"""The tree family: binning, histograms and split search, the level-wise
growth loop, GBM and XGBoost, and the batched grid cohorts."""
