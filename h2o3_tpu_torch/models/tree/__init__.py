"""The tree family: binning, histograms and split search, the level-wise
growth loop (dense and node-sparse levels), GBM, XGBoost and DRF, and the
batched grid cohorts."""
