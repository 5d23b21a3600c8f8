"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports nothing of it (nor jax).  So far it holds the
online scoring plane and the tree-training main path:

* ``frame``   — ``Frame`` / ``Vec``: numeric and categorical columns as
  padded device tensors.
* ``models``  — the training contract (``base``, ``datainfo``,
  ``distributions``, ``scorekeeper``) and the tree family
  (``models.tree``: binning, the level kernels' wrappers in ``hist``,
  the growth loop in ``shared``, ``gbm``, ``xgboost``), with the CUDA
  histogram and split-record kernels.
* ``metrics`` — binomial and regression model metrics.
* ``export``  — the numpy ``ScoringModel``, the archive reader
  (``import_mojo``) and ``from_reference`` for models trained by the
  JAX package or by the port (``model.to_archive()``).
* ``serving`` — the bitpacked ensemble (``pack``), the device scorer
  with its CUDA traversal kernel (``kernel``), and the micro-batcher
  with the published-model registry (``batcher``).
* ``runtime`` — the device (``device``), the ``H2O3_TPU_*`` config, the
  metric registry, the local key store and blocking jobs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
