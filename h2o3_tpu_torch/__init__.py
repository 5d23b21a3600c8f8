"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu.

It runs beside the JAX package, which stays the reference it is tested
against, and imports nothing of it (nor jax).  So far it holds the
online scoring plane:

* ``export``  — the numpy ``ScoringModel``, the archive reader
  (``import_mojo``) and ``from_reference`` for models trained by the
  JAX package.
* ``serving`` — the bitpacked ensemble (``pack``), the device scorer
  with its CUDA traversal kernel (``kernel``), and the micro-batcher
  with the published-model registry (``batcher``).
* ``runtime`` — the ``H2O3_TPU_*`` config and the metric registry.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
