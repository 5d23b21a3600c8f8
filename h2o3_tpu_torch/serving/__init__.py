"""Online scoring plane: bitpacked ensembles, the CUDA traversal kernel,
micro-batching.

* ``pack``    — numpy-only bitpacked node-array packer.
* ``kernel``  — ``PackedScorer``: node planes on the device, the CUDA
  traversal (``csrc/traverse.cu``) or its plain torch version, and
  ``score_mode="packed"|"ref"|"check"``.
* ``batcher`` — continuous micro-batching + the published-model
  registry.
"""
