"""The device the port runs on — its counterpart of ``runtime/cluster.py``.

The JAX package boots a mesh of row shards and pads every column to a
multiple of ``n_row_shards * 8``.  The port runs on one device: one row
shard, rows padded to a multiple of 8.  Entry points take ``device=`` and
run on ``cuda`` unless the caller names another; with no CUDA device they
raise rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is asked for and absent — an entry
    point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "h2o3_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch version")
    return dev


@dataclasses.dataclass
class Cluster:
    """One device, one row shard."""

    device: torch.device

    @property
    def n_row_shards(self) -> int:
        return 1

    def pad_rows(self, n: int) -> int:
        """Rows padded to a multiple of ``n_row_shards * 8``."""
        m = self.n_row_shards * 8
        return ((max(n, 1) + m - 1) // m) * m
