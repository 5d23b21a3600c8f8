"""Vec: one column of a Frame — the port of ``h2o3_tpu/frame/vec.py``.

A Vec is a device tensor padded to the row multiple (``runtime/device``:
8) plus its logical type, row count and categorical domain.  Numerics are
float32 with NaN for missing; categoricals are int32 codes with -1 for
missing.  Rollups (RollupStats.java:19-30) are computed lazily in one
pass on the column's device and cached.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime.device import Cluster, resolve_device

# Logical column types — mirrors Vec.java:207-212 and the JAX package.
T_NUM = "num"
T_CAT = "cat"


def encode_domain(svals: np.ndarray, domain: Sequence[str]) -> np.ndarray:
    """int32 codes of string values against an ordered domain; values not
    in the domain code as -1."""
    svals = np.asarray(svals)
    if svals.dtype.kind not in "US":
        svals = svals.astype(str)
    dom = np.asarray(list(domain), dtype=str)
    if len(dom) == 0:
        return np.full(len(svals), -1, np.int32)
    sorter = np.argsort(dom)
    pos = np.clip(np.searchsorted(dom, svals, sorter=sorter), 0,
                  len(dom) - 1)
    hits = sorter[pos]
    return np.where(dom[hits] == svals, hits, -1).astype(np.int32)


@dataclasses.dataclass
class RollupStats:
    """Lazily computed column statistics (fvec/RollupStats.java:19-30)."""

    nrows: int
    nmissing: int
    mean: float
    sigma: float
    vmin: float
    vmax: float
    nzero: int


def _rollup(data: torch.Tensor, n: int):
    """The JAX package's ``_rollup_kernel_impl``: f32 sums over the first
    ``n`` rows with NaN skipped, the sample variance from them."""
    x = data[:n]
    present = ~torch.isnan(x)
    xz = torch.where(present, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    cnt = present.sum()
    nf = cnt.clamp_min(1).to(torch.float32)
    s = xz.sum(dtype=torch.float32)
    ss = (xz * xz).sum(dtype=torch.float32)
    mean = s / nf
    var = (ss / nf - mean * mean).clamp_min(0.0)
    big = float(np.finfo(np.float32).max)
    vmin = torch.where(present, x, big).min()
    vmax = torch.where(present, x, -big).max()
    nzero = (present & (x == 0.0)).sum()
    var = var * nf / (nf - 1.0).clamp_min(1.0)
    return [float(v) for v in torch.stack(
        [cnt.to(torch.float32), mean, var, vmin, vmax,
         nzero.to(torch.float32)]).cpu()]


class Vec:
    """One column: a padded device tensor plus metadata."""

    def __init__(self, data: torch.Tensor, vtype: str, nrows: int,
                 domain: Optional[Sequence[str]] = None):
        self.data = data
        self.type = vtype
        self.nrows = int(nrows)
        self.domain = list(domain) if domain is not None else None
        self._rollups: Optional[RollupStats] = None

    @staticmethod
    def from_numpy(arr: np.ndarray, vtype: str = T_NUM,
                   domain: Optional[Sequence[str]] = None,
                   device=None) -> "Vec":
        """A Vec from host data, padded to the row multiple, on
        ``device`` (``cuda`` unless named)."""
        dev = resolve_device(device)
        if vtype not in (T_NUM, T_CAT):
            raise NotImplementedError(
                f"column type {vtype!r}: the port has numeric and "
                "categorical columns so far (ROADMAP Queue 1)")
        arr = np.asarray(arr)
        n = len(arr)
        padded = Cluster(dev).pad_rows(n)
        if vtype == T_CAT:
            if arr.dtype == object or arr.dtype.kind in "US":
                labels = list(domain) if domain is not None else \
                    [str(u) for u in np.unique(arr.astype(str))]
                arr = encode_domain(arr, labels)
                domain = labels
            buf = np.full(padded, -1, dtype=np.int32)
            buf[:n] = arr.astype(np.int32)
        else:
            buf = np.full(padded, np.nan, dtype=np.float32)
            buf[:n] = arr.astype(np.float64).astype(np.float32)
        return Vec(torch.from_numpy(buf).to(dev), vtype, n, domain=domain)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    @property
    def padded_len(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        """Boolean [padded] mask of real (non-padding) rows."""
        return torch.arange(self.padded_len, device=self.device) < self.nrows

    def numeric_data(self) -> torch.Tensor:
        """Payload as float32 with NaN missing (cat codes -1 -> NaN)."""
        if self.type == T_CAT:
            return torch.where(self.data < 0, float("nan"),
                               self.data.to(torch.float32))
        return self.data

    def rollups(self) -> RollupStats:
        if self._rollups is None:
            cnt, mean, var, vmin, vmax, nzero = _rollup(
                self.numeric_data(), self.nrows)
            n = int(cnt)
            nan = float("nan")
            self._rollups = RollupStats(
                nrows=self.nrows, nmissing=self.nrows - n,
                mean=mean if n else nan,
                sigma=float(np.sqrt(max(var, 0.0))) if n > 1 else nan,
                vmin=vmin if n else nan, vmax=vmax if n else nan,
                nzero=int(nzero))
        return self._rollups

    def to_numpy(self) -> np.ndarray:
        """The logical (unpadded) column on the host."""
        return self.data[: self.nrows].cpu().numpy()

