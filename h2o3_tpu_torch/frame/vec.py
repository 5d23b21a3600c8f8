"""Vec: one column of a Frame — the port of ``h2o3_tpu/frame/vec.py``.

A Vec is a device tensor padded to the row multiple (``runtime/device``:
8) plus its logical type, row count and categorical domain.  Numerics are
float32 with NaN for missing; categoricals are int32 codes with -1 for
missing.  A TIME column keeps its exact float64 ms since the epoch on the
host (``host_data``) and puts ``(ms - time_base) / 1000`` seconds on the
device as float32.  STR and UUID columns live on the host only (numpy
object arrays, ``None`` missing): they never take part in device compute.
Rollups (RollupStats.java:19-30) are computed lazily in one pass on the
column's device and cached.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime.device import Cluster, resolve_device

# Logical column types — mirrors Vec.java:207-212 and the JAX package.
T_BAD = "bad"
T_NUM = "num"
T_CAT = "cat"
T_TIME = "time"
T_STR = "str"
T_UUID = "uuid"


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
    """One column: a padded device tensor (``None`` for STR/UUID) plus
    metadata."""

    def __init__(self, data: Optional[torch.Tensor], vtype: str, nrows: int,
                 domain: Optional[Sequence[str]] = None,
                 host_data: Optional[np.ndarray] = None,
                 time_base: float = 0.0):
        self.data = data
        self.type = vtype
        self.nrows = int(nrows)
        self.domain = list(domain) if domain is not None else None
        self.host_data = host_data          # str/uuid payload, TIME's ms
        self.time_base = time_base          # TIME: ms since epoch of 0
        self._rollups: Optional[RollupStats] = None

    @staticmethod
    def from_numpy(arr: np.ndarray, vtype: str = T_NUM,
                   domain: Optional[Sequence[str]] = None,
                   device=None, time_base: Optional[float] = None) -> "Vec":
        """A Vec from host data, padded to the row multiple, on
        ``device`` (``cuda`` unless named).  TIME input is float64 ms
        since the epoch: the device holds ``(ms - time_base) / 1000``
        seconds as float32 (``time_base`` the earliest finite value
        unless given), the host keeps the exact ms."""
        arr = np.asarray(arr)
        n = len(arr)
        if vtype in (T_STR, T_UUID):
            return Vec(None, vtype, n, host_data=np.asarray(arr, dtype=object))
        dev = resolve_device(device)
        padded = Cluster(dev).pad_rows(n)
        host_data = None
        if vtype == T_CAT:
            if arr.dtype == object or arr.dtype.kind in "US":
                labels = list(domain) if domain is not None else \
                    [str(u) for u in np.unique(arr.astype(str))]
                arr = encode_domain(arr, labels)
                domain = labels
            buf = np.full(padded, -1, dtype=np.int32)
            buf[:n] = arr.astype(np.int32)
        else:
            vals = arr.astype(np.float64)
            if vtype == T_TIME:
                host_data = vals
                if time_base is None:
                    finite = vals[np.isfinite(vals)]
                    time_base = float(finite.min()) if len(finite) else 0.0
                vals = (vals - time_base) / 1000.0
            buf = np.full(padded, np.nan, dtype=np.float32)
            buf[:n] = vals.astype(np.float32)
        return Vec(torch.from_numpy(buf).to(dev), vtype, n, domain=domain,
                   host_data=host_data, time_base=time_base or 0.0)

    @property
    def device(self) -> Optional[torch.device]:
        """The payload's device; ``None`` for a host-only STR/UUID
        column."""
        return self.data.device if self.data is not None else None

    @property
    def is_numeric(self) -> bool:
        return self.type in (T_NUM, T_TIME)

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    @property
    def padded_len(self) -> int:
        return int(self.data.shape[0]) if self.data is not None \
            else self.nrows

    def valid_mask(self) -> torch.Tensor:
        """Boolean [padded] mask of real (non-padding) rows."""
        return torch.arange(self.padded_len, device=self.device) < self.nrows

    def numeric_data(self) -> torch.Tensor:
        """Payload as float32 with NaN missing (cat codes -1 -> NaN)."""
        if self.data is None:
            raise TypeError(f"Vec of type {self.type} has no device payload")
        if self.type == T_CAT:
            return torch.where(self.data < 0, float("nan"),
                               self.data.to(torch.float32))
        return self.data

    def rollups(self) -> RollupStats:
        """Lazy cached stats: a host-only column counts its missing
        cells, TIME takes its exact host ms (as in the JAX package)."""
        if self._rollups is None:
            nan = float("nan")
            if self.data is None:
                miss = int(sum(1 for v in self.host_data[: self.nrows]
                               if v is None))
                self._rollups = RollupStats(self.nrows, miss, nan, nan, nan,
                                            nan, 0)
            elif self.type == T_TIME and self.host_data is not None:
                x = self.host_data[: self.nrows]
                ok = np.isfinite(x)
                n = int(ok.sum())
                self._rollups = RollupStats(
                    nrows=self.nrows, nmissing=self.nrows - n,
                    mean=float(np.mean(x[ok])) if n else nan,
                    sigma=float(np.std(x[ok], ddof=1)) if n > 1 else nan,
                    vmin=float(np.min(x[ok])) if n else nan,
                    vmax=float(np.max(x[ok])) if n else nan,
                    nzero=int((x[ok] == 0).sum()))
            else:
                cnt, mean, var, vmin, vmax, nzero = _rollup(
                    self.numeric_data(), self.nrows)
                n = int(cnt)
                self._rollups = RollupStats(
                    nrows=self.nrows, nmissing=self.nrows - n,
                    mean=mean if n else nan,
                    sigma=float(np.sqrt(max(var, 0.0))) if n > 1 else nan,
                    vmin=vmin if n else nan, vmax=vmax if n else nan,
                    nzero=int(nzero))
        return self._rollups

    def to_numpy(self) -> np.ndarray:
        """The logical (unpadded) column on the host: TIME as its exact
        float64 ms, STR/UUID as their object arrays."""
        if self.host_data is not None:
            return self.host_data[: self.nrows]
        return self.data[: self.nrows].cpu().numpy()

    def decoded(self) -> np.ndarray:
        """Host column with categorical codes mapped back to labels
        (``None`` missing)."""
        arr = self.to_numpy()
        if self.type == T_CAT and self.domain is not None:
            dom = np.asarray(self.domain, dtype=object)
            out = np.empty(len(arr), dtype=object)
            ok = arr >= 0
            out[ok] = dom[arr[ok]]
            out[~ok] = None
            return out
        return arr
