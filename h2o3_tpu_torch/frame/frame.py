"""Frame: a named table of Vecs on one device — the port of
``h2o3_tpu/frame/frame.py`` (water/fvec/Frame.java:65).

Every device Vec of a Frame lies on the same device and is padded to the
same length, so row i of every column lines up; STR/UUID columns stay on
the host.  Frames are immutable: the munging verbs (``cbind``,
``rename``, ``drop``, ``with_vec``, ``rows``, ``filter``,
``split_frame``) return new Frames, and so do the data plane's verbs
(``sort``, ``merge``, ``group_by``, ``impute``, ``scale``), which
delegate to ``rapids.ops`` as in the JAX package; ``cor`` and ``var``
return matrices.  ``_matrix_cache`` memoizes per-frame device views
(``matrix``, the response, the weights), as in the JAX package.  Not
ported yet: the lineage records and ``spill`` (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..runtime import dkv
from ..runtime.device import Cluster, resolve_device
from .vec import T_CAT, T_NUM, Vec


class Frame:
    def __init__(self, names: Sequence[str], vecs: Sequence[Vec],
                 key: Optional[str] = None):
        if len(names) != len(vecs):
            raise ValueError("names/vecs length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {list(names)}")
        if len({v.nrows for v in vecs}) > 1:
            raise ValueError("vecs disagree on nrows")
        if len({str(v.device) for v in vecs if v.data is not None}) > 1:
            raise ValueError("vecs lie on different devices")
        self.names: List[str] = list(names)
        self.vecs: List[Vec] = list(vecs)
        self.nrows: int = vecs[0].nrows if vecs else 0
        self.key = key
        self._matrix_cache: Dict[tuple, torch.Tensor] = {}
        if key is not None:
            dkv.put(key, self)

    def _device_vec(self) -> Optional[Vec]:
        return next((v for v in self.vecs if v.data is not None), None)

    @property
    def device(self) -> torch.device:
        """The device of the frame's device columns (the CPU for a frame
        of host-only columns)."""
        v = self._device_vec()
        return v.device if v is not None else torch.device("cpu")

    @property
    def ncols(self) -> int:
        return len(self.vecs)

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def padded_rows(self) -> int:
        v = self._device_vec()
        return v.padded_len if v is not None else self.nrows

    def vec(self, name: str) -> Vec:
        try:
            return self.vecs[self.names.index(name)]
        except ValueError:
            raise KeyError(f"no column {name!r} in frame (have {self.names})")

    def __getitem__(self, cols) -> "Frame":
        if isinstance(cols, str):
            cols = [cols]
        return Frame(cols, [self.vec(c) for c in cols])

    def types(self) -> Dict[str, str]:
        return {n: v.type for n, v in zip(self.names, self.vecs)}

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.padded_rows, device=self.device) \
            < self.nrows

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], key: Optional[str] = None,
                   types: Optional[Dict[str, str]] = None,
                   domains: Optional[Dict[str, Sequence[str]]] = None,
                   device=None) -> "Frame":
        """A Frame from host columns on ``device`` (``cuda`` unless
        named).  A column of strings becomes categorical with its sorted
        labels as the domain, as in the JAX package."""
        dev = resolve_device(device)
        types = types or {}
        domains = domains or {}
        names, vecs = [], []
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            vtype = types.get(name)
            domain = domains.get(name)
            if vtype is None:
                if arr.dtype == object or arr.dtype.kind in "US":
                    labels, codes = np.unique(arr.astype(str),
                                              return_inverse=True)
                    vtype, domain, arr = T_CAT, [str(x) for x in labels], \
                        codes
                else:
                    vtype = T_NUM
            names.append(name)
            vecs.append(Vec.from_numpy(arr, vtype, domain=domain,
                                       device=dev))
        return Frame(names, vecs, key=key)

    # --------------------------------------------------------------- munging
    def cbind(self, other: "Frame") -> "Frame":
        if other.nrows != self.nrows:
            raise ValueError("cbind: row counts differ")
        return Frame(self.names + other.names, self.vecs + other.vecs)

    def rename(self, mapping: Dict[str, str]) -> "Frame":
        return Frame([mapping.get(n, n) for n in self.names], self.vecs)

    def drop(self, cols: Sequence[str]) -> "Frame":
        cols = set([cols] if isinstance(cols, str) else cols)
        keep = [(n, v) for n, v in zip(self.names, self.vecs)
                if n not in cols]
        return Frame([n for n, _ in keep], [v for _, v in keep])

    def with_vec(self, name: str, vec: Vec) -> "Frame":
        if name in self.names:
            vecs = list(self.vecs)
            vecs[self.names.index(name)] = vec
            return Frame(self.names, vecs)
        return Frame(self.names + [name], self.vecs + [vec])

    def rows(self, index: np.ndarray) -> "Frame":
        """Row subset by integer index: device columns gather on their
        device and pad again; host columns (TIME's ms, STR/UUID) on the
        host."""
        index = np.asarray(index, dtype=np.int64)
        n = len(index)
        padded = Cluster(self.device).pad_rows(n)
        idx = torch.from_numpy(index).to(self.device)
        out = []
        for v in self.vecs:
            host = v.host_data[: v.nrows][index] \
                if v.host_data is not None else None
            if v.data is None:
                out.append(Vec(None, v.type, n, host_data=host))
                continue
            fill = -1 if v.type == T_CAT else float("nan")
            data = torch.full((padded,), fill, dtype=v.data.dtype,
                              device=v.device)
            data[:n] = v.data[: v.nrows][idx]
            out.append(Vec(data, v.type, n, domain=v.domain,
                           host_data=host, time_base=v.time_base))
        return Frame(self.names, out)

    def filter(self, mask: np.ndarray) -> "Frame":
        mask = np.asarray(mask, dtype=bool)
        return self.rows(np.nonzero(mask[: self.nrows])[0])

    def split_frame(self, ratios: Sequence[float],
                    seed: int = 0) -> List["Frame"]:
        """Random row split — h2o.split_frame (random uniform), the JAX
        package's draws."""
        u = np.random.default_rng(seed).random(self.nrows)
        bounds = np.cumsum(list(ratios))
        if len(bounds) == 0 or bounds[-1] < 1.0 - 1e-9:
            bounds = np.append(bounds, 1.0)
        bounds[-1] = np.inf       # the last piece takes what remains
        pieces, lo = [], 0.0
        for hi in bounds:
            pieces.append(self.filter((u >= lo) & (u < hi)))
            lo = hi
        return pieces

    # ---------------------------------------------------------- device views
    def matrix(self, cols: Optional[Sequence[str]] = None,
               dtype=torch.float32) -> torch.Tensor:
        """[padded_rows, len(cols)] block of the columns' payloads; cats
        as raw codes (-1 NA).  Cached per column set and dtype."""
        cols = list(cols) if cols is not None else list(self.names)
        ck = (tuple(cols), str(dtype))
        hit = self._matrix_cache.get(ck)
        if hit is not None:
            return hit
        parts = []
        for c in cols:
            v = self.vec(c)
            if v.data is None:
                raise TypeError(f"column {c!r} of type {v.type} is host-only")
            parts.append(v.data.to(dtype))
        mat = torch.stack(parts, dim=1)
        self._matrix_cache[ck] = mat
        return mat

    # ------------------------------------------------- the data plane's verbs
    # h2o-py's H2OFrame carries the munging verbs as methods; the device
    # implementations live in rapids/ops.py and these delegate.
    def sort(self, by, ascending=True) -> "Frame":
        from ..rapids import ops
        return ops.sort(self, by, ascending=ascending)

    def merge(self, other: "Frame", by, how: str = "inner") -> "Frame":
        from ..rapids import ops
        return ops.merge(self, other, by, how=how)

    def group_by(self, by, aggs) -> "Frame":
        from ..rapids import ops
        return ops.group_by(self, by, aggs)

    def impute(self, column: str, method: str = "mean",
               combine_method: str = "interpolate") -> "Frame":
        from ..rapids import ops
        return ops.impute(self, column, method=method,
                          combine_method=combine_method)

    def scale(self, center: bool = True, scale: bool = True) -> "Frame":
        from ..rapids import ops
        return ops.scale(self, center=center, scale_=scale)

    def cor(self, cols=None, use: str = "complete.obs"):
        from ..rapids import ops
        return ops.cor(self, cols, use=use)

    def var(self, cols=None, use: str = "complete.obs"):
        from ..rapids import ops
        return ops.var(self, cols, use=use)

    # ---------------------------------------------------------------- export
    def to_pandas(self):
        """A pandas DataFrame of the decoded columns (pandas is imported
        here, at the call)."""
        import pandas as pd
        return pd.DataFrame({n: v.decoded()
                             for n, v in zip(self.names, self.vecs)})

    def to_numpy(self) -> np.ndarray:
        return np.stack([np.asarray(v.to_numpy(), dtype=np.float64)
                         for v in self.vecs], axis=1)

    def head(self, n: int = 10) -> "Frame":
        """The first ``n`` rows as a Frame (h2o-py's ``head``; the JAX
        package returns a pandas DataFrame: ``head(n).to_pandas()``)."""
        return self.rows(np.arange(min(n, self.nrows)))

    def describe(self) -> Dict[str, dict]:
        """h2o-py H2OFrame.describe(): ``summary()``."""
        return self.summary()

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, v in zip(self.names, self.vecs):
            r = v.rollups()
            if v.data is None:
                out[name] = {"type": v.type, "missing": r.nmissing}
            else:
                out[name] = {"type": v.type, "min": r.vmin, "max": r.vmax,
                             "mean": r.mean, "sigma": r.sigma,
                             "missing": r.nmissing, "zeros": r.nzero,
                             "cardinality": v.cardinality}
        return out

    def __repr__(self):
        return (f"<Frame {self.key or ''} {self.nrows}x{len(self.vecs)} "
                f"{self.names[:8]} on {self.device}>")
