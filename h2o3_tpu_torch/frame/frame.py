"""Frame: a named table of Vecs on one device — the port of
``h2o3_tpu/frame/frame.py`` (water/fvec/Frame.java:65).

Every Vec of a Frame lies on the same device and is padded to the same
length, so row i of every column lines up.  Frames are immutable;
``_matrix_cache`` memoizes per-frame device views (the response, the
weights), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..runtime import dkv
from ..runtime.device import resolve_device
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
        if len({str(v.device) for v in vecs}) > 1:
            raise ValueError("vecs lie on different devices")
        self.names: List[str] = list(names)
        self.vecs: List[Vec] = list(vecs)
        self.nrows: int = vecs[0].nrows if vecs else 0
        self.key = key
        self._matrix_cache: Dict[tuple, torch.Tensor] = {}
        if key is not None:
            dkv.put(key, self)

    @property
    def device(self) -> torch.device:
        return self.vecs[0].device

    def vec(self, name: str) -> Vec:
        try:
            return self.vecs[self.names.index(name)]
        except ValueError:
            raise KeyError(f"no column {name!r} in frame (have {self.names})")

    def valid_mask(self) -> torch.Tensor:
        return self.vecs[0].valid_mask()

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

    def __repr__(self):
        return (f"<Frame {self.key or ''} {self.nrows}x{len(self.vecs)} "
                f"{self.names[:8]} on {self.device}>")
