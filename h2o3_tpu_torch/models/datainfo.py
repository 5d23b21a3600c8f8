"""DataInfo: the fitted featurization state — the part of
``h2o3_tpu/models/datainfo.py`` the tree family reads (hex/DataInfo.java).

Trees train on raw values (numerics as they are, categoricals as codes),
so the port keeps the column layout, the response domain and the
per-frame response and weight views; the one-hot design matrix of the
linear families waits for their slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec

MEAN_IMPUTATION = "mean_imputation"
SKIP = "skip"


@dataclasses.dataclass
class ColumnSpec:
    name: str
    type: str                       # T_NUM / T_CAT
    domain: Optional[List[str]]     # cat labels (training-time)
    mean: float                     # imputation value / centering
    sigma: float                    # scaling (1.0 when not standardizing)
    time_base: float = 0.0
    offset: int = 0                 # first output column index
    width: int = 1                  # number of output columns


@dataclasses.dataclass
class DataInfo:
    """Fitted featurization: layout + per-column adaptation state."""

    specs: List[ColumnSpec]
    response_column: Optional[str]
    response_domain: Optional[List[str]]
    weights_column: Optional[str]
    offset_column: Optional[str]
    standardize: bool
    use_all_factor_levels: bool
    missing_values_handling: str
    add_intercept: bool
    nfeatures: int
    response_mean: float = 0.0
    response_sigma: float = 1.0

    @property
    def nclasses(self) -> int:
        return len(self.response_domain) if self.response_domain else 1

    @property
    def is_classifier(self) -> bool:
        return self.response_domain is not None

    @staticmethod
    def fit(frame: Frame, response_column: Optional[str] = None,
            ignored_columns: Sequence[str] = (),
            weights_column: Optional[str] = None,
            offset_column: Optional[str] = None,
            standardize: bool = True,
            use_all_factor_levels: bool = False,
            missing_values_handling: str = MEAN_IMPUTATION,
            add_intercept: bool = True) -> "DataInfo":
        skip = set(ignored_columns) | {response_column, weights_column,
                                       offset_column, None}
        specs: List[ColumnSpec] = []
        offset = 0
        for name, vec in zip(frame.names, frame.vecs):
            if name in skip:
                continue
            if vec.type == T_CAT:
                dom = list(vec.domain or [])
                lo = 0 if use_all_factor_levels else 1
                width = max(len(dom) - lo, 0) + 1          # +1 NA bucket
                specs.append(ColumnSpec(name, T_CAT, dom, 0.0, 1.0,
                                        offset=offset, width=width))
            else:
                r = vec.rollups()
                mean = r.mean if np.isfinite(r.mean) else 0.0
                sigma = r.sigma if (standardize and np.isfinite(r.sigma)
                                    and r.sigma > 0) else 1.0
                specs.append(ColumnSpec(name, vec.type, None, mean, sigma,
                                        offset=offset, width=1))
            offset += specs[-1].width
        if not specs:
            raise ValueError("no usable feature columns")
        resp_domain = None
        rmean, rsigma = 0.0, 1.0
        if response_column is not None:
            rv = frame.vec(response_column)
            if rv.type == T_CAT:
                resp_domain = list(rv.domain or [])
            else:
                rr = rv.rollups()
                rmean = rr.mean if np.isfinite(rr.mean) else 0.0
                rsigma = rr.sigma if np.isfinite(rr.sigma) and \
                    rr.sigma > 0 else 1.0
        nfeat = offset + (1 if add_intercept else 0)
        return DataInfo(specs, response_column, resp_domain, weights_column,
                        offset_column, standardize, use_all_factor_levels,
                        missing_values_handling, add_intercept, nfeat,
                        response_mean=rmean, response_sigma=rsigma)

    def aligned_codes(self, vec: Vec, s: ColumnSpec) -> torch.Tensor:
        """A (possibly differently coded) cat Vec on the training codes."""
        if vec.type != T_CAT:
            return torch.where(torch.isnan(vec.data), -1.0,
                               vec.data).to(torch.int32)
        if vec.domain == s.domain:
            return vec.data
        remap = np.full(max(len(vec.domain or []), 1), -1, dtype=np.int32)
        lookup = {lbl: i for i, lbl in enumerate(s.domain)}
        for i, lbl in enumerate(vec.domain or []):
            remap[i] = lookup.get(lbl, -1)
        remap_dev = torch.from_numpy(remap).to(vec.device)
        codes = vec.data
        return torch.where(codes < 0, -1,
                           remap_dev[codes.clamp_min(0).long()])

    def response(self, frame: Frame) -> torch.Tensor:
        """Response as float32 [padded]: class codes for classifiers (-1
        missing) else values (NaN missing).  Memoized per frame."""
        key = ("__response__", self.response_column,
               tuple(self.response_domain or ()))
        hit = frame._matrix_cache.get(key)
        if hit is None:
            rv = frame.vec(self.response_column)
            if self.response_domain is not None:
                spec = ColumnSpec(self.response_column, T_CAT,
                                  self.response_domain, 0.0, 1.0)
                hit = self.aligned_codes(rv, spec).to(torch.float32)
            else:
                hit = rv.numeric_data()
            frame._matrix_cache[key] = hit
        return hit

    def weights(self, frame: Frame) -> torch.Tensor:
        """Row weights x validity: 0 on padding and on rows whose response
        is missing.  Memoized per frame."""
        key = ("__weights__", self.weights_column, self.response_column,
               tuple(self.response_domain or ()),
               self.missing_values_handling)
        hit = frame._matrix_cache.get(key)
        if hit is not None:
            return hit
        w = frame.valid_mask().to(torch.float32)
        if self.weights_column is not None:
            w = w * torch.nan_to_num(
                frame.vec(self.weights_column).numeric_data())
        if self.response_column is not None:
            y = self.response(frame)
            bad = torch.isnan(y) | (y < -0.5) if self.response_domain \
                else torch.isnan(y)
            w = w * torch.where(bad, 0.0, 1.0)
        if self.missing_values_handling == SKIP:
            for s in self.specs:
                vec = frame.vec(s.name)
                if s.type == T_CAT:
                    w = w * (self.aligned_codes(vec, s) >= 0)
                else:
                    w = w * ~torch.isnan(vec.data)
        frame._matrix_cache[key] = w
        return w
