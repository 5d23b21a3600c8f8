"""DataInfo: the fitted featurization state — the port of
``h2o3_tpu/models/datainfo.py`` (hex/DataInfo.java).

Trees train on raw values (numerics as they are, categoricals as codes)
and read the column layout, the response domain and the per-frame
response and weight views.  GLM and DeepLearning train on the design
matrix (``make_matrix``; an autoencoder's layout has no response, and
``coef_names`` names its reconstruction): numerics mean-imputed and
standardized, time columns shifted to the training base, categoricals
one-hot with an NA bucket (unseen levels land there: the reference's
adaptTestForTrain), and the intercept column, memoized on the frame;
``offsets`` gives GLM's offset column.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_TIME, Vec

MEAN_IMPUTATION = "mean_imputation"
SKIP = "skip"
# the row block of a reduction over a design matrix: the per-block
# temporaries (a weighted or transformed copy of the block) stay this size
BLOCK_BYTES = 1 << 30


def row_blocks(N: int, P: int):
    """The ``(start, stop)`` row ranges of an [N, P] f32 matrix in blocks
    of at most ``BLOCK_BYTES``: the unsupervised families reduce over
    them, so no [N, P] temporary beside the design exists."""
    rb = max(1, BLOCK_BYTES // (4 * max(int(P), 1)))
    return [(r0, min(int(N), r0 + rb)) for r0 in range(0, int(N), rb)]


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
    def coef_names(self) -> List[str]:
        names = []
        for s in self.specs:
            if s.type == T_CAT:
                lo = 0 if self.use_all_factor_levels else 1
                names += [f"{s.name}.{lbl}" for lbl in s.domain[lo:]]
                names.append(f"{s.name}.missing(NA)")
            else:
                names.append(s.name)
        if self.add_intercept:
            names.append("Intercept")
        return names

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
            add_intercept: bool = True,
            force_classification: bool = False) -> "DataInfo":
        """The layout of ``frame``'s feature columns (host-only STR/UUID
        columns are never features).  ``force_classification`` trains a
        numeric response as classes: its distinct finite values, as
        labels, are the response domain."""
        skip = set(ignored_columns) | {response_column, weights_column,
                                       offset_column, None}
        specs: List[ColumnSpec] = []
        offset = 0
        for name, vec in zip(frame.names, frame.vecs):
            if name in skip or vec.data is None:
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
                                        time_base=vec.time_base,
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
            elif force_classification:
                vals = np.unique(rv.to_numpy())
                vals = vals[np.isfinite(vals)]
                resp_domain = [str(int(v)) if v == int(v) else str(v)
                               for v in vals]
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

    def make_matrix(self, frame: Frame) -> torch.Tensor:
        """The [padded, nfeatures] f32 design matrix on the frame's device,
        bitwise the JAX package's: numerics with NaN as their mean, then
        (x - mean) / sigma when standardizing; a time column shifted by
        the difference of the time bases; a categorical's one-hot columns
        from level ``lo`` (1 unless ``use_all_factor_levels``) and its NA
        bucket, which missing and unseen levels set; the intercept column
        of ones.  The columns are written into one preallocated tensor (at
        10M rows and P = 628 it is 25 GB: no second [N, P] temporary
        exists), and the result is memoized on the frame under the
        layout's signature."""
        key = ("__design__", self.standardize, self._design_signature())
        hit = frame._matrix_cache.get(key)
        if hit is not None:
            return hit
        n, P = frame.padded_rows, self.nfeatures
        X = torch.zeros((n, P), dtype=torch.float32, device=frame.device)
        rows = torch.arange(n, device=frame.device) * P
        lo = 0 if self.use_all_factor_levels else 1
        for s in self.specs:
            vec = frame.vec(s.name)
            if s.type == T_CAT:
                codes = self.aligned_codes(vec, s).long()
                # the level's column, or the NA bucket for a missing one
                col = torch.where(codes < 0, s.width - 1, codes - lo)
                hot = (codes < 0) | ((col >= 0) & (col < s.width - 1))
                X.view(-1)[(rows + s.offset + col)[hot]] = 1.0
                continue
            x = vec.data
            if s.type == T_TIME and abs(vec.time_base - s.time_base) > 0:
                x = x + (vec.time_base - s.time_base) / 1000.0
            mean = torch.tensor(s.mean, dtype=torch.float32)
            x = torch.where(torch.isnan(x), mean.to(x.device), x)
            if self.standardize:
                x = (x - mean) / torch.tensor(s.sigma, dtype=torch.float32)
            X[:, s.offset] = x
        if self.add_intercept:
            X[:, P - 1] = 1.0
        frame._matrix_cache[key] = X
        return X

    def _design_signature(self) -> tuple:
        """The memo key of the design layout (the signature tuple itself,
        not a hash of it, so no two layouts can collide)."""
        return (tuple((s.name, s.type, tuple(s.domain or ()), s.mean,
                       s.sigma, s.time_base, s.offset, s.width)
                      for s in self.specs),
                self.use_all_factor_levels, self.add_intercept,
                self.missing_values_handling)

    def offsets(self, frame: Frame) -> Optional[torch.Tensor]:
        """The offset column [padded] with NaN as 0, or None."""
        if self.offset_column is None:
            return None
        return torch.nan_to_num(
            frame.vec(self.offset_column).numeric_data())

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
            if self.response_domain is not None and rv.type == T_CAT:
                spec = ColumnSpec(self.response_column, T_CAT,
                                  self.response_domain, 0.0, 1.0)
                hit = self.aligned_codes(rv, spec).to(torch.float32)
            elif self.response_domain is not None:
                # a numeric response trained as classes: the code of the
                # domain value it equals, -1 for none
                vals = torch.tensor([float(v) for v in self.response_domain],
                                    dtype=torch.float32, device=rv.device)
                x = rv.data
                code = torch.argmin((x[:, None] - vals[None, :]).abs(), dim=1)
                exact = (x[:, None] == vals[None, :]).any(dim=1)
                hit = torch.where(exact, code, -1).to(torch.float32)
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
