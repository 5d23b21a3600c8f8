"""Target encoding — the port of ``h2o3_tpu/models/targetencoder.py``
(h2o-extensions/target-encoder, ai/h2o/targetencoding/TargetEncoder.java:23).

The per-level response sums and weights of each categorical column are
f64 host ``bincount`` tables (per fold too, for ``k_fold``), as in the
reference: the holdout corrections subtract near-equal quantities, which
f32 products would blur.  ``transform`` appends ``<col>_te``: the level
mean, with the row's own response taken out (``leave_one_out``) or its
fold's statistics (``k_fold``, by ``fold_column``, which is the
encoder's own and not cross-validation), blended toward the prior and
with uniform noise from the JAX package's numpy draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo

LEAKAGE_HANDLING = ("none", "leave_one_out", "k_fold")


@dataclasses.dataclass
class TargetEncoderParameters(Parameters):
    columns: Optional[List[str]] = None        # None -> all cat features
    data_leakage_handling: str = "none"        # none | leave_one_out | k_fold
    blending: bool = True
    inflection_point: float = 10.0             # k in k/f smoothing
    smoothing: float = 20.0                    # f
    noise: float = 0.0
    fold_column: Optional[str] = None


class TargetEncoderModel(Model):
    algo = "targetencoder"

    def transform(self, frame: Frame, as_training: bool = False) -> Frame:
        """Append ``<col>_te`` columns (training mode applies holdout)."""
        p: TargetEncoderParameters = self.params
        tables = self.output["encoding_tables"]
        prior = self.output["prior_mean"]
        names = list(frame.names)
        vecs = list(frame.vecs)
        rng = np.random.default_rng(self.params.effective_seed())
        y = wrow = folds = None
        if as_training and p.data_leakage_handling == "leave_one_out":
            y = self.datainfo.response(frame)[: frame.nrows].cpu().numpy()
            wrow = np.ones(frame.nrows)
            if p.weights_column and p.weights_column in frame.names:
                wrow = np.nan_to_num(
                    frame.vec(p.weights_column).to_numpy())
        if as_training and p.data_leakage_handling == "k_fold":
            if p.fold_column is None or p.fold_column not in frame.names:
                raise ValueError(
                    "k_fold leakage handling requires fold_column")
            fc = frame.vec(p.fold_column).to_numpy()
            fold_ids = self.output["fold_ids"]
            lookup = {f: i for i, f in enumerate(fold_ids)}
            folds = np.asarray([lookup.get(f, -1) for f in fc])
        for col, tbl in tables.items():
            if col not in frame.names:
                continue
            v = frame.vec(col)
            codes = v.to_numpy() if v.type == T_CAT else \
                v.to_numpy().astype(np.int64)
            sums = tbl["sums"]
            counts = tbl["counts"]
            s = np.where((codes >= 0) & (codes < len(sums)),
                         sums[np.clip(codes, 0, len(sums) - 1)], 0.0)
            c = np.where((codes >= 0) & (codes < len(counts)),
                         counts[np.clip(codes, 0, len(counts) - 1)], 0.0)
            if y is not None:               # leave-one-out (weight-aware)
                s = s - np.nan_to_num(y) * wrow
                c = np.maximum(c - wrow, 0)
            if folds is not None:           # k_fold: drop own fold's stats
                fs = tbl["fold_sums"]       # [nfolds, K]
                fcnt = tbl["fold_counts"]
                cc = np.clip(codes, 0, len(sums) - 1)
                ff = np.clip(folds, 0, len(fs) - 1)
                own_s = np.where((codes >= 0) & (folds >= 0),
                                 fs[ff, cc], 0.0)
                own_c = np.where((codes >= 0) & (folds >= 0),
                                 fcnt[ff, cc], 0.0)
                s = s - own_s
                c = np.maximum(c - own_c, 0)
            mean = np.where(c > 0, s / np.maximum(c, 1e-12), prior)
            if p.blending:
                lam = 1.0 / (1.0 + np.exp(-(c - p.inflection_point)
                                          / max(p.smoothing, 1e-6)))
                mean = lam * mean + (1 - lam) * prior
            if as_training and p.noise > 0:
                mean = mean + rng.uniform(-p.noise, p.noise, len(mean))
            names.append(f"{col}_te")
            vecs.append(Vec.from_numpy(mean, T_NUM, device=frame.device))
        return Frame(names, vecs)

    def _predict_raw(self, X):
        raise NotImplementedError("targetencoder transforms, not predicts")

    def model_performance(self, frame=None):
        return self.training_metrics


class TargetEncoder(ModelBuilder):
    """TE builder — H2OTargetEncoderEstimator analog."""

    algo = "targetencoder"
    model_class = TargetEncoderModel
    standard_metrics = False

    def __init__(self, params: Optional[TargetEncoderParameters] = None,
                 **kw):
        super().__init__(params or TargetEncoderParameters(**kw))

    def _cv_requested(self) -> bool:
        # the fold column is the k_fold encoding's, not cross-validation
        p = self.params
        return bool(p.nfolds and p.nfolds > 1)

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if self.params.data_leakage_handling not in LEAKAGE_HANDLING:
            raise ValueError(
                f"data_leakage_handling="
                f"{self.params.data_leakage_handling!r}: "
                + "|".join(LEAKAGE_HANDLING))

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> TargetEncoderModel:
        p: TargetEncoderParameters = self.params
        y = di.response(frame)
        w = di.weights(frame)
        yz = y.nan_to_num()
        cols = p.columns or [s.name for s in di.specs if s.type == T_CAT]
        fold_ids = []
        fold_mask_np = None
        if p.data_leakage_handling == "k_fold" and p.fold_column:
            fc = frame.vec(p.fold_column).to_numpy()
            fold_ids = sorted(set(fc.tolist()))
            pad = frame.padded_rows - frame.nrows
            fm = np.stack([(fc == f) for f in fold_ids]).astype(np.float32)
            fold_mask_np = np.pad(fm, [(0, 0), (0, pad)]).astype(np.float64)
        tables: Dict[str, dict] = {}
        # f64 host tables: the transform subtracts near-equal quantities
        # (LOO / fold corrections), which f32 sums would blur
        yz64 = yz.cpu().numpy().astype(np.float64)
        w64 = w.cpu().numpy().astype(np.float64)
        for i, col in enumerate(cols):
            v = frame.vec(col)
            if v.type != T_CAT:
                continue
            K = len(v.domain or [])
            if K == 0:
                continue
            codes = v.data.cpu().numpy()
            ok = (codes >= 0) * w64
            cc = np.clip(codes, 0, K - 1)
            sums = np.bincount(cc, weights=yz64 * ok, minlength=K)[:K]
            counts = np.bincount(cc, weights=ok, minlength=K)[:K]
            tables[col] = {"sums": sums, "counts": counts,
                           "domain": list(v.domain or [])}
            if fold_mask_np is not None:
                tables[col]["fold_sums"] = np.stack(
                    [np.bincount(cc, weights=yz64 * ok * fm,
                                 minlength=K)[:K] for fm in fold_mask_np])
                tables[col]["fold_counts"] = np.stack(
                    [np.bincount(cc, weights=ok * fm,
                                 minlength=K)[:K] for fm in fold_mask_np])
            job.update((i + 1) / max(len(cols), 1), f"encoding {col}")
        n = float(w.sum())
        prior = float((yz * w).sum()) / max(n, 1e-12)
        model = TargetEncoderModel(job.dest_key or dkv.make_key(self.algo),
                                   p, di)
        model.output.update({"encoding_tables": tables, "prior_mean": prior,
                             "fold_ids": fold_ids})
        model.training_metrics = {"columns": list(tables),
                                  "prior_mean": prior}
        return model
