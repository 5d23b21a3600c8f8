"""Isotonic regression — the port of ``h2o3_tpu/models/isotonic.py``
(hex/isotonic/IsotonicRegression.java).

The rows are sorted by x on the device (``_sort_xyw``: a stable sort,
invalid rows to +inf with weight 0); on the host duplicate x values are
pooled into weighted means and ``_pav``, the stack-based
pool-adjacent-violators, fits them in O(n); the model keeps the
segment-boundary knots as its thresholds and predicts by linear
interpolation, ``out_of_bounds`` "na" or "clip".  The tree family's
isotonic calibration (``tree.shared.SharedTree._post_fit``) uses ``_pav``
too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class IsotonicRegressionParameters(Parameters):
    out_of_bounds: str = "na"     # na | clip


def _sort_xyw(x, y, w):
    invalid = torch.isnan(x) | torch.isnan(y) | (w <= 0)
    key = torch.where(invalid, float("inf"), x)
    order = torch.argsort(key, stable=True)
    return key[order], y[order], torch.where(invalid, 0.0, w)[order]


def _pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Stack-based pool-adjacent-violators: the isotonic (non-decreasing)
    fit of ``y`` with weights ``w``, in O(n)."""
    n = len(y)
    means = np.empty(n)
    weights = np.empty(n)
    sizes = np.empty(n, dtype=np.int64)
    top = -1
    for i in range(n):
        top += 1
        means[top], weights[top], sizes[top] = y[i], w[i], 1
        while top > 0 and means[top - 1] >= means[top]:
            tw = weights[top - 1] + weights[top]
            means[top - 1] = (means[top - 1] * weights[top - 1]
                              + means[top] * weights[top]) / tw
            weights[top - 1] = tw
            sizes[top - 1] += sizes[top]
            top -= 1
    return np.repeat(means[: top + 1], sizes[: top + 1])


class IsotonicRegressionModel(Model):
    algo = "isotonicregression"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("isotonic scores via thresholds")

    def _predict_np(self, frame: Frame) -> np.ndarray:
        x = frame.vec(self.output["feature"]).numeric_data()[: frame.nrows] \
            .cpu().numpy().astype(np.float64)
        tx = self.output["thresholds_x"]
        ty = self.output["thresholds_y"]
        pred = np.interp(x, tx, ty)
        if self.params.out_of_bounds == "na":
            pred = np.where((x < tx[0]) | (x > tx[-1]), np.nan, pred)
        return np.where(np.isnan(x), np.nan, pred)

    def predict(self, frame: Frame) -> Frame:
        return Frame(["predict"], [Vec.from_numpy(
            self._predict_np(frame), T_NUM, device=frame.device)])

    def model_performance(self, frame: Optional[Frame] = None):
        from ..metrics.core import regression_metrics
        if frame is None:
            return self.training_metrics
        p = self._predict_np(frame)
        y = frame.vec(self.params.response_column).numeric_data()[
            : frame.nrows].cpu().numpy().astype(np.float64)
        ok = ~(np.isnan(p) | np.isnan(y))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=frame.device)
        return regression_metrics(t(p[ok]), t(y[ok]),
                                  t(np.ones(int(ok.sum()))))

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout (the JAX
        package's ``export/mojo.py::_extract`` for isotonic regression),
        scored by ``ScoringModel._score_isotonic``."""
        from ..export.mojo import archive_meta
        meta = archive_meta(self, "isotonic")
        meta["feature"] = self.output["feature"]
        meta["out_of_bounds"] = self.params.out_of_bounds
        return meta, {
            "thresholds_x": np.asarray(self.output["thresholds_x"]),
            "thresholds_y": np.asarray(self.output["thresholds_y"])}


class IsotonicRegression(ModelBuilder):
    """Isotonic builder — H2OIsotonicRegressionEstimator analog."""

    algo = "isotonicregression"
    model_class = IsotonicRegressionModel
    standard_metrics = False

    def __init__(self, params: Optional[IsotonicRegressionParameters] = None,
                 **kw):
        super().__init__(params or IsotonicRegressionParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p = self.params
        if p.out_of_bounds not in ("na", "clip"):
            raise ValueError(f"out_of_bounds={p.out_of_bounds!r}: na|clip")
        feats = [n for n in frame.names
                 if n not in (p.response_column, p.weights_column)
                 and n not in p.ignored_columns]
        if len(feats) != 1:
            raise ValueError(
                f"isotonic regression needs exactly 1 feature, got {feats}")

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> IsotonicRegressionModel:
        p = self.params
        feature = di.specs[0].name
        x = frame.vec(feature).numeric_data()
        y = frame.vec(p.response_column).numeric_data()
        w = di.weights(frame)
        xs, ys, ws = (t.cpu().numpy().astype(np.float64)
                      for t in _sort_xyw(x, y, w))
        n = int((ws > 0).sum())
        xs, ys, ws = xs[:n], ys[:n], ws[:n]
        # aggregate duplicate x (weighted mean) so PAV runs on unique knots
        ux, start = np.unique(xs, return_index=True)
        wsum = np.add.reduceat(ws, start)
        ysum = np.add.reduceat(ys * ws, start)
        ymean = ysum / np.maximum(wsum, 1e-30)
        fit = _pav(ymean, wsum)
        # keep only segment-boundary knots (thresholds, as the reference does)
        keep = np.ones(len(fit), bool)
        if len(fit) > 2:
            interior = (fit[1:-1] == fit[:-2]) & (fit[1:-1] == fit[2:])
            keep[1:-1] = ~interior
        model = IsotonicRegressionModel(
            job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "feature": feature,
            "thresholds_x": ux[keep], "thresholds_y": fit[keep],
            "nobs": n,
        })
        model.training_metrics = model.model_performance(frame)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
