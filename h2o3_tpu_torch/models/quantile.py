"""Quantile — the port of ``h2o3_tpu/models/quantile.py``
(hex/quantile/Quantile.java:15).

Each numeric column is sorted once on the device (a stable sort; missing
values and rows of weight 0 to +inf, their weights 0), and the sorted
column and weights come back to the host, where the requested
probabilities are read off by exact rank arithmetic (unweighted) or
along the cumulative weights, with ``combine_method`` ``interpolate``,
``average``, ``low`` or ``high``, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, T_TIME
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo

DEFAULT_PROBS = (0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9,
                 0.99, 0.999)
COMBINE_METHODS = ("interpolate", "average", "low", "high")


@dataclasses.dataclass
class QuantileParameters(Parameters):
    probs: Sequence[float] = DEFAULT_PROBS
    combine_method: str = "interpolate"   # interpolate | average | low | high


def _sorted_with_weights(x, w):
    """Sort x ascending (invalid rows to +inf), carrying weights along."""
    invalid = torch.isnan(x) | (w <= 0)
    key = torch.where(invalid, float("inf"), x)
    order = torch.argsort(key, stable=True)
    return key[order], torch.where(invalid, 0.0, w)[order]


def _quantile_from_sorted(xs: np.ndarray, ws: np.ndarray, prob: float,
                          method: str) -> float:
    wsum = ws.sum()
    if wsum <= 0:
        return float("nan")
    unweighted = bool(np.all((ws == 0) | (ws == ws[ws > 0][0])))
    n = int((ws > 0).sum())
    if unweighted:
        # exact rank arithmetic on the n valid (sorted-first) entries
        h = prob * (n - 1)
        lo = int(np.floor(h))
        hi = min(lo + 1, n - 1)
        frac = h - lo
        if method == "interpolate":
            return float(xs[lo] * (1 - frac) + xs[hi] * frac)
        if method == "average":
            return float((xs[lo] + xs[hi]) / 2) if frac else float(xs[lo])
        if method == "low":
            return float(xs[lo])
        if method == "high":
            return float(xs[hi] if frac else xs[lo])
        raise ValueError(f"unknown combine_method {method!r}")
    # weighted: rank along the cumulative-weight axis
    cw = np.cumsum(ws)
    target = prob * wsum
    idx = min(int(np.searchsorted(cw, target, side="left")), n - 1)
    on_boundary = np.isclose(cw[idx], target) and idx + 1 < n
    if method == "low" or not on_boundary:
        return float(xs[idx])
    if method == "high":
        return float(xs[idx + 1])
    return float((xs[idx] + xs[idx + 1]) / 2)


class QuantileModel(Model):
    algo = "quantile"

    def model_performance(self, frame=None):
        return self.training_metrics


class Quantile(ModelBuilder):
    """Quantile builder — h2o.quantile analog (also ``quantile``)."""

    algo = "quantile"
    model_class = QuantileModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[QuantileParameters] = None, **kw):
        super().__init__(params or QuantileParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            weights_column=p.weights_column, standardize=False,
            add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> QuantileModel:
        p: QuantileParameters = self.params
        if p.combine_method not in COMBINE_METHODS:
            raise ValueError(f"unknown combine_method {p.combine_method!r}")
        w = di.weights(frame)
        table = {}
        skip = set(p.ignored_columns) | {p.weights_column}
        numeric = [nm for nm, v in zip(frame.names, frame.vecs)
                   if v.type in (T_NUM, T_TIME) and nm not in skip]
        for i, name in enumerate(numeric):
            xs, ws = _sorted_with_weights(frame.vec(name).numeric_data(), w)
            xs = xs.cpu().numpy().astype(np.float64)
            ws = ws.cpu().numpy().astype(np.float64)
            table[name] = [_quantile_from_sorted(xs, ws, q, p.combine_method)
                           for q in p.probs]
            job.update((i + 1) / len(numeric), f"quantiles: {name}")
        model = QuantileModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({"probs": list(p.probs), "quantiles": table})
        model.training_metrics = table
        return model


def quantile(frame: Frame, probs: Sequence[float] = DEFAULT_PROBS,
             combine_method: str = "interpolate",
             weights_column: Optional[str] = None,
             device=None) -> dict:
    """Frame-level quantiles — the ``h2o.frame.quantile`` convenience
    path, on ``device`` (``cuda`` unless named, as every builder)."""
    m = Quantile(probs=tuple(probs), combine_method=combine_method,
                 weights_column=weights_column, device=device).train(frame)
    return m.output["quantiles"]
