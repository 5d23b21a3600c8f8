"""Model metrics: binomial and regression — the port of those families of
``h2o3_tpu/metrics/core.py`` (hex/ModelMetrics*, hex/AUC2.java).

Each family is one pass over the (prediction, response, weight) rows on
their device, then a small host-side epilogue.  The binomial AUC uses the
JAX package's 400-bin weighted histograms of P(class 1) — here one
``bincount`` per class instead of its one-hot matmul — and the same
trapezoid over the descending-threshold ROC polyline.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

NBINS = 400  # AUC2's default number of threshold bins (hex/AUC2.java)


def _binomial_sums(p1, y, w, nbins: int) -> np.ndarray:
    """(pos[nbins], neg[nbins], logloss_sum, se_sum, wsum, wpos) in one
    packed host fetch."""
    p1c = p1.clamp(1e-15, 1 - 1e-15)
    idx = (p1 * nbins).to(torch.int64).clamp(0, nbins - 1)
    pos_w = w * (y == 1)
    neg_w = w * (y == 0)
    pos = torch.bincount(idx, weights=pos_w, minlength=nbins)
    neg = torch.bincount(idx, weights=neg_w, minlength=nbins)
    ll = -(w * (y * torch.log(p1c) + (1 - y) * torch.log1p(-p1c))).sum()
    se = (w * (y - p1) ** 2).sum()
    tail = torch.stack([ll, se, w.sum(), pos_w.sum()])
    return torch.cat([pos.to(torch.float32), neg.to(torch.float32),
                      tail]).cpu().numpy().astype(np.float64)


@dataclasses.dataclass
class ConfusionMatrix:
    """2x2 confusion matrix at a threshold, rows = actual."""
    table: np.ndarray
    domain: List[str]


@dataclasses.dataclass
class ModelMetricsBinomial:
    nobs: float
    auc: float
    pr_auc: float
    gini: float
    logloss: float
    mse: float
    rmse: float
    mean_per_class_error: float
    max_f1: float
    max_f1_threshold: float
    accuracy: float
    domain: List[str]
    cm: ConfusionMatrix
    thresholds: np.ndarray
    tps: np.ndarray
    fps: np.ndarray

    @property
    def ks(self) -> float:
        npos, nneg = float(self.tps[-1]), float(self.fps[-1])
        if npos <= 0 or nneg <= 0:
            return float("nan")
        return float(np.max(self.tps / npos - self.fps / nneg))

    def describe(self) -> dict:
        return {"auc": self.auc, "pr_auc": self.pr_auc,
                "logloss": self.logloss, "rmse": self.rmse,
                "gini": self.gini,
                "mean_per_class_error": self.mean_per_class_error,
                "max_f1": self.max_f1, "threshold": self.max_f1_threshold,
                "ks": self.ks}


def binomial_metrics(p1, y, w, domain: Optional[List[str]] = None
                     ) -> ModelMetricsBinomial:
    """AUC2-equivalent metrics from P(class 1), labels {0,1}, weights."""
    packed = _binomial_sums(p1, y, w, NBINS)
    pos, neg = packed[:NBINS], packed[NBINS: 2 * NBINS]
    ll, se, wsum, wpos = packed[2 * NBINS:]
    n = float(wsum)
    npos = float(wpos)
    nneg = n - npos
    tps = np.cumsum(pos[::-1])
    fps = np.cumsum(neg[::-1])
    thresholds = (np.arange(NBINS)[::-1]) / NBINS
    tpr = tps / max(npos, 1e-12)
    fpr = fps / max(nneg, 1e-12)
    auc = float(np.trapezoid(np.concatenate([[0.0], tpr]),
                             np.concatenate([[0.0], fpr])))
    prec = tps / np.maximum(tps + fps, 1e-12)
    rec = tpr
    pr_auc = float(np.trapezoid(np.concatenate([[prec[0]], prec]),
                                np.concatenate([[0.0], rec])))
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
    best = int(np.argmax(f1))
    thr = float(thresholds[best])
    tp, fp = tps[best], fps[best]
    fn, tn = npos - tp, nneg - fp
    cm = ConfusionMatrix(np.array([[tn, fp], [fn, tp]]),
                         list(domain or ["0", "1"]))
    per_class_err = 0.5 * (fp / max(nneg, 1e-12) + fn / max(npos, 1e-12))
    return ModelMetricsBinomial(
        nobs=n, auc=auc, pr_auc=pr_auc, gini=2 * auc - 1,
        logloss=float(ll) / max(n, 1e-12), mse=float(se) / max(n, 1e-12),
        rmse=float(np.sqrt(float(se) / max(n, 1e-12))),
        mean_per_class_error=float(per_class_err),
        max_f1=float(f1[best]), max_f1_threshold=thr,
        accuracy=float((tp + tn) / max(n, 1e-12)),
        domain=list(domain or ["0", "1"]), cm=cm,
        thresholds=thresholds, tps=tps, fps=fps)


@dataclasses.dataclass
class ModelMetricsRegression:
    nobs: float
    mse: float
    rmse: float
    mae: float
    rmsle: float
    r2: float
    mean_residual_deviance: float

    def describe(self) -> dict:
        return {"rmse": self.rmse, "mae": self.mae, "r2": self.r2,
                "mean_residual_deviance": self.mean_residual_deviance}


def regression_metrics(pred, y, w) -> ModelMetricsRegression:
    err = y - pred
    wsum = w.sum()
    ybar = (w * y).sum() / wsum.clamp_min(1e-12)
    ok = (pred > -1) & (y > -1) & (w > 0)
    sle = torch.where(
        ok, w * (torch.log1p(pred.clamp_min(-1 + 1e-12))
                 - torch.log1p(y.clamp_min(-1 + 1e-12))) ** 2, 0.0).sum()
    se, ae, wsum, sst, sle = torch.stack([
        (w * err * err).sum(), (w * err.abs()).sum(), wsum,
        (w * (y - ybar) ** 2).sum(), sle]).cpu().numpy().astype(np.float64)
    n = max(float(wsum), 1e-12)
    mse = float(se) / n
    return ModelMetricsRegression(
        nobs=float(wsum), mse=mse, rmse=float(np.sqrt(mse)),
        mae=float(ae) / n, rmsle=float(np.sqrt(max(float(sle), 0.0) / n)),
        r2=float(1.0 - float(se) / max(float(sst), 1e-12)),
        mean_residual_deviance=mse)


def make_metrics(di, raw, y, w):
    """Dispatch on the DataInfo's response type — the BigScore metric
    step.  Multinomial responses wait for their slice."""
    if di.is_classifier:
        dom = [str(d) for d in di.response_domain]
        if len(dom) != 2:
            raise NotImplementedError(
                "multinomial metrics are not ported yet (ROADMAP Queue 1)")
        p1 = raw[:, 1] if raw.ndim == 2 else raw
        return binomial_metrics(p1, y, w, domain=dom)
    pred = raw[:, 0] if raw.ndim == 2 else raw
    return regression_metrics(pred, torch.nan_to_num(y), w)
