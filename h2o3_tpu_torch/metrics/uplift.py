"""Uplift metrics: AUUC (qini/gain/lift) and the qini coefficient.

Reference: ``hex/AUUC.java`` — rows ranked by predicted uplift are bucketed
(default 1000 bins); per-bucket treatment/control response sums give the
uplift curve, its area (AUUC), and the normalized qini coefficient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class ModelMetricsUplift:
    nobs: float
    auuc_qini: float
    auuc_gain: float
    auuc_lift: float
    qini_coefficient: float
    ate: float                     # average treatment effect (observed)

    def describe(self) -> Dict[str, float]:
        return {"auuc_qini": self.auuc_qini, "auuc_gain": self.auuc_gain,
                "auuc_lift": self.auuc_lift,
                "qini": self.qini_coefficient, "ate": self.ate}

    @property
    def r2(self):
        return float("nan")


def uplift_metrics(pred_uplift, y, treatment, weights=None,
                   nbins: int = 1000) -> ModelMetricsUplift:
    """AUUC over the uplift ranking (AUUC.java semantics).

    qini(k) = Y1_t(k) - Y1_c(k) * N_t(k)/N_c(k) over the top-k ranked rows;
    AUUC = mean over buckets; the qini coefficient normalizes against the
    random-ranking diagonal.
    """
    p = np.asarray(pred_uplift, np.float64)
    yy = np.asarray(y, np.float64)
    t = np.asarray(treatment, np.float64)
    w = np.ones_like(p) if weights is None else np.asarray(weights,
                                                           np.float64)
    order = np.argsort(-p, kind="stable")
    yy, t, w = yy[order], t[order], w[order]
    n = len(p)
    nbins = min(nbins, n)
    edges = np.linspace(0, n, nbins + 1).astype(int)[1:]

    cy1t = np.cumsum(w * yy * t)
    cnt = np.cumsum(w * t)
    cy1c = np.cumsum(w * yy * (1 - t))
    cnc = np.cumsum(w * (1 - t))
    k = edges - 1
    y1t, ntr = cy1t[k], cnt[k]
    y1c, nc = cy1c[k], cnc[k]
    ratio = ntr / np.maximum(nc, 1e-12)
    qini = y1t - y1c * ratio
    gain = (y1t / np.maximum(ntr, 1e-12)
            - y1c / np.maximum(nc, 1e-12)) * (ntr + nc)
    lift = (y1t / np.maximum(ntr, 1e-12)
            - y1c / np.maximum(nc, 1e-12))
    auuc_qini = float(np.mean(qini))
    auuc_gain = float(np.mean(gain))
    auuc_lift = float(np.mean(lift))
    # random-ranking baseline: linear ramp to the final qini value
    final = qini[-1]
    random_auuc = float(np.mean(np.linspace(final / nbins, final, nbins)))
    qini_coef = float((auuc_qini - random_auuc)
                      / max(abs(random_auuc), 1e-12)) \
        if abs(random_auuc) > 1e-12 else float("nan")
    ate = float(y1t[-1] / max(ntr[-1], 1e-12)
                - y1c[-1] / max(nc[-1], 1e-12))
    return ModelMetricsUplift(nobs=float(np.sum(w)), auuc_qini=auuc_qini,
                              auuc_gain=auuc_gain, auuc_lift=auuc_lift,
                              qini_coefficient=qini_coef, ate=ate)
