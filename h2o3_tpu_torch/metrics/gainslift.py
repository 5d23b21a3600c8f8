"""Gains/Lift table for binomial models — ``hex/GainsLift.java`` analog.

The reference buckets rows into (default) 16 quantile groups of the
predicted probability and reports per-group response/capture/lift plus the
Kolmogorov-Smirnov statistic.  Here the table derives from the same
400-bin score histograms the AUC computation uses (metrics/core.py), so no
extra device pass is needed: group boundaries are score-quantiles read off
the cumulative histogram.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def gains_lift_table(thresholds: np.ndarray, tps: np.ndarray,
                     fps: np.ndarray, groups: int = 16) -> Dict[str, list]:
    """Build the table from descending-threshold cumulatives.

    ``tps[k]``/``fps[k]`` = weighted positives/negatives with score >=
    thresholds[k].  Returns the reference's column set
    (GainsLift.java createTable).
    """
    npos = float(tps[-1])
    nneg = float(fps[-1])
    n = npos + nneg
    if n <= 0 or npos <= 0:
        return {"group": [], "cumulative_data_fraction": [], "lift": [],
                "kolmogorov_smirnov": []}
    cum_frac = (tps + fps) / n
    base_rate = npos / n

    rows = []
    prev_frac = 0.0
    prev_capture = 0.0
    ks_max = 0.0
    for g in range(1, groups + 1):
        target = g / groups
        k = int(np.searchsorted(cum_frac, target, side="left"))
        k = min(k, len(cum_frac) - 1)
        frac = float(cum_frac[k])
        if frac <= prev_frac and g < groups:
            continue                      # ties collapse groups (reference)
        capture = float(tps[k]) / npos    # cumulative capture rate
        resp_cum = float(tps[k]) / max(float(tps[k] + fps[k]), 1e-12)
        d_frac = frac - prev_frac
        d_capture = capture - prev_capture
        lift = (d_capture / d_frac) if d_frac > 0 else 0.0
        cum_lift = capture / max(frac, 1e-12)
        resp_rate = lift * base_rate
        ks = float(tps[k]) / npos - float(fps[k]) / max(nneg, 1e-12)
        ks_max = max(ks_max, ks)
        rows.append({
            "group": len(rows) + 1,
            "cumulative_data_fraction": frac,
            "lower_threshold": float(thresholds[k]),
            "lift": lift,
            "cumulative_lift": cum_lift,
            "response_rate": resp_rate,
            "cumulative_response_rate": capture / max(frac, 1e-12)
            * base_rate,
            "capture_rate": d_capture,
            "cumulative_capture_rate": capture,
            "gain": 100.0 * (lift - 1.0),
            "cumulative_gain": 100.0 * (cum_lift - 1.0),
            "kolmogorov_smirnov": ks,
        })
        prev_frac, prev_capture = frac, capture
    table: Dict[str, list] = {k: [r[k] for r in rows] for k in rows[0]} \
        if rows else {}
    table["_ks"] = [ks_max]
    return table


def concordance_index(event_time: np.ndarray, event: np.ndarray,
                      risk: np.ndarray, weights=None) -> float:
    """Survival concordance (Harrell's C) — CoxPH concordance analog.

    Comparable pairs: i with an observed event and t_i < t_j.  Concordant
    when the earlier-event row has the HIGHER risk score.  O(n^2) in
    blocked numpy — fine for coordinator-side metric computation.
    """
    t = np.asarray(event_time, np.float64)
    e = np.asarray(event, bool)
    r = np.asarray(risk, np.float64)
    w = np.ones_like(t) if weights is None else np.asarray(weights,
                                                           np.float64)
    ok = np.isfinite(t) & np.isfinite(r)
    t, e, r, w = t[ok], e[ok], r[ok], w[ok]
    num = den = 0.0
    idx = np.flatnonzero(e)
    for i in idx:
        later = t > t[i]
        pw = w[i] * w[later]
        den += pw.sum()
        num += pw[r[i] > r[later]].sum() + 0.5 * pw[r[i] == r[later]].sum()
    return float(num / den) if den > 0 else float("nan")
