"""Early stopping — the ScoreKeeper.stopEarly analog (a copy of
``h2o3_tpu/models/scorekeeper.py``, which has no jax in it).

Reference: ``hex/ScoreKeeper.java:17,319`` — convergence test on a moving
average of the chosen stopping metric: stop when the best moving average over
the last ``stopping_rounds`` scoring events fails to improve on the previous
moving average by more than ``stopping_tolerance`` (relative).
"""

from __future__ import annotations

from typing import Sequence


def moving_average(xs: Sequence[float], k: int) -> list:
    out = []
    for i in range(len(xs) - k + 1):
        out.append(sum(xs[i:i + k]) / k)
    return out


def stop_early(values: Sequence[float], stopping_rounds: int,
               tolerance: float, maximize: bool) -> bool:
    """True when the metric's moving average has converged.

    ``values`` is the full scoring-history series (most recent last).
    Mirrors ScoreKeeper.stopEarly: needs at least ``stopping_rounds + 1``
    moving-average points; compares the latest to the best of the earlier
    ones with a relative tolerance.
    """
    k = stopping_rounds
    if k <= 0 or len(values) < 2 * k:
        return False
    ma = moving_average(list(values), k)
    if len(ma) < k + 1:
        return False
    recent = ma[-1]
    reference = ma[:-k] if len(ma) > k else ma[:1]
    best = max(reference) if maximize else min(reference)
    if maximize:
        return recent <= best * (1 + tolerance) if best >= 0 else \
            recent <= best * (1 - tolerance)
    return recent >= best * (1 - tolerance) if best >= 0 else \
        recent >= best * (1 + tolerance)


METRIC_MAXIMIZE = {
    "auc": True, "pr_auc": True, "accuracy": True, "r2": True,
    "logloss": False, "rmse": False, "mse": False, "mae": False,
    "deviance": False, "mean_per_class_error": False, "anomaly_score": False,
}


def metric_direction(name: str, is_classifier: bool) -> tuple:
    """Resolve stopping_metric='auto' -> (metric_name, maximize)."""
    if name in ("auto", "", None):
        return ("logloss", False) if is_classifier else \
            ("mean_residual_deviance", False)
    return name, METRIC_MAXIMIZE.get(name, False)
