"""Isotonic regression's pooling step — ``_pav`` of
``h2o3_tpu/models/isotonic.py`` (hex/isotonic/IsotonicRegression.java),
copied: that module imports jax, so the function is copied and not the
module.  The tree family's isotonic calibration uses it
(``tree.shared.SharedTree._post_fit``); the IsotonicRegression builder
waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import numpy as np


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
