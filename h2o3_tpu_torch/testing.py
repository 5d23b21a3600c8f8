"""What the port's tests and ``chip_smoke.py`` share: bitwise equality of
f32 tensors, a records histogram with a planted tie, and the 3-class
``delay_class`` response of the bench frame."""

from __future__ import annotations

import numpy as np
import torch


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal f32 tensors (NaNs with the same bits included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def tie_hist(a: int, b: int, L: int, F: int) -> np.ndarray:
    """Integer-valued H [3, L, F, a + b + 3] whose regular bins mirror
    each other (NA bin empty), so that the splits after bins ``a`` and
    ``b`` score the same gain, bit for bit, and the best: bins 0..a and
    their mirror carry +5 of g, the others -1."""
    nbins = a + b + 2
    k = np.arange(nbins)
    g = np.where((k <= a) | (k >= nbins - 1 - a), 5.0, -1.0)
    row = np.stack([g, np.ones(nbins), np.full(nbins, 20.0)])
    row = np.concatenate([row, np.zeros((3, 1))], axis=1)
    return np.broadcast_to(row[:, None, None, :], (3, L, F, nbins + 1)) \
        .astype(np.float32).copy()


def delay_class(cols) -> np.ndarray:
    """The 3-class ``delay_class`` response of the airlines-shaped bench
    frame (``make_airlines_like``'s columns): "NO" where
    ``dep_delayed_15min`` is "NO", else "LONG" where the scheduled
    departure ``crs_dep_time`` is 1700 or later, else "SHORT"."""
    late = np.asarray(cols["crs_dep_time"]) >= 1700
    return np.where(np.asarray(cols["dep_delayed_15min"]) == "NO", "NO",
                    np.where(late, "LONG", "SHORT")).astype(object)
