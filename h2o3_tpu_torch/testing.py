"""What the port's tests and ``chip_smoke.py`` share: bitwise equality of
f32 tensors, a records histogram with a planted tie, the 3-class
``delay_class`` response of the bench frame, trees carried across from
the JAX package (``trees_from_reference``) and the training kernels'
plain route on a card (``plain_route``)."""

from __future__ import annotations

import contextlib

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


def trees_from_reference(trees, device="cpu") -> list:
    """The JAX package's grown trees (objects with per-level ``feat``,
    ``thr``, ``na_left``, ``valid`` lists, ``values`` and an optional
    ``cover``, held in any array type numpy reads) as the port's
    ``shared.Tree``s on ``device``: each array through ``np.asarray``, in
    the dtypes the port's builds give (int32 features, f32 thresholds
    and values, bool NA directions and valid flags)."""
    from .models.tree.shared import Tree

    def dev(a, dtype):
        return torch.from_numpy(np.array(np.asarray(a), dtype=dtype)) \
            .to(device)

    out = []
    for t in trees:
        cover = getattr(t, "cover", None)
        out.append(Tree(
            feat=[dev(a, np.int32) for a in t.feat],
            thr=[dev(a, np.float32) for a in t.thr],
            na_left=[dev(a, np.bool_) for a in t.na_left],
            valid=[dev(a, np.bool_) for a in t.valid],
            values=dev(t.values, np.float32),
            cover=None if cover is None else dev(cover, np.float32)))
    return out


@contextlib.contextmanager
def plain_route(hist):
    """``hist_varbin``, ``hist_uniform``, ``split_records`` (every form)
    and ``slot_compact`` of the ``hist`` module swapped for the port's own
    plain torch versions while the block runs: on a card, the oracle
    train of the kernels' one (the fixed-point contract makes the two
    bitwise)."""
    real = (hist.hist_varbin, hist.hist_uniform, hist.split_records,
            hist.slot_compact)

    def varbin(gcodes, leaf, stats, L, bc, B, scale=None, row_start=None):
        return hist.hist_varbin_torch(gcodes, leaf, stats, L,
                                      hist.packed_layout(tuple(bc), B),
                                      scale)

    def uniform(codes, leaf, stats, L, B, planes=3, scale=None,
                row_start=None):
        return hist.hist_uniform_torch(codes, leaf, stats, L, B, planes,
                                       scale)

    def records(Hist, nbins, *args, mono=None):
        return hist._split_records_torch(Hist, *args, mono)

    (hist.hist_varbin, hist.hist_uniform, hist.split_records,
     hist.slot_compact) = (varbin, uniform, records,
                           hist.slot_compact_torch)
    try:
        yield
    finally:
        (hist.hist_varbin, hist.hist_uniform, hist.split_records,
         hist.slot_compact) = real
