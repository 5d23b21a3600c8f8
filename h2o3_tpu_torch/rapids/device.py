"""Device-side munging primitives: lexicographic rank, gather joins, row
moves — the port of ``h2o3_tpu/rapids/device.py``.

Reference semantics: ``water/rapids/RadixOrder.java`` (distributed MSB
radix sort) and ``water/rapids/BinaryMerge.java`` (per-bucket binary
merge with row expansion).  On the card the sort is
``torch.argsort(stable=True)`` (a radix sort), join matching and
duplicate-row expansion are dense ranks, segment tables and prefix sums,
and grouped float sums reduce contiguous runs of the sorted rows
(``segment_sums``) in a fixed order: no float atomics, so a second run is
bitwise the first.  Besides the results' way to the host, the host
syncs are O(1) scalars (the group and output row counts).

Sort keys are float32, with NA and padding as +inf, as in the JAX
package: integers above 2^24 and times (seconds from the column's base)
that differ below float32's resolution tie.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_TIME, Vec
from ..runtime.device import Cluster

_INF = float("inf")


def sort_key(vec: Vec) -> torch.Tensor:
    """Float32 sort key for one column: NA (and padding) map to +inf."""
    if vec.type == T_CAT:
        return torch.where(vec.data < 0, _INF, vec.data.to(torch.float32))
    return torch.where(torch.isnan(vec.data), _INF, vec.data)


def lex_order(keys: Sequence[torch.Tensor],
              ascending: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Row order sorting lexicographically by ``keys`` (first key primary).

    Successive stable argsorts, least-significant key first (the LSD
    construction).  +inf (NA/padding) stays last under either direction.
    """
    n = keys[0].shape[0]
    asc = [True] * len(keys) if ascending is None else list(ascending)
    order = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for key, a in reversed(list(zip(keys, asc))):
        k = torch.where(torch.isnan(key), _INF, key)
        if not a:
            k = torch.where(torch.isinf(k) & (k > 0), k, -k)
        order = order[torch.argsort(k[order], stable=True)]
    return order


def sorted_rank(keys: Sequence[torch.Tensor]):
    """(order, rank_sorted): the lexicographic row order and, along it,
    each row's 0-based dense rank (non-decreasing)."""
    order = lex_order(keys)
    neq = torch.zeros(order.shape[0] - 1, dtype=torch.bool,
                      device=order.device)
    for k in keys:
        s = torch.where(torch.isnan(k), _INF, k)[order]
        neq = neq | (s[1:] != s[:-1])
    boundary = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=order.device), neq.long()])
    return order, torch.cumsum(boundary, 0)


def dense_rank(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Lexicographic dense rank (0-based) of rows over the key columns.

    Equal rows get equal ranks; all-NA rows (keys pre-mapped to +inf)
    collapse into the single top rank.  One sort and one scatter, no
    hashing.
    """
    order, rank_sorted = sorted_rank(keys)
    return torch.zeros_like(rank_sorted).scatter_(0, order, rank_sorted)


def segment_sums(x_sorted: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of contiguous runs of ``x_sorted`` (``lengths``
    summing to its length), in a fixed order per run: bitwise the same on
    every run of the same device (no float atomics, unlike
    ``index_add_``)."""
    return torch.segment_reduce(x_sorted, "sum", lengths=lengths,
                                unsafe=True)


def gather_rows(frame: Frame, order: torch.Tensor, n_out: int,
                na_mask: Optional[torch.Tensor] = None) -> Frame:
    """New Frame whose row j is ``frame`` row ``order[j]`` (device gather).

    ``order`` may be longer or shorter than the output padding; rows at j
    >= n_out become NA padding.  ``na_mask`` additionally forces NA output
    rows (the unmatched side of a left join).  String, UUID and TIME
    columns gather on the host (they keep their exact host payloads);
    everything else stays on the device.
    """
    dev = frame.device
    p_out = Cluster(dev).pad_rows(n_out)
    order = order.to(dev)
    if order.shape[0] < p_out:
        order = torch.cat([order, torch.zeros(p_out - order.shape[0],
                                              dtype=order.dtype,
                                              device=dev)])
    idx = order[:p_out].long().clamp(0, max(frame.padded_rows - 1, 0))
    live = torch.arange(p_out, device=dev) < n_out
    if na_mask is not None:
        na_mask = na_mask.to(dev)
        mask = na_mask[:p_out] if na_mask.shape[0] >= p_out else \
            torch.cat([na_mask, torch.zeros(p_out - na_mask.shape[0],
                                            dtype=torch.bool, device=dev)])
        live = live & ~mask
    host_idx = host_na = None
    vecs = []
    for v in frame.vecs:
        if v.data is None or v.type == T_TIME:
            if host_idx is None:
                host_idx = idx.cpu().numpy()[:n_out]
                host_na = ~live.cpu().numpy()[:n_out]
            payload = v.host_data[: len(v.host_data)]
            col = payload[np.clip(host_idx, 0, len(payload) - 1)]
            if host_na.any():
                col = np.array(col, copy=True)
                col[host_na] = np.nan if v.type == T_TIME else None
            vecs.append(Vec.from_numpy(col, v.type, device=dev))
        elif v.type == T_CAT:
            g = torch.where(live, v.data[idx], -1)
            vecs.append(Vec(g, T_CAT, n_out, domain=v.domain))
        else:
            g = torch.where(live, v.data[idx], float("nan"))
            vecs.append(Vec(g, v.type, n_out))
    return Frame(frame.names, vecs)


def expand_starts(starts: torch.Tensor, counts: torch.Tensor,
                  p_out: int) -> torch.Tensor:
    """Map output position j -> source row i with starts[i] <= j <
    starts[i] + counts[i].

    The inverse of a ragged expansion: a scatter-max of each row at its
    start (rows with count 0 never own positions), then the owners
    carried forward, as the JAX package's cumulative max does.  With
    ``starts`` ascending the owners rise with their positions, so the
    carry is a forward fill: the k-th owning position's row looked up by
    an int64 ``cumsum`` of the owning positions (``torch.cummax`` took
    29 of a 10M-row merge's 36 device ms on an H100).
    """
    dev = starts.device
    nonzero = counts > 0
    pos = torch.where(nonzero, starts, p_out).clamp(0, p_out).long()
    src = torch.arange(starts.shape[0], dtype=torch.int64, device=dev)
    owner = torch.full((p_out + 1,), -1, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, pos, torch.where(nonzero, src, -1), "amax")[:p_out]
    owns = owner >= 0
    k = torch.cumsum(owns, 0)                # owning positions up to j
    # the k-th owning position's row; the rest write -1 to a spare slot
    row_of = torch.full((p_out + 1,), -1, dtype=torch.int64,
                        device=dev).scatter_(
        0, torch.where(owns, k - 1, p_out), owner)
    return torch.where(k > 0, row_of[(k - 1).clamp_min(0)], -1)
