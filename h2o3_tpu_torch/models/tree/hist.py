"""Histogram, split-search and partition steps of tree training — the
level path of ``h2o3_tpu/models/tree/hist.py``.

Reference hot loop: ``hex/tree/DHistogram.java`` (per-(leaf, column, bin)
sums of the gradient statistics) and XGBoost's ``gpu_hist``.  One tree
level is: the level histogram ``H[3, L, F, B]`` of (Σg, Σh, Σw) per
(leaf, feature, bin) -> the per-(leaf, feature) winner records -> the
per-leaf best split -> the row partition into child leaves.  ``B`` counts
``nbins`` regular bins and the NA bin last.

Kernels (``csrc/``, built by ``native.py``), each beside its plain torch
version:

* ``hist_uniform`` / ``hist_varbin`` -> ``csrc/hist.cu``: the histogram
  on the uniform bin axis (JAX ``_make_pallas_hist``) and on the packed
  per-feature axis (JAX ``_make_pallas_varbin_hist``); plain versions
  ``hist_uniform_torch`` / ``hist_varbin_torch``, one int64 ``index_add_``
  each;
* ``split_records`` -> ``csrc/split_records.cu`` (JAX
  ``_make_pallas_split_records``); plain version ``_split_records_torch``
  (the JAX package's ``_split_records_xla`` with its prefix sums taken in
  sequential order);
* ``fine_hist`` -> ``csrc/fine_hist.cu`` (JAX ``_make_pallas_fine_hist``):
  the fine bins inside the K super-bins the hierarchical split search
  chose per (leaf, feature); plain version ``fine_hist_torch``, one
  int64 ``index_add_``.

The three histograms sum in int64 fixed point (``stat_scale``,
``quantize``; ``csrc/hist_common.cuh`` holds the kernels' shared tile):
their sums are exact, so each is bitwise the same on every run and
bitwise its plain version, on any stats.

The hierarchical search around it (``select_superbins``,
``best_splits_hier``) is plain torch: the JAX package computes it outside
any kernel too.

A wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors.  The JAX package's one-hot matmul lookups
(``table_lookup``) were a TPU workaround; here they are plain gathers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ... import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

HIST = native.Kernel("hist", {
    "hist_launch": ((_P, _I, _L, _P, _P, _L, _P, _P, _I, _P, _I, _I, _I, _I,
                     _I, _P, _L, _L, _L, _P), _I),
})
SPLIT_RECORDS = native.Kernel("split_records", {
    "split_records_launch": ((_P, _I, _I, _F, _F, _F, _F, _F, _P, _P), _I),
})
FINE_HIST = native.Kernel("fine_hist", {
    "fine_hist_launch": ((_P, _I, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                          _P, _I, _I, _I, _I, _P, _P), _I),
})

_REC_PLANES = 12
# shared memory one histogram block may use: two blocks of 512 threads
# then fit one SM (227 KB each at most)
HIST_SMEM_BUDGET = 96 * 1024
_HIST_THREADS = 512
# a small tile's copies stop where four such blocks, a full SM of threads,
# would no longer fit its shared memory
_COPIES_SMEM = 227 * 1024 // 4
# the most copies of a small tile, one per lane of a warp
# (chip_smoke.py sets 1 to time the tiles without copies)
MAX_COPIES = 32
# bytes of one fixed-point sum in a histogram tile (int64)
_SLOT_BYTES = 8


# ------------------------------------------------- fixed-point arithmetic
#
# Every histogram sums its stats in int64 fixed point: plane p's values
# are quantised once, round-half-even(x * 2^s_p), summed exactly (so in
# any order, and the kernel and its plain version bitwise alike), and the
# sum is dequantised once, int64 -> f64 -> x 2^-s_p -> f32.

_SUM_BITS = 62


def stat_scale(stats: torch.Tensor) -> torch.Tensor:
    """The fixed-point scales of the stat planes [3, n]: a [2, 3] f64
    tensor on the stats' device, row 0 each plane's 2^s_p, row 1 its
    inverse 2^-s_p, or NaN where the plane holds a NaN or an infinity
    (that plane's histograms are then NaN throughout).

    s_p = 62 - e_p with sum_r |x_p,r| < 2^e_p (the plane's L1 norm, in
    f64), so that the quantised rows' |values| add up to under 2^62 plus
    n/2 of rounding: no slot, partial or total of a histogram over these
    rows can leave int64.  A slot of k rows is then within k * 2^-(s_p+1)
    <= k * sum|x_p| * 2^-62 of its exact sum before the one rounding to
    f32.  Computed on the device: the host reads nothing.  Both powers of
    two are built from their exponent bits, exactly."""
    m = torch.linalg.vector_norm(stats, 1, dim=1, dtype=torch.float64)
    finite = torch.isfinite(m)
    _, e = torch.frexp(torch.where(finite, m, 0.0))
    s = _SUM_BITS - e.long()
    q = ((s + 1023) << 52).view(torch.float64)
    inv = ((1023 - s) << 52).view(torch.float64)
    return torch.stack([q, torch.where(finite, inv, torch.nan)])


def quantize(stats: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[3, n] stats -> their int64 fixed-point values round-half-even(x *
    2^s_p) (``torch.round``, as ``__double2ll_rn`` in the kernels).  A
    plane whose scale marks a non-finite stat quantises to 0: its
    histogram is NaN whatever it sums."""
    q = torch.round(stats.double() * scale[0][:, None])
    return torch.where(torch.isfinite(scale[1])[:, None], q, 0.0).long()


def _dequantize(sums: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """int64 sums x their planes' 2^-s_p (broadcast) -> f32."""
    return (sums.double() * inv).float()


def _check_scale(scale, stats) -> torch.Tensor:
    """The caller's scale (a ``stat_scale`` of the tree's stats), or this
    call's own."""
    if scale is None:
        return stat_scale(stats)
    if scale.shape != (2, 3) or scale.dtype != torch.float64 \
            or scale.device != stats.device:
        raise ValueError(f"scale must be stat_scale's [2, 3] f64 tensor on "
                         f"{stats.device}")
    return scale.contiguous()


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {what} for device {t.device}")


# ---------------------------------------------------------------- layouts

@dataclasses.dataclass(frozen=True)
class HistLayout:
    """Where each feature's bins lie on the packed bin axis q.

    Row r of feature f adds to q = code_off[f] + codes[f, r] when q lies
    in its segment [qstart[f], qstart[f] + qlen[f]); Q rows in all."""

    code_off: Tuple[int, ...]
    qstart: Tuple[int, ...]
    qlen: Tuple[int, ...]
    Q: int

    @property
    def F(self) -> int:
        return len(self.qstart)


@functools.lru_cache(maxsize=None)
def uniform_layout(F: int, B: int) -> HistLayout:
    """B bins per feature, raw codes: q = f * B + code."""
    off = tuple(f * B for f in range(F))
    return HistLayout(off, off, (B,) * F, F * B)


def varbin_layout(bin_counts, B: int):
    """Packed ragged bin-axis layout: per-feature [offset, B_f regular bins,
    NA slot], each segment 8-padded with at least one spare slot.

    Returns (offsets[F], segment row counts [F], total rows Q8, and the
    dense gather map [F, B+1] -> packed row, with empty bins pointing at
    padding slots that stay zero).  A copy of the JAX package's layout.
    """
    offsets, rows = [], []
    q = 0
    for bf in bin_counts:
        bf = min(bf, B - 1)
        seg = ((bf + 2) + 7) // 8 * 8
        offsets.append(q)
        rows.append(seg)
        q += seg
    qmap = np.zeros((len(bin_counts), B + 1), np.int32)
    for f, bf in enumerate(bin_counts):
        bf = min(bf, B - 1)
        for b in range(B + 1):
            if b < bf:
                qmap[f, b] = offsets[f] + b
            elif b == B:
                qmap[f, b] = offsets[f] + bf
            else:
                qmap[f, b] = offsets[f] + rows[f] - 1
    return (np.asarray(offsets, np.int32), np.asarray(rows, np.int32),
            q, qmap)


@functools.lru_cache(maxsize=None)
def packed_layout(bin_counts: tuple, B: int) -> HistLayout:
    """The varbin layout as a HistLayout: codes arrive pre-offset
    (``offset_codes``), so code_off is 0."""
    offsets, rows, Q8, _ = varbin_layout(bin_counts, B)
    return HistLayout((0,) * len(bin_counts), tuple(int(o) for o in offsets),
                      tuple(int(r) for r in rows), int(Q8))


@functools.lru_cache(maxsize=None)
def _qmap_dense(bin_counts: tuple, B: int) -> np.ndarray:
    """[F*B] packed row of each dense (feature, bin); bins 0..B-2 regular,
    B-1 the NA slot."""
    _, _, _, qmap = varbin_layout(bin_counts, B)
    return np.ascontiguousarray(
        qmap[:, list(range(B - 1)) + [B]].reshape(-1)).astype(np.int64)


def offset_codes(codes: torch.Tensor, bin_counts, nbins: int) -> torch.Tensor:
    """codes [F, N] (NA == nbins) -> packed bin ids of the varbin layout;
    int16 when every id fits, as in the JAX package (it halves the bytes
    the histogram reads at every level of the tree)."""
    offsets, _, Q8, _ = varbin_layout(bin_counts, nbins + 1)
    dev = codes.device
    off = torch.as_tensor(offsets, dtype=torch.int32, device=dev)[:, None]
    bf = torch.as_tensor([min(b, nbins) for b in bin_counts],
                         dtype=torch.int32, device=dev)[:, None]
    out = torch.where(codes >= nbins, off + bf, codes + off)
    return out.to(torch.int16 if Q8 < 32_000 else torch.int32)


def hist_tiles(layout: HistLayout, L: int, budget: int = HIST_SMEM_BUDGET,
               planes: int = 3) -> Tuple[np.ndarray, int]:
    """Cut the [Q, L] output into tiles of (contiguous feature range) x
    (leaf range) of at most ``budget`` bytes of shared memory.

    The leaf range is the largest even split of L at which the widest
    feature segment fits; features are then packed greedily at that
    width.  Returns ([T, 8] int32 rows fa, fb, qa, qn, l0, ln, use_smem,
    copies) and the shared-memory bytes of the largest block.  A feature
    whose segment alone exceeds the budget at one leaf gets a tile with
    use_smem = 0 (global atomics).  A small tile is kept in ``copies``
    side by side, the largest power of two up to ``MAX_COPIES`` whose
    copies (each one slot longer, for the banks) stay within
    ``_COPIES_SMEM``: lane l of a warp adds into copy l % copies and the
    kernel sums them at the end, so fewer lanes of one add collide on a
    hot bin.  Each bin holds
    ``planes`` int64 fixed-point sums: (g, h, w), and |g| with
    planes = 4."""
    per_q = planes * _SLOT_BYTES
    widest = max(layout.qlen)
    lt_max = budget // (per_q * widest)
    groups = max(1, -(-L // max(lt_max, 1)))
    Lt = -(-L // groups)
    tiles = []
    fa = 0
    F = layout.F
    while fa < F:
        fb = fa + 1
        while fb < F and (layout.qstart[fb] + layout.qlen[fb]
                          - layout.qstart[fa]) * Lt * per_q <= budget:
            fb += 1
        qa = layout.qstart[fa]
        qn = layout.qstart[fb - 1] + layout.qlen[fb - 1] - qa
        smem = int(qn * Lt * per_q <= budget)
        for l0 in range(0, L, Lt):
            ln = min(Lt, L - l0)
            fit = _COPIES_SMEM // (qn * ln * per_q + _SLOT_BYTES)
            copies = 1 << (min(MAX_COPIES, fit).bit_length() - 1) \
                if smem and fit >= 2 else 1
            tiles.append((fa, fb, qa, qn, l0, ln, smem, copies))
        fa = fb
    arr = np.asarray(tiles, np.int32)
    used = arr[:, 6] == 1
    cp = arr[used, 7]
    smem_bytes = int((cp * (arr[used, 3] * arr[used, 5] * per_q
                            + _SLOT_BYTES * (cp > 1))).max()) \
        if used.any() else 0
    return arr, smem_bytes


@functools.lru_cache(maxsize=None)
def _device_meta(layout: HistLayout, L: int, device: str, planes: int = 3):
    """The layout's [3, F] feature table and its [T, 8] tiles on the
    device, uploaded once per (layout, L, device, planes)."""
    tiles, smem = hist_tiles(layout, L, planes=planes)
    meta = np.asarray([layout.code_off, layout.qstart, layout.qlen],
                      np.int32)
    dev = torch.device(device)
    return (torch.from_numpy(meta).to(dev), torch.from_numpy(tiles).to(dev),
            int(tiles.shape[0]), smem)


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def _rows_per_block(n: int, n_tiles: int, smem: int, device: str) -> int:
    """Rows per block: enough blocks for two waves of the card, at least
    2,048 rows a block, at most 65,535 row blocks (the grid's y limit)."""
    per_sm = max(1, min(2048 // _HIST_THREADS,
                        (227 * 1024) // max(smem, 1)))
    target = 2 * _sm_count(device) * per_sm
    chunks = max(1, min(-(-n // 2048), -(-target // n_tiles)))
    rows = -(-n // chunks)
    return max(rows, -(-n // 65_535))


# --------------------------------------------------- histogram: kernel path

def _check_hist_operands(codes, leaf, stats):
    if codes.dim() != 2 or codes.dtype not in (torch.int16, torch.int32):
        raise ValueError("codes must be a [F, n] int16/int32 tensor")
    n = codes.shape[1]
    if leaf.shape != (n,) or leaf.dtype != torch.int32:
        raise ValueError("leaf must be an [n] int32 tensor")
    if stats.dim() != 2 or stats.shape[0] != 3 or stats.shape[1] != n \
            or stats.dtype != torch.float32:
        raise ValueError("stats must be a [3, n] f32 tensor")
    for name, t in (("codes", codes), ("leaf", leaf), ("stats", stats)):
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on "
                             f"{codes.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} rows must be contiguous")


def _launch_hist(codes, leaf, stats, scale, L: int, layout: HistLayout,
                 out: torch.Tensor, strides, planes: int = 3) -> None:
    """Launch ``csrc/hist.cu`` adding the level histogram into ``out``
    (int64 fixed point, zeroed by the caller) through ``strides`` = (s,
    l, q)."""
    dev = codes.device
    n = codes.shape[1]
    meta, tiles, n_tiles, smem = _device_meta(layout, L, str(dev), planes)
    if n == 0:
        return
    rpb = _rows_per_block(n, n_tiles, smem, str(dev))
    lib = HIST.lib()
    with torch.cuda.device(dev):
        rc = lib.hist_launch(
            codes.data_ptr(), codes.element_size(), codes.stride(0),
            leaf.data_ptr(), stats.data_ptr(), stats.stride(0),
            scale.data_ptr(), meta.data_ptr(), layout.F, tiles.data_ptr(),
            n_tiles, n, rpb, smem, planes, out.data_ptr(), strides[0],
            strides[1], strides[2],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    HIST.count()


def _plane_inv(scale, planes: int) -> torch.Tensor:
    """[planes, 1, 1, 1] inverse scales of a dense histogram's planes: g,
    h, w, and g's again for |g| (built on the device: an index list would
    be a host-to-device copy, which waits for the stream)."""
    inv = scale[1] if planes == 3 else torch.cat([scale[1], scale[1][:1]])
    return inv.view(planes, 1, 1, 1)


def hist_uniform_torch(codes, leaf, stats, L: int, B: int, planes: int = 3,
                       scale=None) -> torch.Tensor:
    """Plain torch level histogram on the uniform axis: the stats
    quantised (``quantize``), one int64 ``index_add_`` over the flattened
    (leaf, feature, bin) index, dequantised to f32.  codes [F, n], leaf
    [n], stats [3, n] -> H [planes, L, F, B]; planes = 4 adds Σ|g| as
    plane 3; ``scale`` is ``stat_scale(stats)`` unless given."""
    F, n = codes.shape
    dev = codes.device
    scale = stat_scale(stats) if scale is None else scale
    qs = quantize(stats, scale)
    if planes == 4:
        qs = torch.cat([qs, qs[:1].abs()])
    c = codes.long()
    lf = leaf.long()
    ok = ((lf >= 0) & (lf < L))[None, :] & (c >= 0) & (c < B)
    idx = (lf[None, :] * F + torch.arange(F, device=dev)[:, None]) * B + c
    src = qs[:, None, :].expand(planes, F, n)
    out = torch.zeros((planes, L * F * B), dtype=torch.int64, device=dev)
    out.index_add_(1, idx[ok], src[:, ok])
    return _dequantize(out.view(planes, L, F, B), _plane_inv(scale, planes))


def hist_uniform(codes, leaf, stats, L: int, B: int, planes: int = 3,
                 scale=None) -> torch.Tensor:
    """Level histogram on the uniform bin axis -> H [planes, L, F, B] f32.

    codes [F, n] int16/int32 in [0, B), leaf [n] int32 (rows outside
    [0, L) add nothing), stats [3, n] f32 = (g, h, w); ``planes=4`` adds
    Σ|g| as plane 3, as the JAX ``make_hist_fn(..., planes=4)``.  Sums
    are int64 fixed point on ``scale`` (``stat_scale``; this call's own
    when None): exact, the same on every run.  CUDA tensors launch
    ``csrc/hist.cu`` (counted in ``HIST.launches``); CPU tensors take
    ``hist_uniform_torch``."""
    _check_hist_operands(codes, leaf, stats)
    if planes not in (3, 4):
        raise ValueError(f"planes={planes}: use 3 or 4")
    scale = _check_scale(scale, stats)
    if not _on_cuda(codes, "histogram"):
        return hist_uniform_torch(codes, leaf, stats, L, B, planes, scale)
    F = codes.shape[0]
    out = torch.zeros((planes, L, F * B), dtype=torch.int64,
                      device=codes.device)
    _launch_hist(codes, leaf, stats, scale, L, uniform_layout(F, B), out,
                 (L * F * B, F * B, 1), planes)
    return _dequantize(out.view(planes, L, F, B), _plane_inv(scale, planes))


def hist_varbin_torch(gcodes, leaf, stats, L: int, layout: HistLayout,
                      scale=None) -> torch.Tensor:
    """Plain torch level histogram on the packed axis: the stats
    quantised, one int64 ``index_add_`` over the flattened (packed bin,
    leaf) index, dequantised to f32.  gcodes [F, n] (pre-offset), leaf
    [n], stats [3, n] -> [Q8, 3L], column 3 l + s."""
    F, n = gcodes.shape
    dev = gcodes.device
    scale = stat_scale(stats) if scale is None else scale
    qs = quantize(stats, scale)
    q = gcodes.long()
    lf = leaf.long()
    lo = torch.as_tensor(layout.qstart, device=dev)[:, None]
    hi = lo + torch.as_tensor(layout.qlen, device=dev)[:, None]
    ok = ((lf >= 0) & (lf < L))[None, :] & (q >= lo) & (q < hi)
    idx = q * L + lf[None, :]
    src = qs.t()[None, :, :].expand(F, n, 3)
    out = torch.zeros((layout.Q * L, 3), dtype=torch.int64, device=dev)
    out.index_add_(0, idx[ok], src[ok])
    return _dequantize(out, scale[1]).view(layout.Q, 3 * L)


def hist_varbin(gcodes, leaf, stats, L: int, bin_counts: tuple, B: int,
                scale=None) -> torch.Tensor:
    """Level histogram on the packed per-feature axis -> [Q8, 3L] f32
    (row q, column 3 l + s; expand with ``expand_varbin``).

    gcodes [F, n] are pre-offset packed ids (``offset_codes``); sums as in
    ``hist_uniform``.  CUDA tensors launch ``csrc/hist.cu`` (counted in
    ``HIST.launches``); CPU tensors take ``hist_varbin_torch``."""
    _check_hist_operands(gcodes, leaf, stats)
    layout = packed_layout(tuple(bin_counts), B)
    scale = _check_scale(scale, stats)
    if not _on_cuda(gcodes, "histogram"):
        return hist_varbin_torch(gcodes, leaf, stats, L, layout, scale)
    out = torch.zeros((layout.Q * L, 3), dtype=torch.int64,
                      device=gcodes.device)
    _launch_hist(gcodes, leaf, stats, scale, L, layout, out, (1, 3, 3 * L))
    return _dequantize(out, scale[1]).view(layout.Q, 3 * L)


def expand_varbin(packed: torch.Tensor, bin_counts: tuple, L: int,
                  B: int) -> torch.Tensor:
    """[Q8, 3L] packed histogram -> the dense [3, L, F, B] contract
    through the static qmap gather (hist.py:389-395 of the JAX package)."""
    F = len(bin_counts)
    qd = torch.as_tensor(_qmap_dense(tuple(bin_counts), B),
                         device=packed.device)
    H = packed.index_select(0, qd)                    # [F*B, 3L]
    return H.view(F, B, L, 3).permute(3, 2, 0, 1).contiguous()


def local_hist(codes, leaf, stats, L: int, F: int, B: int,
               bin_counts=None, scale=None) -> torch.Tensor:
    """Level histogram in the dense [3, L, F, B] contract: the varbin
    layout when ``bin_counts`` is given (codes pre-offset), else the
    uniform one (the JAX package's ``make_hist_fn`` and
    ``make_varbin_hist_fn``; one device, so no psum)."""
    if bin_counts is not None:
        packed = hist_varbin(codes, leaf, stats, L, tuple(bin_counts), B,
                             scale)
        return expand_varbin(packed, tuple(bin_counts), L, B)
    return hist_uniform(codes, leaf, stats, L, B, scale=scale)


def make_subtract_level_fn(d: int, F: int, B: int, bin_counts=None):
    """Level-``d`` histogram by smaller-sibling compaction + parent
    subtraction (the JAX package's ``make_subtract_level_fn``;
    DHistogram / LightGBM / gpu_hist's halving).

    Each parent's child with fewer rows is compacted into a dense prefix
    of ``n // 2`` rows (a cumsum-positioned scatter: ``index_copy_`` of a
    permutation that puts the chosen rows first), only that prefix is
    histogrammed at the parent-slot geometry, and the larger sibling is
    ``H_parent - H_small`` in f32 with its h/w planes clamped at 0.
    Rows of the prefix past the compacted count carry leaf -1 and add
    nothing.  Returns ``fn(codes, leaf, g, h, w[, carry]) -> (H, carry)``
    where ``carry`` is the level's own histogram, the next level's
    parent; ``fn.stacked(codes, leaf, stats, carry, scale)`` takes the
    stats already stacked as [3, n] and the tree's ``stat_scale`` (by
    default that of these stats, which the compacted prefix then shares).
    """
    bc = tuple(bin_counts) if bin_counts is not None else None
    Lp = 2 ** max(d - 1, 0)
    Lc = 2 ** d

    def level(codes, leaf, stats, carry=None, scale=None):
        scale = stat_scale(stats) if scale is None else scale
        if d == 0:
            H = local_hist(codes, leaf, stats, 1, F, B, bc, scale)
            return H, H
        if carry is None:
            raise ValueError(f"level {d} needs the previous level's carry")
        n = codes.shape[1]
        cap = n // 2
        dev = codes.device
        # rows per child: a shared-memory histogram of the leaf ids
        # (exact in f64; bincount would sync the host for its length, and
        # an index_add_ of ones piles every row's atomic on 2^d addresses)
        cnt = torch.histc(leaf.double(), bins=Lc, min=0, max=Lc)
        small_is_left = cnt[0::2] <= cnt[1::2]                     # [Lp]
        chosen_child = torch.stack([small_is_left, ~small_is_left],
                                   dim=1).reshape(-1)              # [Lc]
        chosen = chosen_child[leaf.long()]
        # a permutation: the chosen rows, in order, to the prefix, every
        # other row after them (distinct targets, so no write contention)
        c_incl = torch.cumsum(chosen, dim=0)
        row = torch.arange(n, device=dev)
        target = torch.where(chosen, c_incl - 1, c_incl[-1] + row - c_incl)
        ccodes = torch.empty_like(codes).index_copy_(1, target, codes)
        pleaf = torch.empty_like(leaf).index_copy_(
            0, target, torch.where(chosen, leaf >> 1, -1))
        st = torch.empty_like(stats).index_copy_(1, target, stats)
        Hs = local_hist(ccodes[:, :cap], pleaf[:cap], st[:, :cap], Lp, F,
                        B, bc, scale)                              # [3,Lp,F,B]
        Ho = carry - Hs
        Ho[1:].clamp_min_(0.0)
        sl = small_is_left[None, :, None, None]
        Hl = torch.where(sl, Hs, Ho)
        Hr = torch.where(sl, Ho, Hs)
        H = torch.stack([Hl, Hr], dim=2).reshape(3, Lc, F, B)
        return H, H

    def fn(codes, leaf, g, h, w, carry=None):
        return level(codes, leaf, torch.stack([g, h, w]).to(torch.float32),
                     carry)

    fn.stacked = level
    return fn


# ------------------------------------------- hierarchical search: histograms

def superbin_geometry(nbins: int) -> Tuple[int, int]:
    """(S, W): S super-bins of W fine bins each, as the JAX package's
    ``make_build_tree_fn`` cuts them (S = 16 from 128 bins up, else 8)."""
    S = 16 if nbins >= 128 else 8
    return S, -(-nbins // S)


def coarse_codes(codes: torch.Tensor, nbins: int) -> torch.Tensor:
    """codes [F, N] (NA == nbins) -> super-bin ids, NA -> S; int16."""
    S, W = superbin_geometry(nbins)
    return torch.where(codes >= nbins, S, codes // W).to(torch.int16)


@functools.lru_cache(maxsize=None)
def _fine_meta(L: int, F: int, K: int, W: int, device: str):
    """The fine histogram's tiles on the device and its shared memory:
    ``hist_tiles`` over F segments of K*W slots, plus the largest tile's
    [leaves, features, K] slice of sel."""
    tiles, smem = hist_tiles(uniform_layout(F, K * W), L)
    sel_ints = int((tiles[:, 5] * (tiles[:, 1] - tiles[:, 0])).max()) * K
    sel_bytes = -(-sel_ints * 4 // _SLOT_BYTES) * _SLOT_BYTES   # aligned
    return (torch.from_numpy(tiles).to(torch.device(device)),
            int(tiles.shape[0]), smem + sel_bytes)


def fine_slots(codes, leaf, sel, W: int, nbins: int):
    """Each (feature, k, row)'s flat output slot ((l*F + f)*K + k)*W + t
    and whether it lands: the row's leaf l is in [0, L), its code is a
    regular bin and falls on sel[l, f, k]'s super-bin.  [F, K, n] each."""
    L, F, K = sel.shape
    dev = codes.device
    c = codes.long()                                           # [F, n]
    lf = leaf.long()
    lc = lf.clamp(0, L - 1)
    s_of = sel.long()[lc].permute(1, 2, 0)                     # [F, K, n]
    ok = (s_of == (c // W)[:, None, :]) \
        & ((c >= 0) & (c < nbins))[:, None, :] \
        & ((lf >= 0) & (lf < L))[None, None, :]
    f_ix = torch.arange(F, device=dev)[:, None, None]
    k_ix = torch.arange(K, device=dev)[None, :, None]
    idx = ((lc[None, None, :] * F + f_ix) * K + k_ix) * W \
        + (c % W)[:, None, :]
    return idx, ok


def fine_hist_torch(codes, leaf, stats, sel, W: int, nbins: int,
                    scale=None) -> torch.Tensor:
    """Plain torch fine histogram: the stats quantised, one int64
    ``index_add_`` over the flattened (leaf, feature, k, t) slot,
    dequantised to f32.  codes [F, n], leaf [n], stats [3, n], sel
    [L, F, K] -> H [3, L, F, K, W]; slot (l, f, k, t) sums the rows with
    leaf l and code sel[l, f, k] * W + t.  NA rows (code >= nbins) and
    rows whose leaf is outside [0, L) add nothing."""
    L, F, K = sel.shape
    scale = stat_scale(stats) if scale is None else scale
    qs = quantize(stats, scale)
    idx, ok = fine_slots(codes, leaf, sel, W, nbins)
    src = qs[:, None, None, :].expand(3, F, K, codes.shape[1])
    out = torch.zeros((3, L * F * K * W), dtype=torch.int64,
                      device=codes.device)
    out.index_add_(1, idx[ok], src[:, ok])
    return _dequantize(out.view(3, L, F, K, W),
                       scale[1].view(3, 1, 1, 1, 1))


def fine_hist(codes, leaf, stats, sel, W: int, nbins: int,
              scale=None) -> torch.Tensor:
    """Fine histogram of the K chosen super-bins -> H [3, L, F, K, W] f32.

    codes [F, n] int16/int32 raw bin codes (NA == nbins), leaf [n] int32,
    stats [3, n] f32 = (g, h, w), sel [L, F, K] int32 super-bin ids; sums
    as in ``hist_uniform``.  CUDA tensors launch ``csrc/fine_hist.cu``
    (counted in ``FINE_HIST.launches``); CPU tensors take
    ``fine_hist_torch``."""
    _check_hist_operands(codes, leaf, stats)
    if sel.dim() != 3 or sel.shape[1] != codes.shape[0] \
            or sel.dtype != torch.int32:
        raise ValueError(f"sel must be an [L, {codes.shape[0]}, K] int32 "
                         f"tensor, got {tuple(sel.shape)} {sel.dtype}")
    if sel.device != codes.device:
        raise ValueError(f"sel is on {sel.device}, codes on {codes.device}")
    scale = _check_scale(scale, stats)
    if not _on_cuda(codes, "fine histogram"):
        return fine_hist_torch(codes, leaf, stats, sel, W, nbins, scale)
    L, F, K = sel.shape
    dev = codes.device
    sel = sel.contiguous()
    out = torch.zeros((3, L, F, K, W), dtype=torch.int64, device=dev)
    n = codes.shape[1]
    tiles, n_tiles, smem = _fine_meta(L, F, K, W, str(dev))
    if n > 0:
        rpb = _rows_per_block(n, n_tiles, smem, str(dev))
        lib = FINE_HIST.lib()
        with torch.cuda.device(dev):
            rc = lib.fine_hist_launch(
                codes.data_ptr(), codes.element_size(), codes.stride(0),
                leaf.data_ptr(), stats.data_ptr(), stats.stride(0),
                scale.data_ptr(), sel.data_ptr(), L, F, K, W, nbins,
                tiles.data_ptr(), n_tiles, n, rpb, smem, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fine_hist kernel launch failed: CUDA "
                               f"error {rc}")
        FINE_HIST.count()
    return _dequantize(out, scale[1].view(3, 1, 1, 1, 1))


def make_fine_hist_fn(L: int, F: int, W: int, K: int, nbins: int):
    """The level-facing fine histogram (the JAX package's
    ``make_fine_hist_fn`` on one device, so no psum):
    ``fn(codes, leaf, stats, sel, scale=None) -> H [3, L, F, K, W]``."""
    def fn(codes, leaf, stats, sel, scale=None):
        if tuple(sel.shape) != (L, F, K) or codes.shape[0] != F:
            raise ValueError(f"fine histogram built for sel [{L}, {F}, "
                             f"{K}], got {tuple(sel.shape)}")
        return fine_hist(codes, leaf, stats, sel, W, nbins, scale)
    return fn


# ------------------------------------------------------------ split search

def _soft_threshold(G, alpha):
    return torch.sign(G) * torch.clamp_min(G.abs() - alpha, 0.0)


def _score(G, H, lam, alpha=0.0):
    Gt = _soft_threshold(G, alpha)
    return Gt * Gt / (H + lam)


def newton_value(g, h, reg_lambda: float, reg_alpha: float):
    """Soft-thresholded Newton node value, the one formula shared by
    split rejection and leaf fitting."""
    num = torch.sign(g) * torch.clamp_min(g.abs() - reg_alpha, 0.0)
    return -num / (h + reg_lambda + 1e-12)


def _cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis in sequential f32 order
    (bin 0, then + bin 1, ...): the order ``csrc/split_records.cu`` takes.
    ``torch.cumsum`` accumulates in f64 on the CPU and in a tree on the
    card, so it would give other last bits on each."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for b in range(1, x.shape[-1]):
        acc = acc + x[..., b]
        out[..., b] = acc
    return out


def _split_records_torch(Hist, reg_lambda, min_rows, reg_alpha, gamma,
                         min_child_weight) -> torch.Tensor:
    """Per-(leaf, feature) winner records [L, F, 12] — the plain version
    of ``csrc/split_records.cu`` and the port of the JAX package's
    ``_split_records_xla`` (same formula; prefix sums in sequential f32
    order).  Fields: gain, bin, na_left, GL, HL, CL at the bin (NA
    excluded), g_na, h_na, c_na, totG, totH, totC."""
    G, Hs, C = Hist[0], Hist[1], Hist[2]
    g_na, h_na, c_na = G[..., -1], Hs[..., -1], C[..., -1]
    cum = _cumsum_seq(Hist[..., :-1])
    cumG, cumH, cumC = cum[0], cum[1], cum[2]
    totG = cumG[..., -1] + g_na
    totH = cumH[..., -1] + h_na
    totC = cumC[..., -1] + c_na
    parent = _score(totG, totH, reg_lambda, reg_alpha)
    GL, HL, CL = cumG[..., :-1], cumH[..., :-1], cumC[..., :-1]
    GR = totG[..., None] - GL - g_na[..., None]
    HR = totH[..., None] - HL - h_na[..., None]
    CR = totC[..., None] - CL - c_na[..., None]

    def gain_with_na(gl, hl, cl, gr, hr, cr):
        g = 0.5 * (_score(gl, hl, reg_lambda, reg_alpha)
                   + _score(gr, hr, reg_lambda, reg_alpha)
                   - parent[..., None]) - gamma
        ok = (cl >= min_rows) & (cr >= min_rows) & \
            (hl >= min_child_weight) & (hr >= min_child_weight)
        return torch.where(ok, g, -torch.inf)

    gain_naL = gain_with_na(GL + g_na[..., None], HL + h_na[..., None],
                            CL + c_na[..., None], GR, HR, CR)
    gain_naR = gain_with_na(GL, HL, CL, GR + g_na[..., None],
                            HR + h_na[..., None], CR + c_na[..., None])
    na_left_better = gain_naL >= gain_naR
    gain = torch.maximum(gain_naL, gain_naR)
    bin_ = torch.argmax(gain, dim=-1)

    def pick(a):
        return a.gather(-1, bin_[..., None])[..., 0]

    return torch.stack(
        [pick(gain), bin_.to(torch.float32),
         pick(na_left_better).to(torch.float32),
         pick(GL), pick(HL), pick(CL), g_na, h_na, c_na,
         totG, totH, totC], dim=-1)


def split_records(Hist, nbins: int, reg_lambda, min_rows, reg_alpha=0.0,
                  gamma=0.0, min_child_weight=0.0) -> torch.Tensor:
    """Per-(leaf, feature) winner records [L, F, 12] from H[3, L, F, B].

    CUDA tensors launch ``csrc/split_records.cu`` (counted in
    ``SPLIT_RECORDS.launches``); CPU tensors take
    ``_split_records_torch``.  Scalar parameters only: the per-leaf form
    of the batched grid waits for that slice."""
    if Hist.dim() != 4 or Hist.shape[0] != 3 or Hist.shape[-1] != nbins + 1:
        raise ValueError(f"Hist must be [3, L, F, {nbins + 1}], got "
                         f"{tuple(Hist.shape)}")
    if Hist.dtype != torch.float32:
        raise ValueError("Hist must be f32")
    if not _on_cuda(Hist, "split records"):
        return _split_records_torch(Hist, reg_lambda, min_rows, reg_alpha,
                                    gamma, min_child_weight)
    _, L, F, B = Hist.shape
    H = Hist.contiguous()
    rec = torch.empty((L, F, _REC_PLANES), dtype=torch.float32,
                      device=H.device)
    lib = SPLIT_RECORDS.lib()
    with torch.cuda.device(H.device):
        rc = lib.split_records_launch(
            H.data_ptr(), L * F, B, float(reg_lambda), float(reg_alpha),
            float(gamma), float(min_rows), float(min_child_weight),
            rec.data_ptr(), torch.cuda.current_stream(H.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_records kernel launch failed: CUDA "
                           f"error {rc}")
    SPLIT_RECORDS.count()
    return rec


def finish_splits(rec, min_rows, min_split_improvement, feat_mask=None):
    """Reduce winner records over features into the per-leaf best split
    (feat, bin, na_left, gain, valid, children[L, 6]), in the JAX
    package's ``best_splits`` arithmetic order."""
    L, F, _ = rec.shape
    gain = rec[..., 0]
    if feat_mask is not None:
        m = feat_mask if feat_mask.dim() == 2 else feat_mask[None, :]
        gain = torch.where(m, gain, -torch.inf)
    feat = torch.argmax(gain, dim=1)
    fl = feat[:, None]

    def pick(i):
        return rec[..., i].gather(1, fl)[:, 0]

    best_gain = gain.gather(1, fl)[:, 0]
    bin_ = pick(1).to(torch.int32)
    na_left = pick(2) > 0.5
    glx, hlx, clx = pick(3), pick(4), pick(5)
    gna, hna, cna = pick(6), pick(7), pick(8)
    ftot, htot, ctot = pick(9), pick(10), pick(11)
    valid = torch.isfinite(best_gain) & \
        (best_gain > min_split_improvement) & \
        (rec[..., 11] >= 2 * min_rows).any(-1)
    gr0 = ftot - glx - gna
    hr0 = htot - hlx - hna
    cr0 = ctot - clx - cna
    gl = torch.where(na_left, glx + gna, glx)
    hl = torch.where(na_left, hlx + hna, hlx)
    cl = torch.where(na_left, clx + cna, clx)
    gr = torch.where(na_left, gr0, gr0 + gna)
    hr = torch.where(na_left, hr0, hr0 + hna)
    cr = torch.where(na_left, cr0, cr0 + cna)
    gl = torch.where(valid, gl, ftot)
    hl = torch.where(valid, hl, htot)
    cl = torch.where(valid, cl, ctot)
    zero = torch.zeros((), dtype=gr.dtype, device=gr.device)
    gr = torch.where(valid, gr, zero)
    hr = torch.where(valid, hr, zero)
    cr = torch.where(valid, cr, zero)
    children = torch.stack([gl, hl, cl, gr, hr, cr], dim=1)
    return feat.to(torch.int32), bin_, na_left, best_gain, valid, children


def fused_best_splits(Hist, nbins: int, reg_lambda, min_rows,
                      min_split_improvement, feat_mask=None,
                      reg_alpha=0.0, gamma=0.0, min_child_weight=0.0):
    """Best split per leaf through the records wrapper: one records
    launch, then the feature argmax (``split_mode="fused"``)."""
    rec = split_records(Hist, nbins, reg_lambda, min_rows, reg_alpha,
                        gamma, min_child_weight)
    return finish_splits(rec, min_rows, min_split_improvement, feat_mask)


def best_splits(Hist, nbins: int, reg_lambda, min_rows,
                min_split_improvement, feat_mask=None, reg_alpha=0.0,
                gamma=0.0, min_child_weight=0.0):
    """Best split per leaf through the plain records on any device — the
    oracle of ``split_mode="separate"`` (and of "check", which holds the
    records kernel against it on a card)."""
    rec = _split_records_torch(Hist, reg_lambda, min_rows, reg_alpha,
                               gamma, min_child_weight)
    return finish_splits(rec, min_rows, min_split_improvement, feat_mask)


# ----------------------------------------- hierarchical search: split choice

def coarse_totals(Hc, reg_lambda, reg_alpha):
    """Per-(leaf, feature) prefix sums over the S super-bins, the NA
    sums, the totals (NA included) and the parent score of a coarse
    histogram Hc [3, L, F, S+1]; prefix sums in sequential f32 order."""
    cum = _cumsum_seq(Hc[:3, ..., :-1])
    cums = (cum[0], cum[1], cum[2])
    nas = (Hc[0, ..., -1], Hc[1, ..., -1], Hc[2, ..., -1])
    tots = tuple(c[..., -1] + na for c, na in zip(cums, nas))
    parent = _score(tots[0], tots[1], reg_lambda, reg_alpha)
    return cums, nas, tots, parent


def _gain_with_na(glx, hlx, clx, nas, tots, parent, reg_lambda, reg_alpha,
                  gamma, min_rows, min_child_weight):
    """Split gain at candidate left sums (NA excluded), maxed over the
    two NA directions: the one formula of super-bin selection and the
    refined search.  Returns (gain, na_left, NA-resolved left g, h, c)."""
    totG, totH, totC = tots
    gna, hna, cna = (x[..., None] for x in nas)

    def gain_dir(gl, hl, cl):
        gr = totG[..., None] - gl
        hr = totH[..., None] - hl
        cr = totC[..., None] - cl
        gn = 0.5 * (_score(gl, hl, reg_lambda, reg_alpha)
                    + _score(gr, hr, reg_lambda, reg_alpha)
                    - parent[..., None]) - gamma
        ok = (cl >= min_rows) & (cr >= min_rows) & \
            (hl >= min_child_weight) & (hr >= min_child_weight)
        return torch.where(ok, gn, -torch.inf)

    gL = gain_dir(glx + gna, hlx + hna, clx + cna)
    gR = gain_dir(glx, hlx, clx)
    na_left = gL >= gR
    gain = torch.maximum(gL, gR)
    gl = torch.where(na_left, glx + gna, glx)
    hl = torch.where(na_left, hlx + hna, hlx)
    cl = torch.where(na_left, clx + cna, clx)
    return gain, na_left, gl, hl, cl


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest f32 values along the last axis, in
    ``jax.lax.top_k``'s order: IEEE total order (+0 above -0, a NaN by
    its sign) and ties to the lower index.  ``torch.topk`` promises no
    order for ties, so this is a stable descending sort of the values'
    total-order integer keys."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def select_superbins(Hc, nbins: int, W: int, K: int, reg_lambda, reg_alpha,
                     gamma, min_rows, min_child_weight, feat_mask=None,
                     coarse=None):
    """The K super-bins per (leaf, feature) to refine: the two touching
    each of the top ceil(K/2) coarse boundaries by exact gain (the JAX
    package's ``select_superbins``).  Hc [3, L, F, S+1] -> (sel [L, F, K]
    int32, the boundary gains [L, F, S-1]).  ``coarse`` is
    ``coarse_totals(Hc, reg_lambda, reg_alpha)`` when the caller has it."""
    cums, nas, tots, parent = coarse or coarse_totals(Hc, reg_lambda,
                                                      reg_alpha)
    S = cums[0].shape[-1]
    bgain = _gain_with_na(cums[0][..., :-1], cums[1][..., :-1],
                          cums[2][..., :-1], nas, tots, parent, reg_lambda,
                          reg_alpha, gamma, min_rows, min_child_weight)[0]
    if feat_mask is not None:
        m = feat_mask if feat_mask.dim() == 2 else feat_mask[None, :]
        bgain = torch.where(m[..., None], bgain, -torch.inf)
    nb = max(1, (K + 1) // 2)
    top_b = _top_k_indices(bgain, nb)                          # [L, F, nb]
    # boundary s touches super-bins s and s+1
    pairs = torch.stack([top_b, torch.clamp_max(top_b + 1, S - 1)], dim=-1)
    sel = pairs.reshape(*top_b.shape[:-1], 2 * nb)[..., :K]
    return sel.to(torch.int32), bgain


def hier_candidates(Hc, Hf, sel, nbins: int, W: int, reg_lambda,
                    min_rows, feat_mask=None, reg_alpha=0.0, gamma=0.0,
                    min_child_weight=0.0, coarse=None):
    """Every candidate split of the hierarchical search, per leaf: the
    coarse boundaries of all features, then the fine boundaries inside
    the K refined super-bins, flattened feature-major in that order.
    Returns ([L, n] columns gain, na_left, NA-resolved left g, h, c,
    feat, bin; and the per-(leaf, feature) totals g, h, c).  ``coarse``
    as in ``select_superbins``."""
    cums, nas, tots, parent = coarse or coarse_totals(Hc, reg_lambda,
                                                      reg_alpha)
    cumG, cumH, cumC = cums
    L, F, S = cumG.shape
    K = sel.shape[-1]
    dev = Hc.device
    if feat_mask is not None:
        fmask = feat_mask if feat_mask.dim() == 2 else feat_mask[None, :]
    else:
        fmask = torch.ones((L, F), dtype=torch.bool, device=dev)

    def eval_cands(glx, hlx, clx, allowed):
        gain, na_left, gl, hl, cl = _gain_with_na(
            glx, hlx, clx, nas, tots, parent, reg_lambda, reg_alpha,
            gamma, min_rows, min_child_weight)
        gain = torch.where(allowed & fmask[..., None], gain, -torch.inf)
        return [gain, na_left, gl, hl, cl]

    # (a) coarse boundaries: split after super-bin s, s in 0..S-2
    bins_a = (torch.arange(S - 1, dtype=torch.int32, device=dev) + 1) * W - 1
    res_a = eval_cands(cumG[..., :-1], cumH[..., :-1], cumC[..., :-1],
                       (bins_a <= nbins - 2)[None, None, :])
    feat_ix = torch.arange(F, dtype=torch.int32, device=dev)[None, :, None]
    res_a += [feat_ix.expand(L, F, S - 1), bins_a.expand(L, F, S - 1)]

    # (b) fine boundaries inside the refined super-bins.  A refined
    # super-bin's prefix is the coarse prefix before it (0 for the first):
    # the very value its left coarse boundary is scored with, so a fine
    # slot with no row before it in its super-bin ties that boundary
    # exactly and the first maximal gain, the boundary, wins as it does in
    # exact arithmetic.  The JAX package takes cum - x, one rounding more.
    pre = [torch.nn.functional.pad(cum[..., :-1], (1, 0)).gather(
        -1, sel.long()) for cum in (cumG, cumH, cumC)]         # [L, F, K]
    cumf = _cumsum_seq(Hf)                                  # [3, L, F, K, W]
    bins_f = (sel[..., None] * W + torch.arange(
        W, dtype=torch.int32, device=dev)).reshape(L, F, K * W)
    res_f = eval_cands(
        *[(p[..., None] + cf).reshape(L, F, K * W)
          for p, cf in zip(pre, cumf)], bins_f <= nbins - 2)
    res_f += [feat_ix.expand(L, F, K * W), bins_f]
    cols = [torch.cat([a.reshape(L, -1), f.reshape(L, -1)], dim=1)
            for a, f in zip(res_a, res_f)]
    return cols, tots


def best_splits_hier(Hc, Hf, sel, ub, nbins: int, W: int, reg_lambda,
                     min_rows, min_split_improvement, feat_mask=None,
                     reg_alpha=0.0, gamma=0.0, min_child_weight=0.0,
                     coarse=None):
    """Best split per leaf from the coarse Hc [3, L, F, S+1] and fine
    Hf [3, L, F, K, W] histograms (the JAX package's
    ``best_splits_hier``): the first maximal gain over
    ``hier_candidates`` (NaN counts as the maximum), so a coarse boundary
    that reappears as a fine slot wins a tie.  Returns ``best_splits``'
    tuple and a placeholder; ``ub`` is unused, as there.  ``coarse`` as
    in ``select_superbins``."""
    cols, (totG, totH, totC) = hier_candidates(
        Hc, Hf, sel, nbins, W, reg_lambda, min_rows, feat_mask, reg_alpha,
        gamma, min_child_weight, coarse)
    best = torch.argmax(cols[0], dim=1)[:, None]
    best_gain, na_left, gl, hl, cl, feat, bin_ = \
        (c.gather(1, best)[:, 0] for c in cols)
    fl = feat.long()[:, None]
    ftot, htot, ctot = (t.gather(1, fl)[:, 0] for t in (totG, totH, totC))
    valid = torch.isfinite(best_gain) & \
        (best_gain > min_split_improvement) & \
        (totC >= 2 * min_rows).any(-1)
    gr, hr, cr = ftot - gl, htot - hl, ctot - cl
    zero = torch.zeros((), dtype=gr.dtype, device=gr.device)
    children = torch.stack(
        [torch.where(valid, gl, ftot), torch.where(valid, hl, htot),
         torch.where(valid, cl, ctot), torch.where(valid, gr, zero),
         torch.where(valid, hr, zero), torch.where(valid, cr, zero)], dim=1)
    return (feat, bin_, na_left, best_gain, valid, children,
            torch.zeros((), dtype=torch.bool, device=gr.device))


# --------------------------------------------------------------- partition

def partition(codes, leaf, feat, bin_, na_left, valid, na_bin: int):
    """Send rows to child leaves: new_leaf = 2 * leaf + went_right.

    ``codes`` is feature-major [F, N].  Each row gathers its leaf's split
    (feature, bin, NA direction, valid) and its code of that feature; a
    terminal (invalid) leaf routes every row left."""
    li = leaf.long()
    f = feat.long()[li]
    b = bin_[li]
    nl = na_left[li]
    v = valid[li]
    c = codes.gather(0, f[None, :])[0]
    right = torch.where(c == na_bin, ~nl, c > b) & v
    return (2 * leaf + right.to(torch.int32)).to(torch.int32)
