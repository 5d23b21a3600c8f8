"""Histogram, split-search and partition steps of tree training — the
level path of ``h2o3_tpu/models/tree/hist.py``.

Reference hot loop: ``hex/tree/DHistogram.java`` (per-(leaf, column, bin)
sums of the gradient statistics) and XGBoost's ``gpu_hist``.  One tree
level is: the level histogram ``H[3, L, F, B]`` of (Σg, Σh, Σw) per
(leaf, feature, bin) -> the per-(leaf, feature) winner records -> the
per-leaf best split -> the row partition into child leaves.  ``B`` counts
``nbins`` regular bins and the NA bin last.  A node-sparse deep level
(``make_batched_sparse_level_fn``) runs the same steps over A slots of
alive nodes (``sparse_slot_maps``) instead of the 2^d dense nodes, through
the same kernels.

Kernels (``csrc/``, built by ``native.py``), each beside its plain torch
version:

* ``hist_uniform`` / ``hist_varbin`` -> ``csrc/hist.cu``: the histogram
  on the uniform bin axis (JAX ``_make_pallas_hist``) and on the packed
  per-feature axis (JAX ``_make_pallas_varbin_hist``); plain versions
  ``hist_uniform_torch`` / ``hist_varbin_torch``, one int64 ``index_add_``
  each;
* ``split_records`` -> ``csrc/split_records.cu`` (JAX
  ``_make_pallas_split_records``, both forms: scalar parameters, or one
  set per leaf for the batched grid; and a monotone form, which the JAX
  package computes in XLA as ``best_splits(mono=)``); plain version
  ``_split_records_torch`` (the JAX package's ``_split_records_xla`` with
  its prefix sums taken in sequential order);
* ``fine_hist`` -> ``csrc/fine_hist.cu`` (JAX ``_make_pallas_fine_hist``):
  the fine bins inside the K super-bins the hierarchical split search
  chose per (leaf, feature); plain version ``fine_hist_torch``, one
  int64 ``index_add_``;
* ``slot_compact`` -> ``csrc/slot_compact.cu`` (no Pallas kernel: XLA in
  the JAX package's ``_sparse_local_body``): a node-sparse level's chosen
  rows ordered by parent slot, so that ``hist_varbin`` / ``hist_uniform``
  with ``row_start`` let each tile read only its parent slots' rows;
  plain version ``slot_compact_torch``, a stable ``argsort`` per tree.

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
                     _I, _P, _L, _L, _L, _I, _L, _L, _L, _L, _L, _P, _I, _P,
                     _I, _I, _P), _I),
})
# the histogram over per-tile row windows (the node-sparse levels' slot
# geometry, ``row_start`` given), counted apart from the full-prefix
# launches in ``HIST.launches``
HIST_WINDOWS = native.KernelForm(HIST, "hist (slot windows)")
SLOT_COMPACT = native.Kernel("slot_compact", {
    "slot_count_launch": ((_P, _L, _I, _I, _I, _P, _P), _I),
    "slot_scatter_launch": ((_P, _I, _L, _I, _P, _L, _P, _L, _L, _P, _I, _P,
                             _I, _I, _I, _P, _P, _P, _I, _P), _I),
})
SPLIT_RECORDS = native.Kernel("split_records", {
    "split_records_launch": ((_P, _I, _I, _F, _F, _F, _F, _F, _P, _P), _I),
    "split_records_rows_launch": ((_P, _I, _I, _I, _P, _P, _P), _I),
    "split_records_mono_launch": ((_P, _I, _I, _F, _F, _F, _F, _F, _I, _P,
                                   _P, _P), _I),
})
# the per-row form of the records kernel (per-leaf parameters), counted
# apart from the scalar form's launches in ``SPLIT_RECORDS.launches``
SPLIT_RECORDS_ROWS = native.KernelForm(SPLIT_RECORDS,
                                       "split_records (per-row)")
# the monotone form (per-feature constraints: candidates whose child
# values break a feature's direction are rejected), counted apart too
SPLIT_RECORDS_MONO = native.KernelForm(SPLIT_RECORDS,
                                       "split_records (monotone)")
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
    (that plane's histograms are then NaN throughout).  K trees' stats
    [K, 3, n] give each tree its own scales, [K, 2, 3]: row by row what
    K calls on the trees' [3, n] give.

    s_p = 62 - e_p with sum_r |x_p,r| < 2^e_p (the plane's L1 norm, in
    f64), so that the quantised rows' |values| add up to under 2^62 plus
    n/2 of rounding: no slot, partial or total of a histogram over these
    rows can leave int64.  A slot of k rows is then within k * 2^-(s_p+1)
    <= k * sum|x_p| * 2^-62 of its exact sum before the one rounding to
    f32.  Computed on the device: the host reads nothing.  Both powers of
    two are built from their exponent bits, exactly."""
    m = torch.linalg.vector_norm(stats, 1, dim=-1, dtype=torch.float64)
    finite = torch.isfinite(m)
    _, e = torch.frexp(torch.where(finite, m, 0.0))
    s = _SUM_BITS - e.long()
    q = ((s + 1023) << 52).view(torch.float64)
    inv = ((1023 - s) << 52).view(torch.float64)
    return torch.stack([q, torch.where(finite, inv, torch.nan)], dim=-2)


def quantize(stats: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[3, n] stats -> their int64 fixed-point values round-half-even(x *
    2^s_p) (``torch.round``, as ``__double2ll_rn`` in the kernels); [K, 3,
    n] on K trees' [K, 2, 3] scales likewise.  A plane whose scale marks a
    non-finite stat quantises to 0: its histogram is NaN whatever it
    sums."""
    q = torch.round(stats.double() * scale[..., 0, :, None])
    return torch.where(torch.isfinite(scale[..., 1, :])[..., None], q,
                       0.0).long()


def _dequantize(sums: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """int64 sums x their planes' 2^-s_p (broadcast) -> f32."""
    return (sums.double() * inv).float()


def _check_scale(scale, stats) -> torch.Tensor:
    """The caller's scale (a ``stat_scale`` of the tree's stats, [2, 3],
    or of K trees', [K, 2, 3]), or this call's own."""
    if scale is None:
        return stat_scale(stats)
    want = (*stats.shape[:-2], 2, 3)
    if scale.shape != want or scale.dtype != torch.float64 \
            or scale.device != stats.device:
        raise ValueError(f"scale must be stat_scale's {list(want)} f64 "
                         f"tensor on {stats.device}")
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
            tiles.append((fa, fb, qa, qn, l0, ln, smem,
                          _copies(qn, ln, per_q, smem)))
        fa = fb
    return _tile_table(tiles, per_q)


def _copies(qn: int, ln: int, per_q: int, smem: int) -> int:
    """A tile's copies: the largest power of two up to ``MAX_COPIES`` whose
    copies, each one slot longer, stay within ``_COPIES_SMEM`` (1 for a
    tile in global memory)."""
    fit = _COPIES_SMEM // (qn * ln * per_q + _SLOT_BYTES)
    return 1 << (min(MAX_COPIES, fit).bit_length() - 1) \
        if smem and fit >= 2 else 1


def _tile_table(tiles, per_q: int) -> Tuple[np.ndarray, int]:
    """[T, 8] int32 tile rows and the shared-memory bytes of the largest
    block."""
    arr = np.asarray(tiles, np.int32)
    used = arr[:, 6] == 1
    cp = arr[used, 7]
    smem_bytes = int((cp * (arr[used, 3] * arr[used, 5] * per_q
                            + _SLOT_BYTES * (cp > 1))).max()) \
        if used.any() else 0
    return arr, smem_bytes


def slot_tiles(layout: HistLayout, L: int, budget: int = HIST_SMEM_BUDGET,
               planes: int = 3) -> Tuple[np.ndarray, int]:
    """``hist_tiles``'s table for a launch over per-tile row windows (the
    node-sparse levels, ``row_start`` given).

    There a tile reads only the rows of its own leaf range, so a narrower
    leaf range costs no extra reads, while each further feature range
    reads every row's leaf (4 B) and stats (12 B) again.  So features are
    packed greedily into the widest ranges that fit the budget at ONE
    leaf, and each range takes the widest leaf range that then fits (an
    even split of L): the bench frame's 8 features at nbins 64 are 368
    packed bins, 8.8 KB a slot, so 11 slots a 96 KB tile (373 tiles at
    4,096 parent slots), each row's leaf and stats read once for all its
    features.  A feature whose segment alone exceeds the
    budget gets one tile over all L leaves in global memory (use_smem 0).
    The copies rule is ``hist_tiles``'s."""
    per_q = planes * _SLOT_BYTES
    tiles = []
    fa = 0
    F = layout.F
    while fa < F:
        fb = fa + 1
        while fb < F and (layout.qstart[fb] + layout.qlen[fb]
                          - layout.qstart[fa]) * per_q <= budget:
            fb += 1
        qa = layout.qstart[fa]
        qn = layout.qstart[fb - 1] + layout.qlen[fb - 1] - qa
        smem = int(qn * per_q <= budget)
        lt = min(L, budget // (qn * per_q)) if smem else L
        groups = -(-L // lt)
        Lt = -(-L // groups)
        for l0 in range(0, L, Lt):
            ln = min(Lt, L - l0)
            tiles.append((fa, fb, qa, qn, l0, ln, smem,
                          _copies(qn, ln, per_q, smem)))
        fa = fb
    return _tile_table(tiles, per_q)


@functools.lru_cache(maxsize=None)
def _device_meta(layout: HistLayout, L: int, device: str, planes: int = 3,
                 windows: bool = False):
    """The layout's [3, F] feature table and its [T, 8] tiles on the
    device (``slot_tiles`` for a launch over row windows, else
    ``hist_tiles``), uploaded once per (layout, L, device, planes,
    windows); with the tile count, the shared memory and the number of
    feature ranges."""
    tiles, smem = (slot_tiles if windows else hist_tiles)(
        layout, L, planes=planes)
    meta = np.asarray([layout.code_off, layout.qstart, layout.qlen],
                      np.int32)
    dev = torch.device(device)
    return (torch.from_numpy(meta).to(dev), torch.from_numpy(tiles).to(dev),
            int(tiles.shape[0]), smem, len(set(tiles[:, 0].tolist())))


def prepare_uniform(F: int, B: int, widths, device) -> None:
    """Upload the device tables of the uniform-axis launches at each
    leaf count L in ``widths`` (``_device_meta``) and read the card's SM
    count, ahead of a CUDA graph capture, where a host-to-device copy
    would wait for the stream; nothing on another device."""
    if torch.device(device).type != "cuda":
        return
    for L in widths:
        _device_meta(uniform_layout(F, B), L, str(device), 3, False)
    _sm_count(str(device))


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def _rows_per_block(n: int, n_tiles: int, smem: int, device: str,
                    K: int = 1) -> int:
    """Rows per block: enough blocks for two waves of the card over the
    K trees of a launch, at least 2,048 rows a block, at most 65,535 row
    blocks (the grid's y limit)."""
    per_sm = max(1, min(2048 // _HIST_THREADS,
                        (227 * 1024) // max(smem, 1)))
    target = 2 * _sm_count(device) * per_sm
    chunks = max(1, min(-(-n // 2048), -(-target // (n_tiles * K))))
    rows = -(-n // chunks)
    return max(rows, -(-n // 65_535))


@functools.lru_cache(maxsize=None)
def window_grid(n: int, n_tiles: int, n_ranges: int, smem: int, sms: int,
                K: int = 1) -> Tuple[int, int]:
    """(rows a chunk, blocks) of a launch over row windows on a card of
    ``sms`` SMs: a prefix of n rows, T tiles over ``n_ranges`` feature
    ranges, K trees.  The rows a chunk aim at two waves of the card if
    every prefix row were in a window (at least 2,048); the blocks bound
    the chunks any windows can need without reading them: within one
    feature range the leaf ranges partition the leaves, so the windows of
    tree k's tiles there hold at most n rows between them, and sum_t
    ceil(rows_t / R) <= K * T + n_ranges * K * n / R."""
    per_sm = max(1, min(2048 // _HIST_THREADS,
                        (227 * 1024) // max(smem, 1)))
    target = 2 * sms * per_sm
    R = max(2048, -(-n_ranges * K * n // target))
    return R, K * n_tiles + -(-n_ranges * K * n // R)


# --------------------------------------------------- histogram: kernel path
#
# Every histogram wrapper takes one tree or K trees.  One tree: codes
# [F, n], leaf [n], stats [3, n], scale [2, 3].  K trees (a multinomial
# round's class trees, in one launch): leaf [K, n], stats [K, 3, n], scale
# [K, 2, 3], and codes either [F, n], which the K trees share (read with
# a stride of 0, never copied), or [K, F, n], each tree's own (a view may
# stride its trees and features as it likes; each row must be
# contiguous).  The output gains a leading K.

def _check_hist_operands(codes, leaf, stats) -> int:
    """Raise on operands the histograms do not take; returns K (0 for one
    tree)."""
    K = leaf.shape[0] if leaf.dim() == 2 else 0
    lead = (K,) if K else ()
    if codes.dim() not in (2, 3) or (codes.dim() == 3 and (
            not K or codes.shape[0] != K)) \
            or codes.dtype not in (torch.int16, torch.int32):
        raise ValueError("codes must be a [F, n] (or, for K trees, "
                         "[K, F, n]) int16/int32 tensor")
    n = codes.shape[-1]
    if leaf.shape != (*lead, n) or leaf.dtype != torch.int32:
        raise ValueError(f"leaf must be an {list(lead) + [n]} int32 tensor")
    if stats.shape != (*lead, 3, n) or stats.dtype != torch.float32:
        raise ValueError(f"stats must be a {list(lead) + [3, n]} f32 tensor")
    for name, t in (("codes", codes), ("leaf", leaf), ("stats", stats)):
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on "
                             f"{codes.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    return K


def _check_row_start(row_start, leaf, L: int):
    """Raise unless ``row_start`` is None or the [L + 1] (K trees: [K, L +
    1]) contiguous int32 tensor of the leaves' row windows on the leaf's
    device.  Its values are not checked (that would read them on the
    host): windows that are not monotone or miss rows of their leaves give
    undefined sums on the card."""
    if row_start is None:
        return
    want = (*leaf.shape[:-1], L + 1)
    if tuple(row_start.shape) != want or row_start.dtype != torch.int32 \
            or row_start.device != leaf.device \
            or not row_start.is_contiguous():
        raise ValueError(f"row_start must be a contiguous {list(want)} "
                         f"int32 tensor on {leaf.device}")


def _launch_hist(codes, leaf, stats, scale, L: int, layout: HistLayout,
                 out: torch.Tensor, strides, planes: int = 3,
                 row_start=None) -> None:
    """Launch ``csrc/hist.cu`` adding the level histogram of one tree, or
    of K trees (``leaf`` [K, n]), into ``out`` (int64 fixed point, zeroed
    by the caller; tree k's at ``out[k]``) through ``strides`` = (s, l,
    q).  With ``row_start`` each tile reads only its leaves' row windows
    (``slot_tiles``; counted in ``HIST_WINDOWS``), else every row
    (``hist_tiles``; counted in ``HIST``)."""
    dev = codes.device
    n = codes.shape[-1]
    windows = row_start is not None
    meta, tiles, n_tiles, smem, n_ranges = _device_meta(
        layout, L, str(dev), planes, windows)
    if n == 0:
        return
    batched = leaf.dim() == 2
    K = leaf.shape[0] if batched else 1

    def kstride(t, dims):        # tree k's offset in elements; 0 if shared
        return t.stride(0) if batched and t.dim() == dims else 0
    if windows:
        rpb = 0
        R, blocks = window_grid(n, n_tiles, n_ranges, smem,
                                _sm_count(str(dev)), K)
        plan = torch.empty(K * n_tiles + 1, dtype=torch.int32, device=dev)
        win = (row_start.data_ptr(), L, plan.data_ptr(), R, blocks)
    else:
        rpb = _rows_per_block(n, n_tiles, smem, str(dev), K)
        win = (None, 0, None, 0, 0)
    lib = HIST.lib()
    with torch.cuda.device(dev):
        rc = lib.hist_launch(
            codes.data_ptr(), codes.element_size(), codes.stride(-2),
            leaf.data_ptr(), stats.data_ptr(), stats.stride(-2),
            scale.data_ptr(), meta.data_ptr(), layout.F, tiles.data_ptr(),
            n_tiles, n, rpb, smem, planes, out.data_ptr(), strides[0],
            strides[1], strides[2], K, kstride(codes, 3), kstride(leaf, 2),
            kstride(stats, 3), kstride(scale, 3),
            kstride(out, out.dim()), *win,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    (HIST_WINDOWS if windows else HIST).count()


def _plane_inv(scale, planes: int) -> torch.Tensor:
    """[..., planes, 1, 1, 1] inverse scales of a dense histogram's planes
    (one tree's, or K trees' with a leading K): g, h, w, and g's again for
    |g| (built on the device: an index list would be a host-to-device
    copy, which waits for the stream)."""
    inv = scale[..., 1, :]
    if planes == 4:
        inv = torch.cat([inv, inv[..., :1]], dim=-1)
    return inv[..., None, None, None]


def _batch(leaf, stats, scale):
    """One tree's leaf, stats and scale with a K of 1."""
    if leaf.dim() == 2:
        return leaf, stats, scale
    return leaf[None], stats[None], scale[None]


def _tree_codes(codes) -> torch.Tensor:
    """[K, F, n] codes of the trees, or [1, F, n] for codes they share."""
    return codes if codes.dim() == 3 else codes[None]


def hist_uniform_torch(codes, leaf, stats, L: int, B: int, planes: int = 3,
                       scale=None) -> torch.Tensor:
    """Plain torch level histogram on the uniform axis: the stats
    quantised (``quantize``), one int64 ``index_add_`` over the flattened
    (tree, leaf, feature, bin) index, dequantised to f32.  codes [F, n],
    leaf [n], stats [3, n] -> H [planes, L, F, B] (K trees: H [K, planes,
    L, F, B]); planes = 4 adds Σ|g| as plane 3; ``scale`` is
    ``stat_scale(stats)`` unless given."""
    single = leaf.dim() == 1
    scale = stat_scale(stats) if scale is None else scale
    leaf, stats, scale = _batch(leaf, stats, scale)
    K, _, n = stats.shape
    F = codes.shape[-2]
    dev = codes.device
    qs = quantize(stats, scale)                                # [K, 3, n]
    if planes == 4:
        qs = torch.cat([qs, qs[:, :1].abs()], dim=1)
    c = _tree_codes(codes).long()                              # [K|1, F, n]
    lf = leaf.long()
    ok = ((lf >= 0) & (lf < L))[:, None, :] & (c >= 0) & (c < B)
    kl = torch.arange(K, device=dev)[:, None] * L + lf         # [K, n]
    idx = (kl[:, None, :] * F
           + torch.arange(F, device=dev)[None, :, None]) * B + c
    # rows outside the histogram add to one spare slot past its end (a
    # mask would pick them with a host synchronisation, which a CUDA
    # graph cannot capture)
    total = K * L * F * B
    idx = torch.where(ok, idx, total).expand(K, F, n)
    src = qs[:, :, None, :].expand(K, planes, F, n).transpose(0, 1)
    out = torch.zeros((planes, total + 1), dtype=torch.int64, device=dev)
    out.index_add_(1, idx.reshape(-1), src.reshape(planes, -1))
    H = _dequantize(out[:, :total].view(planes, K, L, F, B).transpose(0, 1),
                    _plane_inv(scale, planes)).contiguous()
    return H[0] if single else H


def hist_uniform(codes, leaf, stats, L: int, B: int, planes: int = 3,
                 scale=None, row_start=None) -> torch.Tensor:
    """Level histogram on the uniform bin axis -> H [planes, L, F, B] f32.

    codes [F, n] int16/int32 in [0, B), leaf [n] int32 (rows outside
    [0, L) add nothing), stats [3, n] f32 = (g, h, w); ``planes=4`` adds
    Σ|g| as plane 3, as the JAX ``make_hist_fn(..., planes=4)``.  Sums
    are int64 fixed point on ``scale`` (``stat_scale``; this call's own
    when None): exact, the same on every run.  K trees (leaf [K, n], see
    above) give H [K, planes, L, F, B] from one launch, bitwise K calls of
    one tree.  ``row_start`` (None, or each tree's [L + 1] int32 row
    windows: leaf l's rows at [row_start[l], row_start[l + 1]), every row
    outside them at a leaf outside [0, L)) lets each tile read only its
    leaves' rows; on the card a ``row_start`` that breaks this (not
    monotone, or missing rows of a leaf) gives undefined sums, as the
    windows are not checked against ``leaf``.  CUDA tensors launch ``csrc/hist.cu`` (counted in
    ``HIST.launches``, or ``HIST_WINDOWS.launches`` over row windows); CPU
    tensors take ``hist_uniform_torch``, which sums by leaf id and so
    needs no windows."""
    K = _check_hist_operands(codes, leaf, stats)
    if planes not in (3, 4):
        raise ValueError(f"planes={planes}: use 3 or 4")
    scale = _check_scale(scale, stats)
    _check_row_start(row_start, leaf, L)
    if not _on_cuda(codes, "histogram"):
        return hist_uniform_torch(codes, leaf, stats, L, B, planes, scale)
    F = codes.shape[-2]
    lead = (K,) if K else ()
    out = torch.zeros((*lead, planes, L, F * B), dtype=torch.int64,
                      device=codes.device)
    _launch_hist(codes, leaf, stats, scale, L, uniform_layout(F, B), out,
                 (L * F * B, F * B, 1), planes, row_start)
    return _dequantize(out.view(*lead, planes, L, F, B),
                       _plane_inv(scale, planes))


def hist_varbin_torch(gcodes, leaf, stats, L: int, layout: HistLayout,
                      scale=None) -> torch.Tensor:
    """Plain torch level histogram on the packed axis: the stats
    quantised, one int64 ``index_add_`` over the flattened (tree, packed
    bin, leaf) index, dequantised to f32.  gcodes [F, n] (pre-offset),
    leaf [n], stats [3, n] -> [Q8, 3L], column 3 l + s (K trees: [K, Q8,
    3L])."""
    single = leaf.dim() == 1
    scale = stat_scale(stats) if scale is None else scale
    leaf, stats, scale = _batch(leaf, stats, scale)
    K, _, n = stats.shape
    F = gcodes.shape[-2]
    dev = gcodes.device
    qs = quantize(stats, scale)                                # [K, 3, n]
    q = _tree_codes(gcodes).long()                             # [K|1, F, n]
    lf = leaf.long()
    lo = torch.as_tensor(layout.qstart, device=dev)[:, None]
    hi = lo + torch.as_tensor(layout.qlen, device=dev)[:, None]
    ok = (((lf >= 0) & (lf < L))[:, None, :] & (q >= lo) & (q < hi)) \
        .expand(K, F, n)
    kq = torch.arange(K, device=dev)[:, None, None] * layout.Q + q
    idx = (kq * L + lf[:, None, :]).expand(K, F, n)
    src = qs.transpose(1, 2)[:, None].expand(K, F, n, 3)
    out = torch.zeros((K * layout.Q * L, 3), dtype=torch.int64, device=dev)
    out.index_add_(0, idx[ok], src[ok])
    H = _dequantize(out.view(K, layout.Q * L, 3), scale[:, 1:2]) \
        .view(K, layout.Q, 3 * L)
    return H[0] if single else H


def hist_varbin(gcodes, leaf, stats, L: int, bin_counts: tuple, B: int,
                scale=None, row_start=None) -> torch.Tensor:
    """Level histogram on the packed per-feature axis -> [Q8, 3L] f32
    (row q, column 3 l + s; expand with ``expand_varbin``).

    gcodes [F, n] are pre-offset packed ids (``offset_codes``); sums as in
    ``hist_uniform``, and K trees likewise give [K, Q8, 3L] from one
    launch; ``row_start`` as there.  CUDA tensors launch ``csrc/hist.cu``
    (counted in ``HIST.launches``, or ``HIST_WINDOWS.launches``); CPU
    tensors take ``hist_varbin_torch``."""
    K = _check_hist_operands(gcodes, leaf, stats)
    layout = packed_layout(tuple(bin_counts), B)
    scale = _check_scale(scale, stats)
    _check_row_start(row_start, leaf, L)
    if not _on_cuda(gcodes, "histogram"):
        return hist_varbin_torch(gcodes, leaf, stats, L, layout, scale)
    lead = (K,) if K else ()
    out = torch.zeros((*lead, layout.Q * L, 3), dtype=torch.int64,
                      device=gcodes.device)
    _launch_hist(gcodes, leaf, stats, scale, L, layout, out, (1, 3, 3 * L),
                 row_start=row_start)
    return _dequantize(out, scale[..., 1:2, :]).view(*lead, layout.Q, 3 * L)


@functools.lru_cache(maxsize=None)
def _qmap_device(bin_counts: tuple, B: int, device: str) -> torch.Tensor:
    """``_qmap_dense`` on the device, uploaded once per (bin_counts, B,
    device): a copy from pageable host memory waits for the stream, so
    uploading it per call would hold the host once per level."""
    return torch.from_numpy(_qmap_dense(bin_counts, B)).to(
        torch.device(device))


def expand_varbin(packed: torch.Tensor, bin_counts: tuple, L: int,
                  B: int) -> torch.Tensor:
    """[Q8, 3L] packed histogram -> the dense [3, L, F, B] contract
    through the static qmap gather (hist.py:389-395 of the JAX package);
    K trees' [K, Q8, 3L] -> [K, 3, L, F, B] through the same one gather."""
    F = len(bin_counts)
    qd = _qmap_device(tuple(bin_counts), B, str(packed.device))
    H = packed.index_select(-2, qd)                   # [..., F*B, 3L]
    if packed.dim() == 2:
        return H.view(F, B, L, 3).permute(3, 2, 0, 1).contiguous()
    return H.view(-1, F, B, L, 3).permute(0, 4, 3, 1, 2).contiguous()


def local_hist(codes, leaf, stats, L: int, F: int, B: int,
               bin_counts=None, scale=None, row_start=None) -> torch.Tensor:
    """Level histogram in the dense [3, L, F, B] contract (K trees: [K, 3,
    L, F, B]): the varbin layout when ``bin_counts`` is given (codes
    pre-offset), else the uniform one (the JAX package's ``make_hist_fn``
    and ``make_varbin_hist_fn``; one device, so no psum); ``row_start``
    the leaves' row windows, if the rows are ordered by leaf."""
    if bin_counts is not None:
        packed = hist_varbin(codes, leaf, stats, L, tuple(bin_counts), B,
                             scale, row_start=row_start)
        return expand_varbin(packed, tuple(bin_counts), L, B)
    return hist_uniform(codes, leaf, stats, L, B, scale=scale,
                        row_start=row_start)


@functools.lru_cache(maxsize=None)
def _tree_offsets(K: int, step: int, device: str) -> torch.Tensor:
    """[K, 1] int32 k * step on the device, uploaded once."""
    return (torch.arange(K, dtype=torch.int32) * step)[:, None].to(
        torch.device(device))


def make_batched_level_fn(d: int, K: int, F: int, B: int, bin_counts=None):
    """Level-``d`` histograms of K trees in one histogram launch (the JAX
    package's ``make_batched_level_fn``, hist.py:637, which vmaps the level
    over K and lowers to one ``pallas_call``).

    ``fn(codes, leaf, stats, carry=None, scale=None) -> (H, carry)``:
    codes [F, n] shared by the trees (pre-offset under ``bin_counts``),
    leaf [K, n], stats [K, 3, n], ``scale`` the trees' [K, 2, 3]
    ``stat_scale`` (by default that of these stats), carry the previous
    level's [K, 3, 2^(d-1), F, B]; H [K, 3, 2^d, F, B] is also the next
    level's carry.  ``make_subtract_level_fn`` is its one-tree case.
    Every tree picks its own smaller siblings (one
    ``histc`` over k * 2^d + leaf counts all trees' children), and their
    rows are compacted into a prefix of n // 2 + 1 rows per tree by one
    scatter of row numbers and one gather of those rows' codes, leaves and
    stats (only the chosen prefix is written, not a permutation of all
    rows); one launch histograms the K prefixes and each larger sibling is
    its parent minus the smaller in f32, h/w clamped at 0.  Every op runs
    over [K, n] at once, so a level's op count does not grow with K.  The
    histograms are exact integer sums, independent of row order: tree k's
    H is bitwise ``make_subtract_level_fn`` on tree k alone.  The full
    rebuild (``hist_mode="full"``, the crosscheck oracle) is
    ``local_hist`` at 2^d leaves."""
    bc = tuple(bin_counts) if bin_counts is not None else None
    Lc = 2 ** d

    def level(codes, leaf, stats, carry=None, scale=None):
        scale = stat_scale(stats) if scale is None else scale
        if d == 0:
            H = local_hist(codes, leaf, stats, Lc, F, B, bc, scale)
            return H, H
        if carry is None:
            raise ValueError(f"level {d} needs the previous level's carry")
        # rows per child of every tree: one shared-memory histogram of
        # k * Lc + leaf (exact in f64)
        cnt = torch.histc(
            (leaf + _tree_offsets(K, Lc, str(codes.device))).double(),
            bins=K * Lc, min=0, max=K * Lc).view(K, Lc)
        H = _subtract_children(codes, leaf, stats, carry, scale, cnt, F, B,
                               bc)
        return H, H

    return level


def _subtract_children(codes, leaf, stats, carry, scale, cnt, F: int, B: int,
                       bc=None) -> torch.Tensor:
    """The children's histograms [K, 3, Lc, F, B] of one level by
    smaller-sibling compaction, given the rows per child ``cnt`` [K, Lc]
    and the parents' histograms ``carry`` [K, 3, Lc/2, F, B]: every tree
    picks its own smaller siblings, their rows are compacted into a prefix
    of n // 2 + 1 rows per tree, one launch histograms the K prefixes at
    the parent geometry, and each larger sibling is its parent minus the
    smaller in f32, h/w clamped at 0."""
    K, Lc = cnt.shape
    Lp = Lc // 2
    n = codes.shape[1]
    cap = n // 2
    dev = codes.device
    small_is_left = cnt[:, 0::2] <= cnt[:, 1::2]                    # [K, Lp]
    chosen_child = torch.stack([small_is_left, ~small_is_left],
                               dim=2).view(K, Lc)
    chosen = chosen_child.gather(1, leaf.long())                    # [K, n]
    # each tree's running count of its chosen rows: one scan over the K*n
    # flattened rows (a scan along a [K, n] row runs K blocks), less the
    # count of the trees before it
    c_flat = torch.cumsum(chosen.view(-1), dim=0).view(K, n)
    c_incl = c_flat - torch.nn.functional.pad(c_flat[:-1, -1:], (0, 0, 1, 0))
    # the chosen rows' numbers, in order, to each tree's prefix; every other
    # row to the spare slot ``cap``.  Slots from a tree's count on (the
    # spare one included) take leaf -1 and add nothing.
    target = torch.where(chosen, c_incl - 1, cap)
    rows = torch.zeros((K, cap + 1), dtype=torch.int64, device=dev) \
        .scatter_(1, target, torch.arange(n, device=dev).expand(K, n))
    kept = torch.arange(cap + 1, device=dev) < c_incl[:, -1:]
    ccodes = codes.index_select(1, rows.view(-1)).view(
        F, K, cap + 1).transpose(0, 1)                       # [K, F, cap+1]
    pleaf = torch.where(kept, leaf.gather(1, rows) >> 1, -1)
    st = stats.gather(2, rows[:, None, :].expand(K, 3, cap + 1))
    Hs = local_hist(ccodes, pleaf, st, Lp, F, B, bc, scale)
    Ho = carry - Hs
    Ho[:, 1:].clamp_min_(0.0)
    sl = small_is_left[:, None, :, None, None]
    Hl = torch.where(sl, Hs, Ho)
    Hr = torch.where(sl, Ho, Hs)
    return torch.stack([Hl, Hr], dim=3).view(K, 3, Lc, F, B)


def make_batched_scan_level_fn(W: int, K: int, F: int, B: int):
    """The subtraction level of the whole-tree scan program for K trees
    (the JAX package's ``make_batched_scan_level_fn``, hist.py:830): one
    program for every level below the root, at a fixed child width ``W``
    (the deepest level's 2^(D-1)) and parent width W/2, on the uniform
    bin axis (the scan forfeits the packed layout, as the reference does).

    ``fn(codes, leaf, stats, carry, scale, dead=None) -> (H, carry)``:
    codes [F, n] shared, leaf [K, n] with every row in [0, W), stats [K,
    3, n], ``scale`` the trees' [K, 2, 3] ``stat_scale``, carry the
    previous level's first W/2 child slots [K, 3, W/2, F, B]; H [K, 3, W,
    F, B] and the next carry, H's first W/2 slots (a view).  The
    compaction is ``make_batched_level_fn``'s at width W: a slot that no
    row reaches counts 0 rows on both sides, histograms exact zeros and
    subtracts to exact zeros, so the padded slots are inert and the live
    2^d slots are bitwise the level program's.  The rows per child come
    from ``_child_counts``: plain device work, which the graph of a tree
    captures (``torch.histc``, the level program's count, asks CUDA for
    the device's free memory on every call).

    ``dead`` (a 0-dim bool tensor: no node of any tree is alive) is the
    reference's early exit: every row then sits on an even child, and the
    level is the parent passthrough (clamped parent left, zeros right),
    which is what the compaction gives.  On the CPU the passthrough is
    taken without the compaction; inside a CUDA graph, which has no
    branch, the compaction runs and gives the same bits."""
    if W < 2 or W & (W - 1):
        raise ValueError(f"scan level width must be a power of two >= 2, "
                         f"got {W}")
    Wp = W // 2

    def level(codes, leaf, stats, carry, scale, dead=None):
        if dead is not None and not codes.is_cuda and bool(dead):
            Hoc = carry.clone()
            Hoc[:, 1:].clamp_min_(0.0)
            H = torch.stack([Hoc, torch.zeros_like(Hoc)],
                            dim=3).view(K, 3, W, F, B)
            return H, H[:, :, :Wp]
        H = _subtract_children(codes, leaf, stats, carry, scale,
                               _child_counts(leaf, W), F, B)
        return H, H[:, :, :Wp]

    return level


# rows a block of ``_child_counts``: no count then takes more integer adds
# than this, however the rows fall
_COUNT_BLOCK = 1 << 16


def _child_counts(leaf: torch.Tensor, W: int) -> torch.Tensor:
    """Rows per child [K, W] of leaf [K, n] (every row in [0, W)): int64
    adds into one count per (block of ``_COUNT_BLOCK`` rows, child), then
    a sum over the blocks.  Exact in any order of the adds."""
    K, n = leaf.shape
    nb = max(1, -(-n // _COUNT_BLOCK))
    blk = torch.arange(n, device=leaf.device) // _COUNT_BLOCK
    idx = blk * W + leaf
    one = torch.ones((), dtype=torch.int64, device=leaf.device)
    cnt = torch.zeros((K, nb * W), dtype=torch.int64, device=leaf.device)
    cnt.scatter_add_(1, idx, one.expand(K, n))
    return cnt.view(K, nb, W).sum(dim=1)


def make_scan_level_fn(W: int, F: int, B: int):
    """``make_batched_scan_level_fn`` for one tree (the JAX package's
    ``make_scan_level_fn``, hist.py:738): leaf [n], stats [3, n], scale
    [2, 3], carry [3, W/2, F, B] -> (H [3, W, F, B], carry)."""
    batched = make_batched_scan_level_fn(W, 1, F, B)

    def level(codes, leaf, stats, carry, scale, dead=None):
        H, nxt = batched(codes, leaf[None], stats[None], carry[None],
                         scale[None], dead)
        return H[0], nxt[0]

    return level


def make_subtract_level_fn(d: int, F: int, B: int, bin_counts=None):
    """Level-``d`` histogram by smaller-sibling compaction + parent
    subtraction (the JAX package's ``make_subtract_level_fn``;
    DHistogram / LightGBM / gpu_hist's halving): ``make_batched_level_fn``
    for one tree.

    Each parent's child with fewer rows is compacted into a dense prefix
    of ``n // 2 + 1`` rows, only that prefix is histogrammed at the
    parent-slot geometry, and the larger sibling is ``H_parent -
    H_small`` in f32 with its h/w planes clamped at 0.  Rows of the prefix
    past the compacted count carry leaf -1 and add nothing.  Returns
    ``fn(codes, leaf, g, h, w[, carry]) -> (H, carry)`` where ``carry`` is
    the level's own histogram, the next level's parent;
    ``fn.stacked(codes, leaf, stats, carry, scale)`` takes the stats
    already stacked as [3, n] and the tree's ``stat_scale`` (by default
    that of these stats, which the compacted prefix then shares).
    """
    batched = make_batched_level_fn(d, 1, F, B, bin_counts)

    def level(codes, leaf, stats, carry=None, scale=None):
        scale = stat_scale(stats) if scale is None else scale
        H, _ = batched(codes, leaf[None], stats[None],
                       None if carry is None else carry[None], scale[None])
        return H[0], H[0]

    def fn(codes, leaf, g, h, w, carry=None):
        return level(codes, leaf, torch.stack([g, h, w]).to(torch.float32),
                     carry)

    fn.stacked = level
    return fn


# ------------------------------------------------ node-sparse deep levels

def sparse_slot_budget(F: int, B: int,
                       cap_bytes: int = 64 * 1024 * 1024) -> int:
    """Slots of a node-sparse deep level (the JAX package's
    ``sparse_slot_budget``, hist.py:906): the largest multiple of 8 whose
    [A, F, B] three-plane f32 histogram fits ``cap_bytes``, clamped to
    [16, 4096].  A level narrower than this uses its 2^d nodes."""
    a = cap_bytes // (F * B * 3 * 4)
    return int(max(16, min(4096, (a // 8) * 8)))


def sparse_slot_maps(valid_prev: torch.Tensor, A_next: int):
    """Child slots of the next node-sparse level, per tree (the JAX
    package's ``sparse_slot_maps``, hist.py:955, with a leading K).

    ``valid_prev`` [K, Ap] holds the previous level's split decisions in
    its own space (dense nodes at the first sparse level, slots after it).
    Both children of every valid slot get a pair of slots (even = left),
    in slot order; where a level has more alive children than ``A_next``
    slots, the later pairs are dropped and those children are terminal.
    Returns int64 ``child_base`` [K, Ap+1] (each previous slot's first
    child slot, ``A_next`` for none; the last column is the sentinel's),
    ``ps_of_slot`` [K, A_next] (each slot's parent slot; slots past the
    live ones point at 0) and bool ``real`` [K, A_next] (the live slots)."""
    K, Ap = valid_prev.shape
    dev = valid_prev.device
    idx = torch.cumsum(valid_prev.long(), dim=1) - 1
    kept = valid_prev & (2 * idx + 1 < A_next)
    base = torch.where(kept, 2 * idx, A_next)
    child_base = torch.cat(
        [base, torch.full((K, 1), A_next, dtype=torch.int64, device=dev)], 1)
    # a pair's parent; a dropped pair writes the spare last column
    half = torch.zeros((K, A_next // 2 + 1), dtype=torch.int64, device=dev) \
        .scatter_(1, torch.where(kept, idx, A_next // 2),
                  torch.arange(Ap, device=dev).expand(K, Ap))
    ps_of_slot = half[:, :-1].repeat_interleave(2, dim=1)
    real = torch.arange(A_next, device=dev) < 2 * kept.sum(1, keepdim=True)
    return child_base, ps_of_slot, real


def _slot_choice(cnt: torch.Tensor, ps_of_slot: torch.Tensor, A_prev: int):
    """From the rows per slot ``cnt`` [K, A + 1] (the sentinel slot A
    last), each parent slot's smaller child: the left one where its count
    is at most the right one's (the JAX package's ``cl <= cr``).  Returns
    bool ``chosen_slot`` [K, A], int32 ``dest`` [K, A + 1] (a chosen
    slot's parent slot, -1 for the other child and for A) and int32
    ``row_start`` [K, A_prev + 1], the exclusive scan of the chosen rows
    per parent slot: parent slot p's rows lie at [row_start[k, p],
    row_start[k, p + 1]), and row_start[k, A_prev] is tree k's count.
    Slots past the live ones hold no rows, so pointing them at parent 0
    adds nothing.  [K, A]-sized torch ops; the host reads nothing."""
    K, A1 = cnt.shape
    A = A1 - 1
    dev = cnt.device
    c = cnt[:, :A].long()
    ps = ps_of_slot.long()
    zero = torch.zeros((K, A_prev), dtype=torch.int64, device=dev)
    cl = zero.scatter_add(1, ps[:, 0::2], c[:, 0::2])
    cr = zero.scatter_add(1, ps[:, 1::2], c[:, 1::2])
    sil = (cl <= cr).gather(1, ps)                                # [K, A]
    chosen_slot = torch.where((torch.arange(A, device=dev) & 1).bool(),
                              ~sil, sil)
    per_parent = zero.scatter_add(1, ps, torch.where(chosen_slot, c, 0))
    row_start = torch.nn.functional.pad(torch.cumsum(per_parent, 1),
                                        (1, 0)).to(torch.int32)
    dest = torch.nn.functional.pad(torch.where(chosen_slot, ps, -1),
                                   (0, 1), value=-1).to(torch.int32)
    return chosen_slot, dest, row_start


def _slots(sleaf: torch.Tensor, A: int) -> torch.Tensor:
    """Each row's slot, a value outside [0, A] counted as the sentinel
    A (int64)."""
    s = sleaf.long()
    return torch.where((s < 0) | (s > A), A, s)


def slot_counts_torch(sleaf: torch.Tensor, A: int) -> torch.Tensor:
    """Plain version of the count pass: [K, n] slots -> int32 rows per
    (tree, slot) [K, A + 1], the sentinel slot A included (one
    ``bincount`` over k * (A + 1) + slot)."""
    K = sleaf.shape[0]
    off = torch.arange(K, device=sleaf.device)[:, None] * (A + 1)
    return torch.bincount((_slots(sleaf, A) + off).view(-1),
                          minlength=K * (A + 1)).view(K, A + 1) \
        .to(torch.int32)


def slot_compact_torch(codes, sleaf, stats, ps_of_slot, A_prev: int):
    """Plain version of ``slot_compact`` (the CPU path and the oracle):
    the same windows, each in row order.  A stable ``argsort`` per tree of
    the key (the row's parent slot if its slot is chosen, else A_prev)
    puts the chosen rows first in (parent slot, row) order; the first
    n // 2 + 1 are gathered, and positions from the tree's count on take
    leaf -1 (their codes and stats, other rows', are never read)."""
    K, n = sleaf.shape
    A = ps_of_slot.shape[1]
    F = codes.shape[0]
    cap1 = n // 2 + 1
    dev = codes.device
    chosen_slot, dest, row_start = _slot_choice(
        slot_counts_torch(sleaf, A), ps_of_slot, A_prev)
    key = dest.long().gather(1, _slots(sleaf, A))
    key = torch.where(key < 0, A_prev, key)
    rows = torch.argsort(key, dim=1, stable=True)[:, :cap1]     # [K, cap1]
    kept = torch.arange(cap1, device=dev) < row_start[:, -1:]
    ccodes = codes.index_select(1, rows.reshape(-1)).view(
        F, K, cap1).transpose(0, 1).contiguous()
    pleaf = torch.where(kept, key.gather(1, rows), -1).to(torch.int32)
    st = stats.gather(2, rows[:, None, :].expand(K, 3, cap1))
    return ccodes, pleaf, st, row_start, chosen_slot


def slot_compact(codes, sleaf, stats, ps_of_slot, A_prev: int):
    """The slot-ordered compaction of a node-sparse level of K trees: each
    parent slot's smaller child's rows, side by side per parent slot, in
    a prefix of n // 2 + 1 rows per tree (the JAX package's
    ``_sparse_local_body`` compaction, hist.py:988-1035, there in row
    order).

    codes [F, n] int16/int32 shared by the trees, sleaf [K, n] each row's
    slot in [0, A] (A: none; a tree's row may be a view of one [n] row),
    stats [K, 3, n] f32, ps_of_slot [K, A] (``sparse_slot_maps``).
    Returns (ccodes [K, F, n // 2 + 1], pleaf [K, n // 2 + 1] int32: the
    row's parent slot, -1 past the tree's count, st [K, 3, n // 2 + 1],
    row_start [K, A_prev + 1] int32: parent slot p's rows at
    [row_start[k, p], row_start[k, p + 1]), chosen_slot [K, A] bool).
    Past a tree's count its codes and stats are undefined; no reader
    looks at a row of leaf -1.  The set of rows in each window is exact; in the kernel's output
    their order inside the window may differ between runs (the
    histograms of the prefix cannot: exact integer sums).  CUDA tensors
    launch ``csrc/slot_compact.cu`` (its count pass, the [K, A]-sized
    choice, its scatter pass; counted once in ``SLOT_COMPACT.launches``);
    CPU tensors take ``slot_compact_torch``."""
    K, n = sleaf.shape
    A = ps_of_slot.shape[1]
    if codes.dim() != 2 or codes.shape[1] != n \
            or codes.dtype not in (torch.int16, torch.int32) \
            or codes.stride(1) != 1:
        raise ValueError("codes must be a [F, n] int16/int32 tensor with "
                         "contiguous rows")
    if sleaf.dtype != torch.int64 or sleaf.stride(1) != 1:
        raise ValueError("sleaf must be a [K, n] int64 tensor with "
                         "contiguous rows")
    if stats.shape != (K, 3, n) or stats.dtype != torch.float32 \
            or stats.stride(2) != 1:
        raise ValueError(f"stats must be a [{K}, 3, {n}] f32 tensor with "
                         f"contiguous rows")
    if ps_of_slot.shape[0] != K:
        raise ValueError(f"ps_of_slot must be [{K}, A]")
    for name, t in (("sleaf", sleaf), ("stats", stats),
                    ("ps_of_slot", ps_of_slot)):
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on "
                             f"{codes.device}")
    if not _on_cuda(codes, "slot compaction"):
        return slot_compact_torch(codes, sleaf, stats, ps_of_slot, A_prev)
    chosen_slot, dest, row_start = _slot_choice(_slot_count(sleaf, A),
                                                ps_of_slot, A_prev)
    ccodes, pleaf, st = _slot_scatter(codes, sleaf, stats, dest, row_start)
    SLOT_COMPACT.count()
    return ccodes, pleaf, st, row_start, chosen_slot


def _slot_count(sleaf, A: int) -> torch.Tensor:
    """``slot_compact``'s count pass on the card: [K, A + 1] int32 rows
    per (tree, slot)."""
    K, n = sleaf.shape
    dev = sleaf.device
    cnt = torch.zeros((K, A + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = SLOT_COMPACT.lib().slot_count_launch(
            sleaf.data_ptr(), sleaf.stride(0), n, A, K, cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot_compact count pass failed: CUDA error "
                           f"{rc}")
    return cnt


def _slot_scatter(codes, sleaf, stats, dest, row_start):
    """``slot_compact``'s scatter pass on the card: (ccodes, pleaf, st)
    of the [K, *, n // 2 + 1] prefix, each parent slot's rows in its
    ``row_start`` window."""
    K, n = sleaf.shape
    F = codes.shape[0]
    A = dest.shape[1] - 1
    A_prev = row_start.shape[1] - 1
    cap1 = n // 2 + 1
    dev = codes.device
    cursor = row_start.clone()
    ccodes = torch.empty((K, F, cap1), dtype=codes.dtype, device=dev)
    pleaf = torch.empty((K, cap1), dtype=torch.int32, device=dev)
    st = torch.empty((K, 3, cap1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = SLOT_COMPACT.lib().slot_scatter_launch(
            codes.data_ptr(), codes.element_size(), codes.stride(0), F,
            sleaf.data_ptr(), sleaf.stride(0), stats.data_ptr(),
            stats.stride(1), stats.stride(0), dest.data_ptr(), A,
            cursor.data_ptr(), A_prev, n, cap1, ccodes.data_ptr(),
            pleaf.data_ptr(), st.data_ptr(), K,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slot_compact scatter pass failed: CUDA error "
                           f"{rc}")
    return ccodes, pleaf, st


def make_batched_sparse_level_fn(A_prev: int, A: int, K: int, F: int, B: int,
                                 bin_counts=None):
    """A node-sparse deep level of K trees in one histogram launch (the
    JAX package's ``_make_batched_sparse_level_fn`` and
    ``_sparse_local_body``, hist.py:988-1127): the ``make_batched_level_fn``
    contract on A slots of alive nodes instead of 2^d dense nodes.

    ``fn(codes, sleaf, stats, carry, ps_of_slot, scale=None) -> (H,
    carry)``: codes [F, n] shared (pre-offset under ``bin_counts``), sleaf
    [K, n] int64 each row's slot in [0, A] (A: no slot, a dead chain or a
    dropped pair), stats [K, 3, n], carry the previous level's [K, 3,
    A_prev, F, B] (at the first sparse level the dense level's, whose
    nodes are then the parent slots), ``ps_of_slot`` [K, A]
    (``sparse_slot_maps``).  ``slot_compact`` counts the rows per slot,
    folds the counts to each parent slot's left and right, picks its
    smaller child and writes the chosen rows (never a row of slot A) into
    a prefix of n // 2 + 1 rows ordered by parent slot, each parent
    slot's rows in its own window (``row_start``).  One launch
    histograms the K prefixes at L = A_prev, each tile reading only the
    windows of its parent slots (``slot_tiles``: all features a tile, a
    few parent slots); the larger child is the carry minus the smaller,
    h/w clamped at 0, and one gather along the slot axis gives H [K, 3,
    A, F, B], also the next level's carry.  The histograms are exact
    integer sums, so H does not depend on the order of rows within a
    window.  With every parent valid and A = 2^d the slot map is the
    identity and H is bitwise the dense level's."""
    bc = tuple(bin_counts) if bin_counts is not None else None

    def level(codes, sleaf, stats, carry, ps_of_slot, scale=None):
        scale = stat_scale(stats) if scale is None else scale
        ccodes, pleaf, st, row_start, chosen_slot = slot_compact(
            codes, sleaf, stats, ps_of_slot, A_prev)
        Hs = local_hist(ccodes, pleaf, st, A_prev, F, B, bc, scale,
                        row_start=row_start)
        Ho = carry - Hs
        Ho[:, 1:].clamp_min_(0.0)
        # each slot's histogram from its parent slot's row: the chosen
        # child reads Hs, the other Ho (one gather over both side by side)
        both = torch.stack([Hs, Ho], dim=3).view(K, 3, 2 * A_prev, F * B)
        src = 2 * ps_of_slot + (~chosen_slot).long()
        H = both.gather(2, src[:, None, :, None].expand(K, 3, A, F * B)) \
            .view(K, 3, A, F, B)
        return H, H

    return level


def make_sparse_level_fn(A_prev: int, A: int, F: int, B: int,
                         bin_counts=None):
    """One tree's node-sparse deep level (the JAX package's
    ``make_sparse_level_fn``): ``make_batched_sparse_level_fn`` at K = 1.
    ``fn(codes, sleaf, stats, carry, ps_of_slot, scale=None) -> (H,
    carry)`` with sleaf [n], stats [3, n], carry [3, A_prev, F, B],
    ps_of_slot [A], scale [2, 3]; H [3, A, F, B]."""
    batched = make_batched_sparse_level_fn(A_prev, A, 1, F, B, bin_counts)

    def level(codes, sleaf, stats, carry, ps_of_slot, scale=None):
        scale = stat_scale(stats) if scale is None else scale
        H, _ = batched(codes, sleaf[None], stats[None], carry[None],
                       ps_of_slot[None], scale[None])
        return H[0], H[0]

    return level


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


def newton_value(g, h, reg_lambda, reg_alpha):
    """Soft-thresholded Newton node value, the one formula shared by
    split rejection and leaf fitting; the parameters are scalars or
    tensors that broadcast against g (per tree [K, 1])."""
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


def _per_leaf(x, extra_dims: int):
    """A per-leaf [L] parameter broadcast against ``extra_dims`` trailing
    axes (the JAX package's ``_per_leaf``); scalars pass through."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.reshape(x.shape + (1,) * extra_dims)
    return x


def _split_records_torch(Hist, reg_lambda, min_rows, reg_alpha, gamma,
                         min_child_weight, mono=None) -> torch.Tensor:
    """Per-(leaf, feature) winner records [L, F, 12] — the plain version
    of ``csrc/split_records.cu`` and the port of the JAX package's
    ``_split_records_xla`` (same formula; prefix sums in sequential f32
    order).  Fields: gain, bin, na_left, GL, HL, CL at the bin (NA
    excluded), g_na, h_na, c_na, totG, totH, totC.  The five parameters
    are scalars, or f32 tensors of one value per leaf [L] (the per-row
    form), broadcast as [L, 1] against the totals and [L, 1, 1] against
    the bins.  ``mono`` [F] f32 (1 increasing, -1 decreasing, 0 free)
    rejects a candidate whose children's Newton values break its
    feature's direction (c > 0 and vl > vr, or c < 0 and vl < vr), on
    both NA ways: the JAX package's ``best_splits(mono=)``."""
    lam1, alpha1 = _per_leaf(reg_lambda, 1), _per_leaf(reg_alpha, 1)
    lam2, alpha2 = _per_leaf(reg_lambda, 2), _per_leaf(reg_alpha, 2)
    gamma2 = _per_leaf(gamma, 2)
    rows2, mcw2 = _per_leaf(min_rows, 2), _per_leaf(min_child_weight, 2)
    G, Hs, C = Hist[0], Hist[1], Hist[2]
    g_na, h_na, c_na = G[..., -1], Hs[..., -1], C[..., -1]
    cum = _cumsum_seq(Hist[..., :-1])
    cumG, cumH, cumC = cum[0], cum[1], cum[2]
    totG = cumG[..., -1] + g_na
    totH = cumH[..., -1] + h_na
    totC = cumC[..., -1] + c_na
    parent = _score(totG, totH, lam1, alpha1)
    GL, HL, CL = cumG[..., :-1], cumH[..., :-1], cumC[..., :-1]
    GR = totG[..., None] - GL - g_na[..., None]
    HR = totH[..., None] - HL - h_na[..., None]
    CR = totC[..., None] - CL - c_na[..., None]

    def gain_with_na(gl, hl, cl, gr, hr, cr):
        g = 0.5 * (_score(gl, hl, lam2, alpha2)
                   + _score(gr, hr, lam2, alpha2)
                   - parent[..., None]) - gamma2
        ok = (cl >= rows2) & (cr >= rows2) & (hl >= mcw2) & (hr >= mcw2)
        if mono is not None:
            vl = newton_value(gl, hl, lam2, alpha2)
            vr = newton_value(gr, hr, lam2, alpha2)
            c = mono[None, :, None]
            ok = ok & ~(((c > 0) & (vl > vr)) | ((c < 0) & (vl < vr)))
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


def _leaf_params(L: int, device, *params) -> torch.Tensor:
    """The per-row form's parameter block [L, 8] f32, lanes 0-4 lam,
    alpha, gamma, min_rows, min_child_weight of each leaf (a scalar is
    the same for every leaf); lanes 5-7 pad a leaf's record to 32 bytes
    and are never read (they repeat lanes 0-2, so that the block is one
    stack)."""
    cols = []
    for x in params:
        if isinstance(x, torch.Tensor):
            if x.device != torch.device(device):
                raise ValueError(f"a per-leaf parameter lies on {x.device}, "
                                 f"the histogram on {device}")
            cols.append(x.to(torch.float32).expand(L))
        else:
            cols.append(torch.full((L,), float(x), dtype=torch.float32,
                                   device=device))
    return torch.stack(cols + cols[:3], dim=1)


def split_records(Hist, nbins: int, reg_lambda, min_rows, reg_alpha=0.0,
                  gamma=0.0, min_child_weight=0.0, mono=None) -> torch.Tensor:
    """Per-(leaf, feature) winner records [L, F, 12] from H[3, L, F, B].

    The five parameters are scalars, or 1-D f32 tensors of one value per
    leaf [L] (the JAX package's per-leaf arrays: the batched grid's
    per-member parameters repeated over their leaves).  CUDA tensors
    launch ``csrc/split_records.cu``: its scalar form when every parameter
    is a scalar (counted in ``SPLIT_RECORDS.launches``), else its per-row
    form (``SPLIT_RECORDS_ROWS.launches``); with ``mono`` (the per-feature
    constraints [F] f32, scalar parameters only) its monotone form
    (``SPLIT_RECORDS_MONO.launches``).  CPU tensors take
    ``_split_records_torch``."""
    if Hist.dim() != 4 or Hist.shape[0] != 3 or Hist.shape[-1] != nbins + 1:
        raise ValueError(f"Hist must be [3, L, F, {nbins + 1}], got "
                         f"{tuple(Hist.shape)}")
    if Hist.dtype != torch.float32:
        raise ValueError("Hist must be f32")
    _, L, F, B = Hist.shape
    params = (reg_lambda, reg_alpha, gamma, min_rows, min_child_weight)
    per_leaf = False
    for x in params:
        if isinstance(x, torch.Tensor) and x.dim():
            if tuple(x.shape) != (L,):
                raise ValueError(f"a per-leaf parameter must be [{L}], got "
                                 f"{tuple(x.shape)}")
            per_leaf = True
    if mono is not None:
        if per_leaf:
            raise ValueError("the monotone records take scalar parameters")
        if tuple(mono.shape) != (F,) or mono.dtype != torch.float32 \
                or mono.device != Hist.device:
            raise ValueError(f"mono must be [{F}] f32 on {Hist.device}")
    if not _on_cuda(Hist, "split records"):
        return _split_records_torch(Hist, reg_lambda, min_rows, reg_alpha,
                                    gamma, min_child_weight, mono)
    H = Hist.contiguous()
    rec = torch.empty((L, F, _REC_PLANES), dtype=torch.float32,
                      device=H.device)
    lib = SPLIT_RECORDS.lib()
    stream = torch.cuda.current_stream(H.device).cuda_stream
    if per_leaf:
        block = _leaf_params(L, H.device, *params)
        with torch.cuda.device(H.device):
            rc = lib.split_records_rows_launch(
                H.data_ptr(), L * F, B, F, block.data_ptr(), rec.data_ptr(),
                stream)
    elif mono is not None:
        cons = mono.contiguous()
        with torch.cuda.device(H.device):
            rc = lib.split_records_mono_launch(
                H.data_ptr(), L * F, B, float(reg_lambda), float(reg_alpha),
                float(gamma), float(min_rows), float(min_child_weight), F,
                cons.data_ptr(), rec.data_ptr(), stream)
    else:
        with torch.cuda.device(H.device):
            rc = lib.split_records_launch(
                H.data_ptr(), L * F, B, float(reg_lambda), float(reg_alpha),
                float(gamma), float(min_rows), float(min_child_weight),
                rec.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"split_records kernel launch failed: CUDA "
                           f"error {rc}")
    (SPLIT_RECORDS_ROWS if per_leaf else SPLIT_RECORDS_MONO
     if mono is not None else SPLIT_RECORDS).count()
    return rec


def finish_splits(rec, min_rows, min_split_improvement, feat_mask=None):
    """Reduce winner records over features into the per-leaf best split
    (feat, bin, na_left, gain, valid, children[L, 6]), in the JAX
    package's ``best_splits`` arithmetic order.  ``min_rows`` and
    ``min_split_improvement`` are scalars or one value per leaf [L]."""
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
        (rec[..., 11] >= _per_leaf(2 * min_rows, 1)).any(-1)
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
                      reg_alpha=0.0, gamma=0.0, min_child_weight=0.0,
                      mono=None):
    """Best split per leaf through the records wrapper: one records
    launch, then the feature argmax (``split_mode="fused"``; under
    monotone constraints the records' monotone form, bitwise the JAX
    package's ``best_splits(mono=)`` on integer-valued histograms)."""
    rec = split_records(Hist, nbins, reg_lambda, min_rows, reg_alpha,
                        gamma, min_child_weight, mono=mono)
    return finish_splits(rec, min_rows, min_split_improvement, feat_mask)


def batched_splits(split_fn, HistK, nbins: int, reg_lambda, min_rows,
                   min_split_improvement, feat_mask=None, reg_alpha=0.0,
                   gamma=0.0, min_child_weight=0.0, **kw):
    """Best split per leaf of K trees: H [K, 3, L, F, B] -> ``split_fn``'s
    tuple (``fused_best_splits`` or ``best_splits``) with a leading K on
    every field.  The K*L leaves flatten into one call, tree-major (row
    k*L + l); the records and the feature argmax are row-local, so each
    tree's result is bitwise its own call.  ``feat_mask`` is [K, L, F] or
    [K, F].  The parameters are scalars or one value per tree [K] (a
    batched grid's members), repeated over each tree's L leaves in the
    flat order (the JAX package's ``perk``).  ``kw`` goes to ``split_fn``
    as it is (``mono``, or ``efb.best_splits_mixed``'s ``plan``)."""
    K, _, L, F, B = HistK.shape
    Hflat = HistK.transpose(0, 1).reshape(3, K * L, F, B)
    fm = None
    if feat_mask is not None:
        fm = feat_mask if feat_mask.dim() == 3 else \
            feat_mask[:, None, :].expand(K, L, F)
        fm = fm.reshape(K * L, F)

    def perk(x):                                  # [K] -> [K*L], K-major
        if isinstance(x, torch.Tensor) and x.dim():
            if tuple(x.shape) != (K,):
                raise ValueError(f"a per-tree parameter must be [{K}], got "
                                 f"{tuple(x.shape)}")
            return x[:, None].expand(K, L).reshape(-1)
        return x
    out = split_fn(Hflat, nbins, perk(reg_lambda), perk(min_rows),
                   perk(min_split_improvement), fm, perk(reg_alpha),
                   perk(gamma), perk(min_child_weight), **kw)
    return tuple(x.view(K, L, *x.shape[1:]) for x in out)


def fused_best_splits_batched(HistK, nbins: int, reg_lambda, min_rows,
                              min_split_improvement, feat_mask=None,
                              reg_alpha=0.0, gamma=0.0,
                              min_child_weight=0.0):
    """The JAX package's ``fused_best_splits_batched`` (hist.py:1778):
    ``batched_splits`` through one records launch over the K*L leaves
    (the per-row form where a parameter is per tree [K])."""
    return batched_splits(fused_best_splits, HistK, nbins, reg_lambda,
                          min_rows, min_split_improvement, feat_mask,
                          reg_alpha, gamma, min_child_weight)


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

def partition_right(codes, leaf, feat, bin_, na_left, valid,
                    na_bin: int) -> torch.Tensor:
    """Whether each row goes right (the JAX package's ``partition_right``,
    hist.py:2058): it gathers its node's split (feature, bin, NA
    direction, valid) and its code of that feature; a terminal (invalid)
    node sends every row left.  ``leaf`` indexes the split tables: dense
    node ids, or slot ids at a node-sparse level (whose tables carry the
    sentinel slot, never valid).  ``codes`` is feature-major [F, N]; K
    trees: leaf [K, N] and the tables [K, L], over the one shared code
    plane."""
    li = leaf.long()
    f = feat.long().gather(-1, li)
    b = bin_.gather(-1, li)
    nl = na_left.gather(-1, li)
    v = valid.gather(-1, li)
    c = codes.gather(0, f.view(-1, leaf.shape[-1])).view(f.shape)
    return torch.where(c == na_bin, ~nl, c > b) & v


def partition(codes, leaf, feat, bin_, na_left, valid, na_bin: int):
    """Send rows to child leaves: new_leaf = 2 * leaf + went_right
    (``partition_right``)."""
    right = partition_right(codes, leaf, feat, bin_, na_left, valid, na_bin)
    return (2 * leaf + right.to(torch.int32)).to(torch.int32)


def partition_ranged(codes, leaf, feat, lo, hi, inv, na_left, valid,
                     na_bin: int):
    """``partition`` with a bin RANGE as the right child's condition (the
    JAX package's ``partition_ranged``, hist.py:1998): right = inv XOR
    (lo < code <= hi), NA follows ``na_left``, a terminal node sends every
    row left.  EFB's bundle splits are member sub-ranges of a bundled bin
    axis (``efb.best_splits_mixed``); a plain prefix split is lo = bin,
    hi = nbins, inv = False.  ``codes`` [F, N] (the working codes), leaf
    [N] or [K, N] with the tables [L] or [K, L]."""
    li = leaf.long()
    f = feat.long().gather(-1, li)
    c = codes.gather(0, f.view(-1, leaf.shape[-1])).view(f.shape)
    in_range = (c > lo.gather(-1, li)) & (c <= hi.gather(-1, li))
    right = torch.where(c == na_bin, ~na_left.gather(-1, li),
                        inv.gather(-1, li) ^ in_range) & valid.gather(-1, li)
    return (2 * leaf + right.to(torch.int32)).to(torch.int32)
