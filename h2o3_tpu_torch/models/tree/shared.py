"""Shared tree infrastructure: the level-wise growth loop and ensemble
scoring — the level path of ``h2o3_tpu/models/tree/shared.py``
(hex/tree/SharedTree.java buildLayer, DTree, CompressedTree).

A tree grows level by level: histogram (``hist.make_subtract_level_fn``
or the full rebuild) -> split search (``hist.fused_best_splits`` or the
``best_splits`` oracle) -> threshold lookup -> ``hist.partition``; under
``split_search="hier"`` the histogram and split search are the
hierarchical pair instead (a coarse super-bin histogram, the fine
histogram of the chosen super-bins, ``hist.best_splits_hier``); the
last level's child sums give the Newton leaf values without another pass
over the rows.  A grown tree is per-level arrays (feature, threshold, NA
direction, valid) plus leaf values, all on the device; the ensemble
stacks them per level (``StackedTrees``) and ``traverse`` walks them with
gathers.

The port builds the dense layout, one tree at a time, as a Python loop of
levels (``tree_program="level"``): what the JAX package trains with
``H2O3_TPU_AUTOTUNE=off``.  Its other build programs (the batched K-tree
build, node-sparse deep levels, the whole-tree scan, EFB and monotone
constraints) wait for later slices and raise when asked for.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...frame.frame import Frame
from ...frame.vec import T_CAT
from ...runtime.config import config
from ...runtime.device import resolve_device
from ..base import Model, ModelBuilder, Parameters
from ..datainfo import DataInfo
from ..scorekeeper import stop_early
from . import hist


@dataclasses.dataclass
class SharedTreeParameters(Parameters):
    ntrees: int = 50
    max_depth: int = 5
    min_rows: float = 10.0
    nbins: int = 64
    histogram_type: str = "QuantilesGlobal"
    learn_rate: float = 0.1
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    min_split_improvement: float = 1e-5
    reg_lambda: float = 0.0
    reg_alpha: float = 0.0
    gamma: float = 0.0
    min_child_weight: float = 0.0
    distribution: str = "auto"
    score_tree_interval: int = 5
    standardize: bool = False
    # histogram build per level: "subtract" compacts each parent's
    # smaller child and subtracts; "full" histograms every child from all
    # rows (the oracle); "check" grows the first tree both ways, raises on
    # divergence, then trains with "subtract"; "auto" is "subtract"
    hist_mode: str = "auto"
    # split search per level: "fused" is the records kernel + feature
    # argmax; "separate" the multi-pass best_splits oracle; "check" grows
    # the first tree both ways, then trains "fused"; "auto" is "fused"
    split_mode: str = "auto"
    # "auto" and "dense" both build dense [2^d] levels on the port; they
    # differ only in the depth cap, as in the JAX package (the dense
    # layout stops where a level's histogram passes 64 MB, "auto" only
    # where rows run out).  The node-sparse deep levels are not ported.
    hist_layout: str = "auto"
    # "level" (and "auto"); the whole-tree scan program is not ported yet
    tree_program: str = "auto"
    # "hier" takes the hierarchical search (a coarse super-bin histogram,
    # then the fine bins of the FINE_K best super-bins per (leaf,
    # feature)); anything else, "auto" included, the exact full-bin search
    split_search: str = "auto"
    monotone_constraints: Optional[dict] = None


_LATER = "ROADMAP Queue 1, 'Rest of the tree family'"
# super-bins refined per (leaf, feature) by the hierarchical search: the
# JAX package's make_build_tree_fn default, which GBM.train never changes
FINE_K = 2


def check_tree_params(p) -> None:
    """Raise on the tree options the port has not ported yet."""
    if p.monotone_constraints:
        raise NotImplementedError(
            f"monotone_constraints are not ported yet ({_LATER})")


# ------------------------------------------------------------- trees

@dataclasses.dataclass
class Tree:
    """One grown tree, per level [2^d] arrays + [2^depth] leaf values."""
    feat: List[torch.Tensor]
    thr: List[torch.Tensor]
    na_left: List[torch.Tensor]
    valid: List[torch.Tensor]
    values: torch.Tensor
    cover: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StackedTrees:
    """The whole ensemble on the device: per level [T, 2^d] stacks."""

    levels: List[tuple]          # per depth: (feat, thr, na_left, valid)
    values: torch.Tensor         # [T, 2^depth]
    covers: Optional[torch.Tensor] = None

    @property
    def ntrees(self) -> int:
        return int(self.values.shape[0])

    @property
    def depth(self) -> int:
        return len(self.levels)

    @staticmethod
    def from_trees(trees: Sequence[Tree]) -> "StackedTrees":
        depth = len(trees[0].feat)
        levels = [tuple(torch.stack([getattr(t, a)[d] for t in trees])
                        for a in ("feat", "thr", "na_left", "valid"))
                  for d in range(depth)]
        covers = None
        if all(t.cover is not None for t in trees):
            covers = torch.stack([t.cover for t in trees])
        return StackedTrees(levels, torch.stack([t.values for t in trees]),
                            covers)

    @staticmethod
    def concat(chunks: Sequence["StackedTrees"]) -> "StackedTrees":
        if len(chunks) == 1:
            return chunks[0]
        if any(c.depth != chunks[0].depth for c in chunks):
            raise ValueError("StackedTrees.concat: chunks disagree on depth")
        levels = [tuple(torch.cat([c.levels[d][i] for c in chunks])
                        for i in range(4)) for d in range(chunks[0].depth)]
        covers = None
        if all(c.covers is not None for c in chunks):
            covers = torch.cat([c.covers for c in chunks])
        return StackedTrees(levels, torch.cat([c.values for c in chunks]),
                            covers)

    def to_tree_list(self) -> List[Tree]:
        out = []
        for t in range(self.ntrees):
            out.append(Tree(
                feat=[lv[0][t] for lv in self.levels],
                thr=[lv[1][t] for lv in self.levels],
                na_left=[lv[2][t] for lv in self.levels],
                valid=[lv[3][t] for lv in self.levels],
                values=self.values[t],
                cover=self.covers[t] if self.covers is not None else None))
        return out


class TreeList:
    """Lazy list-of-``Tree`` view over a ``StackedTrees``."""

    def __init__(self, stacked: StackedTrees):
        self._stacked = stacked
        self._cache: Optional[List[Tree]] = None

    def _mat(self) -> List[Tree]:
        if self._cache is None:
            self._cache = self._stacked.to_tree_list()
        return self._cache

    def __len__(self):
        return self._stacked.ntrees

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


def traverse(levels, values, X: torch.Tensor) -> torch.Tensor:
    """Sum of leaf values over stacked trees for a raw [N, F] matrix.

    Per level each (tree, row) gathers its node's split, the row's value
    of the split feature, and descends; NaN takes the NA direction and a
    terminal (invalid) node sends rows left.  Trees are walked in chunks
    so the [trees, N] index planes stay bounded; the leaf values are
    added tree by tree, as the JAX package's scan adds them."""
    N = X.shape[0]
    T = int(values.shape[0])
    Xt = X.t().contiguous()
    acc = torch.zeros(N, dtype=torch.float32, device=X.device)
    tc = max(1, min(T, (1 << 24) // max(N, 1)))
    for t0 in range(0, T, tc):
        t1 = min(T, t0 + tc)
        node = torch.zeros((t1 - t0, N), dtype=torch.int64, device=X.device)
        for feat, thr, na_left, valid in levels:
            f = feat[t0:t1].long().gather(1, node)
            x = Xt.gather(0, f)
            right = torch.where(torch.isnan(x),
                                ~na_left[t0:t1].gather(1, node),
                                x >= thr[t0:t1].gather(1, node))
            right = right & valid[t0:t1].gather(1, node)
            node = 2 * node + right.long()
        leafv = values[t0:t1].gather(1, node)
        for i in range(t1 - t0):
            acc = acc + leafv[i]
    return acc


# -------------------------------------------------------- depth and knobs

def dense_mem_cap(nbins: int, F: int) -> int:
    """Deepest level whose dense [2^d, F, B] histogram fits 64 MB — the
    JAX package's bound, kept so depth caps agree."""
    B = nbins + 1
    mem_cap = 1
    while (mem_cap < 24
           and F * B * 3 * 2 ** mem_cap * 4 <= 64 * 1024 * 1024):
        mem_cap += 1
    return mem_cap


def effective_max_depth(max_depth: int, nbins: int, F: int,
                        n_padded: int, hist_layout: str = "dense") -> int:
    """Depth cap shared by every consumer (same formula as the JAX
    package): a balanced tree runs out of rows past log2(n) + 1 levels,
    and hist_layout="dense" also stops where a level's histogram passes
    64 MB ("auto" does not: the JAX package grows node-sparse levels
    there, the port dense ones, which the card's memory holds)."""
    row_cap = max(1, int(np.ceil(np.log2(max(n_padded, 2)))) + 1)
    if hist_layout == "auto":
        return max(1, min(max_depth, row_cap))
    return max(1, min(max_depth, row_cap, dense_mem_cap(nbins, F)))


def record_effective_depth(model, params, F: int, n_padded: int,
                           hist_layout: str = "dense") -> int:
    eff = effective_max_depth(params.max_depth, params.nbins, F, n_padded,
                              hist_layout)
    model.output["requested_max_depth"] = params.max_depth
    model.output["effective_max_depth"] = eff
    model.output["hist_layout"] = hist_layout
    if eff < params.max_depth:
        warnings.warn(
            f"max_depth={params.max_depth} is capped to {eff} on this frame "
            f"({F} features x {params.nbins} bins x {n_padded} rows; "
            f"hist_layout={hist_layout!r}).", stacklevel=3)
    return eff


def resolve_hist_mode(params) -> str:
    mode = str(getattr(params, "hist_mode", "auto")).lower()
    if mode == "auto":
        return "subtract"
    if mode not in ("subtract", "full", "check"):
        raise ValueError(
            f"hist_mode={mode!r}: use auto | subtract | full | check")
    return mode


def use_hier_split_search(params) -> bool:
    """Whether the hierarchical split search runs: only on request
    (``split_search="hier"``); "auto" is the exact search, as in the JAX
    package."""
    return getattr(params, "split_search", "auto") == "hier"


def resolve_split_mode(params, hier: bool = False) -> str:
    """"auto" is "fused"; the hierarchical search has no fused path, so
    under it every mode but "separate" becomes "separate" (the JAX
    package's resolver: its split crosscheck does not run there)."""
    mode = str(getattr(params, "split_mode", "auto")).lower()
    if mode == "auto":
        mode = "fused"
    if mode not in ("fused", "separate", "check"):
        raise ValueError(
            f"split_mode={mode!r}: use auto | fused | separate | check")
    return "separate" if hier else mode


def resolve_hist_layout(params, hier: bool = False) -> str:
    """"auto" or "dense" (the hierarchical search takes "dense", as the
    JAX package's node-sparse levels do not compose with it)."""
    layout = str(getattr(params, "hist_layout", "auto")).lower()
    if layout in ("auto", "dense"):
        return "dense" if hier else layout
    if layout in ("sparse", "check"):
        raise NotImplementedError(
            f"hist_layout={layout!r}: node-sparse deep levels are not "
            f"ported yet ({_LATER}); use 'auto' or 'dense'")
    raise ValueError(
        f"hist_layout={layout!r}: use dense | sparse | auto | check")


def resolve_tree_program(params) -> str:
    prog = str(getattr(params, "tree_program", "auto")).lower()
    if prog in ("auto", "level"):
        return "level"
    if prog in ("scan", "check"):
        raise NotImplementedError(
            f"tree_program={prog!r}: the whole-tree scan program is not "
            f"ported yet ({_LATER}); use 'auto' or 'level'")
    raise ValueError(
        f"tree_program={prog!r}: use auto | level | scan | check")


def varbin_kernel_engages(bin_counts, nbins: int, F: int,
                          device) -> bool:
    """Whether the packed variable-bin histogram carries the levels: on a
    CUDA device (or anywhere with ``H2O3_TPU_HIST_IMPL=varbin``) when the
    packed axis is shorter than the uniform one, by the JAX package's
    measure sum(min(B_f, nbins) + 9) < F * (nbins + 1)."""
    if bin_counts is None:
        return False
    if not (torch.device(device).type == "cuda"
            or config().hist_impl == "varbin"):
        return False
    return sum(min(b, nbins) + 9 for b in bin_counts) < F * (nbins + 1)


# ------------------------------------------------------------ tree build

def make_build_tree_fn(max_depth: int, nbins: int, F: int, n_padded: int,
                       bin_counts=None, hist_mode: str = "subtract",
                       split_mode: str = "fused", hist_layout: str = "auto",
                       device=None, hier: bool = False):
    """A function that grows one tree on the device (the JAX package's
    ``make_build_tree_fn`` with nk=1, the dense layout and
    tree_program="level").

    ``build(codes, g, h, w, edges_mat, gen, reg_lambda, min_rows,
    min_split_improvement, learn_rate, col_sample_rate, tree_mask,
    reg_alpha, gamma, min_child_weight, hcodes=None)`` returns (per-level
    (feat, thr, na_left, valid), leaf values [2^depth], covers, the final
    leaf of every row).  ``gen`` draws the per-split column samples when
    col_sample_rate < 1; ``hcodes`` are the packed codes when the varbin
    layout engages, or the super-bin codes under ``hier`` (computed once
    per chunk by the caller, or here).

    ``hier=True`` takes the hierarchical split search (JAX
    ``shared.py:929-1055``): per level a coarse histogram over the S
    super-bins (``hist_uniform`` at B = S+1; below the root the left
    children from all rows, the right ones as the previous level's coarse
    histogram minus the left, h/w clamped at 0), ``select_superbins``,
    the fine histogram of the ``FINE_K`` chosen super-bins
    (``fine_hist``) and ``best_splits_hier``.  ``hist_mode`` does not
    apply to it, and it takes ``split_mode="separate"``.

    ``device`` (``cuda`` unless given, raising without CUDA) decides the
    histogram layout (``varbin_kernel_engages``).  Every histogram of a
    tree sums on one fixed-point scale, ``hist.stat_scale`` of its stats,
    computed once on the device."""
    if hist_mode not in ("subtract", "full"):
        raise ValueError(f"hist_mode={hist_mode!r}: use 'subtract' or "
                         "'full' here ('check' is resolved by GBM._fit)")
    if split_mode not in ("separate", "fused"):
        raise ValueError(f"split_mode={split_mode!r}: use 'separate' or "
                         "'fused' here ('check' is resolved by GBM._fit)")
    if hier and split_mode == "fused":
        raise ValueError("split_mode='fused' does not compose with the "
                         "hierarchical search; GBM.train downgrades it "
                         "to 'separate'")
    B = nbins + 1
    max_depth = effective_max_depth(max_depth, nbins, F, n_padded,
                                    hist_layout)
    device = resolve_device(device)
    use_varbin = not hier and varbin_kernel_engages(bin_counts, nbins, F,
                                                    device)
    bc = tuple(bin_counts) if use_varbin else None
    level_fns = [] if hier else [
        hist.make_subtract_level_fn(d, F, B, bin_counts=bc)
        for d in range(max_depth)]
    if hier:
        S, W = hist.superbin_geometry(nbins)
        fine_fns = [hist.make_fine_hist_fn(2 ** d, F, W, FINE_K, nbins)
                    for d in range(max_depth)]

    def hier_level(d, codes, ccodes, leaf, stats, scale, Hc_prev, mask,
                   scal):
        """One level's split by the hierarchical search; returns the
        split tuple and the level's coarse histogram (the next level's
        parent)."""
        reg_lambda, min_rows, msi, reg_alpha, gamma, mcw = scal
        L = 2 ** d
        if d == 0:
            Hc = hist.hist_uniform(ccodes, leaf, stats, 1, S + 1,
                                   scale=scale)
        else:
            # the left children over all rows: a right child's rows carry
            # leaf -1 and add nothing, the same sums as the JAX package's
            # stats masked to 0 on them
            pleaf = torch.where((leaf & 1) == 0, leaf >> 1, -1)
            Hcl = hist.hist_uniform(ccodes, pleaf, stats, L // 2, S + 1,
                                    scale=scale)
            Hcr = Hc_prev - Hcl
            Hcr[1:].clamp_min_(0.0)
            Hc = torch.stack([Hcl, Hcr], dim=2).reshape(3, L, F, S + 1)
        coarse = hist.coarse_totals(Hc, reg_lambda, reg_alpha)
        sel, ub = hist.select_superbins(Hc, nbins, W, FINE_K, reg_lambda,
                                        reg_alpha, gamma, min_rows, mcw,
                                        mask, coarse=coarse)
        Hf = fine_fns[d](codes, leaf, stats, sel, scale)
        split = hist.best_splits_hier(Hc, Hf, sel, ub, nbins, W, reg_lambda,
                                      min_rows, msi, mask, reg_alpha, gamma,
                                      mcw, coarse=coarse)[:6]
        return split, Hc

    def build(codes, g, h, w, edges_mat, gen, reg_lambda, min_rows,
              min_split_improvement, learn_rate, col_sample_rate,
              tree_mask, reg_alpha, gamma, min_child_weight, hcodes=None):
        dev = codes.device
        N = codes.shape[1]
        stats = torch.stack([g, h, w]).to(torch.float32)
        scale = hist.stat_scale(stats)
        if hier and hcodes is None:
            hcodes = hist.coarse_codes(codes, nbins)
        elif use_varbin and hcodes is None:
            hcodes = hist.offset_codes(codes, bc, nbins)
        lcodes = hcodes if use_varbin else codes
        scal = (reg_lambda, min_rows, min_split_improvement, reg_alpha,
                gamma, min_child_weight)
        leaf = torch.zeros(N, dtype=torch.int32, device=dev)
        levels = []
        alive = None
        carry = None
        for d in range(max_depth):
            L = 2 ** d
            mask = None
            if col_sample_rate < 1.0:
                ps = torch.rand((L, F), generator=gen, device=dev) \
                    < col_sample_rate
                anyf = ps.any(dim=1)
                ps[:, 0] = (anyf & ps[:, 0]) | ~anyf
                mask = ps
            if tree_mask is not None:
                mask = tree_mask[None, :].expand(L, F) if mask is None \
                    else mask & tree_mask[None, :]
            if hier:
                split, carry = hier_level(d, codes, hcodes, leaf, stats,
                                          scale, carry, mask, scal)
            else:
                if hist_mode == "subtract":
                    H, carry = level_fns[d].stacked(lcodes, leaf, stats,
                                                    carry, scale)
                else:
                    H = hist.local_hist(lcodes, leaf, stats, L, F, B, bc,
                                        scale)
                split_fn = hist.fused_best_splits if split_mode == "fused" \
                    else hist.best_splits
                split = split_fn(H, nbins, reg_lambda, min_rows,
                                 min_split_improvement, mask, reg_alpha,
                                 gamma, min_child_weight)
            feat, bin_, na_left, gain, valid, children = split
            if d > 0:
                # terminality: a dead node's descendants stay dead, and
                # their child stats collapse to "all rows left"
                valid = valid & alive
                gl, hl, cl2 = children[:, 0], children[:, 1], children[:, 2]
                gr, hr, cr2 = children[:, 3], children[:, 4], children[:, 5]
                zero = torch.zeros((), dtype=gr.dtype, device=dev)
                children = torch.stack(
                    [torch.where(valid, gl, gl + gr),
                     torch.where(valid, hl, hl + hr),
                     torch.where(valid, cl2, cl2 + cr2),
                     torch.where(valid, gr, zero),
                     torch.where(valid, hr, zero),
                     torch.where(valid, cr2, zero)], dim=1)
            alive = torch.stack([valid, valid], dim=1).reshape(-1)
            thr = edges_mat[feat.long(), bin_.clamp(0, nbins - 1).long()]
            leaf = hist.partition(codes, leaf, feat, bin_, na_left, valid,
                                  nbins)
            levels.append((feat, thr, na_left, valid))
        gl, hl, cl = children[:, 0], children[:, 1], children[:, 2]
        gr, hr, cr = children[:, 3], children[:, 4], children[:, 5]

        def newton(gc, hc, cc):
            return torch.where(cc > 0, hist.newton_value(gc, hc, reg_lambda,
                                                         reg_alpha), 0.0)
        vals = torch.stack([newton(gl, hl, cl), newton(gr, hr, cr)],
                           dim=1).reshape(-1)
        vals = (vals * learn_rate).to(torch.float32)
        cover = torch.stack([cl, cr], dim=1).reshape(-1).to(torch.float32)
        return levels, vals, cover, leaf

    build.max_depth = max_depth
    build.use_varbin = use_varbin
    build.bin_counts = bc
    return build


def make_tree_scan_fn(dist, max_depth: int, nbins: int, F: int,
                      n_padded: int, sample_rate: float,
                      col_sample_rate_per_tree: float, bin_counts=None,
                      hist_mode: str = "subtract", split_mode: str = "fused",
                      hist_layout: str = "auto", device=None,
                      hier: bool = False):
    """A chunk of boosting rounds (the JAX package's ``make_tree_scan_fn``
    as a plain loop over the chunk's trees): gradients -> row and column
    samples -> grow -> F update.  Returns ``scan_fn(codes, y, w, F0,
    edges_mat, gen, nchunk, reg_lambda, min_rows, min_split_improvement,
    learn_rate, col_sample_rate, reg_alpha, gamma, min_child_weight) ->
    (F, StackedTrees of the chunk)``.  The hierarchical search builds
    with split_mode="separate" and the dense layout, as there."""
    if hier:
        split_mode, hist_layout = "separate", "dense"
    bt_fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                               bin_counts=bin_counts, hist_mode=hist_mode,
                               split_mode=split_mode,
                               hist_layout=hist_layout, device=device,
                               hier=hier)

    def scan_fn(codes, y, w, F0, edges_mat, gen, nchunk, reg_lambda,
                min_rows, min_split_improvement, learn_rate,
                col_sample_rate, reg_alpha, gamma, min_child_weight):
        if hier:
            hcodes = hist.coarse_codes(codes, nbins)
        elif bt_fn.use_varbin:
            hcodes = hist.offset_codes(codes, bt_fn.bin_counts, nbins)
        else:
            hcodes = None
        Fc = F0
        trees = []
        for _ in range(nchunk):
            g0, h0 = dist.grad_hess(y, Fc)
            wv = w
            if sample_rate < 1.0:
                keep = torch.rand(w.shape, generator=gen,
                                  device=w.device) < sample_rate
                wv = w * keep
            tm = None
            if col_sample_rate_per_tree < 1.0:
                m = torch.rand((F,), generator=gen, device=w.device) \
                    < col_sample_rate_per_tree
                m[0] = m[0] | ~m.any()
                tm = m
            levels, vals, cover, leaf = bt_fn(
                codes, g0 * wv, h0 * wv, wv, edges_mat, gen, reg_lambda,
                min_rows, min_split_improvement, learn_rate,
                col_sample_rate, tm, reg_alpha, gamma, min_child_weight,
                hcodes=hcodes)
            Fc = Fc + vals[leaf.long()]
            trees.append(Tree([lv[0] for lv in levels],
                              [lv[1] for lv in levels],
                              [lv[2] for lv in levels],
                              [lv[3] for lv in levels], vals, cover))
        return Fc, StackedTrees.from_trees(trees)

    scan_fn.build = bt_fn
    return scan_fn


def chunk_schedule(ntrees: int, score_tree_interval: int,
                   chunk_cap: int = 10):
    """Yield (chunk_len, trees_done, score_now): chunks of at most
    ``chunk_cap`` trees whose boundaries land on the scoring intervals."""
    interval = max(1, min(score_tree_interval, ntrees))
    cap = min(chunk_cap, interval)
    t = 0
    while t < ntrees:
        c = min(cap, ntrees - t, interval - (t % interval))
        t += c
        yield c, t, (t % interval == 0 or t >= ntrees)


# --------------------------------------------------------------- oracles

def _grow_host(fn, codes, g, h, w, edges_mat, seed, scal, F):
    dev = codes.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    levels, vals, cover, leaf = fn(codes, g, h, w, edges_mat, gen, *scal)
    return ([[t.cpu().numpy() for t in lv] for lv in levels],
            vals.cpu().numpy(), leaf.cpu().numpy())


def run_hist_crosscheck(codes, g, h, w, edges_mat, seed: int, *, max_depth,
                        nbins, F, n_padded, bin_counts=None,
                        hist_layout="auto",
                        reg_lambda=0.0, min_rows=1.0,
                        min_split_improvement=1e-5, learn_rate=0.1,
                        reg_alpha=0.0, gamma=0.0, min_child_weight=0.0,
                        atol=1e-4):
    """The hist_mode="check" assert: grow one tree with the subtraction
    path and one with the full rebuild on the same inputs and raise
    AssertionError on any divergence of split structure, row routing or
    leaf values (exactly tied gains are the one legitimate cause)."""
    outs = {}
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate, 1.0,
            None, reg_alpha, gamma, min_child_weight)
    for mode in ("subtract", "full"):
        fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                                bin_counts=bin_counts, hist_mode=mode,
                                split_mode="separate",
                                hist_layout=hist_layout,
                                device=codes.device)
        outs[mode] = _grow_host(fn, codes, g, h, w, edges_mat, seed, scal, F)
    lv_s, v_s, leaf_s = outs["subtract"]
    lv_f, v_f, leaf_f = outs["full"]
    for d, (ls, lf) in enumerate(zip(lv_s, lv_f)):
        for name, i in (("feat", 0), ("na_left", 2), ("valid", 3)):
            if not np.array_equal(ls[i], lf[i]):
                raise AssertionError(
                    f"hist_mode='check': subtraction and full builds "
                    f"disagree on {name} at level {d}: {ls[i]} vs {lf[i]}")
        if not np.allclose(ls[1], lf[1], atol=atol, rtol=1e-5):
            raise AssertionError(
                f"hist_mode='check': split thresholds diverge at level {d}")
    if not np.array_equal(leaf_s, leaf_f):
        raise AssertionError(
            "hist_mode='check': final leaf routing differs between the "
            "subtraction and full histogram builds")
    if not np.allclose(v_s, v_f, atol=atol, rtol=1e-4):
        raise AssertionError(
            "hist_mode='check': leaf values diverge beyond tolerance "
            f"(max abs diff {np.max(np.abs(v_s - v_f))})")


def run_split_crosscheck(codes, g, h, w, edges_mat, seed: int, *,
                         max_depth, nbins, F, n_padded, bin_counts=None,
                         hist_mode="subtract", hist_layout="auto",
                         reg_lambda=0.0, min_rows=1.0,
                         min_split_improvement=1e-5, learn_rate=0.1,
                         col_sample_rate=1.0, reg_alpha=0.0, gamma=0.0,
                         min_child_weight=0.0, atol=1e-4):
    """The split_mode="check" assert: grow one tree with the fused
    records path and one with the separate best_splits oracle on the same
    inputs (same column draws) and raise on divergence.  A dead node's
    stored split is arbitrary, so feature/NA/threshold compare only where
    valid."""
    hm = hist_mode if hist_mode in ("subtract", "full") else "subtract"
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
            col_sample_rate, None, reg_alpha, gamma, min_child_weight)
    outs = {}
    for mode in ("separate", "fused"):
        fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                                bin_counts=bin_counts, hist_mode=hm,
                                split_mode=mode, hist_layout=hist_layout,
                                device=codes.device)
        outs[mode] = _grow_host(fn, codes, g, h, w, edges_mat, seed, scal, F)
    lv_s, v_s, leaf_s = outs["separate"]
    lv_f, v_f, leaf_f = outs["fused"]
    for d in range(len(lv_s)):
        valid_s = lv_s[d][3].astype(bool)
        if not np.array_equal(valid_s, lv_f[d][3].astype(bool)):
            raise AssertionError(f"split_mode='check': fused and separate "
                                 f"builds disagree on valid at level {d}")
        for name, i in (("feat", 0), ("na_left", 2)):
            if not np.array_equal(lv_s[d][i][valid_s], lv_f[d][i][valid_s]):
                raise AssertionError(
                    f"split_mode='check': {name} diverges at level {d}")
        if not np.allclose(lv_s[d][1][valid_s], lv_f[d][1][valid_s],
                           atol=atol, rtol=1e-5):
            raise AssertionError(
                f"split_mode='check': split thresholds diverge at level {d}")
    if not np.array_equal(leaf_s, leaf_f):
        raise AssertionError("split_mode='check': final leaf routing "
                             "differs between the fused and separate builds")
    if not np.allclose(v_s, v_f, atol=atol, rtol=1e-4):
        raise AssertionError(
            "split_mode='check': leaf values diverge (max abs diff "
            f"{np.max(np.abs(v_s - v_f))})")


# ------------------------------------------------------------ the model

def _datainfo_meta(di: DataInfo) -> dict:
    return {
        "specs": [{"name": s.name, "type": s.type, "domain": s.domain,
                   "mean": float(s.mean), "sigma": float(s.sigma),
                   "offset": s.offset, "width": s.width} for s in di.specs],
        "response_column": di.response_column,
        "response_domain": di.response_domain,
        "use_all_factor_levels": di.use_all_factor_levels,
        "standardize": di.standardize,
        "add_intercept": di.add_intercept,
        "nfeatures": di.nfeatures,
    }


class SharedTreeModel(Model):
    """Tree-ensemble model: scores through ``traverse`` on the device."""

    def _score_matrix(self, frame: Frame) -> torch.Tensor:
        return self._design(frame)

    def _design(self, frame: Frame) -> torch.Tensor:
        """Raw-value matrix [padded, F]: numerics as they are, cats as
        training codes with NaN for missing."""
        di = self.datainfo
        cols = []
        for s in di.specs:
            vec = frame.vec(s.name)
            if s.type == T_CAT:
                codes = di.aligned_codes(vec, s)
                cols.append(torch.where(codes < 0, float("nan"),
                                        codes.to(torch.float32)))
            else:
                cols.append(vec.data)
        return torch.stack(cols, dim=1)

    def _raw_scores(self, X: torch.Tensor) -> torch.Tensor:
        st = self.output["stacked"]
        return self.output["init_score"] + traverse(st.levels, st.values, X)

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout that
        ``export.mojo.from_reference`` reads (the JAX package's
        ``export/mojo.py::_extract`` for a single-class GBM/XGBoost):
        ``feat_d``, ``thr_d``, ``na_left_d``, ``valid_d`` per level,
        ``values``, ``covers``, and ``init_score`` in the metadata."""
        di = self.datainfo
        st = self.output["stacked"]
        dist = self.output.get("distribution", "gaussian")
        meta = {
            "algo": self.algo, "format_version": 1,
            "datainfo": _datainfo_meta(di),
            "default_threshold": float(self.default_threshold())
            if di.is_classifier else 0.5,
            "family": "tree", "tree_average": False, "nclass_trees": 1,
            "depth": st.depth, "ntrees": st.ntrees,
            "link": "log" if dist in ("poisson", "gamma", "tweedie")
            else "identity",
            "init_score": float(self.output["init_score"]),
        }
        arrays = {}
        for d, (feat, thr, na_left, valid) in enumerate(st.levels):
            arrays[f"feat_{d}"] = feat.cpu().numpy().astype(np.int32)
            arrays[f"thr_{d}"] = thr.cpu().numpy().astype(np.float32)
            arrays[f"na_left_{d}"] = na_left.cpu().numpy().astype(bool)
            arrays[f"valid_{d}"] = valid.cpu().numpy().astype(bool)
        arrays["values"] = st.values.cpu().numpy().astype(np.float32)
        if st.covers is not None:
            arrays["covers"] = st.covers.cpu().numpy().astype(np.float32)
        return meta, arrays


class SharedTree(ModelBuilder):
    """Common training pieces: datainfo, targets, interval scoring."""

    def _validate(self, frame) -> None:
        super()._validate(frame)
        check_tree_params(self.params)

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=p.response_column,
            ignored_columns=p.ignored_columns,
            weights_column=p.weights_column,
            offset_column=p.offset_column, standardize=False,
            missing_values_handling="mean_imputation")

    def _prep_targets(self, y, w, dist):
        """(y with NaN -> 0, the initial score)."""
        y0 = torch.where(torch.isnan(y), 0.0, y)
        return y0, dist.init_score(y0, w)

    def _scores_to_preds(self, F, dist, di):
        if di.is_classifier:
            p1 = dist.linkinv(F).clamp(0.0, 1.0)
            return torch.stack([1 - p1, p1], dim=1)
        return dist.linkinv(F)

    def _score_and_log(self, model, it, F_train, y, w, di, dist, history,
                       valid_state):
        from ...metrics.core import make_metrics
        m = make_metrics(di, self._scores_to_preds(F_train, dist, di), y, w)
        entry = {"iteration": it, **m.describe()}
        mv = None
        if valid_state is not None:
            F_v, y_v, w_v = valid_state
            mv = make_metrics(di, self._scores_to_preds(F_v, dist, di),
                              y_v, w_v)
            entry.update({f"valid_{k}": v for k, v in mv.describe().items()})
        history.append(entry)
        model._interval_metrics = (it, m, mv)
        return m

    def _interval_score(self, model, t_done, F, y, w, di, dist, history,
                        vstate, metric_name, maximize) -> bool:
        """Score at an interval boundary; True = stop early now."""
        p = self.params
        self._score_and_log(model, t_done, F, y, w, di, dist, history,
                            vstate)
        if not p.stopping_rounds:
            return False
        key = f"valid_{metric_name}" if vstate is not None else metric_name
        series = [hh.get(key) for hh in history if hh.get(key) is not None]
        return bool(series and stop_early(series, p.stopping_rounds,
                                          p.stopping_tolerance, maximize))
