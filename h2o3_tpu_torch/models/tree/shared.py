"""Shared tree infrastructure: the level-wise growth loop and ensemble
scoring — the level path of ``h2o3_tpu/models/tree/shared.py``
(hex/tree/SharedTree.java buildLayer, DTree, CompressedTree).

A tree grows level by level: histogram (``hist.make_batched_level_fn``
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

The port builds the level program (``tree_program="level"``), what the
JAX package trains with ``H2O3_TPU_AUTOTUNE=off``: full-width [2^d] dense
levels down to ``sparse_depth_threshold``, then, under
``hist_layout="sparse"`` (what "auto" resolves to), node-sparse levels
whose histograms, split records and routing run over A slots of alive
nodes (``hist.make_batched_sparse_level_fn``, ``hist.sparse_slot_maps``),
each level expanded back to the dense [2^d] contract.  A multinomial or
forest round grows its K class trees as one batched build
(``make_build_tree_fn(nk=K)``: one histogram launch and one records launch
per level for all K trees; one tree is the same level loop at K = 1), or
as a loop of K single-tree builds (``split_mode="separate"``, the oracle
it is bitwise).  A grid cohort's G members grow through the same batched
build, each with its own parameters (``make_grid_scan_fn``).  Every
tree's random draws come from generators keyed by (seed, chunk, tree,
class) (``draw_generator``), so both paths draw the same.

Monotone constraints (``resolve_mono``) and exclusive feature bundling
(``maybe_bundle``, ``efb``) grow dense levels: a monotone level searches
through the records kernel's monotone form and carries per-node value
bounds; a bundled level searches the working features with
``efb.best_splits_mixed`` and routes rows with ``hist.partition_ranged``.
A calibrated binomial model (``calibrate_model``) maps its class-1
probability through a Platt or isotonic curve (``SharedTree._post_fit``).

``tree_program="scan"`` grows the dense exact build as the whole-tree
program (``_make_scan_build``): the root level, then one fixed-width
level program at the deepest level's width for every level below it,
bitwise the level program; on a CUDA device a tree (a round, a cohort
round) is one captured ``torch.cuda.CUDAGraph`` replayed once a tree.
A tree model explains itself through TreeSHAP (``predict_contributions``,
``export/treeshap.py``) and ``varimp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...export.mojo import datainfo_meta
from ...frame.frame import Frame
from ...frame.vec import T_CAT, T_NUM, T_TIME, Vec
from ...runtime.config import config
from ...runtime.device import resolve_device
from ..base import Model, ModelBuilder, Parameters
from ..datainfo import DataInfo
from ..distributions import Multinomial
from ..scorekeeper import stop_early
from . import efb, hist


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
    # "dense" grows full-width [2^d] levels, capped where a level's
    # histogram passes 64 MB; "sparse" grows node-sparse levels from the
    # (clamped) sparse_depth_threshold on, their slot axis sized to the
    # same budget; "check" grows the first round both ways, raises on
    # divergence, then trains "sparse"; "auto" is "sparse", and "dense"
    # under hist_mode="full" and the hierarchical search
    hist_layout: str = "auto"
    # the first node-sparse level (clamped to the dense memory cap and to
    # >= 1: the root level is always dense)
    sparse_depth_threshold: int = 8
    # "level" grows a tree level by level; "scan" as one whole-tree
    # program (on a card one CUDA graph replay a tree); "check" grows the
    # first tree both ways, raises on divergence, then trains "scan";
    # "auto" is "level"
    tree_program: str = "auto"
    # "hier" takes the hierarchical search (a coarse super-bin histogram,
    # then the fine bins of the FINE_K best super-bins per (leaf,
    # feature)); anything else, "auto" included, the exact full-bin search
    split_search: str = "auto"
    # {column: 1 | -1 | 0}: numeric features, GBM/XGBoost binomial and
    # regression only (split rejection plus propagated value bounds, the
    # XGBoost mechanism)
    monotone_constraints: Optional[dict] = None
    tweedie_power: float = 1.5
    quantile_alpha: float = 0.5
    huber_alpha: float = 0.9
    # the JAX package's histogram accumulation type; the port's
    # histograms are exact int64 fixed-point sums at every setting, so
    # this and ``reproducible`` are accepted, kept in the parameters and
    # change no tree
    hist_precision: str = "bf16"
    # probability calibration on a held-out frame (hex/tree
    # CalibrationHelper): binomial models only
    calibrate_model: bool = False
    calibration_frame: Optional[object] = None
    calibration_method: str = "platt"    # platt | isotonic
    reproducible: bool = False
    # exclusive feature bundling of wide sparse frames (efb.py): "auto"
    # engages where the packed histogram cost drops enough; "off" never
    efb: str = "auto"


# super-bins refined per (leaf, feature) by the hierarchical search: the
# JAX package's make_build_tree_fn default, which GBM.train never changes
FINE_K = 2
# the builders that enforce monotone constraints
_MONO_ALGOS = ("gbm", "xgboost")


def check_tree_params(p, algo: str) -> None:
    """The tree options' checks before training (the JAX package's
    ``SharedTree._validate``, shared.py:2652): monotone constraints only
    for GBM/XGBoost; calibration needs a frame and platt or isotonic."""
    if getattr(p, "monotone_constraints", None) and algo not in _MONO_ALGOS:
        raise ValueError(
            "monotone_constraints is only enforced for GBM/XGBoost; "
            f"{algo} would silently ignore it")
    if getattr(p, "calibrate_model", False):
        if getattr(p, "calibration_frame", None) is None:
            raise ValueError("calibrate_model=True needs calibration_frame")
        if getattr(p, "calibration_method", "platt") not in ("platt",
                                                             "isotonic"):
            raise ValueError("calibration_method: platt | isotonic")


def resolve_mono(params, di) -> Optional[tuple]:
    """``monotone_constraints`` -> one float per feature in
    ``di.specs`` order (1, -1 or 0), or None when nothing is constrained
    (the JAX package's ``resolve_mono``)."""
    mc = getattr(params, "monotone_constraints", None)
    if not mc:
        return None
    names = [s.name for s in di.specs]
    vec = [0.0] * len(names)
    for col, direction in mc.items():
        if col not in names:
            raise ValueError(f"monotone_constraints: unknown column "
                             f"{col!r}")
        if di.specs[names.index(col)].type == T_CAT:
            raise ValueError(f"monotone_constraints: {col!r} is "
                             "categorical; numeric features only")
        if direction not in (1, -1, 0):
            raise ValueError(f"monotone_constraints[{col!r}] must be "
                             f"1, -1 or 0, got {direction!r}")
        vec[names.index(col)] = float(direction)
    if not any(vec):
        return None                      # all zeros: unconstrained
    return tuple(vec)


def plan_for(binned, params, mono, nrows: int):
    """EFB's gate (the JAX package's ``maybe_bundle`` before it maps the
    codes): the plan of ``efb.plan_bundles`` unless ``efb`` is off,
    monotone constraints are set or the hierarchical search runs; None
    where no plan wins."""
    mode = str(getattr(params, "efb", "auto")).lower()
    if mode in ("off", "false", "0") or mono is not None \
            or use_hier_split_search(params):
        return None
    return efb.plan_bundles(binned.codes, binned.bin_counts, binned.nbins,
                            nrows)


def maybe_bundle(binned, params, mono, nrows: int):
    """``plan_for``'s plan and what a train grows on: (plan or None, the
    working codes, their feature count, their bin counts)."""
    plan = plan_for(binned, params, mono, nrows)
    if plan is None:
        return None, binned.codes, binned.nfeatures, binned.bin_counts
    return (plan, efb.apply_bundles(binned.codes, plan, binned.nbins),
            plan.n_working, plan.bin_counts)


def efb_bundles(plan) -> int:
    """The number of bundles of a plan (``model.output["efb_bundles"]``)."""
    return sum(1 for w in plan.working if w[0] == "bundle")


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


def stack_trees(trees: Sequence[Tree]):
    """(per level (feat, thr, na_left, valid) [T, 2^d] stacks, leaf values
    [T, 2^depth]) of a list of trees, for ``traverse``."""
    levels = [tuple(torch.stack([getattr(t, a)[d] for t in trees])
                    for a in ("feat", "thr", "na_left", "valid"))
              for d in range(len(trees[0].feat))]
    return levels, torch.stack([t.values for t in trees])


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
        levels, values = stack_trees(trees)
        covers = None
        if all(t.cover is not None for t in trees):
            covers = torch.stack([t.cover for t in trees])
        return StackedTrees(levels, values, covers)

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
    """Lazy list-of-``Tree`` view over a ``StackedTrees``, or, given the K
    per-class stacks of a multinomial model, the per-round lists of its K
    class trees (``trees[t][k]``, the JAX package's ``TreeListMulti``)."""

    def __init__(self, stacked):
        self._stacked = stacked
        self._cache: Optional[list] = None

    def _mat(self) -> list:
        if self._cache is None:
            if isinstance(self._stacked, StackedTrees):
                self._cache = self._stacked.to_tree_list()
            else:
                per_class = [s.to_tree_list() for s in self._stacked]
                self._cache = [list(t) for t in zip(*per_class)]
        return self._cache

    def __len__(self):
        s = self._stacked
        return (s if isinstance(s, StackedTrees) else s[0]).ntrees

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


def row_depth_cap(n_padded: int) -> int:
    """A balanced tree runs out of rows past log2(n) + 1 levels."""
    return max(1, int(np.ceil(np.log2(max(n_padded, 2)))) + 1)


def effective_max_depth(max_depth: int, nbins: int, F: int,
                        n_padded: int, hist_layout: str = "dense") -> int:
    """Depth cap shared by every consumer (the JAX package's formula,
    shared.py:419-441): a balanced tree runs out of rows past log2(n) + 1
    levels; the dense layout also stops where a level's histogram passes
    64 MB (``dense_mem_cap``).  Under the node-sparse layout (``hist_layout``
    "sparse", "auto" or "check", already resolved) the dense levels stop
    at the threshold and the slot axis is sized to the same budget
    (``hist.sparse_slot_budget``), so only the rows cap the depth."""
    if hist_layout in ("sparse", "auto", "check"):
        return max(1, min(max_depth, row_depth_cap(n_padded)))
    return max(1, min(max_depth, row_depth_cap(n_padded),
                      dense_mem_cap(nbins, F)))


def record_effective_depth(model, params, F: int, n_padded: int,
                           hist_layout: str = "dense") -> int:
    """Record the requested and the effective depth, and what caps it, in
    ``model.output``; warn when a cap binds (the JAX package's
    ``record_effective_depth``)."""
    eff = effective_max_depth(params.max_depth, params.nbins, F, n_padded,
                              hist_layout)
    model.output["requested_max_depth"] = params.max_depth
    model.output["effective_max_depth"] = eff
    model.output["hist_layout"] = hist_layout
    cap = None
    if eff < params.max_depth:
        if hist_layout != "dense" or eff == row_depth_cap(n_padded):
            cap, hint = "rows", "rows bound the tree"
        else:
            cap = "dense level 64 MB"
            hint = ("full-width [2^d] levels double histogram memory per "
                    "level; hist_layout='auto' lifts the memory bound")
        warnings.warn(
            f"max_depth={params.max_depth} is capped to {eff} on this frame "
            f"({hint}; {F} features x {params.nbins} bins x {n_padded} "
            f"rows). Trees train at depth {eff}; lower max_depth to "
            f"silence this.", stacklevel=3)
    model.output["depth_cap"] = cap
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


def own_search(*, mono=None, plan=None, hier: bool = False) -> bool:
    """Whether the level searches with a function of its own: the
    hierarchical search (``best_splits_hier``), monotone constraints (the
    records' monotone form) and a bundle plan (``efb.best_splits_mixed``).
    These have neither the fused search nor the node-sparse layout in the
    JAX package (its resolvers, shared.py:1518-1650), so the knob
    resolvers below take "separate" and the dense layout under them, and
    the builders receive those resolved values.  The one place this rule
    is decided."""
    return hier or mono is not None or plan is not None


def resolve_split_mode(params, *, mono=None, plan=None,
                       hier: bool = False) -> str:
    """"auto" is "fused"; every mode becomes "separate" under
    ``own_search`` (the JAX package's resolver, shared.py:1518; its split
    crosscheck does not run there).  "separate" then records the JAX
    package's mode: the level's own search runs whatever it says (see
    ``make_build_tree_fn``)."""
    mode = str(getattr(params, "split_mode", "auto")).lower()
    if mode == "auto":
        mode = "fused"
    if mode not in ("fused", "separate", "check"):
        raise ValueError(
            f"split_mode={mode!r}: use auto | fused | separate | check")
    if own_search(mono=mono, plan=plan, hier=hier):
        return "separate"
    return mode


def resolve_hist_layout(params, *, hist_mode=None, mono=None, plan=None,
                        hier: bool = False) -> str:
    """The builder's layout, "dense" or "sparse", or "check" for the
    trainer to resolve with ``run_layout_crosscheck`` (the JAX package's
    ``resolve_hist_layout``, shared.py:1553-1589).  "auto" is "sparse",
    and "dense" (with the dense layout's depth cap) under monotone
    constraints, a bundle plan, the hierarchical search and
    hist_mode="full" (no carry to subtract from); an explicit "sparse"
    raises there.  "sparse" means node-sparse levels from the clamped
    ``sparse_depth_threshold`` on; the builder applies the threshold.
    ``hist_mode`` is the resolved mode, by default
    ``resolve_hist_mode(params)``."""
    layout = str(getattr(params, "hist_layout", "auto")).lower()
    if layout not in ("dense", "sparse", "auto", "check"):
        raise ValueError(
            f"hist_layout={layout!r}: use dense | sparse | auto | check")
    if int(getattr(params, "sparse_depth_threshold", 8)) < 1:
        raise ValueError("sparse_depth_threshold must be >= 1 (the root "
                         "level seeds the carry and is always dense)")
    if layout == "dense":
        return "dense"
    hm = hist_mode if hist_mode is not None else resolve_hist_mode(params)
    # the JAX package's sparse_layout_active (shared.py:1539):
    # hist_mode="check" trains subtract
    if own_search(mono=mono, plan=plan, hier=hier) \
            or hm not in ("subtract", "check"):
        if layout == "sparse":
            raise ValueError(
                "hist_layout='sparse' does not compose with "
                "hist_mode='full', monotone constraints, EFB bundling or "
                "the hierarchical split search; use hist_layout='auto' "
                "to downgrade automatically")
        return "dense"
    return "check" if layout == "check" else "sparse"


_SCAN_OWN_SEARCH = ("tree_program='scan' does not compose with monotone "
                    "constraints, EFB bundling or the hierarchical split "
                    "search; use tree_program='auto' to downgrade "
                    "automatically")
_SCAN_SPARSE = ("tree_program='scan' requires the dense layout at every "
                "level (the scan body is one fixed-width program; "
                "node-sparse slot maps reshape per level); use "
                "hist_layout='dense' or tree_program='auto'")
_SCAN_DEPTH = ("tree_program='scan' needs effective max_depth >= 2 (a "
               "depth-1 tree is the root level only: nothing to scan); use "
               "tree_program='auto' to downgrade automatically")


def resolve_tree_program(params, *, hist_layout: str = "dense", mono=None,
                         plan=None, hier: bool = False, bin_counts=None,
                         F: Optional[int] = None,
                         n_padded: Optional[int] = None,
                         device=None) -> str:
    """The build's tree program, "level" or "scan", or "check" for the
    trainer to resolve with ``run_program_crosscheck`` (the JAX package's
    ``resolve_tree_program``, shared.py:1603, and its envelope).  "auto"
    is "level", the program the JAX package trains with its autotuner
    off.  The scan grows the dense layout with the uniform histogram and
    the exact unconstrained search at effective depth >= 2: an explicit
    "scan" raises under monotone constraints, a bundle plan or the
    hierarchical search (``own_search``), where node-sparse levels
    engage (``hist_layout`` "sparse" or "check" deeper than the first
    sparse level) and at effective depth < 2, and forfeits the packed
    histogram where it would engage; "check" resolves to "level" in all
    of these cases and where the packed layout engages
    (``varbin_kernel_engages`` on ``device``: on a CUDA device whenever
    it saves work).  The effective depth is taken with ``F`` and
    ``n_padded`` when both are given."""
    prog = str(getattr(params, "tree_program", "auto")).lower()
    if prog not in ("level", "scan", "auto", "check"):
        raise ValueError(
            f"tree_program={prog!r}: use auto | level | scan | check")
    if prog in ("auto", "level"):
        return "level"
    blocked = own_search(mono=mono, plan=plan, hier=hier)
    md = int(getattr(params, "max_depth", 5))
    nb = int(getattr(params, "nbins", 64))
    thr = int(getattr(params, "sparse_depth_threshold", 8))
    if F is not None and n_padded is not None:
        md = effective_max_depth(md, nb, F, n_padded, hist_layout)
    t0 = max(1, min(thr, dense_mem_cap(nb, F)) if F is not None else thr)
    sparse = hist_layout in ("sparse", "check") and md > t0
    if prog == "scan":
        if blocked:
            raise ValueError(_SCAN_OWN_SEARCH)
        if sparse:
            raise ValueError(_SCAN_SPARSE)
        if md < 2:
            raise ValueError(_SCAN_DEPTH)
        return "scan"
    if blocked or sparse or md < 2 or varbin_kernel_engages(
            bin_counts, nb, F or 0, device or "cpu"):
        return "level"
    return "check"


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


# ------------------------------------------------------------ random draws

_M64 = (1 << 64) - 1
# the stream of a round's row sample, shared by its class trees
ROW_SAMPLE = -1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def draw_generator(seed: int, chunk: int, tree: int, stream: int,
                   device) -> torch.Generator:
    """The generator of one stream of a train's draws: class ``stream``'s
    column draws for tree ``tree`` of chunk ``chunk`` (its tree mask, then
    its per-split masks level by level; a single-class train is class 0),
    or that round's row sample (``stream=ROW_SAMPLE``), which its class
    trees share.  Seeded by a fixed integer mix (splitmix64) of (seed,
    chunk, tree, stream), the structure of the JAX package's fold_in keys
    (shared.py:2165-2191): every tree draws the same whichever path grows
    it and in whatever order, the batched build level by level across the
    K trees, the K loop tree by tree."""
    h = _splitmix64(int(seed) & _M64)
    for v in (chunk, tree, stream + 1):
        h = _splitmix64(h ^ (int(v) & _M64))
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(h >> 1)
    return gen


def tree_column_mask(F: int, rate: float, gen) -> torch.Tensor:
    """A tree's column sample: each feature kept with probability
    ``rate``, feature 0 when none is."""
    m = torch.rand((F,), generator=gen, device=gen.device) < rate
    m[0] = m[0] | ~m.any()
    return m


def split_column_mask(L: int, F: int, rate: float, gen) -> torch.Tensor:
    """A level's per-split column samples [L, F]: each kept with
    probability ``rate``, feature 0 of a leaf that keeps none."""
    ps = torch.rand((L, F), generator=gen, device=gen.device) < rate
    anyf = ps.any(dim=1)
    ps[:, 0] = (anyf & ps[:, 0]) | ~anyf
    return ps


# ------------------------------------------------------------ tree build

def _collapse_dead(valid, alive, children):
    """Terminality: a dead node's descendants stay dead, and their child
    stats collapse to "all rows left".  [..., L] and [..., L, 6]."""
    valid = valid & alive
    gl, hl, cl, gr, hr, cr = children.unbind(-1)
    zero = torch.zeros((), dtype=gr.dtype, device=gr.device)
    return valid, torch.stack(
        [torch.where(valid, gl, gl + gr), torch.where(valid, hl, hl + hr),
         torch.where(valid, cl, cl + cr), torch.where(valid, gr, zero),
         torch.where(valid, hr, zero), torch.where(valid, cr, zero)], dim=-1)


def _pairs(x):
    """[..., L, 2] -> [..., 2L]: each node's two children side by side."""
    return x.reshape(*x.shape[:-2], -1)


def _per_k(x, extra_dims: int):
    """A per-tree [K] parameter broadcast against ``extra_dims`` trailing
    axes (the JAX package's ``_per_k``); scalars pass through."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.reshape(x.shape + (1,) * extra_dims)
    return x


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: max with lo, then min with hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _leaf_values(children, reg_lambda, reg_alpha, learn_rate, bounds=None):
    """The Newton leaf values [..., 2^depth] (x learn_rate) and covers of
    the last level's child sums [..., 2^(depth-1), 6]; the parameters are
    scalars or one value per tree [K] of children [K, L, 6].  ``bounds``
    (lo, hi) [..., 2^depth]: a monotone build's value bounds, which clamp
    the values before the learning rate."""
    gl, hl, cl, gr, hr, cr = children.unbind(-1)
    lam, alpha = _per_k(reg_lambda, 1), _per_k(reg_alpha, 1)

    def newton(gc, hc, cc):
        return torch.where(cc > 0, hist.newton_value(gc, hc, lam, alpha),
                           0.0)
    vals = _pairs(torch.stack([newton(gl, hl, cl), newton(gr, hr, cr)],
                              dim=-1))
    if bounds is not None:
        vals = _clip(vals, *bounds)
    vals = (vals * _per_k(learn_rate, 1)).to(torch.float32)
    cover = _pairs(torch.stack([cl, cr], dim=-1)).to(torch.float32)
    return vals, cover


def sparse_geometry(max_depth: int, nbins: int, F: int,
                    sparse_depth_threshold: int, hist_layout: str):
    """Where a build's node-sparse levels start and their widths (the JAX
    package's ``make_build_tree_fn``, shared.py:631-660): the first
    sparse level t0 = max(1, min(threshold, ``dense_mem_cap``)) when the
    layout is "sparse" and the tree is deeper than t0 (else
    ``max_depth``: no sparse level), level d's slots A_d = min(2^d,
    ``hist.sparse_slot_budget``) and its parent slots (2^(d-1), the dense
    nodes, at the first sparse level; A_(d-1) after it).  Returns
    (sparse_from, {d: A_d}, {d: parent slots})."""
    t0 = max(1, min(sparse_depth_threshold, dense_mem_cap(nbins, F)))
    sparse_from = t0 if hist_layout == "sparse" and max_depth > t0 \
        else max_depth
    A_cap = hist.sparse_slot_budget(F, nbins + 1)
    A_lv = {d: min(2 ** d, A_cap) for d in range(sparse_from, max_depth)}
    Ap_lv = {d: 2 ** (d - 1) if d == sparse_from else A_lv[d - 1]
             for d in range(sparse_from, max_depth)}
    return sparse_from, A_lv, Ap_lv


def _slot_maps(d: int, A: int, prev_valid, slot_of_leaf, leaf_of_slot):
    """Slot assignment and the dense <-> slot maps of sparse level d, per
    tree [K, ...] (the JAX package's ``_slot_maps``).  ``prev_valid`` is
    the previous level's valid in its own space: the dense [K, 2^(d-1)]
    nodes at the first sparse level (then ``slot_of_leaf`` is None), its
    [K, Ap] slots after it.  Returns ``sparse_slot_maps``' child_base,
    ps_of_slot and real, ``slot_of_leaf`` [K, 2^d] (A for a node with no
    slot) and ``leaf_of_slot`` [K, A] (each slot's dense node)."""
    child_base, ps_of_slot, real = hist.sparse_slot_maps(prev_valid, A)
    dev = prev_valid.device
    side = torch.arange(2 ** d, device=dev) & 1
    sbit = torch.arange(A, device=dev) & 1
    if slot_of_leaf is None:
        parent_base = child_base[:, :-1]
        leaf_of_slot = 2 * ps_of_slot + sbit
    else:
        parent_base = child_base.gather(1, slot_of_leaf)
        leaf_of_slot = 2 * leaf_of_slot.gather(1, ps_of_slot) + sbit
    slot_of_leaf = torch.clamp_max(
        parent_base.repeat_interleave(2, dim=1) + side, A)
    return child_base, ps_of_slot, real, slot_of_leaf, leaf_of_slot


def _expand_sparse(A: int, split_s, slot_of_leaf, prev_children):
    """A sparse level's slot records [K, A] -> the dense [K, 2^d] level
    contract (the JAX package's ``_expand_sparse``).  A node with no slot
    (a dead chain or a dropped pair) is terminal: an invalid record whose
    child sums are its side of its parent's, all to the left, so the rows
    draining through it keep a leaf value."""
    feat_s, bin_s, na_s, valid_s, children_s = split_s
    K, L = slot_of_leaf.shape
    mapped = slot_of_leaf < A
    slc = torch.clamp_max(slot_of_leaf, A - 1)
    feat = torch.where(mapped, feat_s.gather(1, slc), 0)
    bin_ = torch.where(mapped, bin_s.gather(1, slc), 0)
    na_left = mapped & na_s.gather(1, slc)
    valid = mapped & valid_s.gather(1, slc)
    pc = prev_children.repeat_interleave(2, dim=1)            # [K, 2^d, 6]
    right = (torch.arange(L, device=slot_of_leaf.device) & 1).bool()
    tot = torch.where(right[:, None], pc[..., 3:6], pc[..., 0:3])
    inherit = torch.cat([tot, torch.zeros_like(tot)], dim=-1)
    children = torch.where(
        mapped[..., None],
        children_s.gather(1, slc[..., None].expand(K, L, 6)), inherit)
    return feat, bin_, na_left, valid, children


def _sentinel(x):
    """[K, A] slot table -> [K, A+1] with the sentinel slot A (zero:
    never valid, so a row without a slot keeps flowing left)."""
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)


def make_build_tree_fn(max_depth: int, nbins: int, F: int, n_padded: int,
                       bin_counts=None, hist_mode: str = "subtract",
                       split_mode: str = "fused", hist_layout: str = "dense",
                       device=None, hier: bool = False, nk: int = 1,
                       sparse_depth_threshold: int = 8, mono=None,
                       plan=None, tree_program: str = "level"):
    """A function that grows one tree on the device (the JAX package's
    ``make_build_tree_fn``), or, with ``nk`` > 1, the K trees of a
    multinomial or forest round or the G members of a grid cohort at
    once.  ``tree_program="scan"`` returns the whole-tree scan program
    instead (``_make_scan_build``: the same arguments and results, bitwise
    the level program's), with the JAX package's refusals: monotone
    constraints, a bundle plan, the hierarchical search, engaged
    node-sparse levels and an effective depth below 2 raise ValueError.

    ``build(codes, g, h, w, edges_mat, gen, reg_lambda, min_rows,
    min_split_improvement, learn_rate, col_sample_rate, tree_mask,
    reg_alpha, gamma, min_child_weight, hcodes=None)`` returns (per-level
    (feat, thr, na_left, valid), leaf values [2^depth], covers, the final
    leaf of every row).  ``gen`` draws the per-split column samples when
    col_sample_rate < 1; ``hcodes`` are the packed codes when the varbin
    layout engages, or the super-bin codes under ``hier`` (computed once
    per chunk by the caller, or here).

    ``nk`` > 1 (the JAX package's ``nk`` branch, shared.py:768-911): g
    and h are [K, N], w [N] (shared by the trees) or [K, N], ``gen`` a
    list of K generators and ``tree_mask`` [K, F]; every result gains a
    leading K.  One level loop grows all K trees, and one tree is its K =
    1 case: per level one batched histogram (``hist.make_batched_level_fn``
    or ``hist.local_hist``: one launch), one records launch over the K*L
    leaves (``hist.batched_splits``) and one partition.  It takes
    split_mode="fused"; tree k is bitwise a single build of tree k with
    the same generator.  Each parameter may also be one value per tree
    (the JAX package's ``[G]`` grid operands): ``reg_lambda``,
    ``min_rows``, ``min_split_improvement``, ``learn_rate``,
    ``reg_alpha``, ``gamma`` and ``min_child_weight`` as f32 tensors [K]
    on the device (the records then take their kernel's per-row form),
    ``col_sample_rate`` as a sequence of K floats: tree k draws its
    per-split masks only where its own rate is below 1, as its single
    build does.

    ``hier=True`` takes the hierarchical split search (JAX
    ``shared.py:929-1055``): per level a coarse histogram over the S
    super-bins (``hist_uniform`` at B = S+1; below the root the left
    children from all rows, the right ones as the previous level's coarse
    histogram minus the left, h/w clamped at 0), ``select_superbins``,
    the fine histogram of the ``FINE_K`` chosen super-bins
    (``fine_hist``) and ``best_splits_hier``.  ``hist_mode`` does not
    apply to it, and it takes ``split_mode="separate"`` and one tree.
    ``split_mode`` chooses between the fused records and the separate
    oracle for the exact unconstrained search alone: hier, ``mono`` and
    ``plan`` each search with their own function (``own_search``), and
    the resolvers hand them "separate".

    ``hist_layout="sparse"`` (JAX ``shared.py:631-766``, ``:812-857``)
    grows node-sparse levels from ``sparse_geometry``'s first sparse
    level on: each tree's alive nodes get slots (``_slot_maps``), every
    row carries its slot (``sleaf``, A for none) beside its dense node,
    and per level one batched histogram at the slot geometry
    (``hist.make_batched_sparse_level_fn``: one launch at L = the parent
    slots), one records launch over the K*A slots (its column mask drawn
    dense, as a dense level draws it, then gathered to the slots), the
    slot records expanded back to the dense [2^d] level
    (``_expand_sparse``), and one went-right bit through the slot tables
    (``hist.partition_right``) that updates both ids.  Where a level has
    more alive children than slots, the later pairs are dropped and those
    children stay leaves.  It takes hist_mode="subtract" and the exact
    search.

    ``mono`` (one float per feature, ``resolve_mono``; JAX
    ``shared.py:955-959``, ``:1117-1136``, ``:1153-1156``): every level
    searches through the records kernel's monotone form
    (``hist.fused_best_splits(mono=)``: the card never runs the plain
    search here), per-node value bounds lo/hi
    [K, L] start at -inf/inf, the children's clipped Newton values give
    their midpoint, the bounds tighten by the chosen feature's direction
    and interleave (left, right), and the leaf values are clamped to them
    before the learning rate.  ``plan`` (an ``efb.BundlePlan``; JAX
    ``:1073-1107``): ``codes`` are the plan's working codes and F, the
    bin counts its working ones; every level searches with
    ``efb.best_splits_mixed`` (the raw features through the records
    kernel) and routes rows with ``hist.partition_ranged``, and the
    recorded levels keep original (feature, threshold) pairs
    (``edges_mat`` is the original features').  Both take the dense
    layout and the exact search.

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
    if nk > 1 and (hier or split_mode != "fused"):
        raise ValueError("the batched K-tree build takes split_mode="
                         "'fused' and the exact search; the K loop of "
                         "single builds serves the others")
    if hist_layout not in ("dense", "sparse"):
        raise ValueError(f"hist_layout={hist_layout!r}: use 'dense' or "
                         "'sparse' here ('auto' and 'check' are resolved "
                         "by the trainer)")
    if hist_layout == "sparse" and (hist_mode != "subtract" or hier
                                    or mono is not None or plan is not None):
        raise ValueError("hist_layout='sparse' takes hist_mode='subtract' "
                         "(the slot carry is the subtraction carry), the "
                         "exact search and no monotone constraints or "
                         "bundle plan")
    if hier and (mono is not None or plan is not None):
        raise ValueError("monotone constraints and EFB bundling do not "
                         "compose with the hierarchical split search")
    if mono is not None and plan is not None:
        raise ValueError("feature bundling (EFB) does not compose with "
                         "monotone constraints")
    if tree_program not in ("level", "scan"):
        raise ValueError(f"tree_program={tree_program!r}: use 'level' or "
                         "'scan' here ('auto' and 'check' are resolved by "
                         "the trainer)")
    if tree_program == "scan" and own_search(mono=mono, plan=plan,
                                             hier=hier):
        raise ValueError(_SCAN_OWN_SEARCH)
    B = nbins + 1
    max_depth = effective_max_depth(max_depth, nbins, F, n_padded,
                                    hist_layout)
    sparse_from, A_lv, Ap_lv = sparse_geometry(
        max_depth, nbins, F, sparse_depth_threshold, hist_layout)
    device = resolve_device(device)
    if tree_program == "scan":
        if sparse_from < max_depth:
            raise ValueError(_SCAN_SPARSE)
        if max_depth < 2:
            raise ValueError(_SCAN_DEPTH)
        return _make_scan_build(max_depth, nbins, F, hist_mode, nk,
                                split_mode)
    use_varbin = not hier and varbin_kernel_engages(bin_counts, nbins, F,
                                                    device)
    bc = tuple(bin_counts) if use_varbin else None
    level_fns = [] if hier else [
        hist.make_batched_level_fn(d, nk, F, B, bin_counts=bc)
        for d in range(sparse_from)] + [
        hist.make_batched_sparse_level_fn(Ap_lv[d], A_lv[d], nk, F, B,
                                          bin_counts=bc)
        for d in range(sparse_from, max_depth)]
    split_fn = hist.fused_best_splits if split_mode == "fused" \
        else hist.best_splits
    split_kw = {}
    if mono is not None:
        if len(mono) != F:
            raise ValueError(f"mono has {len(mono)} entries for {F} "
                             "features")
        mono_t = torch.tensor(mono, dtype=torch.float32, device=device)
        split_fn, split_kw = hist.fused_best_splits, {"mono": mono_t}
    elif plan is not None:
        if plan.n_working != F:
            raise ValueError(f"the plan has {plan.n_working} working "
                             f"features, the build {F}")

        def split_fn(H, nbins, *args):
            return efb.best_splits_mixed(H, nbins, plan, *args)
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

    def grow(codes, stats, gens, tree_mask, edges_mat, reg_lambda, min_rows,
             min_split_improvement, learn_rate, col_sample_rate, reg_alpha,
             gamma, min_child_weight, hcodes):
        """The level loop over K = len(gens) trees: stats [K, 3, N],
        tree_mask [K, F]; every result has a leading K."""
        K = len(gens)
        N = codes.shape[1]
        scale = hist.stat_scale(stats)                       # [K, 2, 3]
        rates = member_rates(col_sample_rate, K)
        if hier and hcodes is None:
            hcodes = hist.coarse_codes(codes, nbins)
        elif use_varbin and hcodes is None:
            hcodes = hist.offset_codes(codes, bc, nbins)
        lcodes = hcodes if use_varbin else codes
        scal = (reg_lambda, min_rows, min_split_improvement, reg_alpha,
                gamma, min_child_weight)
        leaf = torch.zeros((K, N), dtype=torch.int32, device=codes.device)
        levels = []
        alive = None
        carry = None
        bounds = None
        if mono is not None:
            bounds = (torch.full((K, 1), -torch.inf, device=codes.device),
                      torch.full((K, 1), torch.inf, device=codes.device))
        for d in range(max_depth):
            L = 2 ** d
            mask = None
            if min(rates) < 1.0:
                # each tree's own draws, in the order a single build of
                # it draws them; a tree at rate 1 draws nothing
                mask = torch.stack([
                    split_column_mask(L, F, r, gk) if r < 1.0 else
                    torch.ones((L, F), dtype=torch.bool, device=codes.device)
                    for r, gk in zip(rates, gens)])
            if tree_mask is not None:
                mask = tree_mask[:, None, :].expand(K, L, F) \
                    if mask is None else mask & tree_mask[:, None, :]
            if d >= sparse_from:
                A = A_lv[d]
                if d == sparse_from:
                    # the first sparse level: slots from the last dense
                    # level's valid, whose carry is the parent slots'
                    (child_base, ps_of_slot, real, slot_of_leaf,
                     leaf_of_slot) = _slot_maps(d, A, valid, None, None)
                    sleaf = slot_of_leaf.gather(1, leaf.long())
                else:
                    (child_base, ps_of_slot, real, slot_of_leaf,
                     leaf_of_slot) = _slot_maps(d, A, valid_s, slot_of_leaf,
                                                leaf_of_slot)
                    sleaf = torch.clamp_max(
                        child_base.gather(1, sleaf) + right, A)
                H, carry = level_fns[d](lcodes, sleaf, stats, carry,
                                        ps_of_slot, scale)
                mask_s = None if mask is None else mask.gather(
                    1, leaf_of_slot[..., None].expand(K, A, F))
                feat_s, bin_s, na_s, _, valid_s, children_s = \
                    hist.batched_splits(split_fn, H, nbins, reg_lambda,
                                        min_rows, min_split_improvement,
                                        mask_s, reg_alpha, gamma,
                                        min_child_weight)
                # slots past the live ones gathered parent slot 0's
                # histogram: no rows, their records are dropped here
                valid_s, children_s = _collapse_dead(valid_s, real,
                                                     children_s)
                feat, bin_, na_left, valid, children = _expand_sparse(
                    A, (feat_s, bin_s, na_s, valid_s, children_s),
                    slot_of_leaf, children)
                # one went-right bit moves both ids: the dense node (leaf
                # values, traversal) and the slot (next level's routing)
                right = hist.partition_right(
                    codes, sleaf, *map(_sentinel, (feat_s, bin_s, na_s,
                                                   valid_s)), nbins)
                leaf = (2 * leaf + right.to(torch.int32)).to(torch.int32)
                thr = edges_mat[feat.long(), bin_.clamp(0, nbins - 1).long()]
                levels.append((feat, thr, na_left, valid))
                continue
            if hier:
                split, carry = hier_level(
                    d, codes, hcodes, leaf[0], stats[0], scale[0], carry,
                    None if mask is None else mask[0], scal)
                split = tuple(x[None] for x in split)
            else:
                if hist_mode == "subtract":
                    H, carry = level_fns[d](lcodes, leaf, stats, carry,
                                            scale)
                else:
                    H = hist.local_hist(lcodes, leaf, stats, L, F, B, bc,
                                        scale)
                split = hist.batched_splits(
                    split_fn, H, nbins, reg_lambda, min_rows,
                    min_split_improvement, mask, reg_alpha, gamma,
                    min_child_weight, **split_kw)
            feat, bin_, na_left, gain, valid, children = split[:6]
            if d > 0:
                valid, children = _collapse_dead(valid, alive, children)
            alive = _pairs(torch.stack([valid, valid], dim=-1))
            if bounds is not None:
                bounds = _mono_bounds(bounds, children, feat, valid,
                                      mono_t, reg_lambda, reg_alpha)
            thr = edges_mat[feat.long(), bin_.clamp(0, nbins - 1).long()]
            if plan is not None:
                wfeat, lo_w, hi_w, inv_w = split[6:]
                leaf = hist.partition_ranged(codes, leaf, wfeat, lo_w, hi_w,
                                             inv_w, na_left, valid, nbins)
            else:
                leaf = hist.partition(codes, leaf, feat, bin_, na_left,
                                      valid, nbins)
            levels.append((feat, thr, na_left, valid))
        vals, cover = _leaf_values(children, reg_lambda, reg_alpha,
                                   learn_rate, bounds)
        return levels, vals, cover, leaf

    def build(codes, g, h, w, edges_mat, gen, reg_lambda, min_rows,
              min_split_improvement, learn_rate, col_sample_rate,
              tree_mask, reg_alpha, gamma, min_child_weight, hcodes=None):
        scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
                col_sample_rate, reg_alpha, gamma, min_child_weight, hcodes)
        if nk > 1:
            stats = torch.stack([g, h, w.expand_as(g)], dim=1) \
                .to(torch.float32)
            return grow(codes, stats, gen, tree_mask, edges_mat, *scal)
        stats = torch.stack([g, h, w]).to(torch.float32)[None]
        levels, vals, cover, leaf = grow(
            codes, stats, [gen], None if tree_mask is None
            else tree_mask[None], edges_mat, *scal)
        return ([tuple(x[0] for x in lv) for lv in levels], vals[0],
                cover[0], leaf[0])

    build.max_depth = max_depth
    build.use_varbin = use_varbin
    build.bin_counts = bc
    build.nk = nk
    return build


def build_tree(codes, g, h, w, edges, nbins: int, max_depth: int,
               reg_lambda: float, min_rows: float,
               min_split_improvement: float, learn_rate: float, gen,
               col_sample_rate: float = 1.0, tree_col_mask=None,
               reg_alpha: float = 0.0, gamma: float = 0.0,
               min_child_weight: float = 0.0, hier: bool = False, mono=None,
               hist_mode: str = "subtract", split_mode: str = "fused",
               hist_layout: str = "dense", sparse_depth_threshold: int = 8,
               tree_program: str = "level", bin_counts=None):
    """Grow one tree: the JAX package's convenience wrapper around
    ``make_build_tree_fn`` (shared.py:2401).  ``edges`` is the per-feature
    edge list or an [F, nbins] matrix, ``gen`` the ``torch.Generator`` of
    the per-split column draws (``draw_generator``) in place of the JAX
    package's key, ``bin_counts`` the features' bins in use (the packed
    histogram engages on a card where it saves work).  ``mono`` or
    ``hier`` force the separate search, the dense layout and the level
    program, as there.  Returns (``Tree``, the final leaf of every row
    [N]), on the codes' device."""
    from .binning import edges_matrix
    F, N = codes.shape
    dev = codes.device
    if isinstance(edges, (list, tuple)):
        edges = edges_matrix(edges, nbins)
    edges_mat = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    # no mask is every column (the JAX package's ones(F))
    tm = None if tree_col_mask is None else torch.as_tensor(
        tree_col_mask, dtype=torch.bool, device=dev)
    if mono is not None or hier:
        split_mode = "separate"          # no fused path for these builds
        hist_layout = "dense"            # nor a sparse one
        tree_program = "level"           # nor a scan one
    fn = make_build_tree_fn(max_depth, nbins, F, N, bin_counts=bin_counts,
                            hist_mode=hist_mode, split_mode=split_mode,
                            hist_layout=hist_layout, device=dev, hier=hier,
                            sparse_depth_threshold=sparse_depth_threshold,
                            mono=mono, tree_program=tree_program)
    levels, vals, cover, leaf = fn(codes, g, h, w, edges_mat, gen,
                                   reg_lambda, min_rows,
                                   min_split_improvement, learn_rate,
                                   col_sample_rate, tm, reg_alpha, gamma,
                                   min_child_weight)
    tree = Tree([lv[0] for lv in levels], [lv[1] for lv in levels],
                [lv[2] for lv in levels], [lv[3] for lv in levels], vals,
                cover=cover)
    return tree, leaf


def _mono_bounds(bounds, children, feat, valid, mono_t, reg_lambda,
                 reg_alpha):
    """A monotone level's children's value bounds (the JAX package's
    propagation, shared.py:1117-1136): the children's Newton values
    clipped to their parent's bounds give the midpoint; a constrained
    split caps the left child's upper bound (increasing) or lower bound
    (decreasing) at it and the right child's the other way; interleaved
    (left, right), [K, 2L]."""
    lo, hi = bounds
    lam, alpha = _per_k(reg_lambda, 1), _per_k(reg_alpha, 1)
    vL = _clip(hist.newton_value(children[..., 0], children[..., 1], lam,
                                 alpha), lo, hi)
    vR = _clip(hist.newton_value(children[..., 3], children[..., 4], lam,
                                 alpha), lo, hi)
    mid = 0.5 * (vL + vR)
    c = mono_t[feat.long()] * valid.to(torch.float32)
    hi_l = torch.where(c > 0, torch.minimum(hi, mid), hi)
    lo_l = torch.where(c < 0, torch.maximum(lo, mid), lo)
    hi_r = torch.where(c < 0, torch.minimum(hi, mid), hi)
    lo_r = torch.where(c > 0, torch.maximum(lo, mid), lo)
    return (_pairs(torch.stack([lo_l, lo_r], dim=-1)),
            _pairs(torch.stack([hi_l, hi_r], dim=-1)))


def member_rates(rate, K: int) -> tuple:
    """A sampling rate as K host floats: one rate for every tree, or a
    sequence of one per tree."""
    if not isinstance(rate, (list, tuple)):
        return (float(rate),) * K
    rates = tuple(float(r) for r in rate)
    if len(rates) != K:
        raise ValueError(f"{len(rates)} sampling rates for {K} trees")
    return rates


# ------------------------------------------------- the whole-tree program

@dataclasses.dataclass
class ScanGraphCounts:
    """What the captured tree programs did on the card: graphs captured,
    replays (one a tree, a round or a cohort round), the kernel launches
    one replay of the last capture makes (the wrappers count a launch
    where they record it into the graph, once per capture; a replay
    counts nothing), the device memory of the last capture's private
    pool (the allocator's reserve grown across the capture) and the wall
    seconds of the captures (warm-up, recording and their syncs)."""

    captures: int = 0
    replays: int = 0
    per_replay: dict = dataclasses.field(default_factory=dict)
    pool_bytes: int = 0
    capture_s: float = 0.0

    def reset(self) -> None:
        self.captures = self.replays = self.pool_bytes = 0
        self.capture_s = 0.0
        self.per_replay = {}


SCAN_GRAPHS = ScanGraphCounts()


def _launch_counts() -> dict:
    """Every training kernel's (and form's) launch count, by name."""
    return {k.name: k.launches for k in (
        hist.HIST, hist.HIST_WINDOWS, hist.SPLIT_RECORDS,
        hist.SPLIT_RECORDS_ROWS, hist.SPLIT_RECORDS_MONO, hist.FINE_HIST,
        hist.SLOT_COMPACT)}


class _TreeGraph:
    """One tree program captured as a ``torch.cuda.CUDAGraph``: static
    input buffers (the stats, the padded split masks, the per-tree
    parameters), the graph and its static outputs.  The body runs once on
    a side stream under ``torch.cuda.set_sync_debug_mode("error")``, so
    that any host synchronisation in it raises, then is captured;
    ``run`` copies the inputs in, replays, and clones the outputs, which
    the next replay overwrites.  ``codes`` and ``edges_mat`` are read in
    place: the graph keeps them."""

    def __init__(self, body, codes, edges_mat, stats, masks, params,
                 tables):
        dev = codes.device
        self.codes, self.edges_mat = codes, edges_mat
        self.stats = stats.clone()
        self.masks = None if masks is None else masks.clone()
        self.params = tuple(p.clone() if isinstance(p, torch.Tensor) else p
                            for p in params)
        # the histogram launches' device tables, uploaded once (a copy
        # from the host waits for the stream): (F, B, the widths L)
        hist.prepare_uniform(*tables, dev)

        def call():
            return body(codes, self.stats, self.masks, edges_mat,
                        self.params)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = _launch_counts()
        reserved = torch.cuda.memory_reserved(dev)
        # captured on the side stream directly: ``torch.cuda.graph`` would
        # also collect the host's garbage and empty the allocator's cache
        # at every train's capture
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                self.out = call()
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        SCAN_GRAPHS.capture_s += time.perf_counter() - t0
        after = _launch_counts()
        SCAN_GRAPHS.captures += 1
        SCAN_GRAPHS.per_replay = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        # a private pool takes fresh segments: the reserve's growth
        SCAN_GRAPHS.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def run(self, stats, masks, params):
        self.stats.copy_(stats)
        if masks is not None:
            self.masks.copy_(masks)
        for dst, src in zip(self.params, params):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        self.graph.replay()
        SCAN_GRAPHS.replays += 1
        levels, vals, cover, leaf = self.out
        return ([tuple(x.clone() for x in lv) for lv in levels],
                vals.clone(), cover.clone(), leaf.clone())


def _graph_key(codes, edges_mat, stats, masks, params) -> tuple:
    """A captured tree program's signature: the tensors it reads in place,
    the shapes of its inputs, and every scalar parameter (a tensor
    parameter is copied in, so only its shape counts)."""
    def sig(t):
        return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
    return (sig(codes), sig(edges_mat), tuple(stats.shape),
            None if masks is None else tuple(masks.shape),
            tuple(("t", tuple(p.shape), p.dtype)
                  if isinstance(p, torch.Tensor) else ("f", float(p))
                  for p in params))


def _scan_masks(gens, rates, tree_mask, D: int, W: int, F: int, device):
    """The per-split column masks of a scanned build, drawn before it
    runs, level by level at their true [K, 2^d, F] shapes and in the
    level program's order (each tree's generator, only where its own rate
    is below 1), anded with the tree masks and padded to [D, K, W, F]
    with False; None where nothing is sampled."""
    K = len(gens)
    if min(rates) >= 1.0 and tree_mask is None:
        return None
    out = torch.zeros((D, K, W, F), dtype=torch.bool, device=device)
    for d in range(D):
        L = 2 ** d
        m = torch.stack([
            split_column_mask(L, F, r, gk) if r < 1.0 else
            torch.ones((L, F), dtype=torch.bool, device=device)
            for r, gk in zip(rates, gens)])
        if tree_mask is not None:
            m = m & tree_mask[:, None, :]
        out[d, :, :L] = m
    return out


def _make_scan_build(max_depth: int, nbins: int, F: int, hist_mode: str,
                     nk: int, split_mode: str):
    """The ``tree_program="scan"`` build (the JAX package's
    ``_make_scan_build``, shared.py:1167): the root level, then levels 1
    to D-1 as iterations of one fixed-width program at W = 2^(D-1), the
    deepest level's child count.

    A shallower level leaves the slots from 2^d on empty, and they are
    inert: they histogram exact zeros, the split search finds them
    invalid and ``valid &= alive`` kills whatever it finds, so each
    level's live 2^d slots, the routing and the leaf values are bitwise
    the level program's (the histograms are exact integer sums, whatever
    the width).  The level is ``hist.make_batched_scan_level_fn`` under
    hist_mode="subtract" and a full rebuild at W (``hist.local_hist``)
    under "full"; the histogram is the uniform one, as in the reference,
    which forfeits the packed layout.  The per-level column masks are
    drawn before the program runs (``_scan_masks``).  The carried
    ``dead`` predicate (no node alive) skips, on the CPU, the histogram
    and the partition, whose results it already knows.

    On a CUDA device the program is one ``torch.cuda.CUDAGraph`` a tree
    (with ``nk`` > 1, a round or a cohort round): captured for its
    signature (``_graph_key``; a new signature captures anew, and a train
    has one) and replayed once a tree
    (``_TreeGraph``; counted in ``SCAN_GRAPHS``).  A capture that fails
    raises: no scan runs eagerly on a card.  On the CPU the same body
    runs eagerly.  ``build`` takes and returns what the level build
    does."""
    B = nbins + 1
    D = max_depth
    W = 2 ** (D - 1)
    Wp = W // 2
    subtract = hist_mode == "subtract"
    lev0 = hist.make_batched_level_fn(0, nk, F, B)
    scan_lev = hist.make_batched_scan_level_fn(W, nk, F, B)
    split_fn = hist.fused_best_splits if split_mode == "fused" \
        else hist.best_splits
    tables = (F, B, (1, Wp if subtract else W))

    def body(codes, stats, masks, edges_mat, params):
        (reg_lambda, min_rows, min_split_improvement, learn_rate, reg_alpha,
         gamma, min_child_weight) = params
        K, _, N = stats.shape
        dev = codes.device
        scale = hist.stat_scale(stats)                       # [K, 2, 3]

        def split(H, mask):
            return hist.batched_splits(
                split_fn, H, nbins, reg_lambda, min_rows,
                min_split_improvement, mask, reg_alpha, gamma,
                min_child_weight)[:6]

        def record(feat, bin_, na_left, valid, L):
            thr = edges_mat[feat.long(), bin_.clamp(0, nbins - 1).long()]
            return tuple(x[:, :L] for x in (feat, thr, na_left, valid))

        # the root, outside the scan: no carry, no sibling
        leaf = torch.zeros((K, N), dtype=torch.int32, device=dev)
        H, _ = lev0(codes, leaf, stats, None, scale)
        if subtract:
            carry = torch.nn.functional.pad(H, (0, 0, 0, 0, 0, Wp - 1))
        feat, bin_, na_left, _, valid, children = split(
            H, None if masks is None else masks[0][:, :1])
        leaf = hist.partition(codes, leaf, feat, bin_, na_left, valid, nbins)
        levels = [record(feat, bin_, na_left, valid, 1)]
        alive = torch.nn.functional.pad(
            _pairs(torch.stack([valid, valid], dim=-1)), (0, W - 2))
        for d in range(1, D):
            dead = ~alive.any()
            if subtract:
                H, carry = scan_lev(codes, leaf, stats, carry, scale, dead)
            else:
                H = hist.local_hist(codes, leaf, stats, W, F, B, None, scale)
            feat, bin_, na_left, _, valid, ch = split(
                H, None if masks is None else masks[d])
            valid, children = _collapse_dead(valid, alive, ch)
            # the next level reads its first 2^(d+1) <= W slots: the
            # interleave of the first W/2 parents covers them
            alive = _pairs(torch.stack([valid[:, :Wp], valid[:, :Wp]],
                                       dim=-1))
            if not codes.is_cuda and bool(dead):
                leaf = 2 * leaf             # every node terminal: all left
            else:
                leaf = hist.partition(codes, leaf, feat, bin_, na_left,
                                      valid, nbins)
            levels.append(record(feat, bin_, na_left, valid, 2 ** d))
        vals, cover = _leaf_values(children, reg_lambda, reg_alpha,
                                   learn_rate)
        return levels, vals, cover, leaf

    graphs = {}                 # the graph of the last signature
    narrow = {}

    def grow(codes, stats, masks, edges_mat, params):
        if not codes.is_cuda:
            return body(codes, stats, masks, edges_mat, params)
        if codes.dtype != torch.int16 and B <= torch.iinfo(torch.int16).max:
            # the graph reads int16 codes: half the bytes of every code
            # gather and histogram pass; made once a train (the graphs
            # key on the copy)
            sig = (codes.data_ptr(), tuple(codes.shape), codes.stride())
            if narrow.get("sig") != sig:
                narrow.update(sig=sig, src=codes,
                              codes=codes.to(torch.int16))
            codes = narrow["codes"]
        key = _graph_key(codes, edges_mat, stats, masks, params)
        if key not in graphs:
            graphs.clear()
            graphs[key] = _TreeGraph(body, codes, edges_mat, stats, masks,
                                     params, tables)
        return graphs[key].run(stats, masks, params)

    def build(codes, g, h, w, edges_mat, gen, reg_lambda, min_rows,
              min_split_improvement, learn_rate, col_sample_rate,
              tree_mask, reg_alpha, gamma, min_child_weight, hcodes=None):
        params = (reg_lambda, min_rows, min_split_improvement, learn_rate,
                  reg_alpha, gamma, min_child_weight)
        if nk > 1:
            stats = torch.stack([g, h, w.expand_as(g)], dim=1) \
                .to(torch.float32)
            gens, tm = list(gen), tree_mask
        else:
            stats = torch.stack([g, h, w]).to(torch.float32)[None]
            gens = [gen]
            tm = None if tree_mask is None else tree_mask[None]
        masks = _scan_masks(gens, member_rates(col_sample_rate, len(gens)),
                            tm, D, W, F, codes.device)
        levels, vals, cover, leaf = grow(codes, stats, masks, edges_mat,
                                         params)
        if nk > 1:
            return levels, vals, cover, leaf
        return ([tuple(x[0] for x in lv) for lv in levels], vals[0],
                cover[0], leaf[0])

    build.max_depth = max_depth
    build.use_varbin = False
    build.bin_counts = None
    build.nk = nk
    build.program = "scan"
    build.graphs = graphs
    return build


def _scan_codes(bt_fn, codes, nbins: int, hier: bool):
    """The codes a chunk's levels read besides the raw ones, made once per
    chunk: super-bin codes under ``hier``, packed ones under varbin."""
    if hier:
        return hist.coarse_codes(codes, nbins)
    if bt_fn.use_varbin:
        return hist.offset_codes(codes, bt_fn.bin_counts, nbins)
    return None


def _row_sample(w, sample_rate: float, seed, chunk_no: int, t: int):
    """Round t's row weights: ``w`` times its row sample."""
    if sample_rate >= 1.0:
        return w
    gen = draw_generator(seed, chunk_no, t, ROW_SAMPLE, w.device)
    return w * (torch.rand(w.shape, generator=gen, device=w.device)
                < sample_rate)


def make_tree_scan_fn(dist, max_depth: int, nbins: int, F: int,
                      n_padded: int, sample_rate: float,
                      col_sample_rate_per_tree: float, bin_counts=None,
                      hist_mode: str = "subtract", split_mode: str = "fused",
                      hist_layout: str = "dense", device=None,
                      hier: bool = False, sparse_depth_threshold: int = 8,
                      mono=None, plan=None, tree_program: str = "level"):
    """A chunk of boosting or bagging rounds (the JAX package's
    ``make_tree_scan_fn`` as a plain loop over the chunk's trees):
    gradients -> row and column samples -> grow -> F update.  ``dist`` is
    a distribution, or "drf" for the forest's mean fit (g = -y, h = 1,
    shared.py:2080 there: no feedback from F, which sums the trees'
    leaf values).  Returns ``scan_fn(codes, y, w, F0,
    edges_mat, seed, chunk_no, nchunk, reg_lambda, min_rows,
    min_split_improvement, learn_rate, col_sample_rate, reg_alpha, gamma,
    min_child_weight) -> (F, StackedTrees of the chunk)``; tree t of chunk
    ``chunk_no`` draws from ``draw_generator(seed, chunk_no, t, ...)``,
    class 0.  The hierarchical search, monotone constraints ``mono`` and
    a bundle plan ``plan`` (``codes`` then the working codes) take
    split_mode="separate" and the dense layout, as the resolvers give
    them (``own_search``).  ``tree_program="scan"`` grows each tree as
    the whole-tree program (on a card one graph replay a tree)."""
    bt_fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                               bin_counts=bin_counts, hist_mode=hist_mode,
                               split_mode=split_mode,
                               hist_layout=hist_layout, device=device,
                               hier=hier,
                               sparse_depth_threshold=sparse_depth_threshold,
                               mono=mono, plan=plan,
                               tree_program=tree_program)

    def scan_fn(codes, y, w, F0, edges_mat, seed, chunk_no, nchunk,
                reg_lambda, min_rows, min_split_improvement, learn_rate,
                col_sample_rate, reg_alpha, gamma, min_child_weight):
        hcodes = _scan_codes(bt_fn, codes, nbins, hier)
        Fc = F0
        trees = []
        for t in range(nchunk):
            if dist == "drf":
                g0, h0 = -y, torch.ones_like(y)
            else:
                g0, h0 = dist.grad_hess(y, Fc)
            wv = _row_sample(w, sample_rate, seed, chunk_no, t)
            gen = draw_generator(seed, chunk_no, t, 0, w.device)
            tm = tree_column_mask(F, col_sample_rate_per_tree, gen) \
                if col_sample_rate_per_tree < 1.0 else None
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


_MULTINOMIAL = Multinomial()


def make_multinomial_scan_fn(K: int, max_depth: int, nbins: int, F: int,
                             n_padded: int, sample_rate: float,
                             col_sample_rate_per_tree: float,
                             bin_counts=None, hist_mode: str = "subtract",
                             split_mode: str = "fused",
                             hist_layout: str = "dense", device=None,
                             hier: bool = False, mode: str = "multinomial",
                             sparse_depth_threshold: int = 8, plan=None,
                             tree_program: str = "level"):
    """A chunk of rounds of K class trees (the JAX package's
    ``make_multinomial_scan_fn``, shared.py:2108, as a plain loop): per
    round the gradients, one row sample shared by the K trees, a column
    mask and per-split draws per class, and the K trees.  The gradients
    are the softmax's, g = P - Y1, h = max(P (1 - P), 1e-10), for
    ``mode="multinomial"``, and the forest's mean fit, g = -Y1, h = 1,
    for ``mode="drf"`` (each class tree fits its one-hot column; F sums
    the trees' leaf values).

    ``split_mode="fused"`` grows them as one batched build
    (``make_build_tree_fn(nk=K)``: one histogram and one records launch
    per level whatever K is); ``"separate"`` loops over K single builds
    with the plain records, the oracle the batched path is bitwise (the
    same generators, ``draw_generator``).  The hierarchical search and a
    bundle plan (``plan``: ``codes`` the working codes) take the K loop
    and the dense layout, as the resolvers give them (``own_search``).
    ``tree_program="scan"`` grows the round (or each tree of the K loop)
    as the whole-tree program: on a card one graph replay a round.

    Returns ``scan_fn(codes, Y1, w, F0, edges_mat, seed, chunk_no, nchunk,
    reg_lambda, min_rows, min_split_improvement, learn_rate,
    col_sample_rate, reg_alpha, gamma, min_child_weight) -> (F, [K
    StackedTrees of the chunk, one per class])``; Y1 [K, N] is the
    one-hot response, F0 and F the [K, N] scores, class-major."""
    if mode not in ("multinomial", "drf"):
        raise ValueError(f"mode={mode!r}: use 'multinomial' or 'drf'")
    max_depth = effective_max_depth(max_depth, nbins, F, n_padded,
                                    hist_layout)
    batched = split_mode == "fused" and K > 1
    bt_fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                               bin_counts=bin_counts, hist_mode=hist_mode,
                               split_mode=split_mode,
                               hist_layout=hist_layout, device=device,
                               hier=hier, nk=K if batched else 1,
                               sparse_depth_threshold=sparse_depth_threshold,
                               plan=plan, tree_program=tree_program)

    def scan_fn(codes, Y1, w, F0, edges_mat, seed, chunk_no, nchunk,
                reg_lambda, min_rows, min_split_improvement, learn_rate,
                col_sample_rate, reg_alpha, gamma, min_child_weight):
        hcodes = _scan_codes(bt_fn, codes, nbins, hier)
        scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
                col_sample_rate)
        reg = (reg_alpha, gamma, min_child_weight)
        Fc = F0
        rounds = []
        for t in range(nchunk):
            if mode == "drf":
                g, h = -Y1, torch.ones_like(Y1)
            else:
                g, h = _MULTINOMIAL.grad_hess(Y1, Fc)
            wv = _row_sample(w, sample_rate, seed, chunk_no, t)
            gens = [draw_generator(seed, chunk_no, t, k, w.device)
                    for k in range(K)]
            tms = [tree_column_mask(F, col_sample_rate_per_tree, gk)
                   for gk in gens] if col_sample_rate_per_tree < 1.0 \
                else None
            if batched:
                levels, vals, cover, leaf = bt_fn(
                    codes, g * wv, h * wv, wv, edges_mat, gens, *scal,
                    torch.stack(tms) if tms else None, *reg, hcodes=hcodes)
                Fc = Fc + vals.gather(1, leaf.long())
            else:
                per = [bt_fn(codes, g[k] * wv, h[k] * wv, wv, edges_mat,
                             gens[k], *scal, tms[k] if tms else None, *reg,
                             hcodes=hcodes) for k in range(K)]
                levels = [tuple(torch.stack([p[0][d][i] for p in per])
                                for i in range(4))
                          for d in range(len(per[0][0]))]
                vals, cover = (torch.stack([p[i] for p in per])
                               for i in (1, 2))
                Fc = Fc + torch.stack([p[1][p[3].long()] for p in per])
            rounds.append((levels, vals, cover))
        # per class k: the chunk's [T, 2^d] level stacks, as views
        lv = [tuple(torch.stack([r[0][d][i] for r in rounds])
                    for i in range(4)) for d in range(len(rounds[0][0]))]
        vals, cover = (torch.stack([r[i] for r in rounds]) for i in (1, 2))
        return Fc, [StackedTrees([tuple(x[:, k] for x in lvd) for lvd in lv],
                                 vals[:, k], cover[:, k]) for k in range(K)]

    scan_fn.build = bt_fn
    scan_fn.max_depth = max_depth
    return scan_fn


def make_grid_scan_fn(G: int, dist, max_depth: int, nbins: int, F: int,
                      n_padded: int, bin_counts=None,
                      hist_mode: str = "subtract",
                      hist_layout: str = "dense", device=None,
                      sparse_depth_threshold: int = 8,
                      tree_program: str = "level"):
    """A chunk of G-member grid rounds (the JAX package's
    ``make_grid_scan_fn``, shared.py:2235, as a plain loop): the members
    of a cohort share the codes, the response and the tree shape, and
    each carries its own scalar hyperparameters, seed and scores; one
    batched build (``make_build_tree_fn(nk=G)``) grows the round's G
    trees: one histogram launch and one records launch (its per-row form)
    per level whatever G is, at the dense or the node-sparse slot
    geometry alike, so a deep cohort grows the trees of its members' own
    trains (the JAX package pins its cohorts to the dense layout).  Under
    ``tree_program="scan"`` a cohort round is the whole-tree program: on
    a card one graph replay a round.

    Returns ``scan_fn(codes, y, w, F0, edges_mat, seeds, chunk_no, nchunk,
    reg_lambda, min_rows, min_split_improvement, learn_rate,
    col_sample_rate, sample_rate, col_sample_rate_per_tree, alive,
    reg_alpha, gamma, min_child_weight) -> (F, [G StackedTrees of the
    chunk, one per member])``: F0 and F are the [G, N] scores; ``seeds``,
    the three rates and ``alive`` are sequences of G host values; the
    other parameters f32 tensors [G] on the device.

    Member g draws exactly what its own sequential train draws
    (``make_tree_scan_fn``): its row sample, tree mask and per-split masks
    come from ``draw_generator(seeds[g], chunk_no, t, ...)`` and only at
    its own rates below 1 (the JAX package always draws; here one
    generator carries a tree's column draws in order, so a skipped draw
    must stay skipped).  Its gradients are computed on its own [N] row of
    scores.  So member g is bitwise its sequential train.  ``alive`` is
    the successive-halving mask: a retired member's row weights are 0,
    every split of its trees is invalid, its leaf values are 0 and its
    scores stay as they are."""
    if G < 2:
        raise ValueError("make_grid_scan_fn needs G >= 2 (a single member "
                         "is the sequential path)")
    bt_fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                               bin_counts=bin_counts, hist_mode=hist_mode,
                               split_mode="fused", hist_layout=hist_layout,
                               device=device, nk=G,
                               sparse_depth_threshold=sparse_depth_threshold,
                               tree_program=tree_program)

    def scan_fn(codes, y, w, F0, edges_mat, seeds, chunk_no, nchunk,
                reg_lambda, min_rows, min_split_improvement, learn_rate,
                col_sample_rate, sample_rate, col_sample_rate_per_tree,
                alive, reg_alpha, gamma, min_child_weight):
        hcodes = _scan_codes(bt_fn, codes, nbins, False)
        csr = member_rates(col_sample_rate, G)
        srs = member_rates(sample_rate, G)
        cspt = member_rates(col_sample_rate_per_tree, G)
        live = [bool(a) for a in alive]
        Fc = F0
        rounds = []
        for t in range(nchunk):
            gh = [dist.grad_hess(y, Fc[k]) for k in range(G)]
            wv = torch.stack([
                _row_sample(w, srs[k], seeds[k], chunk_no, t) if live[k]
                else torch.zeros_like(w) for k in range(G)])
            gens = [draw_generator(seeds[k], chunk_no, t, 0, w.device)
                    for k in range(G)]
            tm = None
            if min(cspt) < 1.0:
                tm = torch.stack([
                    tree_column_mask(F, cspt[k], gens[k]) if cspt[k] < 1.0
                    else torch.ones((F,), dtype=torch.bool, device=w.device)
                    for k in range(G)])
            g = torch.stack([x[0] for x in gh]) * wv
            h = torch.stack([x[1] for x in gh]) * wv
            levels, vals, cover, leaf = bt_fn(
                codes, g, h, wv, edges_mat, gens, reg_lambda, min_rows,
                min_split_improvement, learn_rate, csr, tm, reg_alpha, gamma,
                min_child_weight, hcodes=hcodes)
            Fc = Fc + vals.gather(1, leaf.long())
            rounds.append((levels, vals, cover))
        lv = [tuple(torch.stack([r[0][d][i] for r in rounds])
                    for i in range(4)) for d in range(len(rounds[0][0]))]
        vals, cover = (torch.stack([r[i] for r in rounds]) for i in (1, 2))
        return Fc, [StackedTrees([tuple(x[:, k] for x in lvd) for lvd in lv],
                                 vals[:, k], cover[:, k]) for k in range(G)]

    scan_fn.build = bt_fn
    return scan_fn


def chunk_schedule(ntrees: int, score_tree_interval: int,
                   chunk_cap: int = 10):
    """Yield (chunk_len, trees_done, score_now): chunks of at most
    ``chunk_cap`` trees whose boundaries land on the scoring intervals.
    Each chunk fence polls the thread's cooperative deadline
    (``parallel.check_deadline``, armed by ``map_builds`` and the cohort
    trainer), so an in-flight build stops within one chunk of a grid's
    max_runtime_secs."""
    from ..parallel import check_deadline
    interval = max(1, min(score_tree_interval, ntrees))
    cap = min(chunk_cap, interval)
    t = 0
    while t < ntrees:
        check_deadline()
        c = min(cap, ntrees - t, interval - (t % interval))
        t += c
        yield c, t, (t % interval == 0 or t >= ntrees)


# --------------------------------------------------------------- oracles

def _grow_host(fn, codes, g, h, w, edges_mat, seed, scal, nk: int = 1,
               k: int = 0):
    """Grow with ``fn`` on the draws of the train's first round (class
    ``k``'s generator, or all ``nk`` classes' for a batched build); the
    levels, leaf values and final leaves on the host, with a leading K
    (of 1 for one tree)."""
    dev = codes.device
    gens = [draw_generator(seed, 0, 0, c, dev) for c in range(k, k + nk)]
    levels, vals, cover, leaf = fn(codes, g, h, w, edges_mat,
                                   gens if nk > 1 else gens[0], *scal)
    lead = (lambda t: t) if nk > 1 else (lambda t: t[None])
    return ([[lead(t).cpu().numpy() for t in lv] for lv in levels],
            lead(vals).cpu().numpy(), lead(leaf).cpu().numpy())


def run_hist_crosscheck(codes, g, h, w, edges_mat, seed: int, *, max_depth,
                        nbins, F, n_padded, bin_counts=None,
                        reg_lambda=0.0, min_rows=1.0,
                        min_split_improvement=1e-5, learn_rate=0.1,
                        reg_alpha=0.0, gamma=0.0, min_child_weight=0.0,
                        nk: int = 1, atol=1e-4, mono=None, plan=None):
    """The hist_mode="check" assert: grow one tree with the subtraction
    path and one with the full rebuild (dense levels, at the dense
    effective depth, as in the JAX package) on the same inputs and raise
    AssertionError on any divergence of split structure, row routing or
    leaf values (exactly tied gains are the one legitimate cause).  ``nk``
    > 1 checks the batched K-tree build (g and h [K, N]) at its own
    geometry, both ways with the fused records, as the JAX package.
    ``mono`` and ``plan`` grow both builds under the constraints or on
    the plan's working codes."""
    outs = {}
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate, 1.0,
            None, reg_alpha, gamma, min_child_weight)
    for mode in ("subtract", "full"):
        fn = make_build_tree_fn(max_depth, nbins, F, n_padded,
                                bin_counts=bin_counts, hist_mode=mode,
                                split_mode="fused" if nk > 1 else "separate",
                                device=codes.device, nk=nk, mono=mono,
                                plan=plan)
        outs[mode] = _grow_host(fn, codes, g, h, w, edges_mat, seed, scal,
                                nk)
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
                         hist_mode="subtract", reg_lambda=0.0, min_rows=1.0,
                         min_split_improvement=1e-5, learn_rate=0.1,
                         col_sample_rate=1.0, reg_alpha=0.0, gamma=0.0,
                         min_child_weight=0.0, nk: int = 1, atol=1e-4):
    """The split_mode="check" assert: grow one round's tree, or its ``nk``
    class trees (g and h [K, N]), with the fused path (batched when ``nk``
    > 1) and with a loop of single builds on the separate best_splits
    oracle, on the same inputs and draws (dense levels, as in the JAX
    package), and raise on divergence.  A dead
    node's stored split is arbitrary, so feature/NA/threshold compare only
    where valid."""
    hm = hist_mode if hist_mode in ("subtract", "full") else "subtract"
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
            col_sample_rate, None, reg_alpha, gamma, min_child_weight)
    max_depth = effective_max_depth(max_depth, nbins, F, n_padded)
    common = dict(bin_counts=bin_counts, hist_mode=hm, device=codes.device)
    sep = make_build_tree_fn(max_depth, nbins, F, n_padded,
                             split_mode="separate", **common)
    fus = make_build_tree_fn(max_depth, nbins, F, n_padded,
                             split_mode="fused", nk=nk, **common)
    rows = (lambda x, k: x[k]) if nk > 1 else (lambda x, k: x)
    per = [_grow_host(sep, codes, rows(g, k), rows(h, k), w, edges_mat,
                      seed, scal, k=k) for k in range(nk)]
    lv_s = [[np.concatenate([p[0][d][i] for p in per]) for i in range(4)]
            for d in range(len(per[0][0]))]
    v_s, leaf_s = (np.concatenate([p[i] for p in per]) for i in (1, 2))
    lv_f, v_f, leaf_f = _grow_host(fus, codes, g, h, w, edges_mat, seed,
                                   scal, nk)
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


def run_layout_crosscheck(codes, g, h, w, edges_mat, seed: int, *,
                          max_depth, nbins, F, n_padded, bin_counts=None,
                          sparse_depth_threshold=8, reg_lambda=0.0,
                          min_rows=1.0, min_split_improvement=1e-5,
                          learn_rate=0.1, col_sample_rate=1.0,
                          reg_alpha=0.0, gamma=0.0, min_child_weight=0.0,
                          nk: int = 1, atol=1e-4):
    """The hist_layout="check" assert (the JAX package's
    ``run_layout_crosscheck``, shared.py:1831-1930): grow one round's
    tree, or its ``nk`` class trees as one batched build (g and h [K,
    N]), with dense levels and with node-sparse levels on the same inputs
    and draws, at the dense effective depth (past it no dense oracle
    exists), and raise AssertionError on divergence.  The sparse levels
    never histogram a dead chain's rows, so valid and the final routing
    must match exactly, feature and NA direction exactly where valid,
    thresholds to tolerance where valid, leaf values to f32 tolerance.
    Children that a full slot budget leaves as leaves
    (``hist.sparse_slot_budget``) trip the valid compare: showing that is
    this mode's job."""
    md = effective_max_depth(max_depth, nbins, F, n_padded)
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
            col_sample_rate, None, reg_alpha, gamma, min_child_weight)
    outs = {}
    for layout in ("dense", "sparse"):
        fn = make_build_tree_fn(md, nbins, F, n_padded,
                                bin_counts=bin_counts, hist_mode="subtract",
                                split_mode="fused" if nk > 1 else "separate",
                                hist_layout=layout, device=codes.device,
                                nk=nk,
                                sparse_depth_threshold=sparse_depth_threshold)
        outs[layout] = _grow_host(fn, codes, g, h, w, edges_mat, seed, scal,
                                  nk)
    lv_d, v_d, leaf_d = outs["dense"]
    lv_s, v_s, leaf_s = outs["sparse"]
    for k in range(nk):
        for d in range(len(lv_d)):
            valid_d = lv_d[d][3][k].astype(bool)
            if not np.array_equal(valid_d, lv_s[d][3][k].astype(bool)):
                raise AssertionError(
                    f"hist_layout='check': dense and sparse builds disagree "
                    f"on valid at tree {k} level {d} (alive children past "
                    f"the slot budget stay leaves on the sparse side: see "
                    f"hist.sparse_slot_budget)")
            for name, i in (("feat", 0), ("na_left", 2)):
                if not np.array_equal(lv_d[d][i][k][valid_d],
                                      lv_s[d][i][k][valid_d]):
                    raise AssertionError(
                        f"hist_layout='check': {name} diverges at tree {k} "
                        f"level {d}")
            if not np.allclose(lv_d[d][1][k][valid_d],
                               lv_s[d][1][k][valid_d], atol=atol,
                               rtol=1e-5):
                raise AssertionError(
                    f"hist_layout='check': split thresholds diverge at "
                    f"tree {k} level {d}")
        if not np.array_equal(leaf_d[k], leaf_s[k]):
            raise AssertionError(
                "hist_layout='check': final leaf routing differs between "
                f"the dense and sparse builds for tree {k}")
        if not np.allclose(v_d[k], v_s[k], atol=atol, rtol=1e-4):
            raise AssertionError(
                f"hist_layout='check': leaf values diverge for tree {k} "
                f"(max abs diff {np.max(np.abs(v_d[k] - v_s[k]))})")


def run_program_crosscheck(codes, g, h, w, edges_mat, seed: int, *,
                           max_depth, nbins, F, n_padded,
                           hist_mode="subtract", split_mode="fused",
                           reg_lambda=0.0, min_rows=1.0,
                           min_split_improvement=1e-5, learn_rate=0.1,
                           col_sample_rate=1.0, reg_alpha=0.0, gamma=0.0,
                           min_child_weight=0.0, nk: int = 1):
    """The tree_program="check" assert (the JAX package's
    ``run_program_crosscheck``, shared.py:1931): grow one round's tree,
    or its ``nk`` class trees as one batched build (g and h [K, N]), with
    the whole-tree scan program and with the level program on the same
    inputs and draws (dense levels, the uniform histogram), and raise
    AssertionError unless they agree bitwise: every level's feature,
    threshold, NA direction and valid flag, the leaf values and the final
    leaf of every row.  The reference compares thresholds and values to
    f32 tolerance, because its histograms' row blocking depends on the
    slot width; the port's histograms are exact int64 sums whatever the
    width, so any difference is a fault, and a tolerance would hide it."""
    hm = hist_mode if hist_mode in ("subtract", "full") else "subtract"
    sm = split_mode if split_mode in ("fused", "separate") else "fused"
    scal = (reg_lambda, min_rows, min_split_improvement, learn_rate,
            col_sample_rate, None, reg_alpha, gamma, min_child_weight)
    outs = {}
    for prog in ("level", "scan"):
        fn = make_build_tree_fn(max_depth, nbins, F, n_padded, hist_mode=hm,
                                split_mode="fused" if nk > 1 else sm,
                                device=codes.device, nk=nk,
                                tree_program=prog)
        outs[prog] = _grow_host(fn, codes, g, h, w, edges_mat, seed, scal,
                                nk)
    (lv_l, v_l, leaf_l), (lv_s, v_s, leaf_s) = outs["level"], outs["scan"]

    def bits(x):
        return x.view(np.int32) if x.dtype == np.float32 else x
    for d, (a, b) in enumerate(zip(lv_l, lv_s)):
        for name, i in (("feat", 0), ("thr", 1), ("na_left", 2),
                        ("valid", 3)):
            if not np.array_equal(bits(a[i]), bits(b[i])):
                raise AssertionError(
                    f"tree_program='check': scan and level builds disagree "
                    f"on {name} at level {d}")
    if not np.array_equal(leaf_l, leaf_s):
        raise AssertionError("tree_program='check': final leaf routing "
                             "differs between the scan and level builds")
    if not np.array_equal(bits(v_l), bits(v_s)):
        raise AssertionError(
            "tree_program='check': leaf values differ between the scan and "
            f"level builds (max abs diff {np.max(np.abs(v_l - v_s))})")


# ------------------------------------------------------------ the model

def fit_calibration(p1: np.ndarray, y: np.ndarray, method: str) -> dict:
    """The calibration curve of class-1 probabilities ``p1`` against the
    response ``y`` (host numpy, the JAX package's ``_post_fit`` with its
    types: f32 probabilities clipped to [1e-12, 1 - 1e-12], rows with a
    finite response): Platt's logistic (``platt_fit``), or the isotonic
    regression (``isotonic._pav``) of y over the probabilities in sorted
    order, whose knots ``np.interp`` reads."""
    p1 = np.clip(p1, 1e-12, 1 - 1e-12)
    ok = np.isfinite(y)
    p1, y = p1[ok], y[ok]
    if method == "isotonic":
        from ..isotonic import _pav
        order = np.argsort(p1)
        ys = _pav(y[order].astype(np.float64), np.ones(len(y), np.float64))
        return {"method": "isotonic", "x": p1[order], "y": ys}
    a, b = platt_fit(p1, y)
    return {"method": "platt", "a": a, "b": b}


def platt_fit(p1: np.ndarray, y: np.ndarray):
    """Platt scaling: the logistic regression of y on p1, (a, b) of
    1 / (1 + exp(-(a p1 + b))), by IRLS in numpy on the host, from (1, 0),
    at most 25 steps, stopping when |da| + |db| < 1e-9 (the JAX
    package's loop, operation for operation)."""
    a, b = 1.0, 0.0
    for _ in range(25):
        eta = a * p1 + b
        mu = 1.0 / (1.0 + np.exp(-eta))
        wq = np.maximum(mu * (1 - mu), 1e-9)
        z = eta + (y - mu) / wq
        X2 = np.stack([p1, np.ones_like(p1)], axis=1)
        A = (X2 * wq[:, None]).T @ X2
        rhs = (X2 * wq[:, None]).T @ z
        sol = np.linalg.solve(A + 1e-9 * np.eye(2), rhs)
        if abs(sol[0] - a) + abs(sol[1] - b) < 1e-9:
            a, b = float(sol[0]), float(sol[1])
            break
        a, b = float(sol[0]), float(sol[1])
    return a, b


class SharedTreeModel(Model):
    """Tree-ensemble model: scores through ``traverse`` on the device."""

    # a forest averages its trees (DRF, DT); a boosted model sums them
    tree_average = False
    # whether the portable archive's tree scorer scores this model as its
    # predict does (``to_archive``); the JAX package exports none of the
    # others either
    exportable = True

    def _calibration_curve(self, p1: np.ndarray) -> np.ndarray:
        """Class-1 probabilities -> calibrated ones, on the host (the JAX
        package's ``_calibration_curve``): Platt's logistic 1 / (1 +
        exp(-(a p1 + b))) or the isotonic knots' ``np.interp``."""
        cal = self.output.get("calibration")
        if cal is None:
            raise ValueError("model was not calibrated "
                             "(calibrate_model=True + calibration_frame)")
        if cal["method"] == "platt":
            return 1.0 / (1.0 + np.exp(-(cal["a"] * p1 + cal["b"])))
        return np.interp(p1, cal["x"], cal["y"])

    def calibrated_probabilities(self, frame: Frame) -> np.ndarray:
        """P(class 1) after calibration (CalibrationHelper.predict)."""
        raw = self._predict_raw(self._score_matrix(frame))[: frame.nrows]
        raw = raw.cpu().numpy()
        return self._calibration_curve(raw[:, 1] if raw.ndim == 2 else raw)

    def predict(self, frame: Frame) -> Frame:
        """``Model.predict``, and for a calibrated model ``cal_p0`` and
        ``cal_p1``: the curve of the class-1 probability column."""
        out = super().predict(frame)
        if self.output.get("calibration") is not None:
            dom = self.datainfo.response_domain
            p1 = self._calibration_curve(out.vec(str(dom[1])).to_numpy())
            out = out.with_vec("cal_p0", Vec.from_numpy(
                1.0 - p1, T_NUM, device=frame.device))
            out = out.with_vec("cal_p1", Vec.from_numpy(
                p1, T_NUM, device=frame.device))
        return out

    def _host_trees(self) -> list:
        """Every tree with its arrays on the host, each stack's planes
        brought over once: a list of ``Tree``s of numpy arrays, round by
        round and, for K class-tree stacks, class by class within a round
        (the JAX package's order of its ``trees``)."""
        st = self.output["stacked"]
        stacks = st if isinstance(st, list) else [st]
        host = []
        for sk in stacks:
            lv = [[x.cpu().numpy() for x in level] for level in sk.levels]
            vals = sk.values.cpu().numpy()
            cov = None if sk.covers is None else sk.covers.cpu().numpy()
            host.append([Tree([l[0][t] for l in lv], [l[1][t] for l in lv],
                              [l[2][t] for l in lv], [l[3][t] for l in lv],
                              vals[t], None if cov is None else cov[t])
                         for t in range(sk.ntrees)])
        return [tk for rnd in zip(*host) for tk in rnd]

    def varimp(self, frame: Optional[Frame] = None,
               method: str = "cover") -> dict:
        """Variable importances — hex/tree VarImp analog (the JAX
        package's ``varimp``, shared.py:2477).

        ``method="cover"``: per-feature sum of training covers at the
        nodes that split on it (cover-weighted split frequency; from the
        recorded leaf covers, no data pass).  ``method="shap"``: mean
        |TreeSHAP contribution| over ``frame`` (needs a frame;
        binomial/regression only).  Returns {feature: relative
        importance}, scaled so the max is 1, every feature listed."""
        from ...export import treeshap
        names = [s.name for s in self.datainfo.specs]
        if method == "shap":
            if frame is None:
                raise ValueError("varimp(method='shap') needs a frame")
            # the f32 contributions of the predict_contributions frame, in
            # f64, as the reference reads them back
            contrib = self._contributions(frame)[:, :-1] \
                .astype(np.float32).astype(np.float64)
            imp = np.abs(contrib).mean(axis=0)
        else:
            imp = np.zeros(len(names))
            for t in treeshap.shap_trees_from_model(self._host_trees()):
                for d in range(t.depth):
                    valid = t.valid[d]
                    cover = t.cover[d]
                    feats = t.feat[d]
                    for i in np.flatnonzero(valid):
                        imp[int(feats[i])] += cover[i]
        mx = imp.max()
        rel = imp / mx if mx > 0 else imp
        order = np.argsort(-rel)
        return {names[i]: float(rel[i]) for i in order}

    def _contributions(self, frame: Frame) -> np.ndarray:
        """[n, F+1] f64 TreeSHAP contributions and BiasTerm of the
        frame's rows: the design from ``_design`` to the host once, the
        trees' arrays once (``_host_trees``)."""
        from ...export import treeshap
        if self.output.get("nclass_trees", 1) > 1:
            raise ValueError("predict_contributions supports binomial and "
                             "regression models only (reference parity)")
        st = treeshap.shap_trees_from_model(self._host_trees())
        X = self._design(frame)[: frame.nrows].cpu().numpy() \
            .astype(np.float64)
        if self.tree_average:
            scale, init = 1.0 / max(len(st), 1), 0.0
        else:
            scale, init = 1.0, float(np.asarray(self.output["init_score"]))
        return treeshap.ensemble_contributions(st, X, init, scale)

    def predict_contributions(self, frame: Frame) -> Frame:
        """Per-feature TreeSHAP contributions + BiasTerm (margin space),
        a frame on the model's device (the JAX package's
        ``predict_contributions``, shared.py:2512).

        Reference: EasyPredictModelWrapper.predictContributions /
        PredictTreeSHAPTask — binomial and regression models only, exact
        Shapley values per Lundberg's TreeSHAP from the per-node covers
        recorded at training, on the host.  ``sum(contributions) +
        BiasTerm`` equals the raw margin (GBM/XGBoost) or the averaged
        leaf sum (DRF)."""
        contribs = self._contributions(frame)
        names = [s.name for s in self.datainfo.specs] + ["BiasTerm"]
        return Frame(names, [Vec.from_numpy(contribs[:, j], T_NUM,
                                            device=frame.device)
                             for j in range(len(names))])

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
                x = vec.data
                if s.type == T_TIME and vec.time_base != s.time_base:
                    x = x + (vec.time_base - s.time_base) / 1000.0
                cols.append(x)
        return torch.stack(cols, dim=1)

    def _raw_scores(self, X: torch.Tensor) -> torch.Tensor:
        """The raw scores [N], or [N, K] for K class-tree stacks (each
        class's initial score plus its trees)."""
        st = self.output["stacked"]
        init = self.output["init_score"]
        if self.output.get("nclass_trees", 1) == 1:
            return init + traverse(st.levels, st.values, X)
        return torch.stack([float(init[k]) + traverse(s.levels, s.values, X)
                            for k, s in enumerate(st)], dim=1)

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout that
        ``export.mojo.from_reference`` reads (the JAX package's
        ``export/mojo.py::_extract`` for GBM/XGBoost/DRF): ``feat_d``,
        ``thr_d``, ``na_left_d``, ``valid_d`` per level, ``values``,
        ``covers``, and ``init_score`` in the metadata; K class-tree stacks
        as K groups of those arrays under the prefixes ``k0_``, ``k1_``,
        ... with ``nclass_trees`` = K and one initial score per class.
        ``tree_average`` is true for a forest (DRF, DT): its scorers divide
        the sum of the trees by their number.  A model the tree scorer
        cannot score (``exportable`` false) raises the JAX package's
        ``no portable export`` error."""
        if not self.exportable:
            from ...export.mojo import no_portable_export
            no_portable_export(self)
        di = self.datainfo
        st = self.output["stacked"]
        K = self.output.get("nclass_trees", 1)
        stacks = list(st) if K > 1 else [st]
        dist = self.output.get("distribution", "gaussian")
        init = self.output["init_score"]
        meta = {
            "algo": self.algo, "format_version": 1,
            "datainfo": datainfo_meta(di),
            "default_threshold": float(self.default_threshold())
            if di.is_classifier else 0.5,
            "family": "tree", "tree_average": self.tree_average,
            "nclass_trees": K,
            "depth": stacks[0].depth, "ntrees": stacks[0].ntrees,
            "link": "log" if dist in ("poisson", "gamma", "tweedie")
            else "identity",
            "init_score": [float(v) for v in np.asarray(init)] if K > 1
            else float(init),
        }
        custom = getattr(self.params, "custom_distribution_func", None)
        if custom is not None and hasattr(custom, "linkinv"):
            # the JAX package writes such a model with an identity link,
            # so that its archive would score otherwise than its predict
            raise ValueError(
                "to_archive: the custom distribution defines linkinv, "
                "which the archive's links (identity, log) cannot carry")
        arrays = {}
        for k, sk in enumerate(stacks):
            pre = f"k{k}_" if K > 1 else ""
            for d, (feat, thr, na_left, valid) in enumerate(sk.levels):
                arrays[f"{pre}feat_{d}"] = feat.cpu().numpy().astype(
                    np.int32)
                arrays[f"{pre}thr_{d}"] = thr.cpu().numpy().astype(
                    np.float32)
                arrays[f"{pre}na_left_{d}"] = na_left.cpu().numpy().astype(
                    bool)
                arrays[f"{pre}valid_{d}"] = valid.cpu().numpy().astype(bool)
            arrays[f"{pre}values"] = sk.values.cpu().numpy().astype(
                np.float32)
            if sk.covers is not None:
                arrays[f"{pre}covers"] = sk.covers.cpu().numpy().astype(
                    np.float32)
        return meta, arrays


class SharedTree(ModelBuilder):
    """Common training pieces: datainfo, targets, interval scoring."""

    # train a numeric response as classes (AdaBoost)
    force_classification = False

    def _validate(self, frame) -> None:
        super()._validate(frame)
        p = self.params
        check_tree_params(p, self.algo)
        if getattr(p, "calibrate_model", False):
            cal = p.calibration_frame
            if cal.device != frame.device:
                raise ValueError(f"the calibration frame lies on "
                                 f"{cal.device}, the training frame on "
                                 f"{frame.device}")
            rc = p.response_column
            dom = frame.vec(rc).domain if rc in frame.names else None
            if dom is not None and len(dom) != 2:
                raise ValueError("calibration supports binomial models only")

    def _post_fit(self, model, frame, valid) -> None:
        """Probability calibration on the held-out ``calibration_frame``
        (hex/tree/CalibrationHelper; the JAX package's ``_post_fit``,
        shared.py:2674): its class-1 probabilities, scored on the model's
        device, against its response, through ``fit_calibration``."""
        p = self.params
        if not getattr(p, "calibrate_model", False):
            return
        cal_fr = p.calibration_frame
        di = model.datainfo
        if not di.is_classifier or di.nclasses != 2:
            raise ValueError("calibration supports binomial models only")
        raw = model._predict_raw(model._score_matrix(cal_fr))
        raw = raw[: cal_fr.nrows].cpu().numpy()
        y = di.response(cal_fr)[: cal_fr.nrows].cpu().numpy()
        model.output["calibration"] = fit_calibration(
            raw[:, 1] if raw.ndim == 2 else raw, y, p.calibration_method)

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=p.response_column,
            ignored_columns=p.ignored_columns,
            weights_column=p.weights_column,
            offset_column=p.offset_column, standardize=False,
            missing_values_handling="mean_imputation",
            force_classification=self.force_classification)

    def _prep_targets(self, y, w, dist):
        """(y with NaN -> 0, the initial score)."""
        y0 = torch.where(torch.isnan(y), 0.0, y)
        return y0, dist.init_score(y0, w)

    def _scores_to_preds(self, F, dist, di):
        """Training scores -> predictions: [N, K] probabilities from the
        class-major [K, N] multinomial scores (softmax over the classes),
        [N, 2] for binomial, the predictions otherwise."""
        if dist.name == "multinomial":
            return torch.softmax(F, dim=0).t()
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
