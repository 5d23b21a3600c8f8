#!/usr/bin/env python3
"""GPU smoke of h2o3_tpu_torch: the quickest proof that the port starts
on a CUDA card and serves through its own kernels.

Phases (any failure exits non-zero and prints no result line):

1. device  — the card's name and power limit (nvidia-smi) and torch's name;
2. build   — every CUDA kernel of the port, one nvcc per source, all
             started together, from the sources in this checkout; the
             atomic opcodes of the two histogram libraries
             (``cuobjdump -sass``: native ATOMS.ADD, no compare-and-swap
             loop) and of a probe of one shared f32, u32 and u64 add and
             one global u64 add (``PROBE``);
3. models  — the serving profile: a binomial GBM-shaped export of 300
             trees x depth 10 over 32 features (~85% of heap nodes
             split, leaf values x0.1) and a multinomial K=3 group of 50
             trees per class at depth 6, from np.random.default_rng(7);
4. kernels — the traversal against its plain torch version on the
             card for both models at B = 1, 8, 37, 256 and 1024 (2% NaN
             cells), and for the multinomial group also at 600,000 rows
             (more row tiles than a grid's y dimension holds): bitwise
             equal leaves, and score_mode="check" against the numpy
             ScoringModel;
5. serve   — launch counts set to 0, then publish("smoke", model) and
             8 client threads x 50 single-row predict_rows requests
             through the MicroBatcher (max_batch=256, tick 1 ms); every
             answer is checked against the numpy ScoringModel, and the
             kernel's launch count must equal the batcher's launches;
6. times   — each kernel and its plain version timed with CUDA events
             (median of 50 launches) beside the least time the card
             could take for the same work (bytes over 3.35 TB/s, f32
             operations over 67 TFLOP/s: the H100 SXM data sheet); the
             traversal's sector reckoning, and the traversal of both
             models at B = 1, 8, 64, 256, 1024 and the serve phase's
             mean batch (in turns with the other version's kernel, given
             ``--other``);
7. train kernels — on the bench frame (``make_airlines_like``, the draws
             of bench.py) at 1,000,000 rows, the level inputs of one tree
             are captured; ``hist_uniform``, ``hist_varbin`` and
             ``split_records`` are held against their plain versions on
             them (and on a ragged row count and L = 1, 8, 32):
             the fixed-point histograms bitwise on integer-valued stats
             and on the real bernoulli stats, a second launch bitwise the
             first, each plane within 1e-5 of its total from this
             script's own f64 sums (the distance printed); records
             bitwise on the levels and on the edge cases of their block
             argmax (NaN planes, every gain -inf, ties of two bins in one
             thread, in one warp and across warps, nbins = 2, 31, 32,
             33, 256), a second launch bitwise the first;
8. train   — launch counts set to 0, then
             ``XGBoost(max_depth=6, nbins=256, seed=1, ntrees=20)`` trains
             on the 1M-row frame on the card: ``hist`` and
             ``split_records`` must each launch trees x levels times.  The
             same train through plain torch on the card (the histograms
             this script's own f64 ``index_add_``, rounded to f32: see
             ``train_plain``) must give the same splits at every level of
             the first tree, predictions to rtol 1e-4 and the training
             AUC to 1e-4.  The model is then published and a 256-row
             batch answered by ``predict_rows`` must equal ``m.predict``.
             A second kernel train must give bitwise identical trees and
             leaf values;
9. train times — each training kernel's device time per tree (the six
             captured level launches) beside its bound, its plain
             version and, for the histograms, the one int64
             ``index_add_`` call that computes the same sums;
10. hier kernels — the same train with ``split_search="hier"`` (the
             hierarchical split search) captures one tree's level inputs;
             ``fine_hist`` is held against its plain version on them, on
             a ragged row count, with rows of leaf -1 and on the
             nbins = 61 geometry whose NA code aliases into a fine slot
             (bitwise on integer-valued and on the real stats, a second
             launch bitwise the first, within 1e-5 of each plane's total
             of the f64 sums); so is the coarse pass's ``hist_uniform``
             on its captured levels, with the 3 planes the path launches
             and with 4;
11. hier train — launch counts set to 0, then the 20-tree hier train at
             1M rows: ``fine_hist`` and ``hist`` must each launch trees x
             levels times and ``split_records`` never.  The same train
             with the wrappers swapped for their plain versions must
             give the same splits on the first tree (a threshold may
             differ only where both bins route every row alike: the two
             sides of a structural tie, summed from different
             histograms), predictions to rtol 1e-4 and the training AUC
             to 1e-4; the AUC must lie within 0.01 of the exact search's;
             the model published must answer like ``m.predict``; a
             second kernel train must give bitwise identical trees and
             leaf values;
12. hier times — ``fine_hist`` per captured level and per tree beside
             its bound, its plain version and the one int64
             ``index_add_`` call on its precomputed slots; the coarse
             ``hist_uniform`` launches beside theirs;
13. headlines — the bench protocol at its default 10,000,000 rows, for
             the exact search (given ``--other``, in turns with that
             version's train) and then the
             hierarchical search: a 20-tree warmup train, then trees/s
             of a 50-tree train, with a
             torch.profiler breakdown of a 10-tree train and the host's
             cost of one small torch op before and after (``host_op_us``),
             which with the device operations per tree bounds the wall a
             launch-bound train can reach; then the kernel times of both
             searches (CUDA events) on a captured 10M-row tree of each,
             its records bitwise their plain version.

14. multinomial kernels — on the bench frame at 1M rows with the 3-class
             ``delay_class`` response (``h2o3_tpu_torch.testing``), the
             level inputs of one round of K = 3 class trees are captured;
             on each level the one K-batched ``hist`` launch (blockIdx.z =
             tree, codes shared at the root, each tree's compacted prefix
             below it, each tree on its own fixed-point scale) must equal
             its plain version, a second launch and K launches of one tree
             each, bitwise, on the packed and the uniform layout and on
             integer-valued and the real softmax stats; the records of the
             K*L flattened leaves bitwise their plain version;
15. multinomial train — launch counts set to 0, then ``XGBoost(max_depth
             =6, nbins=256, seed=1, ntrees=20)`` on ``delay_class`` at 1M
             rows: ``hist`` and ``split_records`` must each launch rounds x
             levels times, the counts of the single-class train, whatever
             K; the K loop (``split_mode="separate"``) must give bitwise the
             same trees and leaf values; the plain route on the card the
             same first-round splits, probabilities to rtol 1e-4 and the
             training logloss to 1e-4; a second train bitwise; the
             published model must answer like ``m.predict``.  Then the
             K-batched launch per round in turns with K single launches,
             beside its plain version, the one ``index_add_`` and its bound;
16. multinomial headline — at 10M rows a 20-round warmup, then rounds/s
             and trees/s (K x rounds/s) of a timed 20-round train, batched,
             and of a 5-round train as the K loop, each with a profile's
             device operations per round and idle share; the K-batched
             launch per round in turns with K single launches on a
             captured 10M-row round.
17. grid kernels — on the bench frame at 1M rows, the records inputs of
             one round of the phase-18 cohort (G = 4 members, their K*L
             leaves member-major, one set of parameters per leaf) are
             captured; on each level the per-row ``split_records`` launch
             must equal its plain version with the same per-leaf tensors
             on the real and the integer-valued H, on a NaN g plane, with
             min_rows and min_child_weight ruling out one member only and
             with one member retired (all-zero histogram: no split), and a
             second launch, bitwise; with every leaf on one member's
             parameters it must equal the scalar launch bitwise;
18. grid train — launch counts set to 0, then ``GridSearch(XGBoost,
             {"learn_rate": [0.05, 0.1], "reg_lambda": [0.0, 1.0]},
             grid_batch="on")`` with the bench config at 1M rows and 20
             trees: ``hist`` and the per-row ``split_records`` must each
             launch rounds x levels times, the scalar records never; each
             member bitwise its own sequential train (trees, leaf values,
             predictions); a second cohort bitwise; the plain route the
             same first-tree splits per member, training AUC to 1e-4; a
             sampled cohort (``sample_rate`` and ``col_sample_rate_per_tree``
             in [0.8, 1.0], ``col_sample_rate=0.6``) bitwise its members'
             sequential trains; successive halving (``halving_eta=2``)
             leaves every member bitwise the first trees of its sequential
             train and the retired members' trees after retirement without
             a split or a non-zero leaf value; a member published; then the
             per-row launch per round beside its plain version and bound;
19. grid headline — at 10M rows a 5-round warmup, then member trees/s (G
             x rounds/s) of a timed 20-round cohort, the device operations
             per round and idle share of a profiled cohort of the same size,
             the wave path's trees/s (the members as sequential 20-tree
             trains, ``grid_batch="off"``), and the per-row records per
             round (bitwise its plain version) beside its bound.
20. slot levels — on the bench frame at 1M rows, one tree of
             ``DRF(max_depth=20, nbins=64, sample_rate=1, mtries=-2)`` and
             one round of K = 3 class trees on ``delay_class`` are
             captured; at every node-sparse level (from depth 8, at most
             4,096 slots) ``slot_compact`` must give its plain version's
             row_start and chosen slots and, in every parent slot's
             window, the same rows (told apart by a row-number code
             plane) with the same codes, parent slot and stats, twice;
             the one windowed ``hist`` launch (L = the parent slots, each
             tile over its parent slots' row windows) must equal its
             plain version, a second launch and the full-prefix launch
             (``row_start=None``), bitwise, on the captured and on
             integer-valued stats, and the plain histogram of the plain
             compaction's prefix; the records over the K*A slots theirs;
             the slot budget must bind (the alive children made
             terminal, per level, are printed);
21. DRF train — launch counts set to 0, then the 3-tree DRF above: the
             scalar records must launch trees x ``effective_max_depth``
             times (60), the full-prefix ``hist`` once per dense level
             (24), ``slot_compact`` and the windowed ``hist`` once per
             sparse level (36 each); the plain route the same
             first-tree splits, predictions to rtol 1e-4, training AUC to
             1e-4; a second train bitwise; the sampled K = 3 forest
             (``sample_rate=0.632``, ``mtries=-1``, 2 rounds) launching
             rounds x levels, whatever K, and bitwise its K loop
             (``split_mode="separate"``); ``hist_layout="check"`` at
             ``max_depth=12``, ``sparse_depth_threshold=4``; DRF at its
             defaults (5 trees) published and 400 single-row requests
             served through the MicroBatcher, every answer against the
             numpy ScoringModel (rtol 1e-4, atol 1e-5), ``traverse``
             launched once per batcher launch;
22. DRF headline — at 10M rows DRF at its defaults (depth 20,
             ``sample_rate=0.632``, ``mtries=-1``, ``min_rows=1``): a 3-tree
             warmup, then trees/s of a timed 10-tree forest, the device
             peak memory, the device operations per tree, idle share and
             device ms by op of a profiled forest of the same size; then
             one captured tree's sparse levels, per level and per tree:
             the windowed ``hist`` in turns with the same kernel over the
             same prefix without windows (windowed, full, full,
             windowed), beside its plain version, the one int64
             ``index_add_`` and its bound; ``slot_compact`` beside its
             plain version, the row-order compaction it replaced
             (``row_order_compaction``, kept for timing) and its bound;
             the records beside their plain version and bound.
23. import — the bench frame at 10M rows written to a CSV in a
             temporary directory (vectorised per column and 1M-row chunk,
             floats ``%.9g``: each reads back as the float32 it was) and
             ``import_file``d onto the card with carrier, origin and dest
             typed "cat": every column bitwise ``Frame.from_numpy`` built
             with the parser's domains (the str of each code as a float,
             sorted as strings), a second import bitwise the first, the
             first 1M rows through the stdlib tokenizer bitwise the native
             engine's (the same codes; labels "5" for "5.0"); rows/s,
             MB/s, the stage seconds and the device peak;
24. import train — launch counts set to 0, then 20 trees of the bench
             XGBoost on the import: 120 ``hist`` and 120 ``split_records``
             launches, bitwise the trees of the same train on the numpy
             frame;
25. DT — launch counts set to 0, then ``DecisionTree()`` (depth 20,
             node-sparse from 8) on an imported 1M-row CSV: 20 records,
             8 full-prefix ``hist``, 12 ``slot_compact`` and 12 windowed
             ``hist`` launches, the plain route's splits at every level, a
             second
             train bitwise, published and served against the numpy
             ScoringModel; one DT at 10M rows timed;
26. isolation — IsolationForest (50 trees) and EIF (10 trees) on the 1M
             import, bitwise a ``device="cpu"`` train of the same file and
             seed; the IsolationForest's archive scored through one
             ``traverse`` launch over the 1M rows as ``predict`` does, then
             published and served; trees/s of both at 10M rows;
27. uplift — launch counts set to 0, then ``UpliftDRF(max_depth=10)``, 3
             trees, on an imported 1M-row CSV of the bench features plus a
             treatment and a conversion with a planted effect: 24
             full-prefix ``hist`` launches and 6 ``slot_compact`` and 6
             windowed ones (both arms one launch a level, levels 8-9
             node-sparse), the plain route's splits on the first tree, a
             second train bitwise; trees/s at 10M rows (the timed train
             twice), the device operations per tree, idle share and
             device ms by op of a profiled train of the same size.
28. DART — launch counts set to 0, then ``XGBoost(booster="dart",
             rate_drop=0.1, max_depth=6, nbins=256, seed=1)``, 20 trees on
             the 1M-row bench frame: 120 ``hist`` and 120 ``split_records``
             launches and at least one round with drops; the plain route
             the same splits in every tree (those grown after a drop
             included), predictions to rtol 1e-4, AUC to 1e-4; a second
             train bitwise; published and answered through ``traverse``
             as ``m.predict`` (its kernels run at the exact path's
             shapes: phases 7 and 9 hold and time them there);
29. DART K = 3 — 5 rounds on ``delay_class`` at 1M rows
             (``rate_drop=0.3``, ``one_drop``): rounds x levels launches
             whatever K, bitwise the K loop (``split_mode="separate"``);
30. DART headline — at 10M rows a 5-tree warmup, trees/s of a timed
             20-tree train, and a profiled train of the same size whose
             drop sums (``gbm.tree_scores``), replayed alone under the
             profiler, give their share of the device time;
31. GLM — at 1M rows, TF32 off: binomial at the defaults (IRLSM, lambda
             0, P = 628) against the same fit with the Gram in f64 on the
             card (``gram_f64`` swapped for ``glm.weighted_gram``):
             coefficients within 1e-2 of the largest (the f32 sums times
             the Gram's condition number, printed), the deviance at the
             final coefficients 1e-8, probabilities 1e-3; two planted
             faults (TF32 allowed; the Gram's last row block dropped)
             must break every limit; a second fit bitwise; the lambda search
             (alpha 0.5, 30 lambdas) timed; multinomial on
             ``delay_class``; the archives' numpy scorer on 20,000 rows
             against ``m.predict`` (rtol 1e-5, atol 1e-6);
32. GLM headline — at 10M rows (a 25.1 GB design): seconds of the first
             fit and of one on the cached design, IRLS iterations, the
             device peak, the Gram's device ms (CUDA events) against the
             2·N·P² FLOP bound of the full product and the N·P(P+1) bound
             of its symmetric half (67 TFLOP/s f32), and the idle share of
             a profiled fit.

Phases 12 and 13 also time the three histogram paths of their captured
trees (1M and 10M rows) in turns with the tiles without copies (which
must give the same sums) and, given ``--other DIR``, with the histogram
kernels of the h2o3_tpu_torch package under DIR; phases 9 and 13 time
``split_records`` per captured tree, and phase 6 the traversal, in
turns with that package's (which must give the same records and
leaves).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--other DIR]   (one CUDA card, nvcc on
                                              PATH or under $CUDA_HOME/bin)

e.g. ``mkdir _ab_old && git archive <rev> h2o3_tpu_torch | tar -x -C
_ab_old`` and ``--other _ab_old`` times that version's four training and
serving kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
REPS = 50
# the plain versions and the one-call library yardsticks: tens of ms a
# call at 10M rows, so a median of a few launches holds them
YARDSTICK_REPS = 5
SPIN_CYCLES = 20_000_000         # ~10 ms of device clock
# the node-sparse kernels' launch counts of a train that grows no sparse
# level
NO_SLOT = {"hist (slot windows)": 0, "slot_compact": 0}
# the batch sizes of the traversal's checks and of its turns
TRAVERSE_BATCHES = (1, 8, 37, 256, 1024)
LARGE_BATCH = 600_000
TURN_BATCHES = (1, 8, 64, 256, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """The script's elapsed seconds at the end of a phase."""
    log(f"[{time.perf_counter() - T_START:.1f} s] {phase} done")


def make_airlines_like(n):
    """The bench frame: bench.py's ``make_airlines_like`` (the same draws
    from ``np.random.default_rng(0)``), 5 numeric and 3 categorical
    columns and a binary response."""
    rng = np.random.default_rng(0)
    cols = {
        "year": rng.integers(1987, 2008, n).astype(np.float32),
        "month": rng.integers(1, 13, n).astype(np.float32),
        "day_of_week": rng.integers(1, 8, n).astype(np.float32),
        "crs_dep_time": rng.integers(0, 2400, n).astype(np.float32),
        "distance": np.abs(rng.normal(700, 500, n)).astype(np.float32),
        "carrier": rng.integers(0, 22, n),
        "origin": rng.integers(0, 300, n),
        "dest": rng.integers(0, 300, n),
    }
    logit = (0.002 * (cols["crs_dep_time"] / 100 - 12) ** 2
             - 0.0005 * cols["distance"] / 100
             + 0.2 * np.isin(cols["day_of_week"], (5, 7))
             + 0.1 * rng.normal(size=n))
    dep_delayed = rng.random(n) < 1 / (1 + np.exp(-logit))
    cols["dep_delayed_15min"] = np.where(dep_delayed, "YES",
                                         "NO").astype(object)
    types = {"carrier": "cat", "origin": "cat", "dest": "cat"}
    domains = {"carrier": [str(i) for i in range(22)],
               "origin": [str(i) for i in range(300)],
               "dest": [str(i) for i in range(300)]}
    return cols, types, domains


BENCH_CFG = dict(response_column="dep_delayed_15min", max_depth=6,
                 nbins=256, seed=1, score_tree_interval=10 ** 9)


def serving_profile(T: int, depth: int, F: int, K: int, rng):
    """``(meta, arrays)`` of a GBM-shaped tree export in the portable
    archive layout: heap trees with ~85% of existing nodes split."""
    arrays = {}
    prefixes = [f"k{k}_" for k in range(K)] if K > 1 else [""]
    for p in prefixes:
        valid_prev = np.ones((T, 1), bool)
        for d in range(depth):
            W = 2 ** d
            arrays[f"{p}feat_{d}"] = rng.integers(0, F, (T, W)) \
                .astype(np.int32)
            arrays[f"{p}thr_{d}"] = rng.normal(size=(T, W)) \
                .astype(np.float32)
            arrays[f"{p}na_left_{d}"] = rng.integers(0, 2, (T, W)) \
                .astype(bool)
            exist = np.repeat(valid_prev, 2, axis=1) if d else \
                np.ones((T, 1), bool)
            v = (rng.random((T, W)) < 0.85) & exist
            arrays[f"{p}valid_{d}"] = v
            valid_prev = v
        arrays[f"{p}values"] = (rng.normal(size=(T, 2 ** depth)) * 0.1) \
            .astype(np.float32)
    domain = ["no", "yes"] if K == 1 else ["a", "b", "c"][:K]
    meta = {
        "algo": "gbm", "family": "tree", "tree_average": False,
        "nclass_trees": K, "ntrees": T, "depth": depth,
        "link": "identity",
        "init_score": 0.0 if K == 1 else [0.0] * K,
        "default_threshold": 0.5,
        "datainfo": {
            "specs": [{"name": f"x{i}", "type": "num", "domain": None,
                       "mean": 0.0, "sigma": 1.0, "offset": i, "width": 1}
                      for i in range(F)],
            "response_domain": domain, "response_column": "y",
            "use_all_factor_levels": False, "standardize": False,
            "add_intercept": False, "nfeatures": F,
        },
    }
    return meta, arrays


def batch(rng, B: int, F: int) -> np.ndarray:
    X = rng.normal(size=(B, F)).astype(np.float32)
    X[rng.random((B, F)) < 0.02] = np.nan
    return X


def sass_atomics(lib_path: str, native) -> dict:
    """Counts of the atomic opcodes in a built library's machine code
    (``cuobjdump -sass``, from the CUDA toolkit beside nvcc): what each
    kernel's adds compiled to.  A compare-and-swap loop shows as
    ATOMS.CAST.SPIN."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(native.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ops = collections.Counter(re.findall(
        r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass))
    return dict(sorted(ops.items()))


# one atomic add per kernel: what each kind compiles to on sm_90a
PROBE = r"""
#define SH(T, NAME)                                                       \
  extern "C" __global__ void NAME(T* out, const T* in, const int* idx) { \
    __shared__ T s[1024];                                               \
    s[threadIdx.x] = (T)0;                                              \
    __syncthreads();                                                    \
    atomicAdd(&s[idx[threadIdx.x] & 1023], in[threadIdx.x]);            \
    __syncthreads();                                                    \
    out[threadIdx.x] = s[threadIdx.x];                                  \
  }
SH(float, shared_f32)
SH(unsigned int, shared_u32)
SH(unsigned long long, shared_u64)
extern "C" __global__ void global_u64(unsigned long long* out,
                                      const unsigned long long* in) {
  atomicAdd(out + (threadIdx.x & 7), in[threadIdx.x]);
}
"""


def probe_sass(native) -> dict:
    """What a shared f32, u32 and u64 ``atomicAdd`` and a global u64 one
    compile to (``PROBE`` through the kernels' nvcc target, then
    ``cuobjdump -sass``): {kernel: (atomic opcodes, a branch back?)}.  A
    compare-and-swap loop shows as ATOMS.CAST.SPIN and a branch back."""
    import re
    import shutil
    import tempfile
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(native.nvcc_path()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(
            tmp, "probe.cubin")
        with open(src, "w") as f:
            f.write(PROBE)
        subprocess.run([native.nvcc_path(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
                        "-o", cubin, src], check=True, timeout=300,
                       capture_output=True)
        sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = sorted(set(re.findall(
            r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", fn)))
        out[fn.split("\n", 1)[0].strip()] = (
            ops, len(re.findall(r"\bBRA\b", fn)) > 1)
    return out


def cuda_ms(fn, reps: int = REPS, spin: bool = True) -> float:
    """Median time of one call between two CUDA events, over ``reps``.

    With ``spin`` the stream is first held busy (``torch.cuda._sleep``,
    about 10 ms) so the host has enqueued the call before the first
    event fires: the events then hold device work only.  Without it
    they also hold the time the device waits for the host to enqueue
    the call (the wrapper's Python and the launch)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def traverse_work(planes, X, depth):
    """Bytes and f32 compares the traversal of this batch needs: every
    distinct node its paths touch (word + value, 8 B), the roots, X
    once and the output once; one compare per internal node stepped."""
    import torch
    from h2o3_tpu_torch.serving import pack
    i32, f32, roots = planes
    B, F = X.shape
    node = roots.long().unsqueeze(0).expand(B, -1)
    seen = [node.reshape(-1)]
    steps = 0
    for _ in range(depth):
        w = torch.take(i32, node)
        internal = ((w >> pack.LEAF_BIT) & 1) == 0
        steps += int(internal.sum())
        feat = (w & pack.FEAT_MASK).long()
        x = torch.gather(X, 1, feat)
        thr = torch.take(f32, node)
        nal = (w >> pack.NA_LEFT_BIT) & 1
        right = torch.where(torch.isnan(x), nal == 0, x >= thr)
        delta = (w >> pack.DELTA_SHIFT) & pack.DELTA_MASK
        node = node + torch.where(internal, delta + right.int(), 0)
        seen.append(node.reshape(-1))
    n_nodes = int(torch.unique(torch.cat(seen)).numel())
    R = roots.numel()
    nbytes = 8 * n_nodes + 4 * R + 4 * B * F + 4 * B * R
    return nbytes, steps, n_nodes


def traverse_turns(scorers, rng, F, mean_batch, kernel, other, card):
    """Phase 6: the traversal of both serving models at ``TURN_BATCHES``
    and at the serve phase's mean batch: the kernel (as the scorer calls
    it) and, given ``other``, that version's kernel in turns (the device
    ms of one launch); raises unless both give bitwise the same leaves.
    The other wrapper gets the record plane where it takes one, else
    pack.py's two planes."""
    import inspect
    import torch
    nb = max(1, int(round(mean_batch)))
    for k, ps in scorers.items():
        variants = [("this kernel", lambda X, ps=ps: lambda: kernel.traverse(
            ps._d_nodes, ps._d_roots, X, ps.depth), None)]
        if other:
            okernel = other[2]
            nodes = (ps._d_nodes,) if "nodes" in inspect.signature(
                okernel.traverse).parameters else tuple(
                    p.contiguous() for p in kernel.planes(ps._d_nodes))
            variants.append((other[0], lambda X, ps=ps, nodes=nodes:
                             lambda: okernel.traverse(
                                 *nodes, ps._d_roots, X, ps.depth), None))
        batches = sorted(set(TURN_BATCHES) | {nb})
        launches = [(b, lambda f, X=batch(rng, b, F): f(
            torch.from_numpy(X).cuda())) for b in batches]
        ms, diff = turns(launches, variants)
        for b in batches:
            if any(v != 0.0 for v in diff[b].values()):
                raise AssertionError(f"traverse variants differ on {k} at "
                                     f"B={b}: {diff[b]}")
            log(f"traverse in turns on {k} at B={b}"
                + (f" (the serve phase's mean batch, {mean_batch:.2f} rows)"
                   if b == nb else "")
                + f" {card}, device ms of one launch: " + "; ".join(
                    f"{tag} {v:.4f}" for tag, v in ms[b].items()))


# ------------------------------------------------------------ training

def plane_err(got, want, planes, nplanes=3):
    """Each plane's max |got - want|, the largest such error relative to
    its plane's total |sum|, and the largest in units of the f32 spacing
    at ``want`` (an f32 result can be no nearer than half of one);
    ``planes`` picks plane s of a histogram."""
    import torch
    errs, rel, ulps = [], 0.0, 0.0
    for s in range(nplanes):
        a, b = planes(got, s).double(), planes(want, s)
        diff = (a - b).abs()
        errs.append(float(diff.max()))
        rel = max(rel, errs[-1] / max(float(b.abs().sum()), 1.0))
        w = b.float().abs()
        ulp = (torch.nextafter(w, torch.full_like(w, float("inf"))) - w)
        ulps = max(ulps, float((diff / ulp.double()).max()))
    return errs, rel, ulps


def max_diff(a, b) -> float:
    """max |a - b| of two f32 tensors: 0 where they hold the same bits
    (equal infinities and NaNs included), inf where a non-finite entry
    differs; 0.0 when bitwise equal."""
    import torch
    same = a.contiguous().view(torch.int32) == b.contiguous().view(
        torch.int32)
    d = (a.double() - b.double()).abs()
    d = torch.where(d.isnan(), float("inf"), d)
    return float(torch.where(same, 0.0, d).max()) if d.numel() else 0.0


def dense_plane(h, s):
    return h[s]


def packed_plane(h, s):
    return h[:, s::3]


def capture_levels(fr, XGBoost, hist):
    """Train one tree with the histogram and records wrappers watched:
    the inputs each level gave ``hist_varbin`` (with the tree's
    fixed-point scale; a tree's own, also where the level launched it as
    a batch of one) and ``split_records``."""
    hv, sr = [], []
    real_hv, real_sr = hist.hist_varbin, hist.split_records

    def spy_hv(gcodes, leaf, stats, L, bc, B, scale=None, row_start=None):
        # the one-tree subtract level launches as a batch of one
        # (make_batched_level_fn's K = 1): keep the tree's own operands
        one = (gcodes[0] if gcodes.dim() == 3 else gcodes, leaf[0],
               stats[0], scale[0]) if leaf.dim() == 2 else \
            (gcodes, leaf, stats, scale)
        hv.append((one[0].clone(), one[1].clone(), one[2].clone(), L,
                   tuple(bc), B, one[3]))
        return real_hv(gcodes, leaf, stats, L, bc, B, scale,
                       row_start=row_start)

    def spy_sr(Hist, nbins, *args, **kw):
        sr.append((Hist.clone(), nbins, args))
        return real_sr(Hist, nbins, *args, **kw)

    hist.hist_varbin, hist.split_records = spy_hv, spy_sr
    try:
        XGBoost(ntrees=1, **BENCH_CFG).train(fr)
    finally:
        hist.hist_varbin, hist.split_records = real_hv, real_sr
    return hv, sr


def f64_uniform(codes, leaf, stats, L, B, planes=3):
    """This script's own f64 level histogram on the uniform axis, one f64
    ``index_add_`` and no fixed point: the oracle the kernels' sums are
    measured by, independent of the port's plain versions.  [planes, L,
    F, B] f64; planes = 4 adds the |g| plane."""
    import torch
    F, n = codes.shape
    dev = codes.device
    st = stats.double()
    if planes == 4:
        st = torch.cat([st, st[:1].abs()])
    c = codes.long()
    lf = leaf.long()
    ok = ((lf >= 0) & (lf < L))[None, :] & (c >= 0) & (c < B)
    idx = (lf[None, :] * F + torch.arange(F, device=dev)[:, None]) * B + c
    out = torch.zeros((planes, L * F * B), dtype=torch.float64, device=dev)
    out.index_add_(1, idx[ok], st[:, None, :].expand(planes, F, n)[:, ok])
    return out.view(planes, L, F, B)


def f64_varbin(gcodes, leaf, stats, L, layout):
    """The same on the packed axis: [Q8, 3L] f64, column 3 l + s."""
    import torch
    F, n = gcodes.shape
    dev = gcodes.device
    q = gcodes.long()
    lf = leaf.long()
    lo = torch.as_tensor(layout.qstart, device=dev)[:, None]
    hi = lo + torch.as_tensor(layout.qlen, device=dev)[:, None]
    ok = ((lf >= 0) & (lf < L))[None, :] & (q >= lo) & (q < hi)
    out = torch.zeros((layout.Q * L, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, (q * L + lf[None, :])[ok],
                   stats.double().t()[None].expand(F, n, 3)[ok])
    return out.view(layout.Q, 3 * L)


def f64_fine(codes, leaf, stats, sel, W, nbins):
    """The same for the fine histogram: [3, L, F, K, W] f64, slot (l, f,
    k, t) summing the rows of leaf l whose regular code is sel[l, f, k] *
    W + t."""
    import torch
    L, F, K = sel.shape
    dev = codes.device
    c = codes.long().t()                                       # [n, F]
    lf = leaf.long()
    lc = lf.clamp(0, L - 1)
    hit = (sel.long()[lc] == (c // W)[:, :, None]) \
        & ((c >= 0) & (c < nbins))[:, :, None] \
        & ((lf >= 0) & (lf < L))[:, None, None]                # [n, F, K]
    idx = ((lc[:, None, None] * F + torch.arange(F, device=dev)[None, :,
                                                                None]) * K
           + torch.arange(K, device=dev)[None, None, :]) * W \
        + (c % W)[:, :, None]
    st = stats.double()[:, :, None, None].expand(3, c.shape[0], F, K)
    out = torch.zeros((3, L * F * K * W), dtype=torch.float64, device=dev)
    out.index_add_(1, idx[hit], st[:, hit])
    return out.view(3, L, F, K, W)


def per_tree(fn, codes, leaf, stats, *args):
    """``fn`` of one tree, or stacked over the K trees of a batched call
    (leaf [K, n]; codes [F, n] shared or [K, F, n] each tree's own)."""
    import torch
    if leaf.dim() == 1:
        return fn(codes, leaf, stats, *args)
    return torch.stack([fn(codes[k] if codes.dim() == 3 else codes,
                           leaf[k], stats[k], *args)
                        for k in range(leaf.shape[0])])


@contextlib.contextmanager
def plain_route(hist):
    """``hist_varbin``, ``hist_uniform``, ``split_records``,
    ``fine_hist`` and ``slot_compact`` swapped for plain torch on the card
    while the block runs: the route the kernels' training is held
    against.  Its histograms are this script's own f64 ``index_add_``
    (``f64_uniform``, ``f64_varbin``, ``f64_fine``; tree by tree for a
    batched call; by leaf id, so a prefix's row windows need no reading)
    rounded to f32, not the port's fixed-point plain versions: an oracle
    independent of the arithmetic under test; its records the plain
    ``_split_records_torch`` (per-leaf parameters included); its
    node-sparse compaction ``slot_compact_torch``."""
    real = (hist.hist_varbin, hist.hist_uniform, hist.split_records,
            hist.fine_hist, hist.slot_compact)

    def varbin(gcodes, leaf, stats, L, bc, B, scale=None, row_start=None):
        return per_tree(f64_varbin, gcodes, leaf, stats, L,
                        hist.packed_layout(tuple(bc), B)).float()

    def uniform(codes, leaf, stats, L, B, planes=3, scale=None,
                row_start=None):
        return per_tree(f64_uniform, codes, leaf, stats, L, B,
                        planes).float()

    def records(Hist, nbins, *args):
        return hist._split_records_torch(Hist, *args)

    def fine(codes, leaf, stats, sel, W, nbins, scale=None):
        return f64_fine(codes, leaf, stats, sel, W, nbins).float()

    (hist.hist_varbin, hist.hist_uniform, hist.split_records,
     hist.fine_hist, hist.slot_compact) = (varbin, uniform, records, fine,
                                           hist.slot_compact_torch)
    try:
        yield
    finally:
        (hist.hist_varbin, hist.hist_uniform, hist.split_records,
         hist.fine_hist, hist.slot_compact) = real


def train_plain(fr, XGBoost, hist, ntrees, cfg=BENCH_CFG, **extra):
    """The same train through ``plain_route``."""
    with plain_route(hist):
        return XGBoost(ntrees=ntrees, **cfg, **extra).train(fr)


def raw_codes(gcodes, bc, nbins, hist):
    """Packed varbin ids back to the uniform codes (NA -> nbins)."""
    import torch
    offsets, _, _, _ = hist.varbin_layout(bc, nbins + 1)
    off = torch.as_tensor(offsets, device=gcodes.device)[:, None]
    bf = torch.as_tensor([min(b, nbins) for b in bc],
                         device=gcodes.device)[:, None]
    c = gcodes.int() - off
    return torch.where(c == bf, nbins, c).to(torch.int32)


def int_stats(n, gen, dev):
    import torch
    return torch.stack([
        torch.randint(-3, 4, (n,), generator=gen, device=dev),
        torch.randint(0, 3, (n,), generator=gen, device=dev),
        torch.randint(0, 2, (n,), generator=gen, device=dev)]).float()


def check_train_kernels(hv, sr, hist, dev):
    """Phase 7: every training kernel against its plain version on the
    card, on the captured bench levels (with the tree's fixed-point
    scale) and on synthetic ones: the histograms bitwise on integer-valued
    and on the real bernoulli stats, a second launch bitwise the first,
    and each plane's distance from this script's f64 sums; raises on any
    difference.  Returns the largest max|kernel - plain| measured for
    each kernel (0.0 while they agree bitwise)."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    f64_err, f64_ulps = [0.0, 0.0, 0.0], 0.0
    kdiff = {"hist": 0.0, "split_records": 0.0}
    g0, _, st0, _, bc, B, _ = hv[0]
    nbins = B - 1
    layout = hist.packed_layout(bc, B)
    cases = [(g, leaf, st, L, scale, "level %d" % i)
             for i, (g, leaf, st, L, _, _, scale) in enumerate(hv)]
    n0 = g0.shape[1]
    for L in (1, 8, 32):
        leaf = torch.randint(0, L, (n0,), generator=gen, device=dev,
                             dtype=torch.int32)
        cases.append((g0, leaf, st0, L, None, f"L={L}"))
        rag = n0 - 17                  # a ragged row count
        cases.append((g0[:, :rag], leaf[:rag], st0[:, :rag], L, None,
                      f"L={L} n={rag}"))
    for g, leaf, st, L, scale, what in cases:
        g = g.contiguous()
        n = g.shape[1]
        raw = raw_codes(g, bc, nbins, hist)
        for stats, sc, kind in ((int_stats(n, gen, dev), None, "integer"),
                                (st.contiguous(), scale, "real")):
            pv = hist.hist_varbin(g, leaf, stats, L, bc, B, sc)
            pv2 = hist.hist_varbin(g, leaf, stats, L, bc, B, sc)
            pu = hist.hist_uniform(raw, leaf, stats, L, B, scale=sc)
            pv_ref = hist.hist_varbin_torch(g, leaf, stats, L, layout, sc)
            pu_ref = hist.hist_uniform_torch(raw, leaf, stats, L, B,
                                             scale=sc)
            torch.cuda.synchronize()
            kdiff["hist"] = max(kdiff["hist"], max_diff(pv, pv_ref),
                                max_diff(pu, pu_ref))
            for name, a, b in (("hist_varbin", pv, pv_ref),
                               ("hist_varbin, a second launch", pv2, pv),
                               ("hist_uniform", pu, pu_ref),
                               ("hist_varbin expanded vs hist_uniform",
                                hist.expand_varbin(pv, bc, L, B), pu)):
                if not same_bits(a, b):
                    raise AssertionError(
                        f"{name} != plain on {kind} stats ({what}): "
                        f"max|diff| {max_diff(a, b):.3e}")
            if kind == "real":
                errs, rel, ulps = plane_err(
                    pv, f64_varbin(g, leaf, stats, L, layout), packed_plane)
                f64_err = [max(x, y) for x, y in zip(f64_err, errs)]
                f64_ulps = max(f64_ulps, ulps)
                if rel > 1e-5:
                    raise AssertionError(
                        f"hist_varbin vs the f64 sums ({what}): "
                        f"{rel:.3e} of its plane's total > 1e-5")
    log(f"kernel check hist: hist_varbin and hist_uniform equal their "
        f"fixed-point plain versions bitwise, on integer-valued stats and "
        f"on the bench's bernoulli stats, a second launch bitwise the "
        f"first, the packed layout expanded bitwise the uniform one, over "
        f"{len(cases)} cases: the {len(hv)} captured levels of a bench "
        f"tree (n = {n0}, the tree's scale) and L = 1, 8, 32 at n = {n0} "
        f"and a ragged n = {n0 - 17}; max|diff| from the f64 sums per "
        f"plane (g, h, w): " + ", ".join(f"{e:.3e}" for e in f64_err)
        + f", at most {f64_ulps:.4f} f32 spacings of the f64 sum")
    kdiff["split_records"] = check_records(sr, hist, "1M-row")
    kdiff["split_records"] = max(kdiff["split_records"],
                                 check_records_cases(hist, dev))
    return kdiff


def check_records(sr, hist, label):
    """``split_records`` against its plain version on captured levels: on
    the real H and on its integer-valued rounding, bitwise, and a second
    launch bitwise the first; raises on any difference.  Returns the
    largest max|kernel - plain| (0.0 while bitwise)."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    worst = 0.0
    for i, (H, nbins_, args) in enumerate(sr):
        for Hc, what in ((H, "real"), (H.round(), "integer-valued")):
            got = hist.split_records(Hc, nbins_, *args)
            again = hist.split_records(Hc, nbins_, *args)
            want = hist._split_records_torch(Hc, *args)
            torch.cuda.synchronize()
            worst = max(worst, max_diff(got, want))
            if not (same_bits(got, want) and same_bits(again, got)):
                a = got.view(torch.int32).long()
                b = want.view(torch.int32).long()
                ulp = int((a - b).abs().max())
                raise AssertionError(
                    f"split_records != plain (or a second launch) on {what}"
                    f" H at {label} level {i}: max {ulp} ulp")
    log(f"kernel check split_records: bitwise equal to its plain version "
        f"on the {len(sr)} captured {label} levels' H and on their "
        f"integer-valued rounding; a second launch bitwise the first")
    return worst


def check_records_cases(hist, dev):
    """``split_records`` against its plain version on the card on the
    edge cases of its block argmax: NaN planes (a non-finite stat), every
    gain -inf (min_rows out of reach), ties of two bins in one thread
    (bins 3 and 259), in one warp (3 and 35, 3 and 20) and across warps
    (10 and 245), and nbins = 2, 31, 32, 33, 256; bitwise (NaN bits
    included), a second launch bitwise the first, the tie won by its first
    bin.  Returns the largest max|kernel - plain|."""
    import torch
    from h2o3_tpu_torch.testing import same_bits, tie_hist
    rng = np.random.default_rng(13)
    prm = (1.0, 1.0, 0.0, 0.0, 1.0)
    cases = []
    for nbins in (2, 31, 32, 33, 256):
        B = nbins + 1
        H = np.stack([rng.normal(size=(7, 8, B)) * 3,
                      rng.random((7, 8, B)) * 5,
                      rng.integers(0, 40, (7, 8, B))]).astype(np.float32)
        cases.append((f"nbins={nbins}", H, nbins, prm, None))
    H256 = cases[-1][1]
    for p, name in enumerate("ghw"):
        H = H256.copy()
        H[p] = np.nan
        cases.append((f"NaN {name} plane", H, 256, prm, None))
    cases.append(("every gain -inf", H256, 256, (1.0, 1e9, 0.0, 0.0, 1.0),
                  0))
    for a, b in ((3, 259), (3, 35), (3, 20), (10, 245)):
        cases.append((f"tie of bins {a} and {b}", tie_hist(a, b, 3, 5),
                      a + b + 2, prm, a))
    worst = 0.0
    for what, Hn, nbins, args, want_bin in cases:
        H = torch.from_numpy(Hn).to(dev)
        got = hist.split_records(H, nbins, *args)
        again = hist.split_records(H, nbins, *args)
        want = hist._split_records_torch(H, *args)
        torch.cuda.synchronize()
        worst = max(worst, max_diff(got, want))
        if not (same_bits(got, want) and same_bits(again, got)):
            raise AssertionError(f"split_records != plain (or a second "
                                 f"launch) bitwise on {what}: max|diff| "
                                 f"{max_diff(got, want):.3e}")
        if want_bin is not None and not bool((got[..., 1] == want_bin)
                                             .all()):
            raise AssertionError(f"split_records on {what}: bin "
                                 f"{got[..., 1].unique().tolist()}, "
                                 f"expected {want_bin}")
    log("kernel check split_records cases: bitwise equal to its plain "
        "version (NaN bits included), a second launch bitwise the first, "
        "on " + "; ".join(c[0] for c in cases))
    return worst


def work_hist(g, leaf, L, Q, F):
    """Bytes and f32 adds one level's histogram needs: every leaf id, the
    codes and stats of the rows in [0, L), the packed output once."""
    valid = int(((leaf >= 0) & (leaf < L)).sum())
    nbytes = 4 * leaf.numel() + valid * (F * g.element_size() + 12) \
        + Q * 3 * L * 4
    return nbytes, 3 * F * valid


def work_records(LF, B):
    """Bytes and f32 operations of one records launch, counted from
    csrc/split_records.cu: 3 adds per regular bin for the totals, 53 per
    candidate bin (prefix sums, right sides, two gains, max)."""
    nbins = B - 1
    return 3 * LF * B * 4 + LF * 12 * 4, LF * (3 * nbins + 53 * (nbins - 1))


def bound(nbytes, ops):
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / F32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def time_train_kernels(hv, sr, hist, label):
    """Phase 9: device time of each level's launch of the training
    kernels, their plain versions and the one-call index_add_ yardstick;
    returns per-tree sums."""
    import torch
    rows = []
    tot = {"hist": [0.0, 0.0, 0.0, 0.0, 0, 0], "hist_uniform":
           [0.0, 0.0, 0.0, 0.0, 0, 0], "split_records":
           [0.0, 0.0, 0.0, 0.0, 0, 0]}
    for i, (g, leaf, st, L, bc, B, sc) in enumerate(hv):
        layout = hist.packed_layout(bc, B)
        F = g.shape[0]
        raw = raw_codes(g, bc, B - 1, hist)
        ms = cuda_ms(lambda: hist.hist_varbin(g, leaf, st, L, bc, B, sc))
        plain = cuda_ms(lambda: hist.hist_varbin_torch(g, leaf, st, L,
                                                       layout, sc),
                        reps=YARDSTICK_REPS)
        ums = cuda_ms(lambda: hist.hist_uniform(raw, leaf, st, L, B,
                                                scale=sc))
        uplain = cuda_ms(lambda: hist.hist_uniform_torch(
            raw, leaf, st, L, B, scale=sc), reps=YARDSTICK_REPS)
        # the yardstick: the one int64 index_add_ that computes the same
        # fixed-point sums, its index and quantised source prepared
        # outside the timed call
        qs = hist.quantize(st, sc)
        q = g.long()
        lf = leaf.long()
        ok = ((lf >= 0) & (lf < L))[None, :].expand_as(q)
        idx = (q * L + lf[None, :])[ok]
        src = qs.t()[None].expand(F, -1, 3)[ok]
        out = torch.zeros((layout.Q * L, 3), dtype=torch.int64,
                          device=g.device)
        lib = cuda_ms(lambda: out.index_add_(0, idx, src), YARDSTICK_REPS)
        uidx = ((lf[None, :] * F + torch.arange(F, device=g.device)[:, None])
                * B + raw.long())[ok]
        uout = torch.zeros((3, L * F * B), dtype=torch.int64,
                           device=g.device)
        usrc = qs[:, None, :].expand(3, F, -1)[:, ok]
        ulib = cuda_ms(lambda: uout.index_add_(1, uidx, usrc),
                       YARDSTICK_REPS)
        nbytes, ops = work_hist(g, leaf, L, layout.Q, F)
        bnd, _ = bound(nbytes, ops)
        ubnd, _ = bound(nbytes - layout.Q * 3 * L * 4 + F * B * 3 * L * 4,
                        ops)
        H, nbins, args = sr[i]
        LF, Bh = H.shape[1] * H.shape[2], H.shape[3]
        rms = cuda_ms(lambda: hist.split_records(H, nbins, *args))
        rplain = cuda_ms(lambda: hist._split_records_torch(H, *args),
                         reps=10)
        rb, rops = work_records(LF, Bh)
        rbnd, _ = bound(rb, rops)
        for k, v in (("hist", (ms, plain, bnd, lib, nbytes, ops)),
                     ("hist_uniform", (ums, uplain, ubnd, ulib, 0, ops)),
                     ("split_records", (rms, rplain, rbnd, 0.0, rb, rops))):
            for j in range(6):
                tot[k][j] += v[j]
        log(f"train times {label} level {i} (L={L}, n={g.shape[1]}, "
            f"valid rows {ops // (3 * F)}): hist_varbin {ms:.4f} ms "
            f"(plain {plain:.4f}, index_add_ {lib:.4f}, bound {bnd:.5f}); "
            f"hist_uniform {ums:.4f} ms (plain {uplain:.4f}, index_add_ "
            f"{ulib:.4f}, bound {ubnd:.5f}); split_records {rms:.4f} ms "
            f"(plain {rplain:.4f}, bound {rbnd:.6f}, LF={LF})")
    return tot


def train_phase(cols, types, domains, kernels, XGBoost, Frame, batcher,
                hist, card):
    """Phase 8: the training main path, counted, against the plain route,
    then published into the serving plane."""
    import torch
    n = len(cols["year"])
    fr = Frame.from_numpy(cols, types=types, domains=domains)
    ntrees = 20
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = XGBoost(ntrees=ntrees, **BENCH_CFG).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    st = m.output["stacked"]
    levels = st.depth
    if m.output["hist_kernel"] != "varbin":
        raise AssertionError("the bench frame did not take the varbin "
                             "histogram")
    for name in ("hist", "split_records"):
        if launches[name] != ntrees * levels:
            raise AssertionError(
                f"{name} launched {launches[name]} times on the train; "
                f"expected trees x levels = {ntrees} x {levels}")
    if launches["split_records (per-row)"] != 0:
        raise AssertionError("a single train took the per-row records")
    if {k: launches[k] for k in NO_SLOT} != NO_SLOT:
        raise AssertionError(f"a depth-6 train launched {launches}: the "
                             f"node-sparse kernels")
    log(f"train: XGBoost(max_depth=6, nbins=256, ntrees={ntrees}) on "
        f"{n} rows in {train_s:.3f} s {card}; launches {launches} = "
        f"{ntrees} trees x {levels} levels for hist and split_records")

    plain_from = {k.name: k.launches for k in kernels}
    mp = train_plain(fr, XGBoost, hist, ntrees)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route train launched a kernel")
    a, b = m.output["trees"][0], mp.output["trees"][0]
    for d in range(levels):
        for name in ("feat", "na_left", "valid", "thr"):
            if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                raise AssertionError(
                    f"kernel and plain-route trains differ on {name} at "
                    f"level {d} of the first tree")
    p_k = m.predict(fr).vec("YES").to_numpy()
    p_p = mp.predict(fr).vec("YES").to_numpy()
    if not (np.isfinite(p_k).all() and p_k.shape == (n,)):
        raise AssertionError("kernel-route predictions are not finite")
    pred_rel = float(np.max(np.abs(p_k - p_p) / np.abs(p_p)))
    if not np.allclose(p_k, p_p, rtol=1e-4, atol=0.0):
        raise AssertionError(f"predictions differ from the plain route: "
                             f"max rel {pred_rel:.3e} > 1e-4")
    auc_k, auc_p = m.training_metrics.auc, mp.training_metrics.auc
    if abs(auc_k - auc_p) > 1e-4:
        raise AssertionError(f"training AUC {auc_k} vs plain {auc_p}")
    same_trees = 0
    for tk, tp in zip(m.output["trees"], mp.output["trees"]):
        same_trees += all(torch.equal(getattr(tk, nm)[d], getattr(tp, nm)[d])
                          for nm in ("feat", "thr", "na_left", "valid")
                          for d in range(levels))
    log(f"train vs plain route on the card: first tree's splits equal at "
        f"all {levels} levels; {same_trees}/{ntrees} trees with equal "
        f"splits; predictions max rel diff {pred_rel:.3e}; training AUC "
        f"{auc_k:.6f} vs {auc_p:.6f}; logloss "
        f"{m.training_metrics.logloss:.6f} vs "
        f"{mp.training_metrics.logloss:.6f}")

    m2 = XGBoost(ntrees=ntrees, **BENCH_CFG).train(fr)
    check_deterministic(m, m2, "exact")

    publish_check("trained-xgboost", m, fr, cols, batcher)
    return fr, launches, ntrees, auc_k


def check_deterministic(m, m2, search):
    """A second kernel train must give bitwise the first one's trees
    (feature, threshold, NA direction, valid at every level of every
    class) and leaf values: the histograms sum in int64 fixed point, so
    nothing on the path depends on the order of the atomics."""
    why = stacks_differ(m, m2)
    if why:
        raise AssertionError(f"{search} search: a second kernel train "
                             f"differs on {why}")
    a = as_stacks(m)
    log(f"determinism {search}: a second kernel train gave bitwise "
        f"identical trees and leaf values ({len(a)} x {a[0].ntrees} trees "
        f"x {a[0].depth} levels)")


def as_stacks(m):
    """A model's per-class ``StackedTrees`` (one for a single class)."""
    st = m.output["stacked"]
    return st if isinstance(st, list) else [st]


def stacks_differ(m, m2):
    """None when two models hold bitwise the same trees (feature,
    threshold, NA direction, valid at every level of every class) and
    leaf values; else what differs first."""
    for k, (a, b) in enumerate(zip(as_stacks(m), as_stacks(m2))):
        why = stack_differs(a, b)
        if why:
            return f"{why} of class {k}"
    return None


def stack_differs(a, b):
    """None when two ``StackedTrees`` hold bitwise the same trees and leaf
    values; else what differs first."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    if (a.ntrees, a.depth) != (b.ntrees, b.depth):
        return f"{a.ntrees} x {a.depth} trees against {b.ntrees} x {b.depth}"
    for d, (lv1, lv2) in enumerate(zip(a.levels, b.levels)):
        for nm, x, y in zip(("feat", "thr", "na_left", "valid"), lv1, lv2):
            same = same_bits(x, y) if x.is_floating_point() \
                else torch.equal(x, y)
            if not same:
                return f"{nm} at level {d}"
    if not same_bits(a.values, b.values):
        return "the leaf values"
    return None


def publish_check(name, m, fr, cols, batcher):
    """Publish ``m`` into the serving plane; 256 rows answered by
    ``predict_rows`` must equal ``m.predict``: every class's probability
    and the labels."""
    rows = []
    for i in range(256):
        r = {}
        for k, v in cols.items():
            if k in ("carrier", "origin", "dest"):
                r[k] = str(int(v[i]))
            elif k not in ("dep_delayed_15min", "delay_class"):
                r[k] = float(v[i])
        rows.append(r)
    try:
        ent = batcher.publish(name, m)
        ans = ent.predict_rows(rows)
    finally:
        batcher.shutdown_all()
    dom = [str(d) for d in m.datainfo.response_domain]
    pred = m.predict(fr)
    probs = np.stack([pred.vec(c).to_numpy()[:256] for c in dom], axis=1)
    if not np.allclose(ans["probabilities"], probs, rtol=1e-5, atol=1e-7):
        raise AssertionError(f"published model {name}'s answers differ "
                             "from m.predict")
    labels = pred.vec("predict").to_numpy()[:256]
    if not (ans["predict"] == np.asarray(dom, dtype=object)[labels]).all():
        raise AssertionError(f"published model {name}'s labels differ")
    log(f"publish: the trained model {name}, published through "
        f"to_archive, answered 256 rows equal to m.predict ({len(dom)} "
        f"classes, rtol 1e-5)")


def host_op_us(n: int = 4000) -> float:
    """Wall microseconds per small torch op on the card when the host
    alone sets the pace: ``n`` in-place adds on one element, synchronized
    once.  The host's launch cost in this process, read beside a
    headline whose device sits idle between launches."""
    import torch
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def device_profile(train):
    """One profiled ``train()``: its device kernels (``key_averages``
    entries with device time, the largest first) and their busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0]
    kern.sort(key=lambda e: -e.self_device_time_total)
    return kern, sum(e.self_device_time_total for e in kern) / 1e3


def idle_share(busy_ms, wall_s):
    """1 - device busy / wall over the same train: the busy time from a
    profiled train, the wall from the unprofiled train of the same size
    (the profiler slows the host), so work done once per train falls in
    both.  Not clamped: a negative share says the two trains differed."""
    return 1 - busy_ms / (wall_s * 1e3) if busy_ms > 0 else float("nan")


def headline(XGBoost, fr, card, search, tag=""):
    """Phase 13: the bench protocol at 10M rows with ``split_search =
    search``, and a profile of a train of the same size; ``tag`` names
    another version's package."""
    import torch
    n = fr.nrows
    who = search + tag
    probe_us = host_op_us()
    cfg = dict(BENCH_CFG, split_search=search)
    t0 = time.perf_counter()
    XGBoost(ntrees=20, **cfg).train(fr)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    ntrees = 50
    t0 = time.perf_counter()
    m = XGBoost(ntrees=ntrees, **cfg).train(fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"headline {who}: bench_trees protocol, {n} rows, "
        f"XGBoost(max_depth=6, nbins=256, split_search={search!r}): "
        f"20-tree warmup {warm:.3f} s, then {ntrees} trees in {dt:.3f} s = "
        f"{ntrees / dt:.3f} trees/s; training AUC "
        f"{m.training_metrics.auc:.6f} {card}")
    kern, busy = device_profile(lambda: XGBoost(ntrees=ntrees, **cfg)
                                .train(fr))
    if busy <= 0:
        log(f"profile {who}: no device time in the trace: not "
            "measured")
    else:
        wall_tree = dt / ntrees * 1e3
        per_tree = sum(e.count for e in kern) / ntrees
        probe_after = host_op_us()
        log(f"host {who}: {per_tree:g} device operations per tree; a "
            f"small torch op costs the host {probe_us:.2f} us before the "
            f"headline and {probe_after:.2f} us after it, so the launches "
            f"alone hold a tree for {per_tree * probe_us / 1e3:.2f}-"
            f"{per_tree * probe_after / 1e3:.2f} ms of its "
            f"{wall_tree:.2f} ms of wall")
        log(f"profile {who} of a {ntrees}-tree train at {n} rows: "
            f"device busy {busy / ntrees:.2f} ms per tree against "
            f"{wall_tree:.2f} ms of wall per tree of the unprofiled "
            f"{ntrees}-tree train: idle share {idle_share(busy, dt):.3f}; "
            f"device ms per tree by kernel (launches per tree): "
            + "; ".join(
                f"{e.key[:110]} {e.self_device_time_total / 1e3 / ntrees:.3f}"
                f" ({e.count / ntrees:g})" for e in kern[:14]))
    return ntrees / dt

# ------------------------------------------------- the hierarchical search

HIER = dict(split_search="hier")


def capture_hier_levels(fr, XGBoost, hist):
    """Train one hierarchical-search tree with ``fine_hist`` and
    ``hist_uniform`` watched: the inputs each level gave them (the fine
    histogram's raw codes, leaf, stats, sel, W, nbins; the coarse pass's
    super-bin codes, parent ids, stats, L, B; each with the tree's
    fixed-point scale)."""
    fh, hu = [], []
    real_fh, real_hu = hist.fine_hist, hist.hist_uniform

    def spy_fh(codes, leaf, stats, sel, W, nbins, scale=None):
        fh.append((codes, leaf, stats, sel.clone(), W, nbins, scale))
        return real_fh(codes, leaf, stats, sel, W, nbins, scale)

    def spy_hu(codes, leaf, stats, L, B, planes=3, scale=None,
               row_start=None):
        hu.append((codes, leaf, stats, L, B, scale))
        return real_hu(codes, leaf, stats, L, B, planes, scale,
                       row_start=row_start)

    hist.fine_hist, hist.hist_uniform = spy_fh, spy_hu
    try:
        XGBoost(ntrees=1, **BENCH_CFG, **HIER).train(fr)
    finally:
        hist.fine_hist, hist.hist_uniform = real_fh, real_hu
    return fh, hu


def check_hier_kernels(fh, hu, hist, dev):
    """Phase 10: ``fine_hist`` and the coarse pass's ``hist_uniform``
    (with 3 planes, as the hier path launches it, and with 4) against
    their plain versions on the card: bitwise on integer-valued and on
    the real stats, a second launch bitwise the first, each plane's
    distance from this script's f64 sums logged; raises on any
    difference.  Returns the largest max|kernel - plain| measured for
    ``fine_hist`` and for the coarse pass with 3 planes (0.0 while they
    agree bitwise)."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    kdiff = {"fine_hist": 0.0, "coarse hist": 0.0}
    codes, leaf_d, st, sel_d, W, nbins, _ = fh[-1]
    n0 = codes.shape[1]
    cases = [(c, lf, s, sel, w, nb, sc, f"level {i}")
             for i, (c, lf, s, sel, w, nb, sc) in enumerate(fh)]
    rag = n0 - 17                      # a ragged row count
    cases.append((codes[:, :rag], leaf_d[:rag], st[:, :rag], sel_d, W,
                  nbins, None, f"level {len(fh) - 1} n={rag}"))
    minus = torch.rand(n0, generator=gen, device=dev) < 0.1
    cases.append((codes, torch.where(minus, -1, leaf_d), st, sel_d, W,
                  nbins, None, "leaf -1 on a tenth of the rows"))
    # nbins = 61 (S = 8, W = 8): the NA code 61 is slot 5 of super-bin 7,
    # which every (leaf, feature) selects as its first super-bin
    nb61 = 61
    S61, W61 = hist.superbin_geometry(nb61)
    c61 = torch.randint(0, nb61 + 1, (8, n0), generator=gen, device=dev,
                        dtype=torch.int32)
    l61 = torch.randint(-1, 4, (n0,), generator=gen, device=dev,
                        dtype=torch.int32)
    s61 = torch.randint(0, S61, (4, 8, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    s61[:, :, 0] = S61 - 1
    cases.append((c61, l61, st, s61, W61, nb61, None, "NA alias nbins=61"))
    fine_err, fine_ulps = [0.0, 0.0, 0.0], 0.0
    for c, lf, s, sel, w, nb, sc, what in cases:
        n = c.shape[1]
        for stats, scale, kind in ((int_stats(n, gen, dev), None,
                                    "integer"), (s.contiguous(), sc, "real")):
            got = hist.fine_hist(c, lf, stats, sel, w, nb, scale)
            again = hist.fine_hist(c, lf, stats, sel, w, nb, scale)
            ref = hist.fine_hist_torch(c, lf, stats, sel, w, nb, scale)
            torch.cuda.synchronize()
            kdiff["fine_hist"] = max(kdiff["fine_hist"], max_diff(got, ref))
            if nb == nb61 and bool((got[:, :, :, 0, 5] != 0).any()):
                raise AssertionError("fine_hist landed the NA code in the "
                                     "slot it aliases")
            for name, a, b in (("fine_hist", got, ref),
                               ("fine_hist, a second launch", again, got)):
                if not same_bits(a, b):
                    raise AssertionError(
                        f"{name} != plain on {kind} stats ({what}): "
                        f"max|diff| {max_diff(a, b):.3e}")
            if kind == "real":
                errs, rel, ulps = plane_err(
                    got, f64_fine(c, lf, stats, sel, w, nb), dense_plane)
                fine_err = [max(x, y) for x, y in zip(fine_err, errs)]
                fine_ulps = max(fine_ulps, ulps)
                if rel > 1e-5:
                    raise AssertionError(
                        f"fine_hist vs the f64 sums ({what}): {rel:.3e} of "
                        f"its plane's total > 1e-5")
    log(f"kernel check fine_hist: equal to its fixed-point plain version "
        f"bitwise on integer-valued stats and on the bench's bernoulli "
        f"stats, a second launch bitwise the first, over {len(cases)} "
        f"cases: the {len(fh)} captured levels of a hier bench tree (n = "
        f"{n0}, W = {W}, K = {sel_d.shape[-1]}, the tree's scale), a "
        f"ragged n = {rag}, leaf -1 rows and the nbins = 61 NA-alias "
        f"geometry; max|diff| from the f64 sums per plane (g, h, w): "
        + ", ".join(f"{e:.3e}" for e in fine_err)
        + f", at most {fine_ulps:.4f} f32 spacings of the f64 sum")
    # the hier path's own coarse launches (planes = 3: B = S+1, parent ids
    # with the right children's rows at leaf -1), and the |g| plane
    for planes in (3, 4):
        p_err, p_ulps = [0.0] * planes, 0.0
        for i, (c, lf, s, L, B, sc) in enumerate(hu):
            n = c.shape[1]
            for stats, scale, kind in ((int_stats(n, gen, dev), None,
                                        "integer"),
                                       (s.contiguous(), sc, "real")):
                got = hist.hist_uniform(c, lf, stats, L, B, planes, scale)
                again = hist.hist_uniform(c, lf, stats, L, B, planes, scale)
                ref = hist.hist_uniform_torch(c, lf, stats, L, B, planes,
                                              scale)
                torch.cuda.synchronize()
                if planes == 3:
                    kdiff["coarse hist"] = max(kdiff["coarse hist"],
                                               max_diff(got, ref))
                for name, a, b in (("", got, ref),
                                   (", a second launch", again, got)):
                    if not same_bits(a, b):
                        raise AssertionError(
                            f"hist_uniform(planes={planes}){name} != plain "
                            f"on {kind} stats (coarse level {i}): max|diff|"
                            f" {max_diff(a, b):.3e}")
                if kind == "real":
                    errs, rel, ulps = plane_err(
                        got, f64_uniform(c, lf, stats, L, B, planes),
                        dense_plane, planes)
                    p_err = [max(x, y) for x, y in zip(p_err, errs)]
                    p_ulps = max(p_ulps, ulps)
                    if rel > 1e-5:
                        raise AssertionError(
                            f"hist_uniform(planes={planes}) vs the f64 sums"
                            f" (coarse level {i}): {rel:.3e} of its "
                            f"plane's total > 1e-5")
        log(f"kernel check hist_uniform(planes={planes}): equal to its "
            f"fixed-point plain version bitwise on integer-valued and on "
            f"the real stats, a second launch bitwise the first, on the "
            f"{len(hu)} captured coarse levels of the hier path (B = "
            f"{hu[0][4]}, L = {[h[3] for h in hu]}, the tree's scale); "
            f"max|diff| from the f64 sums per plane: "
            + ", ".join(f"{e:.3e}" for e in p_err)
            + f", at most {p_ulps:.4f} f32 spacings of the f64 sum")
    return kdiff


def split_agreement(ta, tb, codes, edges, nbins, hist):
    """Hold tree ``tb`` against ``ta`` level by level: the same valid
    flags, and where a node is valid the same feature and NA direction;
    each level's partition of the rows the same, so a threshold may
    differ only where both trees' bins send every row alike (no row of
    the node has a code between them).  A dead node's stored split is
    arbitrary (the JAX package's split crosscheck skips it too).  Returns
    (the number of such tied nodes, None) or (None, the first
    difference)."""
    import torch
    leaf = torch.zeros(codes.shape[1], dtype=torch.int32,
                       device=codes.device)
    ties = 0
    for d in range(len(ta.feat)):
        valid = ta.valid[d]
        if not torch.equal(valid, tb.valid[d]):
            return None, f"valid at level {d}"
        for nm in ("feat", "na_left"):
            a, b = getattr(ta, nm)[d], getattr(tb, nm)[d]
            if not torch.equal(a[valid], b[valid]):
                return None, (f"{nm} at level {d}: {a.tolist()} vs "
                              f"{b.tolist()} (valid {valid.tolist()})")
        feat, nal = ta.feat[d], ta.na_left[d]
        rows = edges[feat.long()]                          # [L, nbins]
        bins = [(rows == t.thr[d][:, None]).int().argmax(1).to(torch.int32)
                for t in (ta, tb)]
        la, lb = (hist.partition(codes, leaf, feat, b, nal, valid, nbins)
                  for b in bins)
        if not torch.equal(la, lb):
            return None, (f"routing at level {d}: bins {bins[0].tolist()} "
                          f"vs {bins[1].tolist()}")
        ties += int((ta.thr[d] != tb.thr[d])[valid].sum())
        leaf = la
    return ties, None


def train_hier_phase(fr, cols, kernels, XGBoost, batcher, hist, codes,
                     exact_auc, card):
    """Phase 11: the hierarchical search's training path, counted, against
    the plain route, then published."""
    import torch
    from h2o3_tpu_torch.models.tree import binning
    n = len(cols["year"])
    ntrees = 20
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = XGBoost(ntrees=ntrees, **BENCH_CFG, **HIER).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    levels = m.output["stacked"].depth
    if m.output["split_search"] != "hier":
        raise AssertionError("the train did not take the hierarchical "
                             "search")
    want = {"hist": ntrees * levels, "fine_hist": ntrees * levels,
            "split_records": 0, "split_records (per-row)": 0, **NO_SLOT}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"hier train launches {launches}; expected "
                             f"{want}")
    log(f"hier train: XGBoost(max_depth=6, nbins=256, ntrees={ntrees}, "
        f"split_search='hier') on {n} rows in {train_s:.3f} s {card}; "
        f"launches {launches} = {ntrees} trees x {levels} levels for "
        f"fine_hist and the coarse hist, none for split_records")

    plain_from = {k.name: k.launches for k in kernels}
    mp = train_plain(fr, XGBoost, hist, ntrees, **HIER)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route hier train launched a kernel")
    nbins = BENCH_CFG["nbins"]
    edges = torch.from_numpy(binning.edges_matrix(m.output["edges"],
                                                  nbins)).to(codes.device)
    agree = [split_agreement(tp, tk, codes, edges, nbins, hist)
             for tk, tp in zip(m.output["trees"], mp.output["trees"])]
    if agree[0][0] is None:
        raise AssertionError(f"kernel and plain-route hier trains differ "
                             f"on the first tree: {agree[0][1]}")
    same = sum(a is not None for a, _ in agree)
    bitwise = sum(a == 0 for a, _ in agree)
    first_diff = next((f"tree {t}: {why}" for t, (_, why) in
                       enumerate(agree) if why), "none")
    p_k = m.predict(fr).vec("YES").to_numpy()
    p_p = mp.predict(fr).vec("YES").to_numpy()
    if not (np.isfinite(p_k).all() and p_k.shape == (n,)):
        raise AssertionError("hier kernel-route predictions are not finite")
    pred_rel = float(np.max(np.abs(p_k - p_p) / np.abs(p_p)))
    if not np.allclose(p_k, p_p, rtol=1e-4, atol=0.0):
        raise AssertionError(f"hier predictions differ from the plain "
                             f"route: max rel {pred_rel:.3e} > 1e-4")
    auc_k, auc_p = m.training_metrics.auc, mp.training_metrics.auc
    if abs(auc_k - auc_p) > 1e-4:
        raise AssertionError(f"hier training AUC {auc_k} vs plain {auc_p}")
    if abs(auc_k - exact_auc) > 0.01:
        raise AssertionError(f"hier training AUC {auc_k} vs the exact "
                             f"search's {exact_auc}: more than 0.01 apart")
    log(f"hier train vs plain route on the card: the first tree's splits "
        f"agree at all {levels} levels ({agree[0][0]} thresholds differ "
        f"across a structural tie); {same}/{ntrees} trees agree "
        f"({bitwise} with every threshold bitwise; first difference: "
        f"{first_diff}); predictions max rel "
        f"diff {pred_rel:.3e}; training AUC {auc_k:.6f} vs {auc_p:.6f} "
        f"(exact search {exact_auc:.6f}); logloss "
        f"{m.training_metrics.logloss:.6f} vs "
        f"{mp.training_metrics.logloss:.6f}")
    publish_check("trained-xgboost-hier", m, fr, cols, batcher)

    m2 = XGBoost(ntrees=ntrees, **BENCH_CFG, **HIER).train(fr)
    check_deterministic(m, m2, "hier")
    return launches, ntrees


def work_fine(c, leaf, sel, W, nbins, hist):
    """Bytes and f32 adds one fine-histogram launch needs: every leaf id,
    the codes and stats of the rows whose leaf is in range, sel, the
    output once; 3 adds per (row, feature, k) slot that lands."""
    L, F, K = sel.shape
    valid = int(((leaf >= 0) & (leaf < L)).sum())
    _, ok = hist.fine_slots(c, leaf, sel, W, nbins)
    nbytes = 4 * leaf.numel() + valid * (F * c.element_size() + 12) \
        + sel.numel() * 4 + 3 * L * F * K * W * 4
    return nbytes, 3 * int(ok.sum())


def time_hier_kernels(fh, hu, hist, label):
    """Phase 12 (and 13 at 10M rows): device time of each level's
    fine_hist launch, its plain version, the one-call int64 index_add_ on
    its precomputed slots and quantised stats, its bound; and of the
    coarse hist_uniform launches.  Returns per-tree sums [ms, plain,
    bound, index_add_, bytes, ops] for each."""
    import torch
    tot = {"fine_hist": [0.0, 0.0, 0.0, 0.0, 0, 0],
           "coarse hist": [0.0, 0.0, 0.0, 0.0, 0, 0]}
    for i, ((c, leaf, st, sel, W, nbins, sc), (cc, pl, cst, L, B, csc)) in \
            enumerate(zip(fh, hu)):
        Lf, F, K = sel.shape
        ms = cuda_ms(lambda: hist.fine_hist(c, leaf, st, sel, W, nbins, sc))
        plain = cuda_ms(lambda: hist.fine_hist_torch(c, leaf, st, sel, W,
                                                     nbins, sc),
                        reps=YARDSTICK_REPS)
        idx, ok = hist.fine_slots(c, leaf, sel, W, nbins)
        fidx = idx[ok]
        src = hist.quantize(st, sc)[:, None, None, :].expand(
            3, F, K, -1)[:, ok]
        out = torch.zeros((3, Lf * F * K * W), dtype=torch.int64,
                          device=c.device)
        lib = cuda_ms(lambda: out.index_add_(1, fidx, src), YARDSTICK_REPS)
        del idx, ok, src
        nbytes, ops = work_fine(c, leaf, sel, W, nbins, hist)
        bnd, _ = bound(nbytes, ops)
        cms = cuda_ms(lambda: hist.hist_uniform(cc, pl, cst, L, B,
                                                scale=csc))
        cplain = cuda_ms(lambda: hist.hist_uniform_torch(cc, pl, cst, L, B,
                                                         scale=csc),
                         reps=YARDSTICK_REPS)
        lf = pl.long()
        cok = ((lf >= 0) & (lf < L))[None, :].expand_as(cc)
        cidx = ((lf[None, :] * F + torch.arange(F, device=c.device)[:, None])
                * B + cc.long())[cok]
        cout = torch.zeros((3, L * F * B), dtype=torch.int64,
                           device=c.device)
        csrc = hist.quantize(cst, csc)[:, None, :].expand(3, F, -1)[:, cok]
        clib = cuda_ms(lambda: cout.index_add_(1, cidx, csrc),
                       YARDSTICK_REPS)
        cbytes, cops = work_hist(cc, pl, L, F * B, F)
        cbnd, _ = bound(cbytes, cops)
        for k, v in (("fine_hist", (ms, plain, bnd, lib, nbytes, ops)),
                     ("coarse hist", (cms, cplain, cbnd, clib, cbytes,
                                      cops))):
            for j in range(6):
                tot[k][j] += v[j]
        log(f"hier times {label} level {i} (L={Lf}, n={c.shape[1]}, "
            f"landing slots {ops // 3}): fine_hist {ms:.4f} ms (plain "
            f"{plain:.4f}, index_add_ {lib:.4f}, bound {bnd:.5f}); coarse "
            f"hist_uniform at B={B}, L={L} {cms:.4f} ms (plain "
            f"{cplain:.4f}, index_add_ {clib:.4f}, bound {cbnd:.5f})")
    return tot



# -------------------------------------------------------- multinomial

K_CLASSES = 3
MULTI_CFG = dict(response_column="delay_class",
                 ignored_columns=["dep_delayed_15min"], max_depth=6,
                 nbins=256, seed=1, score_tree_interval=10 ** 9)
MULTI_ROUNDS = 20
# the K loop's headline rounds: its ~13,000 device operations a round
# make a profile of 20 rounds minutes of the script's time
MULTI_LOOP_ROUNDS = 5


def multi_frame(n, Frame):
    """The bench frame at ``n`` rows with the 3-class ``delay_class``
    response (``h2o3_tpu_torch.testing.delay_class``); (cols, frame)."""
    from h2o3_tpu_torch.testing import delay_class
    cols, types, domains = make_airlines_like(n)
    cols["delay_class"] = delay_class(cols)
    return cols, Frame.from_numpy(cols, types=types, domains=domains)


def capture_multi_levels(fr, XGBoost, hist):
    """Train one multinomial round with the histogram and records wrappers
    watched: the inputs each level's K-batched ``hist_varbin`` launch had
    (codes shared at the root, each tree's compacted prefix below it;
    leaf [K, n], stats [K, 3, n], the trees' [K, 2, 3] scales) and each
    level's ``split_records`` (the K*L flattened leaves)."""
    hv, sr = [], []
    real_hv, real_sr = hist.hist_varbin, hist.split_records

    def spy_hv(gcodes, leaf, stats, L, bc, B, scale=None, row_start=None):
        if leaf.dim() == 2:
            hv.append((gcodes, leaf, stats, L, tuple(bc), B, scale))
        return real_hv(gcodes, leaf, stats, L, bc, B, scale,
                       row_start=row_start)

    def spy_sr(Hist, nbins, *args, **kw):
        sr.append((Hist.clone(), nbins, args))
        return real_sr(Hist, nbins, *args, **kw)

    hist.hist_varbin, hist.split_records = spy_hv, spy_sr
    try:
        XGBoost(ntrees=1, **MULTI_CFG).train(fr)
    finally:
        hist.hist_varbin, hist.split_records = real_hv, real_sr
    return hv, sr


def tree_codes(codes, k):
    """Tree k's codes of a batched call, contiguous."""
    return (codes[k] if codes.dim() == 3 else codes).contiguous()


def check_multi_kernels(hv, sr, hist, dev):
    """Phase 14: the K-batched histogram launch on the captured levels of
    a K = 3 round, on both layouts (the packed one the path launches, and
    the uniform one on the same rows' raw codes): bitwise its plain
    version, bitwise a second launch, and bitwise K launches of one tree
    each, on integer-valued and on the real softmax stats (each tree on
    its own scale); the records of the K*L flattened leaves bitwise their
    plain version.  Returns the largest max|kernel - plain|."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    worst = 0.0
    for i, (g, leaf, st, L, bc, B, scale) in enumerate(hv):
        K, _, n = st.shape
        layout = hist.packed_layout(bc, B)
        raw = raw_codes(g, bc, B - 1, hist)
        ints = torch.stack([int_stats(n, gen, dev) for _ in range(K)])
        for stats, sc, kind in ((ints, None, "integer"),
                                (st, scale, "real")):
            scs = hist.stat_scale(stats) if sc is None else sc
            pv = hist.hist_varbin(g, leaf, stats, L, bc, B, scs)
            pv2 = hist.hist_varbin(g, leaf, stats, L, bc, B, scs)
            pv_ref = hist.hist_varbin_torch(g, leaf, stats, L, layout, scs)
            pv_one = torch.stack([hist.hist_varbin(
                tree_codes(g, k), leaf[k], stats[k], L, bc, B, scs[k])
                for k in range(K)])
            pu = hist.hist_uniform(raw, leaf, stats, L, B, scale=scs)
            pu_ref = hist.hist_uniform_torch(raw, leaf, stats, L, B,
                                             scale=scs)
            pu_one = torch.stack([hist.hist_uniform(
                tree_codes(raw, k), leaf[k], stats[k], L, B, scale=scs[k])
                for k in range(K)])
            torch.cuda.synchronize()
            worst = max(worst, max_diff(pv, pv_ref), max_diff(pu, pu_ref))
            for name, a, b in (
                    ("hist_varbin (K-batched) vs plain", pv, pv_ref),
                    ("hist_varbin (K-batched), a second launch", pv2, pv),
                    ("hist_varbin (K-batched) vs K single launches", pv,
                     pv_one),
                    ("hist_uniform (K-batched) vs plain", pu, pu_ref),
                    ("hist_uniform (K-batched) vs K single launches", pu,
                     pu_one),
                    ("the packed layout expanded vs the uniform one",
                     hist.expand_varbin(pv, bc, L, B), pu)):
                if not same_bits(a, b):
                    raise AssertionError(
                        f"{name} on {kind} stats (level {i}): max|diff| "
                        f"{max_diff(a, b):.3e}")
    shapes = [(tuple(g.shape), tuple(leaf.shape)) for g, leaf, *_ in hv]
    log(f"kernel check hist (K-batched, K={K}): on the {len(hv)} captured "
        f"levels of a multinomial round (codes, leaf shapes {shapes}), "
        f"both layouts, integer-valued and softmax stats on each tree's "
        f"own scale: one launch bitwise its plain version, bitwise a "
        f"second launch and bitwise {K} launches of one tree each")
    return max(worst, check_records(sr, hist, f"K={K} 1M-row"))


def work_multi(g, leaf, L, Q, F):
    """Bytes and adds of one K-batched launch: every tree's leaf ids, the
    stats of its rows in [0, L) and its packed output; the codes of those
    rows once per tree where each tree has its own [K, F, n] prefix, and
    once in all where the trees share the root's [F, n] codes (stride 0),
    for the rows some tree reads."""
    ok = (leaf >= 0) & (leaf < L)
    valid = int(ok.sum())
    code_rows = valid if g.dim() == 3 else int(ok.any(0).sum())
    nbytes = 4 * leaf.numel() + 12 * valid \
        + code_rows * F * g.element_size() + leaf.shape[0] * Q * 3 * L * 4
    return nbytes, 3 * F * valid


def time_multi_kernels(hv, hist, label, card, turns_reps=30):
    """Device ms per round (the sum of its captured level launches) of
    the K-batched launch, in turns with the K launches of one tree each
    (batched, single, single, batched), its plain version, the one int64
    ``index_add_`` computing the same sums (k folded into the index) and
    its bound.  Returns [ms, plain, bound, index_add_, bytes, ops,
    single ms]."""
    import torch
    tot = [0.0, 0.0, 0.0, 0.0, 0, 0, 0.0]
    for i, (g, leaf, st, L, bc, B, sc) in enumerate(hv):
        K, _, n = st.shape
        layout = hist.packed_layout(bc, B)
        F = g.shape[-2]

        def batched():
            return hist.hist_varbin(g, leaf, st, L, bc, B, sc)
        ones = [(tree_codes(g, k), leaf[k], st[k], sc[k]) for k in range(K)]

        def single():
            return [hist.hist_varbin(c, lf, s, L, bc, B, sk)
                    for c, lf, s, sk in ones]
        b1 = cuda_ms(batched, turns_reps)
        s1 = cuda_ms(single, turns_reps)
        s2 = cuda_ms(single, turns_reps)
        b2 = cuda_ms(batched, turns_reps)
        ms, one = (b1 + b2) / 2, (s1 + s2) / 2
        plain = cuda_ms(lambda: hist.hist_varbin_torch(g, leaf, st, L,
                                                       layout, sc),
                        reps=YARDSTICK_REPS)
        qs = hist.quantize(st, sc)                             # [K, 3, n]
        q = g.long() if g.dim() == 3 else g.long()[None]
        lf = leaf.long()
        ok = ((lf >= 0) & (lf < L))[:, None, :].expand(K, F, n)
        kq = torch.arange(K, device=g.device)[:, None, None] * layout.Q + q
        idx = (kq * L + lf[:, None, :]).expand(K, F, n)[ok]
        src = qs.transpose(1, 2)[:, None].expand(K, F, n, 3)[ok]
        out = torch.zeros((K * layout.Q * L, 3), dtype=torch.int64,
                          device=g.device)
        lib = cuda_ms(lambda: out.index_add_(0, idx, src), YARDSTICK_REPS)
        del idx, src, kq, ok
        nbytes, ops = work_multi(g, leaf, L, layout.Q, F)
        bnd, _ = bound(nbytes, ops)
        for j, v in enumerate((ms, plain, bnd, lib, nbytes, ops, one)):
            tot[j] += v
        log(f"multinomial times {label} level {i} (K={K}, L={L}, n={n}) "
            f"{card}: K-batched hist_varbin {ms:.4f} ms in turns with "
            f"{K} single launches {one:.4f} ms (b {b1:.4f}, s {s1:.4f}, "
            f"s {s2:.4f}, b {b2:.4f}); plain {plain:.4f}, index_add_ "
            f"{lib:.4f}, bound {bnd:.5f}")
    log(f"multinomial times per round at {label} (sum of the {len(hv)} "
        f"level launches) {card}: K-batched hist {tot[0]:.4f} ms, {K} "
        f"single launches {tot[6]:.4f} ms; plain {tot[1]:.4f}, index_add_ "
        f"{tot[3]:.4f}, bound {tot[2]:.5f}")
    return tot


def multi_class_probs(m, fr):
    """``m.predict``'s class probabilities [n, K], in domain order."""
    dom = [str(d) for d in m.datainfo.response_domain]
    pred = m.predict(fr)
    return np.stack([pred.vec(c).to_numpy() for c in dom], axis=1)


def train_multi_phase(fr, cols, kernels, XGBoost, batcher, hist, card):
    """Phase 15: the multinomial training path (K = 3 class trees a
    round in one batched build), counted; bitwise its K loop
    (split_mode="separate"); against the plain route; a second train
    bitwise; published.  Returns the main path's launch counts."""
    import torch
    n = len(cols["year"])
    rounds = MULTI_ROUNDS
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = XGBoost(ntrees=rounds, **MULTI_CFG).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    st = as_stacks(m)
    levels = st[0].depth
    if len(st) != K_CLASSES or m.output["hist_kernel"] != "varbin":
        raise AssertionError(f"the multinomial train grew {len(st)} class "
                             f"stacks on the {m.output['hist_kernel']} "
                             f"layout; expected {K_CLASSES}, varbin")
    want = {"hist": rounds * levels, "split_records": rounds * levels,
            "fine_hist": 0, "split_records (per-row)": 0, **NO_SLOT}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"multinomial train launches {launches}; "
                             f"expected rounds x levels, whatever K: {want}")
    log(f"multinomial train: XGBoost(max_depth=6, nbins=256, ntrees="
        f"{rounds}) on {n} rows, response delay_class (K = {K_CLASSES}), "
        f"in {train_s:.3f} s {card}; launches {launches} = {rounds} rounds "
        f"x {levels} levels for hist and split_records, the launches of "
        f"the single-class train")

    for k in kernels:
        k.launches = 0
    ms = XGBoost(ntrees=rounds, split_mode="separate", **MULTI_CFG).train(fr)
    torch.cuda.synchronize()
    sep_launches = {k.name: k.launches for k in kernels}
    why = stacks_differ(m, ms)
    if why:
        raise AssertionError(f"the batched multinomial train and its K "
                             f"loop (split_mode='separate') differ on {why}")
    log(f"multinomial K loop (split_mode='separate', {K_CLASSES} single "
        f"builds a round, plain records): bitwise the batched train's "
        f"trees and leaf values; launches {sep_launches}")

    plain_from = {k.name: k.launches for k in kernels}
    mp = train_plain(fr, XGBoost, hist, rounds, cfg=MULTI_CFG)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route multinomial train launched a "
                             "kernel")
    for k, (a, b) in enumerate(zip(m.output["trees"][0],
                                   mp.output["trees"][0])):
        for d in range(levels):
            for name in ("feat", "na_left", "valid", "thr"):
                if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                    raise AssertionError(
                        f"kernel and plain-route multinomial trains differ "
                        f"on {name} at level {d} of class {k}'s first tree")
    p_k, p_p = multi_class_probs(m, fr), multi_class_probs(mp, fr)
    if not (np.isfinite(p_k).all() and p_k.shape == (n, K_CLASSES)
            and np.allclose(p_k.sum(axis=1), 1.0, atol=1e-5)):
        raise AssertionError("multinomial probabilities are not finite "
                             "rows summing to 1")
    pred_rel = float(np.max(np.abs(p_k - p_p) / np.abs(p_p)))
    if not np.allclose(p_k, p_p, rtol=1e-4, atol=0.0):
        raise AssertionError(f"multinomial probabilities differ from the "
                             f"plain route: max rel {pred_rel:.3e} > 1e-4")
    ll_k, ll_p = m.training_metrics.logloss, mp.training_metrics.logloss
    if abs(ll_k - ll_p) > 1e-4:
        raise AssertionError(f"multinomial training logloss {ll_k} vs plain "
                             f"{ll_p}")
    same = sum(stacks_differ_round(m, mp, t) is None for t in range(rounds))
    mt = m.training_metrics
    log(f"multinomial train vs plain route on the card: the first round's "
        f"{K_CLASSES} trees equal at all {levels} levels; {same}/{rounds} "
        f"rounds with equal splits; probabilities max rel diff "
        f"{pred_rel:.3e}; training logloss {ll_k:.6f} vs {ll_p:.6f}; mean "
        f"per-class error {mt.mean_per_class_error:.6f}, accuracy "
        f"{mt.accuracy:.6f}")

    m2 = XGBoost(ntrees=rounds, **MULTI_CFG).train(fr)
    check_deterministic(m, m2, "multinomial")
    publish_check("trained-xgboost-multinomial", m, fr, cols, batcher)
    return launches


def stacks_differ_round(m, m2, t):
    """None when round t's trees (its class trees, or its one tree) have
    the same splits in both."""
    import torch

    def trees(model):
        r = model.output["trees"][t]
        return r if isinstance(r, list) else [r]
    for a, b in zip(trees(m), trees(m2)):
        for name in ("feat", "na_left", "valid", "thr"):
            for x, y in zip(getattr(a, name), getattr(b, name)):
                if not torch.equal(x, y):
                    return name
    return None


def headline_multi(XGBoost, fr, card):
    """Phase 16: the multinomial train at 10M rows: a 20-round warmup,
    then rounds/s and trees/s (K x rounds/s) of a timed 20-round train,
    batched, and of a timed 5-round train with split_mode="separate" (the
    K loop), each with the device operations per round and idle share of
    a profiled train of the same size."""
    import torch
    n = fr.nrows
    out = {}
    t0 = time.perf_counter()
    XGBoost(ntrees=MULTI_ROUNDS, **MULTI_CFG).train(fr)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    for mode in ("fused", "separate"):
        rounds = MULTI_ROUNDS if mode == "fused" else MULTI_LOOP_ROUNDS
        cfg = dict(MULTI_CFG, split_mode=mode)
        probe_us = host_op_us()
        t0 = time.perf_counter()
        m = XGBoost(ntrees=rounds, **cfg).train(fr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rps = rounds / dt
        mt = m.training_metrics
        log(f"headline multinomial {mode}: {n} rows, XGBoost(max_depth=6, "
            f"nbins=256), delay_class (K = {K_CLASSES}): "
            + (f"{MULTI_ROUNDS}-round warmup {warm:.3f} s, then "
               if mode == "fused" else "")
            + f"{rounds} rounds in {dt:.3f} s = {rps:.3f} rounds/s = "
            f"{K_CLASSES * rps:.3f} trees/s; training logloss "
            f"{mt.logloss:.6f}, accuracy {mt.accuracy:.6f} {card}")
        kern, busy = device_profile(lambda: XGBoost(ntrees=rounds, **cfg)
                                    .train(fr))
        ops = sum(e.count for e in kern) / rounds
        idle = idle_share(busy, dt)
        if busy <= 0:
            log(f"profile multinomial {mode}: no device time in the trace: "
                "not measured")
        else:
            log(f"profile multinomial {mode} of a {rounds}-round train at "
                f"{n} rows: {ops:g} device operations per round (a small "
                f"torch op costs the host {probe_us:.2f} us); device busy "
                f"{busy / rounds:.2f} ms per round against "
                f"{dt / rounds * 1e3:.2f} ms of wall per round of the "
                f"unprofiled {rounds}-round train: idle share {idle:.3f}; "
                f"device ms per round by kernel (launches per round): "
                + "; ".join(f"{e.key[:110]} "
                            f"{e.self_device_time_total / 1e3 / rounds:.3f} "
                            f"({e.count / rounds:g})" for e in kern[:12]))
        out[mode] = (rps, ops, idle)
    return out


# --------------------------------------------------------------- grid

# the phase-18 cohort: G = 4 members of the bench XGBoost
GRID_HP = {"learn_rate": [0.05, 0.1], "reg_lambda": [0.0, 1.0]}
GRID_SAMPLED = {"sample_rate": [0.8, 1.0],
                "col_sample_rate_per_tree": [0.8, 1.0]}
GRID_ROUNDS = 20


def combos(hp):
    """The grid's combos in GridSearch's Cartesian order."""
    import itertools
    names = list(hp)
    return [dict(zip(names, v)) for v in itertools.product(*hp.values())]


def grid_search(GridSearch, XGBoost, hp, ntrees, **extra):
    """The bench XGBoost's batched grid over ``hp``."""
    return GridSearch(XGBoost, hp, grid_batch="on", ntrees=ntrees,
                      **dict(BENCH_CFG, **extra))


def by_combo(models, hp):
    """Grid models keyed by their hyperparameter values."""
    return {tuple(getattr(m.params, k) for k in hp): m for m in models}


def capture_grid_records(fr, GridSearch, XGBoost, hist):
    """Train one round of the phase-18 cohort with the records wrapper
    watched: each level's ``split_records`` inputs (H [3, G*L, F, B] of
    the G members' L leaves, member-major, and the per-leaf parameters
    lam, min_rows, alpha, gamma, mcw, each [G*L])."""
    sr = []
    real = hist.split_records

    def spy(Hist, nbins, *args, **kw):
        sr.append((Hist.clone(), nbins, args))
        return real(Hist, nbins, *args, **kw)

    hist.split_records = spy
    try:
        grid_search(GridSearch, XGBoost, GRID_HP, 1).train(fr)
    finally:
        hist.split_records = real
    return sr


def check_grid_records(sr, hist, dev):
    """Phase 17: the per-row records launch on the captured levels of a
    cohort round against its plain version with the same per-leaf
    tensors, bitwise (NaN bits included), a second launch bitwise the
    first; with every leaf given member 0's parameters, bitwise the scalar
    launch; and on a NaN g plane, with min_rows and min_child_weight that
    rule out every bin of one member only, and with one member retired
    (its histogram all zero).  Raises on any difference; returns the
    largest max|kernel - plain|."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    G = len(GRID_HP["learn_rate"]) * len(GRID_HP["reg_lambda"])
    worst = 0.0
    cases = 0

    def held(H, nbins, args, what):
        nonlocal worst, cases
        got = hist.split_records(H, nbins, *args)
        again = hist.split_records(H, nbins, *args)
        want = hist._split_records_torch(H, *args)
        torch.cuda.synchronize()
        worst = max(worst, max_diff(got, want))
        cases += 1
        if not (same_bits(got, want) and same_bits(again, got)):
            raise AssertionError(f"split_records (per-row) != plain (or a "
                                 f"second launch) on {what}: max|diff| "
                                 f"{max_diff(got, want):.3e}")
        return got

    for i, (H, nbins, args) in enumerate(sr):
        nl = H.shape[1]
        L = nl // G
        if not all(isinstance(a, torch.Tensor) and a.shape == (nl,)
                   for a in args):
            raise AssertionError(f"level {i}: the cohort's records did not "
                                 f"take per-leaf parameters")
        held(H, nbins, args, f"level {i}")
        held(H.round(), nbins, args, f"level {i}, integer-valued H")
        same = tuple(torch.full_like(a, float(a[0])) for a in args)
        a = hist.split_records(H, nbins, *same)
        b = hist.split_records(H, nbins, *(float(x[0]) for x in args))
        torch.cuda.synchronize()
        if not same_bits(a, b):
            raise AssertionError(f"level {i}: per-row launch with equal "
                                 f"leaves != the scalar launch")
        Hn = H.clone()
        Hn[0] = float("nan")
        held(Hn, nbins, args, f"level {i}, NaN g plane")
        ruled = [x.clone() for x in args]
        for j in (1, 4):                        # min_rows, mcw
            ruled[j][2 * L:3 * L] = 1e9
        got = held(H, nbins, ruled, f"level {i}, member 2 ruled out")
        if not (bool(torch.isneginf(got[2 * L:3 * L, :, 0]).all())
                and bool(torch.isfinite(got[:2 * L, :, 0]).any())):
            raise AssertionError(f"level {i}: min_rows/min_child_weight of "
                                 f"member 2 did not rule out its bins alone")
        Hz = H.clone()
        Hz[:, 3 * L:] = 0.0
        got = held(Hz, nbins, args, f"level {i}, member 3 retired")
        split = hist.finish_splits(got, args[1], 0.0)
        if bool(split[4][3 * L:].any()) or not bool(
                torch.isfinite(split[5][3 * L:]).all()):
            raise AssertionError(f"level {i}: the retired member split or "
                                 f"gave non-finite child sums")
    log(f"kernel check split_records (per-row): bitwise equal to its plain "
        f"version with the same per-leaf tensors (NaN bits included), a "
        f"second launch bitwise the first, over {cases} launches: the "
        f"{len(sr)} captured levels of a G = {G} cohort round (1M rows) on "
        f"the real and the integer-valued H, a NaN g plane, min_rows and "
        f"min_child_weight ruling out member 2 alone, member 3 retired "
        f"(all-zero histogram: no split, finite child sums); with every "
        f"leaf on member 0's parameters bitwise the scalar launch")
    return worst


def time_grid_records(sr, hist, label, card):
    """Device ms per cohort round (the sum of its captured level launches)
    of the per-row records launch, its plain version and its bound: H
    read once, 3 G L F B x 4 B, the parameter block G L x 32 B, the
    records written G L F x 12 x 4 B, over 3.35 TB/s, or its operations
    over 67 TFLOP/s.  Returns [ms, plain, bound, bytes, ops]."""
    tot = [0.0, 0.0, 0.0, 0, 0]
    for i, (H, nbins, args) in enumerate(sr):
        nl, F, B = H.shape[1], H.shape[2], H.shape[3]
        ms = cuda_ms(lambda: hist.split_records(H, nbins, *args))
        plain = cuda_ms(lambda: hist._split_records_torch(H, *args),
                        reps=10)
        nbytes = 3 * nl * F * B * 4 + nl * 32 + nl * F * 12 * 4
        ops = work_records(nl * F, B)[1]
        bnd, _ = bound(nbytes, ops)
        for j, v in enumerate((ms, plain, bnd, nbytes, ops)):
            tot[j] += v
        log(f"grid records {label} level {i} (G*L={nl}, F={F}, B={B}) "
            f"{card}: split_records (per-row) {ms:.4f} ms (plain "
            f"{plain:.4f}, bound {bnd:.6f})")
    log(f"grid records per round at {label} (sum of the {len(sr)} level "
        f"launches) {card}: split_records (per-row) {tot[0]:.4f} ms, plain "
        f"{tot[1]:.4f}, bound {tot[2]:.6f} ({bound(tot[3], tot[4])[1]})")
    return tot


class ScanWatch:
    """Wraps ``shared.make_grid_scan_fn`` while a block runs: each chunk's
    ``alive`` mask and its per-member trees, to see what the retired
    members grew."""

    def __init__(self, shared):
        self.shared = shared
        self.chunks = []

    def __enter__(self):
        real = self.real = self.shared.make_grid_scan_fn

        def make(*a, **kw):
            fn = real(*a, **kw)

            def scan(*args):
                F, per = fn(*args)
                self.chunks.append((list(args[15]), per))
                return F, per
            scan.build = fn.build
            return scan
        self.shared.make_grid_scan_fn = make
        return self

    def __exit__(self, *exc):
        self.shared.make_grid_scan_fn = self.real


def grid_train_phase(fr, cols, kernels, GridSearch, XGBoost, batcher, hist,
                     card):
    """Phase 18: the batched grid path (G = 4 members of the bench
    XGBoost, one level loop), counted; each member bitwise its sequential
    train; a second cohort bitwise; the plain route; a sampled cohort;
    successive halving; a member published.  Returns the main path's
    launch counts."""
    import torch
    from h2o3_tpu_torch.models.tree import shared
    R = GRID_ROUNDS
    G = len(combos(GRID_HP))
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    g = grid_search(GridSearch, XGBoost, GRID_HP, R).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    levels = as_stacks(g.models[0])[0].depth
    want = {"hist": R * levels, "split_records (per-row)": R * levels,
            "split_records": 0, "fine_hist": 0, **NO_SLOT}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"grid cohort launches {launches}; expected "
                             f"rounds x levels, whatever G: {want}")
    if sorted(m.output["grid_cohort"]["member"] for m in g.models) != \
            list(range(G)) or len(g.models) != G:
        raise AssertionError("the grid did not train one cohort of "
                             f"{G} members")
    log(f"grid train: GridSearch(XGBoost, {GRID_HP}, grid_batch='on'), "
        f"max_depth=6, nbins=256, ntrees={R}, on {fr.nrows} rows in "
        f"{train_s:.3f} s {card}; launches {launches} = {R} rounds x "
        f"{levels} levels for hist and the per-row split_records, none of "
        f"the scalar form")

    mg = by_combo(g.models, GRID_HP)
    seqs = {}
    for combo in combos(GRID_HP):
        key = tuple(combo.values())
        seqs[key] = XGBoost(ntrees=R, **BENCH_CFG, **combo).train(fr)
        why = stacks_differ(mg[key], seqs[key])
        if why:
            raise AssertionError(f"cohort member {combo} and its sequential "
                                 f"train differ on {why}")
        p_g = mg[key].predict(fr).vec("YES").to_numpy()
        p_s = seqs[key].predict(fr).vec("YES").to_numpy()
        if not np.array_equal(p_g, p_s):
            raise AssertionError(f"cohort member {combo}'s predictions "
                                 f"differ from its sequential train's")
    log(f"grid vs sequential on the card: each of the {G} members bitwise "
        f"its own sequential XGBoost train ({R} trees x {levels} levels, "
        f"leaf values and predictions)")

    g2 = grid_search(GridSearch, XGBoost, GRID_HP, R).train(fr)
    for key, m2 in by_combo(g2.models, GRID_HP).items():
        why = stacks_differ(mg[key], m2)
        if why:
            raise AssertionError(f"a second cohort train differs on {why} "
                                 f"(member {key})")
    log(f"determinism grid: a second cohort train gave bitwise identical "
        f"trees and leaf values ({G} members x {R} trees)")

    plain_from = {k.name: k.launches for k in kernels}
    with plain_route(hist):
        gp = grid_search(GridSearch, XGBoost, GRID_HP, R).train(fr)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route cohort launched a kernel")
    worst_rel, worst_auc = 0.0, 0.0
    for key, mp in by_combo(gp.models, GRID_HP).items():
        a, b = mg[key].output["trees"][0], mp.output["trees"][0]
        for d in range(levels):
            for name in ("feat", "na_left", "valid", "thr"):
                if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                    raise AssertionError(
                        f"kernel and plain-route cohorts differ on {name} at "
                        f"level {d} of member {key}'s first tree")
        auc_k, auc_p = mg[key].training_metrics.auc, mp.training_metrics.auc
        worst_auc = max(worst_auc, abs(auc_k - auc_p))
        if abs(auc_k - auc_p) > 1e-4:
            raise AssertionError(f"member {key}: training AUC {auc_k} vs "
                                 f"plain {auc_p}")
        p_k = mg[key].predict(fr).vec("YES").to_numpy()
        p_p = mp.predict(fr).vec("YES").to_numpy()
        if not (np.isfinite(p_k).all() and p_k.shape == (fr.nrows,)):
            raise AssertionError("cohort predictions are not finite")
        worst_rel = max(worst_rel,
                        float(np.max(np.abs(p_k - p_p) / np.abs(p_p))))
    log(f"grid vs plain route on the card: every member's first tree equal "
        f"at all {levels} levels; predictions max rel diff {worst_rel:.3e}; "
        f"training AUC max |diff| {worst_auc:.3e} (each "
        + ", ".join(f"{k}: {m.training_metrics.auc:.6f}"
                    for k, m in mg.items()) + ")")

    gs = grid_search(GridSearch, XGBoost, GRID_SAMPLED, R,
                     col_sample_rate=0.6).train(fr)
    masked = 0
    for key, m in by_combo(gs.models, GRID_SAMPLED).items():
        combo = dict(zip(GRID_SAMPLED, key))
        seq = XGBoost(ntrees=R, col_sample_rate=0.6, **BENCH_CFG,
                      **combo).train(fr)
        why = stacks_differ(m, seq)
        if why:
            raise AssertionError(f"sampled cohort member {combo} and its "
                                 f"sequential train differ on {why}")
        if not np.array_equal(m.predict(fr).vec("YES").to_numpy(),
                              seq.predict(fr).vec("YES").to_numpy()):
            raise AssertionError(f"sampled member {combo}'s predictions "
                                 f"differ")
        masked += sum(int((~lv[3]).sum()) for lv in as_stacks(m)[0].levels)
    log(f"grid sampled: {GRID_SAMPLED} with col_sample_rate=0.6, each "
        f"member bitwise its sequential train (trees, leaf values, "
        f"predictions); {masked} nodes left unsplit across the members")

    halving = dict(BENCH_CFG, score_tree_interval=5)
    with ScanWatch(shared) as watch:
        gh = GridSearch(XGBoost, GRID_HP, grid_batch="on", ntrees=R,
                        search_criteria={"successive_halving": True,
                                         "halving_eta": 2},
                        **halving).train(fr)
    retired = [m for m in gh.models if m.output.get("halving")]
    survivors = [m for m in gh.models if not m.output.get("halving")]
    if len(retired) != G - 1 or len(survivors) != 1:
        raise AssertionError(f"halving left {len(survivors)} survivors")
    for m in gh.models:
        key = tuple(getattr(m.params, k) for k in GRID_HP)
        full = as_stacks(seqs[key])[0]
        n = m.output["ntrees_trained"]
        why = stack_differs(as_stacks(m)[0], shared.StackedTrees(
            [tuple(x[:n] for x in lv) for lv in full.levels],
            full.values[:n], full.covers[:n]))
        if why:
            raise AssertionError(f"halving member {key}: its {n} trees and "
                                 f"its sequential train's differ on {why}")
    after = 0
    for alive, per in watch.chunks:
        for k, on in enumerate(alive):
            if on:
                continue
            after += per[k].ntrees
            if bool((per[k].values != 0).any()) or any(
                    bool(lv[3].any()) for lv in per[k].levels):
                raise AssertionError(f"retired member {k} grew a split or a "
                                     f"non-zero leaf value")
    log(f"grid halving (halving_eta=2, scoring every 5 trees): retired at "
        + ", ".join(f"{m.output['halving']['retired_at']}" for m in retired)
        + f" trees, {survivors[0].params.learn_rate}/"
        f"{survivors[0].params.reg_lambda} survives with "
        f"{survivors[0].output['ntrees_trained']} trees; every member bitwise "
        f"the first trees of its sequential train; the {after} trees the "
        f"retired members grew after retirement have no split and zero leaf "
        f"values")
    publish_check("trained-xgboost-grid-member", g.models[0], fr, cols,
                  batcher)
    return launches


def headline_grid(GridSearch, XGBoost, fr, card):
    """Phase 19: the phase-18 cohort at 10M rows: a 5-round warmup, then
    member trees/s (G x rounds/s) of a timed 20-round cohort, the device
    operations per round and idle share of a profiled train of the same
    size, and the wave path (the G members as sequential 20-tree trains,
    ``grid_batch="off"``) in the same run."""
    import torch
    R = GRID_ROUNDS
    G = len(combos(GRID_HP))
    n = fr.nrows
    t0 = time.perf_counter()
    grid_search(GridSearch, XGBoost, GRID_HP, 5).train(fr)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    probe_us = host_op_us()
    t0 = time.perf_counter()
    g = grid_search(GridSearch, XGBoost, GRID_HP, R).train(fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tps = G * R / dt
    log(f"headline grid: {n} rows, GridSearch(XGBoost, {GRID_HP}, "
        f"grid_batch='on'), max_depth=6, nbins=256: 5-round warmup "
        f"{warm:.3f} s, then {R} rounds of {G} members in {dt:.3f} s = "
        f"{R / dt:.3f} rounds/s = {tps:.3f} member trees/s; best training "
        f"AUC {max(m.training_metrics.auc for m in g.models):.6f} {card}")
    kern, busy = device_profile(
        lambda: grid_search(GridSearch, XGBoost, GRID_HP, R).train(fr))
    ops = sum(e.count for e in kern) / R
    idle = idle_share(busy, dt)
    if busy <= 0:
        log("profile grid: no device time in the trace: not measured")
    else:
        log(f"profile grid of a {R}-round cohort at {n} rows: {ops:g} device "
            f"operations per round (a small torch op costs the host "
            f"{probe_us:.2f} us); device busy {busy / R:.2f} ms per round "
            f"against {dt / R * 1e3:.2f} ms of wall per round of the "
            f"unprofiled {R}-round cohort: idle share {idle:.3f}; device ms "
            f"per round by kernel (launches per round): "
            + "; ".join(f"{e.key[:110]} "
                        f"{e.self_device_time_total / 1e3 / R:.3f} "
                        f"({e.count / R:g})" for e in kern[:12]))
    t0 = time.perf_counter()
    GridSearch(XGBoost, GRID_HP, grid_batch="off", ntrees=R,
               **BENCH_CFG).train(fr)
    torch.cuda.synchronize()
    wave_dt = time.perf_counter() - t0
    wave_tps = G * R / wave_dt
    log(f"headline grid wave path: the {G} members as sequential {R}-tree "
        f"trains (grid_batch='off') in {wave_dt:.3f} s = {wave_tps:.3f} "
        f"trees/s {card}")
    return tps, ops, idle, wave_tps


# -------------------------------------------------- DRF, node-sparse levels

# the forest of phases 20-21: the bench frame's binary response, unsampled
# (every tree alike), at DRF's depth, min_rows and a 64-bin axis
DRF_CFG = dict(response_column="dep_delayed_15min",
               ignored_columns=["delay_class"], max_depth=20, nbins=64,
               sample_rate=1.0, mtries=-2, seed=1,
               score_tree_interval=10 ** 9)
DRF_CLASS_CFG = dict(DRF_CFG, response_column="delay_class",
                     ignored_columns=["dep_delayed_15min"])
# DRF's defaults (sample_rate 0.632, mtries -1, min_rows 1) at depth 20
DRF_DEFAULT_CFG = dict(response_column="dep_delayed_15min",
                       ignored_columns=["delay_class"], max_depth=20,
                       nbins=64, seed=1, score_tree_interval=10 ** 9)
DRF_TREES = 3
DRF_WARM, DRF_TIMED = 3, 10


def capture_slot_levels(fr, DRF, hist, cfg):
    """Train one DRF tree (or one round of K class trees) with the
    histogram, compaction and records wrappers watched: per level the
    inputs of its one batched ``hist_varbin`` or ``hist_uniform`` launch
    (leaf [K, n]: the root's rows, a dense level's compacted prefix
    labelled by parent, a sparse level's slot-ordered prefix labelled by
    parent slot, with its ``row_start``), per sparse level those of its
    ``slot_compact`` launch (codes, sleaf, stats, ps_of_slot, A_prev), and
    per level those of its records launch (the K*L flattened leaves or
    slots).  Returns (levels, compactions, records, the model's build:
    its depth and first sparse level)."""
    hv, sc, sr = [], [], []
    real = (hist.hist_varbin, hist.hist_uniform, hist.slot_compact,
            hist.split_records)

    def spy_hv(gcodes, leaf, stats, L, bc, B, scale=None, row_start=None):
        hv.append(("varbin", gcodes, leaf, stats, L, tuple(bc), B, scale,
                   row_start))
        return real[0](gcodes, leaf, stats, L, bc, B, scale,
                       row_start=row_start)

    def spy_hu(codes, leaf, stats, L, B, planes=3, scale=None,
               row_start=None):
        hv.append(("uniform", codes, leaf, stats, L, None, B, scale,
                   row_start))
        return real[1](codes, leaf, stats, L, B, planes, scale,
                       row_start=row_start)

    def spy_sc(codes, sleaf, stats, ps_of_slot, A_prev):
        sc.append((codes, sleaf, stats, ps_of_slot, A_prev))
        return real[2](codes, sleaf, stats, ps_of_slot, A_prev)

    def spy_sr(Hist, nbins, *args, **kw):
        sr.append((Hist.clone(), nbins, args))
        return real[3](Hist, nbins, *args, **kw)

    (hist.hist_varbin, hist.hist_uniform, hist.slot_compact,
     hist.split_records) = spy_hv, spy_hu, spy_sc, spy_sr
    try:
        m = DRF(ntrees=1, **cfg).train(fr)
    finally:
        (hist.hist_varbin, hist.hist_uniform, hist.slot_compact,
         hist.split_records) = real
    return hv, sc, sr, m


def slot_hist(entry, hist, stats=None, scale=None, plain=True,
              windows=True):
    """Launch a captured level's histogram again (on other stats when
    given; over its row windows, or with ``windows=False`` over the whole
    prefix, today's full-prefix geometry), and with ``plain`` its plain
    version: (kernel, plain)."""
    kind, g, leaf, st, L, bc, B, sc, rs = entry
    st = st if stats is None else stats
    sc = sc if stats is None else scale
    rs = rs if windows else None
    if kind == "varbin":
        got = hist.hist_varbin(g, leaf, st, L, bc, B, sc, row_start=rs)
        return (got, hist.hist_varbin_torch(
            g, leaf, st, L, hist.packed_layout(bc, B), sc)) if plain else got
    got = hist.hist_uniform(g, leaf, st, L, B, scale=sc, row_start=rs)
    return (got, hist.hist_uniform_torch(g, leaf, st, L, B, scale=sc)) \
        if plain else got


def by_window(out, n):
    """A compaction's prefix ([K, F, cap1] codes whose plane 0 is each
    row's number, pleaf, st) sorted per tree by (parent slot, row), the
    tail (leaf -1) last with its codes and stats read as 0 (the kernel
    leaves them unwritten): the order-free form of its windows."""
    import torch
    cc, pleaf, st = out[:3]
    tail = pleaf < 0
    key = torch.where(tail, torch.iinfo(torch.int64).max,
                      pleaf.long() * n + cc[:, 0].long())
    order = torch.sort(key, dim=1, stable=True)[1]
    K, F, cap1 = cc.shape
    tail = tail.gather(1, order)[:, None]
    return (torch.where(tail, 0, cc.gather(
                2, order[:, None].expand(K, F, cap1))),
            pleaf.gather(1, order),
            torch.where(tail, 0.0, st.gather(
                2, order[:, None].expand(K, 3, cap1))))


def check_compaction(entry, hist, what):
    """``slot_compact`` against ``slot_compact_torch`` on a captured
    level's inputs, with each row's number as a first code plane: the same
    ``row_start`` and chosen slots, each window the same rows with the
    same codes, parent slot and stats (both sorted by row within their
    windows), the same tail of leaf -1; a second launch likewise.  Returns the
    largest |kernel - plain| over the sorted stats and codes."""
    import torch
    codes, sleaf, stats, ps, A_prev = entry
    n = codes.shape[1]
    rows = torch.arange(n, dtype=torch.int32, device=codes.device)[None]
    tagged = torch.cat([rows, codes.int()])
    want = hist.slot_compact_torch(tagged, sleaf, stats, ps, A_prev)
    w = by_window(want, n)
    worst = 0.0
    for _ in range(2):
        got = hist.slot_compact(tagged, sleaf, stats, ps, A_prev)
        torch.cuda.synchronize()
        if not (torch.equal(got[3], want[3])
                and torch.equal(got[4], want[4])):
            raise AssertionError(f"slot_compact at {what}: row_start or "
                                 f"the chosen slots differ from the plain "
                                 f"version")
        g = by_window(got, n)
        worst = max(worst, max_diff(g[0], w[0]), max_diff(g[2], w[2]))
        if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                and torch.equal(g[2].view(torch.int32),
                                w[2].view(torch.int32))):
            raise AssertionError(f"slot_compact at {what}: a window holds "
                                 f"other rows, codes, parent slots or "
                                 f"stats than the plain version's")
    return worst


def dropped_children(m, shared):
    """Per sparse level d of the model's trees: the alive children past
    the slot budget (2 x the valid nodes of level d-1 less the A_d slots:
    pairs drop whole), summed over its trees and classes."""
    p = m.params
    F = len(m.datainfo.specs)
    depth = m.output["effective_max_depth"]
    _, A_lv, _ = shared.sparse_geometry(depth, p.nbins, F,
                                        p.sparse_depth_threshold, "sparse")
    out = {d: 0 for d in A_lv}
    for st in as_stacks(m):
        for d, A in A_lv.items():
            alive = 2 * st.levels[d - 1][3].sum(dim=1)
            out[d] += int((alive - A).clamp_min(0).sum())
    return out, A_lv


def sparse_start(m, shared):
    """The model's first node-sparse level."""
    return shared.sparse_geometry(
        m.output["effective_max_depth"], m.params.nbins,
        len(m.datainfo.specs), m.params.sparse_depth_threshold,
        "sparse")[0]


def check_slot_kernels(fr, DRF, hist, shared, dev, card):
    """Phase 20: one 1M-row DRF tree and one K = 3 round captured; at
    every sparse level ``slot_compact`` against its plain version (the
    same windows: ``check_compaction``), the one windowed ``hist`` launch
    (K trees, L = the parent slots, each tile over its parent slots' row
    windows) bitwise its plain version, a second launch and the
    full-prefix launch (``row_start=None``), on the captured and on
    integer-valued stats, and the plain histogram of the plain
    compaction's prefix; the records over the K*A slots bitwise theirs;
    the slot budget binds (some level drops pairs).  Returns (the largest
    max|kernel - plain| of hist, slot_compact and records, the binomial
    capture)."""
    import torch
    from h2o3_tpu_torch.testing import same_bits
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    worst = {"hist": 0.0, "split_records": 0.0, "slot_compact": 0.0}
    capture = None
    for what, cfg in (("binomial tree", DRF_CFG),
                      (f"K={K_CLASSES} round", DRF_CLASS_CFG)):
        hv, sc, sr, m = capture_slot_levels(fr, DRF, hist, cfg)
        depth = m.output["effective_max_depth"]
        start = sparse_start(m, shared)
        if len(hv) != depth or len(sr) != depth or start >= depth \
                or len(sc) != depth - start \
                or any(e[8] is not None for e in hv[:start]) \
                or any(e[8] is None for e in hv[start:]):
            raise AssertionError(
                f"DRF {what}: {len(hv)} hist, {len(sc)} slot_compact and "
                f"{len(sr)} records launches for {depth} levels, sparse "
                f"from {start}, windows at the wrong levels")
        shapes = []
        for d in range(start, depth):
            entry = hv[d]
            leaf = entry[2]
            K, n = leaf.shape
            worst["slot_compact"] = max(
                worst["slot_compact"],
                check_compaction(sc[d - start], hist,
                                 f"sparse level {d} of the DRF {what}"))
            ints = torch.stack([int_stats(n, gen, dev) for _ in range(K)])
            for stats, scl, kind in ((None, None, "captured"),
                                     (ints, hist.stat_scale(ints),
                                      "integer")):
                got, want = slot_hist(entry, hist, stats, scl)
                again, _ = slot_hist(entry, hist, stats, scl)
                full = slot_hist(entry, hist, stats, scl, plain=False,
                                 windows=False)
                torch.cuda.synchronize()
                worst["hist"] = max(worst["hist"], max_diff(got, want))
                if not (same_bits(got, want) and same_bits(again, got)
                        and same_bits(full, got)):
                    raise AssertionError(
                        f"windowed hist ({entry[0]}) at sparse level {d} of "
                        f"the DRF {what} != plain (or a second launch, or "
                        f"the full-prefix launch) on {kind} stats: "
                        f"max|diff| {max_diff(got, want):.3e}, full "
                        f"{max_diff(full, want):.3e}")
            # the plain compaction's prefix through the plain histogram
            pc = hist.slot_compact_torch(*sc[d - start])
            kind, _, _, _, L, bc, B, scl, _ = entry
            plain = hist.hist_varbin_torch(
                pc[0], pc[1], pc[2], L, hist.packed_layout(bc, B), scl) \
                if kind == "varbin" else hist.hist_uniform_torch(
                    pc[0], pc[1], pc[2], L, B, scale=scl)
            if not same_bits(plain, slot_hist(entry, hist, plain=False)):
                raise AssertionError(
                    f"the windowed hist of slot_compact's prefix at sparse "
                    f"level {d} of the DRF {what} != the plain histogram "
                    f"of the plain compaction's prefix")
            shapes.append((d, L, sr[d][0].shape[1], n,
                           int(entry[8][:, -1].sum())))
        worst["split_records"] = max(
            worst["split_records"],
            check_records(sr[start:], hist, f"sparse-level DRF {what}"))
        drops, A_lv = dropped_children(m, shared)
        log(f"kernel check slot levels, DRF {what} at {fr.nrows} rows "
            f"(max_depth {depth}, sparse from level {start}, slots "
            f"{sorted(set(A_lv.values()))}, hist layout {hv[-1][0]}): at "
            f"every sparse level slot_compact's windows hold the plain "
            f"version's rows, codes, parent slots and stats (a second "
            f"launch too); the windowed hist launch bitwise its plain "
            f"version, a second launch and the full-prefix launch, on the "
            f"captured and on integer-valued stats, and the plain "
            f"histogram of the plain compaction's prefix; records over the "
            f"K*A slots bitwise theirs; (level, parent slots L, K*A records "
            f"rows, prefix rows, chosen rows) {shapes}; alive children "
            f"made terminal by the slot budget per level "
            f"{ {d: c for d, c in drops.items() if c} } {card}")
        if not any(drops.values()):
            raise AssertionError(f"DRF {what}: no sparse level dropped a "
                                 f"pair; the slot budget never bound")
        if capture is None:
            capture = (hv, sc, sr, start)
    return worst, capture


def drf_train_phase(fr, cols, kernels, DRF, hist, shared, batcher, card):
    """Phase 21: the DRF main path at 1M rows, counted (the scalar
    records once per level of every tree, ``effective_max_depth`` each a
    tree; ``hist`` once per dense level, and per sparse level one
    ``slot_compact`` and one windowed ``hist`` launch; for a K = 3 round
    the same, whatever K); against the
    plain route; a second train bitwise; the K = 3 forest, sampled,
    bitwise its K loop; hist_layout="check" at depth 12 from level 4;
    the default-sampled forest published and served through the
    MicroBatcher, every answer against the numpy ScoringModel.  Returns
    the main path's launch counts."""
    import torch
    from h2o3_tpu_torch.export.mojo import from_reference
    n = fr.nrows
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = DRF(ntrees=DRF_TREES, **DRF_CFG).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    depth = m.output["effective_max_depth"]
    if m.output["hist_layout"] != "sparse" \
            or depth != DRF_CFG["max_depth"]:
        raise AssertionError(f"the DRF grew {m.output['hist_layout']} "
                             f"levels to depth {depth}")
    start = sparse_start(m, shared)
    sparse = depth - start
    want = {"hist": DRF_TREES * start,
            "hist (slot windows)": DRF_TREES * sparse,
            "slot_compact": DRF_TREES * sparse,
            "split_records": DRF_TREES * depth,
            "split_records (per-row)": 0, "fine_hist": 0}
    if launches != want:
        raise AssertionError(f"DRF launches {launches}; expected trees x "
                             f"levels: {want}")
    log(f"DRF train: DRF(max_depth=20, nbins=64, sample_rate=1, mtries=-2, "
        f"ntrees={DRF_TREES}) on {n} rows in {train_s:.3f} s {card}; "
        f"launches {launches} = {DRF_TREES} trees x {depth} levels: per "
        f"tree {start} dense levels one full-prefix hist each, {sparse} "
        f"node-sparse levels one slot_compact and one windowed hist each, "
        f"every level one split_records; hist kernel "
        f"{m.output['hist_kernel']}; training AUC "
        f"{m.training_metrics.auc:.6f}")

    plain_from = {k.name: k.launches for k in kernels}
    with plain_route(hist):
        mp = DRF(ntrees=DRF_TREES, **DRF_CFG).train(fr)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route DRF train launched a kernel")
    a, b = m.output["trees"][0], mp.output["trees"][0]
    for d in range(depth):
        for name in ("feat", "na_left", "valid", "thr"):
            if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                raise AssertionError(
                    f"kernel and plain-route DRF trains differ on {name} "
                    f"at level {d} of the first tree")
    p_k = m.predict(fr).vec("YES").to_numpy()
    p_p = mp.predict(fr).vec("YES").to_numpy()
    if not (np.isfinite(p_k).all() and p_k.shape == (n,)):
        raise AssertionError("DRF predictions are not finite")
    if not np.allclose(p_k, p_p, rtol=1e-4, atol=0.0):
        raise AssertionError("DRF predictions differ from the plain route")
    auc_k, auc_p = m.training_metrics.auc, mp.training_metrics.auc
    if abs(auc_k - auc_p) > 1e-4:
        raise AssertionError(f"DRF training AUC {auc_k} vs plain {auc_p}")
    log(f"DRF vs plain route on the card: the first tree's splits equal at "
        f"all {depth} levels; predictions max |diff| "
        f"{float(np.max(np.abs(p_k - p_p))):.3e}; training AUC "
        f"{auc_k:.6f} vs {auc_p:.6f}")
    check_deterministic(m, DRF(ntrees=DRF_TREES, **DRF_CFG).train(fr),
                        "DRF")

    sampled = dict(DRF_CLASS_CFG, sample_rate=0.632, mtries=-1)
    for k in kernels:
        k.launches = 0
    mk = DRF(ntrees=2, **sampled).train(fr)
    torch.cuda.synchronize()
    klaunch = {k.name: k.launches for k in kernels}
    kdepth = mk.output["effective_max_depth"]
    kstart = sparse_start(mk, shared)
    if klaunch["hist"] != 2 * kstart \
            or klaunch["hist (slot windows)"] != 2 * (kdepth - kstart) \
            or klaunch["slot_compact"] != 2 * (kdepth - kstart) \
            or klaunch["split_records"] != 2 * kdepth \
            or len(as_stacks(mk)) != K_CLASSES:
        raise AssertionError(f"K={K_CLASSES} DRF launches {klaunch}; "
                             f"expected rounds x levels, whatever K")
    ms = DRF(ntrees=2, split_mode="separate", **sampled).train(fr)
    why = stacks_differ(mk, ms)
    if why:
        raise AssertionError(f"the batched K={K_CLASSES} DRF and its K "
                             f"loop differ on {why}")
    log(f"DRF K={K_CLASSES} (delay_class, sample_rate 0.632, mtries -1, 2 "
        f"rounds): launches {klaunch} = 2 rounds x {kdepth} levels, "
        f"whatever K; bitwise its K loop (split_mode='separate'); logloss "
        f"{mk.training_metrics.logloss:.6f}")

    mc = DRF(ntrees=1, **dict(DRF_CFG, max_depth=12, sparse_depth_threshold=4,
                             hist_layout="check")).train(fr)
    if mc.output["hist_layout"] != "sparse":
        raise AssertionError("hist_layout='check' did not train sparse")
    log("DRF hist_layout='check' (max_depth 12, sparse from level 4, no "
        "level past the slot budget): the dense and node-sparse builds "
        "agree on the card, then the sparse one trained")

    md = DRF(ntrees=5, **DRF_DEFAULT_CFG).train(fr)
    serve_check("trained-drf", md, cols, batcher, from_reference, card)
    return launches


def serve_check(name, m, cols, batcher, from_reference, card,
                cat_label=lambda v: str(int(v))):
    """Publish ``m``; 8 client threads x 50 single-row requests through
    the MicroBatcher, counted, each answer against the numpy
    ``ScoringModel`` of the same archive (rtol 1e-4, atol 1e-5, labels
    equal; an isolation forest's scores alike).  ``cat_label`` writes a
    bench code as the label the model's domain holds."""
    from h2o3_tpu_torch.serving import kernel
    n_threads, per_thread = 8, 50
    rows = []
    for i in range(n_threads * per_thread):
        r = {}
        for k, v in cols.items():
            if k in ("carrier", "origin", "dest"):
                r[k] = cat_label(v[i])
            elif k not in ("dep_delayed_15min", "delay_class", "treatment",
                           "conv"):
                r[k] = float(v[i])
        rows.append(r)
    answers = [None] * len(rows)
    errors = []

    def client(c):
        try:
            for j in range(c * per_thread, (c + 1) * per_thread):
                answers[j] = ent.predict_rows([rows[j]])
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    sm = from_reference(*m.to_archive())
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_threads)]
    kernel.TRAVERSE.launches = 0
    try:
        ent = batcher.publish(name, m)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = kernel.TRAVERSE.launches
        batcher_launches = ent.batcher.launches
    finally:
        batcher.shutdown_all()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    ref = sm.predict({k: np.asarray([r[k] for r in rows])
                      for k in rows[0]})
    key = "probabilities" if "probabilities" in ref else "predict"
    got_p = np.concatenate([a[key] for a in answers])
    got_l = np.concatenate([a["predict"] for a in answers])
    if not np.allclose(got_p, ref[key], rtol=1e-4, atol=1e-5):
        raise AssertionError(f"served {name} diverges from the numpy "
                             f"ScoringModel: max|diff| "
                             f"{np.abs(got_p - ref[key]).max()}")
    if key == "probabilities" and not (got_l == ref["predict"]).all():
        raise AssertionError(f"served {name} labels diverge")
    if launches <= 0 or launches != batcher_launches:
        raise AssertionError(f"traverse launches {launches}, batcher "
                             f"launches {batcher_launches}")
    log(f"serve {name}: {sm.meta['ntrees']} trees of depth "
        f"{sm.meta['depth']}, family {sm.meta['family']}, tree_average "
        f"{sm.meta.get('tree_average', False)}; "
        f"{len(rows)} single-row requests from {n_threads} threads through "
        f"the MicroBatcher, {launches} traverse launches; every answer "
        f"matches the numpy ScoringModel {card}")
    return launches


def row_order_compaction(codes, sleaf, stats, ps_of_slot, A_prev):
    """The node-sparse level's compaction as the port built it before
    ``slot_compact`` (``histc`` counts, the fold, one cumsum over the K*n
    rows, a scatter of the chosen rows' numbers in ROW order, then
    gathers of their codes, parent slots and stats): (ccodes, pleaf, st,
    chosen_slot).  Kept only to be timed beside the kernel that replaced
    it."""
    import torch
    K, n = sleaf.shape
    A = ps_of_slot.shape[1]
    F = codes.shape[0]
    cap = n // 2
    dev = codes.device
    off = (torch.arange(K, dtype=torch.int64, device=dev) * (A + 1))[:, None]
    cnt = torch.histc((sleaf + off).double(), bins=K * (A + 1), min=0,
                      max=K * (A + 1)).view(K, A + 1)
    zero = torch.zeros((K, A_prev), dtype=torch.float64, device=dev)
    cl = zero.scatter_add(1, ps_of_slot[:, 0::2], cnt[:, 0:A:2])
    cr = zero.scatter_add(1, ps_of_slot[:, 1::2], cnt[:, 1:A:2])
    sil = (cl <= cr).gather(1, ps_of_slot)
    chosen_slot = torch.where((torch.arange(A, device=dev) & 1).bool(),
                              ~sil, sil)
    no = torch.zeros((K, 1), dtype=torch.int64, device=dev)
    chosen = torch.cat([chosen_slot, no.bool()], 1).gather(1, sleaf)
    ps_tbl = torch.cat([ps_of_slot, no], 1)
    c_flat = torch.cumsum(chosen.view(-1), dim=0).view(K, n)
    c_incl = c_flat - torch.nn.functional.pad(c_flat[:-1, -1:], (0, 0, 1, 0))
    target = torch.where(chosen, c_incl - 1, cap)
    rows = torch.zeros((K, cap + 1), dtype=torch.int64, device=dev) \
        .scatter_(1, target, torch.arange(n, device=dev).expand(K, n))
    kept = torch.arange(cap + 1, device=dev) < c_incl[:, -1:]
    ccodes = codes.index_select(1, rows.view(-1)).view(
        F, K, cap + 1).transpose(0, 1)
    pleaf = torch.where(kept, ps_tbl.gather(1, sleaf.gather(1, rows)),
                        -1).to(torch.int32)
    st = stats.gather(2, rows[:, None, :].expand(K, 3, cap + 1))
    return ccodes, pleaf, st, chosen_slot


def work_windows(g, leaf, rs, L, Q, F):
    """Bytes and adds of one windowed launch: each tree's row_start, the
    leaf id, stats and codes of each row in its windows (every other row
    of the prefix is never read) and its packed output once."""
    valid = int(rs[:, -1].sum())
    nbytes = rs.numel() * 4 + valid * (4 + 12 + F * g.element_size()) \
        + leaf.shape[0] * Q * 3 * L * 4
    return nbytes, 3 * F * valid


def work_compaction(entry, hist):
    """Bytes one ``slot_compact`` needs: every row's slot read once (8 B;
    one [n] row when the trees share it), the codes and stats of the
    chosen rows read and written with their parent slot, and the leaf -1
    of each tree's tail (the rest of its n // 2 + 1 positions; their
    codes and stats are never written)."""
    codes, sleaf, _, ps, A_prev = entry
    K, n = sleaf.shape
    F, cb = codes.shape[0], codes.element_size()
    cnt = hist.slot_counts_torch(sleaf, ps.shape[1])
    chosen = int(hist._slot_choice(cnt, ps, A_prev)[2][:, -1].sum())
    rows = K if sleaf.stride(0) else 1
    return rows * n * 8 + chosen * (2 * (F * cb + 12) + 4) \
        + (K * (n // 2 + 1) - chosen) * 4


def time_slot_levels(hv, sc, sr, start, hist, label, card):
    """Device ms of each sparse level's windowed ``hist`` launch (CUDA
    events) in turns with the same kernel over the same slot-ordered
    prefix without windows (``row_start=None``, the full-prefix
    geometry: windowed, full, full, windowed), beside its plain version,
    the one int64 ``index_add_`` computing the same sums and its bound;
    its ``slot_compact`` beside the plain version and the row-order
    compaction it replaced (``row_order_compaction``), with its bound;
    the records launch.  Returns per-tree sums {hist, slot_compact,
    split_records: [ms, plain, bound, index_add_, bytes, ops]} and the
    full-prefix hist's ms and the row-order compaction's ms per tree."""
    import torch
    tot = {k: [0.0] * 6 for k in ("hist", "slot_compact", "split_records")}
    full_tot = old_tot = 0.0
    parts_tot = [0.0] * 3
    for d in range(start, len(hv)):
        kind, g, leaf, st, L, bc, B, scl, rs = hv[d]
        K, n = leaf.shape
        F = g.shape[-2]
        t = [cuda_ms(lambda: slot_hist(hv[d], hist, plain=False,
                                       windows=w), reps=20)
             for w in (True, False, False, True)]
        ms, full = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        if kind == "varbin":
            layout = hist.packed_layout(bc, B)
            plain = cuda_ms(lambda: hist.hist_varbin_torch(
                g, leaf, st, L, layout, scl), reps=YARDSTICK_REPS)
            Q = layout.Q
            q = g.long() if g.dim() == 3 else g.long()[None]
        else:
            plain = cuda_ms(lambda: hist.hist_uniform_torch(
                g, leaf, st, L, B, scale=scl), reps=YARDSTICK_REPS)
            Q = F * B
            c = g.long() if g.dim() == 3 else g.long()[None]
            q = c + (torch.arange(F, device=g.device) * B)[None, :, None]
        qs = hist.quantize(st, scl)
        lf = leaf.long()
        ok = ((lf >= 0) & (lf < L))[:, None, :].expand(K, F, n)
        kq = torch.arange(K, device=g.device)[:, None, None] * Q + q
        idx = (kq * L + lf[:, None, :]).expand(K, F, n)[ok]
        src = qs.transpose(1, 2)[:, None].expand(K, F, n, 3)[ok]
        out = torch.zeros((K * Q * L, 3), dtype=torch.int64,
                          device=g.device)
        lib = cuda_ms(lambda: out.index_add_(0, idx, src), YARDSTICK_REPS)
        del idx, src, kq, ok, out
        nbytes, ops = work_windows(g, leaf, rs, L, Q, F)
        bnd, _ = bound(nbytes, ops)
        e = sc[d - start]
        cms = cuda_ms(lambda: hist.slot_compact(*e), reps=20)
        # its parts: the count pass, the [K, A] choice, the scatter pass
        ecodes, esleaf, estats, eps, eAp = e
        cnt = hist._slot_count(esleaf, eps.shape[1])
        _, dest, ers = hist._slot_choice(cnt, eps, eAp)
        parts = (cuda_ms(lambda: hist._slot_count(esleaf, eps.shape[1]),
                         reps=20),
                 cuda_ms(lambda: hist._slot_choice(cnt, eps, eAp), reps=20),
                 cuda_ms(lambda: hist._slot_scatter(ecodes, esleaf, estats,
                                                    dest, ers), reps=20))
        chosen = int(ers[:, -1].sum())
        cplain = cuda_ms(lambda: hist.slot_compact_torch(*e),
                         reps=YARDSTICK_REPS)
        cold = cuda_ms(lambda: row_order_compaction(*e),
                       reps=YARDSTICK_REPS)
        cb = work_compaction(e, hist)
        cbnd, _ = bound(cb, 0)
        H, nbins, args = sr[d]
        LF, Bh = H.shape[1] * H.shape[2], H.shape[3]
        rms = cuda_ms(lambda: hist.split_records(H, nbins, *args), reps=20)
        rplain = cuda_ms(lambda: hist._split_records_torch(H, *args),
                         reps=3)
        rb, rops = work_records(LF, Bh)
        rbnd, _ = bound(rb, rops)
        for key, v in (("hist", (ms, plain, bnd, lib, nbytes, ops)),
                       ("slot_compact", (cms, cplain, cbnd, 0.0, cb, 0)),
                       ("split_records", (rms, rplain, rbnd, 0.0, rb,
                                          rops))):
            for j in range(6):
                tot[key][j] += v[j]
        full_tot += full
        old_tot += cold
        parts_tot = [a + b for a, b in zip(parts_tot, parts)]
        log(f"slot level times {label} level {d} (K={K}, parent slots "
            f"L={L}, prefix rows {n}, rows in windows {ops // (3 * F)}, "
            f"{kind}) {card}: windowed hist {ms:.4f} ms in turns with the "
            f"full-prefix launch {full:.4f} ({t[0]:.4f}, {t[1]:.4f}, "
            f"{t[2]:.4f}, {t[3]:.4f}; plain {plain:.4f}, index_add_ "
            f"{lib:.4f}, bound {bnd:.5f} by bytes {nbytes}); slot_compact "
            f"{cms:.4f} ms over {chosen} chosen rows (count pass "
            f"{parts[0]:.4f}, choice {parts[1]:.4f}, scatter pass "
            f"{parts[2]:.4f}; plain {cplain:.4f}, the row-order compaction "
            f"{cold:.4f}, bound {cbnd:.5f} by bytes {cb}); split_records "
            f"{rms:.4f} ms over {LF} rows (plain {rplain:.4f}, bound "
            f"{rbnd:.6f})")
    log(f"slot level times per tree at {label} (sum of the {len(hv) - start}"
        f" sparse levels) {card}: windowed hist {tot['hist'][0]:.4f} ms, "
        f"the full-prefix launch in turns {full_tot:.4f} (plain "
        f"{tot['hist'][1]:.4f}, index_add_ {tot['hist'][3]:.4f}, bound "
        f"{tot['hist'][2]:.5f}); slot_compact {tot['slot_compact'][0]:.4f}"
        f" ms (count pass {parts_tot[0]:.4f}, choice {parts_tot[1]:.4f}, "
        f"scatter pass {parts_tot[2]:.4f}; plain "
        f"{tot['slot_compact'][1]:.4f}, the row-order "
        f"compaction {old_tot:.4f}, bound {tot['slot_compact'][2]:.5f}); "
        f"split_records {tot['split_records'][0]:.4f} ms (plain "
        f"{tot['split_records'][1]:.4f}, bound "
        f"{tot['split_records'][2]:.6f})")
    return tot, full_tot, old_tot


def headline_drf(DRF, fr, hist, shared, card):
    """Phase 22: DRF at its defaults at 10M rows (depth 20, sample_rate
    0.632, mtries -1, min_rows 1): a 3-tree warmup, then trees/s of a
    timed 10-tree forest, the device operations per tree, idle share and
    device ms by op of a profiled forest of the same size; then one
    captured tree's sparse levels timed."""
    import torch
    n = fr.nrows
    t0 = time.perf_counter()
    DRF(ntrees=DRF_WARM, **DRF_DEFAULT_CFG).train(fr)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    probe_us = host_op_us()
    T = DRF_TIMED
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = DRF(ntrees=T, **DRF_DEFAULT_CFG).train(fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tps = T / dt
    peak = torch.cuda.max_memory_allocated()
    F = len(m.datainfo.specs)
    B = m.params.nbins + 1
    A = max(shared.sparse_geometry(20, B - 1, F, 8, "sparse")[1].values())
    # a sparse level holds its carry, Hs, Ho, the [Hs, Ho] pair and H, each
    # [K, 3, A, F, B] f32, and the kernel's int64 [K, Q|F*B, A, 3] output
    lvl = 6 * 3 * A * F * B * 4 + A * 3 * F * B * 8
    log(f"DRF memory at {n} rows: device peak "
        f"{peak / 2 ** 30:.3f} GiB over the timed forest (the frame "
        f"included); a sparse level's histograms, reckoned from the code at "
        f"A = {A} slots, K = 1: at most {lvl / 2 ** 20:.1f} MiB, x K for K "
        f"class trees")
    drops, _ = dropped_children(m, shared)
    log(f"headline DRF: {n} rows, DRF at its defaults (max_depth=20, "
        f"nbins=64, sample_rate=0.632, mtries=-1, min_rows=1): {DRF_WARM}-"
        f"tree warmup {warm:.3f} s, then {T} trees in {dt:.3f} s = "
        f"{tps:.3f} trees/s; training AUC {m.training_metrics.auc:.6f}; "
        f"effective depth {m.output['effective_max_depth']}, hist kernel "
        f"{m.output['hist_kernel']}; alive children past the slot budget "
        f"per tree by level "
        f"{ {d: c / T for d, c in drops.items() if c} } {card}")
    kern, busy = device_profile(lambda: DRF(ntrees=T, **DRF_DEFAULT_CFG)
                                .train(fr))
    ops = sum(e.count for e in kern) / T
    idle = idle_share(busy, dt)
    if busy <= 0:
        log("profile DRF: no device time in the trace: not measured")
    else:
        log(f"profile DRF of a {T}-tree forest at {n} rows: {ops:g} device "
            f"operations per tree (a small torch op costs the host "
            f"{probe_us:.2f} us); device busy {busy / T:.2f} ms per tree "
            f"against {dt / T * 1e3:.2f} ms of wall per tree of the "
            f"unprofiled {T}-tree forest: idle share {idle:.3f}; device ms "
            f"per tree by kernel (launches per tree): "
            + "; ".join(f"{e.key[:110]} "
                        f"{e.self_device_time_total / 1e3 / T:.3f} "
                        f"({e.count / T:g})" for e in kern[:14]))
    hv, sc, sr, mc = capture_slot_levels(fr, DRF, hist, DRF_DEFAULT_CFG)
    start = sparse_start(mc, shared)
    check_records(sr[start:], hist, "10M-row DRF sparse-level")
    tot = time_slot_levels(hv, sc, sr, start, hist, f"{n} rows", card)
    return tps, ops, idle, tot


def slot_phases(DRF, Frame, hist, shared, batcher, kernels, dev, card):
    """Phases 20-21 at 1M rows.  Returns what phase 22's kernel rows
    need: (kernel-vs-plain differences, the main path's launch counts)."""
    cols, frd = multi_frame(1_000_000, Frame)
    kdiff, _ = check_slot_kernels(frd, DRF, hist, shared, dev, card)
    mark("phase 20")
    launches = drf_train_phase(frd, cols, kernels, DRF, hist, shared,
                               batcher, card)
    del frd, cols
    mark("phase 21")
    return kdiff, launches


def slot_headline(DRF, Frame, hist, shared, card, slot):
    """Phase 22 and the kernel rows of the slot geometry."""
    kdiff, launches = slot
    _, fr10 = multi_frame(10_000_000, Frame)
    tps, ops, idle, (tot, full, old) = headline_drf(DRF, fr10, hist, shared,
                                                   card)
    del fr10
    log(f"DRF headline at 10M rows {card}: {tps:.3f} trees/s, {ops:g} "
        f"device ops per tree, idle share {idle:.3f}; per tree at the "
        f"sparse levels the windowed hist {tot['hist'][0]:.4f} ms (the "
        f"full-prefix launch in turns {full:.4f}, index_add_ "
        f"{tot['hist'][3]:.4f}, bound {tot['hist'][2]:.5f}), slot_compact "
        f"{tot['slot_compact'][0]:.4f} ms (the row-order compaction "
        f"{old:.4f}, bound {tot['slot_compact'][2]:.5f}), split_records "
        f"{tot['split_records'][0]:.4f} ms")
    rows = []
    for name, key, src, rep, lib in (
            ("hist (node-sparse levels)", "hist (slot windows)",
             "h2o3_tpu_torch/csrc/hist.cu",
             "h2o3_tpu/models/tree/hist.py:256; "
             "h2o3_tpu/models/tree/hist.py:80 (at the slot geometry: "
             "hist.py:1046, _make_sparse_level_fn)", True),
            ("slot_compact", "slot_compact",
             "h2o3_tpu_torch/csrc/slot_compact.cu",
             "none: XLA in the reference (h2o3_tpu/models/tree/hist.py:988, "
             "_sparse_local_body)", False),
            ("split_records (node-sparse levels)", "split_records",
             "h2o3_tpu_torch/csrc/split_records.cu",
             "h2o3_tpu/models/tree/hist.py:1526 (over the K*A slots: "
             "shared.py:836, shared.py:998)", False)):
        v = tot[key.split(" ")[0]]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key], "max_abs_err": kdiff[key.split(" ")[0]],
            "ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
            "bound_by": bound(v[4], v[5])[1],
            "library_ms": v[3] if lib else None,
        })
    return rows


# ------------------------------------------ 23-27: file import and builders

IMPORT_ROWS = 10_000_000
IMPORT_SMALL = 1_000_000
# the bench's categorical codes: written as numbers, imported as "cat"
IMPORT_CATS = {"carrier": "cat", "origin": "cat", "dest": "cat"}
XGB_IMPORT_TREES = 20
DT_CFG = dict(response_column="dep_delayed_15min", seed=1)
ISO_CFG = dict(ignored_columns=["dep_delayed_15min"], seed=1)
# 10 trees: the device="cpu" oracle train scores 1M rows through every
# tree's hyperplanes
EIF_CFG = dict(ISO_CFG, extension_level=1, ntrees=10)
UPLIFT_CFG = dict(response_column="conv", treatment_column="treatment",
                  ignored_columns=["dep_delayed_15min"], max_depth=10, seed=1)
UPLIFT_TREES = 3
# the first node-sparse level of DT's default depth 20 and of the uplift
# forest's depth 10 (the default sparse_depth_threshold): the levels
# before it launch the full-prefix hist, those from it slot_compact and
# the windowed hist
DT_SPARSE_FROM = UPLIFT_SPARSE_FROM = 8
UPLIFT_TIMED = 5


def csv_cells(v):
    """One column as fixed-width byte cells: integer-valued numbers as
    integers, other floats with 9 significant digits (each reads back as
    the float32 it was), labels as they are."""
    v = np.asarray(v)
    if v.dtype == object or v.dtype.kind in "US":
        return v.astype("S")
    if v.dtype.kind in "iu" or (v == np.round(v)).all():
        iv = v.astype(np.int64)
        lo = int(iv.min())
        table = np.array([str(i).encode()
                          for i in range(lo, int(iv.max()) + 1)])
        return table[iv - lo]
    return np.array([b"%.9g" % x for x in v.astype(np.float64).tolist()])


def write_csv(path, cols, rows=None, chunk=1_000_000) -> None:
    """The columns as a CSV with a header line, vectorised per column and
    chunk of rows: each chunk's cells side by side as bytes, their
    padding dropped."""
    names = list(cols)
    n = len(cols[names[0]]) if rows is None else rows
    with open(path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            parts = []
            for j, name in enumerate(names):
                parts.append(csv_cells(cols[name][lo:hi]).view(np.uint8)
                             .reshape(hi - lo, -1))
                parts.append(np.full((hi - lo, 1), ord(
                    "\n" if j == len(names) - 1 else ","), np.uint8))
            blk = np.concatenate(parts, axis=1).ravel()
            f.write(blk[blk != 0].tobytes())


def float_label(v):
    """A bench code as the label the imported domain holds: the parser
    labels a numeric cell typed "cat" by the str of its float64, as the
    JAX package's native engine does."""
    return str(np.float64(v))


def imported_codes(values, domain):
    """The bench codes against an imported domain: each label must be the
    str of its value as a float64, the labels sorted as strings."""
    want = sorted(np.unique(values).astype(np.float64).astype(str).tolist())
    if list(domain) != want:
        raise AssertionError(f"imported domain {domain[:6]}... is not the "
                             "sorted float labels of the values")
    lab = np.array([float(x) for x in domain]).astype(np.int64)
    lut = np.full(int(lab.max()) + 1, -1, np.int32)
    lut[lab] = np.arange(len(lab), dtype=np.int32)
    return lut[values]


def frames_bitwise(a, b, label, same_domains=True):
    """Two frames with the same names, types, domains and every column
    bitwise (``same_domains=False``: domains numerically equal, for the
    stdlib engine's integer labels)."""
    import torch
    if a.names != b.names or a.types() != b.types() or a.nrows != b.nrows:
        raise AssertionError(f"{label}: {a.types()} x {a.nrows} against "
                             f"{b.types()} x {b.nrows}")
    def numeric(dom):
        try:
            return [float(x) for x in dom]
        except ValueError:
            return dom
    for name in a.names:
        va, vb = a.vec(name), b.vec(name)
        dom_ok = va.domain == vb.domain or not same_domains and \
            numeric(va.domain) == numeric(vb.domain)
        if not dom_ok:
            raise AssertionError(f"{label}: domains of {name} differ")
        if not torch.equal(va.data.view(torch.uint8),
                           vb.data.to(va.device).view(torch.uint8)):
            raise AssertionError(f"{label}: column {name} differs")


def import_phase(Frame, tmp, card):
    """Phase 23: the bench frame at 10M rows written to a CSV and imported
    onto the card; returns (the import, the numpy frame with the parser's
    domains, the columns, the 1M-row CSV, its import)."""
    import torch
    from h2o3_tpu_torch import fastcsv, import_file
    from h2o3_tpu_torch.frame import parse
    t0 = time.perf_counter()
    fastcsv.load()
    log(f"fastcsv: built with g++ {' '.join(fastcsv.GXX_FLAGS)} into "
        f"{os.path.basename(fastcsv.lib_path())} and loaded in "
        f"{time.perf_counter() - t0:.2f} s (the host of {card})")
    n = IMPORT_ROWS
    cols, _, _ = make_airlines_like(n)
    path = os.path.join(tmp, "bench.csv")
    t0 = time.perf_counter()
    write_csv(path, cols)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    log(f"import: wrote the {n}-row bench frame to a {size / 1e6:.1f} MB "
        f"CSV in {write_s:.2f} s (vectorised per column and 1M-row chunk; "
        f"floats %.9g; the host of {card})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fr = import_file(path, col_types=IMPORT_CATS)
    imp_s = time.perf_counter() - t0
    stats = dict(parse.last_parse_stats)
    peak = torch.cuda.max_memory_allocated() - base
    if fr.device.type != "cuda" or fr.nrows != n:
        raise AssertionError(f"import gave {fr.nrows} rows on {fr.device}")
    stages = {k: stats[k] for k in ("mmap_s", "scan_s", "tokenize_s",
                                    "device_s", "decode_s", "vec_s")}
    log(f"import_file at {n} rows {card}: {imp_s:.3f} s = "
        f"{n / imp_s:,.0f} rows/s, {size / 1e6 / imp_s:.1f} MB/s; "
        f"{stats['ranges']} byte ranges; stage seconds {stages} (device_s "
        f"sums the pool threads' casts and copies); device peak "
        f"{peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB "
        f"before; types {fr.types()}")
    arrays = dict(cols)
    for c in IMPORT_CATS:
        arrays[c] = imported_codes(cols[c], fr.vec(c).domain)
    exp = Frame.from_numpy(arrays, types=IMPORT_CATS,
                           domains={c: fr.vec(c).domain for c in IMPORT_CATS})
    frames_bitwise(fr, exp, "import vs Frame.from_numpy")
    t0 = time.perf_counter()
    frames_bitwise(fr, import_file(path, col_types=IMPORT_CATS),
                   "a second import")
    imp2_s = time.perf_counter() - t0
    small = os.path.join(tmp, "bench1m.csv")
    write_csv(small, cols, rows=IMPORT_SMALL)
    nat = import_file(small, col_types=IMPORT_CATS)
    t0 = time.perf_counter()
    names, raw = parse._parse_csv_stdlib(small, None, None, None)
    std = Frame(names, [parse._column_to_vec(raw[c], c, IMPORT_CATS.get(c))
                        for c in names])
    torch.cuda.synchronize()
    std_s = time.perf_counter() - t0
    frames_bitwise(nat, std, "stdlib engine vs native", same_domains=False)
    log(f"import checks: every column of the {n}-row import bitwise "
        f"Frame.from_numpy with the parser's domains (labels '0.0', '1.0', "
        f"... of the codes, sorted as strings); a second import "
        f"({imp2_s:.3f} s) bitwise the first; the first {IMPORT_SMALL} rows "
        f"through the stdlib engine ({std_s:.2f} s) bitwise the native "
        f"engine's (the same codes; labels '5' for '5.0') {card}")
    return fr, exp, cols, small, nat


def import_train_phase(fr, exp, XGBoost, kernels, card):
    """Phase 24: 20 trees of the bench XGBoost on the imported frame,
    counted, bitwise the same train on the numpy frame."""
    import torch
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = XGBoost(ntrees=XGB_IMPORT_TREES, **BENCH_CFG).train(fr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    levels = XGB_IMPORT_TREES * BENCH_CFG["max_depth"]
    want = {"hist": levels, "split_records": levels,
            "split_records (per-row)": 0, "fine_hist": 0, **NO_SLOT}
    if launches != want:
        raise AssertionError(f"imported-frame XGBoost launches {launches}; "
                             f"expected {want}")
    why = stacks_differ(m, XGBoost(ntrees=XGB_IMPORT_TREES, **BENCH_CFG)
                        .train(exp))
    if why:
        raise AssertionError(f"XGBoost on the imported frame and on the "
                             f"numpy frame differ on {why}")
    log(f"import train: XGBoost(max_depth=6, nbins=256, ntrees="
        f"{XGB_IMPORT_TREES}) on the imported {fr.nrows}-row frame in "
        f"{train_s:.3f} s {card}; launches "
        f"{launches}; bitwise the trees and leaf values of the same train "
        f"on the numpy frame; training AUC {m.training_metrics.auc:.6f}")
    return launches


def dt_phase(nat, cols, fr10, kernels, hist, batcher, card):
    """Phase 25: DecisionTree at its defaults on the 1M-row import:
    counted, against the plain route, a second train bitwise, served;
    then one DT at 10M rows timed."""
    import torch
    from h2o3_tpu_torch.export.mojo import from_reference
    from h2o3_tpu_torch.models.tree.dt import DecisionTree
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = DecisionTree(**DT_CFG).train(nat)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    depth = m.output["effective_max_depth"]
    start = DT_SPARSE_FROM
    want = {"hist": start, "hist (slot windows)": depth - start,
            "slot_compact": depth - start, "split_records": depth,
            "split_records (per-row)": 0, "fine_hist": 0}
    if launches != want or m.output["hist_layout"] != "sparse" \
            or depth != 20:
        raise AssertionError(f"DT launches {launches} at depth {depth} "
                             f"({m.output['hist_layout']}); expected {want}")
    with plain_route(hist):
        mp = DecisionTree(**DT_CFG).train(nat)
    a, b = m.output["trees"][0], mp.output["trees"][0]
    for d in range(depth):
        for name in ("feat", "na_left", "valid", "thr"):
            if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                raise AssertionError(f"kernel and plain-route DT differ on "
                                     f"{name} at level {d}")
    p_k = m.predict(nat).vec("YES").to_numpy()
    p_p = mp.predict(nat).vec("YES").to_numpy()
    if not (np.isfinite(p_k).all() and np.allclose(p_k, p_p, rtol=1e-4)):
        raise AssertionError("DT predictions differ from the plain route")
    check_deterministic(m, DecisionTree(**DT_CFG).train(nat), "DT")
    log(f"DT train: DecisionTree() (max_depth 20, min_rows 10, nbins 64, "
        f"node-sparse from depth 8) on the imported {nat.nrows} rows in "
        f"{train_s:.3f} s {card}; launches {launches}; the plain route's "
        f"splits at all {depth} levels, predictions max |diff| "
        f"{float(np.max(np.abs(p_k - p_p))):.3e}; training AUC "
        f"{m.training_metrics.auc:.6f}; "
        f"{int(sum(v.sum() for v in a.valid))} splits")
    serve_check("trained-dt", m, cols, batcher, from_reference, card,
                cat_label=float_label)
    DecisionTree(**DT_CFG).train(fr10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m10 = DecisionTree(**DT_CFG).train(fr10)
    torch.cuda.synchronize()
    dt10 = time.perf_counter() - t0
    log(f"DT at {fr10.nrows} rows (the import, after one warmup train) "
        f"{card}: one tree in {dt10:.3f} s ({1 / dt10:.3f} trees/s), "
        f"{int(sum(v.sum() for v in m10.output['trees'][0].valid))} "
        f"splits, training AUC {m10.training_metrics.auc:.6f}")
    return launches


def same_iso_trees(a, b, label):
    """Two isolation forests (or EIFs) with bitwise the same trees."""
    if "stacked" in a.output:
        sa, sb = a.output["stacked"], b.output["stacked"]
        pairs = [(x.cpu(), y.cpu()) for la, lb in zip(sa.levels, sb.levels)
                 for x, y in zip(la, lb)] + [(sa.values.cpu(),
                                              sb.values.cpu())]
        same = all(x.dtype == y.dtype and np.array_equal(
            x.numpy().view(np.uint8), y.numpy().view(np.uint8))
            for x, y in pairs)
    else:
        same = all(np.array_equal(np.asarray(x).view(np.uint8),
                                  np.asarray(y).view(np.uint8))
                   for ta, tb in zip(a.output["trees"], b.output["trees"])
                   for x, y in zip(ta.normals + ta.offsets + ta.valid
                                   + [ta.values],
                                   tb.normals + tb.offsets + tb.valid
                                   + [tb.values]))
    if not same or len(a.output["trees"]) != len(b.output["trees"]):
        raise AssertionError(f"{label}: the card's trees differ from the "
                             "CPU's")


def isolation_phase(nat, small, cols, fr10, batcher, card):
    """Phase 26: IsolationForest and EIF on the 1M-row import against a
    ``device="cpu"`` train of the same file and seed; the IsolationForest
    published and served through ``traverse.cu``; trees/s at 10M rows."""
    import torch
    from h2o3_tpu_torch import import_file
    from h2o3_tpu_torch.export.mojo import from_reference
    from h2o3_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                                   IsolationForest)
    from h2o3_tpu_torch.serving import kernel
    cpu = import_file(small, col_types=IMPORT_CATS, device="cpu")
    for cls, cfg, label in ((IsolationForest, ISO_CFG, "IsolationForest"),
                            (ExtendedIsolationForest, EIF_CFG, "EIF")):
        t0 = time.perf_counter()
        m = cls(**cfg).train(nat)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        same_iso_trees(m, cls(device="cpu", **cfg).train(cpu), label)
        score = m.predict(nat).vecs[0].to_numpy()
        if not (np.isfinite(score).all() and (score > 0).all()
                and (score < 1).all()):
            raise AssertionError(f"{label}: scores outside (0, 1)")
        log(f"{label} ({m.params.ntrees} trees, sample_size 256, depth 8"
            + (", extension_level 1" if cls is ExtendedIsolationForest
               else "") + f") on the imported {nat.nrows} rows in "
            f"{card_s:.3f} s {card}: bitwise the trees of a device='cpu' "
            f"train of the same file and seed; mean score "
            f"{float(np.mean(score)):.6f}")
        if cls is IsolationForest:
            iso = m
    ps = kernel.PackedScorer(from_reference(*iso.to_archive()))
    X = iso._design(nat)[: nat.nrows]
    before = kernel.TRAVERSE.launches
    got = ps.score_tensor(X)[:, 0].cpu().numpy()
    want = iso.predict(nat).vec("predict").to_numpy()
    if kernel.TRAVERSE.launches != before + 1 or \
            not np.allclose(got, want, rtol=1e-5):
        raise AssertionError("the packed IsolationForest's scores differ "
                             "from predict")
    served = serve_check("trained-isolationforest", iso, cols, batcher,
                         from_reference, card, cat_label=float_label)
    for cls, cfg, label in ((IsolationForest, ISO_CFG, "IsolationForest"),
                            (ExtendedIsolationForest, EIF_CFG, "EIF")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = cls(**cfg).train(fr10)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"{label} at {fr10.nrows} rows {card}: {m.params.ntrees} trees "
            f"in {dt:.3f} s = {m.params.ntrees / dt:.3f} trees/s (the "
            f"training scores of every row included)")
    return 1 + served


def uplift_columns(cols, n=None, seed=12):
    """The bench features plus a treatment arm and a conversion with a
    planted effect (+0.15 past 700 miles, -0.05 below), drawn from
    ``np.random.default_rng(seed)``, in the manner of
    tests/test_algos3.py."""
    n = len(cols["year"]) if n is None else n
    rng = np.random.default_rng(seed)
    treat = rng.integers(0, 2, n)
    dist = cols["distance"][:n]
    logit = (0.002 * (cols["crs_dep_time"][:n] / 100 - 12) ** 2
             - 0.0005 * dist / 100 - 0.5)
    p = np.clip(1 / (1 + np.exp(-logit))
                + treat * np.where(dist > 700, 0.15, -0.05), 0.01, 0.99)
    out = {k: cols[k][:n] for k in ("year", "month", "day_of_week",
                                    "crs_dep_time", "distance", "carrier",
                                    "origin", "dest")}
    out["treatment"] = np.array(["control", "treatment"],
                                dtype=object)[treat]
    out["conv"] = np.array(["no", "yes"], dtype=object)[
        (rng.random(n) < p).astype(np.int64)]
    return out


def uplift_phase(cols, fr10, Frame, kernels, hist, tmp, card):
    """Phase 27: UpliftDRF (depth 10, both arms on the K axis) on a
    1M-row uplift CSV imported onto the card: counted (one ``hist``
    launch per level for both arms), against the plain route, a second
    train bitwise; trees/s at 10M rows."""
    import torch
    from h2o3_tpu_torch import import_file
    from h2o3_tpu_torch.models.tree.uplift import UpliftDRF
    path = os.path.join(tmp, "uplift1m.csv")
    write_csv(path, uplift_columns(cols, IMPORT_SMALL))
    ufr = import_file(path, col_types=IMPORT_CATS)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    m = UpliftDRF(ntrees=UPLIFT_TREES, **UPLIFT_CFG).train(ufr)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    want = {"hist": UPLIFT_TREES * UPLIFT_SPARSE_FROM,
            "hist (slot windows)": UPLIFT_TREES * (10 - UPLIFT_SPARSE_FROM),
            "slot_compact": UPLIFT_TREES * (10 - UPLIFT_SPARSE_FROM),
            "split_records": 0, "split_records (per-row)": 0,
            "fine_hist": 0}
    if launches != want:
        raise AssertionError(f"uplift launches {launches}; expected {want}")
    with plain_route(hist):
        mp = UpliftDRF(ntrees=UPLIFT_TREES, **UPLIFT_CFG).train(ufr)
    a, b = m.output["trees"][0], mp.output["trees"][0]
    for d in range(10):
        for name in ("feat", "na_left", "valid", "thr"):
            if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                raise AssertionError(f"kernel and plain-route uplift differ "
                                     f"on {name} at level {d}")
    m2 = UpliftDRF(ntrees=UPLIFT_TREES, **UPLIFT_CFG).train(ufr)
    for key in ("stacked_pt", "stacked_pc"):
        why = stack_differs(m.output[key], m2.output[key])
        if why:
            raise AssertionError(f"a second uplift train differs on {why}")
    up = m.predict(ufr).vec("uplift_predict").to_numpy()
    met = m.training_metrics.describe()
    if not (np.isfinite(up).all() and np.isfinite(list(met.values())).all()):
        raise AssertionError(f"uplift predictions or metrics not finite: "
                             f"{met}")
    log(f"uplift train: UpliftDRF(max_depth=10, KL, sample_rate 0.632, "
        f"ntrees={UPLIFT_TREES}) on the imported {ufr.nrows} rows in "
        f"{train_s:.3f} s {card}; launches {launches} (both arms in one "
        f"launch a level, node-sparse levels 8-9, hist kernel "
        f"{m.output['hist_kernel']}); the plain route's splits on the first "
        f"tree; a second train bitwise; qini {met['qini']:.6f}, ate "
        f"{met['ate']:.6f}, mean uplift on the planted +0.15 rows "
        f"{float(up[cols['distance'][:ufr.nrows] > 700].mean()):.4f}")
    u10 = uplift_columns(cols)
    ufr10 = fr10.cbind(Frame.from_numpy(
        {k: u10[k] for k in ("treatment", "conv")}))
    walls = []
    # the first is also the warmup; the timed train twice, for its spread
    for T in (1, UPLIFT_TIMED, UPLIFT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        UpliftDRF(ntrees=T, **UPLIFT_CFG).train(ufr10)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    T = UPLIFT_TIMED
    further = [(w - walls[0]) / (T - 1) * 1e3 for w in walls[1:]]
    log(f"uplift at {ufr10.nrows} rows (the import plus a treatment and a "
        f"conversion) {card}: {T} trees in {walls[1]:.3f} s = "
        f"{T / walls[1]:.3f} trees/s, binning, the training scores and the "
        f"AUUC on the host included (1 tree: {walls[0]:.3f} s, so "
        f"{further[0]:.1f} ms a further tree; the {T}-tree train again: "
        f"{walls[2]:.3f} s, {further[1]:.1f} ms a further tree)")
    probe_us = host_op_us()
    kern, busy = device_profile(lambda: UpliftDRF(ntrees=T, **UPLIFT_CFG)
                                .train(ufr10))
    if busy <= 0:
        log("profile uplift: no device time in the trace: not measured")
    else:
        log(f"profile uplift of a {T}-tree train at {ufr10.nrows} rows: "
            f"{sum(e.count for e in kern) / T:g} device operations per tree "
            f"(a small torch op costs the host {probe_us:.2f} us); device "
            f"busy {busy / T:.2f} ms per tree against "
            f"{walls[1] / T * 1e3:.2f} ms of wall per tree of the unprofiled "
            f"{T}-tree train: idle share {idle_share(busy, walls[1]):.3f}; "
            f"device ms per tree by kernel (launches per tree): "
            + "; ".join(f"{e.key[:110]} "
                        f"{e.self_device_time_total / 1e3 / T:.3f} "
                        f"({e.count / T:g})" for e in kern[:14]))
    return launches


def import_phases(Frame, XGBoost, hist, batcher, kernels, card):
    """Phases 23-27 in a temporary directory, removed after."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="h2o3_smoke_")
    try:
        fr, exp, cols, small, nat = import_phase(Frame, tmp, card)
        mark("phase 23")
        xl = import_train_phase(fr, exp, XGBoost, kernels, card)
        del exp
        mark("phase 24")
        dl = dt_phase(nat, cols, fr, kernels, hist, batcher, card)
        mark("phase 25")
        tl = isolation_phase(nat, small, cols, fr, batcher, card)
        mark("phase 26")
        ul = uplift_phase(cols, fr, Frame, kernels, hist, tmp, card)
        mark("phase 27")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"launches on the import paths {card}: XGBoost {xl}; DT {dl}; "
        f"IsolationForest scoring: traverse {tl} (one over the 1M rows, "
        f"the rest serving); uplift {ul}")


# ------------------------------------------------- 28-32: DART and GLM

# phase 28: XGBoost's DART booster on the bench frame
DART_CFG = dict(BENCH_CFG, booster="dart", rate_drop=0.1)
DART_TREES = 20
DART_ROUNDS_K = 5                 # the K = 3 DART rounds of phase 29
DART_WARM, DART_TIMED = 5, 20     # the 10M-row headline of phase 30
GLM_CFG = dict(response_column="dep_delayed_15min",
               ignored_columns=["delay_class"])
GLM_MULTI_CFG = dict(response_column="delay_class",
                     ignored_columns=["dep_delayed_15min"])
GLM_ARCHIVE_ROWS = 20_000         # rows the numpy scorer scores (f64)
# the f32 Gram's fit against the f64 Gram's: the coefficients' max
# difference over the largest, the deviance at the final coefficients
# (relative) and the probabilities' max difference.  The sound reading
# is the f32 sums' rounding (~1e-7 of each entry) times the condition
# number of the 628-column Gram (printed beside it): its worst direction
# is the intercept against the sum of a categorical's one-hot columns.
# Each limit lies between that reading and the readings of two planted
# faults, both taken in every run and required to break every limit:
# the Gram with TF32 matmuls allowed, and the Gram with its last row
# block's weights zeroed.  On an H100 at 1M rows the three read 3.578e-3,
# 3.212e-10 and 2.649e-4 sound, 0.1194, 3.706e-7 and 8.814e-3 with TF32.
GLM_F32_COEF_TOL = 1e-2
GLM_F32_DEV_TOL = 1e-8
GLM_F32_PROB_TOL = 1e-3


def watch_drops(gbm):
    """Wrap ``gbm.tree_scores`` (DART's drop sums; no validation frame is
    scored here) to record each round's dropped trees (the list, its X
    and K); returns (the records, a function that restores it)."""
    seen = []
    real = gbm.tree_scores

    def spy(trees, X, K):
        seen.append((list(trees), X, K))
        return real(trees, X, K)
    gbm.tree_scores = spy

    def restore():
        gbm.tree_scores = real
    return seen, restore


def dart_phase(fr, cols, kernels, XGBoost, batcher, hist, kernel, gbm,
               card):
    """Phase 28: the DART path at 1M rows, counted; every tree, those of
    the rounds that dropped trees included, split as the plain route's;
    a second train bitwise; published and served through
    ``traverse.cu``.  Its kernels are the exact path's at the same
    shapes, held against their plain versions in phase 7 and timed in
    phase 9."""
    import torch
    n = fr.nrows
    for k in kernels:
        k.launches = 0
    seen, restore = watch_drops(gbm)
    try:
        t0 = time.perf_counter()
        m = XGBoost(ntrees=DART_TREES, **DART_CFG).train(fr)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        restore()
    launches = {k.name: k.launches for k in kernels}
    levels = m.output["stacked"].depth
    want = {"hist": DART_TREES * levels,
            "split_records": DART_TREES * levels, "fine_hist": 0,
            "split_records (per-row)": 0, **NO_SLOT}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"DART train launches {launches}; expected "
                             f"trees x levels: {want}")
    if not seen:
        raise AssertionError("the DART train dropped no tree")
    dropped = sum(len(t) for t, _, _ in seen)
    log(f"DART train: XGBoost(booster='dart', rate_drop=0.1, max_depth=6, "
        f"nbins=256, ntrees={DART_TREES}) on {n} rows in {train_s:.3f} s "
        f"{card}; launches {launches} = {DART_TREES} trees x {levels} "
        f"levels; {len(seen)} rounds dropped trees ({dropped} in all)")

    plain_from = {k.name: k.launches for k in kernels}
    mp = train_plain(fr, XGBoost, hist, DART_TREES, cfg=DART_CFG)
    if {k.name: k.launches for k in kernels} != plain_from:
        raise AssertionError("the plain-route DART train launched a kernel")
    a, b = m.output["trees"][0], mp.output["trees"][0]
    for d in range(levels):
        for name in ("feat", "na_left", "valid", "thr"):
            if not torch.equal(getattr(a, name)[d], getattr(b, name)[d]):
                raise AssertionError(f"kernel and plain-route DART trains "
                                     f"differ on {name} at level {d} of the "
                                     "first tree")
    pk = m.predict(fr).vec("YES").to_numpy()
    pp = mp.predict(fr).vec("YES").to_numpy()
    if not (np.isfinite(pk).all() and pk.shape == (n,)):
        raise AssertionError("DART predictions are not finite")
    rel = float(np.max(np.abs(pk - pp) / np.abs(pp)))
    if not np.allclose(pk, pp, rtol=1e-4, atol=0.0):
        raise AssertionError(f"DART predictions differ from the plain "
                             f"route: max rel {rel:.3e} > 1e-4")
    auc_k, auc_p = m.training_metrics.auc, mp.training_metrics.auc
    if abs(auc_k - auc_p) > 1e-4:
        raise AssertionError(f"DART training AUC {auc_k} vs plain {auc_p}")
    differ = [t for t in range(DART_TREES)
              if stacks_differ_round(m, mp, t) is not None]
    if differ:
        raise AssertionError(f"kernel and plain-route DART trains split "
                             f"trees {differ} differently")
    log(f"DART train vs plain route on the card: all {DART_TREES} trees "
        f"({len(seen)} of them grown after a drop) split equally at all "
        f"{levels} levels; predictions max rel diff {rel:.3e}; training "
        f"AUC {auc_k:.6f} vs {auc_p:.6f}")
    m2 = XGBoost(ntrees=DART_TREES, **DART_CFG).train(fr)
    check_deterministic(m, m2, "DART")
    before = kernel.TRAVERSE.launches
    publish_check("trained-xgboost-dart", m, fr, cols, batcher)
    served = kernel.TRAVERSE.launches - before
    if served <= 0:
        raise AssertionError("the published DART model never launched "
                             "traverse")
    log(f"DART served: {served} traverse launches answered the 256 rows "
        f"as m.predict {card}")

    return launches


def dart_multi_phase(Frame, XGBoost, kernels, card):
    """Phase 29: the K = 3 DART round on ``delay_class`` at 1M rows, one
    batched build a round (rounds x levels launches, whatever K), bitwise
    its K loop (``split_mode="separate"``)."""
    import torch
    cols, fr = multi_frame(1_000_000, Frame)
    cfg = dict(MULTI_CFG, booster="dart", rate_drop=0.3, one_drop=True)
    for k in kernels:
        k.launches = 0
    m = XGBoost(ntrees=DART_ROUNDS_K, **cfg).train(fr)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    levels = as_stacks(m)[0].depth
    if launches["hist"] != DART_ROUNDS_K * levels or \
            launches["split_records"] != DART_ROUNDS_K * levels:
        raise AssertionError(f"K = 3 DART launches {launches}; expected "
                             f"rounds x levels, whatever K")
    ms = XGBoost(ntrees=DART_ROUNDS_K, split_mode="separate", **cfg) \
        .train(fr)
    why = stacks_differ(m, ms)
    if why:
        raise AssertionError(f"the batched K = 3 DART round and its K loop "
                             f"differ on {why}")
    p = multi_class_probs(m, fr)
    if not (np.isfinite(p).all() and np.allclose(p.sum(axis=1), 1.0,
                                                  atol=1e-5)):
        raise AssertionError("K = 3 DART probabilities are not finite rows "
                             "summing to 1")
    log(f"DART K = 3 (delay_class, rate_drop=0.3, one_drop, "
        f"{DART_ROUNDS_K} rounds) on {fr.nrows} rows {card}: launches "
        f"{launches} = rounds x levels; bitwise its K loop (trees and "
        f"rescaled leaf values); training logloss "
        f"{m.training_metrics.logloss:.6f}")
    return launches


def headline_dart(XGBoost, fr, gbm, card):
    """Phase 30: DART at 10M rows: a warmup, then trees/s of a timed
    train, and a profile of a train of the same size whose drop sums are
    replayed alone under the profiler: their share of the device time."""
    import torch
    n = fr.nrows
    XGBoost(ntrees=DART_WARM, **DART_CFG).train(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = XGBoost(ntrees=DART_TIMED, **DART_CFG).train(fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    seen, restore = watch_drops(gbm)
    try:
        kern, busy = device_profile(lambda: XGBoost(
            ntrees=DART_TIMED, **DART_CFG).train(fr))
    finally:
        restore()
    _, drop_busy = device_profile(lambda: [gbm.tree_scores(t, X, K)
                                           for t, X, K in seen])
    ops = sum(e.count for e in kern) / DART_TIMED
    log(f"headline DART: {n} rows, XGBoost(booster='dart', rate_drop=0.1, "
        f"max_depth=6, nbins=256): {DART_WARM}-tree warmup, then "
        f"{DART_TIMED} trees in {dt:.3f} s = {DART_TIMED / dt:.3f} trees/s; "
        f"training AUC {m.training_metrics.auc:.6f} {card}")
    if busy <= 0:
        log("profile DART: no device time in the trace: not measured")
    else:
        log(f"profile DART of a {DART_TIMED}-tree train at {n} rows: "
            f"{ops:g} device operations per tree; device busy "
            f"{busy / DART_TIMED:.2f} ms per tree against "
            f"{dt / DART_TIMED * 1e3:.2f} ms of wall: idle share "
            f"{idle_share(busy, dt):.3f}; the drop sums ({len(seen)} "
            f"rounds, {sum(len(t) for t, _, _ in seen)} dropped trees, "
            f"replayed alone) {drop_busy:.2f} ms of {busy:.2f} ms device "
            f"busy = share {drop_busy / busy:.4f}; device ms per tree by "
            "kernel (launches per tree): " + "; ".join(
                f"{e.key[:110]} {e.self_device_time_total / 1e3 / DART_TIMED:.3f}"
                f" ({e.count / DART_TIMED:g})" for e in kern[:10]))
    return DART_TIMED / dt


def gram_f64(X, wi, z=None):
    """``glm.weighted_gram`` with the products in f64 on the card: the
    oracle the f32 Gram is held against (its own row blocks, 1 GiB
    each)."""
    import torch
    N, P = X.shape
    rb = max(1, (1 << 30) // (8 * P))
    G = torch.zeros((P, P), dtype=torch.float64, device=X.device)
    c = torch.zeros(P, dtype=torch.float64, device=X.device)
    w64 = wi.double()
    for r0 in range(0, N, rb):
        Xb = X[r0:r0 + rb].double()
        G.addmm_((Xb * w64[r0:r0 + rb, None]).t(), Xb)
        if z is not None:
            c += Xb.t() @ (w64[r0:r0 + rb] * z[r0:r0 + rb].double())
    return G, (None if z is None else c)


def without_last_block(glm, real):
    """A faulty ``glm.weighted_gram``: the Gram with the weights of its
    last row block zeroed (X'Wz whole), as a dropped block would give."""
    import torch

    def gram(X, wi, z=None):
        N, P = X.shape
        rb = max(1, glm.GRAM_BLOCK_BYTES // (4 * P))
        keep = torch.arange(N, device=X.device) < (N - 1) // rb * rb
        G, _ = real(X, wi * keep, None)
        return G, (None if z is None else X.t() @ (wi * z))
    return gram


def glm_gap(m, ref, fr, y):
    """(the coefficients' max difference over the largest, the relative
    difference of the binomial deviances at the final coefficients, the
    probabilities' max difference) of fit ``m`` against fit ``ref``; the
    deviances summed in f64 from ``predict``'s probabilities."""
    b, br = (np.asarray(x.output["beta_std_flat"]) for x in (m, ref))
    p, pr = (multi_class_probs(x, fr)[:, 1].astype(np.float64)
             for x in (m, ref))

    def deviance(q):
        return float(-2.0 * np.sum(np.where(y, np.log(q), np.log1p(-q))))
    with np.errstate(all="ignore"):
        gap = (float(np.abs(b - br).max() / np.abs(br).max()),
               abs(deviance(p) / deviance(pr) - 1.0),
               float(np.abs(p - pr).max()))
    # a non-finite reading is as far off as can be
    return tuple(float("inf") if not np.isfinite(v) else v for v in gap)


def irls_iterations(m):
    """The IRLS iterations of a single-class IRLSM fit: the sum over its
    lambdas (one history entry each)."""
    return sum(int(h["iteration"]) for h in m.scoring_history)


def glm_phase(Frame, GLM, glm, from_reference, card):
    """Phase 31: GLM at 1M rows on the card: binomial at the defaults
    held against the same fit with the Gram in f64 on the card; a second
    fit bitwise; the lambda search; multinomial on ``delay_class``; the
    archive's numpy scorer against ``predict``."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: GLM's Gram must be full "
                             "f32")
    cols, fr = multi_frame(1_000_000, Frame)
    n = fr.nrows
    t0 = time.perf_counter()
    m = GLM(**GLM_CFG).train(fr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    P = m.datainfo.nfeatures
    y = np.asarray(cols["dep_delayed_15min"]) == "YES"
    real = glm.weighted_gram
    glm.weighted_gram = gram_f64
    try:
        m64 = GLM(**GLM_CFG).train(fr)
    finally:
        glm.weighted_gram = real
    limits = (GLM_F32_COEF_TOL, GLM_F32_DEV_TOL, GLM_F32_PROB_TOL)
    gap = glm_gap(m, m64, fr, y)
    # the planted faults: each must break every limit
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        mt = GLM(**GLM_CFG).train(fr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    glm.weighted_gram = without_last_block(glm, real)
    try:
        mb = GLM(**GLM_CFG).train(fr)
    finally:
        glm.weighted_gram = real
    faults = {"TF32 allowed": glm_gap(mt, m64, fr, y),
              "last row block dropped": glm_gap(mb, m64, fr, y)}

    def show(g):
        return (f"coefficients {g[0]:.3e} of the largest, deviance "
                f"{g[1]:.3e}, probabilities {g[2]:.3e}")
    log(f"GLM fits against the f64 Gram's {card} (limits {limits}): the "
        f"f32 Gram {show(gap)}; planted faults: " + "; ".join(
            f"{k}: {show(g)}" for k, g in faults.items()))
    di = m.datainfo
    X = di.make_matrix(fr)
    G = gram_f64(X, di.weights(fr))[0].cpu().numpy()
    live = np.diag(G) > 0            # NA buckets no row sets are all zero
    cond = float(np.linalg.cond(G[np.ix_(live, live)]))
    if any(v > t for v, t in zip(gap, limits)):
        raise AssertionError(f"GLM with the f32 Gram against the f64 Gram: "
                             f"{show(gap)} (limits {limits})")
    for k, g in faults.items():
        if any(v <= t for v, t in zip(g, limits)):
            raise AssertionError(f"the planted fault '{k}' passes a limit "
                                 f"{limits}: {show(g)}")
    m2 = GLM(**GLM_CFG).train(fr)
    b, b2 = (np.asarray(x.output["beta_std_flat"]) for x in (m, m2))
    if not np.array_equal(b, b2):
        raise AssertionError("a second GLM fit on the card differs: max "
                             f"|diff| {np.abs(b - b2).max():.3e}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls came on during the GLM fits")
    log(f"GLM binomial at the defaults on {n} rows (P = {P}) {card}: "
        f"{fit_s:.3f} s, {irls_iterations(m)} IRLS iterations, residual "
        f"deviance {m.output['residual_deviance']:.3f}, AUC "
        f"{m.training_metrics.auc:.6f}; against the same fit with the Gram "
        f"in f64 on the card: {show(gap)} (limits {limits}; the weighted "
        f"Gram's condition number over its {int(live.sum())} live columns "
        f"{cond:.3e}); a second fit bitwise; TF32 off")

    t0 = time.perf_counter()
    ms = GLM(alpha=0.5, lambda_search=True, nlambdas=30, **GLM_CFG) \
        .train(fr)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    nz = int(np.count_nonzero(np.asarray(ms.output["beta_std_flat"])))
    log(f"GLM lambda_search (alpha 0.5, 30 lambdas) on {n} rows {card}: "
        f"{search_s:.3f} s, {irls_iterations(ms)} IRLS iterations, final "
        f"lambda {ms.output['lambda']:.3e}, {nz} of {P} coefficients "
        f"non-zero, AUC {ms.training_metrics.auc:.6f}")

    t0 = time.perf_counter()
    mm = GLM(**GLM_MULTI_CFG).train(fr)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    p = multi_class_probs(mm, fr)
    if not (mm.output["family"] == "multinomial" and np.isfinite(p).all()
            and np.allclose(p.sum(axis=1), 1.0, atol=1e-5)):
        raise AssertionError("GLM multinomial probabilities are not finite "
                             "rows summing to 1")
    log(f"GLM multinomial on delay_class ({n} rows, K = 3) {card}: "
        f"{multi_s:.3f} s, {mm.output['iterations']} iterations, logloss "
        f"{mm.training_metrics.logloss:.6f}, mean per-class error "
        f"{mm.training_metrics.mean_per_class_error:.6f}")

    k = GLM_ARCHIVE_ROWS
    rows = {c: cols[c][:k] for c in ("year", "month", "day_of_week",
                                     "crs_dep_time", "distance", "carrier",
                                     "origin", "dest")}
    for model, dom in ((m, ["NO", "YES"]), (mm, ["LONG", "NO", "SHORT"])):
        got = from_reference(*model.to_archive()).predict(rows)[
            "probabilities"]
        want = multi_class_probs(model, fr)[:k]
        err = float(np.abs(got - want).max())
        if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"the GLM archive's numpy scorer differs "
                                 f"from predict by {err:.3e}")
        log(f"GLM archive ({model.output['family']}): the numpy "
            f"ScoringModel scores {k} rows as m.predict (max |diff| "
            f"{err:.3e}, rtol 1e-5, atol 1e-6)")


def glm_headline(fr, GLM, glm, card):
    """Phase 32: GLM at 10M rows (P = 628): seconds per fit (the first
    with the design matrix built), IRLS iterations, the device peak, the
    Gram's device ms against its bound, and the idle share of a profiled
    fit."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = GLM(**GLM_CFG).train(fr)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    m2 = GLM(**GLM_CFG).train(fr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if not np.array_equal(np.asarray(m.output["beta_std_flat"]),
                          np.asarray(m2.output["beta_std_flat"])):
        raise AssertionError("a second 10M-row GLM fit differs")
    di = m.datainfo
    X = di.make_matrix(fr)
    N, P = X.shape
    w = di.weights(fr)
    z = torch.linspace(-1.0, 1.0, N, device=X.device)
    gram_ms = cuda_ms(lambda: glm.weighted_gram(X, w, z), reps=5)
    flops = 2.0 * N * P * P
    # X'WX is symmetric: its P(P+1)/2 distinct entries are the least work
    sym_flops = 1.0 * N * P * (P + 1)
    ops_ms = flops / F32_OPS_PER_S * 1e3
    sym_ms = sym_flops / F32_OPS_PER_S * 1e3
    bytes_ms = (N * P * 4 + 2 * N * 4) / HBM_BYTES_PER_S * 1e3
    its = irls_iterations(m)
    log(f"GLM headline at {fr.nrows} rows, P = {P} {card}: the first fit "
        f"(design matrix built, {N * P * 4 / 1e9:.2f} GB) {first_s:.3f} s, "
        f"a fit on the cached design {fit_s:.3f} s, {its} IRLS iterations "
        f"({fit_s / max(its, 1) * 1e3:.1f} ms each); device peak "
        f"{peak / 2 ** 30:.2f} GiB above what was resident; the Gram "
        f"X'WX + X'Wz {gram_ms:.2f} ms (median of 5, CUDA events) against "
        f"the bound of the full product {max(ops_ms, bytes_ms):.2f} ms "
        f"(2·N·P² = {flops / 1e12:.2f} TFLOP over 67 TFLOP/s f32; its "
        f"bytes {bytes_ms:.2f} ms) and the symmetric bound "
        f"{max(sym_ms, bytes_ms):.2f} ms (N·P(P+1) = {sym_flops / 1e12:.2f} "
        f"TFLOP): {gram_ms / max(sym_ms, bytes_ms):.2f}x the symmetric "
        f"bound, {flops / (gram_ms * 1e-3) / 1e12:.1f} TFLOP/s as the full "
        f"product; training AUC {m.training_metrics.auc:.6f}")
    kern, busy = device_profile(lambda: GLM(**GLM_CFG).train(fr))
    if busy <= 0:
        log("profile GLM: no device time in the trace: not measured")
    else:
        log(f"profile GLM of a fit at {fr.nrows} rows: device busy "
            f"{busy:.1f} ms against {fit_s * 1e3:.1f} ms of wall: idle "
            f"share {idle_share(busy, fit_s):.3f}; {sum(e.count for e in kern)}"
            f" device operations; device ms by kernel (launches): "
            + "; ".join(f"{e.key[:100]} {e.self_device_time_total / 1e3:.2f}"
                        f" ({e.count})" for e in kern[:8]))


def dart_glm_phases(Frame, XGBoost, GLM, glm, gbm, hist, kernel, batcher,
                    from_reference, kernels, card):
    """Phases 28-32: DART, then GLM."""
    import torch
    cols, types, domains = make_airlines_like(1_000_000)
    fr = Frame.from_numpy(cols, types=types, domains=domains)
    exact = dart_phase(fr, cols, kernels, XGBoost, batcher, hist, kernel,
                       gbm, card)
    del fr, cols
    mark("phase 28")
    launches = dart_multi_phase(Frame, XGBoost, kernels, card)
    mark("phase 29")
    t0 = time.perf_counter()
    cols, types, domains = make_airlines_like(10_000_000)
    fr10 = Frame.from_numpy(cols, types=types, domains=domains)
    del cols
    torch.cuda.synchronize()
    log(f"DART and GLM headline frame: {fr10.nrows} rows on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tps = headline_dart(XGBoost, fr10, gbm, card)
    mark("phase 30")
    glm_phase(Frame, GLM, glm, from_reference, card)
    mark("phase 31")
    glm_headline(fr10, GLM, glm, card)
    del fr10
    mark("phase 32")
    log(f"launches on the DART paths {card}: 20 trees at 1M rows {exact}; "
        f"the K = 3 rounds {launches}; DART at 10M rows {tps:.3f} trees/s")


def load_other(path: str):
    """Another version of the ``h2o3_tpu_torch`` package, the one under
    ``path`` (e.g. ``git archive <rev> h2o3_tpu_torch`` unpacked where
    .gitignore lists it), imported as ``other_h2o3_tpu_torch`` with its
    own sources and build directory; returns its tree ``hist`` module and
    its ``serving.kernel`` module, their four kernels built."""
    import importlib
    import importlib.util
    name = "other_h2o3_tpu_torch"
    pkg = os.path.join(os.path.abspath(path), "h2o3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    other = importlib.import_module(f"{name}.models.tree.hist")
    okernel = importlib.import_module(f"{name}.serving.kernel")
    importlib.import_module(f"{name}.native").build_all(
        [other.HIST, other.FINE_HIST, other.SPLIT_RECORDS, okernel.TRAVERSE])
    return other, okernel


def one_copy(hist):
    """A ``hist_turns`` setup: the histogram tiles without copies."""
    def setup():
        keep = hist.MAX_COPIES

        def swap(n):
            hist.MAX_COPIES = n
            hist._device_meta.cache_clear()
            hist._fine_meta.cache_clear()
        swap(1)
        return lambda: swap(keep)
    return setup


def turns(launches, variants, reps=30):
    """Device ms of ``launches`` under each variant in turns: every launch
    timed (``cuda_ms``) under the variants in order, then in reverse order
    (A, B, B, A for two), the two passes averaged, the launches of one
    path summed.  ``launches`` are (path, make): ``make(obj)`` returns the
    call; ``variants`` are (tag, obj, setup or None), where ``setup()``
    swaps the variant in and returns its undo.  Returns ({path: {tag:
    ms}}, {path: {tag: max|diff| from the first variant's output}})."""
    ms, diff, first = {}, {}, {}
    for tag, obj, setup in list(variants) + list(reversed(variants)):
        undo = setup() if setup else None
        try:
            for i, (path, make) in enumerate(launches):
                fn = make(obj)
                out = fn()
                d = diff.setdefault(path, {})
                d[tag] = max(d.get(tag, 0.0),
                             max_diff(out, first.setdefault(i, out)))
                t = ms.setdefault(path, {})
                t[tag] = t.get(tag, 0.0) + cuda_ms(fn, reps) / 2
        finally:
            if undo:
                undo()
    return ms, diff


def hist_turns(hv, hu, fh, variants):
    """Device ms per tree (the sum of its captured level launches) of the
    three histogram paths, ``hist_varbin`` on the exact levels ``hv`` and
    the coarse ``hist_uniform`` and ``fine_hist`` on the hier levels
    ``hu``, ``fh``, under each variant (tag, hist module, setup) in turns.
    A version's wrapper gets the tree's fixed-point scale where it takes
    one."""
    import inspect

    def call(mod, fn, *a, scale):
        f = getattr(mod, fn)
        kw = {"scale": scale} if "scale" in inspect.signature(
            f).parameters else {}
        return lambda: f(*a, **kw)

    launches = [("hist_varbin (exact levels)",
                 lambda m, a=(g, lf, st, L, bc, B), sc=sc:
                 call(m, "hist_varbin", *a, scale=sc))
                for g, lf, st, L, bc, B, sc in hv]
    launches += [("hist_uniform (hier coarse pass)",
                  lambda m, a=(c, lf, st, L, B), sc=sc:
                  call(m, "hist_uniform", *a, scale=sc))
                 for c, lf, st, L, B, sc in hu]
    launches += [("fine_hist",
                  lambda m, a=(c, lf, st, sel, W, nb), sc=sc:
                  call(m, "fine_hist", *a, scale=sc))
                 for c, lf, st, sel, W, nb, sc in fh]
    return turns(launches, variants)


def log_turns(hv, hu, fh, variants, label, card):
    """``hist_turns`` logged per path; raises if the tiles without copies
    give other sums."""
    ms, diff = hist_turns(hv, hu, fh, variants)
    for path, t in ms.items():
        if diff[path]["one copy per tile"] != 0.0:
            raise AssertionError(f"{path}: the tiles without copies give "
                                 f"other sums")
        log(f"in turns per tree at {label} {card}: {path}: " + "; ".join(
            f"{tag} {v:.4f} ms" + (f" (max|diff| {diff[path][tag]:.3e})"
                                   if tag != "this" else "")
            for tag, v in t.items()))


def records_turns(sr, variants, label, card):
    """``split_records`` per captured tree (the sum of its level launches)
    of this checkout and each other version (tag, hist module) in turns;
    raises unless every version gives bitwise the same records."""
    launches = [("split_records", lambda m, H=H, nb=nb, a=a:
                 lambda: m.split_records(H, nb, *a)) for H, nb, a in sr]
    ms, diff = turns(launches, [(t, m, None) for t, m in variants])
    if any(v != 0.0 for v in diff["split_records"].values()):
        raise AssertionError(f"split_records versions differ: {diff}")
    log(f"in turns per tree at {label} {card}: split_records over "
        f"{len(sr)} level launches: " + "; ".join(
            f"{tag} {v:.4f} ms" for tag, v in ms["split_records"].items()))
    return ms["split_records"]


def main() -> dict:
    import argparse
    ap = argparse.ArgumentParser(
        description="GPU smoke of h2o3_tpu_torch (see the module notes)")
    ap.add_argument("--other", metavar="DIR",
                    help="also time the kernels of the h2o3_tpu_torch "
                         "package under DIR in turns with this "
                         "checkout's (phases 6, 9, 12 and 13)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device: nothing to run")

    # ---------------------------------------------------------- 1 device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)                            # as nvidia-smi gives it
    log(f"device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    card = f"({smi})"

    from h2o3_tpu_torch import native
    from h2o3_tpu_torch.export.mojo import from_reference
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models import DRF, GLM, GridSearch, glm
    from h2o3_tpu_torch.models.tree import gbm, hist, shared
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    from h2o3_tpu_torch.runtime import config as cfgmod
    from h2o3_tpu_torch.runtime import observability as obs
    from h2o3_tpu_torch.serving import batcher, kernel
    from h2o3_tpu_torch.testing import same_bits

    # ----------------------------------------------------------- 2 build
    kernels = [kernel.TRAVERSE, hist.HIST, hist.SPLIT_RECORDS,
               hist.FINE_HIST, hist.SLOT_COMPACT]
    t0 = time.perf_counter()
    native.build_all(kernels)
    log(f"build: {len(kernels)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{k.name}]: {line.strip()}")
    for k in (hist.HIST, hist.FINE_HIST):
        ops = sass_atomics(k._lib_path(), native)
        cas = sum(v for op, v in ops.items() if ".CAS" in op)
        log(f"sass[{k.name}]: atomic opcodes (cuobjdump -sass, both code "
            f"widths) {ops}: {cas} compare-and-swap loop(s); the shared "
            f"64-bit adds are native 32-bit ATOMS.ADD pairs")
    for fn, (ops, back) in sorted(probe_sass(native).items()):
        log(f"sass probe {fn}: {ops}"
            + ("; a branch back (a loop)" if back else ""))
    kernels_train = [hist.HIST, hist.SPLIT_RECORDS, hist.SPLIT_RECORDS_ROWS,
                     hist.FINE_HIST, hist.HIST_WINDOWS, hist.SLOT_COMPACT]
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    # the histograms timed in turns (phases 12, 13): this checkout's
    # tiles, the tiles without copies, and another version if given
    variants = [("this", hist, None),
                ("one copy per tile", hist, one_copy(hist))]
    other = None
    if args.other:
        other = (f"other {args.other}",) + load_other(args.other)
        variants.append((other[0], other[1], None))

    # ---------------------------------------------------------- 3 models
    rng = np.random.default_rng(7)
    F, B = 32, 256
    models = {
        "binomial_300x10": from_reference(*serving_profile(300, 10, F, 1,
                                                           rng)),
        "multinomial_3x50x6": from_reference(*serving_profile(50, 6, F, 3,
                                                              rng)),
    }
    scorers = {k: kernel.PackedScorer(sm) for k, sm in models.items()}
    for k, ps in scorers.items():
        log(f"model {k}: {ps.packed.n_nodes} nodes, "
            f"{ps.packed.nbytes()} B of node planes, R="
            f"{ps.packed.roots.shape[0]}, depth {ps.depth}")

    # --------------------------------------------------------- 4 kernels
    max_err = 0.0
    for k, ps in scorers.items():
        planes = (*kernel.planes(ps._d_nodes), ps._d_roots)
        # the multinomial group also at more row tiles than a grid's y
        # dimension holds (65,535 x 8 rows)
        sizes = TRAVERSE_BATCHES + ((LARGE_BATCH,) if ps.n_class > 1
                                    else ())
        for rows in sizes:
            X = batch(rng, rows, F)
            Xd = torch.from_numpy(X).cuda()
            got = kernel.traverse(ps._d_nodes, ps._d_roots, Xd, ps.depth)
            want = kernel.traverse_torch(*planes, Xd, ps.depth)
            torch.cuda.synchronize()
            err = max_diff(got, want)
            max_err = max(max_err, err)
            if not same_bits(got, want):
                raise AssertionError(f"traverse kernel != plain on {k} "
                                     f"B={rows}: max|diff|={err:.3e}")
            if rows == LARGE_BATCH:
                continue
            out = ps.score(X, score_mode="check")
            if out.shape[0] != rows or not np.isfinite(out).all():
                raise AssertionError(f"{k}: bad scores {out.shape}")
        log(f"kernel check {k}: traverse bitwise equal to traverse_torch "
            f"at B = {sizes} (depth {ps.depth}); score_mode=check passed "
            f"at B = {TRAVERSE_BATCHES}")

    # ----------------------------------------------------------- 5 serve
    os.environ["H2O3_TPU_SERVE_TICK_MS"] = "1"
    os.environ["H2O3_TPU_SERVE_MAX_BATCH"] = str(B)
    cfgmod.reload()
    sm = models["binomial_300x10"]
    n_threads, per_thread = 8, 50
    Xr = batch(rng, n_threads * per_thread, F)
    reqs = [{f"x{i}": float(v) for i, v in enumerate(row)
             if not np.isnan(v)} for row in Xr]
    answers = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    errors = []

    def client(c):
        try:
            for j in range(c * per_thread, (c + 1) * per_thread):
                t = time.perf_counter()
                answers[j] = ent.predict_rows([reqs[j]])
                lat[j] = time.perf_counter() - t
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_threads)]
    serve_kernels = [kernel.TRAVERSE]      # the serving path's kernels
    for k in serve_kernels:
        k.launches = 0
    try:
        t_pub = time.perf_counter()
        ent = batcher.publish("smoke", sm)
        pub_s = time.perf_counter() - t_pub
        t_serve = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t_serve
        launches = {k.name: k.launches for k in serve_kernels}
        batcher_launches = ent.batcher.launches
    finally:
        batcher.shutdown_all()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")

    ref = sm.predict({f"x{i}": Xr[:, i] for i in range(F)})
    got_p = np.concatenate([a["probabilities"] for a in answers])
    got_l = np.concatenate([a["predict"] for a in answers])
    if not np.allclose(got_p, ref["probabilities"], rtol=1e-4, atol=1e-5):
        raise AssertionError("served probabilities diverge from the numpy "
                             "ScoringModel: max|diff|="
                             f"{np.abs(got_p - ref['probabilities']).max()}")
    if not (got_l == ref["predict"]).all():
        raise AssertionError("served labels diverge from the numpy "
                             "ScoringModel")
    for name_k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name_k} never launched on the "
                                 "serving path")
    if launches["traverse"] != batcher_launches:
        raise AssertionError(
            f"traverse launches {launches['traverse']} != batcher "
            f"launches {batcher_launches}")
    lat_ms = np.asarray(lat) * 1e3
    phases = {ph: obs.histogram("serve_latency_seconds", phase=ph)
              for ph in ("queue", "device", "total")}
    sizes = obs.histogram("serve_batch_size")
    mean_batch = sizes.sum / max(sizes.count, 1)
    log("serve breakdown: mean " + ", ".join(
        f"{ph} {h.sum / max(h.count, 1) * 1e3:.3f} ms"
        for ph, h in phases.items())
        + f" per request; mean batch {sizes.sum / max(sizes.count, 1):.2f}"
        " rows (queue = enqueue to launch, device = H2D + kernel + class "
        "sum/link + D2H, total = submit to answer)")
    log(f"serve: publish+warmup {pub_s:.3f} s; {len(reqs)} single-row "
        f"requests from {n_threads} threads in {wall:.3f} s = "
        f"{len(reqs) / wall:.1f} QPS; latency p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; {batcher_launches} batcher "
        f"launches = {launches['traverse']} traverse launches; every "
        f"answer matches the numpy ScoringModel {card}")

    # ----------------------------------------------------------- 6 times
    ps = scorers["binomial_300x10"]
    planes = (*kernel.planes(ps._d_nodes), ps._d_roots)
    Xd = torch.from_numpy(batch(rng, B, F)).cuda()
    ms = cuda_ms(lambda: kernel.traverse(ps._d_nodes, ps._d_roots, Xd,
                                         ps.depth))
    plain_ms = cuda_ms(lambda: kernel.traverse_torch(*planes, Xd,
                                                     ps.depth))
    score_ms = cuda_ms(lambda: ps.score_tensor(Xd))
    host_ms = cuda_ms(lambda: kernel.traverse(ps._d_nodes, ps._d_roots, Xd,
                                              ps.depth), spin=False)
    score_host_ms = cuda_ms(lambda: ps.score_tensor(Xd), spin=False)
    nbytes, steps, n_nodes = traverse_work(planes, Xd, ps.depth)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = steps / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"times at B={B}, R={planes[2].numel()}, depth {ps.depth} {card}, "
        f"median of {REPS}: device time: traverse kernel {ms:.4f} ms, "
        f"traverse_torch {plain_ms:.4f} ms, score_tensor (kernel + class "
        f"sum + link) {score_ms:.4f} ms; with the host's enqueue: "
        f"traverse {host_ms:.4f} ms, score_tensor {score_host_ms:.4f} ms; "
        f"bound {bound_ms:.6f} ms ({nbytes} B: {n_nodes} touched nodes x "
        f"8 B + roots + X + out, over 3.35 TB/s; {steps} f32 compares "
        f"over 67 TFLOP/s)")
    visits = B * planes[2].numel() + steps     # records a descent reads
    words = 2 * visits + B * planes[2].numel()
    log(f"traverse sectors at B={B}: {steps} internal steps of "
        f"{B * planes[2].numel()} (row, tree) descents; with trees on "
        f"lanes, two planes read {words} words, each in its own 32-B "
        f"sector: {words * 32 / 1e6:.1f} MB through L2 at most; one 8-B "
        f"record a step: {visits * 32 / 1e6:.1f} MB")
    traverse_turns(scorers, rng, F, mean_batch, kernel, other, card)

    traverse_row = {
        "name": "traverse", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/traverse.cu",
        "replaces": "h2o3_tpu/serving/kernel.py:68",
        "launches": launches["traverse"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }

    mark("phases 1-6")
    # ------------------------------------------------- 7 train kernels
    dev = torch.device("cuda")
    cols, types, domains = make_airlines_like(1_000_000)
    fr1 = Frame.from_numpy(cols, types=types, domains=domains)
    hv, sr = capture_levels(fr1, XGBoost, hist)
    kdiff = check_train_kernels(hv, sr, hist, dev)

    # ---------------------------------------------------------- 8 train
    _, tlaunch, ntrees, exact_auc = train_phase(
        cols, types, domains, kernels_train, XGBoost, Frame, batcher, hist,
        card)
    if tlaunch["fine_hist"] != 0:
        raise AssertionError("the exact search launched fine_hist")

    # ---------------------------------------------------- 9 train times
    tot = time_train_kernels(hv, sr, hist, "1M rows")
    per_tree = {k: tlaunch[k] / ntrees for k in tlaunch}
    log(f"train times per tree at 1M rows (sum of the {len(hv)} level "
        f"launches) {card}: " + "; ".join(
            f"{k} {v[0]:.4f} ms (plain {v[1]:.4f}, bound {v[2]:.5f}"
            + (f", index_add_ {v[3]:.4f})" if k != "split_records" else ")")
            for k, v in tot.items())
        + f"; launches per tree {per_tree}")
    rows = []
    for kname, src, rep, lib in (
            ("hist", "h2o3_tpu_torch/csrc/hist.cu",
             "h2o3_tpu/models/tree/hist.py:256; "
             "h2o3_tpu/models/tree/hist.py:80", True),
            ("split_records", "h2o3_tpu_torch/csrc/split_records.cu",
             "h2o3_tpu/models/tree/hist.py:1526", False)):
        v = tot[kname]
        bnd = v[2]                       # the sum of the levels' bounds
        _, by = bound(v[4], v[5])
        rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": rep, "launches": tlaunch[kname],
            "max_abs_err": kdiff[kname],
            "ms": v[0], "plain_ms": v[1], "bound_ms": bnd, "bound_by": by,
            "library_ms": v[3] if lib else None,
        })
    if other:
        rec_pair = [("this", hist), (other[0], other[1])]
        records_turns(sr, rec_pair, "1M rows", card)
    del sr

    mark("phases 7-9")
    # ------------------------------------------------- 10 hier kernels
    fh, hu = capture_hier_levels(fr1, XGBoost, hist)
    kdiff.update(check_hier_kernels(fh, hu, hist, dev))

    # ---------------------------------------------------- 11 hier train
    hlaunch, hntrees = train_hier_phase(fr1, cols, kernels_train, XGBoost,
                                        batcher, hist, fh[0][0], exact_auc,
                                        card)

    # ---------------------------------------------------- 12 hier times
    htot = time_hier_kernels(fh, hu, hist, "1M rows")
    log(f"hier times per tree at 1M rows (sum of the {len(fh)} level "
        f"launches) {card}: " + "; ".join(
            f"{k} {v[0]:.4f} ms (plain {v[1]:.4f}, bound {v[2]:.5f}, "
            f"index_add_ {v[3]:.4f})" for k, v in htot.items())
        + f"; launches per tree "
        f"{ {k: v / hntrees for k, v in hlaunch.items()} }")
    v = htot["fine_hist"]
    rows.append({
        "name": "fine_hist", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/fine_hist.cu",
        "replaces": "h2o3_tpu/models/tree/hist.py:1130",
        "launches": hlaunch["fine_hist"], "max_abs_err": kdiff["fine_hist"],
        "ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
        "bound_by": bound(v[4], v[5])[1], "library_ms": v[3],
    })
    v = htot["coarse hist"]
    rows.append({
        "name": "hist (hier coarse pass)", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/hist.cu",
        "replaces": "h2o3_tpu/models/tree/hist.py:80",
        "launches": hlaunch["hist"], "max_abs_err": kdiff["coarse hist"],
        "ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
        "bound_by": bound(v[4], v[5])[1], "library_ms": v[3],
    })
    log_turns(hv, hu, fh, variants, "1M rows", card)
    del hv, fh, hu
    cols1 = cols

    mark("phases 10-12")
    # ------------------------------------------ 14 multinomial kernels
    mcols, frm1 = multi_frame(1_000_000, Frame)
    mhv, msr = capture_multi_levels(frm1, XGBoost, hist)
    kdiff["hist (K-batched)"] = check_multi_kernels(mhv, msr, hist, dev)
    del msr

    # --------------------------------------------- 15 multinomial train
    mlaunch = train_multi_phase(
        frm1, mcols, kernels_train, XGBoost, batcher, hist, card)
    mtot = time_multi_kernels(mhv, hist, "1M rows", card)
    rows.append({
        "name": f"hist (K-batched, K={K_CLASSES})", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/hist.cu",
        "replaces": "h2o3_tpu/models/tree/hist.py:637 (vmapped "
                    "h2o3_tpu/models/tree/hist.py:256; "
                    "h2o3_tpu/models/tree/hist.py:80)",
        "launches": mlaunch["hist"], "max_abs_err": kdiff["hist (K-batched)"],
        "ms": mtot[0], "plain_ms": mtot[1], "bound_ms": mtot[2],
        "bound_by": bound(mtot[4], mtot[5])[1], "library_ms": mtot[3],
    })
    del mhv, frm1, mcols

    mark("phases 14-15")
    # ------------------------------------------------- 17 grid kernels
    gsr = capture_grid_records(fr1, GridSearch, XGBoost, hist)
    kdiff["split_records (per-row)"] = check_grid_records(gsr, hist, dev)

    mark("phase 17")
    # ---------------------------------------------------- 18 grid train
    glaunch = grid_train_phase(fr1, cols1, kernels_train, GridSearch,
                               XGBoost, batcher, hist, card)
    gtot = time_grid_records(gsr, hist, "1M rows", card)
    rows.append({
        "name": "split_records (per-row)", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/split_records.cu",
        "replaces": "h2o3_tpu/models/tree/hist.py:1526 (per_row=True)",
        "launches": glaunch["split_records (per-row)"],
        "max_abs_err": kdiff["split_records (per-row)"],
        "ms": gtot[0], "plain_ms": gtot[1], "bound_ms": gtot[2],
        "bound_by": bound(gtot[3], gtot[4])[1], "library_ms": None,
    })
    del gsr, fr1, cols1

    mark("phase 18")
    # ------------------------------------- 20-21 slot levels, DRF train
    slot = slot_phases(DRF, Frame, hist, shared, batcher, kernels_train,
                       dev, card)
    # ----------------------------------------------------- 13 headlines
    t0 = time.perf_counter()
    cols, types, domains = make_airlines_like(10_000_000)
    fr10 = Frame.from_numpy(cols, types=types, domains=domains)
    if other:
        import importlib
        opkg = other[1].__name__.split(".")[0]
        OXGBoost = importlib.import_module(
            f"{opkg}.models.tree.xgboost").XGBoost
        ofr10 = importlib.import_module(f"{opkg}.frame").Frame.from_numpy(
            cols, types=types, domains=domains)
    del cols
    torch.cuda.synchronize()
    log(f"headline frame: {fr10.nrows} rows made and on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # the exact headline; given another version, in turns with its train
    # (this, other, other, this)
    heads = [("", XGBoost, fr10)]
    if other:
        heads.append((f" [{other[0]}]", OXGBoost, ofr10))
        heads += heads[::-1]
    tps = {}
    for tag, xgb, frame in heads:
        tps.setdefault(tag, []).append(headline(xgb, frame, card, "auto",
                                                tag))
    exact_tps = float(np.mean(tps[""]))
    if other:
        log(f"exact headline in turns {card}: " + "; ".join(
            f"{tag.strip(' []') or 'this'} " + " and ".join(
                f"{v:.3f}" for v in t) + " trees/s"
            for tag, t in tps.items()))
        del ofr10
    hier_tps = headline(XGBoost, fr10, card, "hier")
    log(f"headlines at {fr10.nrows} rows {card}: exact search "
        f"{exact_tps:.3f} trees/s, hierarchical search {hier_tps:.3f} "
        f"trees/s")
    # the kernels per 10M-row tree, with CUDA events: one captured tree
    # of each search
    hv10, sr10 = capture_levels(fr10, XGBoost, hist)
    check_records(sr10, hist, "10M-row")
    tot10 = time_train_kernels(hv10, sr10, hist, "10M rows")
    if other:
        records_turns(sr10, rec_pair, "10M rows", card)
    del sr10
    fh10, hu10 = capture_hier_levels(fr10, XGBoost, hist)
    htot10 = time_hier_kernels(fh10, hu10, hist, "10M rows")
    log(f"kernel times per 10M-row tree (CUDA events, sum of the 6 level "
        f"launches of one captured tree) {card}: " + "; ".join(
            f"{k} {v[0]:.4f} ms (plain {v[1]:.4f}, bound {v[2]:.5f}"
            + (f", index_add_ {v[3]:.4f})" if k != "split_records" else ")")
            for k, v in list(tot10.items()) + list(htot10.items())))
    log_turns(hv10, hu10, fh10, variants, "10M rows", card)
    del hv10, fh10, hu10

    mark("phase 13")
    # ---------------------------------------- 16 multinomial headline
    _, frm10 = multi_frame(10_000_000, Frame)
    mh = headline_multi(XGBoost, frm10, card)
    mhv10, _ = capture_multi_levels(frm10, XGBoost, hist)
    del frm10
    mtot10 = time_multi_kernels(mhv10, hist, "10M rows", card)
    del mhv10
    (rps, ops, idle), (srps, sops, sidle) = mh["fused"], mh["separate"]
    log(f"multinomial headline at 10M rows {card}: batched "
        f"{K_CLASSES * rps:.3f} trees/s ({rps:.3f} rounds/s, {ops:g} device "
        f"ops per round, idle share {idle:.3f}); K loop "
        f"{K_CLASSES * srps:.3f} trees/s ({srps:.3f} rounds/s, {sops:g} "
        f"ops per round, idle share {sidle:.3f}); K-batched hist "
        f"{mtot10[0]:.4f} ms per round against {mtot10[6]:.4f} ms for "
        f"{K_CLASSES} single launches (bound {mtot10[2]:.5f})")

    mark("phase 16")
    # ------------------------------------------------ 19 grid headline
    gtps, gops, gidle, wave_tps = headline_grid(GridSearch, XGBoost, fr10,
                                                card)
    gsr10 = capture_grid_records(fr10, GridSearch, XGBoost, hist)
    del fr10
    check_records(gsr10, hist, "10M-row grid")
    gtot10 = time_grid_records(gsr10, hist, "10M rows", card)
    del gsr10
    log(f"grid headline at 10M rows {card}: cohort of "
        f"{len(combos(GRID_HP))} {gtps:.3f} member trees/s ({gops:g} device "
        f"ops per round, idle share {gidle:.3f}); wave path {wave_tps:.3f} "
        f"trees/s; per-row split_records {gtot10[0]:.4f} ms per round "
        f"(bound {gtot10[2]:.6f}, plain {gtot10[1]:.4f}); "
        f"{time.perf_counter() - T_START:.1f} s since the script started")

    mark("phase 19")
    # ------------------------------------------------ 22 DRF headline
    rows += slot_headline(DRF, Frame, hist, shared, card, slot)
    mark("phase 22")
    # --------------------------- 23-27 file import, DT, IF/EIF, uplift
    import_phases(Frame, XGBoost, hist, batcher, kernels_train, card)
    # ------------------------------------------------ 28-32 DART, GLM
    dart_glm_phases(Frame, XGBoost, GLM, glm, gbm, hist, kernel, batcher,
                    from_reference, kernels_train, card)

    return {"kernels": [traverse_row] + rows, "device": device}


if __name__ == "__main__":
    try:
        result = main()
    except SystemExit:
        raise
    except BaseException:               # noqa: BLE001 — any phase fails
        traceback.print_exc()
        sys.exit(1)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": result["device"]}))
