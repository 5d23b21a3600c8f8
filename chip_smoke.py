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
4. kernels — each kernel's wrapper against its plain torch version on
             the card at the shapes the serving path gives it (B=256,
             2% NaN cells): bitwise equal leaves, and score_mode="check"
             against the numpy ScoringModel;
5. serve   — launch counts set to 0, then publish("smoke", model) and
             8 client threads x 50 single-row predict_rows requests
             through the MicroBatcher (max_batch=256, tick 1 ms); every
             answer is checked against the numpy ScoringModel, and the
             kernel's launch count must equal the batcher's launches;
6. times   — each kernel and its plain version timed with CUDA events
             (median of 50 launches) beside the least time the card
             could take for the same work (bytes over 3.35 TB/s, f32
             operations over 67 TFLOP/s: the H100 SXM data sheet);
7. train kernels — on the bench frame (``make_airlines_like``, the draws
             of bench.py) at 1,000,000 rows, the level inputs of one tree
             are captured; ``hist_uniform``, ``hist_varbin`` and
             ``split_records`` are held against their plain versions on
             them (and on a ragged row count and L = 1, 8, 32):
             the fixed-point histograms bitwise on integer-valued stats
             and on the real bernoulli stats, a second launch bitwise the
             first, each plane within 1e-5 of its total from this
             script's own f64 sums (the distance printed); records
             bitwise;
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
             the exact and then the hierarchical search: a 20-tree
             warmup train, then trees/s of a 50-tree train, with a
             torch.profiler breakdown of a 10-tree train and the host's
             cost of one small torch op before and after (``host_op_us``),
             which with the device operations per tree bounds the wall a
             launch-bound train can reach; then the kernel times of both
             searches (CUDA events) on a captured 10M-row tree of each.

Phases 12 and 13 also time the three histogram paths of their captured
trees (1M and 10M rows) in turns with the tiles without copies (which
must give the same sums) and, given ``--other DIR``, with the histogram
kernels of the h2o3_tpu_torch package under DIR.

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--other DIR]   (one CUDA card, nvcc on
                                              PATH or under $CUDA_HOME/bin)

e.g. ``mkdir _ab_old && git archive <rev> h2o3_tpu_torch | tar -x -C
_ab_old`` and ``--other _ab_old`` times that version's histograms.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
REPS = 50
SPIN_CYCLES = 20_000_000         # ~10 ms of device clock


def log(msg: str) -> None:
    print(msg, flush=True)


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


def same_bits(a, b) -> bool:
    """Bitwise equal f32 tensors (NaNs with the same bits included)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def dense_plane(h, s):
    return h[s]


def packed_plane(h, s):
    return h[:, s::3]


def capture_levels(fr, XGBoost, hist):
    """Train one tree with the histogram and records wrappers watched:
    the inputs each level gave ``hist_varbin`` (with the tree's
    fixed-point scale) and ``split_records``."""
    hv, sr = [], []
    real_hv, real_sr = hist.hist_varbin, hist.split_records

    def spy_hv(gcodes, leaf, stats, L, bc, B, scale=None):
        hv.append((gcodes.clone(), leaf.clone(), stats.clone(), L,
                   tuple(bc), B, scale))
        return real_hv(gcodes, leaf, stats, L, bc, B, scale)

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


def train_plain(fr, XGBoost, hist, ntrees, **extra):
    """The same train with ``hist_varbin``, ``hist_uniform``,
    ``split_records`` and ``fine_hist`` swapped for plain torch on the
    card: the route the kernels' training is held against.  Its
    histograms are this script's own f64 ``index_add_`` (``f64_uniform``,
    ``f64_varbin``, ``f64_fine``) rounded to f32, not the port's
    fixed-point plain versions: an oracle independent of the arithmetic
    under test."""
    real = (hist.hist_varbin, hist.hist_uniform, hist.split_records,
            hist.fine_hist)

    def varbin(gcodes, leaf, stats, L, bc, B, scale=None):
        return f64_varbin(gcodes, leaf, stats, L,
                          hist.packed_layout(tuple(bc), B)).float()

    def uniform(codes, leaf, stats, L, B, planes=3, scale=None):
        return f64_uniform(codes, leaf, stats, L, B, planes).float()

    def records(Hist, nbins, *args):
        return hist._split_records_torch(Hist, *args)

    def fine(codes, leaf, stats, sel, W, nbins, scale=None):
        return f64_fine(codes, leaf, stats, sel, W, nbins).float()

    (hist.hist_varbin, hist.hist_uniform, hist.split_records,
     hist.fine_hist) = varbin, uniform, records, fine
    try:
        return XGBoost(ntrees=ntrees, **BENCH_CFG, **extra).train(fr)
    finally:
        (hist.hist_varbin, hist.hist_uniform, hist.split_records,
         hist.fine_hist) = real


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
    for i, (H, nbins_, args) in enumerate(sr):
        for Hc, what in ((H, "real"), (H.round(), "integer-valued")):
            got = hist.split_records(Hc, nbins_, *args)
            want = hist._split_records_torch(Hc, *args)
            torch.cuda.synchronize()
            kdiff["split_records"] = max(kdiff["split_records"],
                                         max_diff(got, want))
            if not torch.equal(got, want):
                a = got.view(torch.int32).long()
                b = want.view(torch.int32).long()
                ulp = int((a - b).abs().max())
                raise AssertionError(
                    f"split_records != plain on {what} H at level {i}: "
                    f"max {ulp} ulp")
    log(f"kernel check split_records: bitwise equal to its plain version "
        f"on the {len(sr)} captured levels' H and on their integer-valued "
        f"rounding")
    return kdiff


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
                                                       layout, sc), reps=20)
        ums = cuda_ms(lambda: hist.hist_uniform(raw, leaf, st, L, B,
                                                scale=sc))
        uplain = cuda_ms(lambda: hist.hist_uniform_torch(
            raw, leaf, st, L, B, scale=sc), reps=20)
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
        lib = cuda_ms(lambda: out.index_add_(0, idx, src))
        uidx = ((lf[None, :] * F + torch.arange(F, device=g.device)[:, None])
                * B + raw.long())[ok]
        uout = torch.zeros((3, L * F * B), dtype=torch.int64,
                           device=g.device)
        usrc = qs[:, None, :].expand(3, F, -1)[:, ok]
        ulib = cuda_ms(lambda: uout.index_add_(1, uidx, usrc))
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

    publish_check("trained-xgboost", m, fr, cols, batcher, p_k)
    return fr, launches, ntrees, auc_k


def check_deterministic(m, m2, search):
    """A second kernel train must give bitwise the first one's trees
    (feature, threshold, NA direction, valid at every level) and leaf
    values: the histograms sum in int64 fixed point, so nothing on the
    path depends on the order of the atomics."""
    import torch
    a, b = m.output["stacked"], m2.output["stacked"]
    for d, (lv1, lv2) in enumerate(zip(a.levels, b.levels)):
        for nm, x, y in zip(("feat", "thr", "na_left", "valid"), lv1, lv2):
            same = same_bits(x, y) if x.is_floating_point() \
                else torch.equal(x, y)
            if not same:
                raise AssertionError(
                    f"{search} search: a second kernel train differs on "
                    f"{nm} at level {d}")
    if not same_bits(a.values, b.values):
        raise AssertionError(f"{search} search: a second kernel train gave "
                             f"other leaf values")
    log(f"determinism {search}: a second kernel train gave bitwise "
        f"identical trees and leaf values ({a.ntrees} trees x "
        f"{a.depth} levels)")


def publish_check(name, m, fr, cols, batcher, p_k):
    """Publish ``m`` into the serving plane; 256 rows answered by
    ``predict_rows`` must equal ``m.predict``."""
    rows = []
    for i in range(256):
        r = {}
        for k, v in cols.items():
            if k in ("carrier", "origin", "dest"):
                r[k] = str(int(v[i]))
            elif k != "dep_delayed_15min":
                r[k] = float(v[i])
        rows.append(r)
    try:
        ent = batcher.publish(name, m)
        ans = ent.predict_rows(rows)
    finally:
        batcher.shutdown_all()
    if not np.allclose(ans["probabilities"][:, 1], p_k[:256], rtol=1e-5,
                       atol=1e-7):
        raise AssertionError(f"published model {name}'s answers differ "
                             "from m.predict")
    labels = m.predict(fr).vec("predict").to_numpy()[:256]
    if not (ans["predict"] == np.asarray(["NO", "YES"],
                                         dtype=object)[labels]).all():
        raise AssertionError(f"published model {name}'s labels differ")
    log(f"publish: the trained model {name}, published through "
        "to_archive, answered 256 rows equal to m.predict (rtol 1e-5)")


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


def headline(XGBoost, fr, card, search):
    """Phase 13: the bench protocol at 10M rows with ``split_search =
    search``, and a profile."""
    import torch
    n = fr.nrows
    probe_us = host_op_us()
    cfg = dict(BENCH_CFG, split_search=search)
    t0 = time.perf_counter()
    XGBoost(ntrees=20, **cfg).train(fr)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = XGBoost(ntrees=50, **cfg).train(fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"headline {search}: bench_trees protocol, {n} rows, "
        f"XGBoost(max_depth=6, nbins=256, split_search={search!r}): "
        f"20-tree warmup {warm:.3f} s, then 50 trees in {dt:.3f} s = "
        f"{50 / dt:.3f} trees/s; training AUC "
        f"{m.training_metrics.auc:.6f} {card}")
    from torch.profiler import ProfilerActivity, profile
    nprof = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        XGBoost(ntrees=nprof, **cfg).train(fr)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        log(f"profile {search}: no device time in the trace: not "
            "measured")
    else:
        # the profiler slows the host, so the wall time per tree is the
        # unprofiled 50-tree train's; binning runs once in each train
        wall_tree = dt / 50 * 1e3
        per_tree = sum(e.count for e in kern) / nprof
        probe_after = host_op_us()
        kern.sort(key=lambda e: -e.self_device_time_total)
        log(f"host {search}: {per_tree:g} device operations per tree; a "
            f"small torch op costs the host {probe_us:.2f} us before the "
            f"headline and {probe_after:.2f} us after it, so the launches "
            f"alone hold a tree for {per_tree * probe_us / 1e3:.2f}-"
            f"{per_tree * probe_after / 1e3:.2f} ms of its "
            f"{wall_tree:.2f} ms of wall")
        log(f"profile {search} of a {nprof}-tree train at {n} rows: "
            f"device busy "
            f"{busy / nprof:.2f} ms per tree against {wall_tree:.2f} ms of "
            f"wall per tree unprofiled: idle share "
            f"{max(0.0, 1 - busy / nprof / wall_tree):.3f}; device ms per "
            f"tree by kernel (launches per tree): " + "; ".join(
                f"{e.key[:110]} {e.self_device_time_total / 1e3 / nprof:.3f}"
                f" ({e.count / nprof:g})" for e in kern[:14]))
    return 50 / dt

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

    def spy_hu(codes, leaf, stats, L, B, planes=3, scale=None):
        hu.append((codes, leaf, stats, L, B, scale))
        return real_hu(codes, leaf, stats, L, B, planes, scale)

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
            "split_records": 0}
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
    publish_check("trained-xgboost-hier", m, fr, cols, batcher, p_k)

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
                                                     nbins, sc), reps=10)
        idx, ok = hist.fine_slots(c, leaf, sel, W, nbins)
        fidx = idx[ok]
        src = hist.quantize(st, sc)[:, None, None, :].expand(
            3, F, K, -1)[:, ok]
        out = torch.zeros((3, Lf * F * K * W), dtype=torch.int64,
                          device=c.device)
        lib = cuda_ms(lambda: out.index_add_(1, fidx, src))
        del idx, ok, src
        nbytes, ops = work_fine(c, leaf, sel, W, nbins, hist)
        bnd, _ = bound(nbytes, ops)
        cms = cuda_ms(lambda: hist.hist_uniform(cc, pl, cst, L, B,
                                                scale=csc))
        cplain = cuda_ms(lambda: hist.hist_uniform_torch(cc, pl, cst, L, B,
                                                         scale=csc), reps=10)
        lf = pl.long()
        cok = ((lf >= 0) & (lf < L))[None, :].expand_as(cc)
        cidx = ((lf[None, :] * F + torch.arange(F, device=c.device)[:, None])
                * B + cc.long())[cok]
        cout = torch.zeros((3, L * F * B), dtype=torch.int64,
                           device=c.device)
        csrc = hist.quantize(cst, csc)[:, None, :].expand(3, F, -1)[:, cok]
        clib = cuda_ms(lambda: cout.index_add_(1, cidx, csrc))
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



def load_other(path: str):
    """Another version of the ``h2o3_tpu_torch`` package, the one under
    ``path`` (e.g. ``git archive <rev> h2o3_tpu_torch`` unpacked where
    .gitignore lists it), imported as ``other_h2o3_tpu_torch`` with its
    own sources and build directory; returns its tree ``hist`` module,
    its histogram kernels built."""
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
    importlib.import_module(f"{name}.native").build_all(
        [other.HIST, other.FINE_HIST])
    return other


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


def hist_turns(hv, hu, fh, variants, reps=30):
    """Device ms per tree (the sum of its captured level launches) of the
    three histogram paths, ``hist_varbin`` on the exact levels ``hv`` and
    the coarse ``hist_uniform`` and ``fine_hist`` on the hier levels
    ``hu``, ``fh``, under each variant in turns: every launch timed
    (``cuda_ms``) under the variants in order, then in reverse order
    (A, B, B, A for two), the two passes averaged.  ``variants`` are (tag,
    hist module, setup or None); ``setup()`` swaps the variant in and
    returns its undo.  A version's wrapper gets the tree's fixed-point
    scale where it takes one.  Returns ({path: {tag: ms}}, {path: {tag:
    max|diff| from the first variant's sums}})."""
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
    ms, diff, first = {}, {}, {}
    for tag, mod, setup in list(variants) + list(reversed(variants)):
        undo = setup() if setup else None
        try:
            for i, (path, make) in enumerate(launches):
                fn = make(mod)
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


def main() -> dict:
    import argparse
    ap = argparse.ArgumentParser(
        description="GPU smoke of h2o3_tpu_torch (see the module notes)")
    ap.add_argument("--other", metavar="DIR",
                    help="also time the histogram kernels of the "
                         "h2o3_tpu_torch package under DIR in turns with "
                         "this checkout's (phases 12 and 13)")
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
    from h2o3_tpu_torch.models.tree import hist
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    from h2o3_tpu_torch.runtime import config as cfgmod
    from h2o3_tpu_torch.runtime import observability as obs
    from h2o3_tpu_torch.serving import batcher, kernel

    # ----------------------------------------------------------- 2 build
    kernels = [kernel.TRAVERSE, hist.HIST, hist.SPLIT_RECORDS,
               hist.FINE_HIST]
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
    # the histograms timed in turns (phases 12, 13): this checkout's
    # tiles, the tiles without copies, and another version if given
    variants = [("this", hist, None),
                ("one copy per tile", hist, one_copy(hist))]
    if args.other:
        variants.append((f"other {args.other}", load_other(args.other),
                         None))

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
        for rows in (B, 37):            # full buffer, ragged last tile
            X = batch(rng, rows, F)
            Xd = torch.from_numpy(X).cuda()
            planes = (ps._d_i32, ps._d_f32, ps._d_roots)
            got = kernel.traverse(*planes, Xd, ps.depth)
            want = kernel.traverse_torch(*planes, Xd, ps.depth)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise AssertionError(f"traverse kernel != plain on {k} "
                                     f"B={rows}: max|diff|={err:.3e}")
            out = ps.score(X, score_mode="check")
            if out.shape[0] != rows or not np.isfinite(out).all():
                raise AssertionError(f"{k}: bad scores {out.shape}")
        log(f"kernel check {k}: traverse bitwise equal to traverse_torch "
            f"(B={B} and B=37); score_mode=check passed")

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
    planes = (ps._d_i32, ps._d_f32, ps._d_roots)
    Xd = torch.from_numpy(batch(rng, B, F)).cuda()
    ms = cuda_ms(lambda: kernel.traverse(*planes, Xd, ps.depth))
    plain_ms = cuda_ms(lambda: kernel.traverse_torch(*planes, Xd,
                                                     ps.depth))
    score_ms = cuda_ms(lambda: ps.score_tensor(Xd))
    host_ms = cuda_ms(lambda: kernel.traverse(*planes, Xd, ps.depth),
                      spin=False)
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

    traverse_row = {
        "name": "traverse", "route": "cuda",
        "source": "h2o3_tpu_torch/csrc/traverse.cu",
        "replaces": "h2o3_tpu/serving/kernel.py:68",
        "launches": launches["traverse"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }

    # ------------------------------------------------- 7 train kernels
    dev = torch.device("cuda")
    cols, types, domains = make_airlines_like(1_000_000)
    fr1 = Frame.from_numpy(cols, types=types, domains=domains)
    hv, sr = capture_levels(fr1, XGBoost, hist)
    kdiff = check_train_kernels(hv, sr, hist, dev)

    # ---------------------------------------------------------- 8 train
    kernels_train = [hist.HIST, hist.SPLIT_RECORDS, hist.FINE_HIST]
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
    del sr

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
    del hv, fh, hu, fr1

    # ----------------------------------------------------- 13 headlines
    t0 = time.perf_counter()
    cols, types, domains = make_airlines_like(10_000_000)
    fr10 = Frame.from_numpy(cols, types=types, domains=domains)
    del cols
    torch.cuda.synchronize()
    log(f"headline frame: {fr10.nrows} rows made and on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    exact_tps = headline(XGBoost, fr10, card, "auto")
    hier_tps = headline(XGBoost, fr10, card, "hier")
    log(f"headlines at {fr10.nrows} rows {card}: exact search "
        f"{exact_tps:.3f} trees/s, hierarchical search {hier_tps:.3f} "
        f"trees/s")
    # the kernels per 10M-row tree, with CUDA events: one captured tree
    # of each search
    hv10, sr10 = capture_levels(fr10, XGBoost, hist)
    tot10 = time_train_kernels(hv10, sr10, hist, "10M rows")
    del sr10
    fh10, hu10 = capture_hier_levels(fr10, XGBoost, hist)
    del fr10
    htot10 = time_hier_kernels(fh10, hu10, hist, "10M rows")
    log(f"kernel times per 10M-row tree (CUDA events, sum of the 6 level "
        f"launches of one captured tree) {card}: " + "; ".join(
            f"{k} {v[0]:.4f} ms (plain {v[1]:.4f}, bound {v[2]:.5f}"
            + (f", index_add_ {v[3]:.4f})" if k != "split_records" else ")")
            for k, v in list(tot10.items()) + list(htot10.items())))
    log_turns(hv10, hu10, fh10, variants, "10M rows", card)
    del hv10, fh10, hu10

    return {
        "kernels": [traverse_row] + rows,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }


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
