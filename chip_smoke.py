#!/usr/bin/env python3
"""GPU smoke of h2o3_tpu_torch: the quickest proof that the port starts
on a CUDA card and serves through its own kernels.

Phases (any failure exits non-zero and prints no result line):

1. device  — the card's name and power limit (nvidia-smi) and torch's name;
2. build   — every CUDA kernel of the port, one nvcc per source, all
             started together, from the sources in this checkout;
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
             operations over 67 TFLOP/s: the H100 SXM data sheet).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py        (one CUDA card, nvcc on PATH or
                                     under $CUDA_HOME/bin)
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


def main() -> dict:
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
    from h2o3_tpu_torch.runtime import config as cfgmod
    from h2o3_tpu_torch.runtime import observability as obs
    from h2o3_tpu_torch.serving import batcher, kernel

    # ----------------------------------------------------------- 2 build
    kernels = [kernel.TRAVERSE]
    t0 = time.perf_counter()
    native.build_all(kernels)
    log(f"build: {len(kernels)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{k.name}]: {line.strip()}")

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
    for k in kernels:
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
        launches = {k.name: k.launches for k in kernels}
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

    return {
        "kernels": [{
            "name": "traverse", "route": "cuda",
            "source": "h2o3_tpu_torch/csrc/traverse.cu",
            "replaces": "h2o3_tpu/serving/kernel.py:68",
            "launches": launches["traverse"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }],
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
