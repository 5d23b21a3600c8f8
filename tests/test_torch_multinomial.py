"""h2o3_tpu_torch's multinomial path held against the JAX package and
against its own K loop.

A multinomial round grows K class trees.  The port grows them as one
batched build: one histogram launch (``hist.make_batched_level_fn``, the
K axis of ``csrc/hist.cu``) and one records launch
(``hist.fused_best_splits_batched``) per level for all K trees.  The same
numpy inputs from one seed go through the JAX function and its port: the
K-batched histograms (against the JAX package's vmapped Pallas kernels in
interpret mode), the batched records, and an XGBoost and a GBM trained by
both packages on the airlines-shaped bench frame with the 3-class
``delay_class`` response.  The batched level and the batched train are
also held bitwise against the port's own K loop of single-tree builds,
with row and column sampling on.  All of it runs on the CPU, where the
port's kernel wrappers take their plain torch versions.

Tolerances, as in tests/test_torch_training.py: the JAX side sums in f32
over the suite's 8-device CPU mesh, so histograms agree bitwise with it
only on integer-valued stats, and to 1e-5 of each plane's L1 norm
otherwise; trees agree where every winning gain clears its runner-up by
more than 1e-3 (checked), leaf values and probabilities to rtol 1e-4.
Inside the port everything is bitwise: its histograms are exact int64
sums on each tree's own fixed-point scale.
"""

import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.metrics import core as jmetrics
from h2o3_tpu.models import GBM as JGBM
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models.tree import hist as jhist
from h2o3_tpu.models.tree import shared as jshared

from bench import make_airlines_like

from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.metrics import core as metrics
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.binning import edges_matrix, fit_bins
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.runtime import config
from h2o3_tpu_torch.serving import batcher
from h2o3_tpu_torch.testing import delay_class, same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

K = 3
# the slice's frame: 3,264 rows (a multiple of the JAX mesh's 64-row
# padding), chosen because every split of both 5-round models wins by a
# clear gain margin (test_slice_trees_match_jax checks it): at 3,904 rows
# one XGBoost level-3 node has two features within 7e-4 of the gain
N_SLICE = 3264
_XGB = dict(response_column="delay_class",
            ignored_columns=["dep_delayed_15min"], max_depth=4, nbins=32,
            seed=1, ntrees=5, score_tree_interval=10 ** 9)
# GBM's defaults (no lambda, learn_rate 0.1) leave nodes whose best gain
# is f32 noise of about 1e-5, just above the default improvement of 1e-5;
# a threshold of 1e-3 keeps the splits with signal only
_GBM = dict(_XGB, ntrees=3, min_split_improvement=1e-3)


def _stats(rng, n, integer, lead=()):
    if integer:
        return np.stack([rng.integers(-3, 4, (*lead, n)),
                         rng.integers(0, 3, (*lead, n)),
                         rng.integers(0, 2, (*lead, n))],
                        axis=len(lead)).astype(np.float32)
    p = rng.random((*lead, n)).astype(np.float32)
    return np.stack([p - (rng.random((*lead, n)) < 0.4), p * (1 - p),
                     rng.random((*lead, n)) < 0.9],
                    axis=len(lead)).astype(np.float32)


def _close(got, want, integer):
    """Bitwise on integer-valued stats, else each (tree, plane) to 1e-5
    of its L1 norm."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
        return
    for k in range(want.shape[0]):
        for s in range(want.shape[1]):
            scale = max(float(np.abs(want[k, s]).sum()), 1.0)
            assert float(np.abs(got[k, s] - want[k, s]).max()) \
                <= 1e-5 * scale


def _codes(rng, n, nbins, bin_counts):
    return np.stack([np.where(rng.random(n) < 0.1, nbins,
                              rng.integers(0, bc, n))
                     for bc in bin_counts]).astype(np.int32)


# --------------------------------------------- (a) the K-batched histograms

@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("layout", ["uniform", "varbin"])
@pytest.mark.parametrize("d", [0, 2])
def test_batched_hist_plain_vs_single_and_jax(d, layout, integer):
    """The K-batched plain histograms (L = 1 and 4, K = 3) are bitwise K
    single-tree calls, and match the JAX package's vmapped Pallas kernel
    (``make_batched_level_fn(subtract=False)`` in interpret mode)."""
    n, F, nbins = 2048, 5, 64
    B = nbins + 1
    L = 2 ** d
    rng = np.random.default_rng(3 * d + 7 * integer + (layout == "varbin"))
    bc = (7, nbins, 22, 3, nbins - 5)
    codes = _codes(rng, n, nbins, bc)
    leaf = rng.integers(0, L, (K, n)).astype(np.int32)
    st = _stats(rng, n, integer, (K,))
    tcodes = torch.from_numpy(codes)
    tleaf, tst = torch.from_numpy(leaf), torch.from_numpy(st)
    if layout == "varbin":
        gc = hist.offset_codes(tcodes, bc, nbins)
        packed = hist.hist_varbin(gc, tleaf, tst, L, bc, B)
        assert packed.shape[0] == K
        for k in range(K):
            assert same_bits(packed[k], hist.hist_varbin(gc, tleaf[k],
                                                         tst[k], L, bc, B))
        got = hist.expand_varbin(packed, bc, L, B)
        jcodes = jhist.offset_codes(jnp.asarray(codes), bc, nbins)
    else:
        got = hist.hist_uniform(tcodes, tleaf, tst, L, B)
        for k in range(K):
            assert same_bits(got[k], hist.hist_uniform(tcodes, tleaf[k],
                                                       tst[k], L, B))
        jcodes = jnp.asarray(codes)
    assert got.shape == (K, 3, L, F, B)
    jfn = jhist.make_batched_level_fn(
        d, K, F, B, n, bin_counts=bc if layout == "varbin" else None,
        force_impl="pallas_interpret", precision="f32", subtract=False)
    want = jfn(jcodes, jnp.asarray(leaf), *(jnp.asarray(st[:, s])
                                           for s in range(3)))
    _close(got.numpy(), want, integer)


@pytest.mark.parametrize("planes", [3, 4])
def test_batched_hist_own_codes_and_scales(planes):
    """Each tree's own codes ([K, F, n], as a strided view) and its own
    fixed-point scale: bitwise the single calls, and each tree's scale is
    bitwise ``stat_scale`` of its stats alone."""
    n, F, nbins = 1531, 4, 40
    B = nbins + 1
    rng = np.random.default_rng(planes)
    codes = torch.from_numpy(np.stack(
        [_codes(rng, n, nbins, (9, 40, 3, 40)) for _ in range(K)], axis=1))
    own = codes.transpose(0, 1)                           # [K, F, n] view
    leaf = torch.from_numpy(rng.integers(-1, 3, (K, n)).astype(np.int32))
    st = torch.from_numpy(_stats(rng, n, False, (K,)))
    st[1] *= 1e4                        # trees on scales far apart
    scale = hist.stat_scale(st)
    for k in range(K):
        assert torch.equal(scale[k], hist.stat_scale(st[k]))
    got = hist.hist_uniform(own, leaf, st, 3, B, planes=planes, scale=scale)
    for k in range(K):
        want = hist.hist_uniform(own[k].contiguous(), leaf[k], st[k], 3, B,
                                 planes=planes)
        assert same_bits(got[k], want)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("varbin", [False, True])
def test_batched_level_bitwise_k_subtract_levels(varbin, integer):
    """``make_batched_level_fn`` at d = 0-3 is bitwise K calls of
    ``make_subtract_level_fn``, each on its tree's own scale; the full
    rebuild (``local_hist`` at 2^d leaves) gives the same splits'
    histograms to f32 tolerance."""
    n, F, nbins = 3001, 5, 64
    B = nbins + 1
    rng = np.random.default_rng(11 + integer + 2 * varbin)
    bc = (7, nbins, 22, 3, nbins - 5)
    codes = torch.from_numpy(_codes(rng, n, nbins, bc))
    lcodes = hist.offset_codes(codes, bc, nbins) if varbin else codes
    st = torch.from_numpy(_stats(rng, n, integer, (K,)))
    scale = hist.stat_scale(st)
    lbc = bc if varbin else None
    leaf = torch.zeros((K, n), dtype=torch.int32)
    carry, carries = None, [None] * K
    for d in range(4):
        if d:
            leaf = (2 * leaf + torch.from_numpy(
                rng.random((K, n)) < 0.3 + 0.1 * d).int()).int()
        H, carry = hist.make_batched_level_fn(d, K, F, B, lbc)(
            lcodes, leaf, st, carry, scale)
        assert H.shape == (K, 3, 2 ** d, F, B)
        for k in range(K):
            Hk, carries[k] = hist.make_subtract_level_fn(
                d, F, B, lbc).stacked(lcodes, leaf[k], st[k], carries[k],
                                      scale[k])
            assert same_bits(H[k], Hk), (d, k)
        full = hist.local_hist(lcodes, leaf, st, 2 ** d, F, B, lbc, scale)
        _close(H.numpy(), full.numpy(), integer)


# ---------------------------------------------------- (b) batched records

@pytest.mark.parametrize("mask_rank", [2, 3])
def test_fused_best_splits_batched_vs_jax(mask_rank):
    """K*L leaves in one records call: bitwise the JAX package's
    ``fused_best_splits_batched`` on integer H, with per-class masks
    ([K, F] or [K, L, F]), and bitwise K single calls."""
    L, F, nbins = 4, 6, 31
    B = nbins + 1
    rng = np.random.default_rng(mask_rank)
    H = np.stack([rng.integers(-20, 21, (K, L, F, B)),
                  rng.integers(0, 30, (K, L, F, B)),
                  rng.integers(0, 40, (K, L, F, B))], axis=1)
    H = H.astype(np.float32)
    H[..., rng.random(B) < 0.1] = 0.0
    mask = rng.random((K, F) if mask_rank == 2 else (K, L, F)) < 0.7
    prm = (1.0, 2.0, 1e-5, 0.0, 0.0, 1.0)
    got = hist.fused_best_splits_batched(torch.from_numpy(H), nbins, *prm[:3],
                                         torch.from_numpy(mask), *prm[3:])
    want = jhist.fused_best_splits_batched(jnp.asarray(H), nbins, *prm[:3],
                                           jnp.asarray(mask), *prm[3:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in range(K):
        m = torch.from_numpy(mask[k])
        one = hist.fused_best_splits(torch.from_numpy(H[k]), nbins,
                                     *prm[:3], m, *prm[3:])
        for g, o in zip(got, one):
            assert torch.equal(g[k], o)


def test_partition_batched_bitwise_single():
    n, F, nbins, L = 999, 4, 16, 4
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(_codes(rng, n, nbins, (16, 5, 16, 9)))
    leaf = torch.from_numpy(rng.integers(0, L, (K, n)).astype(np.int32))
    feat = torch.from_numpy(rng.integers(0, F, (K, L)).astype(np.int32))
    bin_ = torch.from_numpy(rng.integers(0, nbins, (K, L)).astype(np.int32))
    na_left = torch.from_numpy(rng.random((K, L)) < 0.5)
    valid = torch.from_numpy(rng.random((K, L)) < 0.8)
    got = hist.partition(codes, leaf, feat, bin_, na_left, valid, nbins)
    for k in range(K):
        assert torch.equal(got[k], hist.partition(
            codes, leaf[k], feat[k], bin_[k], na_left[k], valid[k], nbins))


# ----------------------------------------- (c) batched build vs the K loop

def _scan_inputs(n=2000, nbins=64):
    cols, types_, domains = make_airlines_like(n)
    cols["delay_class"] = delay_class(cols)
    fr = Frame.from_numpy(cols, types=types_, domains=domains, device="cpu")
    feats = [c for c in cols if c not in ("dep_delayed_15min",
                                          "delay_class")]
    binned = fit_bins(fr, feats, nbins=nbins, seed=1)
    dom = sorted(set(cols["delay_class"]))
    yi = torch.from_numpy(np.searchsorted(dom, cols["delay_class"]))
    Y1 = torch.nn.functional.one_hot(yi, K).t().float()
    N = binned.codes.shape[1]
    Y1 = torch.nn.functional.pad(Y1, (0, N - n))
    w = torch.ones(N)
    w[n:] = 0.0
    return binned, Y1, w, torch.from_numpy(edges_matrix(binned.edges, nbins))


@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("hist_mode", ["subtract", "full"])
def test_multinomial_scan_fused_bitwise_separate(hist_mode, varbin,
                                                 monkeypatch):
    """``make_multinomial_scan_fn`` "fused" (one batched build a round) is
    bitwise "separate" (a loop of K single builds) over 3 rounds with
    sample_rate=0.8, col_sample_rate_per_tree=0.7 and col_sample_rate=0.8:
    the scores F, every level of every class tree and the leaf values."""
    if varbin:
        monkeypatch.setenv("H2O3_TPU_HIST_IMPL", "varbin")
    config.reload()
    try:
        binned, Y1, w, edges = _scan_inputs()
        N = w.shape[0]
        F0 = torch.full((K, N), -1.1)
        out = {}
        for mode in ("fused", "separate"):
            fn = shared.make_multinomial_scan_fn(
                K, 5, 64, binned.nfeatures, N, 0.8, 0.7,
                bin_counts=binned.bin_counts, hist_mode=hist_mode,
                split_mode=mode, device="cpu")
            assert fn.build.use_varbin == varbin
            out[mode] = fn(binned.codes, Y1, w, F0, edges, 7, 2, 3, 1.0,
                           1.0, 1e-5, 0.3, 0.8, 0.0, 0.0, 1.0)
    finally:
        monkeypatch.delenv("H2O3_TPU_HIST_IMPL", raising=False)
        config.reload()
    (Ff, sf), (Fs, ss) = out["fused"], out["separate"]
    assert same_bits(Ff, Fs)
    assert len(sf) == len(ss) == K
    for a, b in zip(sf, ss):
        assert a.ntrees == 3 and a.depth == 5
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
        assert same_bits(a.values, b.values)
        assert same_bits(a.covers, b.covers)
    # the draws were on: some tree masks left features out
    assert any(not bool(lv[3].all()) for s in sf for lv in s.levels)


def test_draws_keyed_per_tree_and_class():
    """Each (seed, chunk, tree, stream) has its own generator: the same
    key draws the same on every call, in any order; other keys differ."""
    keys = [(1, 0, 0, 0), (1, 0, 0, 1), (1, 0, 1, 0), (1, 1, 0, 0),
            (2, 0, 0, 0), (1, 0, 0, shared.ROW_SAMPLE)]
    draws = [torch.rand(8, generator=shared.draw_generator(*k, "cpu"))
             for k in keys]
    again = [torch.rand(8, generator=shared.draw_generator(*k, "cpu"))
             for k in reversed(keys)][::-1]
    for a, b in zip(draws, again):
        assert torch.equal(a, b)
    assert len({tuple(d.tolist()) for d in draws}) == len(keys)


# ------------------------------------------------ (d) the slice vs JAX

def _slice_frames():
    cols, types_, domains = make_airlines_like(N_SLICE)
    cols["delay_class"] = delay_class(cols)
    jfr = JFrame.from_numpy(cols, types=types_, domains=domains)
    fr = Frame.from_numpy(cols, types=types_, domains=domains, device="cpu")
    return cols, jfr, fr


@pytest.fixture(scope="module")
def port_trained():
    cols, jfr, fr = _slice_frames()
    return cols, jfr, fr, XGBoost(device="cpu", **_XGB).train(fr)


@pytest.fixture(scope="module")
def trained(port_trained):
    """The port's train and the JAX package's: only the tests that read
    the JAX model ask for it, so an xdist worker that runs none of them
    never trains it."""
    cols, jfr, fr, tm = port_trained
    return cols, jfr, JXGBoost(**_XGB).train(jfr), fr, tm


def _records_margins(monkeypatch, estimator, cfg, fr, depth):
    """Retrain with the records captured: for every valid node of every
    class tree, how far its winning feature's gain clears the runner-up's,
    relative to the gain."""
    records = []
    real = hist.split_records

    def spy(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]
    monkeypatch.setattr(hist, "split_records", spy)
    m = estimator(device="cpu", **cfg).train(fr)
    margins = []
    for t, round_trees in enumerate(m.output["trees"]):
        for d in range(depth):
            gains = records[depth * t + d][..., 0].sort(
                dim=1, descending=True).values
            L = 2 ** d
            for k, tree in enumerate(round_trees):
                for l in np.flatnonzero(tree.valid[d].numpy()):
                    top, second = (float(gains[k * L + l, 0]),
                                   float(gains[k * L + l, 1]))
                    margins.append((top - second) / abs(top))
    assert len(records) == cfg["ntrees"] * depth and margins
    return min(margins)


def _assert_same_trees(jm, tm, ntrees, depth, where_valid):
    jt, tt = list(jm.output["trees"]), list(tm.output["trees"])
    assert len(jt) == len(tt) == ntrees
    for jr, tr in zip(jt, tt):
        assert len(jr) == len(tr) == K
        for a, b in zip(jr, tr):
            assert len(a.feat) == len(b.feat) == depth
            for d in range(depth):
                valid = b.valid[d].numpy()
                np.testing.assert_array_equal(np.asarray(a.valid[d]), valid)
                sel = valid if where_valid else slice(None)
                for name in ("feat", "na_left"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, name)[d])[sel],
                        getattr(b, name)[d].numpy()[sel],
                        err_msg=f"{name} {d}")
                np.testing.assert_array_equal(
                    np.asarray(a.thr[d]).view(np.int32)[sel],
                    b.thr[d].numpy().view(np.int32)[sel])
            np.testing.assert_allclose(b.values.numpy(),
                                       np.asarray(a.values), rtol=1e-4,
                                       atol=1e-7)


def _assert_probs_and_metrics(cols, jfr, jm, fr, tm):
    for c in ("LONG", "NO", "SHORT"):
        np.testing.assert_allclose(tm.predict(fr).vec(c).to_numpy(),
                                   np.asarray(jm.predict(jfr).vec(c)
                                              .to_numpy()), rtol=1e-4)
    a, b = jm.training_metrics, tm.training_metrics
    for name in ("logloss", "mean_per_class_error", "accuracy", "rmse"):
        assert abs(getattr(a, name) - getattr(b, name)) <= 1e-5, name
    np.testing.assert_allclose(b.cm.table, np.asarray(a.cm.table),
                               rtol=1e-5)


def test_slice_trees_match_jax(trained, monkeypatch):
    """XGBoost on the delay_class slice: every level of every class tree
    of every round has the same (feat, na_left, valid) and bitwise the
    same thresholds as the JAX package's, leaf values to rtol 1e-4; every
    winning gain clears its runner-up by more than 1e-3."""
    _, _, jm, fr, tm = trained
    assert tm.output["nclass_trees"] == K
    assert tm.output["distribution"] == "multinomial"
    _assert_same_trees(jm, tm, 5, 4, where_valid=False)
    assert _records_margins(monkeypatch, XGBoost, _XGB, fr, 4) > 1e-3


def test_slice_probabilities_and_metrics_match_jax(trained):
    """Class probabilities to rtol 1e-4; training logloss, mean per-class
    error, accuracy and rmse within 1e-5, the confusion matrix to rtol
    1e-5."""
    _assert_probs_and_metrics(*trained)


def test_slice_gbm_matches_jax(monkeypatch):
    """GBM on the same slice: the same valid nodes, and at every valid
    node the same split, thresholds bitwise (a dead node's stored split is
    arbitrary and nothing reads it: the JAX package's split crosscheck
    masks it the same way); leaf values, probabilities and metrics as for
    XGBoost."""
    cols, jfr, fr = _slice_frames()
    jm = JGBM(**_GBM).train(jfr)
    tm = GBM(device="cpu", **_GBM).train(fr)
    _assert_same_trees(jm, tm, 3, 4, where_valid=True)
    _assert_probs_and_metrics(cols, jfr, jm, fr, tm)
    assert _records_margins(monkeypatch, GBM, _GBM, fr, 4) > 1e-3


def test_archive_layout_matches_jax_export(trained):
    """``to_archive`` writes the K class groups as the JAX package's
    export does (``k{k}_`` prefixes, ``nclass_trees`` = K, one initial
    score per class): the same keys and shapes, the same split arrays."""
    _, _, jm, _, tm = trained
    jmeta, jarr = jmojo._extract(jm)
    meta, arr = tm.to_archive()
    assert meta["nclass_trees"] == jmeta["nclass_trees"] == K
    assert set(arr) == set(jarr)
    for key, a in arr.items():
        assert a.shape == jarr[key].shape and a.dtype == jarr[key].dtype
        if key.split("_", 1)[1].startswith(("feat", "valid", "na_left",
                                            "thr")):
            np.testing.assert_array_equal(a, jarr[key], err_msg=key)
    np.testing.assert_allclose(meta["init_score"], jmeta["init_score"],
                               rtol=1e-6)


def test_multinomial_model_publishes(port_trained):
    """A trained multinomial model publishes (``to_archive`` ->
    ``from_reference`` -> ``predict_rows``) and answers as ``m.predict``."""
    cols, _, fr, tm = port_trained
    n = 200
    rows = [{k: (str(int(v[i])) if k in ("carrier", "origin", "dest")
                 else float(v[i]))
             for k, v in cols.items()
             if k not in ("dep_delayed_15min", "delay_class")}
            for i in range(n)]
    ent = batcher.publish("torch-multinomial-test", tm, device="cpu")
    try:
        got = ent.predict_rows(rows)
    finally:
        batcher.shutdown_all()
    want = tm.predict(fr)
    dom = ["LONG", "NO", "SHORT"]
    np.testing.assert_allclose(
        got["probabilities"],
        np.stack([want.vec(c).to_numpy()[:n] for c in dom], axis=1),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        got["predict"],
        np.asarray(dom, dtype=object)[want.vec("predict").to_numpy()[:n]])
    assert from_reference(*tm.to_archive()).meta["nclass_trees"] == K


def test_multinomial_check_modes_and_hier(port_trained):
    """split_mode="check" and hist_mode="check" run their K-tree
    crosschecks on the first round and then train the batched path (the
    same trees); split_search="hier" trains through the K loop of single
    hierarchical builds."""
    *_, fr, tm = port_trained
    m = XGBoost(device="cpu", hist_mode="check", split_mode="check",
                **_XGB).train(fr)
    for a, b in zip(m.output["stacked"], tm.output["stacked"]):
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
    cfg = dict(_XGB, ntrees=2)
    mh = XGBoost(device="cpu", split_search="hier", **cfg).train(fr)
    me = XGBoost(device="cpu", **cfg).train(fr)
    assert mh.output["split_search"] == "hier"
    assert len(mh.output["trees"]) == 2 and len(mh.output["trees"][0]) == K
    assert abs(mh.training_metrics.logloss
               - me.training_metrics.logloss) < 0.01


def test_multinomial_validation_frame_scores_per_class(port_trained):
    """A validation frame is scored class by class as the chunks grow: on
    the training frame itself its metrics are the training metrics, and
    the model's own scoring of it agrees."""
    *_, fr, _ = port_trained
    m = XGBoost(device="cpu", **dict(_XGB, ntrees=2)).train(fr, valid=fr)
    a, b = m.training_metrics, m.validation_metrics
    for name in ("logloss", "mean_per_class_error", "accuracy"):
        assert abs(getattr(a, name) - getattr(b, name)) <= 1e-6, name
    again = m.model_performance(fr)
    assert abs(again.logloss - b.logloss) <= 1e-6


# --------------------------------------------------------- (e) the metrics

def test_multinomial_metrics_match_jax():
    """``multinomial_metrics`` against the JAX one on random probabilities
    (with tied classes) and weights: every field, the confusion matrix and
    the hit ratios."""
    rng = np.random.default_rng(21)
    n, k = 997, 4
    p = rng.random((n, k)).astype(np.float32)
    p[::7, 1] = p[::7, 2]                # ties: the stable sort decides
    p /= p.sum(axis=1, keepdims=True)
    y = rng.integers(0, k, n).astype(np.float32)
    y[::50] = -1.0                       # missing responses, weight 0
    w = (rng.random(n) * 2).astype(np.float32)
    w[y < 0] = 0.0
    dom = ["a", "b", "c", "d"]
    got = metrics.multinomial_metrics(torch.from_numpy(p),
                                      torch.from_numpy(y),
                                      torch.from_numpy(w), dom)
    want = jmetrics.multinomial_metrics(p, y, w, dom)
    for name in ("nobs", "logloss", "mse", "rmse", "mean_per_class_error",
                 "accuracy"):
        assert abs(getattr(got, name) - getattr(want, name)) \
            <= 1e-5 * max(1.0, abs(getattr(want, name))), name
    np.testing.assert_allclose(got.cm.table, want.cm.table, rtol=1e-5)
    np.testing.assert_allclose(got.hit_ratios, want.hit_ratios, rtol=1e-5)
    assert got.describe().keys() == {"logloss", "rmse",
                                     "mean_per_class_error", "accuracy"}


# ------------------------------------------- (f) faults of the depth cap

def _ns(**kw):
    return types.SimpleNamespace(**kw)


@pytest.mark.parametrize("F", [8, 32])
@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("hist_layout", ["auto", "dense", "sparse"])
@pytest.mark.parametrize("hist_mode", ["auto", "subtract", "full", "check"])
def test_effective_depth_matches_reference_resolvers(hist_mode, hist_layout,
                                                     hier, F):
    """The layout and ``effective_max_depth`` after each package's
    resolvers are the same over hist_mode x hist_layout x hier (nbins
    256, max_depth 14, 2^20 rows): "auto" is "sparse", and "dense", with
    its 64 MB cap, under hist_mode="full" and under the hierarchical
    search; an explicit "sparse" raises in both there."""
    nbins, depth, n = 256, 14, 2 ** 20
    jp = _ns(hist_mode=hist_mode, hist_layout=hist_layout,
             sparse_depth_threshold=8)
    tp = _ns(hist_mode=hist_mode, hist_layout=hist_layout,
             sparse_depth_threshold=8)
    if hist_layout == "sparse" and (hier or hist_mode == "full"):
        with pytest.raises(ValueError, match="does not compose"):
            jshared.resolve_hist_layout(
                jp, hist_mode=jshared.resolve_hist_mode(jp), hier=hier)
        with pytest.raises(ValueError, match="does not compose"):
            shared.resolve_hist_layout(
                tp, hist_mode=shared.resolve_hist_mode(tp), hier=hier)
        return
    jlayout = jshared.resolve_hist_layout(
        jp, hist_mode=jshared.resolve_hist_mode(jp), hier=hier)
    tlayout = shared.resolve_hist_layout(
        tp, hist_mode=shared.resolve_hist_mode(tp), hier=hier)
    assert tlayout == jlayout
    want = jshared.effective_max_depth(depth, nbins, F, n, jlayout)
    assert shared.effective_max_depth(depth, nbins, F, n, tlayout) == want


@pytest.mark.parametrize("threshold", [0, -3])
def test_sparse_threshold_below_one_raises_in_both(threshold):
    """A ``sparse_depth_threshold`` below 1 raises in both resolvers: the
    root level seeds the carry and is always dense."""
    for pkg in (jshared, shared):
        with pytest.raises(ValueError, match="sparse_depth_threshold"):
            pkg.resolve_hist_layout(_ns(hist_mode="auto", hist_layout="auto",
                                        sparse_depth_threshold=threshold))


def test_deep_auto_grows_the_reference_depth():
    """At F = 32, nbins = 256, max_depth=20 and 2^19 rows (a dense level
    19 would hold 51.7 GB of histograms) "auto" grows depth 20, the JAX
    package's depth, silently, with node-sparse levels from depth 8 on,
    at most 680 slots wide (the 64 MB budget's, in both packages);
    "dense" stops at its 64 MB cap and warns, as the JAX package does."""
    nbins, F, n = 256, 32, 2 ** 19
    lay = shared.resolve_hist_layout(_ns(hist_mode="auto",
                                         hist_layout="auto"))
    assert lay == "sparse"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = _ns(output={})
        assert shared.record_effective_depth(
            model, _ns(max_depth=20, nbins=nbins), F, n, lay) == 20
    assert model.output["depth_cap"] is None
    start, A_lv, Ap_lv = shared.sparse_geometry(20, nbins, F, 8, lay)
    assert start == 8 and max(A_lv.values()) == hist.sparse_slot_budget(
        F, nbins + 1) == jhist.sparse_slot_budget(F, nbins + 1) == 680
    assert A_lv[8] == Ap_lv[9] == 256 and Ap_lv[8] == 128
    model = _ns(output={})
    with pytest.warns(UserWarning, match="dense level|64 MB|full-width"):
        eff = shared.record_effective_depth(
            model, _ns(max_depth=20, nbins=nbins), F, n, "dense")
    assert eff == jshared.effective_max_depth(20, nbins, F, n, "dense") < 20
    assert model.output["depth_cap"] == "dense level 64 MB"