"""h2o3_tpu_torch's batched grid cohorts held against the JAX package and
against the port's own wave path.

A grid cohort grows the trees of G members that differ only in scalar
hyperparameters as one batched build (``shared.make_grid_scan_fn``): one
histogram launch and one records launch per level for all G members, the
records in the per-row form of ``csrc/split_records.cu`` (one set of
parameters per leaf).  The same numpy inputs from one seed go through the
JAX function and its port: the per-row records (against the JAX
package's per-row Pallas kernel in interpret mode and its XLA twin), the
batched split search with per-member parameters, and the grids trained by
both packages on the airlines-shaped bench frame.  The cohort is also
held bitwise against the port's wave path (one sequential train per
member), with row and column sampling on, under successive halving, and
split into cohorts by depth.  All of it runs on the CPU, where the
kernel wrappers take their plain torch versions.

Tolerances, as in tests/test_torch_multinomial.py: the JAX records agree
bitwise with the port's on integer-valued histograms (every partial sum
exact) and to f32 rounding (rtol 1e-6 of the gains, exact bins away from
ties) otherwise; trees agree with the JAX package's where every winning
gain clears its runner-up by more than 1e-4 of the gain (checked: a
hundred times the f32 rounding of a gain; the closest node of this grid
clears it by 7e-4), leaf values and predictions to rtol 1e-4.  Inside the
port everything is bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import GridSearch as JGridSearch
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models.tree import hist as jhist

from bench import make_airlines_like

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import GridSearch
from h2o3_tpu_torch.models.tree import grid_batch as gb
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.binning import edges_matrix, fit_bins
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.runtime.observability import timeline_events
from h2o3_tpu_torch.testing import same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

# the bench frame cut as in tests/test_torch_multinomial.py: 3,264 rows,
# depth 4, 32 bins, 5 trees
N_SLICE = 3264
_BASE = dict(response_column="dep_delayed_15min", max_depth=4, nbins=32,
             seed=1, ntrees=5, device="cpu")
_HP = {"learn_rate": [0.05, 0.1], "reg_lambda": [0.0, 1.0]}
# the reference's _sampling_params: rates of 1.0 among the members
_HP_SAMPLED = {"sample_rate": [0.8, 1.0],
               "col_sample_rate_per_tree": [0.8, 1.0]}


@pytest.fixture(scope="module")
def frames():
    cols, types_, domains = make_airlines_like(N_SLICE)
    fr = Frame.from_numpy(cols, types=types_, domains=domains, device="cpu")
    return cols, types_, domains, fr


def _pred(m, fr):
    return m.predict(fr).vec("YES").to_numpy()


def _by(models, *names):
    return {tuple(getattr(m.params, n) for n in names): m for m in models}


def _same_stacks(a, b):
    """Bitwise the same trees (every level's fields) and leaf values."""
    assert a.ntrees == b.ntrees and a.depth == b.depth
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            assert (same_bits(x, y) if x.is_floating_point()
                    else torch.equal(x, y))
    assert same_bits(a.values, b.values)


def _first_trees(st, n):
    return shared.StackedTrees([tuple(x[:n] for x in lv) for lv in st.levels],
                               st.values[:n], st.covers[:n])


# ----------------------------------------------- (a) the per-row records

def _records_hist(rng, L, F, nbins, integer):
    B = nbins + 1
    if integer:
        H = np.stack([rng.integers(-20, 21, (L, F, B)),
                      rng.integers(0, 30, (L, F, B)),
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    else:
        H = np.stack([rng.normal(size=(L, F, B)) * 3,
                      rng.random((L, F, B)) * 5,
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    H[..., rng.random(B) < 0.1] = 0.0
    return H


def _leaf_params(rng, L):
    """lam, min_rows, alpha, gamma, mcw: one value per leaf; leaf 1's
    min_rows and min_child_weight rule out every bin."""
    lam = rng.choice([0.0, 0.5, 1.0, 3.0], L).astype(np.float32)
    rows = rng.choice([1.0, 5.0, 20.0], L).astype(np.float32)
    alpha = rng.choice([0.0, 0.25], L).astype(np.float32)
    gamma = rng.choice([0.0, 0.1], L).astype(np.float32)
    mcw = rng.choice([0.0, 1.0, 2.0], L).astype(np.float32)
    rows[1], mcw[1] = 1e9, 1e9
    return lam, rows, alpha, gamma, mcw


@pytest.mark.parametrize("integer", [True, False])
def test_per_row_records_vs_jax(integer):
    """``_split_records_torch`` with per-leaf [L] tensors against the JAX
    package's ``split_records`` with per-leaf arrays through its per-row
    Pallas kernel in interpret mode and through ``_split_records_xla``:
    bitwise on integer-valued H; otherwise the bins, NA directions and
    integer-valued count fields exact and the f32 fields to rtol 1e-6.
    The wrapper takes the plain version for CPU tensors."""
    L, F, nbins = 8, 3, 16
    rng = np.random.default_rng(5 + integer)
    H = _records_hist(rng, L, F, nbins, integer)
    prm = _leaf_params(rng, L)
    lam, rows, alpha, gamma, mcw = (torch.from_numpy(x) for x in prm)
    got = hist.split_records(torch.from_numpy(H), nbins, lam, rows, alpha,
                             gamma, mcw).numpy()
    plain = hist._split_records_torch(torch.from_numpy(H), lam, rows, alpha,
                                      gamma, mcw).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    jargs = [jnp.asarray(x) for x in prm]
    for impl in ("pallas_interpret", "xla"):
        want = np.asarray(jhist.split_records(
            jnp.asarray(H), nbins, jargs[0], jargs[1], jargs[2], jargs[3],
            jargs[4], force_impl=impl))
        if integer:
            np.testing.assert_array_equal(got, want, err_msg=impl)
        else:
            np.testing.assert_array_equal(got[..., 1:3], want[..., 1:3])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=impl)
    # the leaf whose min_rows and min_child_weight rule out every bin
    assert np.isneginf(got[1, :, 0]).all()
    assert np.isfinite(got[0, :, 0]).any()


def test_per_row_records_equal_scalar_when_leaves_agree():
    """Per-leaf tensors that hold one value for every leaf give bitwise
    the scalar form's records (NaN planes included), and a per-leaf
    tensor of the wrong length raises."""
    L, F, nbins = 6, 4, 31
    rng = np.random.default_rng(9)
    H = torch.from_numpy(_records_hist(rng, L, F, nbins, False))
    H[0, 2] = float("nan")
    scal = (1.0, 2.0, 0.25, 0.1, 1.0)      # lam, min_rows, alpha, gamma, mcw
    per = [torch.full((L,), v, dtype=torch.float32) for v in scal]
    assert same_bits(hist.split_records(H, nbins, *per),
                     hist.split_records(H, nbins, *scal))
    with pytest.raises(ValueError, match="per-leaf"):
        hist.split_records(H, nbins, torch.ones(L + 1), 1.0)


# ------------------------------------- (b) batched records, [K] parameters

def test_fused_best_splits_batched_per_member_vs_jax():
    """K*L leaves in one records call with per-tree [K] parameters
    (repeated over each tree's leaves, K-major): bitwise the JAX
    package's ``fused_best_splits_batched`` with [K] arrays on integer H,
    and bitwise K scalar calls of ``fused_best_splits``."""
    K, L, F, nbins = 4, 4, 5, 31
    B = nbins + 1
    rng = np.random.default_rng(21)
    H = np.stack([rng.integers(-20, 21, (K, L, F, B)),
                  rng.integers(0, 30, (K, L, F, B)),
                  rng.integers(0, 40, (K, L, F, B))], axis=1)
    H = H.astype(np.float32)
    mask = rng.random((K, F)) < 0.8
    prm = {"reg_lambda": [0.0, 1.0, 2.0, 0.5],
           "min_rows": [1.0, 3.0, 1e9, 5.0],
           "min_split_improvement": [1e-5, 0.5, 1e-5, 2.0],
           "reg_alpha": [0.0, 0.5, 0.0, 0.1], "gamma": [0.0, 0.0, 0.2, 0.1],
           "min_child_weight": [1.0, 0.0, 2.0, 1.0]}
    order = ("reg_lambda", "min_rows", "min_split_improvement")
    tail = ("reg_alpha", "gamma", "min_child_weight")
    tk = {k: torch.tensor(v, dtype=torch.float32) for k, v in prm.items()}
    jk = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in prm.items()}
    got = hist.fused_best_splits_batched(
        torch.from_numpy(H), nbins, *(tk[k] for k in order),
        torch.from_numpy(mask), *(tk[k] for k in tail))
    want = jhist.fused_best_splits_batched(
        jnp.asarray(H), nbins, *(jk[k] for k in order), jnp.asarray(mask),
        *(jk[k] for k in tail))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k in range(K):
        one = hist.fused_best_splits(
            torch.from_numpy(H[k]), nbins, *(prm[n][k] for n in order),
            torch.from_numpy(mask[k]), *(prm[n][k] for n in tail))
        for g, o in zip(got, one):
            assert torch.equal(g[k], o), k
    assert not bool(got[4][2].any())          # member 2's min_rows
    assert bool(got[4][0].any())


# --------------------------------------- (c) the G-member build vs G builds

def test_build_per_member_params_bitwise_single_builds(frames):
    """``make_build_tree_fn(nk=G)`` with per-member parameters ([G]
    tensors, a sequence of per-split column rates with 1.0 among them,
    per-member tree masks, each member's own generator) is bitwise G
    single builds with the scalars, sampling on; a retired member (all
    stats 0) grows no valid split, leaf values 0 and no NaN."""
    *_, fr = frames
    feats = [c for c in fr.names if c != "dep_delayed_15min"]
    binned = fit_bins(fr, feats, nbins=32, seed=1)
    edges = torch.from_numpy(edges_matrix(binned.edges, 32))
    N, F = binned.codes.shape[1], binned.nfeatures
    G = 4
    rng = np.random.default_rng(4)
    p = rng.random((G, N)).astype(np.float32)
    y = (rng.random(N) < 0.3).astype(np.float32)
    w = (rng.random((G, N)) < 0.9).astype(np.float32)
    w[3] = 0.0                                      # a retired member
    g = torch.from_numpy((p - y) * w)
    h = torch.from_numpy(p * (1 - p) * w)
    wt = torch.from_numpy(w)
    prm = {"reg_lambda": [0.0, 1.0, 2.0, 0.0],
           "min_rows": [1.0, 5.0, 1.0, 0.0],
           "min_split_improvement": [1e-5, 1e-3, 1e-5, 0.0],
           "learn_rate": [0.3, 0.1, 0.05, 0.2],
           "reg_alpha": [0.0, 0.1, 0.0, 0.0], "gamma": [0.0, 0.0, 0.05, 0.0],
           "min_child_weight": [1.0, 0.5, 0.0, 0.0]}
    csr = (0.7, 1.0, 0.5, 1.0)
    tm = torch.from_numpy(np.stack([rng.random(F) < r
                                    for r in (0.8, 1.0, 0.6, 1.0)]))
    tm[:, 0] = True
    kw = dict(bin_counts=binned.bin_counts, hist_layout="dense",
              device="cpu")
    batched = shared.make_build_tree_fn(4, 32, F, N, nk=G, **kw)
    single = shared.make_build_tree_fn(4, 32, F, N, **kw)
    tens = {k: torch.tensor(v, dtype=torch.float32) for k, v in prm.items()}

    def gen(k):
        return shared.draw_generator(7 + k, 0, 0, 0, "cpu")

    def args(src, k=None):
        pick = (lambda n: src[n]) if k is None else (lambda n: src[n][k])
        return (pick("reg_lambda"), pick("min_rows"),
                pick("min_split_improvement"), pick("learn_rate"))

    def tail(src, k=None):
        pick = (lambda n: src[n]) if k is None else (lambda n: src[n][k])
        return pick("reg_alpha"), pick("gamma"), pick("min_child_weight")

    lv, vals, cover, leaf = batched(
        binned.codes, g, h, wt, edges, [gen(k) for k in range(G)],
        *args(tens), csr, tm, *tail(tens))
    for k in range(G):
        lk, vk, ck, leafk = single(
            binned.codes, g[k], h[k], wt[k], edges, gen(k), *args(prm, k),
            csr[k], tm[k], *tail(prm, k))
        for d in range(4):
            for x, yk in zip(lv[d], lk[d]):
                assert (same_bits(x[k], yk) if x.is_floating_point()
                        else torch.equal(x[k], yk)), (k, d)
        assert same_bits(vals[k], vk) and same_bits(cover[k], ck)
        assert torch.equal(leaf[k], leafk)
    assert not any(bool(lvd[3][3].any()) for lvd in lv)
    assert bool((vals[3] == 0).all()) and bool(torch.isfinite(vals).all())
    assert bool(lv[1][3][0].any())


# ----------------------------------- (d) the cohort vs the port's wave path

@pytest.mark.parametrize("hp, extra", [(_HP, {}),
                                       (_HP_SAMPLED,
                                        {"col_sample_rate": 0.6})],
                         ids=["unsampled", "sampled"])
def test_cohort_bitwise_wave_path(frames, hp, extra):
    """The batched cohort (``grid_batch="on"``, tagged ``grid_cohort``) is
    bitwise the wave path (``"off"``: one sequential train per member):
    every tree, every leaf value and the predictions, unsampled and with
    row and column sampling on (rates of 1.0 among the members), and the
    training metrics equal."""
    *_, fr = frames
    kw = dict(_BASE, **extra)
    g_on = GridSearch(XGBoost, hp, grid_batch="on", **kw).train(fr)
    g_off = GridSearch(XGBoost, hp, grid_batch="off", **kw).train(fr)
    assert len(g_on.models) == len(g_off.models) == 4
    assert sorted(m.output["grid_cohort"]["member"] for m in g_on.models) \
        == [0, 1, 2, 3]
    assert all(m.output["grid_cohort"]["size"] == 4 for m in g_on.models)
    assert all(m.output.get("grid_cohort") is None for m in g_off.models)
    names = list(hp)
    mo, mf = _by(g_on.models, *names), _by(g_off.models, *names)
    assert set(mo) == set(mf)
    for k in mo:
        _same_stacks(mo[k].output["stacked"], mf[k].output["stacked"])
        np.testing.assert_array_equal(_pred(mo[k], fr), _pred(mf[k], fr))
        assert mo[k].training_metrics.auc == mf[k].training_metrics.auc
    if extra:                     # the draws were on
        assert any(not bool(lv[3].all())
                   for m in g_on.models
                   for lv in m.output["stacked"].levels)


def test_cohort_validation_frame_and_best_model(frames):
    """A validation frame is scored per member: each member's validation
    metrics equal its sequential train's; the grid's best model and its
    sorted metric table follow the validation AUC."""
    *_, fr = frames
    g_on = GridSearch(XGBoost, _HP, grid_batch="on", **_BASE).train(
        fr, valid=fr)
    g_off = GridSearch(XGBoost, _HP, grid_batch="off", **_BASE).train(
        fr, valid=fr)
    mo = _by(g_on.models, *_HP)
    mf = _by(g_off.models, *_HP)
    for k in mo:
        assert mo[k].validation_metrics.auc == mf[k].validation_metrics.auc
    table = g_on.sorted_metric_table()
    assert [r["auc"] for r in table] == sorted((r["auc"] for r in table),
                                               reverse=True)
    assert g_on.best_model.key == table[0]["model_id"]


# -------------------------------- (e) the port's cohort vs the JAX cohort

@pytest.fixture(scope="module")
def jax_cohort(frames):
    cols, types_, domains, fr = frames
    jfr = JFrame.from_numpy(cols, types=types_, domains=domains)
    kw = {k: v for k, v in _BASE.items() if k != "device"}
    jg = JGridSearch(JXGBoost, _HP, grid_batch="on", **kw).train(jfr)
    return jfr, jg


def _cohort_margins(monkeypatch, fr):
    """Retrain the port's cohort with the records captured: for every
    valid node of every member's trees, how far its winning feature's
    gain clears the runner-up's, relative to the gain."""
    records = []
    real = hist.split_records

    def spy(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]
    monkeypatch.setattr(hist, "split_records", spy)
    g = GridSearch(XGBoost, _HP, grid_batch="on", **_BASE).train(fr)
    depth, G = _BASE["max_depth"], len(g.models)
    margins = []
    for m in g.models:
        k = m.output["grid_cohort"]["member"]
        for t, tree in enumerate(m.output["trees"]):
            for d in range(depth):
                gains = records[depth * t + d][..., 0].sort(
                    dim=1, descending=True).values
                L = 2 ** d
                assert gains.shape[0] == G * L
                for l in np.flatnonzero(tree.valid[d].numpy()):
                    top, second = (float(gains[k * L + l, 0]),
                                   float(gains[k * L + l, 1]))
                    margins.append((top - second) / abs(top))
    assert len(records) == _BASE["ntrees"] * depth and margins
    return min(margins)


def test_cohort_matches_jax_cohort(frames, jax_cohort, monkeypatch):
    """The port's cohort against the JAX package's (``grid_batch="on"``,
    both tagged ``grid_cohort``) on unsampled members: every level of
    every member's trees has the same (feat, na_left, valid) and bitwise
    the same thresholds, leaf values to rtol 1e-4, predictions to rtol
    1e-4; every winning gain clears its runner-up by more than 1e-4."""
    *_, fr = frames
    jfr, jg = jax_cohort
    g = GridSearch(XGBoost, _HP, grid_batch="on", **_BASE).train(fr)
    assert all(m.output.get("grid_cohort") for m in jg.models)
    assert all(m.output.get("grid_cohort") for m in g.models)
    mj, mt = _by(jg.models, *_HP), _by(g.models, *_HP)
    assert set(mj) == set(mt)
    depth = _BASE["max_depth"]
    for key in mt:
        jt, tt = list(mj[key].output["trees"]), list(mt[key].output["trees"])
        assert len(jt) == len(tt) == _BASE["ntrees"]
        for a, b in zip(jt, tt):
            for d in range(depth):
                valid = b.valid[d].numpy()
                np.testing.assert_array_equal(np.asarray(a.valid[d]), valid)
                for name in ("feat", "na_left"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, name)[d]),
                        getattr(b, name)[d].numpy(), err_msg=f"{key} {d}")
                np.testing.assert_array_equal(
                    np.asarray(a.thr[d]).view(np.int32),
                    b.thr[d].numpy().view(np.int32))
            np.testing.assert_allclose(b.values.numpy(),
                                       np.asarray(a.values), rtol=1e-4,
                                       atol=1e-7)
        np.testing.assert_allclose(
            _pred(mt[key], fr),
            np.asarray(mj[key].predict(jfr).vec("YES").to_numpy()),
            rtol=1e-4)
    assert _cohort_margins(monkeypatch, fr) > 1e-4


# --------------------------------------- (f) cohort planning and fallbacks

def test_plan_cohorts_partitioning_rules():
    """Batchable knobs group, shape knobs split, ineligible and singleton
    members take the wave path with a reason."""
    base = dict(_BASE)
    combos = [
        {"learn_rate": 0.1, "max_depth": 3},    # cohort A
        {"learn_rate": 0.2, "max_depth": 3},    # cohort A
        {"learn_rate": 0.1, "max_depth": 4},    # cohort B
        {"reg_lambda": 2.0, "max_depth": 4},    # cohort B
        {"learn_rate": 0.1, "max_depth": 5},    # singleton -> rest
        {"learn_rate": 0.1, "max_depth": 3, "nfolds": 2},  # ineligible
        {"learn_rate": 0.1, "booster": "dart"},            # ineligible
        {"learn_rate": 0.1, "split_search": "hier"},       # ineligible
    ]
    cohorts, rest = gb.plan_cohorts(XGBoost, base, combos)
    assert sorted(sorted(c) for c in cohorts) == [[0, 1], [2, 3]]
    reasons = dict(rest)
    assert set(reasons) == {4, 5, 6, 7}
    assert "singleton" in reasons[4]
    assert "nfolds" in reasons[5]
    assert "dart" in reasons[6]
    assert "hierarchical" in reasons[7]


def _fallbacks(since):
    return [e for e in timeline_events(2000)
            if e["kind"] == "grid_batch_fallback" and e["ts"] >= since]


def test_fallbacks_recorded_and_wave_path_trains(frames):
    """A grid of an ineligible split mode falls back whole: every member
    trains on the wave path, none carries a cohort tag, and the reason
    lands on the timeline.  Cross-validated members (nfolds) fall back
    and train with their folds on the wave path.  Members whose option
    the port lacks (export_checkpoints_dir) also fall back, and their own
    builder then raises, so each becomes a failed entry; a grid of
    nothing else trains no model and says so.  Concurrent waves refuse
    the whole-tree scan program, whose graph capture is process-wide."""
    import time
    *_, fr = frames
    t0 = time.time()
    g = GridSearch(XGBoost, {"learn_rate": [0.1, 0.2]}, grid_batch="auto",
                   split_mode="separate", **dict(_BASE, ntrees=2)).train(fr)
    assert len(g.models) == 2 and not g.failed_entries
    assert all(m.output.get("grid_cohort") is None for m in g.models)
    assert any("split_mode" in str(e.get("reason")) for e in _fallbacks(t0))
    g = GridSearch(XGBoost, {"learn_rate": [0.1, 0.2]}, grid_batch="on",
                   nfolds=2, **dict(_BASE, ntrees=2)).train(fr)
    assert len(g.models) == 2 and not g.failed_entries
    assert all(len(m.output["cv_fold_models"]) == 2
               and m.cross_validation_metrics is not None for m in g.models)
    assert any("nfolds" in str(e.get("reason")) for e in _fallbacks(t0))
    with pytest.raises(ValueError, match="NotImplementedError"):
        GridSearch(XGBoost, {"learn_rate": [0.1, 0.2]}, grid_batch="on",
                   export_checkpoints_dir="/nonexistent", **_BASE).train(fr)
    assert any("export_checkpoints_dir" in str(e.get("reason"))
               for e in _fallbacks(t0))
    with pytest.raises(ValueError, match="parallelism"):
        GridSearch(XGBoost, _HP, parallelism=4, tree_program="scan",
                   **_BASE)


def test_grid_runs_on_cuda_unless_told(frames, monkeypatch):
    """Without CUDA a grid that does not name device="cpu" raises, on
    the batched path and on the wave path alike: nothing falls back to
    the CPU."""
    *_, fr = frames
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in _BASE.items() if k != "device"}
    for mode in ("on", "off"):
        with pytest.raises(RuntimeError, match="CUDA"):
            GridSearch(XGBoost, _HP, grid_batch=mode, **kw).train(fr)


def test_auto_keeps_the_memory_half_of_the_cost_model(frames, monkeypatch):
    """``grid_batch="auto"`` batches where the cohort's state (the JAX
    package's formula) fits ``GRID_STATE_BUDGET``, and records the wave
    path where it does not."""
    import time
    *_, fr = frames
    assert gb.cohort_state_bytes(4, 10_000_000, 8, 6, 256) == \
        4 * (16.0 * 10_000_000 + 2 * 3.0 * 32 * 8 * 257 * 4)
    assert gb.resolve_grid_batch(4, 10_000_000, 8, 6, 256) is None
    g = GridSearch(XGBoost, {"learn_rate": [0.1, 0.2]}, grid_batch="auto",
                   **dict(_BASE, ntrees=2)).train(fr)
    assert all(m.output.get("grid_cohort") for m in g.models)
    monkeypatch.setattr(gb, "GRID_STATE_BUDGET", 1e3)
    t0 = time.time()
    g = GridSearch(XGBoost, {"learn_rate": [0.1, 0.2]}, grid_batch="auto",
                   **dict(_BASE, ntrees=2)).train(fr)
    assert all(m.output.get("grid_cohort") is None for m in g.models)
    assert any("budget" in str(e.get("reason")) for e in _fallbacks(t0))


# --------------------------------------------- (g) successive halving

def test_halving_rungs_schedule():
    assert gb._halving_rungs(8, 40, 2.0) == [(5, 4), (10, 2), (20, 1)]
    assert gb._halving_rungs(2, 10, 3.0) == []  # R=0: nothing to retire
    assert gb._halving_rungs(9, 27, 3.0) == [(3, 3), (9, 1)]
    assert gb._halving_rungs(4, 8, 1.0) == []   # eta<=1 disables


def test_halving_survivors_match_oracle(frames):
    """Successive halving retires members at the scoring fences through
    the alive mask: the survivor is bitwise its full sequential train and
    the best member of the trained-to-completion grid by final logloss;
    each retired member holds bitwise the first trees of its sequential
    train, as many as it grew before retirement."""
    *_, fr = frames
    hp = {"learn_rate": [0.01, 0.05, 0.1, 0.3]}
    kw = dict(_BASE, ntrees=12, score_tree_interval=3)
    g = GridSearch(XGBoost, hp, grid_batch="on",
                   search_criteria={"successive_halving": True,
                                    "halving_eta": 2}, **kw).train(fr)
    full = GridSearch(XGBoost, hp, grid_batch="off", **kw).train(fr)
    retired = [m for m in g.models if m.output.get("halving")]
    survivors = [m for m in g.models if not m.output.get("halving")]
    assert len(retired) == 3 and len(survivors) == 1
    seq = _by(full.models, "learn_rate")
    for m in retired:
        n = m.output["ntrees_trained"]
        assert n == m.output["halving"]["retired_at"] < 12
        _same_stacks(m.output["stacked"], _first_trees(
            seq[(m.params.learn_rate,)].output["stacked"], n))
    s = survivors[0]
    assert s.output["ntrees_trained"] == 12
    _same_stacks(s.output["stacked"],
                 seq[(s.params.learn_rate,)].output["stacked"])
    best = min(full.models, key=lambda m: m.scoring_history[-1]["logloss"])
    assert s.params.learn_rate == best.params.learn_rate


# ------------------------------------------ (h) cohorts split by shape

def test_mixed_depth_grid_partitions_into_cohorts(frames):
    """max_depth changes the build, so a [2, 3] x [lr] grid splits into
    two depth-homogeneous cohorts: both batched, both bitwise the wave
    path."""
    *_, fr = frames
    hp = {"max_depth": [2, 3], "learn_rate": [0.1, 0.2]}
    kw = {k: v for k, v in _BASE.items() if k != "max_depth"}
    g_on = GridSearch(XGBoost, hp, grid_batch="on", **kw).train(fr)
    g_off = GridSearch(XGBoost, hp, grid_batch="off", **kw).train(fr)
    coh = [m.output.get("grid_cohort") for m in g_on.models]
    assert all(c is not None and c["size"] == 2 for c in coh), coh
    mo = _by(g_on.models, "max_depth", "learn_rate")
    mf = _by(g_off.models, "max_depth", "learn_rate")
    for k in mo:
        assert mo[k].output["stacked"].depth == k[0]
        _same_stacks(mo[k].output["stacked"], mf[k].output["stacked"])


# ------------------------------------------- max_runtime_secs in a cohort

def test_cohort_deadline_freezes_members_at_a_chunk_fence(frames,
                                                          monkeypatch):
    """A ``deadline`` that passes during the first chunk stops the cohort
    at the next chunk fence: every member keeps the trees grown so far,
    bitwise the first trees of its sequential train, and the stop is
    recorded; a deadline already past before the first chunk leaves every
    member a failed entry."""
    import time
    *_, fr = frames
    kw = dict(_BASE, ntrees=10, score_tree_interval=5)
    combos = [{"learn_rate": 0.1}, {"learn_rate": 0.3}]
    clock = iter([0.0])            # the first fence at 0, then 100
    monkeypatch.setattr(gb.time, "monotonic", lambda: next(clock, 100.0))
    t0 = time.time()
    res = gb.train_cohort(XGBoost, kw, combos, fr, deadline=50.0)
    assert all(err is None for _, err in res)
    for (m, _), combo in zip(res, combos):
        assert m.output["ntrees_trained"] == 5
        seq = XGBoost(**dict(kw, **combo)).train(fr)
        _same_stacks(m.output["stacked"],
                     _first_trees(seq.output["stacked"], 5))
    assert any(e["kind"] == "grid_cohort_deadline" and e["ts"] >= t0
               for e in timeline_events(2000))
    monkeypatch.setattr(gb.time, "monotonic", lambda: 100.0)
    res = gb.train_cohort(XGBoost, kw, combos, fr, deadline=50.0)
    assert all(m is None and "DeadlineExceeded" in err for m, err in res)
