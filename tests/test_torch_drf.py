"""h2o3_tpu_torch's node-sparse deep levels and DRF held against the JAX
package and against themselves.

Past ``sparse_depth_threshold`` both packages grow node-sparse levels:
histograms, split records and routing over A slots of alive nodes, each
level expanded back to the dense [2^d] contract.  The same numpy inputs
from one seed go through the JAX function and its port: the slot maps,
the sparse level's histograms, and binomial and 3-class (``delay_class``)
forests trained by both packages (each JAX forest in one test) on the
airlines-shaped bench frame at 4,096 rows, 3 trees, at depth 5 from a
threshold of 3 (levels 3-4 sparse; the JAX package compiles one program
a level, so the depth sets these tests' seconds), the slot-budget forest
at depth 9 from threshold 4 (levels 4-8; the budget of 64 slots binds
from level 7), the port's own forests at depth 12 (levels 4-11),
``sample_rate=1`` and ``mtries=-2`` (unsampled: the two packages' random
bits differ by design).  A shrunken slot budget makes both drop the same
pairs.  The port is also held against itself: the sparse level bitwise
the dense one where the slot map is the identity, the batched K = 3 round
bitwise its K loop with sampling on, a deep grid cohort bitwise its
members' own trains.  All of it runs on the CPU, where the port's kernel
wrappers take their plain torch versions.

Tolerances: trees exactly (valid, feature, NA direction, thresholds
bitwise) at every level; leaf values rtol 1e-5, atol 1e-6; predictions
and training metrics 1e-5.  Histograms against the JAX package bitwise on
integer-valued stats, else to 1e-5 of each plane's L1 norm (it sums in
f32 over the suite's 8-device CPU mesh).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.models import DRF as JDRF
from h2o3_tpu.models.tree import hist as jhist
from h2o3_tpu.models.tree import shared as jshared

from bench import make_airlines_like

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DRF, GridSearch
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.serving import batcher
from h2o3_tpu_torch.testing import delay_class, same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 4096
DEPTH = 12
# the depth and first sparse level of the two forests held level by level
# against the JAX package
_FOREST_DEPTH = 5
_FOREST_SPARSE_FROM = 3
# the depth of the forest whose shrunken slot budget binds (64 slots: from
# level 7, where up to 128 children are alive)
_BUDGET_DEPTH = 9
_DRF = dict(ntrees=3, max_depth=DEPTH, nbins=32, sample_rate=1.0,
            mtries=-2, seed=1, sparse_depth_threshold=4,
            score_tree_interval=10 ** 9)
_KINDS = {"binomial": dict(response_column="dep_delayed_15min",
                           ignored_columns=["delay_class"]),
          "multinomial": dict(response_column="delay_class",
                              ignored_columns=["dep_delayed_15min"])}


def _frames(n=N):
    cols, types_, domains = make_airlines_like(n)
    cols["delay_class"] = delay_class(cols)
    jfr = JFrame.from_numpy(cols, types=types_, domains=domains)
    fr = Frame.from_numpy(cols, types=types_, domains=domains, device="cpu")
    return cols, jfr, fr


@pytest.fixture(scope="module")
def frames():
    return _frames()


def _train(kind, cols, jfr, fr):
    """Both packages' forests of one kind at ``_FOREST_DEPTH`` (each JAX
    forest is trained by one test only: under the suite's workers a
    shared fixture would train it once per worker)."""
    cfg = dict(_DRF, max_depth=_FOREST_DEPTH,
               sparse_depth_threshold=_FOREST_SPARSE_FROM, **_KINDS[kind])
    return JDRF(**cfg).train(jfr), DRF(device="cpu", **cfg).train(fr)


def _class_trees(m):
    """Every tree of a forest as (round, class, tree)."""
    K = m.output.get("nclass_trees", 1)
    for t, r in enumerate(m.output["trees"]):
        for k, tree in enumerate(r if K > 1 else [r]):
            yield t, k, tree


def _assert_same_trees(jm, tm, depth):
    jt, tt = list(_class_trees(jm)), list(_class_trees(tm))
    assert len(jt) == len(tt) > 0
    for (t, k, a), (_, _, b) in zip(jt, tt):
        assert len(a.feat) == len(b.feat) == depth
        for d in range(depth):
            msg = f"round {t} class {k} level {d}"
            for name in ("valid", "feat", "na_left"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {msg}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].numpy().view(np.int32), err_msg=f"thr {msg}")
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=1e-5, atol=1e-6)


def _dropped(model, depth, threshold, F, nbins):
    """Per sparse level d: the alive children past the slot budget, 2 x
    the valid nodes of level d-1 less the slots A_d (pairs drop whole),
    over every tree of the forest."""
    _, A_lv, _ = shared.sparse_geometry(depth, nbins, F, threshold, "sparse")
    out = {}
    for _, _, tree in _class_trees(model):
        for d, A in A_lv.items():
            alive = 2 * int(np.asarray(tree.valid[d - 1]).sum())
            out[d] = out.get(d, 0) + max(0, alive - A)
    return out


# ------------------------------------------------ (a) forests, level by level

def _assert_forests_match(kind, jm, tm, jfr, fr):
    """At every level of every (class) tree the same valid, feature, NA
    direction and bitwise thresholds as the JAX package's, dense levels
    0-2 and sparse levels 3-4 alike, leaf values to rtol 1e-5 (both
    resolve "auto" to the sparse layout); the averaged predictions to
    1e-5; the training AUC, rmse and gini (binomial) or accuracy and mean
    per-class error (3-class), and the logloss, within 1e-5.  A binomial
    forest's logloss is NaN in both packages (leaves of one class give
    probabilities of 0 and 1)."""
    assert tm.output["hist_layout"] == jm.output["hist_layout"] == "sparse"
    assert tm.output["effective_max_depth"] == _FOREST_DEPTH
    assert tm.output["nclass_trees"] == (3 if kind == "multinomial" else 1)
    _assert_same_trees(jm, tm, _FOREST_DEPTH)
    dom = ["LONG", "NO", "SHORT"] if kind == "multinomial" else ["NO", "YES"]
    got, want = tm.predict(fr), jm.predict(jfr)
    for c in dom:
        np.testing.assert_allclose(got.vec(c).to_numpy(),
                                   np.asarray(want.vec(c).to_numpy()),
                                   rtol=1e-5, atol=1e-6)
    a, b = jm.training_metrics, tm.training_metrics
    names = ("accuracy", "mean_per_class_error") \
        if kind == "multinomial" else ("auc", "rmse", "gini")
    for name in names + ("logloss",):
        x, y = getattr(a, name), getattr(b, name)
        assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-5, name


def test_binomial_drf_matches_jax_and_its_export(frames):
    """The binomial forest against the JAX package's
    (``_assert_forests_match``); ``to_archive`` writes it as the JAX
    package's export does (``tree_average`` true, the same keys, shapes
    and split arrays)."""
    cols, jfr, fr = frames
    jm, tm = _train("binomial", cols, jfr, fr)
    _assert_forests_match("binomial", jm, tm, jfr, fr)
    jmeta, jarr = jmojo._extract(jm)
    meta, arr = tm.to_archive()
    assert meta["tree_average"] is jmeta["tree_average"] is True
    assert meta["depth"] == jmeta["depth"] == _FOREST_DEPTH
    assert set(arr) == set(jarr)
    for key, x in arr.items():
        assert x.shape == jarr[key].shape and x.dtype == jarr[key].dtype
        if not key.startswith(("values", "covers")):
            np.testing.assert_array_equal(x, jarr[key], err_msg=key)


def test_multinomial_drf_matches_jax(frames):
    """The 3-class forest on ``delay_class`` against the JAX package's
    (``_assert_forests_match``)."""
    cols, jfr, fr = frames
    _assert_forests_match("multinomial", *_train("multinomial", cols, jfr,
                                                 fr), jfr, fr)


# --------------------------------------------------- (b) the slot level

def _level_case(seed, n, F, nbins, integer, K):
    rng = np.random.default_rng(seed)
    bc = (7, nbins, 22, 3, nbins - 5)[:F]
    codes = np.stack([np.where(rng.random(n) < 0.1, nbins,
                               rng.integers(0, b, n))
                      for b in bc]).astype(np.int32)
    if integer:
        st = np.stack([rng.integers(-3, 4, (K, n)), rng.integers(0, 3, (K, n)),
                       rng.integers(0, 2, (K, n))], axis=1)
    else:
        p = rng.random((K, n))
        st = np.stack([p - (rng.random((K, n)) < 0.4), p * (1 - p),
                       rng.random((K, n)) < 0.9], axis=1)
    return bc, codes, st.astype(np.float32), rng


@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_sparse_level_bitwise_dense_level(K, varbin):
    """With every parent valid and A = 2^d the slot map is the identity,
    and the sparse level (``make_sparse_level_fn`` at K = 1,
    ``make_batched_sparse_level_fn`` at K = 3) on the dense carry is
    bitwise the dense level at d = 1-3, on real-valued stats (the
    histograms are exact integer sums in both)."""
    n, F, nbins = 3001, 5, 64
    B = nbins + 1
    bc, codes, st, rng = _level_case(5 + K + varbin, n, F, nbins, False, K)
    tcodes = torch.from_numpy(codes)
    lbc = bc if varbin else None
    lcodes = hist.offset_codes(tcodes, bc, nbins) if varbin else tcodes
    tst = torch.from_numpy(st)
    scale = hist.stat_scale(tst)
    leaf = torch.zeros((K, n), dtype=torch.int32)
    carry = None
    for d in range(4):
        if d:
            leaf = (2 * leaf + torch.from_numpy(
                rng.random((K, n)) < 0.3 + 0.1 * d).int()).int()
        Hd, nxt = hist.make_batched_level_fn(d, K, F, B, lbc)(
            lcodes, leaf, tst, carry, scale)
        if d:
            A, Ap = 2 ** d, 2 ** (d - 1)
            cb, ps, real = hist.sparse_slot_maps(
                torch.ones((K, Ap), dtype=torch.bool), A)
            assert bool(real.all())
            assert torch.equal(ps, torch.arange(A).div(
                2, rounding_mode="floor").expand(K, A))
            sleaf = leaf.long()
            if K == 1:
                Hs, _ = hist.make_sparse_level_fn(Ap, A, F, B, lbc)(
                    lcodes, sleaf[0], tst[0], carry[0], ps[0], scale[0])
                Hs = Hs[None]
            else:
                Hs, _ = hist.make_batched_sparse_level_fn(Ap, A, K, F, B,
                                                          lbc)(
                    lcodes, sleaf, tst, carry, ps, scale)
            assert same_bits(Hs, Hd), d
        carry = nxt


@pytest.mark.parametrize("integer", [True, False])
def test_sparse_level_and_slot_maps_vs_jax(integer):
    """The slot maps (``sparse_slot_maps``) of a level whose parents are
    partly valid and whose alive children overflow the slots equal the
    JAX package's; on those maps the sparse level's histograms match
    ``make_sparse_level_fn`` of the JAX package (bitwise on integer
    stats), over the carry of each package's own dense level 3."""
    n, F, nbins = 2048, 5, 64
    B = nbins + 1
    bc, codes, st, rng = _level_case(11 + integer, n, F, nbins, integer, 1)
    st = st[0]
    leaf = np.zeros(n, np.int32)
    jl = lambda lf: (jnp.asarray(codes), jnp.asarray(lf)) \
        + tuple(map(jnp.asarray, st))                        # noqa: E731
    jcarry = carry = None
    for d in range(4):
        if d:
            leaf = (2 * leaf + (rng.random(n) < 0.45)).astype(np.int32)
        jfn = jhist.make_subtract_level_fn(d, F, B, n)
        _, jcarry = jfn(*jl(leaf)) if d == 0 else jfn(*jl(leaf), jcarry)
        _, carry = hist.make_subtract_level_fn(d, F, B)(
            torch.from_numpy(codes), torch.from_numpy(leaf),
            *torch.from_numpy(st), carry)
    # level 4 from 8 parents, 6 of them valid, in 10 slots: the fifth and
    # sixth valid parents' pairs are dropped
    d, Ap, A = 4, 8, 10
    valid = np.array([1, 0, 1, 1, 1, 0, 1, 1], bool)
    jcb, jps, jreal = jhist.sparse_slot_maps(jnp.asarray(valid), A)
    cb, ps, real, sol, _ = shared._slot_maps(
        d, A, torch.from_numpy(valid)[None], None, None)
    np.testing.assert_array_equal(cb[0].numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(ps[0].numpy(), np.asarray(jps))
    np.testing.assert_array_equal(real[0].numpy(), np.asarray(jreal))
    assert int(real.sum()) == A and int((sol[0] < A).sum()) == A
    leaf = (2 * leaf + (rng.random(n) < 0.45)).astype(np.int32)
    sleaf = sol[0][torch.from_numpy(leaf).long()]
    jfn = jhist.make_sparse_level_fn(Ap, A, F, B, n)
    jH, _ = jfn(jnp.asarray(codes), jnp.asarray(sleaf.numpy().astype(
        np.int32)), *map(jnp.asarray, st), jcarry, jps)
    H, _ = hist.make_sparse_level_fn(Ap, A, F, B)(
        torch.from_numpy(codes), sleaf, torch.from_numpy(st), carry, ps[0])
    got, want = H.numpy(), np.asarray(jH)
    assert got.shape == want.shape == (3, A, F, B)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        for s in range(3):
            scale = max(float(np.abs(want[s]).sum()), 1.0)
            assert float(np.abs(got[s] - want[s]).max()) <= 1e-5 * scale


# ------------------------------------------------ (c) the slot budget binds

@pytest.fixture()
def shrunk_budget(monkeypatch):
    """Both packages' slot budget at 64 slots; the JAX package's cached
    builders are cleared before and after, so that no other test reuses a
    build made at this budget."""
    builders = (jshared.make_build_tree_fn, jshared.make_tree_scan_fn,
                jshared.make_multinomial_scan_fn)
    for fn in builders:
        fn.cache_clear()
    monkeypatch.setattr(jshared, "sparse_slot_budget", lambda F, B: 64)
    monkeypatch.setattr(hist, "sparse_slot_budget", lambda F, B: 64)
    yield 64
    for fn in builders:
        fn.cache_clear()


def test_slot_budget_overflow_matches_jax(frames, shrunk_budget):
    """At a budget of 64 slots a depth-9 binomial forest has more alive
    children than slots from some level on: both packages drop the same
    pairs there (the same valid at every level, so the same terminal
    children) and grow the same trees; the port's own build at the full
    budget drops none."""
    cols, jfr, fr = frames
    cfg = dict(_DRF, ntrees=1, max_depth=_BUDGET_DEPTH, **_KINDS["binomial"])
    jm = JDRF(**cfg).train(jfr)
    tm = DRF(device="cpu", **cfg).train(fr)
    _assert_same_trees(jm, tm, _BUDGET_DEPTH)
    F = len(tm.datainfo.specs)
    dropped = _dropped(tm, _BUDGET_DEPTH, 4, F, 32)
    assert sum(dropped.values()) > 0, dropped
    assert _dropped(jm, _BUDGET_DEPTH, 4, F, 32) == dropped


# ------------------------------------------------ (d) the batched K round

def test_batched_sparse_round_bitwise_k_loop(frames):
    """A sampled 3-class forest (row rate 0.7, mtries -1: per-split column
    draws drawn dense and gathered to the slots): the batched K-tree
    rounds are bitwise the K loop of single builds
    (``split_mode="separate"``)."""
    _, _, fr = frames
    cfg = dict(_DRF, **_KINDS["multinomial"], sample_rate=0.7, mtries=-1,
               max_depth=10)
    a = DRF(device="cpu", **cfg).train(fr)
    b = DRF(device="cpu", split_mode="separate", **cfg).train(fr)
    for sa, sb in zip(a.output["stacked"], b.output["stacked"]):
        assert torch.equal(sa.values, sb.values)
        for la, lb in zip(sa.levels, sb.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
    assert a.training_metrics.logloss == b.training_metrics.logloss


# ------------------------------------------------ (e) hist_layout="check"

def test_layout_check_passes_and_raises_on_overflow(frames, monkeypatch):
    """hist_layout="check" grows the first round dense and sparse on the
    real gradients and trains the sparse path (the trees of "auto"); where
    the slot budget binds it raises."""
    _, _, fr = frames
    cfg = dict(_DRF, **_KINDS["binomial"])
    tm = DRF(device="cpu", **cfg).train(fr)
    m = DRF(device="cpu", hist_layout="check", **cfg).train(fr)
    assert m.output["hist_layout"] == "sparse"
    for a, b in zip(m.output["stacked"].levels, tm.output["stacked"].levels):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    monkeypatch.setattr(hist, "sparse_slot_budget", lambda F, B: 16)
    with pytest.raises(AssertionError, match="disagree on valid"):
        DRF(device="cpu", hist_layout="check", **cfg).train(fr)


# --------------------------------------------- (f) the forest, published

def test_drf_publishes_and_serves(frames):
    """A trained forest publishes (``to_archive``: ``tree_average``) and
    the served answers are ``predict``'s (its averaged probabilities)."""
    cols, _, fr = frames
    tm = DRF(device="cpu", **dict(_DRF, **_KINDS["binomial"])).train(fr)
    n = 200
    rows = [{k: (str(int(v[i])) if k in ("carrier", "origin", "dest")
                 else float(v[i]))
             for k, v in cols.items()
             if k not in ("dep_delayed_15min", "delay_class")}
            for i in range(n)]
    ent = batcher.publish("torch-drf-test", tm, device="cpu")
    try:
        got = ent.predict_rows(rows)
    finally:
        batcher.shutdown_all()
    assert ent.scorer.avg
    want = tm.predict(fr)
    np.testing.assert_allclose(
        got["probabilities"],
        np.stack([want.vec(c).to_numpy()[:n] for c in ("NO", "YES")], 1),
        rtol=1e-5, atol=1e-7)


# --------------------------------------------- (g) a deep grid cohort

def test_deep_xgboost_cohort_bitwise_sequential(frames):
    """An XGBoost cohort at max_depth 7, past a threshold of 4, grows
    batched node-sparse levels: each member (sampled) is bitwise its own
    sequential train at the same depth, whatever the cohort's size."""
    _, _, fr = frames
    kw = dict(response_column="dep_delayed_15min",
              ignored_columns=["delay_class"], max_depth=7, nbins=32, seed=3,
              ntrees=2, sparse_depth_threshold=4, sample_rate=0.8,
              col_sample_rate=0.7, device="cpu")
    hp = {"learn_rate": [0.1, 0.3], "reg_lambda": [0.0, 1.0]}
    g = GridSearch(XGBoost, hp, grid_batch="on", **kw).train(fr)
    assert len(g.models) == 4
    for m in g.models:
        assert m.output["grid_cohort"]["size"] == 4
        assert m.output["hist_layout"] == "sparse"
        assert m.output["effective_max_depth"] == 7
        p = m.params
        s = XGBoost(**dict(kw, learn_rate=p.learn_rate,
                           reg_lambda=p.reg_lambda)).train(fr)
        a, b = m.output["stacked"], s.output["stacked"]
        assert torch.equal(a.values, b.values)
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
