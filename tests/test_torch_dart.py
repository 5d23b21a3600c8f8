"""h2o3_tpu_torch's DART booster held against the JAX package's.

``XGBoost(booster="dart")`` trains both packages on the airlines-shaped
bench frame at 1,984 rows (a multiple of the JAX mesh's 64-row padding)
with ``sample_rate = col_sample_rate = 1``: the row sample and per-split
masks are the port's own keyed streams (``shared.draw_generator``), while
the per-tree column mask and the drops come from
``np.random.default_rng(seed)`` in the JAX package's order, so the drop
sets, the per-tree masks and with them the trees are the JAX package's.
All of it runs on the CPU, where the port's kernel wrappers take their
plain torch versions.

Tolerances.  The JAX side sums its histograms in f32 over the suite's
8-device CPU mesh, the port in int64 fixed point: the splits agree where
every winning gain clears its runner-up, and the checks below hold every
level of every tree bitwise in valid, feature, NA direction and
threshold.  Leaf values agree to rtol 1e-5 beside an atol of 1e-5 of the
tree's largest value (a leaf near zero carries the f32 noise of the
larger ones); predictions to rtol 1e-5 (probabilities) or 1e-5 of the
largest (regression); the training metric to 1e-5.  Inside the port the
batched K = 3 round is bitwise its K loop.
"""

import time

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import XGBoost as JXGBoost

from bench import make_airlines_like

from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import GridSearch
from h2o3_tpu_torch.models.tree import gbm, hist, shared
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.runtime.observability import timeline_events
from h2o3_tpu_torch.serving import kernel
from h2o3_tpu_torch.testing import delay_class

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 1984
DEPTH = 4
_BASE = dict(booster="dart", max_depth=DEPTH, nbins=32, seed=1, ntrees=6,
             score_tree_interval=10 ** 9)
_BIN = dict(_BASE, response_column="dep_delayed_15min",
            ignored_columns=["delay_class"])
CASES = {
    # rate_drop with one_drop, "tree" normalization, a validation frame
    # scored every 2 rounds
    "binomial": dict(_BIN, rate_drop=0.3, one_drop=True, ntrees=4,
                     score_tree_interval=2),
    # skip_drop 0.5 with "forest" normalization on a regression
    "regression": dict(_BASE, response_column="distance",
                       ignored_columns=["dep_delayed_15min", "delay_class"],
                       rate_drop=0.5, skip_drop=0.5,
                       normalize_type="forest"),
    # 3 class trees a round, one batched build (seed 2: under seed 1's
    # drops one level-3 node has two features within 3e-7 of the gain)
    "multinomial": dict(_BASE, response_column="delay_class",
                        ignored_columns=["dep_delayed_15min"], ntrees=4,
                        rate_drop=0.3, one_drop=True, seed=2),
    # the per-tree column mask from the numpy draws
    "col_sample": dict(_BIN, rate_drop=0.3, col_sample_rate_per_tree=0.7),
}


def _columns(n=N):
    cols, types, domains = make_airlines_like(n)
    cols["delay_class"] = delay_class(cols)
    return cols, types, domains


@pytest.fixture(scope="module")
def frames():
    cols, types, domains = _columns()
    fr = Frame.from_numpy(cols, types=types, domains=domains, device="cpu")
    jfr = JFrame.from_numpy(cols, types=types, domains=domains)
    return cols, types, domains, fr, jfr


def _valid_pair(types, domains):
    """A validation frame: the bench frame's draws at 640 rows."""
    cols, _, _ = _columns(640)
    return (Frame.from_numpy(cols, types=types, domains=domains,
                             device="cpu"),
            JFrame.from_numpy(cols, types=types, domains=domains))


def _train(frames, case):
    _, types, domains, fr, jfr = frames
    cfg = CASES[case]
    if case == "binomial":
        vf, jvf = _valid_pair(types, domains)
        return (XGBoost(device="cpu", **cfg).train(fr, valid=vf),
                JXGBoost(**cfg).train(jfr, valid=jvf))
    return XGBoost(device="cpu", **cfg).train(fr), JXGBoost(**cfg).train(jfr)


def _class_trees(tree):
    return tree if isinstance(tree, list) else [tree]


def _assert_same_trees(jm, tm):
    jt, tt = list(jm.output["trees"]), list(tm.output["trees"])
    assert len(jt) == len(tt) == tm.params.ntrees
    for jr, tr in zip(jt, tt):
        for a, b in zip(_class_trees(jr), _class_trees(tr)):
            assert len(a.feat) == len(b.feat) == DEPTH
            for d in range(DEPTH):
                for name in ("valid", "feat", "na_left"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, name)[d]),
                        getattr(b, name)[d].numpy(), err_msg=f"{name} {d}")
                np.testing.assert_array_equal(
                    np.asarray(a.thr[d]).view(np.int32),
                    b.thr[d].numpy().view(np.int32))
            av, bv = np.asarray(a.values), b.values.numpy()
            np.testing.assert_allclose(bv, av, rtol=1e-5,
                                       atol=1e-5 * np.abs(av).max())


def _assert_predictions(jm, tm, fr, jfr):
    p, jp = tm.predict(fr), jm.predict(jfr)
    if tm.datainfo.is_classifier:
        for c in tm.datainfo.response_domain:
            np.testing.assert_allclose(p.vec(str(c)).to_numpy(),
                                       np.asarray(jp.vec(str(c)).to_numpy()),
                                       rtol=1e-5)
    else:
        want = np.asarray(jp.vec("predict").to_numpy())
        np.testing.assert_allclose(p.vec("predict").to_numpy(), want,
                                   rtol=1e-5, atol=1e-5 * np.abs(want).max())


_METRIC = {"binomial": ("logloss", "auc"), "col_sample": ("logloss", "auc"),
           "regression": ("rmse", "mae"),
           "multinomial": ("logloss", "mean_per_class_error")}


def _min_margin(monkeypatch, fr, cfg):
    """Retrain with the records captured: over every valid node of every
    tree, the least relative gap of its winning feature's gain over the
    runner-up's that is not an exact tie (a structural tie: the same
    rows either way, so the same sums and the same first-index pick)."""
    records = []
    real = hist.split_records

    def spy(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]
    monkeypatch.setattr(hist, "split_records", spy)
    m = XGBoost(device="cpu", **cfg).train(fr)
    gaps = []
    for t, rnd in enumerate(m.output["trees"]):
        for k, tree in enumerate(_class_trees(rnd)):
            for d in range(DEPTH):
                g = records[DEPTH * t + d][..., 0].sort(
                    dim=1, descending=True).values
                for l in np.flatnonzero(tree.valid[d].numpy()):
                    top, second = (float(x) for x in g[k * 2 ** d + l, :2])
                    if top != second:
                        gaps.append((top - second) / abs(top))
    return min(gaps)


@pytest.mark.parametrize("case", list(CASES))
def test_dart_matches_jax(frames, case, monkeypatch):
    """Every tree of every round, level by level, as the JAX package's;
    leaf values, predictions and the training metric within the stated
    tolerances; every winning gain that is not an exact tie clears its
    runner-up by more than 1e-3.  The binomial case also scores a
    validation frame every 2 rounds from all trees (DART rescales earlier
    ones): its scoring history is the JAX package's."""
    cols, _, _, fr, jfr = frames
    tm, jm = _train(frames, case)
    K = 3 if case == "multinomial" else 1
    assert tm.output["nclass_trees"] == K
    _assert_same_trees(jm, tm)
    _assert_predictions(jm, tm, fr, jfr)
    a, b = jm.training_metrics, tm.training_metrics
    for name in _METRIC[case]:
        assert abs(getattr(a, name) - getattr(b, name)) <= 1e-5 * max(
            1.0, abs(getattr(a, name))), name
    if case == "binomial":
        assert len(tm.scoring_history) == len(jm.scoring_history) == 2
        for h, jh in zip(tm.scoring_history, jm.scoring_history):
            assert h["iteration"] == jh["iteration"]
            for key in ("logloss", "valid_logloss", "valid_auc"):
                assert abs(h[key] - jh[key]) <= 1e-5, key
        assert abs(tm.validation_metrics.auc
                   - jm.validation_metrics.auc) <= 1e-5
    assert _min_margin(monkeypatch, fr, CASES[case]) > 1e-3


# ------------------------------------------------------- port-side checks

def test_dart_batched_round_bitwise_k_loop(frames):
    """A K = 3 DART round as one batched build (one ``hist`` and one
    records launch per level) is bitwise its K loop
    (``split_mode="separate"``): trees, rescaled leaf values and
    probabilities, with row and column sampling on; the per-round list
    form ``output["trees"][t][k]`` holds each round's class trees."""
    *_, fr, _ = frames
    cfg = dict(CASES["multinomial"], sample_rate=0.8, col_sample_rate=0.8,
               col_sample_rate_per_tree=0.7)
    mb = XGBoost(device="cpu", **cfg).train(fr)
    ms = XGBoost(device="cpu", split_mode="separate", **cfg).train(fr)
    for a, b in zip(mb.output["stacked"], ms.output["stacked"]):
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                                   else x, y.view(torch.int32)
                                   if y.is_floating_point() else y)
        assert torch.equal(a.values.view(torch.int32),
                           b.values.view(torch.int32))
    rounds = mb.output["trees"]
    assert len(rounds) == cfg["ntrees"] and len(rounds[0]) == 3
    assert torch.equal(rounds[2][1].values, mb.output["stacked"][1].values[2])
    pb, ps = mb.predict(fr), ms.predict(fr)
    for c in ("LONG", "NO", "SHORT"):
        np.testing.assert_array_equal(pb.vec(c).to_numpy(),
                                      ps.vec(c).to_numpy())


def test_dart_leaf_lookup_agrees_with_traversal(frames, monkeypatch):
    """The training scores F, updated by leaf lookups, rescaled and less
    (1 - a) S_D, equal the traversal of the final (rescaled) ensemble over
    the raw design to rtol 1e-5 of its range: the partition's leaves and
    the thresholds' agree on every row.  The drops happened: some
    round's S_D was traversed."""
    *_, fr, _ = frames
    seen, drops = {}, []
    real_fin, real_drop = gbm.GBM._finalize_fused, gbm.tree_scores

    def fin(self, model, di, dist, F, *a, **k):
        seen["F"] = F
        return real_fin(self, model, di, dist, F, *a, **k)

    def drop(trees, X, K):
        drops.append(len(trees))
        return real_drop(trees, X, K)
    monkeypatch.setattr(gbm.GBM, "_finalize_fused", fin)
    monkeypatch.setattr(gbm, "tree_scores", drop)
    m = XGBoost(device="cpu", **dict(CASES["binomial"],
                                     score_tree_interval=10 ** 9)).train(fr)
    raw = m._raw_scores(m._design(fr))
    F = seen["F"]
    assert drops and F.shape == raw.shape
    assert float((F - raw).abs().max()) <= 1e-5 * float(raw.abs().max())


def test_dart_served_through_packed_scorer(frames):
    """A DART model's archive (rescaled leaf values) packs and scores
    through ``PackedScorer`` (the traversal wrapper, plain on the CPU) as
    ``predict`` does, binomial and 3-class."""
    cols, *_, fr, _ = frames
    for case in ("binomial", "multinomial"):
        cfg = dict(CASES[case], score_tree_interval=10 ** 9)
        m = XGBoost(device="cpu", **cfg).train(fr)
        ps = kernel.PackedScorer(from_reference(*m.to_archive()),
                                 device="cpu")
        X = m._design(fr)[:N].numpy()
        got = ps.score(X, score_mode="check")
        dom = [str(d) for d in m.datainfo.response_domain]
        pred = m.predict(fr)
        want = np.stack([pred.vec(c).to_numpy() for c in dom], axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dart_grid_takes_wave_path(frames):
    """A grid of DART members trains on the wave path: no member carries
    a cohort tag, the reason lands on the timeline, and each member is
    bitwise its own train."""
    *_, fr, _ = frames
    cfg = dict(CASES["binomial"], ntrees=3, score_tree_interval=10 ** 9)
    t0 = time.time()
    g = GridSearch(XGBoost, {"rate_drop": [0.1, 0.5]}, grid_batch="auto",
                   device="cpu", **{k: v for k, v in cfg.items()
                                    if k != "rate_drop"}).train(fr)
    assert len(g.models) == 2
    assert all(m.output.get("grid_cohort") is None for m in g.models)
    assert any("dart" in str(e.get("reason"))
               for e in timeline_events(2000)
               if e["kind"] == "grid_batch_fallback" and e["ts"] >= t0)
    for m in g.models:
        solo = XGBoost(device="cpu", **dict(cfg, rate_drop=m.params
                                            .rate_drop)).train(fr)
        assert torch.equal(m.output["stacked"].values,
                           solo.output["stacked"].values)


def test_dart_hier_and_defaults(frames):
    """DART under the hierarchical search grows its K class trees as the
    K loop of single hierarchical builds; ``rate_drop = 0`` (the
    default) drops nothing and equals gbtree with the same learn rate."""
    *_, fr, _ = frames
    cfg = dict(CASES["multinomial"], ntrees=2)
    m = XGBoost(device="cpu", split_search="hier", **cfg).train(fr)
    assert m.output["split_search"] == "hier" and len(m.output["trees"]) == 2
    plain = dict(_BIN, ntrees=3)
    md = XGBoost(device="cpu", **plain).train(fr)
    mg = XGBoost(device="cpu", **dict(plain, booster="gbtree")).train(fr)
    for a, b in zip(shared.StackedTrees.to_tree_list(md.output["stacked"]),
                    mg.output["trees"]):
        for d in range(DEPTH):
            assert torch.equal(a.feat[d], b.feat[d])
        np.testing.assert_allclose(a.values.numpy(), b.values.numpy(),
                                   rtol=1e-6, atol=1e-7)
