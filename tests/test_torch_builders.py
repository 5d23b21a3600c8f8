"""h2o3_tpu_torch's DecisionTree, IsolationForest, ExtendedIsolationForest
and UpliftDRF held against the JAX package's.

Both packages import the same CSV, written here from
``np.random.default_rng(21)`` in the manner of ``tests/test_algos3.py``:
1,200 rows of four f32 features (``%.9g``), a five-level categorical, a
treatment arm and a binary response with a planted treatment effect.
Every model is trained by both packages from its own import, unsampled
(``sample_rate=1``, ``mtries=-2``: the packages' random bits differ by
design); an isolation forest's draws are the same numpy draws in both.
Tolerances: trees exactly, level by level (valid, feature, NA direction
and thresholds bitwise; an EIF's normals and offsets bitwise), leaf
values bitwise for the isolation trees and to rtol 1e-5 otherwise,
predictions to rtol 1e-5, uplift metrics (``qini``, ``ate``) to 1e-6.
A DT and an uplift case run at a shrunken slot budget so that the
node-sparse levels drop children.  The port is also held against itself:
an uplift forest's split modes and crosschecks, and its exports served
through ``PackedScorer`` on the CPU.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.frame import parse as JP
from h2o3_tpu.metrics.uplift import uplift_metrics as j_uplift_metrics
from h2o3_tpu.models import (DecisionTree as JDT,
                             ExtendedIsolationForest as JEIF,
                             IsolationForest as JIF, UpliftDRF as JUplift)
from h2o3_tpu.models.tree import shared as jshared
from h2o3_tpu.models.tree import uplift as juplift

from h2o3_tpu_torch import import_file
from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.metrics.uplift import uplift_metrics
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.dt import DecisionTree
from h2o3_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                               IsolationForest)
from h2o3_tpu_torch.models.tree.uplift import UpliftDRF
from h2o3_tpu_torch.serving.kernel import PackedScorer

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 1200
_UPLIFT = dict(response_column="y", treatment_column="treatment", ntrees=2,
               max_depth=4, seed=1, sample_rate=1.0, nbins=32)
_DT = dict(response_column="y", ignored_columns=["treatment"], max_depth=4,
           nbins=32, seed=1)
_ISO = dict(ignored_columns=["y", "treatment"], ntrees=4, max_depth=6,
            sample_size=200, seed=3)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The uplift CSV and both packages' imports of it."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(N, 4)).astype(np.float32)
    X[rng.random((N, 4)) < 0.03] = np.nan
    c = rng.integers(0, 5, N)
    treat = rng.integers(0, 2, N)
    base = 1 / (1 + np.exp(-np.nan_to_num(X[:, 1]) - 0.3 * (c == 2)))
    effect = np.where(np.nan_to_num(X[:, 0]) > 0, 0.3, -0.05)
    y = rng.random(N) < np.clip(base + treat * effect, 0.01, 0.99)
    path = tmp_path_factory.mktemp("builders") / "uplift.csv"
    with open(path, "w") as f:
        f.write("x0,x1,x2,x3,c,treatment,y\n")
        for i in range(N):
            xs = ["" if np.isnan(v) else "%.9g" % v for v in X[i]]
            f.write(",".join(xs + [f"k{c[i]}",
                                   ("control", "treatment")[treat[i]],
                                   ("no", "yes")[int(y[i])]]) + "\n")
    return JP.import_file(str(path)), import_file(str(path), device="cpu")


def _assert_same_trees(jtrees, ttrees, depth, values_rtol=1e-5):
    assert len(jtrees) == len(ttrees) > 0
    for t, (a, b) in enumerate(zip(jtrees, ttrees)):
        assert len(a.feat) == len(b.feat) == depth
        for d in range(depth):
            msg = f"tree {t} level {d}"
            for name in ("valid", "feat", "na_left"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].cpu().numpy(),
                    err_msg=f"{name} {msg}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].cpu().numpy().view(np.int32), err_msg=f"thr {msg}")
        np.testing.assert_allclose(b.values.cpu().numpy(),
                                   np.asarray(a.values), rtol=values_rtol,
                                   atol=1e-7 if values_rtol else 0)


def _col(fr, name):
    return np.asarray(fr.vec(name).to_numpy(), np.float64)


@pytest.fixture()
def shrunk_budget(monkeypatch):
    """Both packages' slot budget at 16 slots (the JAX package's cached
    builders cleared before and after)."""
    builders = (jshared.make_build_tree_fn, jshared.make_tree_scan_fn,
                jshared.make_multinomial_scan_fn)
    for fn in builders:
        fn.cache_clear()
    for mod in (jshared, juplift):
        monkeypatch.setattr(mod, "sparse_slot_budget", lambda F, B: 16)
    monkeypatch.setattr(hist, "sparse_slot_budget", lambda F, B: 16)
    yield 16
    for fn in builders:
        fn.cache_clear()


def _dropped(trees, A_lv):
    """Alive children past the slot budget, over the trees' sparse
    levels."""
    return sum(max(0, 2 * int(np.asarray(t.valid[d - 1]).sum()) - A)
               for t in trees for d, A in A_lv.items())


# ------------------------------------------------------------------- uplift

@pytest.mark.parametrize("metric", ["KL", "chi_squared"])
def test_uplift_matches_jax(frames, metric):
    """Two uplift trees at depth 4 (dense levels): the same trees, the
    same leaf probabilities of both arms, predictions to rtol 1e-5, the
    training and a ``model_performance`` qini and ate to 1e-6."""
    jfr, tfr = frames
    cfg = dict(_UPLIFT, uplift_metric=metric)
    jm = JUplift(**cfg).train(jfr)
    tm = UpliftDRF(device="cpu", **cfg).train(tfr)
    _assert_same_trees(jm.output["trees"], tm.output["trees"], 4)
    np.testing.assert_allclose(tm.output["stacked_pc"].values.numpy(),
                               np.asarray(jm.output["stacked_pc"].values),
                               rtol=1e-5, atol=1e-7)
    got, want = tm.predict(tfr), jm.predict(jfr)
    for c in ("uplift_predict", "p_y1_ct1", "p_y1_ct0"):
        np.testing.assert_allclose(got.vec(c).to_numpy(), _col(want, c),
                                   rtol=1e-5, atol=1e-7)
    for a, b in ((jm.training_metrics, tm.training_metrics),
                 (jm.model_performance(jfr), tm.model_performance(tfr))):
        for name in ("qini", "ate"):
            assert abs(a.describe()[name] - b.describe()[name]) <= 1e-6


def test_uplift_sparse_levels_match_jax(frames, shrunk_budget):
    """Depth 6 with node-sparse levels from depth 3 at 16 slots: both
    packages drop the same pairs and grow the same tree."""
    jfr, tfr = frames
    cfg = dict(_UPLIFT, ntrees=1, max_depth=6, sparse_depth_threshold=3,
               min_rows=5.0)
    jm = JUplift(**cfg).train(jfr)
    tm = UpliftDRF(device="cpu", **cfg).train(tfr)
    assert tm.output["hist_layout"] == jm.output["hist_layout"] == "sparse"
    _assert_same_trees(jm.output["trees"], tm.output["trees"], 6)
    _, A_lv, _ = shared.sparse_geometry(6, 32, 5, 3, "sparse")
    assert _dropped(list(tm.output["trees"]), A_lv) > 0
    np.testing.assert_allclose(
        tm.predict(tfr).vec("uplift_predict").to_numpy(),
        _col(jm.predict(jfr), "uplift_predict"), rtol=1e-5, atol=1e-7)


def _same_where_valid(a, b) -> bool:
    """Two stacks with the same valid, the same feature and threshold
    where valid, and the same leaf values, bitwise: a dense level keeps
    candidate records on dead nodes that a node-sparse level drops."""
    if not torch.equal(a.values, b.values):
        return False
    for (fa, ta, _, va), (fb, tb, _, vb) in zip(a.levels, b.levels):
        if not (torch.equal(va, vb) and torch.equal(fa[va], fb[vb])
                and torch.equal(ta[va], tb[vb])):
            return False
    return True


def test_uplift_modes_bitwise(frames):
    """The port against itself, sampled (row rate 0.8, mtries 2), with
    node-sparse levels from depth 3: the two arms in one launch per level
    bitwise a launch per arm (``split_mode="separate"``); the dense
    layout, the full rebuild and the three crosschecks give the same
    trees (the same valid, the same splits where valid) and leaf
    values."""
    _, tfr = frames
    cfg = dict(_UPLIFT, sample_rate=0.8, mtries=2, max_depth=6,
               sparse_depth_threshold=3)
    base = UpliftDRF(device="cpu", **cfg).train(tfr)
    assert base.output["hist_layout"] == "sparse"
    sep = UpliftDRF(device="cpu", split_mode="separate", **cfg).train(tfr)
    for key in ("stacked_pt", "stacked_pc"):
        a, b = base.output[key], sep.output[key]
        assert torch.equal(a.values, b.values)
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
    for extra in (dict(hist_layout="dense"), dict(hist_mode="full"),
                  dict(hist_layout="check"), dict(split_mode="check"),
                  dict(hist_mode="check")):
        other = UpliftDRF(device="cpu", **cfg, **extra).train(tfr)
        for key in ("stacked_pt", "stacked_pc"):
            assert _same_where_valid(base.output[key], other.output[key]), \
                extra
        np.testing.assert_array_equal(
            other.predict(tfr).vec("uplift_predict").to_numpy(),
            base.predict(tfr).vec("uplift_predict").to_numpy())


def test_uplift_metrics_copy_matches_jax():
    rng = np.random.default_rng(2)
    p, y, t = rng.normal(size=500), rng.random(500) < 0.4, \
        rng.random(500) < 0.5
    w = rng.random(500)
    for kw in ({}, {"weights": w, "nbins": 37}):
        a, b = uplift_metrics(p, y, t, **kw), j_uplift_metrics(p, y, t, **kw)
        assert a.describe() == b.describe() and a.nobs == b.nobs


# --------------------------------------------------------------------- DT

def test_dt_matches_jax_and_serves(frames):
    """A depth-4 DT: the same tree and class probabilities as the JAX
    package's; exported (``tree_average``: its one tree averaged) and
    served through ``PackedScorer`` and the numpy ``ScoringModel`` with
    its own probabilities."""
    jfr, tfr = frames
    jm = JDT(**_DT).train(jfr)
    tm = DecisionTree(device="cpu", **_DT).train(tfr)
    assert tm.algo == "dt" and tm.output["ntrees_trained"] == 1
    _assert_same_trees(jm.output["trees"], tm.output["trees"], 4)
    got = tm.predict(tfr)
    np.testing.assert_allclose(got.vec("yes").to_numpy(),
                               _col(jm.predict(jfr), "yes"), rtol=1e-5)
    meta, arrays = tm.to_archive()
    assert meta["tree_average"] is True and meta["family"] == "tree"
    sm = from_reference(meta, arrays)
    X = tm._design(tfr)[: tfr.nrows].numpy()
    probs = PackedScorer(sm, device="cpu").score(X)
    np.testing.assert_allclose(probs, sm.score_raw(X), rtol=1e-6)
    np.testing.assert_allclose(probs[:, 1], got.vec("yes").to_numpy(),
                               rtol=1e-5)


def test_dt_sparse_levels_match_jax(frames, shrunk_budget):
    """DT at depth 6, node-sparse from depth 3 at 16 slots: the JAX
    package's tree, dropped pairs and all."""
    jfr, tfr = frames
    cfg = dict(_DT, max_depth=6, sparse_depth_threshold=3, min_rows=2.0)
    jm = JDT(**cfg).train(jfr)
    tm = DecisionTree(device="cpu", **cfg).train(tfr)
    assert tm.output["hist_layout"] == "sparse"
    _assert_same_trees(jm.output["trees"], tm.output["trees"], 6)
    _, A_lv, _ = shared.sparse_geometry(6, 32, 5, 3, "sparse")
    assert _dropped(list(tm.output["trees"]), A_lv) > 0


# -------------------------------------------------------- isolation forests

def test_isolation_forest_matches_jax_and_serves(frames):
    """The same isolation trees (path lengths bitwise) and anomaly scores
    as the JAX package's; the export is the JAX package's with its
    pass-through nodes, and the numpy ``ScoringModel`` and
    ``PackedScorer`` score it as ``predict`` does."""
    jfr, tfr = frames
    jm = JIF(**_ISO).train(jfr)
    tm = IsolationForest(device="cpu", **_ISO).train(tfr)
    _assert_same_trees(jm.output["trees"], tm.output["trees"], 6,
                       values_rtol=0)
    got = tm.predict(tfr)
    want = jm.predict(jfr)
    for c in ("predict", "mean_length"):
        np.testing.assert_allclose(got.vec(c).to_numpy(), _col(want, c),
                                   rtol=1e-5)
    assert tm.model_performance(tfr) == pytest.approx(
        jm.model_performance(jfr), rel=1e-5)
    # the JAX package's export, less its fault: a node that did not split
    # but has splitting descendants is written as a pass-through split
    # (threshold NaN, NA left: every row left), so that the packed walk
    # goes on to them as ``predict`` does
    jmeta, jarr = jmojo._extract(jm)
    meta, arrays = tm.to_archive()
    assert {k: meta[k] for k in jmeta if k != "datainfo"} == \
        {k: v for k, v in jmeta.items() if k != "datainfo"}
    assert set(arrays) == set(jarr)
    passed = 0
    for d in range(6):
        va, vb = arrays[f"valid_{d}"], jarr[f"valid_{d}"]
        through = va & ~vb
        below = np.zeros_like(vb)
        for e in range(d + 1, 6):          # any valid descendant
            below |= jarr[f"valid_{e}"].reshape(*vb.shape, -1).any(-1)
        np.testing.assert_array_equal(through, ~vb & below)
        assert np.isnan(arrays[f"thr_{d}"][through]).all()
        assert arrays[f"na_left_{d}"][through].all()
        for k in ("feat", "thr", "na_left"):
            np.testing.assert_array_equal(arrays[f"{k}_{d}"][vb],
                                          jarr[f"{k}_{d}"][vb])
        passed += int(through.sum())
    assert passed > 0
    np.testing.assert_array_equal(arrays["values"], jarr["values"])
    sm = from_reference(meta, arrays)
    X = tm._design(tfr)[: tfr.nrows].numpy()
    np.testing.assert_allclose(sm.score_raw(X), got.vec("predict")
                               .to_numpy(), rtol=1e-5)
    np.testing.assert_allclose(PackedScorer(sm, device="cpu").score(X)[:, 0],
                               sm.score_raw(X), rtol=1e-6)


def test_extended_isolation_forest_matches_jax(frames):
    """EIF at extension level 2: the same normals, offsets, valid and
    path lengths bitwise, anomaly scores to rtol 1e-5."""
    jfr, tfr = frames
    cfg = dict(_ISO, extension_level=2)
    jm = JEIF(**cfg).train(jfr)
    tm = ExtendedIsolationForest(device="cpu", **cfg).train(tfr)
    for a, b in zip(jm.output["trees"], tm.output["trees"]):
        for name in ("normals", "offsets", "valid"):
            for x, y in zip(getattr(a, name), getattr(b, name)):
                np.testing.assert_array_equal(np.asarray(x), y)
        np.testing.assert_array_equal(np.asarray(a.values), b.values)
    np.testing.assert_allclose(
        tm.predict(tfr).vec("anomaly_score").to_numpy(),
        _col(jm.predict(jfr), "anomaly_score"), rtol=1e-5)
