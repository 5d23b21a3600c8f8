"""h2o3_tpu_torch's tree options held against the JAX package: monotone
constraints, probability calibration, and the accepted-but-inert
``hist_precision`` / ``reproducible`` (exclusive feature bundling is in
tests/test_torch_efb.py, which keeps each file's JAX compiles inside
30 s).

The same numpy inputs from one seed go through the JAX function and its
port: the monotone split records (``_split_records_torch(mono=)`` and
``finish_splits`` against the JAX package's XLA ``best_splits(mono=)``),
a constrained GBM and XGBoost trained by both packages, and the
calibration curves.  All of it runs on the CPU, where the kernel wrappers
take their plain torch versions.

Tolerances.  The records are bitwise on integer-valued histograms (every
partial sum exact, the trick of tests/test_mesh_hier.py).  Trained trees
have the same (feature, threshold, NA direction, valid) on every level
(the frame's signal leaves no near-tied gains), leaf values agree to
rtol 1e-5 and predictions to rtol 1e-4 (f32 sums in another order).  The
calibration tolerances are stated above their tests.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import GBM as JGBM
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models import isotonic as jiso
from h2o3_tpu.models.tree import hist as jhist
from h2o3_tpu.models.tree.shared import SharedTreeModel as JSharedTreeModel

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DRF, DecisionTree
from h2o3_tpu_torch.models import isotonic
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.isofor import IsolationForest
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.testing import same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)


def _int_hist(rng, L, F, B):
    """Integer-valued H [3, L, F, B] with a populated NA bin."""
    g = rng.integers(-4, 5, (L, F, B))
    h = rng.integers(0, 4, (L, F, B))
    c = rng.integers(0, 4, (L, F, B))
    return np.stack([g, h, c]).astype(np.float32)


def _same_trees(ja, tb, depth, rtol=1e-5):
    jt, tt = list(ja.output["trees"]), list(tb.output["trees"])
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        for d in range(depth):
            for name in ("feat", "na_left", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {d}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].numpy().view(np.int32))
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=rtol, atol=1e-6)


def _col(m, fr, name):
    return np.asarray(m.predict(fr).vec(name).to_numpy())


# ---------------------------------------------------------------- monotone

@pytest.mark.parametrize("params", [(0.0, 1.0, 0.0, 0.0, 0.0),
                                    (1.0, 2.0, 0.5, 1.0, 0.5)],
                         ids=["plain", "regularised"])
def test_monotone_records_bitwise_jax_best_splits(params):
    """The monotone records (plain version and wrapper) with
    ``finish_splits`` are bitwise the JAX package's ``best_splits(mono=)``
    on every output, and the constraints change the choice somewhere."""
    lam, rows, alpha, gamma, mcw = params
    rng = np.random.default_rng(5)
    L, F, nbins = 8, 5, 16
    H = _int_hist(rng, L, F, nbins + 1)
    mono = np.asarray([1, -1, 0, 1, -1], np.float32)
    want = jhist.best_splits(jnp.asarray(H), nbins, lam, rows, 1e-5, None,
                             alpha, gamma, mcw, mono=jnp.asarray(mono))
    Ht, mt = torch.from_numpy(H), torch.from_numpy(mono)
    for rec in (hist._split_records_torch(Ht, lam, rows, alpha, gamma, mcw,
                                          mt),
                hist.split_records(Ht, nbins, lam, rows, alpha, gamma, mcw,
                                   mono=mt)):
        got = hist.finish_splits(rec, rows, 1e-5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    free = hist.best_splits(Ht, nbins, lam, rows, 1e-5, None, alpha, gamma,
                            mcw)
    assert not all(torch.equal(a, torch.as_tensor(np.asarray(b)))
                   for a, b in zip(free[:2], want[:2]))
    with pytest.raises(ValueError, match="mono"):
        hist.split_records(Ht, nbins, lam, rows, mono=mt[:3])


def _mono_frame(n=800, seed=7):
    """The JAX package's monotone test frame (tests/test_trees.py:283): a
    noisy sample of an increasing truth in x, a binary response of it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n)
    z = rng.normal(size=n)
    y = 2.0 * x + z * 2.0 + 1.5 * np.sin(2.5 * x)
    yb = np.where(y > np.median(y), "hi", "lo").astype(object)
    return {"x": x, "z": z, "y": y, "yb": yb}


@pytest.fixture(scope="module")
def mono_frames():
    cols = _mono_frame()
    return cols, JFrame.from_numpy(cols), Frame.from_numpy(cols,
                                                           device="cpu")


_MONO = {"gbm": ("y", 1), "xgboost": ("yb", -1)}


def _mono_cfg(algo):
    resp, direction = _MONO[algo]
    return dict(response_column=resp, ntrees=4, max_depth=2, nbins=16,
                learn_rate=0.3, seed=1, score_tree_interval=10 ** 9,
                monotone_constraints={"x": direction},
                ignored_columns=["yb" if resp == "y" else "y"])


@pytest.mark.parametrize("algo", ["gbm", "xgboost"])
def test_monotone_trees_match_jax(mono_frames, algo):
    """A constrained GBM (regression, increasing) and XGBoost (binomial,
    decreasing) grow the JAX package's trees, and predict it."""
    _, jfr, fr = mono_frames
    jcls, tcls = (JGBM, GBM) if algo == "gbm" else (JXGBoost, XGBoost)
    cfg = _mono_cfg(algo)
    jm, tm = jcls(**cfg).train(jfr), tcls(device="cpu", **cfg).train(fr)
    assert tm.output["hist_layout"] == "dense"
    _same_trees(jm, tm, 2)
    name = "predict" if algo == "gbm" else "lo"
    np.testing.assert_allclose(_col(tm, fr, name), _col(jm, jfr, name),
                               rtol=1e-4, atol=1e-6)


def test_monotone_sweep(mono_frames):
    """The JAX package's sweep (tests/test_trees.py:283-319) on the port:
    40 trees of depth 4 constrained increasing in x predict a monotone
    curve over 60 points of x, and a decreasing constraint mirrors it,
    GBM and XGBoost alike; the unconstrained GBM is not monotone."""
    _, _, fr = mono_frames
    grid = np.linspace(-3, 3, 60)
    probe = Frame.from_numpy({"x": grid, "z": np.zeros_like(grid)},
                             device="cpu")
    kw = dict(response_column="y", ignored_columns=["yb"], device="cpu",
              seed=1)
    for cls in (GBM, XGBoost):
        m = cls(ntrees=40, max_depth=4, learn_rate=0.2,
                monotone_constraints={"x": 1}, **kw).train(fr)
        assert (np.diff(_col(m, probe, "predict")) >= -1e-5).all()
        md = cls(ntrees=10, max_depth=3, monotone_constraints={"x": -1},
                 **kw).train(fr)
        assert (np.diff(_col(md, probe, "predict")) <= 1e-5).all()
    m0 = GBM(ntrees=40, max_depth=4, learn_rate=0.2, **kw).train(fr)
    assert (np.diff(_col(m0, probe, "predict")) < -1e-5).any()


def test_monotone_refusals(mono_frames):
    """The JAX package's refusals: DRF (and the other forests) do not
    enforce constraints, a multinomial response, a categorical or unknown
    column; the port also refuses the hierarchical search."""
    cols, _, fr = mono_frames
    mono = {"x": 1}
    for cls, kw in ((DRF, {"response_column": "y"}),
                    (DecisionTree, {"response_column": "y"}),
                    (IsolationForest, {})):
        with pytest.raises(ValueError, match="only enforced"):
            cls(ntrees=1, monotone_constraints=mono, device="cpu",
                **kw).train(fr)
    rng = np.random.default_rng(1)
    c3 = dict(cols, k=np.asarray(["a", "b", "c"], object)[
        rng.integers(0, 3, len(cols["x"]))])
    fr3 = Frame.from_numpy(c3, device="cpu")
    with pytest.raises(ValueError, match="multinomial"):
        GBM(response_column="k", ntrees=1, monotone_constraints=mono,
            ignored_columns=["y", "yb"], device="cpu").train(fr3)
    with pytest.raises(ValueError, match="categorical"):
        GBM(response_column="y", ntrees=1, monotone_constraints={"k": 1},
            ignored_columns=["yb"], device="cpu").train(fr3)
    with pytest.raises(ValueError, match="unknown"):
        GBM(response_column="y", ntrees=1, monotone_constraints={"w": 1},
            device="cpu").train(fr)
    with pytest.raises(NotImplementedError, match="monotone"):
        GBM(response_column="y", ntrees=1, monotone_constraints=mono,
            split_search="hier", device="cpu").train(fr)
    with pytest.raises(ValueError, match="does not compose"):
        GBM(response_column="y", ntrees=1, monotone_constraints=mono,
            hist_layout="sparse", device="cpu").train(fr)
    with pytest.raises(ValueError, match="does not compose"):
        GBM(response_column="y", ntrees=1, monotone_constraints=mono,
            tree_program="scan", device="cpu").train(fr)


# ------------------------------------------------------------- calibration
#
# The calibration fits run in the JAX package's numpy types (f32
# probabilities).  Given the same probabilities the two packages' fits
# agree to 1e-8 (bitwise here), so the JAX side is its ``_post_fit`` on a
# stub model that returns seeded probabilities: no JAX train.  The two
# packages' trained probabilities differ by f32 rounding, which Platt's
# slope over a compressed probability range magnifies (~2e-4 of a on a
# 4-tree model): end to end only the port's own fit is held.

class _StubModel:
    """The surface of a JAX binomial model that ``_post_fit`` and
    ``_calibration_curve`` read: seeded class-1 probabilities and a
    response of the calibration frame."""

    def __init__(self, p1, y):
        self.output = {}
        self._raw = jnp.asarray(np.stack([1 - p1, p1], axis=1))
        self.datainfo = types.SimpleNamespace(
            is_classifier=True, nclasses=2,
            response=lambda fr: jnp.asarray(y))

    def _score_matrix(self, frame):
        return None

    def _predict_raw(self, X):
        return self._raw


def _stub(n=3000, seed=21):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    p1 = (1 / (1 + np.exp(-(0.3 * z - 0.2)))).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.2 * z - 0.5)))) \
        .astype(np.float32)
    y[:7] = -1.0                          # missing classes are kept
    return p1, y


@pytest.mark.parametrize("method", ["platt", "isotonic"])
def test_calibration_fit_matches_jax(method):
    """The JAX package's calibration (its ``_post_fit``) and the port's
    ``fit_calibration`` of the same probabilities: Platt's (a, b) to
    1e-8, the isotonic knots bitwise; the port's curve of the same
    probabilities is the JAX package's ``_calibration_curve``."""
    p1, y = _stub()
    stub = _StubModel(p1, y)
    JXGBoost(response_column="y", calibrate_model=True,
             calibration_frame=types.SimpleNamespace(nrows=len(y)),
             calibration_method=method)._post_fit(stub, None, None)
    want = stub.output["calibration"]
    got = shared.fit_calibration(p1, y, method)
    assert got["method"] == want["method"] == method
    if method == "platt":
        assert abs(got["a"] - want["a"]) <= 1e-8
        assert abs(got["b"] - want["b"]) <= 1e-8
    else:
        np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
        np.testing.assert_array_equal(got["y"], np.asarray(want["y"]))
        assert (np.diff(got["y"]) >= 0).all()
    q = np.linspace(0.0, 1.0, 101).astype(np.float32)
    model = types.SimpleNamespace(output={"calibration": got})
    np.testing.assert_array_equal(
        shared.SharedTreeModel._calibration_curve(model, q),
        np.asarray(JSharedTreeModel._calibration_curve(stub, q)))


@pytest.fixture(scope="module")
def cal_frames():
    cols = _mono_frame(n=600, seed=8)
    return Frame.from_numpy(cols, device="cpu")


@pytest.mark.parametrize("method", ["platt", "isotonic"])
def test_calibrated_train_and_columns(mono_frames, cal_frames, method):
    """A calibrated train: the same trees as the uncalibrated train, its
    curve ``fit_calibration`` of its own calibration-frame probabilities,
    ``cal_p1`` the curve of the class-1 column and ``cal_p0`` its
    complement, bitwise (as the frame's f32); an isotonic curve
    non-decreasing."""
    _, _, fr = mono_frames
    cfg = _mono_cfg("xgboost")
    tm0 = XGBoost(device="cpu", **cfg).train(fr)
    tm = XGBoost(device="cpu", calibrate_model=True,
                 calibration_frame=cal_frames, calibration_method=method,
                 **cfg).train(fr)
    for la, lb in zip(tm.output["stacked"].levels,
                      tm0.output["stacked"].levels):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    raw = tm._predict_raw(tm._score_matrix(cal_frames))
    raw = raw[: cal_frames.nrows].numpy()
    y = tm.datainfo.response(cal_frames)[: cal_frames.nrows].numpy()
    cal = tm.output["calibration"]
    want = shared.fit_calibration(raw[:, 1], y, method)
    for k in want:
        np.testing.assert_array_equal(np.asarray(cal[k]),
                                      np.asarray(want[k]))
    curve = tm._calibration_curve(_col(tm, fr, "lo"))
    np.testing.assert_array_equal(_col(tm, fr, "cal_p1"),
                                  curve.astype(np.float32))
    np.testing.assert_array_equal(_col(tm, fr, "cal_p0"),
                                  (1.0 - curve).astype(np.float32))
    np.testing.assert_allclose(tm.calibrated_probabilities(fr), curve,
                               rtol=1e-6)
    if method == "isotonic":
        assert (np.diff(cal["y"]) >= 0).all()


def test_pav_bitwise_jax():
    rng = np.random.default_rng(2)
    for n in (1, 7, 500):
        y = rng.normal(size=n).cumsum() * rng.choice([-1, 1], n)
        w = rng.uniform(0.1, 3.0, n)
        np.testing.assert_array_equal(isotonic._pav(y, w),
                                      jiso._pav(y, w))


def test_calibration_refusals(mono_frames, cal_frames):
    """Calibration needs a frame, platt or isotonic, and a binomial
    response; an uncalibrated model has no curve."""
    _, _, fr = mono_frames
    tcal = cal_frames
    cfg = dict(_mono_cfg("xgboost"), ntrees=1, calibrate_model=True,
               device="cpu")
    with pytest.raises(ValueError, match="needs calibration_frame"):
        XGBoost(**cfg).train(fr)
    with pytest.raises(ValueError, match="platt | isotonic"):
        XGBoost(calibration_frame=tcal, calibration_method="beta",
                **cfg).train(fr)
    with pytest.raises(ValueError, match="binomial"):
        XGBoost(calibration_frame=tcal,
                **dict(cfg, response_column="y",
                       ignored_columns=["yb"])).train(fr)
    with pytest.raises(ValueError, match="not calibrated"):
        XGBoost(**dict(cfg, calibrate_model=False)).train(fr) \
            ._calibration_curve(np.zeros(3))


def test_precision_knobs_are_accepted_and_inert(mono_frames):
    """``hist_precision`` and ``reproducible`` (which the JAX package
    takes for its bf16/f32 histogram accumulation) are accepted and change
    no tree: the port's histograms are exact fixed point."""
    _, _, fr = mono_frames
    cfg = dict(_mono_cfg("gbm"), monotone_constraints=None, device="cpu")
    base = GBM(**cfg).train(fr)
    for kw in ({"hist_precision": "f32"}, {"reproducible": True}):
        m = GBM(**cfg, **kw).train(fr)
        assert {k: getattr(m.params, k) for k in kw} == kw
        for la, lb in zip(m.output["stacked"].levels,
                          base.output["stacked"].levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
        assert same_bits(m.output["stacked"].values,
                         base.output["stacked"].values)
