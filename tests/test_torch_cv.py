"""h2o3_tpu_torch's cross-validation and shared model options held
against the JAX package's.

The same numpy frame from one seed (640 rows, a multiple of the JAX
mesh's 64-row padding, so both packages hand a custom metric arrays of
one shape: four numerics, one with 5% NaN, a 5-level categorical, row
weights, a fold column and a binary response) goes through both packages
on the CPU: ``fold_assignment`` for every scheme, ``nfolds`` and
``fold_column`` on XGBoost and GLM, ``balance_classes`` and
``class_sampling_factors``, a ``custom_metric_func``, and the gains/lift
table.  The port's own contracts come after: every fold model is the
builder's train on the frame with its fold's weights zeroed, bitwise, on
XGBoost, DRF, GLM and DeepLearning, and the CV metrics are the metrics
of the assembled holdout predictions.

Tolerances.  The folds are numpy draws in both packages: bitwise.  The
trees of both packages are the same at this size (the training tests'
contract), their predictions to f32 rounding, so the holdout predictions
to rtol 1e-4 and the CV metrics to 1e-5; GLM as tests/test_torch_glm.py
holds it (coefficients 1e-5 of the largest), so its holdouts to rtol
1e-4, atol 1e-5 and its CV metrics to 1e-5.  The gains/lift table and KS
from the same predictions: rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.metrics import core as jcore
from h2o3_tpu.models import GLM as JGLM
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models import cv as jcv

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.metrics import core
from h2o3_tpu_torch.models import (DRF, GLM, DeepLearning, IsolationForest,
                                   UpliftDRF, cv)
from h2o3_tpu_torch.models import base
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 640
_TYPES = {"c": "cat"}
_DOMAINS = {"c": ["a", "b", "c", "d", "e"]}
XGB = dict(ntrees=3, max_depth=3, nbins=16, seed=1)
CV_TOL = 1e-5


def _columns(n=N, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[:, 1] *= 10.0
    c = rng.integers(0, 5, n)
    eta = 0.8 * X[:, 0] - 0.05 * X[:, 1] + 0.4 * (c == 2) - 0.7
    cols = {f"x{j}": X[:, j].copy() for j in range(4)}
    cols["x3"][rng.random(n) < 0.05] = np.nan
    cols["c"] = c.astype(np.int32)
    cols["wt"] = rng.uniform(0.5, 2.0, n)
    cols["fold"] = rng.integers(0, 3, n).astype(np.float64)
    cols["y"] = np.array(["n", "y"], dtype=object)[
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int)]
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = _columns()
    return (cols, Frame.from_numpy(cols, types=_TYPES, domains=_DOMAINS,
                                   device="cpu"),
            JFrame.from_numpy(cols, types=_TYPES, domains=_DOMAINS))


def _p1(frame):
    return np.asarray(frame.vec("y").to_numpy(), np.float64)[:N]


def _assert_metrics(m, jm, tol, what):
    d, jd = m.describe(), jm.describe()
    assert set(d) == set(jd), what
    for k in d:
        np.testing.assert_allclose(d[k], jd[k], rtol=tol, atol=tol,
                                   err_msg=f"{what}: {k}")


# --------------------------------------------------------------- the folds

@pytest.mark.parametrize("scheme", ["auto", "random", "modulo",
                                    "stratified"])
def test_fold_assignment_is_the_references(scheme):
    """Every scheme's folds are bitwise the JAX package's (numpy draws;
    the stratified scheme over class codes with missing ones)."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 3, 1001).astype(np.float32)
    y[rng.random(1001) < 0.1] = np.nan
    got = cv.fold_assignment(1001, 4, scheme, 17, y=y)
    want = jcv.fold_assignment(1001, 4, scheme, 17, y=y)
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}


# ----------------------------------------- nfolds / fold_column vs the JAX

CV_CASES = {
    "xgboost-nfolds": (XGBoost, JXGBoost, dict(XGB, nfolds=3,
                                               weights_column="wt")),
    "xgboost-fold-column": (XGBoost, JXGBoost, dict(XGB,
                                                    fold_column="fold")),
    "xgboost-stratified": (XGBoost, JXGBoost, dict(
        XGB, nfolds=3, fold_assignment="stratified")),
    "glm-nfolds-modulo": (GLM, JGLM, dict(nfolds=3, fold_assignment="modulo",
                                          weights_column="wt", seed=3)),
    "glm-fold-column": (GLM, JGLM, dict(fold_column="fold")),
}


@pytest.mark.parametrize("case", list(CV_CASES))
def test_cv_matches_jax(frames, case):
    """The same folds, holdout predictions (``cv_predictions``), CV
    metrics and final model as the JAX package's CV.  The JAX package
    cross-validates on a fold column only with nfolds > 1 and keeps the
    column as a feature, so its side gets nfolds=3 and ignores it; the
    port cross-validates on the column alone and never trains on it."""
    cols, fr, jfr = frames
    cls, jcls, kw = CV_CASES[case]
    kw = dict(kw, response_column="y", keep_cross_validation_predictions=True)
    jkw = dict(kw, ignored_columns=["fold"])
    if kw.get("fold_column"):
        jkw["nfolds"] = 3
    else:
        kw["ignored_columns"] = ["fold"]
    m = cls(device="cpu", **kw).train(fr)
    jm = jcls(**jkw).train(jfr)
    assert "fold" not in [s.name for s in m.datainfo.specs]
    assert len(m.output["cv_fold_models"]) == len(jm.output["cv_fold_models"])
    assert len(m.output["cv_fold_models"]) == 3
    # the folds: each row's holdout came from the same fold model
    hp, jhp = m.cv_predictions, jm.cv_predictions
    assert hp.shape == jhp.shape == (N, 2)
    np.testing.assert_allclose(hp, jhp, rtol=1e-4, atol=1e-5)
    _assert_metrics(m.cross_validation_metrics, jm.cross_validation_metrics,
                    CV_TOL, "cross_validation_metrics")
    _assert_metrics(m.training_metrics, jm.training_metrics, CV_TOL,
                    "training_metrics")
    if kw.get("fold_column"):
        folds = cv.row_folds(m.params, fr, m.datainfo)
        assert np.array_equal(folds, cols["fold"].astype(int))


# ------------------------------------------------------- class balancing

@pytest.mark.parametrize("kw", [dict(balance_classes=True),
                                dict(balance_classes=True,
                                     class_sampling_factors=[3.0, 0.5],
                                     weights_column="wt")],
                         ids=["balanced", "factors-and-weights"])
def test_balance_classes_matches_jax(frames, kw):
    """Balanced trains predict as the JAX package's; validation metrics
    stay unbalanced (they equal the model's performance on the frame with
    the user's weights); the model's DataInfo keeps the user's weights
    column, so new frames score with their own weights."""
    cols, fr, jfr = frames
    cfg = dict(XGB, response_column="y", ignored_columns=["fold"], **kw)
    m = XGBoost(device="cpu", **cfg).train(fr, valid=fr)
    jm = JXGBoost(**cfg).train(jfr, valid=jfr)
    np.testing.assert_allclose(_p1(m.predict(fr)), _p1(jm.predict(jfr)),
                               rtol=1e-4)
    assert m.datainfo.weights_column == kw.get("weights_column") \
        == jm.datainfo.weights_column
    assert base.BALANCE_WEIGHTS not in fr.names
    _assert_metrics(m.validation_metrics, m.model_performance(fr), 1e-6,
                    "validation_metrics")
    _assert_metrics(m.validation_metrics, jm.validation_metrics, CV_TOL,
                    "validation_metrics")
    plain = XGBoost(device="cpu", **dict(cfg, balance_classes=False,
                                         class_sampling_factors=None)) \
        .train(fr)
    assert not np.allclose(_p1(m.predict(fr)), _p1(plain.predict(fr)))


def test_balance_is_the_weighted_train(frames):
    """A balanced train is bitwise the train whose weights column holds
    the balancing factors (n / (K · count) per class)."""
    cols, fr, _ = frames
    yv = (cols["y"] == "y").astype(int)
    counts = np.bincount(yv, minlength=2)
    w = (N / (2 * counts))[yv]
    frw = Frame.from_numpy(dict(cols, bw=w), types=_TYPES, domains=_DOMAINS,
                           device="cpu")
    cfg = dict(XGB, response_column="y", ignored_columns=["fold"])
    m = XGBoost(device="cpu", balance_classes=True, **cfg).train(fr)
    mw = XGBoost(device="cpu", weights_column="bw", **cfg).train(frw)
    assert np.array_equal(_p1(m.predict(fr)), _p1(mw.predict(frw)))


# ------------------------------------------------ custom metric, gains/lift

def _wmae(raw, y, w):
    p1 = raw[:, 1] if raw.ndim == 2 else raw
    return "wmae", float(np.sum(w * np.abs(y - p1)) / np.sum(w))


def test_custom_metric_matches_jax(frames):
    """A ``custom_metric_func`` joins ``describe()`` with the JAX
    package's value on the same model and frame; a model without one
    describes as before."""
    cols, fr, jfr = frames
    cfg = dict(response_column="y", ignored_columns=["fold"],
               weights_column="wt", custom_metric_func=_wmae)
    m = GLM(device="cpu", **cfg).train(fr)
    jm = JGLM(**cfg).train(jfr)
    d, jd = m.model_performance(fr).describe(), \
        jm.model_performance(jfr).describe()
    assert "wmae" in d and "wmae" in jd
    np.testing.assert_allclose(d["wmae"], jd["wmae"], rtol=1e-5)
    assert "wmae" not in m.training_metrics.describe()
    mm = core.make_metrics(m.datainfo, torch.zeros(fr.padded_rows),
                           torch.nan_to_num(torch.arange(
                               fr.padded_rows, dtype=torch.float32)),
                           torch.ones(fr.padded_rows),
                           custom_metric_func=lambda r, y, w: ("n", len(r)))
    assert mm.describe()["n"] == fr.padded_rows


def test_gains_lift_and_ks_match_jax():
    """``gains_lift()`` and ``ks`` from the same predictions equal the JAX
    package's (the table is a copy; the histograms are the metrics')."""
    rng = np.random.default_rng(9)
    p1 = rng.random(2000).astype(np.float32)
    y = (rng.random(2000) < p1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 2000).astype(np.float32)
    m = core.binomial_metrics(torch.from_numpy(p1), torch.from_numpy(y),
                              torch.from_numpy(w))
    jm = jcore.binomial_metrics(jnp.asarray(p1), jnp.asarray(y),
                                jnp.asarray(w))
    np.testing.assert_allclose(m.ks, jm.ks, rtol=1e-6)
    for groups in (16, 5):
        g, jg = m.gains_lift(groups), jm.gains_lift(groups)
        assert set(g) == set(jg) and len(g["group"]) > 0
        for k in g:
            np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                       np.asarray(jg[k], np.float64),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


# ------------------------------------------------------ the port's contract

def _fold_weights(cols, folds, f):
    return np.where(folds != f, cols["wt"], 0.0)


FOLD_CASES = {
    "xgboost": (XGBoost, dict(XGB)),
    "drf": (DRF, dict(ntrees=2, max_depth=4, nbins=16, seed=2)),
    "glm": (GLM, dict()),
    "deeplearning": (DeepLearning, dict(hidden=(6,), epochs=2.0,
                                        mini_batch_size=32, seed=3,
                                        precision="f32", stopping_rounds=0)),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_models_are_weighted_trains(frames, case):
    """Each fold model is bitwise the builder's train on the full frame
    with that fold's rows weighted 0 (the user's weights elsewhere), the
    CV metrics are ``make_metrics`` of the assembled holdout predictions,
    and ``cv_predictions`` is kept only when asked."""
    cols, fr, _ = frames
    cls, kw = FOLD_CASES[case]
    cfg = dict(kw, response_column="y", ignored_columns=["fold"],
               weights_column="wt")
    m = cls(device="cpu", nfolds=3, fold_assignment="modulo",
            keep_cross_validation_predictions=True, **cfg).train(fr)
    folds = np.arange(N) % 3
    from h2o3_tpu_torch.runtime import dkv
    for f, key in enumerate(m.output["cv_fold_models"]):
        fm = dkv.get(key)
        frw = Frame.from_numpy(dict(cols, fw=_fold_weights(cols, folds, f)),
                               types=_TYPES, domains=_DOMAINS, device="cpu")
        want = cls(device="cpu", **dict(cfg, weights_column="fw",
                                        ignored_columns=["fold", "wt"])) \
            .train(frw)
        assert np.array_equal(_p1(fm.predict(fr)), _p1(want.predict(frw)))
    hp = np.zeros((fr.padded_rows, 2))
    hp[:N] = m.cv_predictions
    di = m.datainfo
    ref = core.make_metrics(di, torch.tensor(hp, dtype=torch.float32),
                            di.response(fr), di.weights(fr))
    _assert_metrics(m.cross_validation_metrics, ref, 0.0, "cv metrics")
    m2 = cls(device="cpu", nfolds=2, **cfg).train(fr)
    assert m2.cv_predictions is None
    assert len(m2.output["cv_fold_models"]) == 2


# ---------------------------------------------------- what is still refused

def test_shared_options_ported_and_the_rest_refused(frames):
    """``_NOT_PORTED`` keeps checkpoints, their export, stream and warm
    starts, and ``offset_column`` outside GLM; each still raises.  The
    options it gave up are used by the tests above (nfolds, fold_column,
    fold_assignment, keep_cross_validation_predictions, balance_classes,
    class_sampling_factors, custom_metric_func).  The isolation forests
    and uplift, whose metrics are their own, refuse CV and a custom
    metric."""
    cols, fr, _ = frames
    assert set(base._NOT_PORTED) == {"checkpoint", "export_checkpoints_dir",
                                     "stream", "warm_start", "offset_column"}
    p = base.Parameters()
    assert (p.nfolds, p.fold_column, p.fold_assignment,
            p.keep_cross_validation_predictions, p.balance_classes,
            p.class_sampling_factors, p.custom_metric_func) == (
        0, None, "auto", False, False, None, None)
    refused = dict(checkpoint="k", export_checkpoints_dir="/nonexistent",
                   stream=True, warm_start="k", offset_column="x0")
    for cls, kw in ((XGBoost, XGB), (DRF, dict(ntrees=1, max_depth=2)),
                    (DeepLearning, dict(hidden=(4,))), (GLM, {})):
        for name, v in refused.items():
            if cls is GLM and name == "offset_column":
                continue
            with pytest.raises(NotImplementedError, match=name):
                cls(device="cpu", response_column="y", **{name: v},
                    **kw).train(fr)
    for bad in (dict(nfolds=3), dict(fold_column="fold"),
                dict(custom_metric_func=_wmae)):
        with pytest.raises(ValueError, match="metrics"):
            IsolationForest(device="cpu", ntrees=2, **bad).train(fr)
    with pytest.raises(ValueError, match="fold_column"):
        XGBoost(device="cpu", response_column="y", fold_column="nope",
                **XGB).train(fr)
    ufr = Frame.from_numpy({"x0": cols["x0"], "y": cols["y"],
                            "t": np.array(["c", "t"], dtype=object)[
                                np.arange(N) % 2]}, device="cpu")
    with pytest.raises(ValueError, match="metrics"):
        UpliftDRF(device="cpu", response_column="y", treatment_column="t",
                  ntrees=1, max_depth=2, nfolds=3).train(ufr)
