"""h2o3_tpu_torch's GLM held against the JAX package's.

The same numpy frame from one seed (1,984 rows, a multiple of the JAX
mesh's 64-row padding: four numerics, one with 5% NaN, a 5-level
categorical, row weights, an offset, and one response per family) goes
through ``h2o3_tpu.models.GLM`` and the port's ``GLM``, on the CPU.

Tolerances.  The JAX package solves the P x P system on the device in f32
(its fused lambda-path program: a linear solve, or coordinate descent in
f32); the port fetches the f32 Gram and solves in f64 on the host.  Both
accumulate the Gram in f32 in different orders, and their frames' column
means and sigmas (f32 sums over a sharded mesh against one torch sum)
differ in the last bit.  So:

* IRLSM and COD, every family: coefficients (``beta_std_flat``, i.e.
  ``coef_norm``, and the de-standardized ``coef``) to 1e-5 of the
  largest, i.e. rtol 1e-4 of the vector; deviances to rtol 1e-5,
  predictions to rtol 1e-5 with an atol of 1e-5 of the largest (a
  regression's predictions cross zero);
* multinomial: its block-Newton loop stops where an f32 log-likelihood
  stops moving (by 1e-8 n, below f32's resolution of it), so the two
  packages stop a few iterations apart on a slowly converging sequence:
  coefficients to 2e-3 of the largest, the log-likelihood (residual
  deviance) to rtol 1e-6, probabilities to 1e-3 (the last iteration's
  step is ~5e-4);
* L-BFGS and ordinal (optax's L-BFGS in a fixed-length scan there,
  ``torch.optim.LBFGS`` here with its tolerances at 0, so it runs the
  same iteration cap unless its line search makes no step; both on an
  f32 objective, with different line searches, so they reach the
  optimum along different paths): the objective to rtol 1e-6,
  coefficients to 1e-3 of the largest, probabilities to 1e-4;
* ``make_matrix`` bitwise, given the same fitted means and sigmas (the
  rollups themselves to rtol 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.models import GLM as JGLM
from h2o3_tpu.models import GridSearch as JGridSearch
from h2o3_tpu.models.datainfo import DataInfo as JDataInfo

from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import GLM, GridSearch
from h2o3_tpu_torch.models import glm as glm_mod
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.tree.drf import DRF
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 1984
RESPONSES = ("yg", "yb", "yp", "ygam", "ypos", "ym")
_TYPES = {"c": "cat", "yb": "cat", "ym": "cat"}
# the categorical as codes (-1 missing) over its labels
_DOMAINS = {"c": ["a", "b", "c", "d", "e"]}


def _columns(n=N, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[:, 1] *= 10.0
    X[:, 2] += 5.0
    c = rng.integers(0, 5, n)
    eta = (0.5 * X[:, 0] - 0.05 * X[:, 1] + 0.3 * X[:, 2] - 1.5
           + 0.4 * (c == 2) - 0.3 * (c == 4))
    off = rng.normal(scale=0.1, size=n)
    cols = {f"x{j}": X[:, j].copy() for j in range(4)}
    cols["x0"][rng.random(n) < 0.05] = np.nan
    cols["c"] = np.where(rng.random(n) < 0.05, -1, c).astype(np.int32)
    cols["wt"] = rng.uniform(0.5, 2.0, n)
    cols["off"] = off
    cols["yg"] = eta + rng.normal(size=n)
    cols["yb"] = np.array(["n", "y"], dtype=object)[
        (rng.random(n) < 1 / (1 + np.exp(-eta - off))).astype(int)]
    cols["yp"] = rng.poisson(np.exp(0.3 * eta + off)).astype(float)
    cols["ygam"] = rng.gamma(2.0, np.exp(0.2 * eta) / 2.0)
    cols["ypos"] = rng.gamma(1.5, np.exp(0.3 * eta)) \
        * (rng.random(n) < 0.8)
    latent = eta + rng.logistic(size=n)
    cols["ym"] = np.array(["l0", "l1", "l2"], dtype=object)[
        np.digitize(latent, [-1.0, 0.5])]
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = _columns()
    return (cols, Frame.from_numpy(cols, types=_TYPES, domains=_DOMAINS,
                                   device="cpu"),
            JFrame.from_numpy(cols, types=_TYPES, domains=_DOMAINS))


def _cfg(resp, **kw):
    return dict(response_column=resp, weights_column="wt",
                ignored_columns=[r for r in RESPONSES if r != resp]
                + ([] if kw.get("offset_column") else ["off"]), **kw)


def _fit(frames, resp, **kw):
    _, fr, jfr = frames
    cfg = _cfg(resp, **kw)
    return GLM(device="cpu", **cfg).train(fr), JGLM(**cfg).train(jfr)


def _probs(pred, dom, n=N):
    return np.stack([np.asarray(pred.vec(c).to_numpy())[:n] for c in dom],
                    axis=1)


def _assert_coefs(m, jm, tol):
    b, jb = (np.asarray(x.output["beta_std_flat"]) for x in (m, jm))
    scale = np.abs(jb).max()
    assert np.abs(b - jb).max() <= tol * scale, np.abs(b - jb).max()
    bo, jbo = (np.ravel(np.asarray(x.output["beta"], np.float64))
               for x in (m, jm))
    assert np.abs(bo - jbo).max() <= tol * np.abs(jbo).max()
    assert list(m.coef) == list(jm.coef) == m.output["coef_names"]
    assert list(m.coef_norm) == list(jm.coef_norm)


def _assert_predictions(m, jm, frames, rtol):
    _, fr, jfr = frames
    p, jp = m.predict(fr), jm.predict(jfr)
    if m.datainfo.is_classifier:
        dom = [str(d) for d in m.datainfo.response_domain]
        np.testing.assert_allclose(_probs(p, dom), _probs(jp, dom),
                                   rtol=rtol, atol=rtol)
    else:
        want = np.asarray(jp.vec("predict").to_numpy())
        np.testing.assert_allclose(p.vec("predict").to_numpy(), want,
                                   rtol=rtol,
                                   atol=rtol * np.abs(want).max())


# ----------------------------------------------------- the design matrix

def _datainfos(frames, standardize=True):
    _, fr, jfr = frames
    cfg = dict(response_column="yb", weights_column="wt",
               offset_column="off", standardize=standardize,
               ignored_columns=[r for r in RESPONSES if r != "yb"])
    return DataInfo.fit(fr, **cfg), JDataInfo.fit(jfr, **cfg)


@pytest.mark.parametrize("standardize", [True, False])
def test_make_matrix_bitwise_jax(frames, standardize):
    """``make_matrix`` is bitwise the JAX package's on the training frame
    and on a test frame with unseen levels (they set the NA bucket) and a
    time column on another base, given the same fitted means and sigmas;
    the rollups that fit them agree to rtol 1e-6.  ``coef_names`` and
    ``offsets`` are the JAX package's."""
    cols = dict(frames[0])
    rng = np.random.default_rng(5)
    cols["t"] = 1.6e12 + rng.integers(0, 10 ** 9, N).astype(np.float64)
    types = dict(_TYPES, t="time")
    fr = Frame.from_numpy(cols, types=types, domains=_DOMAINS,
                          device="cpu")
    jfr = JFrame.from_numpy(cols, types=types, domains=_DOMAINS)
    di, jdi = _datainfos((None, fr, jfr), standardize)
    for a, b in zip(di.specs, jdi.specs):
        assert (a.name, a.type, a.offset, a.width) == \
            (b.name, b.type, b.offset, b.width)
        np.testing.assert_allclose([a.mean, a.sigma], [b.mean, b.sigma],
                                   rtol=1e-6)
    di.specs = [dataclasses.replace(a, mean=b.mean, sigma=b.sigma)
                for a, b in zip(di.specs, jdi.specs)]
    assert di.coef_names == jdi.coef_names
    assert di.nfeatures == jdi.nfeatures == 11
    assert di.coef_names[4:9] == ["c.b", "c.c", "c.d", "c.e",
                                  "c.missing(NA)"]
    test = {k: v[:200] for k, v in cols.items()}
    test["c"] = np.array(["a", "z", "c", "q", "e"] * 40, dtype=object)
    test["t"] = test["t"] + 12345.0
    for f, jf, n in ((fr, jfr, N),
                     (Frame.from_numpy(test, types=types, device="cpu"),
                      JFrame.from_numpy(test, types=types), 200)):
        X = di.make_matrix(f)
        assert X.dtype == torch.float32 and X.shape[1] == di.nfeatures
        want = np.asarray(jdi.make_matrix(jf))[:n]
        np.testing.assert_array_equal(X.numpy()[:n].view(np.int32),
                                      want.view(np.int32))
        assert di.make_matrix(f) is X                    # memoized
    np.testing.assert_array_equal(di.offsets(fr).numpy()[:N],
                                  np.asarray(jdi.offsets(jfr))[:N])


# --------------------------------------------------------- the families

FAMILY_CASES = {
    "gaussian": dict(resp="yg", lambda_=0.0, offset_column="off"),
    "binomial": dict(resp="yb", lambda_=0.0, offset_column="off",
                     compute_p_values=True),
    "quasibinomial": dict(resp="yb", family="quasibinomial", lambda_=0.0),
    "poisson": dict(resp="yp", lambda_=0.0, family="poisson",
                    offset_column="off"),
    "gamma": dict(resp="ygam", family="gamma", lambda_=0.0,
                  compute_p_values=True),
    "tweedie": dict(resp="ypos", family="tweedie",
                    tweedie_variance_power=1.5, lambda_=0.0),
    "negativebinomial": dict(resp="yp", family="negativebinomial",
                             theta=0.5, lambda_=1e-3, alpha=0.0),
}


@pytest.fixture(scope="module")
def binomial_pair(frames):
    case = dict(FAMILY_CASES["binomial"])
    return _fit(frames, case.pop("resp"), **case)


@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_family_matches_jax(frames, binomial_pair, family):
    """IRLSM on each family (weights; an offset where the family takes
    one): coefficients, deviances, p-values and predictions as the JAX
    package's."""
    case = dict(FAMILY_CASES[family])
    if family == "binomial":
        m, jm = binomial_pair
    else:
        m, jm = _fit(frames, case.pop("resp"), **case)
    assert m.output["family"] == jm.output["family"]
    _assert_coefs(m, jm, 1e-5)
    for key in ("residual_deviance", "null_deviance"):
        np.testing.assert_allclose(m.output[key], jm.output[key], rtol=1e-5)
    assert m.output["rank"] == jm.output["rank"]
    assert m.output["iterations"] == jm.output["iterations"]
    if "compute_p_values" in case:
        for key in ("std_errs", "z_values", "p_values"):
            np.testing.assert_allclose(m.output[key], jm.output[key],
                                       rtol=1e-4, atol=1e-6)
    _assert_predictions(m, jm, frames, 1e-5)
    if m.datainfo.is_classifier:
        assert abs(m.training_metrics.auc - jm.training_metrics.auc) < 1e-6
        assert abs(m.training_metrics.logloss
                   - jm.training_metrics.logloss) < 1e-5
    else:
        np.testing.assert_allclose(m.training_metrics.rmse,
                                   jm.training_metrics.rmse, rtol=1e-5)


@pytest.mark.parametrize("case", ["cod", "lambda_search", "constraints"])
def test_penalized_paths_match_jax(frames, case):
    """COD at alpha 0.5 and a lambda; the lambda path (10 lambdas, warm
    starts, beta_epsilon); ``non_negative`` with ``penalty_factors`` (the
    categorical's slots unpenalized): the JAX package's coefficients,
    deviance and history."""
    kw = {"cod": dict(alpha=0.5, lambda_=0.01),
          "lambda_search": dict(alpha=0.5, lambda_search=True, nlambdas=10),
          "constraints": dict(alpha=0.5, lambda_=0.02, non_negative=True,
                              penalty_factors={"c": 0.0, "x1": 2.0})}[case]
    m, jm = _fit(frames, "yg", **kw)
    _assert_coefs(m, jm, 1e-5)
    np.testing.assert_allclose(m.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-5)
    assert len(m.scoring_history) == len(jm.scoring_history)
    for a, b in zip(m.scoring_history, jm.scoring_history):
        assert a["iteration"] == b["iteration"]
        np.testing.assert_allclose(a["lambda"], b["lambda"], rtol=1e-6)
        np.testing.assert_allclose(a["deviance"], b["deviance"], rtol=1e-5)
    if case == "constraints":
        b = np.asarray(m.output["beta_std_flat"])[:-1]
        assert (b >= 0).all() and (b == 0).any()
    _assert_predictions(m, jm, frames, 1e-5)


def test_lbfgs_matches_jax(frames):
    """solver="lbfgs" (binomial, an L2 penalty): the objective to rtol
    1e-6, coefficients to 1e-3 of the largest, probabilities to 1e-4."""
    m, jm = _fit(frames, "yb", solver="lbfgs", alpha=0.0, lambda_=1e-3)
    np.testing.assert_allclose(m.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-6)
    _assert_coefs(m, jm, 1e-3)
    _assert_predictions(m, jm, frames, 1e-4)
    assert m.scoring_history and len(m.scoring_history) <= 50


def test_multinomial_matches_jax(frames):
    """Multinomial block-Newton (3 classes): the log-likelihood to rtol
    1e-6, coefficients ([P, K]) to 2e-3 of the largest, probabilities to
    1e-3, and the training logloss to 1e-5."""
    m, jm = _fit(frames, "ym", lambda_=0.0)
    assert np.asarray(m.output["beta_std"]).shape == (10, 3)
    np.testing.assert_allclose(m.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-6)
    _assert_coefs(m, jm, 2e-3)
    _assert_predictions(m, jm, frames, 1e-3)
    assert abs(m.training_metrics.logloss
               - jm.training_metrics.logloss) < 1e-5


def test_ordinal_matches_jax(frames):
    """Ordinal (proportional odds, L-BFGS): the NLL to rtol 1e-6,
    coefficients and ordered thresholds to 1e-3 of the largest,
    probabilities to 1e-4."""
    m, jm = _fit(frames, "ym", family="ordinal")
    np.testing.assert_allclose(m.output["residual_deviance"],
                               jm.output["residual_deviance"], rtol=1e-6)
    _assert_coefs(m, jm, 1e-3)
    th, jth = (np.asarray(x.output["ordinal_thresholds"]) for x in (m, jm))
    assert (np.diff(th) > 0).all()
    assert np.abs(th - jth).max() <= 1e-3 * np.abs(jth).max()
    _assert_predictions(m, jm, frames, 1e-4)


# ------------------------------------------------------- archives, grids

def test_archives_score_as_predict(frames, binomial_pair):
    """The port's archive (``to_archive``) and one carried over from the
    JAX model (``_extract``) score through the numpy ``ScoringModel`` as
    the port's ``predict`` does; multinomial and gaussian too."""
    cols, fr, _ = frames
    m, jm = binomial_pair
    rows = {k: cols[k] for k in ("x0", "x1", "x2", "x3", "c")}
    want = _probs(m.predict(fr), ["n", "y"])
    for meta, arrays in (m.to_archive(), jmojo._extract(jm)):
        got = from_reference(meta, arrays).predict(rows)["probabilities"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    meta, jmeta = m.to_archive()[0], jmojo._extract(jm)[0]
    assert (meta["family"], meta["link"]) == (jmeta["family"],
                                              jmeta["link"])
    di, jdi = meta["datainfo"], jmeta["datainfo"]
    assert set(di) == set(jdi)
    for key in di:
        if key != "specs":
            assert di[key] == jdi[key], key
    for a, b in zip(di["specs"], jdi["specs"]):
        assert set(a) == set(b)
        for key in a:
            if key in ("mean", "sigma"):       # the rollups' last bit
                np.testing.assert_allclose(a[key], b[key], rtol=1e-6)
            else:
                assert a[key] == b[key], key
    for resp in ("ym", "yg"):
        mm = GLM(device="cpu", **_cfg(resp, lambda_=0.0)).train(fr)
        out = from_reference(*mm.to_archive()).predict(rows)
        pred = mm.predict(fr)
        if resp == "ym":
            np.testing.assert_allclose(
                out["probabilities"], _probs(pred, ["l0", "l1", "l2"]),
                rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(out["predict"],
                                       pred.vec("predict").to_numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_grid_of_glm_matches_jax(frames):
    """``GridSearch(GLM, {"alpha", "lambda_"})`` trains on the wave path
    (GLM has no batched cohort): the JAX package's grid order and
    metrics."""
    _, fr, jfr = frames
    hp = {"alpha": [0.0, 1.0], "lambda_": [1e-3, 1e-2]}
    cfg = _cfg("yb")
    g = GridSearch(GLM, hp, device="cpu", **cfg).train(fr)
    jg = JGridSearch(JGLM, hp, **cfg).train(jfr)
    assert len(g.models) == len(jg.models) == 4
    assert all(m.output.get("grid_cohort") is None for m in g.models)
    order = [(m.params.alpha, m.params.lambda_) for m in g.models]
    assert order == [(m.params.alpha, m.params.lambda_) for m in jg.models]
    for a, b in zip(g.models, jg.models):
        assert abs(a.training_metrics.auc - b.training_metrics.auc) < 1e-6
        assert abs(a.training_metrics.logloss
                   - b.training_metrics.logloss) < 1e-5


# ------------------------------------------------------- port-side checks

def test_offset_column_only_for_glm(frames):
    """``offset_column`` trains GLM; every tree builder still raises on
    it."""
    _, fr, _ = frames
    cfg = dict(response_column="yb", offset_column="off",
               ignored_columns=[r for r in RESPONSES if r != "yb"])
    for builder in (XGBoost, DRF):
        with pytest.raises(NotImplementedError, match="offset_column"):
            builder(device="cpu", ntrees=1, **cfg).train(fr)
    assert GLM(device="cpu", lambda_=0.0, **cfg).train(fr).output[
        "family"] == "binomial"


def test_unported_options_raise():
    """An option whose value the port does not implement raises rather
    than train something else: GLM without an intercept, DART drops
    drawn other than uniformly."""
    with pytest.raises(NotImplementedError, match="intercept"):
        GLM(device="cpu", response_column="yb", intercept=False)
    with pytest.raises(NotImplementedError, match="sample_type"):
        XGBoost(device="cpu", response_column="yb", booster="dart",
                sample_type="weighted")


def test_weighted_gram_row_blocks(frames, monkeypatch):
    """The Gram summed over row blocks (here 64 rows) equals the one-shot
    product to f32 rounding, X'Wz alike, and a fit over small blocks
    gives the same coefficients to 1e-6 of the largest; a validation
    frame's metrics are ``model_performance``'s."""
    _, fr, _ = frames
    di, _ = _datainfos(frames)
    X = di.make_matrix(fr)
    w = di.weights(fr)
    z = torch.linspace(-1.0, 1.0, X.shape[0])
    G, c = glm_mod.weighted_gram(X, w, z)
    X64, w64 = X.double(), w.double()
    np.testing.assert_allclose(G.numpy(), ((X64 * w64[:, None]).t() @ X64)
                               .numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(c.numpy(), (X64.t() @ (w64 * z.double()))
                               .numpy(), rtol=1e-5, atol=1e-3)
    m = GLM(device="cpu", **_cfg("yb", lambda_=0.0)).train(fr, valid=fr)
    monkeypatch.setattr(glm_mod, "GRAM_BLOCK_BYTES", 64 * 4 * X.shape[1])
    m2 = GLM(device="cpu", **_cfg("yb", lambda_=0.0)).train(fr)
    b, b2 = (np.asarray(x.output["beta_std_flat"]) for x in (m, m2))
    assert np.abs(b - b2).max() <= 1e-6 * np.abs(b).max()
    assert m.validation_metrics.auc == m.model_performance(fr).auc
    with pytest.raises(ValueError, match="ordinal"):
        GLM(device="cpu", family="ordinal",
            **_cfg("ym")).train(fr).to_archive()


def _cod_numpy_scalars(gram, xtwz, n, lam, alpha, beta0, penalize,
                       max_inner=100, tol=1e-8, nonneg=None):
    """The coordinate descent of ``glm._solve_penalized`` on numpy
    scalars and strided Gram columns: the reference its Python-float
    sweep is held to."""
    G, c = gram / n, xtwz / n
    l2 = lam * (1 - alpha) * penalize
    l1 = lam * alpha * penalize
    constrained = nonneg is not None and bool(np.any(nonneg))
    beta = beta0.copy()
    if constrained:
        beta[nonneg] = np.maximum(beta[nonneg], 0.0)
    d = np.diag(G).copy()
    Gb = G @ beta
    for _ in range(max_inner):
        delta = 0.0
        for j in range(len(beta)):
            r = c[j] - (Gb[j] - d[j] * beta[j])
            if penalize[j] > 0:
                bj = np.sign(r) * max(abs(r) - l1[j], 0.0) \
                    / (d[j] + l2[j] + 1e-12)
            else:
                bj = r / (d[j] + 1e-12)
            if constrained and nonneg[j]:
                bj = max(bj, 0.0)
            diff = bj - beta[j]
            if diff != 0.0:
                Gb += G[:, j] * diff
                delta = max(delta, abs(diff))
                beta[j] = bj
        if delta < tol:
            break
    return beta


@pytest.mark.parametrize("seed", range(6))
def test_coordinate_descent_bitwise_its_numpy_form(seed):
    """``_solve_penalized``'s sweep on Python floats and contiguous Gram
    rows gives bit for bit the coefficients of the same sweep on numpy
    scalars (the same IEEE operations in the same order): L1, elastic
    net, per-column factors (zeros included), non-negative columns, a
    collinear pair and a warm start."""
    rng = np.random.default_rng(seed)
    P = int(rng.integers(3, 120))
    n = int(rng.integers(P + 1, 3 * P + 60))
    X = rng.normal(size=(n, P))
    X[:, 1] = X[:, 0]
    X[:, -1] = 1.0
    w = rng.random(n)
    gram = ((X * w[:, None]).T @ X).astype(np.float32).astype(np.float64)
    xtwz = X.T @ (w * rng.normal(size=n))
    pen = np.ones(P)
    pen[-1] = 0.0
    if seed % 2:
        pen[: P // 3] = rng.random(P // 3) * 3
    nonneg = rng.random(P) < 0.3 if seed % 3 == 0 else None
    beta0 = rng.normal(size=P) if seed >= 3 else np.zeros(P)
    for lam, alpha in ((1e-3, 1.0), (1e-2, 0.5), (0.3, 1.0)):
        want = _cod_numpy_scalars(gram, xtwz, float(n), lam, alpha, beta0,
                                  pen, nonneg=nonneg)
        got = glm_mod._solve_penalized(gram, xtwz, float(n), lam, alpha,
                                       beta0, pen, nonneg=nonneg)
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
