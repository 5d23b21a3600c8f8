"""h2o3_tpu_torch's KMeans, Aggregator, PCA/SVD, GLRM, Quantile and
IsotonicRegression held against the JAX package's, on the CPU.

The same numpy columns from one seed (512 rows, a multiple of the JAX
mesh's 64-row padding, so padded shapes and the numpy draws over them
agree: three numerics with cluster structure, a 4-level categorical and
row weights) go through both packages.

Tolerances.  Host numpy work and selections are bitwise: KMeans' initial
centres (the rows its draws pick), its assignments and ``estimate_k``'s
k; quantiles; isotonic thresholds; Aggregator's exemplar count.  f32
device work (XLA there, torch here, in other summation orders, and the
frames' rollups differ in the last bit) is held to:

* KMeans centres to 1e-5 of the largest, within-SS rtol 1e-5;
* PCA eigenvalues rtol 1e-5 and eigenvectors to 1e-4 after the sign
  convention (the largest entry of each component positive), SVD's d
  and v likewise;
* GLRM's objective rtol 1e-5 (ALS, whose factors are compared as their
  product, which no sign of an eigenvector moves), and on the proximal
  path over 30 iterations the same accept/reject sequence, the final
  objective rtol 1e-5 (the non-smooth losses amplify the last-bit
  differences: by iteration 40 of the absolute loss they reach 3e-4).
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import (PCA as JPCA, SVD as JSVD, GLRM as JGLRM,
                             Aggregator as JAggregator, KMeans as JKMeans,
                             IsotonicRegression as JIso,
                             Quantile as JQuantile)
from h2o3_tpu.models.quantile import quantile as jquantile
from h2o3_tpu.runtime import job as jjob

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import (GLRM, PCA, SVD, Aggregator,
                                   IsotonicRegression, KMeans, Quantile,
                                   quantile)
from h2o3_tpu_torch.models import pca as pca_mod
from h2o3_tpu_torch.runtime import job as tjob

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 512
_TYPES = {"c": "cat"}
_DOMAINS = {"c": ["a", "b", "c", "d"]}


def _columns(n=N, seed=5, nan=False):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0, 0.0], [4.0, 1.0, -2.0],
                        [-3.0, 5.0, 1.0]])
    lab = rng.integers(0, 3, n)
    X = centers[lab] + rng.normal(scale=0.8, size=(n, 3))
    X[:, 1] *= 3.0
    cols = {f"x{j}": X[:, j].copy() for j in range(3)}
    if nan:
        cols["x0"][rng.random(n) < 0.05] = np.nan
    cols["c"] = ((lab + rng.integers(0, 2, n)) % 4).astype(np.int32)
    cols["wt"] = rng.uniform(0.5, 2.0, n)
    return cols


def _frames(cols, types=_TYPES, domains=_DOMAINS):
    return (Frame.from_numpy(cols, types=types, domains=domains,
                             device="cpu"),
            JFrame.from_numpy(cols, types=types, domains=domains))


@pytest.fixture(scope="module")
def frames():
    return _frames(_columns())


def _close_of_largest(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def _labels(pred, n=N):
    return np.asarray(pred.vecs[0].to_numpy())[:n]


# ----------------------------------------------------------------- KMeans
@pytest.mark.parametrize("init", ["furthest", "plus_plus", "random"])
def test_kmeans_matches_jax(frames, init):
    """The initial centres bitwise (standardize=False: the design is the
    raw values in both packages, so the draws pick the same rows), then
    Lloyd's centres to 1e-5 of the largest, within-SS rtol 1e-5 and the
    assignments and iteration count equal."""
    fr, jfr = frames
    cfg = dict(k=3, init=init, seed=11, standardize=False,
               ignored_columns=["wt"], max_iterations=20)
    b, jb = KMeans(device="cpu", **cfg), JKMeans(**cfg)
    di, jdi = b._make_datainfo(fr), jb._make_datainfo(jfr)
    X, w = di.make_matrix(fr), di.weights(fr)
    jX, jw = jdi.make_matrix(jfr), jdi.weights(jfr)
    assert np.array_equal(X.numpy(), np.asarray(jX))
    c0 = b._init_centers(X, w, 3, np.random.default_rng(11), di)
    jc0 = jb._init_centers(jX, jw, 3, np.random.default_rng(11), jdi)
    assert np.array_equal(c0, np.asarray(jc0))
    assert np.array_equal(X.numpy()[b.init_rows], c0)
    m, jm = b.train(fr), jb.train(jfr)
    _close_of_largest(m.output["centers"], jm.output["centers"], 1e-5)
    assert m.output["iterations"] == jm.output["iterations"]
    tm, jtm = m.training_metrics, jm.training_metrics
    assert tm.tot_withinss == pytest.approx(jtm.tot_withinss, rel=1e-5)
    assert tm.totss == pytest.approx(jtm.totss, rel=1e-5)
    np.testing.assert_allclose(tm.withinss, jtm.withinss, rtol=1e-5)
    assert tm.size == jtm.size
    assert np.array_equal(_labels(m.predict(fr)), _labels(jm.predict(jfr)))


def test_kmeans_standardized_weighted_and_estimate_k():
    """Standardized, weighted, 5% NaN: centres (de-standardized) 1e-5
    of the largest, within-SS rtol 1e-5, assignments equal; estimate_k
    picks the same k; user points are standardized as the reference's;
    model_performance on the frame equals the training metrics."""
    fr, jfr = _frames(_columns(nan=True))
    cfg = dict(k=3, seed=2, weights_column="wt", max_iterations=20)
    m, jm = KMeans(device="cpu", **cfg).train(fr), JKMeans(**cfg).train(jfr)
    _close_of_largest(m.output["centers_std"], jm.output["centers_std"],
                      1e-5)
    _close_of_largest(m.output["centers"], jm.output["centers"], 1e-5)
    assert m.training_metrics.tot_withinss == pytest.approx(
        jm.training_metrics.tot_withinss, rel=1e-5)
    assert np.array_equal(_labels(m.predict(fr)), _labels(jm.predict(jfr)))
    perf = m.model_performance(fr)
    assert perf.tot_withinss == pytest.approx(
        m.training_metrics.tot_withinss, rel=1e-5)
    ek = dict(k=6, estimate_k=True, seed=4, ignored_columns=["wt"],
              max_iterations=20)
    me, jme = KMeans(device="cpu", **ek).train(fr), JKMeans(**ek).train(jfr)
    assert me.output["k"] == jme.output["k"]
    pts = np.array([[0.0, 0.0, 0.0, 1, 0, 0, 0, 0],
                    [4.0, 3.0, -2.0, 0, 1, 0, 0, 0],
                    [-3.0, 15.0, 1.0, 0, 0, 1, 0, 0]])
    uc = dict(k=3, init="user", user_points=pts, ignored_columns=["wt"],
              max_iterations=20)
    mu, jmu = KMeans(device="cpu", **uc).train(fr), JKMeans(**uc).train(jfr)
    _close_of_largest(mu.output["centers"], jmu.output["centers"], 1e-5)
    assert np.array_equal(_labels(mu.predict(fr)), _labels(jmu.predict(jfr)))


def test_aggregator_matches_jax(frames):
    """The exemplar count bitwise; the exemplars' numerics 1e-5 of the
    largest, their categorical labels and counts equal."""
    fr, jfr = frames
    cfg = dict(target_num_exemplars=12, seed=3, ignored_columns=["wt"])
    m = Aggregator(device="cpu", **cfg).train(fr)
    jm = JAggregator(**cfg).train(jfr)
    assert m.output["num_exemplars"] == jm.output["num_exemplars"]
    np.testing.assert_array_equal(m.output["mapping_counts"],
                                  np.asarray(jm.output["mapping_counts"]))
    out, jout = m.aggregated_frame, jm.aggregated_frame
    assert out.names == jout.names
    for name in ("x0", "x1", "x2"):
        _close_of_largest(out.vec(name).to_numpy(),
                          np.asarray(jout.vec(name).to_numpy()), 1e-5)
    assert list(out.vec("c").decoded()) == list(jout.vec("c").decoded())


# ---------------------------------------------------------------- PCA/SVD
def _signed(V):
    return pca_mod.sign_convention(np.asarray(V, np.float64))


@pytest.mark.parametrize("method,transform", [
    ("gram_s_v_d", "standardize"), ("gram_s_v_d", "none"),
    ("power", "demean"), ("randomized", "standardize"),
    ("randomized", "normalize")])
def test_pca_matches_jax(frames, method, transform):
    """Eigenvalues (std_deviation²) rtol 1e-5, eigenvectors 1e-4 after
    the sign convention, the variance shares rtol 1e-5, the projections
    1e-4 of the largest, reconstruction MSE rtol 1e-4."""
    fr, jfr = frames
    cfg = dict(k=3, transform=transform, pca_method=method, seed=7,
               weights_column="wt", use_all_factor_levels=True)
    m, jm = PCA(device="cpu", **cfg).train(fr), JPCA(**cfg).train(jfr)
    np.testing.assert_allclose(m.output["std_deviation"] ** 2,
                               jm.output["std_deviation"] ** 2, rtol=1e-5)
    assert np.abs(_signed(m.output["eigenvectors"])
                  - _signed(jm.output["eigenvectors"])).max() <= 1e-4
    np.testing.assert_allclose(m.output["pct_variance"],
                               jm.output["pct_variance"], rtol=1e-5)
    np.testing.assert_allclose(m.output["cum_pct_variance"],
                               jm.output["cum_pct_variance"], rtol=1e-5)
    Z = np.stack([v.to_numpy() for v in m.predict(fr).vecs], axis=1)
    jZ = np.stack([np.asarray(v.to_numpy()) for v in jm.predict(jfr).vecs],
                  axis=1)
    _close_of_largest(Z, jZ, 1e-4)
    assert m.model_performance(fr)["reconstruction_mse"] == pytest.approx(
        jm.model_performance(jfr)["reconstruction_mse"], rel=1e-4)


def test_svd_matches_jax(frames):
    """d rtol 1e-5, v 1e-4 after the sign convention, and U (the
    projections over d) 1e-4 of the largest, up to each column's sign."""
    fr, jfr = frames
    cfg = dict(nv=3, transform="standardize", ignored_columns=["wt"])
    m, jm = SVD(device="cpu", **cfg).train(fr), JSVD(**cfg).train(jfr)
    np.testing.assert_allclose(m.output["d"], jm.output["d"], rtol=1e-5)
    V, jV = _signed(m.output["v"]), _signed(jm.output["v"])
    assert np.abs(V - jV).max() <= 1e-4
    sgn = np.sign((np.asarray(m.output["v"]) * V).sum(axis=0))
    jsgn = np.sign((np.asarray(jm.output["v"]) * jV).sum(axis=0))
    U = np.stack([v.to_numpy() for v in m.predict(fr).vecs], axis=1) * sgn
    jU = np.stack([np.asarray(v.to_numpy()) for v in jm.predict(jfr).vecs],
                  axis=1) * jsgn
    _close_of_largest(U, jU, 1e-4)


# ------------------------------------------------------------------- GLRM
@pytest.fixture(scope="module")
def lowrank():
    """A rank-2 matrix of six columns plus 5% noise and a 2-level
    categorical: ALS reaches its optimum within the iterations run."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(N, 2)) @ rng.normal(size=(2, 6)) \
        + 0.05 * rng.normal(size=(N, 6))
    cols = {f"a{j}": A[:, j] for j in range(6)}
    cols["c"] = np.where(A[:, 0] > 0, "p", "q").astype(object)
    return _frames(cols, types={}, domains={})


def test_glrm_als_matches_jax(lowrank):
    """The quadratic ALS path from init="svd" (the categorical block's
    loss quadratic too): objective rtol 1e-5, the
    same iteration count, the low-rank product X Y (sign-free) 1e-4 of
    the largest, recover_svd's singular values rtol 1e-4."""
    fr, jfr = lowrank
    cfg = dict(k=2, transform="standardize", gamma_x=0.1, gamma_y=0.1,
               max_iterations=100, seed=1, recover_svd=True,
               multi_loss="quadratic")
    m, jm = GLRM(device="cpu", **cfg).train(fr), JGLRM(**cfg).train(jfr)
    assert m.output["objective"] == pytest.approx(jm.output["objective"],
                                                  rel=1e-5)
    assert m.output["iterations"] == jm.output["iterations"]
    np.testing.assert_allclose(m.output["singular_values"],
                               jm.output["singular_values"], rtol=1e-4)

    def product(model, f):
        X = np.stack([np.asarray(v.to_numpy())
                      for v in model.transform(f).vecs], axis=1)
        return X @ np.asarray(model.output["archetypes"])
    _close_of_largest(product(m, fr), product(jm, jfr), 1e-4)
    assert m.model_performance(fr)["objective"] == pytest.approx(
        jm.model_performance(jfr)["objective"], rel=1e-4)


def _objectives(monkeypatch, module):
    """Each iteration's objective as the builder reports it to its job
    (5 significant digits)."""
    seen = []
    real = module.Job.update

    def update(self, progress, msg=""):
        if "obj=" in msg:
            seen.append(float(msg.rsplit("obj=", 1)[1]))
        return real(self, progress, msg)
    monkeypatch.setattr(module.Job, "update", update)
    return seen


@pytest.mark.parametrize("cfg", [
    dict(loss="absolute", regularization_x="l1", gamma_x=0.05,
         init="random"),
    dict(loss="huber", regularization_y="non_negative", init="svd",
         loss_by_col={"a2": "quadratic"})])
def test_glrm_proximal_matches_jax(lowrank, monkeypatch, cfg):
    """The proximal path (the loss zoo, the categorical block's hinge,
    per-column losses, regularizers) over 30 iterations: the same
    accept/reject sequence (an iteration's reported objective changes
    exactly when the port accepts it, in both packages), each reported
    objective equal to its 5 digits, the final objective rtol 1e-5 and
    the X factor 1e-4 of the largest."""
    fr, jfr = lowrank
    cfg = dict(k=2, max_iterations=30, seed=3, transform="standardize",
               **cfg)
    seen_t = _objectives(monkeypatch, tjob)
    m = GLRM(device="cpu", **cfg).train(fr)
    seen_j = _objectives(monkeypatch, jjob)
    jm = JGLRM(**cfg).train(jfr)
    assert len(seen_t) == len(seen_j) == m.output["iterations"] == 30
    assert seen_t == seen_j
    acc = m.output["accepted"]
    moved = [True] + [b != a for a, b in zip(seen_j, seen_j[1:])]
    assert acc == moved and 0 < sum(acc) < len(acc)
    assert m.output["objective"] == pytest.approx(jm.output["objective"],
                                                  rel=1e-5)
    _close_of_largest(m.output["x_factor"], jm.output["x_factor"], 1e-4)


# --------------------------------------------------------------- Quantile
def test_quantile_matches_jax_bitwise():
    """Every combine method, unweighted and weighted, NaN and time-free
    numeric columns: the quantile tables bitwise (the sort is exact and
    the interpolation is the same numpy on the same values)."""
    rng = np.random.default_rng(9)
    n = 448
    cols = {"a": rng.normal(size=n), "b": rng.integers(0, 20, n) * 1.0,
            "w": rng.integers(1, 4, n) * 1.0,
            "c": np.array(["u", "v"], dtype=object)[rng.integers(0, 2, n)]}
    cols["a"][rng.random(n) < 0.1] = np.nan
    fr, jfr = _frames(cols, types={}, domains={})
    probs = (0.0, 0.1, 0.25, 0.333, 0.5, 0.9, 1.0)
    for method in ("interpolate", "average", "low", "high"):
        for wcol in (None, "w"):
            cfg = dict(probs=probs, combine_method=method,
                       weights_column=wcol)
            t = Quantile(device="cpu", **cfg).train(fr).output["quantiles"]
            jt = JQuantile(**cfg).train(jfr).output["quantiles"]
            assert t == jt, (method, wcol)
    assert quantile(fr, probs, device="cpu") == \
        jquantile(jfr, probs)
    with pytest.raises(ValueError, match="combine_method"):
        Quantile(combine_method="mean", device="cpu").train(fr)


# ---------------------------------------------------- IsotonicRegression
def test_isotonic_matches_jax():
    """Thresholds bitwise (a stable device sort, then the same host
    pooling), predictions bitwise under "na" and "clip", the training
    metrics rtol 1e-6; two features raise, as in the reference."""
    rng = np.random.default_rng(4)
    n = 640
    x = np.round(rng.uniform(0, 10, n), 1)
    y = np.log1p(x) + rng.normal(scale=0.3, size=n)
    y[rng.random(n) < 0.03] = np.nan
    cols = {"x": x, "y": y, "w": rng.uniform(0.5, 2, n)}
    fr, jfr = _frames(cols, types={}, domains={})
    xt = {"x": np.array([-1.0, 0.0, 3.33, 5.0, 9.95, 12.0, np.nan]),
          "y": np.zeros(7), "w": np.ones(7)}
    ft, jft = _frames(xt, types={}, domains={})
    for oob in ("na", "clip"):
        cfg = dict(response_column="y", weights_column="w",
                   out_of_bounds=oob)
        m = IsotonicRegression(device="cpu", **cfg).train(fr)
        jm = JIso(**cfg).train(jfr)
        for key in ("thresholds_x", "thresholds_y"):
            assert np.array_equal(m.output[key], jm.output[key])
        assert m.output["nobs"] == jm.output["nobs"]
        p = m.predict(ft).vecs[0].to_numpy()
        jp = np.asarray(jm.predict(jft).vecs[0].to_numpy())
        assert np.array_equal(p, jp, equal_nan=True)
        assert np.isnan(p[-1]) and (np.isnan(p[0]) == (oob == "na"))
        assert m.training_metrics.rmse == pytest.approx(
            jm.training_metrics.rmse, rel=1e-6)
    cols["z"] = x * 2
    fr2 = Frame.from_numpy(cols, device="cpu")
    with pytest.raises(ValueError, match="exactly 1 feature"):
        IsotonicRegression(response_column="y", device="cpu").train(fr2)
