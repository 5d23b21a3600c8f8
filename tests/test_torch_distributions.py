"""h2o3_tpu_torch's GBM distributions held against the JAX package.

Every family of ``models/distributions.py`` (gaussian, bernoulli,
poisson, gamma, tweedie, laplace, quantile, huber and a custom one) on
the same seeded numpy inputs in both packages: the gradients, hessians,
initial scores (an even count of positive weights, so that Laplace's
median averages two values, and zero-weight rows, which drop out of
both), inverse links and deviances to rtol 1e-6; then a GBM of each
family trained by both packages, XGBoost's count and positive
objectives, a custom distribution written once for each package, and a
grid cohort of a non-default distribution against its members' own
trains.  All of it runs on the CPU, where the kernel wrappers take their
plain torch versions.

Tolerances.  The trees must have the same (feature, threshold, NA
direction, valid) on every level: the frame's signal is strong, so every
winning gain clears its runner-up far beyond the f32 noise of the two
packages' summation orders.  Leaf values agree to rtol 1e-5 and
predictions to rtol 1e-4 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import GBM as JGBM
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models import distributions as jdist

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import GridSearch
from h2o3_tpu_torch.models import distributions as tdist
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

_FAMILIES = [
    ("gaussian", {}), ("bernoulli", {}), ("poisson", {}), ("gamma", {}),
    ("tweedie", {"tweedie_power": 1.3}), ("laplace", {}),
    ("quantile", {"quantile_alpha": 0.8}), ("huber", {"huber_alpha": 0.7}),
]


class _JaxCustom:
    """A custom loss for the JAX package: squared error on a log link,
    with its Gauss-Newton hessian mu^2."""

    def grad_hess(self, y, f):
        mu = jnp.exp(jnp.clip(f, -30, 30))
        return mu * (mu - y), mu * mu

    def init_score(self, y, w):
        return jnp.log(jnp.maximum(jnp.sum(w * y) / jnp.sum(w), 1e-6))

    def deviance(self, y, f, w):
        return jnp.sum(w * (y - jnp.exp(f)) ** 2)


class _TorchCustom:
    """The same loss for the port, in torch."""

    def grad_hess(self, y, f):
        mu = torch.exp(f.clamp(-30, 30))
        return mu * (mu - y), mu * mu

    def init_score(self, y, w):
        return torch.log(((w * y).sum() / w.sum()).clamp_min(1e-6))

    def deviance(self, y, f, w):
        return (w * (y - torch.exp(f)) ** 2).sum()


def _inputs(name, n=64, seed=3):
    """y of the family's support (counts with zeros for poisson and
    gamma, so Gamma's hessian meets y = 0), raw scores f, and weights
    with 10 zero rows (54 positive: an even count)."""
    rng = np.random.default_rng(seed)
    if name == "bernoulli":
        y = (rng.random(n) < 0.4).astype(np.float32)
    elif name in ("poisson", "gamma"):
        y = rng.poisson(2.0, n).astype(np.float32)
    elif name in ("tweedie", "custom"):
        y = rng.gamma(2.0, 1.0, n).astype(np.float32)
    else:
        y = rng.normal(1.0, 2.0, n).astype(np.float32)
    f = rng.normal(0.2, 0.8, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.choice(n, 10, replace=False)] = 0.0
    return y, f, w


def _pair(name, kw):
    if name == "custom":
        return (jdist.make_distribution(
                    "auto", custom_distribution_func=_JaxCustom()),
                tdist.make_distribution(
                    "auto", custom_distribution_func=_TorchCustom()))
    return (jdist.make_distribution(name, nclasses=1, **kw),
            tdist.make_distribution(name, nclasses=1, **kw))


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("name, kw", _FAMILIES + [("custom", {})],
                         ids=[f[0] for f in _FAMILIES] + ["custom"])
def test_family_functions_match_jax(name, kw):
    y, f, w = _inputs(name)
    jd, td = _pair(name, kw)
    assert td.name == jd.name
    ty, tf, tw = map(torch.from_numpy, (y, f, w))
    jy, jf, jw = map(jnp.asarray, (y, f, w))
    for got, want in zip(td.grad_hess(ty, tf), jd.grad_hess(jy, jf)):
        _close(got.numpy(), want)
    _close(td.init_score(ty, tw).numpy(), jd.init_score(jy, jw))
    _close(td.linkinv(tf).numpy(), jd.linkinv(jf))
    _close(td.deviance(ty, tf, tw).numpy(), jd.deviance(jy, jf, jw),
           rtol=1e-5)


def test_medians_and_quantiles_of_weighted_rows():
    """Laplace's initial score averages the two middle values of an even
    count (``torch.nanmedian`` would take the lower); rows of weight 0
    drop out; no row left gives NaN, as ``jnp.nanmedian`` does."""
    y = torch.tensor([5.0, 1.0, 2.0, 9.0, 4.0, 100.0])
    w = torch.tensor([1.0, 1.0, 0.5, 1.0, 0.0, 0.0])
    lap = tdist.make_distribution("laplace")
    assert float(lap.init_score(y, w)) == 3.5          # (2 + 5) / 2
    assert float(torch.nanmedian(y[w > 0])) == 2.0
    jl = jdist.make_distribution("laplace")
    assert float(jl.init_score(jnp.asarray(y.numpy()),
                               jnp.asarray(w.numpy()))) == 3.5
    q = tdist.make_distribution("quantile", quantile_alpha=0.8)
    jq = jdist.make_distribution("quantile", quantile_alpha=0.8)
    assert float(q.init_score(y, w)) == float(jq.init_score(
        jnp.asarray(y.numpy()), jnp.asarray(w.numpy())))
    assert np.isnan(float(lap.init_score(y, torch.zeros(6))))


def test_make_distribution_dispatch_and_refusals():
    """The full dispatch of the JAX package's ``make_distribution``; it
    raises where that one raises."""
    for name in ("gaussian", "bernoulli", "binomial", "poisson", "gamma",
                 "tweedie", "laplace", "quantile", "huber", "multinomial"):
        assert tdist.make_distribution(name).name == \
            jdist.make_distribution(name).name
    assert tdist.make_distribution("auto", 2).name == "bernoulli"
    assert tdist.make_distribution("auto", 3).name == "multinomial"
    assert tdist.make_distribution("tweedie", tweedie_power=1.7).p == 1.7
    assert tdist.make_distribution("huber", huber_alpha=0.3).delta == 0.3
    with pytest.raises(ValueError, match="custom_distribution_func"):
        tdist.make_distribution("custom")
    with pytest.raises(ValueError, match="grad_hess"):
        tdist.make_distribution("auto", custom_distribution_func=object())
    with pytest.raises(ValueError, match="unknown distribution"):
        tdist.make_distribution("cauchy")


def _frame_cols(n=2000, seed=11):
    """Three numeric features with a strong multiplicative signal, a
    count response and a positive one."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2, 2, n).astype(np.float32)
    x1 = rng.integers(0, 6, n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    eta = 0.6 * x0 + np.where(x1 > 2, 0.5, -0.3) + 0.1 * x2
    return {"x0": x0, "x1": x1, "x2": x2,
            "cnt": rng.poisson(np.exp(eta)).astype(np.float32),
            "pos": np.exp(eta + 0.2 * rng.normal(size=n)).astype(np.float32)}


@pytest.fixture(scope="module")
def frames():
    cols = _frame_cols()
    return cols, JFrame.from_numpy(cols), Frame.from_numpy(cols,
                                                           device="cpu")


def _same_trees(jm, tm, depth, rtol=1e-5):
    jt, tt = list(jm.output["trees"]), list(tm.output["trees"])
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


def _preds(jm, jfr, tm, fr):
    np.testing.assert_allclose(
        tm.predict(fr).vec("predict").to_numpy(),
        np.asarray(jm.predict(jfr).vec("predict").to_numpy()),
        rtol=1e-4, atol=1e-6)


_GBM = dict(ntrees=5, max_depth=2, nbins=16, seed=1, learn_rate=0.3,
            score_tree_interval=10 ** 9, ignored_columns=["cnt", "pos"])


@pytest.mark.parametrize("name, kw", _FAMILIES[2:] + [("custom", {})],
                         ids=[f[0] for f in _FAMILIES[2:]] + ["custom"])
def test_gbm_of_each_family_matches_jax(frames, name, kw):
    cols, jfr, fr = frames
    resp = "cnt" if name == "poisson" else "pos"
    cfg = dict(_GBM, response_column=resp)
    if name == "custom":
        jm = JGBM(custom_distribution_func=_JaxCustom(), **cfg).train(jfr)
        tm = GBM(custom_distribution_func=_TorchCustom(), device="cpu",
                 **cfg).train(fr)
    else:
        jm = JGBM(distribution=name, **kw, **cfg).train(jfr)
        tm = GBM(distribution=name, device="cpu", **kw, **cfg).train(fr)
    assert tm.output["distribution"] == jm.output["distribution"] == name
    np.testing.assert_allclose(tm.output["init_score"],
                               jm.output["init_score"], rtol=1e-6)
    _same_trees(jm, tm, 2)
    _preds(jm, jfr, tm, fr)


@pytest.mark.parametrize("objective, resp", [("count:poisson", "cnt"),
                                             ("reg:gamma", "pos"),
                                             ("reg:tweedie", "pos")])
def test_xgboost_count_and_positive_objectives(frames, objective, resp):
    cols, jfr, fr = frames
    # the shape of the GBM trains above (5 trees, depth 2, 16 bins), so
    # that the JAX package reuses their compiled programs
    cfg = dict(response_column=resp, objective=objective, ntrees=5,
               max_depth=2, nbins=16, seed=1, score_tree_interval=10 ** 9,
               ignored_columns=["cnt", "pos"])
    if objective == "reg:tweedie":
        cfg["tweedie_power"] = 1.3
    jm = JXGBoost(**cfg).train(jfr)
    tm = XGBoost(device="cpu", **cfg).train(fr)
    assert tm.output["distribution"] == jm.output["distribution"]
    _same_trees(jm, tm, 2)
    _preds(jm, jfr, tm, fr)
    meta, _ = tm.to_archive()
    assert meta["link"] == "log"


def test_custom_distribution_refusals(frames):
    """A custom distribution with a multinomial response raises (the JAX
    package's refusal); one that defines linkinv trains and predicts
    through it, and ``to_archive`` refuses it, since the archive's links
    cannot carry it."""
    cols, _, fr = frames
    rng = np.random.default_rng(2)
    c3 = dict(cols, cls=np.asarray(["a", "b", "c"], object)[
        rng.integers(0, 3, len(cols["x0"]))])
    fr3 = Frame.from_numpy(c3, device="cpu")
    with pytest.raises(ValueError, match="multinomial"):
        GBM(response_column="cls", custom_distribution_func=_TorchCustom(),
            device="cpu", ntrees=1, ignored_columns=["cnt", "pos"]) \
            .train(fr3)

    class WithLink(_TorchCustom):
        def linkinv(self, f):
            return torch.exp(f)

    m = GBM(custom_distribution_func=WithLink(), device="cpu",
            **dict(_GBM, response_column="pos", ntrees=2)).train(fr)
    assert (m.predict(fr).vec("predict").to_numpy() > 0).all()
    with pytest.raises(ValueError, match="linkinv"):
        m.to_archive()


def test_grid_cohort_of_a_non_default_distribution(frames):
    """A grid of poisson GBMs batches as one cohort, and each member is
    bitwise its own sequential train (its parameters: learn_rate,
    reg_lambda); members of two tweedie powers split into two cohorts."""
    cols, _, fr = frames
    base = dict(_GBM, response_column="cnt", distribution="poisson",
                ntrees=3, device="cpu")
    hp = {"learn_rate": [0.1, 0.3], "reg_lambda": [0.0, 1.0]}
    g = GridSearch(GBM, hp, grid_batch="on", **base).train(fr)
    assert len(g.models) == 4 and not g.failed_entries
    for m in g.models:
        assert m.output["grid_cohort"]["size"] == 4
        assert m.output["distribution"] == "poisson"
        seq = GBM(**dict(base, learn_rate=m.params.learn_rate,
                         reg_lambda=m.params.reg_lambda,
                         seed=m.params.seed)).train(fr)
        np.testing.assert_array_equal(
            m.predict(fr).vec("predict").to_numpy(),
            seq.predict(fr).vec("predict").to_numpy())
        for la, lb in zip(m.output["stacked"].levels,
                          seq.output["stacked"].levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
    base_t = dict(base, distribution="tweedie", response_column="pos")
    g = GridSearch(GBM, {"tweedie_power": [1.2, 1.5],
                         "learn_rate": [0.1, 0.3]}, grid_batch="on",
                   **base_t).train(fr)
    assert sorted(m.output["grid_cohort"]["size"] for m in g.models) \
        == [2, 2, 2, 2]
