"""h2o3_tpu_torch's DeepLearning held against the JAX package's.

The same numpy frame from one seed (300 rows: four numerics, one with 5%
NaN, a three-level categorical with missing codes, a binary, a
three-class and a numeric response) goes through
``h2o3_tpu.models.deeplearning.DeepLearning`` and the port's, on the CPU,
at ``hidden=(8, 8)``, ``mini_batch_size=32``, ``precision="f32"``,
dropout 0.  The port cannot draw ``jax.random`` bits, so each case hands
it the JAX package's draws (``deeplearning.reference_draws``), derived
here as the JAX package derives them: ``rng, k0 = split(PRNGKey(seed))``
and ``_init_params(k0, ...)``; ``rng, ks = split(rng)`` and
``permutation(ks, n)``; per iteration ``split(fold_in(rng, it), steps)``,
``k1, _ = split(key)`` and ``randint(k1, (), 0, n)``.

Tolerances.  Both sides run the same f32 arithmetic in another order
(XLA's fused CPU program against torch's kernels and autograd), and
their frames' column means and sigmas differ in the last bit (another
f32 summation order), so after the 20-40 steps of a case: weights, the
``scoring_history`` losses, the predictions and the reconstruction to
rtol 1e-4, atol 1e-5; the training metrics to rtol 1e-4, atol 1e-4 (the
AUC's 400 score bins can move a row across a bin edge: a pair of the
300 rows is 2e-5 of it).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.models.deeplearning import DeepLearning as JDeepLearning

from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DeepLearning
from h2o3_tpu_torch.models import deeplearning as dl

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 300
RESPONSES = ("yb", "ym", "yr")
_TYPES = {"c": "cat"}
_DOMAINS = {"c": ["a", "b", "c"]}
RTOL, ATOL = 1e-4, 1e-5
METRIC_ATOL = 1e-4


def _columns(n=N, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[:, 1] *= 5.0
    X[:, 3] += 2.0
    c = rng.integers(0, 3, n)
    eta = X[:, 0] - 0.2 * X[:, 1] + 0.5 * (c == 1) + 0.3 * X[:, 2] * X[:, 3]
    cols = {f"x{j}": X[:, j].copy() for j in range(4)}
    cols["x2"][rng.random(n) < 0.05] = np.nan
    cols["c"] = np.where(rng.random(n) < 0.05, -1, c).astype(np.int32)
    cols["yb"] = np.array(["n", "y"], dtype=object)[
        (eta + rng.logistic(size=n) > 0).astype(int)]
    cols["ym"] = np.array(["l0", "l1", "l2"], dtype=object)[
        np.digitize(eta + rng.logistic(size=n), [-1.0, 1.0])]
    cols["yr"] = 3.0 * eta + 10.0 + rng.normal(size=n)
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = _columns()
    return (cols, Frame.from_numpy(cols, types=_TYPES, domains=_DOMAINS,
                                   device="cpu"),
            JFrame.from_numpy(cols, types=_TYPES, domains=_DOMAINS))


def _cfg(resp, **kw):
    base = dict(hidden=(8, 8), mini_batch_size=32, precision="f32",
                train_samples_per_iteration=320, epochs=3.5, seed=7,
                stopping_rounds=0)
    base.update(kw)
    if base.get("autoencoder"):
        return dict(base, ignored_columns=list(RESPONSES))
    return dict(base, response_column=resp,
                ignored_columns=[r for r in RESPONSES if r != resp])


def jax_draws(jm, cfg):
    """The JAX package's draws for the train of ``jm`` (its DataInfo
    sizes the layers), as numpy: (init weights, permutation or None,
    offsets [iterations, steps])."""
    di = jm.datainfo
    P = di.nfeatures
    auto = cfg.get("autoencoder", False)
    out_dim = P if auto else (di.nclasses if di.is_classifier else 1)
    sizes = [P, *cfg["hidden"], out_dim]
    builder = JDeepLearning(**cfg)
    rng = jax.random.PRNGKey(cfg["seed"])
    rng, k0 = jax.random.split(rng)
    init = builder._init_params(k0, sizes,
                                cfg.get("activation", "").startswith("maxout"))
    perm = None
    if cfg.get("shuffle_training_data", True):
        rng, ks = jax.random.split(rng)
        perm = np.asarray(jax.random.permutation(ks, N))
    steps, iters = DeepLearning(**cfg)._sizing(N, min(cfg["mini_batch_size"],
                                                      N))
    offsets = []
    for it in range(iters):
        keys = jax.random.split(jax.random.fold_in(rng, it), steps)
        offsets.append([int(jax.random.randint(jax.random.split(k)[0], (),
                                               0, N)) for k in keys])
    return ([(np.asarray(W), np.asarray(b)) for W, b in init], perm,
            np.asarray(offsets))


def train_pair(frames, resp, **kw):
    """(port model, JAX model) of the same train, the port on the JAX
    package's draws."""
    _, fr, jfr = frames
    cfg = _cfg(resp, **kw)
    jm = JDeepLearning(**cfg).train(jfr)
    b = DeepLearning(device="cpu", **cfg)
    b.draws = dl.reference_draws(*jax_draws(jm, cfg))
    return b.train(fr), jm


def _col(frame, name):
    return np.asarray(frame.vec(name).to_numpy(), np.float64)[:N]


CASES = {
    "binomial-tanh-adadelta": ("yb", dict(activation="tanh")),
    "binomial-rectifier-momentum-l1-l2": ("yb", dict(
        activation="rectifier", adaptive_rate=False, rate=0.01,
        momentum_stable=0.9, l1=1e-4, l2=1e-3)),
    "binomial-maxout-sgd": ("yb", dict(activation="maxout",
                                       adaptive_rate=False, rate=0.05)),
    "multinomial-rectifier-adadelta": ("ym", dict(activation="rectifier")),
    "regression-tanh-quadratic-stopping": ("yr", dict(
        activation="tanh", stopping_rounds=2, epochs=6.0)),
    "regression-rectifier-absolute-unshuffled": ("yr", dict(
        activation="rectifier", loss="absolute",
        shuffle_training_data=False)),
    "regression-maxout-huber-momentum": ("yr", dict(
        activation="maxout", loss="huber", adaptive_rate=False, rate=0.02,
        momentum_start=0.5)),
    "autoencoder-tanh": (None, dict(activation="tanh", autoencoder=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(frames, case):
    """Final weights, scoring history, predictions and training metrics
    of each activation, optimiser, loss and response kind against the
    JAX package's train on the same draws."""
    cols, fr, jfr = frames
    resp, kw = CASES[case]
    m, jm = train_pair(frames, resp, **kw)
    assert len(m.output["weights"]) == len(jm.output["weights"]) == 3
    for (W, b), (jW, jb) in zip(m.output["weights"], jm.output["weights"]):
        np.testing.assert_allclose(W, np.asarray(jW), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b, np.asarray(jb), rtol=RTOL, atol=ATOL)
    assert m.output["samples_trained"] == jm.output["samples_trained"]
    assert m.output["epochs_trained"] == jm.output["epochs_trained"]
    h, jh = m.scoring_history, jm.scoring_history
    assert [e["iteration"] for e in h] == [e["iteration"] for e in jh]
    assert [e["samples"] for e in h] == [e["samples"] for e in jh]
    np.testing.assert_allclose([e["training_loss"] for e in h],
                               [e["training_loss"] for e in jh],
                               rtol=RTOL, atol=ATOL)
    p, jp = m.predict(fr), jm.predict(jfr)
    assert p.names == jp.names
    for name in p.names:
        if name == "predict" and m.datainfo.is_classifier:
            continue                      # labels: from the probabilities
        np.testing.assert_allclose(_col(p, name), _col(jp, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if kw.get("autoencoder"):
        assert p.names[-1] == "reconstr_Intercept"
        np.testing.assert_allclose(
            _col(m.anomaly(fr), "Reconstruction.MSE"),
            _col(jm.anomaly(jfr), "Reconstruction.MSE"), rtol=RTOL, atol=ATOL)
        assert m.training_metrics is None and jm.training_metrics is None
        return
    d, jd = m.training_metrics.describe(), jm.training_metrics.describe()
    assert set(d) == set(jd)
    for k in d:
        np.testing.assert_allclose(d[k], jd[k], rtol=RTOL, atol=METRIC_ATOL,
                                   err_msg=k)


# ------------------------------------------------------------- optimisers

def _optax_steps(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("kind", ["adadelta", "sgd_momentum", "sgd"])
def test_optimiser_update_rules_match_optax(kind):
    """``torch.optim.Adadelta(lr=1.0)`` and ``SGD(momentum=m)`` make
    optax's ``adadelta(learning_rate=1.0)`` and ``sgd(lr, momentum=m)``
    updates, step for step on the same gradients (f32, rtol 1e-6)."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(6)]
    tx, topt = {
        "adadelta": (optax.adadelta(learning_rate=1.0, rho=0.99, eps=1e-8),
                     lambda ps: torch.optim.Adadelta(ps, lr=1.0, rho=0.99,
                                                     eps=1e-8, foreach=True)),
        "sgd_momentum": (optax.sgd(0.05, momentum=0.9),
                         lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9,
                                                    foreach=True)),
        "sgd": (optax.sgd(0.05), lambda ps: torch.optim.SGD(ps, lr=0.05,
                                                            foreach=True)),
    }[kind]
    want = np.asarray(_optax_steps(tx, jnp.asarray(p0),
                                   [jnp.asarray(g) for g in grads]))
    t = torch.tensor(p0, requires_grad=True)
    opt = topt([t])
    for g in grads:
        t.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------- port only

@pytest.mark.parametrize("resp,loss,custom", [
    ("yr", "huber", lambda pred, y: F.huber_loss(pred, y, reduction="none",
                                                 delta=1.0)),
    ("yb", "automatic", lambda pred, y: F.cross_entropy(
        pred, y.long().clamp(0, 1), reduction="none")),
])
def test_custom_loss_equals_the_builtin_it_restates(frames, resp, loss,
                                                    custom):
    """A ``custom_loss_func`` (a torch callable (pred, y) -> per-row
    loss) that restates a built-in loss trains bitwise the same model."""
    _, fr, _ = frames
    cfg = _cfg(resp, loss=loss, activation="tanh")
    m = DeepLearning(device="cpu", **cfg).train(fr)
    mc = DeepLearning(device="cpu", custom_loss_func=custom,
                      **dict(cfg, loss="automatic")).train(fr)
    for (W, b), (Wc, bc) in zip(m.output["weights"], mc.output["weights"]):
        assert np.array_equal(W, Wc) and np.array_equal(b, bc)


def test_dropout_masks_and_deterministic_scoring(frames, monkeypatch):
    """A dropout mask keeps about 1 - ratio of the units, each scaled by
    1 / (1 - ratio); ``*_with_dropout`` drops 0.5 of each hidden layer
    unless told, beside the input ratio; scoring never drops, so two
    predictions agree bitwise, and two trains of one seed too."""
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(200_000)
    y = dl._dropped(x, 0.3, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    _, fr, _ = frames
    seen = []
    real = dl._dropped
    monkeypatch.setattr(dl, "_dropped", lambda x, r, g: (
        seen.append(r), real(x, r, g))[1])
    cfg = _cfg("yb", activation="rectifier_with_dropout",
               input_dropout_ratio=0.2)
    m = DeepLearning(device="cpu", **cfg).train(fr)
    steps, iters = DeepLearning(**cfg)._sizing(N, 32)
    assert seen == [0.2, 0.5, 0.5] * (steps * iters)
    seen.clear()
    a, b = m.predict(fr), m.predict(fr)
    assert not seen
    assert np.array_equal(_col(a, "y"), _col(b, "y"))
    m2 = DeepLearning(device="cpu", **cfg).train(fr)
    assert np.array_equal(m.output["weights"][0][0],
                          m2.output["weights"][0][0])


def test_seeded_draws(frames):
    """Without the hook a train draws from its seed: the initial weights
    within U(±√(6 / (fan_in + units))) (units doubled for maxout), a
    permutation of the rows, offsets in [0, n); the same seed draws the
    same, another seed otherwise."""
    d, d2 = dl.SeededDraws(5), dl.SeededDraws(6)
    ws = d.init_weights([10, 4, 3], True, "uniform_adaptive", 1.0)
    assert [tuple(W.shape) for W, _ in ws] == [(10, 8), (4, 3)]
    assert float(ws[0][0].abs().max()) <= np.sqrt(6 / 18)
    assert float(ws[1][0].abs().max()) <= np.sqrt(6 / 7)
    assert all(float(b.abs().max()) == 0 for _, b in ws)
    assert torch.equal(ws[0][0], d.init_weights([10, 4, 3], True,
                                                "uniform_adaptive",
                                                1.0)[0][0])
    wn = d.init_weights([10, 4, 3], False, "normal", 0.1)[0][0]
    assert 0.05 < float(wn.std()) < 0.15
    assert sorted(d.permutation(50).tolist()) == list(range(50))
    offs = d.offsets(3, 100, 37)
    assert len(offs) == 100 and min(offs) >= 0 and max(offs) < 37
    assert offs == d.offsets(3, 100, 37) and offs != d.offsets(4, 100, 37)
    assert offs != d2.offsets(3, 100, 37)


@pytest.mark.parametrize("resp", ["yb", "ym", "yr"])
def test_archive_scores_as_predict(frames, resp):
    """``to_archive`` read by ``from_reference`` scores as ``predict``
    (rtol 1e-5, atol 1e-6: the numpy scorer runs in f64)."""
    cols, fr, _ = frames
    m = DeepLearning(device="cpu", **_cfg(resp, activation="tanh")).train(fr)
    sm = from_reference(*m.to_archive())
    rows = {k: cols[k] for k in ("x0", "x1", "x2", "x3")}
    rows["c"] = np.array(["a", "b", "c", None], dtype=object)[cols["c"]]
    got = sm.predict(rows)
    p = m.predict(fr)
    if m.datainfo.is_classifier:
        dom = [str(x) for x in m.datainfo.response_domain]
        want = np.stack([_col(p, k) for k in dom], axis=1)
        np.testing.assert_allclose(got["probabilities"], want, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got["predict"], _col(p, "predict"),
                                   rtol=1e-5, atol=1e-6)


def test_reference_archive_and_export_refusals(frames):
    """A JAX DL model's archive, read by ``from_reference``, scores as
    the JAX model; a maxout model and an autoencoder have no archive
    form, in the port as in the reference (maxout)."""
    cols, fr, jfr = frames
    cfg = _cfg("yb", activation="rectifier", precision="bf16")
    jm = JDeepLearning(**cfg).train(jfr)
    sm = from_reference(*jmojo._extract(jm))
    rows = {k: cols[k] for k in ("x0", "x1", "x2", "x3")}
    rows["c"] = np.array(["a", "b", "c", None], dtype=object)[cols["c"]]
    jp = jm.predict(jfr)
    np.testing.assert_allclose(
        sm.predict(rows)["probabilities"],
        np.stack([_col(jp, k) for k in ("n", "y")], axis=1), rtol=1e-5,
        atol=1e-6)
    mx = DeepLearning(device="cpu", **_cfg("yb", activation="maxout")) \
        .train(fr)
    with pytest.raises(ValueError, match="maxout"):
        mx.to_archive()
    with pytest.raises(ValueError, match="maxout"):
        jmojo._extract(JDeepLearning(**_cfg("yb", activation="maxout"))
                       .train(jfr))
    ae = DeepLearning(device="cpu", **_cfg(None, autoencoder=True)) \
        .train(fr)
    with pytest.raises(ValueError, match="autoencoder"):
        ae.to_archive()


def test_bf16_product_is_f32_before_the_bias(frames):
    """``precision="bf16"`` multiplies bf16-rounded operands into an f32
    product (equal to the f64 product of the rounded operands to f32
    accumulation), and its backward pass gives f32 gradients; a bf16
    train runs and scores."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((64, 40), generator=gen, requires_grad=True)
    w = torch.randn((40, 16), generator=gen, requires_grad=True)
    out = dl.product(a, w, bf16=True)
    assert out.dtype == torch.float32
    exact = a.detach().bfloat16().double() @ w.detach().bfloat16().double()
    np.testing.assert_allclose(out.detach().double().numpy(), exact.numpy(),
                               rtol=1e-6, atol=1e-5)
    assert not torch.equal(out.detach(), out.detach().bfloat16().float())
    out.sum().backward()
    assert a.grad.dtype == w.grad.dtype == torch.float32
    _, fr, _ = frames
    m = DeepLearning(device="cpu", **_cfg("yb", precision="bf16")).train(fr)
    assert np.isfinite(m.training_metrics.logloss)


def test_unknown_options_raise(frames):
    _, fr, _ = frames
    for kw, match in ((dict(activation="sigmoid"), "activation"),
                      (dict(loss="poisson"), "loss"),
                      (dict(precision="fp16"), "precision"),
                      (dict(offset_column="x0"), "offset_column"),
                      (dict(checkpoint="k"), "checkpoint")):
        with pytest.raises((ValueError, NotImplementedError), match=match):
            DeepLearning(device="cpu", **_cfg("yb", **kw)).train(fr)
