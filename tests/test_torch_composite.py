"""h2o3_tpu_torch's composite builders (AdaBoost, RuleFit,
StackedEnsemble, GAM, ANOVAGLM, ModelSelection) and the archive writer
``export_mojo``, held against the JAX package's on the CPU.

The same numpy columns from one seed (2,048 rows, a multiple of the JAX
mesh's 64-row padding) go through both packages.  Every JAX train lives
in the one test that reads it (no shared fixture that several xdist
workers would each rebuild).

Tolerances.  The JAX package sums the trees' histograms in f32 (its CPU
einsum); the port sums them exactly in int64 fixed point, so a split
could part from the reference's only on a near tie.  Its GLM solves in
f32 on the device, the port's in f64 on the host from an f32 Gram:

* AdaBoost: its default 50 learners on a sharper response (5x the
  logit), every learner's splits (valid flags, features, NA directions,
  thresholds) equal, the alphas (the |leaf values|) to rtol 1e-5 and the
  probabilities to 1e-5.  Fifty learners take the row weights D of the
  last learner over three orders of magnitude (1.2e3 between the largest
  and the smallest on this frame; the test asserts 1e3), where each
  tree's own fixed-point scale must keep the small weights' digits; more
  learners would add little to the JAX package's compile-bound train;
* RuleFit (the JAX generator's trees carried across,
  ``testing.trees_from_reference``): the rules, their descriptions and
  the [N, R] rule matrix bitwise; the L1 GLM's coefficients to 1e-5 of
  the largest, the CD tolerance of ``tests/test_torch_glm.py``;
* StackedEnsemble: the level-one frame bitwise given the same base CV
  predictions; the metalearner's coefficients to 1e-5 of the largest;
* GAM: every basis builder bitwise (the same numpy); coefficients to
  1e-5 of the largest and predictions to 1e-5 of the largest |prediction|
  for each ``bs``;
* ANOVAGLM: the degrees of freedom equal, each sum of squares to 1e-5 of
  the full model's residual deviance (a difference of two f32
  deviances), F within that error carried through its formula, the
  p-values to 1e-4;
* ModelSelection: the chosen subsets equal per size, R^2 to 1e-6, and
  maxrsweep's coefficients to 1e-6 of the largest;
* ``export_mojo``: a port-written archive read by the JAX package's
  ``import_mojo`` scores bitwise as the port's ``import_mojo`` (the same
  numpy scorer), and the families without an archive form raise the JAX
  package's ``no portable export``.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.models import gam as jgam
from h2o3_tpu.runtime import dkv as jdkv

from h2o3_tpu_torch import export_mojo, import_mojo
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import gam as pgam
from h2o3_tpu_torch.runtime import dkv as pdkv
from h2o3_tpu_torch.testing import trees_from_reference

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 2048
_TYPES = {"c": "cat", "yb": "cat"}
_DOMAINS = {"c": ["a", "b", "c", "d"], "yb": ["no", "yes"]}
_RESPONSES = ("yb", "yr")


def _columns(n=N, seed=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    c = rng.integers(0, 4, n)
    eta = 1.1 * X[:, 0] - 0.7 * X[:, 1] + 0.6 * np.sin(2 * X[:, 2]) \
        + 0.5 * (c == 2) - 0.3
    cols = {f"x{j}": X[:, j].copy() for j in range(3)}
    cols["x2"][rng.random(n) < 0.05] = np.nan
    cols["c"] = np.where(rng.random(n) < 0.05, -1, c).astype(np.int32)
    cols["yb"] = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.int32)
    cols["yr"] = eta + 0.5 * rng.normal(size=n)
    return cols


def _frames(cols, types=_TYPES, domains=_DOMAINS):
    return (Frame.from_numpy(cols, types=types, domains=domains,
                             device="cpu"),
            JFrame.from_numpy(cols, types=types, domains=domains))


def _col(pred, name, n=N):
    return np.asarray(pred.vec(name).to_numpy(), np.float64) \
        .reshape(-1)[:n]


def _close_coefs(b, jb, tol):
    b, jb = np.asarray(b, np.float64), np.asarray(jb, np.float64)
    assert b.shape == jb.shape
    gap = np.abs(b - jb).max() / np.abs(jb).max()
    assert gap <= tol, gap


def _same_tree(t, jt, what):
    assert len(t.feat) == len(jt.feat), what
    for d in range(len(jt.feat)):
        v, jv = t.valid[d].numpy(), np.asarray(jt.valid[d])
        assert np.array_equal(v, jv), (what, d)
        for a, b in ((t.feat[d], jt.feat[d]), (t.na_left[d], jt.na_left[d]),
                     (t.thr[d], jt.thr[d])):
            assert np.array_equal(a.numpy()[v], np.asarray(b)[jv]), (what, d)


# ----------------------------------------------------------------- AdaBoost
def test_adaboost_matches_jax():
    """50 learners (see the module notes): splits equal, alphas rtol
    1e-5, probabilities 1e-5; the last learner's row weights span more
    than three orders of magnitude."""
    from h2o3_tpu.models import AdaBoost as JAdaBoost
    from h2o3_tpu_torch.models import AdaBoost
    cols = _columns()
    rng = np.random.default_rng(99)
    X = np.nan_to_num(np.stack([cols["x0"], cols["x1"], cols["x2"]], 1))
    eta = 5.0 * (1.1 * X[:, 0] - 0.7 * X[:, 1] + 0.6 * np.sin(2 * X[:, 2])
                 + 0.5 * (cols["c"] == 2) - 0.3)
    cols["ys"] = (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.int32)
    fr, jfr = _frames(cols, dict(_TYPES, ys="cat"),
                      dict(_DOMAINS, ys=["no", "yes"]))
    cfg = dict(response_column="ys", ignored_columns=["yb", "yr"], seed=1)
    weights = []
    from h2o3_tpu_torch.models import adaboost as ada
    real = ada.build_tree

    def spy(codes, g, h, w, *a, **kw):
        weights.append(w[:N].clone())
        return real(codes, g, h, w, *a, **kw)
    ada.build_tree = spy
    try:
        m = AdaBoost(device="cpu", **cfg).train(fr)
    finally:
        ada.build_tree = real
    jm = JAdaBoost(**cfg).train(jfr)
    trees, jtrees = m.output["trees"], jm.output["trees"]
    assert len(trees) == len(jtrees) == 50
    for i, (t, jt) in enumerate(zip(trees, jtrees)):
        _same_tree(t, jt, f"learner {i}")
    alphas = np.asarray(m.output["alphas"])
    jalphas = np.asarray([np.abs(np.asarray(t.values)).max()
                          for t in jtrees])
    np.testing.assert_allclose(alphas, jalphas, rtol=1e-5)
    D = weights[-1][weights[-1] > 0]
    assert float(D.max() / D.min()) > 1e3
    p, jp = _col(m.predict(fr), "yes"), _col(jm.predict(jfr), "yes")
    assert np.abs(p - jp).max() <= 1e-5
    assert m.training_metrics.auc == pytest.approx(jm.training_metrics.auc,
                                                   abs=1e-6)
    with pytest.raises(ValueError, match="binary response"):
        AdaBoost(response_column="c", ignored_columns=["yb", "yr", "ys"],
                 nlearners=1, device="cpu").train(fr)


# ------------------------------------------------------------------ RuleFit
def test_rulefit_matches_jax_with_carried_generator(monkeypatch):
    """The JAX RuleFit's generator trees carried into the port's
    (``trees_from_reference``): rules, descriptions and the rule matrix
    bitwise, the L1 GLM's coefficients to 1e-5 of the largest, the
    predictions to 1e-5, the same rule importances' order."""
    from h2o3_tpu.models import RuleFit as JRuleFit
    from h2o3_tpu_torch.models import GBM, RuleFit
    from h2o3_tpu_torch.models.rulefit import RuleFitModel
    from h2o3_tpu_torch.models.tree.shared import StackedTrees, TreeList
    fr, jfr = _frames(_columns())
    cfg = dict(response_column="yr", ignored_columns=["yb"],
               rule_generation_ntrees=5, max_rule_length=3, lambda_=0.01,
               seed=3)
    jm = JRuleFit(**cfg).train(jfr)
    jgen = jdkv.get(jm.output["rule_model_key"])
    carried = trees_from_reference(jgen.output["trees"])

    def grow(self, frame):
        gen = GBM(response_column="yr", ignored_columns=["yb"], ntrees=1,
                  max_depth=3, seed=3, device="cpu").train(frame)
        st = StackedTrees.from_trees(carried)
        gen.output.update(stacked=st, trees=TreeList(st))
        return gen
    monkeypatch.setattr(RuleFit, "_grow_generator", grow)
    m = RuleFit(device="cpu", **cfg).train(fr)
    assert isinstance(m, RuleFitModel)
    assert m.output["rules"] == [tuple(r) for r in jm.output["rules"]]
    assert m.output["rule_descriptions"] == jm.output["rule_descriptions"]
    R = m.rule_columns(fr)
    assert R.shape == (len(m.output["rules"]), fr.padded_rows)
    assert np.array_equal(R[:, :N].numpy().T, jm._rule_matrix(jfr))
    assert torch.isnan(R[:, N:]).all()
    glm = pdkv.get(m.output["glm_key"])
    jglm = jdkv.get(jm.output["glm_key"])
    _close_coefs(glm.output["beta_std_flat"], jglm.output["beta_std_flat"],
                 1e-5)
    p, jp = _col(m.predict(fr), "predict"), _col(jm.predict(jfr), "predict")
    assert np.abs(p - jp).max() <= 1e-5 * np.abs(jp).max()
    top = [r["variable"] for r in m.rule_importance()[:5]]
    assert top == [r["variable"] for r in jm.rule_importance()[:5]]


def test_rulefit_trains_its_generator_on_the_fit_device():
    """The port's own generator (sampled at 0.7: its trees are the port's
    draws, so no reference parity): the generator lies on the fit's
    device with the RuleFit's features, ``max_num_rules`` keeps the JAX
    package's numpy draw of rules, and a multinomial response raises the
    JAX package's error."""
    from h2o3_tpu_torch.models import RuleFit
    fr, _ = _frames(_columns())
    m = RuleFit(response_column="yb", ignored_columns=["yr"], seed=5,
                rule_generation_ntrees=4, max_rule_length=2,
                max_num_rules=9, lambda_=1e-3, device="cpu").train(fr)
    gen = pdkv.get(m.output["rule_model_key"])
    assert gen.output["stacked"].values.device.type == "cpu"
    assert [s.name for s in gen.datainfo.specs] == \
        [s.name for s in m.datainfo.specs]
    every = [(t, d, nid) for t in range(4) for d in (1, 2)
             for nid in range(2 ** d)]
    keep = np.random.default_rng(5).choice(len(every), 9, replace=False)
    assert m.output["rules"] == [every[i] for i in sorted(keep)]
    assert m.predict(fr).vec("predict").nrows == N
    cols = _columns()
    cols["c3"] = np.asarray(["u", "v", "w"], dtype=object)[
        np.arange(N) % 3]
    fr3 = Frame.from_numpy(cols, types=_TYPES, domains=_DOMAINS,
                           device="cpu")
    with pytest.raises(ValueError, match="binary classification only"):
        RuleFit(response_column="c3", ignored_columns=["yb", "yr"],
                device="cpu").train(fr3)


# -------------------------------------------------------- StackedEnsemble
def test_stacked_ensemble_matches_jax():
    """Port base models (a GBM and a GLM, nfolds=3, CV predictions kept)
    and two JAX base models handed the same CV predictions: the level-one
    frame bitwise, the GLM metalearner's coefficients to 1e-5 of the
    largest; a base model without CV predictions raises the JAX
    package's error."""
    from h2o3_tpu.models import GLM as JGLM
    from h2o3_tpu.models import StackedEnsemble as JSE
    from h2o3_tpu_torch.models import GBM, GLM, StackedEnsemble
    fr, jfr = _frames(_columns())
    base = dict(response_column="yb", ignored_columns=["yr"], nfolds=3,
                keep_cross_validation_predictions=True, seed=2)
    bases = [GBM(ntrees=5, max_depth=3, device="cpu", **base).train(fr),
             GLM(device="cpu", **base).train(fr)]
    jbases = [JGLM(response_column="yb", ignored_columns=["yr"], seed=2,
                   lambda_=lam).train(jfr) for lam in (0.0, 1e-3)]
    for b, jb in zip(bases, jbases):
        assert b.cv_predictions.shape == (N, 2)
        jb.cv_predictions = b.cv_predictions.copy()
    cfg = dict(response_column="yb", seed=2)
    m = StackedEnsemble(base_models=bases, device="cpu", **cfg).train(fr)
    jm = JSE(base_models=jbases, **cfg).train(jfr)
    se = StackedEnsemble(base_models=bases, device="cpu", **cfg)
    lone = se.level_one_training(fr, bases)
    meta, jmeta = (dkv.get(x.output["metalearner_key"]) for dkv, x in
                   ((pdkv, m), (jdkv, jm)))
    jl = jmeta.datainfo
    assert len(lone.names) == len(jl.specs) + 1
    for j, spec in enumerate(meta.datainfo.specs):
        a = lone.vec(spec.name).data[:N].numpy()
        b = np.asarray(bases[j].cv_predictions[:, 1], np.float32)
        assert np.array_equal(a, b), spec.name
        assert spec.mean == pytest.approx(jl.specs[j].mean, rel=1e-6)
    _close_coefs(meta.output["beta_std_flat"], jmeta.output["beta_std_flat"],
                 1e-5)
    assert meta.params.lambda_ == jmeta.params.lambda_ == 1e-5
    pred = m.predict(fr)
    assert np.array_equal(_col(pred, "yes"),
                          _col(meta.predict(m._level_one(fr)), "yes"))
    bases[1].cv_predictions = jbases[1].cv_predictions = None
    for se_cls, bm, f in ((StackedEnsemble, bases[1], fr),
                          (JSE, jbases[1], jfr)):
        with pytest.raises(ValueError, match=f"base model {bm.key} has no "
                           "CV holdout predictions"):
            se_cls(base_models=[bm], **cfg,
                   **({"device": "cpu"} if f is fr else {})).train(f)


# ---------------------------------------------------------------------- GAM
def test_gam_basis_builders_are_bitwise_the_jax_packages():
    """The copied numpy builders on the same inputs: bitwise."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=500)
    knots = np.unique(np.quantile(x, np.linspace(0, 1, 8)))
    for mod_a, mod_b in ((pgam, jgam),):
        Fa, Sa = mod_a._crs_construct(knots)
        Fb, Sb = mod_b._crs_construct(knots)
        assert np.array_equal(Fa, Fb) and np.array_equal(Sa, Sb)
        Xa = mod_a._crs_eval(x, knots, Fa)
        assert np.array_equal(Xa, mod_b._crs_eval(x, knots, Fb))
        Ta, da = mod_a._center_and_diagonalize(Xa, Sa)
        Tb, db = mod_b._center_and_diagonalize(Xa, Sb)
        assert np.array_equal(Ta, Tb) and np.array_equal(da, db)
        Xk = rng.normal(size=(9, 2))
        Xr = rng.normal(size=(300, 2))
        Za, S2a = mod_a._tp_construct(Xk)
        Zb, S2b = mod_b._tp_construct(Xk)
        assert np.array_equal(Za, Zb) and np.array_equal(S2a, S2b)
        assert np.array_equal(mod_a._tp_eval(Xr, Xk, Za),
                              mod_b._tp_eval(Xr, Xk, Zb))
        for d in (1, 2, 3):
            r = np.abs(rng.normal(size=40))
            r[0] = 0.0
            assert np.array_equal(mod_a._tp_eta(r, d), mod_b._tp_eta(r, d))
        assert np.array_equal(mod_a._is_basis(x, knots),
                              mod_b._is_basis(x, knots))


@pytest.mark.parametrize("bs,gam_columns", [
    ("cr", ["x0"]), ("tp", [["x0", "x2"]]), ("is", ["x0"])])
def test_gam_matches_jax(bs, gam_columns):
    """Each basis: the expanded design's columns bitwise, coefficients to
    1e-5 of the largest, predictions to 1e-5 of the largest |prediction|,
    the smooths' penalty factors and non-negative names equal."""
    from h2o3_tpu.models import GAM as JGAM
    from h2o3_tpu_torch.models import GAM
    fr, jfr = _frames(_columns())
    cfg = dict(response_column="yr", ignored_columns=["yb"],
               gam_columns=gam_columns, bs=bs, num_knots=6, scale=0.5,
               family="gaussian", seed=1)
    m = GAM(device="cpu", **cfg).train(fr)
    jm = JGAM(**cfg).train(jfr)
    ex, jex = m._expand(fr), jm._expand(jfr)
    assert ex.names == jex.names
    for name in ex.names:
        if "_gam" in name:
            assert np.array_equal(ex.vec(name).to_numpy(),
                                  np.asarray(jex.vec(name).to_numpy())
                                  .reshape(-1)), name
    glm, jglm = pdkv.get(m.output["glm_key"]), jdkv.get(jm.output["glm_key"])
    assert glm.params.penalty_factors == jglm.params.penalty_factors
    assert glm.params.non_negative == jglm.params.non_negative
    _close_coefs(glm.output["beta_std_flat"], jglm.output["beta_std_flat"],
                 1e-5)
    p, jp = _col(m.predict(fr), "predict"), _col(jm.predict(jfr), "predict")
    assert np.abs(p - jp).max() <= 1e-5 * np.abs(jp).max()
    assert m.coef.keys() == jm.coef.keys()


# ----------------------------------------------------------------- ANOVAGLM
@pytest.mark.parametrize("resp,family,ignored", [
    ("yr", "gaussian", ["yb"]), ("yb", "binomial", ["yr", "c"])])
def test_anovaglm_matches_jax(resp, family, ignored):
    """The table against the JAX package's (see the module notes for the
    tolerances): the F test with a categorical predictor (its degrees of
    freedom its levels less one), the likelihood-ratio chi-square on the
    numerics; ``result()`` a frame of it on the fit's device."""
    from h2o3_tpu.models import ANOVAGLM as JANOVAGLM
    from h2o3_tpu_torch.models import ANOVAGLM
    fr, jfr = _frames(_columns())
    cfg = dict(response_column=resp, ignored_columns=ignored,
               family=family, seed=1)
    m = ANOVAGLM(device="cpu", **cfg).train(fr)
    jm = JANOVAGLM(**cfg).train(jfr)
    rows, jrows = m.output["anova_table"], jm.output["anova_table"]
    full = pdkv.get(m.output["full_model"])
    dev_full = full.output["residual_deviance"]
    df_resid = N - sum(s.width if s.type == "cat" else 1
                       for s in full.datainfo.specs) - 1
    assert [r["predictor"] for r in rows] == [r["predictor"] for r in jrows]
    # F is ss / df, over the residual mean square for gaussian: the sum
    # of squares' error carried through it
    f_scale = df_resid / dev_full if family == "gaussian" else 1.0
    for r, jr in zip(rows, jrows):
        assert r["df"] == jr["df"]
        assert abs(r["ss"] - jr["ss"]) <= 1e-5 * dev_full, r
        assert abs(r["f"] - jr["f"]) <= 1e-5 * dev_full * f_scale / r["df"]
        assert abs(r["p"] - jr["p"]) <= 1e-4, r
    res = m.result()
    assert res.device.type == "cpu" and res.nrows == len(rows)
    assert list(res.vec("predictor").decoded()) == \
        [r["predictor"] for r in rows]


# ----------------------------------------------------------- ModelSelection
def _selection_columns(n=N, seed=17):
    """Two numerics (x1 correlated 0.6 with x0, so that sequential
    replacement has work) and a 3-level categorical."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=n)
    x1 = 0.6 * x0 + 0.8 * rng.normal(size=n)
    g = rng.integers(0, 3, n)
    y = 2.0 * x0 - 1.2 * x1 + 0.8 * (g == 1) + 0.5 * rng.normal(size=n)
    return {"x0": x0, "x1": x1, "g": g.astype(np.int32), "y": y}


@pytest.mark.parametrize("mode", ["maxr", "forward", "backward",
                                  "maxrsweep"])
def test_modelselection_matches_jax(mode):
    """Every size's chosen predictors equal, its R^2 to 1e-6; maxrsweep's
    coefficients (from the swept cross-product matrix) to 1e-6 of the
    largest; the result frame on the fit's device."""
    from h2o3_tpu.models import ModelSelection as JModelSelection
    from h2o3_tpu_torch.models import ModelSelection
    types, domains = {"g": "cat"}, {"g": ["p", "q", "r"]}
    fr, jfr = _frames(_selection_columns(), types, domains)
    cfg = dict(response_column="y", mode=mode, family="gaussian", seed=1,
               max_predictor_number=2, min_predictor_number=1)
    m = ModelSelection(device="cpu", **cfg).train(fr)
    jm = JModelSelection(**cfg).train(jfr)
    sub, jsub = m.output["subsets"], jm.output["subsets"]
    assert [(r["size"], r["predictors"]) for r in sub] == \
        [(r["size"], r["predictors"]) for r in jsub]
    for r, jr in zip(sub, jsub):
        assert abs(r["metric"] - jr["metric"]) <= 1e-6, (r, jr)
        if mode == "maxrsweep":
            assert r["coefficients"].keys() == jr["coefficients"].keys()
            _close_coefs(list(r["coefficients"].values()),
                         list(jr["coefficients"].values()), 1e-6)
    res = m.result()
    assert res.device.type == "cpu" and res.nrows == len(sub)
    if mode == "maxrsweep":
        with pytest.raises(ValueError, match="build_glm_model"):
            m.best_model(2)
    else:
        best = m.best_model(sub[-1]["size"])
        assert best.datainfo.response_column == "y"


def test_modelselection_maxrsweep_blocks_equal_one_product(monkeypatch):
    """The blocked cross-product matrix equals one product of the whole
    [X, y] to f32 rounding, and with blocks of a few rows (many blocks)
    the search chooses the same subsets."""
    from h2o3_tpu_torch.models import ModelSelection
    from h2o3_tpu_torch.models import datainfo as di_mod
    from h2o3_tpu_torch.models import modelselection as ms
    fr, _ = _frames(_selection_columns(), {"g": "cat"},
                    {"g": ["p", "q", "r"]})
    cfg = dict(response_column="y", mode="maxrsweep", max_predictor_number=3,
               device="cpu")
    one = ModelSelection(**cfg).train(fr)
    P = len(one.datainfo.coef_names)
    monkeypatch.setattr(di_mod, "BLOCK_BYTES", 4 * (P + 1) * 100)
    assert len(di_mod.row_blocks(fr.padded_rows, P + 1)) > 10
    many = ModelSelection(**cfg).train(fr)
    assert [r["predictors"] for r in one.output["subsets"]] == \
        [r["predictors"] for r in many.output["subsets"]]
    X = torch.randn(300, 7, dtype=torch.float64)
    y, w = torch.randn(300, dtype=torch.float64), torch.rand(300).double()
    Z = torch.cat([X, y[:, None]], dim=1)
    want = (Z * w[:, None]).t() @ Z
    got = ms.cross_products(X.float(), y.float(), w.float()).double()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)


# -------------------------------------------------------------- export_mojo
def test_export_mojo_round_trips_through_both_readers(tmp_path):
    """Port-trained GBM, DRF, GLM, KMeans and NaiveBayes written by
    ``export_mojo`` and read by the JAX package's ``import_mojo``: bitwise
    the port's reader's scores (both read the same numpy arrays), and
    those equal the model's own predictions; the composite builders'
    models raise ``no portable export``."""
    from h2o3_tpu_torch.models import (DRF, GBM, GLM, AdaBoost, KMeans,
                                       NaiveBayes)
    from h2o3_tpu_torch.models.tree.uplift import UpliftDRF
    cols = _columns()
    fr, _ = _frames(cols)
    rows = {k: (np.asarray(["no", "yes"], dtype=object)[v]
                if k == "yb" else np.where(v < 0, np.nan, v)
                if k == "c" else v)
            for k, v in cols.items()}
    rows["c"] = np.asarray(["a", "b", "c", "d", None], dtype=object)[
        np.where(cols["c"] < 0, 4, cols["c"])]
    sup = dict(response_column="yb", ignored_columns=["yr"])
    models = [GBM(ntrees=3, max_depth=3, device="cpu", **sup),
              DRF(ntrees=3, max_depth=3, seed=1, device="cpu", **sup),
              GLM(device="cpu", **sup),
              KMeans(k=3, seed=1, ignored_columns=list(_RESPONSES),
                     device="cpu"),
              NaiveBayes(device="cpu", **sup)]
    for b in models:
        m = b.train(fr)
        path = export_mojo(m, str(tmp_path / f"{m.algo}.zip"))
        ours, theirs = import_mojo(path), jmojo.import_mojo(path)
        assert type(theirs).__module__.startswith("h2o3_tpu.")
        got, jgot = ours.predict(rows), theirs.predict(rows)
        assert got.keys() == jgot.keys()
        for k in got:
            a, b = np.asarray(got[k]), np.asarray(jgot[k])
            assert a.dtype == b.dtype and np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"), (m.algo, k)
        if m.algo == "kmeans":
            want = m.predict(fr).vecs[0].to_numpy()
            assert np.array_equal(np.asarray(got["predict"], np.float64),
                                  want.astype(np.float64))
        elif m.algo != "naivebayes":
            want = _col(m.predict(fr), "yes")
            assert np.abs(np.asarray(got["probabilities"])[:, 1]
                          - want).max() <= 1e-5, m.algo
    ada = AdaBoost(nlearners=2, device="cpu", **sup).train(fr)
    cols_u = dict(cols, t=(np.arange(N) % 2).astype(np.float64))
    fru = Frame.from_numpy(cols_u, types=_TYPES, domains=_DOMAINS,
                           device="cpu")
    upl = UpliftDRF(response_column="yb", treatment_column="t", ntrees=2,
                    max_depth=2, ignored_columns=["yr"],
                    device="cpu").train(fru)
    for m in (ada, upl):
        with pytest.raises(ValueError, match="no portable export"):
            export_mojo(m, str(tmp_path / "no.zip"))
