"""h2o3_tpu_torch's tree explanations and H2O MOJO importer held against
the JAX package.

TreeSHAP (``export/treeshap.py``, a copy of the JAX package's numpy
module) explains a port tree model (``SharedTreeModel.
predict_contributions``, ``varimp``) and a portable archive
(``ScoringModel.predict_contributions``).  A port model's trees are
carried into a JAX package model of the same frame, so both packages
explain the same trees on the same design: contributions agree to 1e-6
absolute (both compute in f64 from the same f32 inputs; the frames hold
f32), each row's contributions plus BiasTerm sum to the model's f32
margin within 1e-5, and every ``varimp`` method's importances agree to
rtol 1e-9.  The H2O MOJO importer (``export/h2o_mojo.py``, a copy of the
JAX package's) reads zips that the JAX package's ``write_h2o_mojo``
writes, for GBM, DRF (the port's trees), GLM, IsolationForest, KMeans and
DeepLearning (JAX package models with seeded parameters): its
predictions are bitwise the JAX loader's.  All of it runs on the CPU.
"""

import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import load_h2o_mojo as jload_h2o_mojo
from h2o3_tpu.export import write_h2o_mojo
from h2o3_tpu.frame.vec import T_CAT as J_CAT
from h2o3_tpu.models.tree import shared as jshared

from h2o3_tpu_torch.export import h2o_mojo
from h2o3_tpu_torch.export.mojo import from_reference, import_mojo
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DRF
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

_CATS = ("RACE", "DPROS")


def _prostate_cols(n=300, seed=0):
    """A prostate-shaped frame (the JAX package's MOJO writer tests):
    f32-representable numerics, two categoricals with missing cells, a
    binary response and a numeric one (``PSA``)."""
    rng = np.random.default_rng(seed)
    cols = {
        "AGE": rng.integers(45, 80, n).astype(np.float32),
        "PSA": np.round(rng.gamma(2.0, 8.0, n), 1).astype(np.float32),
        "VOL": np.round(rng.random(n) * 50, 1).astype(np.float32),
        "GLEASON": rng.integers(0, 10, n).astype(np.float32),
        "RACE": rng.choice(["black", "white", "other"], n).astype(object),
        "DPROS": rng.choice(["a", "b", "c", "d"], n).astype(object),
    }
    cols["VOL"][rng.random(n) < 0.1] = np.nan
    logit = (0.05 * (cols["GLEASON"] - 5) + 0.02 * (cols["PSA"] - 16)
             - 0.3 * (cols["RACE"] == "black"))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    cols["CAPSULE"] = np.where(y, "yes", "no").astype(object)
    return cols


def _frames(cols):
    types = {c: "cat" for c in (*_CATS, "CAPSULE") if c in cols}
    jfr = JFrame.from_numpy(cols, types={c: J_CAT for c in types})
    return jfr, Frame.from_numpy(cols, types=types, device="cpu")


def _rows(cols, skip=()):
    """The frame's rows as the MOJO readers take them (None for NaN)."""
    out = {}
    for k, v in cols.items():
        if k in skip:
            continue
        out[k] = [None if isinstance(x, float) and np.isnan(x) else x
                  for x in v.tolist()]
    return out


def _jax_model(tm, jfr):
    """The port model's trees and initial score in a JAX package model of
    the same kind, on the JAX frame's datainfo (the port's, field for
    field): the same trees in both packages, with no JAX train."""
    from h2o3_tpu.models.datainfo import DataInfo as JDataInfo
    from h2o3_tpu.models.tree import drf as jdrf
    from h2o3_tpu.models.tree import gbm as jgbm
    p = tm.params
    di = JDataInfo.fit(jfr, response_column=p.response_column,
                       standardize=False,
                       missing_values_handling="mean_imputation")
    Params, Model = (jdrf.DRFParameters, jdrf.DRFModel) \
        if tm.algo == "drf" else (jgbm.GBMParameters, jgbm.GBMModel)
    jm = Model(f"torch_explain_{tm.algo}",
               Params(response_column=p.response_column,
                      ntrees=tm.output["ntrees_trained"],
                      max_depth=tm.output["effective_max_depth"]), di)
    assert [s.name for s in di.specs] == [s.name for s in
                                          tm.datainfo.specs]
    jm.output.update(
        trees=[jshared.Tree(*([x.numpy() for x in getattr(t, a)]
                              for a in ("feat", "thr", "na_left", "valid")),
                            t.values.numpy(), t.cover.numpy())
               for t in tm.output["trees"]],
        init_score=float(np.asarray(tm.output["init_score"])),
        nclass_trees=1,
        distribution=tm.output.get("distribution", "gaussian"))
    return jm


def _contrib(fr_out, n):
    return np.stack([v.to_numpy()[:n] for v in fr_out.vecs], axis=1)


def _assert_explained_like_jax(jm, jfr, tm, fr, margin):
    """Contributions against the JAX model's on the same trees, rows
    summing to ``margin``, and both varimp methods."""
    n = fr.nrows
    got = tm.predict_contributions(fr)
    want = jm.predict_contributions(jfr)
    assert got.names == want.names
    assert got.names[-1] == "BiasTerm"
    gc, wc = _contrib(got, n), _contrib(want, n).astype(np.float64)
    assert np.isfinite(gc).all()
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm._contributions(fr).sum(axis=1), margin,
                               rtol=0, atol=1e-5)
    names = [s.name for s in tm.datainfo.specs]
    for method, kw in (("cover", {}), ("shap", {"frame": fr})):
        mine = tm.varimp(method=method, **kw)
        theirs = jm.varimp(method=method, **({"frame": jfr} if kw else {}))
        assert sorted(mine) == sorted(names) == sorted(theirs)
        assert max(mine.values()) == 1.0
        for k in names:
            assert mine[k] == pytest.approx(theirs[k], rel=1e-9, abs=1e-12)


def _assert_mojo_like_jax_loader(jm, tmp_path, rows, name):
    """``import_mojo`` of the JAX package's H2O MOJO zip: predictions
    bitwise the JAX loader's, every key, and finite."""
    path = write_h2o_mojo(jm, str(tmp_path / f"{name}.zip"))
    mine = import_mojo(path)
    assert isinstance(mine, h2o_mojo.H2OMojoModel)
    got, want = mine.predict(rows), jload_h2o_mojo(path).predict(rows)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if b.dtype.kind == "f":
            assert np.isfinite(b).all(), k
            np.testing.assert_array_equal(a.view(np.int64),
                                          b.view(np.int64), err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    return path


# ----------------------------------------------- (a) trees carried across

def test_gbm_explained_and_imported_like_jax(cl, tmp_path):
    """A binomial GBM of the port carried into the JAX package: TreeSHAP
    contributions and both varimp methods as the JAX model's; each row
    sums to the port's margin; its H2O MOJO, written by the JAX package,
    imported as the JAX loader reads it, also from the extracted
    directory."""
    cols = _prostate_cols()
    jfr, fr = _frames(cols)
    tm = GBM(response_column="CAPSULE", ntrees=4, max_depth=4, seed=7,
             device="cpu").train(fr)
    jm = _jax_model(tm, jfr)
    margin = tm._raw_scores(tm._design(fr))[: fr.nrows].numpy()
    _assert_explained_like_jax(jm, jfr, tm, fr, margin)
    rows = _rows(cols, skip=("CAPSULE",))
    path = _assert_mojo_like_jax_loader(jm, tmp_path, rows, "gbm")
    out = tmp_path / "gbm_dir"
    zipfile.ZipFile(path).extractall(out)
    np.testing.assert_array_equal(import_mojo(str(out)).predict(rows)[
        "probabilities"], jload_h2o_mojo(path).predict(rows)["probabilities"])


def test_drf_explained_and_imported_like_jax(cl, tmp_path):
    """A regression forest of the port carried into the JAX package: the
    forest's average (contributions scaled by 1/T, no initial score), both
    varimp methods, rows summing to the averaged leaf sum, its MOJO."""
    cols = _prostate_cols(seed=1)
    del cols["CAPSULE"]
    jfr, fr = _frames(cols)
    tm = DRF(response_column="PSA", ntrees=3, max_depth=4, seed=5,
             device="cpu").train(fr)
    jm = _jax_model(tm, jfr)
    margin = (tm._raw_scores(tm._design(fr)) / 3)[: fr.nrows].numpy()
    _assert_explained_like_jax(jm, jfr, tm, fr, margin)
    _assert_mojo_like_jax_loader(jm, tmp_path, _rows(cols, skip=("PSA",)),
                                 "drf")


# ------------------------------------- (b) the other families' H2O MOJOs

def _numeric_cols(n=200, seed=3):
    rng = np.random.default_rng(seed)
    return {f"x{j}": (rng.normal(size=n) * 3 + 1).astype(np.float32)
            for j in range(4)}


def _seeded_jax_model(algo, jfr, rng):
    """A JAX package model of ``algo`` on the frame's own datainfo (its
    builder's ``_make_datainfo``) with seeded parameters in place of a
    train: GLM coefficients, DeepLearning weights (one hidden layer of
    8), IsolationForest heap trees (leaf values as path lengths), KMeans
    centres.  The writer reads nothing else of them."""
    from h2o3_tpu import models as jm
    builder = {"glm": lambda: jm.GLM(response_column="CAPSULE",
                                     family="binomial", lambda_=0.0),
               "deeplearning": lambda: jm.DeepLearning(
                   response_column="CAPSULE", hidden=(8,),
                   activation="tanh"),
               "isolationforest": lambda: jm.IsolationForest(ntrees=5,
                                                             max_depth=4),
               "kmeans": lambda: jm.KMeans(k=3)}[algo]()
    di = builder._make_datainfo(jfr)
    model = builder.model_class(f"torch_explain_{algo}", builder.params, di)
    P = di.nfeatures
    if algo == "glm":
        model.output["family"] = "binomial"
        model.output["beta"] = rng.normal(size=P)
    elif algo == "deeplearning":
        model.output["weights"] = [
            (rng.normal(size=(P, 8)) / np.sqrt(P), rng.normal(size=8)),
            (rng.normal(size=(8, 2)), rng.normal(size=2))]
    elif algo == "kmeans":
        model.output["centers_std"] = rng.normal(size=(3, P))
    else:
        depth, F = 4, len(di.specs)
        model.output["trees"] = [jshared.Tree(
            [rng.integers(0, F, 2 ** d).astype(np.int32)
             for d in range(depth)],
            [rng.normal(size=2 ** d).astype(np.float32)
             for d in range(depth)],
            [rng.random(2 ** d) < 0.5 for d in range(depth)],
            [rng.random(2 ** d) < 0.8 for d in range(depth)],
            rng.integers(1, 9, 2 ** depth).astype(np.float32))
            for _ in range(5)]
    return model


@pytest.mark.parametrize("algo", ["glm", "isolationforest", "kmeans",
                                  "deeplearning"])
def test_import_h2o_mojo_matches_jax_loader(cl, tmp_path, algo):
    """GLM, IsolationForest, KMeans and DeepLearning MOJOs written by the
    JAX package's writer: ``import_mojo`` routes them to the port's
    reader, whose predictions are bitwise the JAX loader's."""
    rng = np.random.default_rng(len(algo))
    if algo in ("glm", "deeplearning"):
        cols = _prostate_cols(seed=2)
        jfr, _ = _frames(cols)
        rows = _rows(cols, skip=("CAPSULE",))
    else:
        cols = _numeric_cols()
        jfr = JFrame.from_numpy(cols)
        rows = _rows(cols)
    _assert_mojo_like_jax_loader(_seeded_jax_model(algo, jfr, rng),
                                 tmp_path, rows, algo)


def test_import_mojo_refuses_what_it_cannot_read(tmp_path):
    """A zip with neither model.json nor model.ini is refused; an H2O MOJO
    of an algorithm the reader lacks raises the reader's error."""
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("readme.txt", "nothing")
    with pytest.raises(ValueError, match="model.ini"):
        import_mojo(bad)
    alien = str(tmp_path / "alien.zip")
    with zipfile.ZipFile(alien, "w") as z:
        z.writestr("model.ini", "[info]\nalgo = naivebayes\n")
    with pytest.raises(NotImplementedError, match="naivebayes"):
        import_mojo(alien)


# ------------------------------------------------- (c) the port's own trees

@pytest.mark.parametrize("kind", ["gbm", "xgboost", "drf"])
def test_port_contributions_sum_to_margin_and_archive_agrees(kind):
    """A port-trained model: contributions plus BiasTerm sum to its margin
    (the raw score; a forest's averaged one), ``varimp`` lists every
    feature, and the portable archive's ``ScoringModel.
    predict_contributions`` equals the model's, bitwise in f64."""
    cols = _prostate_cols(seed=4)
    _, fr = _frames(cols)
    if kind == "drf":
        m = DRF(response_column="CAPSULE", ntrees=3, max_depth=5, seed=2,
                device="cpu").train(fr)
    else:
        B = GBM if kind == "gbm" else XGBoost
        m = B(response_column="CAPSULE", ntrees=4, max_depth=4, seed=2,
              device="cpu").train(fr)
    X = m._design(fr)
    raw = m._raw_scores(X)[: fr.nrows].numpy()
    margin = raw / 3 if kind == "drf" else raw
    contrib = m._contributions(fr)
    np.testing.assert_allclose(contrib.sum(axis=1), margin, rtol=0,
                               atol=1e-5)
    names = [s.name for s in m.datainfo.specs]
    assert sorted(m.varimp()) == sorted(names)
    sm = from_reference(*m.to_archive())
    out = sm.predict_contributions(_rows(cols, skip=("CAPSULE",)))
    assert out["names"] == names + ["BiasTerm"]
    np.testing.assert_array_equal(out["contributions"], contrib)


def test_explanations_refuse_what_the_reference_refuses():
    """Multinomial models have no contributions; varimp(method="shap")
    needs a frame; an archive without covers has no contributions."""
    rng = np.random.default_rng(9)
    cols = {"x": rng.normal(size=120).astype(np.float32),
            "y": rng.choice(["a", "b", "c"], 120).astype(object)}
    fr = Frame.from_numpy(cols, types={"y": "cat"}, device="cpu")
    m = GBM(response_column="y", ntrees=2, max_depth=3,
            device="cpu").train(fr)
    with pytest.raises(ValueError, match="binomial and regression"):
        m.predict_contributions(fr)
    with pytest.raises(ValueError, match="needs a frame"):
        m.varimp(method="shap")
    assert set(m.varimp()) == {"x"}
    meta, arrays = m.to_archive()
    with pytest.raises(ValueError, match="binomial/regression"):
        from_reference(meta, arrays).predict_contributions({"x": [0.0]})
