"""h2o3_tpu_torch's NaiveBayes, CoxPH, PSVM, TargetEncoder and Word2Vec,
and the archives of KMeans, PCA, SVD, NaiveBayes and IsotonicRegression,
held against the JAX package's on the CPU.

The same numpy columns from one seed (rows a multiple of the JAX mesh's
64-row padding) go through both packages.

Tolerances.  Host numpy work is bitwise: TargetEncoder's encodings (f64
host tables; the prior is an f32 sum, exact here on a 0/1 response with
unit weights, 1e-6 relative on a continuous one), Word2Vec's vocabulary
and every minibatch's (centre, context, negatives), the concordance
(counted exactly in both).  f32 device work:

* NaiveBayes probabilities to 1e-5;
* CoxPH coefficients to 1e-5 of the largest and the negative log
  partial likelihood rtol 1e-6, Efron and Breslow, with strata and a
  start column (counting-process rows);
* PSVM's objective rtol 1e-4 at convergence (optax's L-BFGS there,
  ``torch.optim.LBFGS`` here, as ``test_torch_glm.py`` holds GLM's);
* Word2Vec's embeddings within 1e-5 of the largest after the test's
  epochs (the same pairs and negatives, the updates summed in other
  orders), with equal ``find_synonyms`` order;
* the archives' numpy scorers: the same functions in both packages, so
  a JAX-trained model's archive scores bitwise as the JAX package's
  ``ScoringModel`` scores it, and a port model's archive scores as its
  ``predict`` to 1e-5.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.export.scoring import ScoringModel as JScoringModel
from h2o3_tpu.models import (PCA as JPCA, SVD as JSVD, PSVM as JPSVM,
                             CoxPH as JCoxPH, IsotonicRegression as JIso,
                             KMeans as JKMeans, NaiveBayes as JNaiveBayes,
                             TargetEncoder as JTargetEncoder,
                             Word2Vec as JWord2Vec)
from h2o3_tpu.models import word2vec as jw2v

from h2o3_tpu_torch.export.mojo import from_reference
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.metrics.gainslift import concordance_index
from h2o3_tpu_torch.models import (PCA, PSVM, SVD, CoxPH, GLRM,
                                   IsotonicRegression, KMeans, NaiveBayes,
                                   TargetEncoder, Word2Vec)
from h2o3_tpu_torch.models import coxph as coxph_mod
from h2o3_tpu_torch.models import word2vec as w2v

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 512
_TYPES = {"c": "cat", "y": "cat"}
_DOMAINS = {"c": ["a", "b", "c", "d"], "y": ["no", "yes"]}


def _columns(n=N, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    c = rng.integers(0, 4, n)
    eta = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * (c == 2) - 0.4
    cols = {f"x{j}": X[:, j].copy() for j in range(3)}
    cols["x2"][rng.random(n) < 0.05] = np.nan
    cols["c"] = np.where(rng.random(n) < 0.05, -1, c).astype(np.int32)
    cols["y"] = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.int32)
    cols["yr"] = eta + rng.normal(size=n)
    cols["wt"] = rng.uniform(0.5, 2.0, n)
    cols["fold"] = rng.integers(0, 3, n).astype(np.float64)
    return cols


def _frames(cols, types=_TYPES, domains=_DOMAINS):
    return (Frame.from_numpy(cols, types=types, domains=domains,
                             device="cpu"),
            JFrame.from_numpy(cols, types=types, domains=domains))


@pytest.fixture(scope="module")
def frames():
    cols = _columns()
    return (cols,) + _frames(cols)


def _probs(pred, dom, n=N):
    return np.stack([np.asarray(pred.vec(d).to_numpy())[:n] for d in dom],
                    axis=1)


# ------------------------------------------------------------- NaiveBayes
@pytest.mark.parametrize("laplace", [0.0, 1.0])
def test_naivebayes_matches_jax(frames, laplace):
    """The level tables, Gaussian moments and priors rtol 1e-6; the
    probabilities to 1e-5, labels equal; the training logloss rtol
    1e-5."""
    _, fr, jfr = frames
    cfg = dict(response_column="y", laplace=laplace, weights_column="wt",
               ignored_columns=["yr", "fold"])
    m = NaiveBayes(device="cpu", **cfg).train(fr)
    jm = JNaiveBayes(**cfg).train(jfr)
    for key in ("_log_cat_table", "_num_mu", "_num_inv2var", "apriori"):
        np.testing.assert_allclose(m.output[key], jm.output[key], rtol=1e-6,
                                   atol=1e-9)
    p, jp = (_probs(x.predict(f), ["no", "yes"])
             for x, f in ((m, fr), (jm, jfr)))
    assert np.abs(p - jp).max() <= 1e-5
    assert m.training_metrics.logloss == pytest.approx(
        jm.training_metrics.logloss, rel=1e-5)


# ------------------------------------------------------------------ CoxPH
def _survival(n=1024, seed=31):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    strat = rng.integers(0, 3, n)
    lam0 = np.array([0.5, 1.0, 2.0])[strat]
    T = rng.exponential(1.0 / (lam0 * np.exp(0.8 * x1 - 0.5 * x2)))
    C = rng.exponential(2.0, n)
    stop = np.round(np.minimum(T, C), 1) + 0.05        # ties
    start = np.where(rng.random(n) < 0.4,
                     np.round(stop * rng.uniform(0, 0.8, n), 1), 0.0)
    cols = {"x1": x1, "x2": x2, "stop": stop, "start": start,
            "event": (T <= C).astype(float), "w": rng.uniform(0.5, 2, n),
            "s": np.array(["a", "b", "c"], dtype=object)[strat],
            "g": np.array(["u", "v"], dtype=object)[rng.integers(0, 2, n)]}
    return _frames(cols, types={}, domains={})


@pytest.fixture(scope="module")
def survival():
    return _survival()


_COX_IGNORED = ["start", "w", "s", "g"]


@pytest.mark.parametrize("cfg", [
    dict(ties="efron"),
    dict(ties="breslow"),
    dict(ties="efron", stratify_by="s", weights_column="w"),
    dict(ties="breslow", stratify_by="s", start_column="start"),
    dict(ties="efron", start_column="start", standardize=False,
         interaction_pairs=[("x1", "x2"), ("g", "x2")],
         ignored_columns=["w", "s", "x2"])])
def test_coxph_matches_jax(survival, cfg):
    """Coefficients (standardized and reported) to 1e-5 of the largest,
    -log PL rtol 1e-6, the concordance bitwise, the linear predictor 1e-5
    of the largest.  (The Newton loop stops where the f32 likelihood
    stops moving by 1e-9 of itself, below its resolution, so the two
    packages may stop some iterations apart at the same optimum.)"""
    fr, jfr = survival
    cfg = dict(stop_column="stop", event_column="event", **cfg)
    cfg.setdefault("ignored_columns", [c for c in _COX_IGNORED
                                       if c not in cfg.values()])
    m, jm = CoxPH(device="cpu", **cfg).train(fr), JCoxPH(**cfg).train(jfr)
    b, jb = np.asarray(m.output["beta_std"]), np.asarray(jm.output["beta_std"])
    assert np.abs(b - jb).max() <= 1e-5 * np.abs(jb).max()
    assert list(m.output["coef"]) == list(jm.output["coef"])
    c, jc = (np.array(list(x.output["coef"].values())) for x in (m, jm))
    assert np.abs(c - jc).max() <= 1e-5 * np.abs(jc).max()
    assert m.output["neg_log_partial_likelihood"] == pytest.approx(
        jm.output["neg_log_partial_likelihood"], rel=1e-6)
    assert m.output["n_events"] == jm.output["n_events"]
    lp = m.predict(fr).vecs[0].to_numpy()
    jlp = np.asarray(jm.predict(jfr).vecs[0].to_numpy())
    assert np.abs(lp - jlp).max() <= 1e-5 * np.abs(jlp).max()
    # the concordance of the same linear predictor, counted both ways
    t = np.asarray(jfr.vec("stop").to_numpy())
    e = np.asarray(jfr.vec("event").to_numpy()) > 0
    assert coxph_mod.concordance(t, e, jlp) == concordance_index(t, e, jlp)


def test_concordance_counts_exactly():
    """``coxph.concordance`` is ``gainslift.concordance_index`` with unit
    weights, bitwise, on ties in time and in risk, NaN rows and no
    events."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 300):
        t = np.round(rng.exponential(1.0, n), 1)
        r = np.round(rng.normal(size=n), 1)
        e = rng.random(n) < 0.6
        if n > 5:
            t[0], r[1] = np.nan, np.nan
        assert coxph_mod.concordance(t, e, r) == concordance_index(t, e, r) \
            or (np.isnan(concordance_index(t, e, r))
                and np.isnan(coxph_mod.concordance(t, e, r)))
    assert np.isnan(coxph_mod.concordance([1.0, 2.0], [False, False],
                                          [0.1, 0.2]))


# ------------------------------------------------------------------- PSVM
def test_psvm_matches_jax(frames):
    """The random Fourier features bitwise (the same numpy draws), the
    squared-hinge objective rtol 1e-4 at convergence, the decision
    function 1e-3 of the largest, the labels of all but 1% of rows equal.
    A kernel other than gaussian raises, as in the reference."""
    _, fr, jfr = frames
    cfg = dict(response_column="y", ignored_columns=["yr", "fold", "wt"],
               hyper_param=0.5, seed=5, rank_ratio=0.125,
               max_iterations=100)
    m, jm = PSVM(device="cpu", **cfg).train(fr), JPSVM(**cfg).train(jfr)
    assert np.array_equal(m.output["rff_w"], jm.output["rff_w"])
    assert m.output["rank"] == jm.output["rank"] == 64
    assert m.output["objective"] == pytest.approx(jm.output["objective"],
                                                  rel=1e-4)
    f, jf = m.decision_function(fr), np.asarray(jm.decision_function(jfr))
    assert np.abs(f - jf).max() <= 1e-3 * np.abs(jf).max()
    assert np.mean(np.sign(f) != np.sign(jf)) <= 0.01
    for bad in (dict(kernel_type="linear"),):
        with pytest.raises(ValueError, match="gaussian"):
            PSVM(device="cpu", **{**cfg, **bad}).train(fr)
        with pytest.raises(ValueError, match="gaussian"):
            JPSVM(**{**cfg, **bad}).train(jfr)


# ---------------------------------------------------------- TargetEncoder
@pytest.mark.parametrize("resp,cfg", [
    ("y", dict(data_leakage_handling="none")),
    ("y", dict(data_leakage_handling="leave_one_out", blending=False)),
    ("y", dict(data_leakage_handling="k_fold", fold_column="fold",
               noise=0.01, seed=7)),
    ("yr", dict(data_leakage_handling="k_fold", fold_column="fold",
                inflection_point=5.0, smoothing=3.0))])
def test_target_encoder_matches_jax(frames, resp, cfg):
    """The encoding tables bitwise, the prior bitwise on the 0/1 response
    (rtol 1e-6 on the continuous one), and the training and the plain
    transforms' encodings bitwise on the 0/1 response, 1e-6 of the
    largest on the continuous one (the noise from the same draws)."""
    _, fr, jfr = frames
    others = [c for c in ("y", "yr", "x0", "x1", "x2") if c != resp]
    cfg = dict(response_column=resp, ignored_columns=others + ["fold"],
               **cfg)
    m = TargetEncoder(device="cpu", **cfg).train(fr)
    jm = JTargetEncoder(**cfg).train(jfr)
    tb, jtb = m.output["encoding_tables"], jm.output["encoding_tables"]
    assert list(tb) == list(jtb) == ["c"]
    for key, v in jtb["c"].items():
        assert np.array_equal(np.asarray(tb["c"][key]), np.asarray(v)), key
    exact = resp == "y"
    if exact:
        assert m.output["prior_mean"] == jm.output["prior_mean"]
    else:
        assert m.output["prior_mean"] == pytest.approx(
            jm.output["prior_mean"], rel=1e-6)
    for as_training in (False, True):
        e = m.transform(fr, as_training=as_training).vec("c_te").to_numpy()
        je = np.asarray(jm.transform(jfr, as_training=as_training)
                        .vec("c_te").to_numpy())
        if exact:
            assert np.array_equal(e, je)
        else:
            assert np.abs(e - je).max() <= 1e-6 * np.abs(je).max()


# --------------------------------------------------------------- Word2Vec
def _corpus(n_sent=150, seed=6):
    rng = np.random.default_rng(seed)
    topics = [["cat", "dog", "pet", "animal", "fur"],
              ["car", "road", "drive", "wheel", "fuel"]]
    words = []
    for _ in range(n_sent):
        topic = topics[rng.integers(0, 2)]
        words += [topic[i] for i in rng.integers(0, 5, rng.integers(3, 9))]
        words += ["the"] * int(rng.integers(0, 2))
        words.append(None)
    return np.array(words, dtype=object)


def _record_steps(monkeypatch, module, to_np):
    seen = []
    real = module._sgns_step

    def step(U, V, center, context, neg, lr):
        seen.append(tuple(np.asarray(to_np(a)).astype(np.int64)
                          for a in (center, context, neg)) + (lr,))
        return real(U, V, center, context, neg, lr)
    monkeypatch.setattr(module, "_sgns_step", step)
    return seen


def test_word2vec_matches_jax(monkeypatch):
    """The vocabulary, and every minibatch's centres, contexts,
    negatives and learning rate bitwise (the same draws in the same
    order); the embeddings within 1e-5 of the largest after 4 epochs;
    ``find_synonyms`` in the same order; ``transform`` both ways."""
    words = _corpus()
    cols = {"words": words}
    fr = Frame.from_numpy(cols, types={"words": "str"}, device="cpu")
    jfr = JFrame.from_numpy(cols, types={"words": "str"})
    cfg = dict(vec_size=16, epochs=4, min_word_freq=2, seed=3,
               window_size=3, sent_sample_rate=0.05, batch_size=64)
    steps = _record_steps(monkeypatch, w2v, lambda a: a.cpu())
    m = Word2Vec(device="cpu", **cfg).train(fr)
    jsteps = _record_steps(monkeypatch, jw2v, np.asarray)
    jm = JWord2Vec(**cfg).train(jfr)
    assert m.output["words"] == jm.output["words"]
    assert m.output["pairs_trained"] == jm.output["pairs_trained"]
    assert len(steps) == len(jsteps) > 0
    for a, b in zip(steps, jsteps):
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
        assert a[3] == b[3]
    E, jE = m.output["embeddings"], np.asarray(jm.output["embeddings"])
    assert np.abs(E - jE).max() <= 1e-5 * np.abs(jE).max()
    for wd in ("cat", "car", "the"):
        assert list(m.find_synonyms(wd, 4)) == list(jm.find_synonyms(wd, 4))
    for agg in ("none", "average"):
        T = np.stack([v.to_numpy() for v in
                      m.transform(fr, aggregate_method=agg).vecs], axis=1)
        jT = np.stack([np.asarray(v.to_numpy()) for v in
                       jm.transform(jfr, aggregate_method=agg).vecs],
                      axis=1)
        assert T.shape == jT.shape
        assert np.allclose(T, jT, rtol=0, atol=1e-5 * np.abs(jE).max(),
                           equal_nan=True)


def test_skipgram_pairs_layout():
    """The vectorized pair layout is the reference's double loop: per
    kept word, its window's other words in order, on the same draws."""
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    sents = [["a", "b", "c", "d", "e"], ["b", "x"], ["c", "a", "a", "b"]]
    vocab = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4}
    keep = np.array([1.0, 0.9, 0.8, 1.0, 0.5])
    cen, ctx = w2v.skipgram_pairs(sents, vocab, keep, 2, rng_a)
    want_c, want_x = [], []
    for s in sents:
        ids = [vocab[wd] for wd in s if wd in vocab
               and rng_b.random() < keep[vocab[wd]]]
        for i, c in enumerate(ids):
            win = rng_b.integers(1, 3)
            for j in range(max(0, i - win), min(len(ids), i + win + 1)):
                if j != i:
                    want_c.append(c)
                    want_x.append(ids[j])
    assert cen.tolist() == want_c and ctx.tolist() == want_x


# --------------------------------------------------------------- archives
def _archive_cases(fr, jfr, svd=False):
    base = dict(ignored_columns=["y", "yr", "fold", "wt"])
    return [
        (KMeans, JKMeans, dict(k=3, seed=1, **base)),
        (PCA, JPCA, dict(k=2, transform="standardize", **base)),
        (SVD, JSVD, dict(nv=2, transform="demean", **base)),
        (NaiveBayes, JNaiveBayes, dict(response_column="y",
                                       ignored_columns=["yr", "fold"])),
        (IsotonicRegression, JIso, dict(
            response_column="yr",
            ignored_columns=["x1", "x2", "c", "y", "fold", "wt"])),
    ]


def _rows(cols, n=96):
    return {k: (np.asarray(v)[:n].astype(object) if k == "c"
                else np.asarray(v)[:n]) for k, v in cols.items()}


def _coded(cols, n=96):
    """Rows for the scorers: the categorical as labels (missing as
    None)."""
    rows = {k: np.asarray(v)[:n] for k, v in cols.items()}
    lbl = np.array(_DOMAINS["c"] + [None], dtype=object)
    rows["c"] = lbl[np.where(rows["c"] < 0, 4, rows["c"])]
    return rows


@pytest.mark.parametrize("case", range(5))
def test_archives_score_as_the_reference(frames, case):
    """Each family's archive: a JAX-trained model's ``_extract`` carried
    by ``from_reference`` scores as the JAX ``ScoringModel`` (bitwise:
    the same numpy), and the port model's ``to_archive`` in the same
    layout (the same keys, shapes and metadata) scores as its own
    ``predict`` (labels equal, values to 1e-5)."""
    cols, fr, jfr = frames
    cls, jcls, cfg = _archive_cases(fr, jfr)[case]
    m, jm = cls(device="cpu", **cfg).train(fr), jcls(**cfg).train(jfr)
    rows = _coded(cols)
    jmeta, jarr = jmojo._extract(jm)
    got = from_reference(jmeta, jarr).predict(rows)
    want = JScoringModel(jmeta, jarr).predict(rows)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert np.array_equal(a, b, equal_nan=a.dtype != object), k
    meta, arr = m.to_archive()
    assert sorted(arr) == sorted(jarr)
    for k in arr:
        assert np.asarray(arr[k]).shape == np.asarray(jarr[k]).shape, k
    assert {k: v for k, v in meta.items() if k != "datainfo"}.keys() \
        == {k: v for k, v in jmeta.items() if k != "datainfo"}.keys()
    assert meta["family"] == jmeta["family"]
    sm = from_reference(meta, arr).predict(rows)
    pred = m.predict(fr)
    n = len(rows["x0"])
    if meta["family"] == "naivebayes":
        assert np.array_equal(sm["predict"],
                              np.asarray(pred.vec("predict").decoded())[:n])
        assert np.abs(sm["probabilities"]
                      - _probs(pred, ["no", "yes"], n)).max() <= 1e-5
    elif meta["family"] == "kmeans":
        assert np.array_equal(sm["predict"],
                              pred.vecs[0].to_numpy()[:n].astype(float))
    else:
        want_p = np.stack([v.to_numpy()[:n] for v in pred.vecs], axis=1)
        if m.algo == "svd":
            # the archive scores the projections, predict gives U = XV/d
            want_p = want_p * np.asarray(m.output["d"])[None, :]
        assert np.allclose(sm["predict"], want_p.reshape(-1), rtol=1e-5,
                           atol=1e-5, equal_nan=True)


# --------------------------------------------------------------- refusals
def test_unported_options_raise(frames):
    """Each option the reference refuses, the port refuses too."""
    _, fr, jfr = frames
    cases = [
        (KMeans, dict(k=2, init="kmeans||", ignored_columns=["y"])),
        (PCA, dict(k=2, pca_method="glrm", ignored_columns=["y"])),
        (PCA, dict(k=2, transform="whiten", ignored_columns=["y"])),
        (GLRM, dict(k=2, loss="quantile", ignored_columns=["y"])),
        (GLRM, dict(k=2, regularization_x="l2", ignored_columns=["y"])),
        (CoxPH, dict(stop_column="yr", event_column="y", ties="exact")),
        (TargetEncoder, dict(response_column="y",
                             data_leakage_handling="kfold")),
        (NaiveBayes, dict(response_column="yr")),
        (PSVM, dict(response_column="c", ignored_columns=["y"])),
    ]
    for cls, cfg in cases:
        with pytest.raises(ValueError):
            cls(device="cpu", **cfg).train(fr)


def test_new_builders_run_on_cuda_unless_told(frames, monkeypatch):
    """Without CUDA every new builder raises unless given device="cpu"."""
    _, fr, _ = frames
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = dict(ignored_columns=["y", "yr", "fold", "wt"])
    for cls, cfg in [(KMeans, dict(k=2, **base)), (PCA, dict(k=2, **base)),
                     (SVD, dict(nv=2, **base)), (GLRM, dict(k=2, **base)),
                     (NaiveBayes, dict(response_column="y")),
                     (CoxPH, dict(stop_column="yr", event_column="y")),
                     (TargetEncoder, dict(response_column="y"))]:
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(**cfg).train(fr)
    wfr = Frame.from_numpy({"w": _corpus(20)}, types={"w": "str"},
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Word2Vec(vec_size=4, min_word_freq=1).train(wfr)
    m = Word2Vec(vec_size=4, min_word_freq=1, epochs=1,
                 sent_sample_rate=1.0, device="cpu").train(wfr)
    assert m.output["device"].type == "cpu"
