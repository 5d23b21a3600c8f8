"""h2o3_tpu_torch's frame synthesis (``frame.create``), the ``Frame``
munging verbs, and the builders that wait on the data plane
(``train_segments``, ``Infogram``, ``Grep``) and on concurrent builds
(``GridSearch(parallelism=n)``, ``models/parallel.py``), held against the
JAX package's on the CPU and against themselves.

Tolerances.  ``create_frame``, ``insert_missing_values``,
``interaction`` and ``tabulate``: bitwise (the same numpy draws in the
same order).  ``dct_transform``: 1e-5 of the largest |value| (both are
f32 products).  The ``Frame`` verbs as in ``tests/test_torch_rapids.py``
(orders, codes and counts bitwise, sums within 1e-6 of the largest).
``train_segments``: the segment table (segment values, row counts,
statuses, errors) equal to the JAX package's over the same stub builder,
and every segment's XGBoost bitwise the port's own train on that
segment's rows.  ``Infogram``: the features, their order and the
admissible set equal; relevance and CMI within 1e-5 (trees grown from
the same numpy columns; the CMI is a mean of log2 probabilities).
``Grep``: the match table bitwise.  Grid waves: every member of
``parallelism=2`` bitwise its ``parallelism=1`` twin.
"""

import gzip
import time
import types

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.frame import create as jcreate
from h2o3_tpu.models import Infogram as JInfogram
from h2o3_tpu.models.grep import grep as jgrep
from h2o3_tpu.models import segments as jsegments

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.frame import create as pcreate
from h2o3_tpu_torch.models import (GBM, Grep, GridSearch, Infogram,
                                   XGBoost, grep, parallel, train_segments)
from h2o3_tpu_torch.rapids import ops as pops

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

_RTOL = 1e-6


def _host(v):
    if v.type == "cat":
        return np.asarray(v.decoded(), object)
    if v.type in ("str", "uuid"):
        return np.asarray(v.to_numpy(), object)
    return np.asarray(v.to_numpy(), np.float64)


def _same_frame(tf, jf, rtol=0.0, exact=()):
    """Names, types, domains, codes and string cells equal; numeric
    columns bitwise, or within ``rtol`` of the largest |value| except the
    ``exact`` ones."""
    assert tf.names == jf.names and tf.nrows == jf.nrows
    for n in tf.names:
        tv, jv = tf.vec(n), jf.vec(n)
        assert tv.type == jv.type, n
        if tv.type == "cat":
            assert list(tv.domain) == list(jv.domain), n
            np.testing.assert_array_equal(tv.to_numpy(),
                                          np.asarray(jv.to_numpy()), n)
        elif tv.type in ("str", "uuid"):
            assert list(_host(tv)) == list(_host(jv)), n
        else:
            g, w = _host(tv), _host(jv)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), n)
            ok = ~np.isnan(w)
            if n in exact or rtol == 0:
                np.testing.assert_array_equal(g[ok], w[ok], n)
            elif ok.any():
                assert np.abs(g[ok] - w[ok]).max() <= \
                    rtol * max(np.abs(w[ok]).max(), 1e-30), n


# ------------------------------------------------------------- frame.create

_CREATE = dict(rows=300, cols=12, seed=11, categorical_fraction=0.25,
               integer_fraction=0.2, binary_fraction=0.1, time_fraction=0.1,
               string_fraction=0.1, missing_fraction=0.05, factors=7,
               has_response=True, response_factors=3)


def test_create_frame_and_its_kin_bitwise_jax():
    """create_frame (every column type, NAs, a 3-class response),
    insert_missing_values, interaction (pairwise and over the tuple) and
    tabulate are bitwise the JAX package's on the same seed; the DCT
    within 1e-5 of the largest |value|."""
    jf = jcreate.create_frame(**_CREATE)
    tf = pcreate.create_frame(device="cpu", **_CREATE)
    _same_frame(tf, jf)
    _same_frame(pcreate.insert_missing_values(tf, 0.2, seed=3),
                jcreate.insert_missing_values(jf, 0.2, seed=3))
    cats = [n for n in tf.names if tf.vec(n).type == "cat"][:3]
    for pw in (False, True):
        _same_frame(pcreate.interaction(tf, cats, pairwise=pw,
                                        max_factors=10),
                    jcreate.interaction(jf, cats, pairwise=pw,
                                        max_factors=10))
    nums = [n for n in tf.names if tf.vec(n).type == "num"]
    assert pcreate.tabulate(tf, nums[0], "response", nbins_predictor=5) \
        == jcreate.tabulate(jf, nums[0], "response", nbins_predictor=5)
    cols = {f"p{j}": np.random.default_rng(j).normal(size=40)
            for j in range(6)}
    jd = jcreate.dct_transform(JFrame.from_numpy(cols), [2, 3, 1])
    td = pcreate.dct_transform(Frame.from_numpy(cols, device="cpu"),
                               [2, 3, 1])
    _same_frame(td, jd, rtol=1e-5)


# ---------------------------------------------------------- the Frame verbs

def _verb_columns(n=640, seed=23):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 5, n).astype(np.int32)
    k[rng.random(n) < 0.05] = -1
    x = rng.normal(3.0, 2.0, n)
    x[rng.random(n) < 0.05] = np.nan
    return {"k": k, "g": rng.integers(0, 3, n).astype(np.float64),
            "x": x, "z": rng.uniform(-1, 1, n)}


@pytest.fixture(scope="module")
def verb_frames():
    cols = _verb_columns()
    kw = dict(types={"k": "cat"}, domains={"k": list("abcde")})
    return JFrame.from_numpy(cols, **kw), \
        Frame.from_numpy(cols, device="cpu", **kw)


@pytest.mark.parametrize("verb", ["sort", "merge", "group_by", "impute",
                                  "scale", "cor", "var", "matrix",
                                  "to_pandas"])
def test_frame_verbs_match_jax(verb_frames, verb):
    """Each verb of the port's Frame gives the JAX package's Frame verb's
    result (and delegates to ``rapids.ops``)."""
    jf, tf = verb_frames
    if verb == "sort":
        _same_frame(tf.sort(["k", "x"], ascending=[False, True]),
                    jf.sort(["k", "x"], ascending=[False, True]))
    elif verb == "merge":
        rc = {"k": np.array(["b", "a", "q"], object),
              "w": np.array([1.0, 2.0, 3.0])}
        _same_frame(tf.merge(Frame.from_numpy(rc, device="cpu"), "k",
                             how="left"),
                    jf.merge(JFrame.from_numpy(rc), "k", how="left"))
    elif verb == "group_by":
        aggs = {"x": ["count", "mean", "sd"], "z": ["sum", "max"]}
        _same_frame(tf.group_by(["k", "g"], aggs),
                    jf.group_by(["k", "g"], aggs), rtol=_RTOL,
                    exact={"k", "g", "count_x", "max_z"})
    elif verb == "impute":
        _same_frame(tf.impute("x", method="median"),
                    jf.impute("x", method="median"))
    elif verb == "scale":
        _same_frame(tf.scale(), jf.scale(), rtol=_RTOL)
    elif verb in ("cor", "var"):
        got = getattr(tf, verb)(["g", "x", "z"])
        want = getattr(jf, verb)(["g", "x", "z"])
        assert got["columns"] == want["columns"]
        np.testing.assert_allclose(got["matrix"], want["matrix"],
                                   rtol=0, atol=_RTOL * np.abs(
                                       want["matrix"]).max())
    elif verb == "matrix":
        got = tf.matrix(["k", "x"])
        assert got is tf.matrix(["k", "x"])           # cached per set
        np.testing.assert_array_equal(
            got[: tf.nrows].numpy(),
            np.asarray(jf.matrix(["k", "x"]))[: jf.nrows])
    else:
        got, want = tf.to_pandas(), jf.to_pandas()
        assert list(got.columns) == list(want.columns)
        for c in got.columns:
            assert [str(x) for x in got[c]] == [str(x) for x in want[c]]


# ------------------------------------------------------------ train_segments

def _segment_columns(n=1200, seed=31):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    seg = rng.integers(0, 4, n).astype(np.int32)
    seg[rng.random(n) < 0.03] = -1
    side = rng.integers(0, 2, n).astype(np.int32)
    side[(seg == 3) & (rng.random(n) < 0.9)] = 1     # a tiny (3, 0) segment
    y = (X[:, 0] + 0.5 * seg - X[:, 1] * side
         + rng.normal(size=n) > 0.6).astype(np.int32)
    return {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "seg": seg,
            "side": side, "y": y}


_SEG_KW = dict(types={"seg": "cat", "side": "cat", "y": "cat"},
               domains={"seg": ["n", "e", "s", "w"], "side": ["l", "r"],
                        "y": ["no", "yes"]})


class _Stub:
    """A builder that records the rows it is given, refuses segments of
    under 30 rows, and returns a model carrying a key made from the call
    count (the same in both packages)."""

    calls = 0

    def train(self, frame, valid=None):
        _Stub.calls += 1
        if frame.nrows < 30:
            raise ValueError(f"{frame.nrows} rows")
        return types.SimpleNamespace(key=f"stub_{_Stub.calls}_{frame.nrows}")


def _table(sm):
    return [(r.segment, r.model_key, r.status, r.error, r.nrows)
            for r in sm.results]


def test_train_segments_table_matches_jax_and_models_their_trains():
    """Over one stub builder both packages find the same segments (the
    device group-by's order; NA keys dropped), give each the same rows,
    and fail the same tiny segment with the same error; ``segments=``
    restricts to listed tuples.  With XGBoost every segment's model is
    bitwise the port's own train on that segment's rows."""
    cols = _segment_columns()
    jf = JFrame.from_numpy(cols, **_SEG_KW)
    tf = Frame.from_numpy(cols, device="cpu", **_SEG_KW)
    by = ["seg", "side"]
    _Stub.calls = 0
    want = jsegments.train_segments(_Stub, jf, by)
    _Stub.calls = 0
    got = train_segments(_Stub, tf, by)
    assert _table(got) == _table(want)
    assert [r.status for r in got.results].count("FAILED") == 1
    _same_frame(got.as_frame(), want.as_frame())
    pick = {"seg": np.array(["e", "w"], object),
            "side": np.array(["r", "l"], object)}
    _Stub.calls = 0
    want = jsegments.train_segments(_Stub, jf, by,
                                    segments=JFrame.from_numpy(pick))
    _Stub.calls = 0
    got = train_segments(_Stub, tf, by,
                         segments=Frame.from_numpy(pick, device="cpu"))
    assert _table(got) == _table(want) and len(got.results) == 2

    kw = dict(response_column="y", ntrees=3, max_depth=3, seed=5,
              device="cpu")
    sm = train_segments(lambda: XGBoost(**kw), tf, "seg")
    assert [r.status for r in sm.results] == ["SUCCEEDED"] * 4
    codes = tf.vec("seg").to_numpy()
    for i, r in enumerate(sm.results):
        sub = pops.filter_rows(tf, codes == i).drop(["seg"])
        own = XGBoost(**kw).train(sub)
        m = sm.model(seg=r.segment["seg"])
        assert r.nrows == sub.nrows
        a, b = m.output["stacked"], own.output["stacked"]
        assert torch.equal(a.values, b.values)
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)


# ------------------------------------------------------------------ Infogram

def _infogram_columns(n=1024, seed=41):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    c = rng.integers(0, 3, n).astype(np.int32)
    logit = 1.5 * X[:, 0] - 1.0 * X[:, 1] + 0.8 * (c == 1)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return {"x0": X[:, 0], "x1": X[:, 1], "c": c, "y": y}


@pytest.mark.parametrize("protected", [None, ["x1"]])
def test_infogram_matches_jax(protected):
    """Core (no protected columns) and fair infograms over GBM: the same
    features in the same order, the same admissible set, relevance and
    CMI within 1e-5 of the JAX package's."""
    cols = _infogram_columns()
    kw = dict(types={"c": "cat", "y": "cat"},
              domains={"c": ["p", "q", "r"], "y": ["no", "yes"]})
    params = dict(response_column="y", seed=2, protected_columns=protected,
                  infogram_algorithm_params={"ntrees": 3, "max_depth": 2})
    jm = JInfogram(**params).train(JFrame.from_numpy(cols, **kw))
    tm = Infogram(device="cpu", **params).train(
        Frame.from_numpy(cols, device="cpu", **kw))
    jrows, trows = jm.output["admissible_score"], tm.output["admissible_score"]
    assert [r["column"] for r in trows] == [r["column"] for r in jrows]
    assert tm.admissible_features == jm.admissible_features
    for a, b in zip(trows, jrows):
        for k in ("relevance", "cmi", "cmi_raw", "admissible_index"):
            assert abs(a[k] - b[k]) <= 1e-5, (a["column"], k)
    assert tm.output["nmodels_trained"] == jm.output["nmodels_trained"]
    with pytest.raises(NotImplementedError):
        tm.predict(None)


# ---------------------------------------------------------------------- Grep

def test_grep_matches_jax(tmp_path):
    """Over a directory of a text file and a gzipped one, the match
    table (file, byte offset, match) is bitwise the JAX package's, and
    the Grep builder keeps it under its key."""
    rng = np.random.default_rng(9)
    lines = [f"{rng.integers(0, 99)}x,{'ab' * int(rng.integers(1, 4))}"
             f",{rng.normal():.3f}\n" for _ in range(300)]
    (tmp_path / "a.csv").write_text("".join(lines[:150]))
    with gzip.open(tmp_path / "b.csv.gz", "wt") as f:
        f.write("".join(lines[150:]))
    for regex in (r"[0-9]+x", r"(ab)+,-"):
        got = grep(str(tmp_path), regex, device="cpu")
        want = jgrep(str(tmp_path), regex)
        assert got.nrows == want.nrows > 0
        _same_frame(got, want)
    m = Grep(regex=r"[0-9]+x", device="cpu").train_on_path(str(tmp_path))
    assert m.output["n_matches"] == m.result().nrows > 0
    with pytest.raises(ValueError, match="regex"):
        Grep(device="cpu").train_on_path(str(tmp_path))


# ------------------------------------------------------- concurrent waves

def _grid_frame():
    cols = _infogram_columns(800, seed=43)
    return Frame.from_numpy(cols, device="cpu",
                            types={"c": "cat", "y": "cat"},
                            domains={"c": ["p", "q", "r"],
                                     "y": ["no", "yes"]})


def test_parallel_waves_bitwise_sequential_members():
    """``GridSearch(parallelism=2)`` on the wave path trains every member
    bitwise its ``parallelism=1`` twin (trees and training metrics), the
    entries in the same order; a wave may overshoot ``max_models`` by no
    member; the scan program is refused under concurrent waves."""
    fr = _grid_frame()
    hp = {"learn_rate": [0.1, 0.3], "max_depth": [2, 3]}
    base = dict(response_column="y", ntrees=3, seed=7, sample_rate=0.8,
                grid_batch="off", device="cpu")
    g1 = GridSearch(GBM, hp, parallelism=1, **base).train(fr)
    g2 = GridSearch(GBM, hp, parallelism=2, **base).train(fr)
    assert g1.entries == g2.entries and len(g2.models) == 4
    for a, b in zip(g1.models, g2.models):
        sa, sb = a.output["stacked"], b.output["stacked"]
        assert torch.equal(sa.values, sb.values)
        for la, lb in zip(sa.levels, sb.levels):
            for x, y in zip(la, lb):
                assert torch.equal(x, y)
        assert a.training_metrics.auc == b.training_metrics.auc
    g3 = GridSearch(GBM, hp, parallelism=3,
                    search_criteria={"strategy": "Cartesian",
                                     "max_models": 2}, **base).train(fr)
    assert len(g3.models) == 2
    with pytest.raises(ValueError, match="scan"):
        GridSearch(GBM, hp, parallelism=2, tree_program="scan", **base)
    with pytest.raises(ValueError, match="parallelism"):
        GridSearch(GBM, hp, parallelism=-1, **base)


def test_map_builds_deadline_and_effective_parallelism():
    """map_builds keeps input order, arms the deadline in each worker
    thread (cleared after), and re-raises a thunk's error; a deadline
    already past fails a wave member at its first chunk fence;
    effective_parallelism builds 0 and 1 one at a time and clamps n to
    the tasks."""
    seen = []

    def thunk(i):
        def run():
            time.sleep(0.01 * (3 - i))
            seen.append(parallel.get_deadline())
            return i
        return run

    assert parallel.map_builds([thunk(i) for i in range(3)], 3,
                               deadline=123.0) == [0, 1, 2]
    assert seen == [123.0] * 3 and parallel.get_deadline() is None
    with pytest.raises(RuntimeError, match="boom"):
        parallel.map_builds([lambda: (_ for _ in ()).throw(
            RuntimeError("boom"))], 2)
    assert parallel.effective_parallelism(1, 5) == 1
    assert parallel.effective_parallelism(4, 2) == 2
    assert parallel.effective_parallelism(0, 1) == 1
    assert parallel.effective_parallelism(0, 8) == 1
    assert parallel.effective_parallelism(3, 8) == 3
    fr = _grid_frame()
    with pytest.raises(parallel.DeadlineExceeded):
        parallel.map_builds(
            [lambda: GBM(response_column="y", ntrees=2,
                         device="cpu").train(fr)], 1,
            deadline=time.monotonic() - 1.0)


def test_map_builds_stress_threads_keep_their_deadlines_and_counts():
    """More build threads than cores, the interpreter switching threads
    every microsecond: each thread sees only its own deadline (armed by a
    nested ``map_builds``), and a kernel's launch count loses no update
    under concurrent ``count()`` calls."""
    import sys
    from h2o3_tpu_torch import native
    k = native.Kernel("stress", {})

    def member(i):
        def inner():
            ok = True
            for _ in range(200):
                ok &= parallel.get_deadline() == float(i)
                k.count()
            return ok
        return lambda: parallel.map_builds([inner], 1, deadline=float(i))[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seen = parallel.map_builds([member(i) for i in range(32)], 16)
    finally:
        sys.setswitchinterval(old)
    assert seen == [True] * 32
    assert k.launches == 32 * 200
    assert parallel.get_deadline() is None
