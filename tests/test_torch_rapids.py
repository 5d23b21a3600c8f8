"""h2o3_tpu_torch's data plane (``rapids``: device sort, group-by, merge,
the munging and string verbs, the Rapids expression language and its
primitives, the lazy client DAG) held against the JAX package's on the
CPU.

The same numpy columns from one seed (1,000 rows: a numeric key with NAs,
a categorical with NAs, a float value column with NAs, a time column in
ms since the epoch with NAs and a string column with missing cells) go
through ``h2o3_tpu.rapids`` and ``h2o3_tpu_torch.rapids``.

Tolerances.  Sort orders, dense ranks, group keys, counts, min and max,
merge row sets, every categorical code and domain, string results, the
time fields and the numpy draws (``h2o.runif``, the fold columns, the
stratified split) bitwise.  Group sums, means, variances and standard
deviations: within 1e-6 of the column's largest |value| (the JAX package
sums in f32 in row order, the port in f64 over the rows sorted by group).
``var``/``cor``/``scale`` and elementwise math (the two packages' libm
differ in the last ulp): rtol 1e-6 against the largest |value|.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame as JFrame
from h2o3_tpu import Vec as JVec
from h2o3_tpu import rapids as jrapids
from h2o3_tpu.rapids import ast as jast
from h2o3_tpu.rapids import device as jdev
from h2o3_tpu.rapids import ops as jops
from h2o3_tpu.rapids import strings as jstr
from h2o3_tpu.runtime import dkv as jdkv

from h2o3_tpu_torch import rapids as prapids
from h2o3_tpu_torch.frame import Frame, Vec
from h2o3_tpu_torch.rapids import ast as past
from h2o3_tpu_torch.rapids import device as pdev
from h2o3_tpu_torch.rapids import ops as pops
from h2o3_tpu_torch.rapids import strings as pstr
from h2o3_tpu_torch.runtime import dkv as pdkv

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N = 1000
_TYPES = {"b": "cat", "t": "time", "s": "str"}
_DOMAINS = {"b": ["lo", "mid", "hi", "top"]}
_RTOL = 1e-6


def _columns(n=N, seed=17):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, n).astype(np.float64)
    a[rng.random(n) < 0.04] = np.nan
    b = rng.integers(0, 4, n).astype(np.int32)
    b[rng.random(n) < 0.05] = -1
    v = rng.normal(40.0, 12.0, n)
    v[rng.random(n) < 0.05] = np.nan
    t = 1.6e12 + rng.integers(0, 60, n) * 3.6e6 + rng.integers(0, 999, n)
    t[rng.random(n) < 0.03] = np.nan
    s = np.array([f" w{k}x{k % 3} " for k in rng.integers(0, 30, n)], object)
    s[rng.random(n) < 0.05] = None
    return {"a": a, "b": b, "v": v, "t": t, "s": s}


def _both(cols, key=None, types=_TYPES, domains=_DOMAINS):
    """(JAX frame, port frame) of the same columns, under ``key`` in each
    package's store when given."""
    return (JFrame.from_numpy(cols, key=key, types=types, domains=domains),
            Frame.from_numpy(cols, key=key, types=types, domains=domains,
                             device="cpu"))


@pytest.fixture(scope="module")
def frames():
    _both(_right_cols(), key="rright", types={}, domains={})
    return _both(_columns(), key="rfr")


def _host(v):
    if v.type == "cat":
        return np.asarray(v.decoded(), object)
    if v.type == "str":
        return np.asarray(v.to_numpy(), object)
    return np.asarray(v.to_numpy(), np.float64)


def _close(got, want, rtol=_RTOL):
    """Equal NaN positions; the values within ``rtol`` of the largest
    |value| (bitwise where rtol is 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return
    if rtol == 0:
        np.testing.assert_array_equal(got[ok], want[ok])
        return
    scale = max(float(np.abs(want[ok]).max()), 1e-30)
    assert float(np.abs(got[ok] - want[ok]).max()) <= rtol * scale


def _same_frame(tf, jf, rtol=0.0, exact=()):
    """The same names, types, row count, domains and codes; string and
    categorical columns equal; numeric ones bitwise, or within ``rtol``
    of the largest except the ``exact`` columns."""
    assert tf.names == jf.names
    assert tf.nrows == jf.nrows
    for n in tf.names:
        tv, jv = tf.vec(n), jf.vec(n)
        assert tv.type == jv.type, n
        if tv.type == "cat":
            assert list(tv.domain) == list(jv.domain), n
            np.testing.assert_array_equal(tv.to_numpy(),
                                          np.asarray(jv.to_numpy()), n)
        elif tv.type == "str":
            assert list(_host(tv)) == list(_host(jv)), n
        else:
            _close(_host(tv), _host(jv), 0.0 if n in exact else rtol)


# ------------------------------------------------------ device primitives

def test_lex_order_and_dense_rank_bitwise():
    """On the same float32 keys (ties, NaN and +inf among them) the row
    order of every direction pattern and the dense rank equal the JAX
    package's."""
    rng = np.random.default_rng(3)
    n = 777
    k1 = rng.integers(0, 5, n).astype(np.float32)
    k1[rng.random(n) < 0.05] = np.nan
    k2 = rng.normal(size=n).astype(np.float32).round(1)
    k2[rng.random(n) < 0.05] = np.inf
    keys = [k1, k2]
    for asc in ([True, True], [False, True], [True, False], [False, False]):
        want = np.asarray(jdev.lex_order([np.asarray(k) for k in keys], asc))
        got = pdev.lex_order([torch.from_numpy(k) for k in keys], asc)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jdev.dense_rank([np.asarray(k) for k in keys]))
    got = pdev.dense_rank([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_starts_bitwise():
    """The ragged expansion's owner map (counts of 0 own nothing) equals
    the JAX package's."""
    counts = np.array([2, 0, 3, 1, 0, 0, 4], np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    want = np.asarray(jdev.expand_starts(np.asarray(starts),
                                         np.asarray(counts), 16))
    got = pdev.expand_starts(torch.from_numpy(starts.astype(np.int64)),
                             torch.from_numpy(counts.astype(np.int64)), 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sums_fixed_order_equal_grouped_sums():
    """``segment_sums`` over the rows sorted by group equals a float64
    per-group sum, and two calls agree bitwise."""
    rng = np.random.default_rng(5)
    gid = rng.integers(0, 40, 5000)
    x = rng.normal(size=5000)
    order = np.argsort(gid, kind="stable")
    lengths = torch.from_numpy(np.bincount(gid, minlength=41))
    xs = torch.from_numpy(x[order])
    a = pdev.segment_sums(xs, lengths)
    b = pdev.segment_sums(xs, lengths)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), np.bincount(gid, x, minlength=41),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------- sort

@pytest.mark.parametrize("by,asc", [("v", True), (["b", "a"], [True, False]),
                                    (["a", "t"], [False, True]),
                                    (["t"], False)])
def test_sort_matches_jax(frames, by, asc):
    """Every column of the sorted frame (string and time columns gathered
    on the host) bitwise the JAX package's."""
    jf, tf = frames
    _same_frame(pops.sort(tf, by, ascending=asc),
                jops.sort(jf, by, ascending=asc))


# --------------------------------------------------------------- group-by

_GB = [(["b"], {"v": ["count", "sum", "mean", "min", "max", "var", "sd"]}),
       (["a", "b"], {"v": ["count", "sum", "mean", "sd"],
                     "t": ["min", "max"]}),
       (["t"], {"v": ["mean", "var"], "a": ["sum", "count"]})]


@pytest.mark.parametrize("by,aggs", _GB)
def test_group_by_matches_jax(frames, by, aggs):
    """The group keys, their order, codes and domains, counts, min and max
    bitwise the JAX package's; sums, means, variances and standard
    deviations within 1e-6 of the column's largest |value|; NA-key rows
    dropped in both."""
    jf, tf = frames
    got, want = pops.group_by(tf, by, aggs), jops.group_by(jf, by, aggs)
    exact = set(by) | {f"{fn}_{c}" for c, fns in aggs.items() for fn in fns
                       if fn in ("count", "min", "max")}
    assert got.nrows > 1
    _same_frame(got, want, rtol=_RTOL, exact=exact)


def test_group_by_bitwise_run_to_run_and_all_na(frames):
    """Two group-bys agree bitwise; a frame whose key is all NA gives an
    empty result in both packages."""
    _, tf = frames
    aggs = {"v": ["sum", "var"]}
    _same_frame(pops.group_by(tf, ["b"], aggs),
                pops.group_by(tf, ["b"], aggs))
    cols = {"k": np.full(20, np.nan), "x": np.arange(20.0)}
    jf, pf = _both(cols, types={}, domains={})
    assert pops.group_by(pf, "k", {"x": ["sum"]}).nrows == \
        jops.group_by(jf, "k", {"x": ["sum"]}).nrows == 0


# ------------------------------------------------------------------ merge

def _right_cols():
    # "top" missing, "zz" extra, and a duplicated "hi" (row expansion)
    return {"b": np.array(["hi", "lo", "zz", "mid", "hi", None], object),
            "a": np.array([1.0, 2.0, 3.0, np.nan, 4.0, 0.0]),
            "r": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0])}


def test_merge_matches_jax(frames):
    """Inner, left, right and outer joins on one and two keys (a
    categorical with different domains on each side, a numeric with
    NAs), and the Rapids ``merge`` op: the same rows in the same order,
    every column bitwise.  One test: the JAX package's eager merge
    compiles for ~20 s in each worker that runs one."""
    jf, tf = frames
    for by, how in ((["b"], "inner"), (["b"], "right"), (["b", "a"], "left"),
                    (["b", "a"], "outer")):
        rc = _right_cols()
        if by == ["b"]:
            rc = {k: v for k, v in rc.items() if k != "a"}
        jr, tr = _both(rc, types={}, domains={})
        _same_frame(pops.merge(tf, tr, by, how=how),
                    jops.merge(jf, jr, by, how=how))
    _same_frame(*_run("(merge rfr rright 1 ['b' 'a'])"))


# ---------------------------------------------------------- the other verbs

def test_filter_rbind_cbind_unique_table_hist(frames):
    """filter_rows by a Vec mask and by a host mask, rbind with unified
    domains, cbind's renames, unique, table (with weights too), hist and
    ifelse, all equal to the JAX package's (bitwise)."""
    jf, tf = frames
    jm = JVec((jf.vec("v").data > 40).astype(np.float32), "num", jf.nrows)
    tm = Vec((tf.vec("v").data > 40).float(), "num", tf.nrows)
    _same_frame(pops.filter_rows(tf, tm), jops.filter_rows(jf, jm))
    host = np.asarray(_columns()["a"] > 2)
    _same_frame(pops.filter_rows(tf, host), jops.filter_rows(jf, host))
    other = {"a": np.array([9.0]), "b": np.array([2], np.int32),
             "v": np.array([1.5]), "t": np.array([1.7e12]),
             "s": np.array(["q"], object)}
    jo, to = _both(other, domains={"b": ["top", "new", "lo"]})
    _same_frame(pops.rbind(tf, to), jops.rbind(jf, jo))
    assert pops.cbind(tf, tf).names == jops.cbind(jf, jf).names
    for c in ("a", "b", "t"):
        assert list(pops.unique(tf.vec(c))) == \
            list(jops.unique(jf.vec(c)))
    assert pops.table(tf.vec("b")) == jops.table(jf.vec("b"))
    # weighted: the JAX package sums the weights in f32, the port in f64
    jw, tw = jops.impute(jf, "a").vec("a"), pops.impute(tf, "a").vec("a")
    got, want = pops.table(tf.vec("b"), tw), jops.table(jf.vec("b"), jw)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    assert pops.table(tf.vec("a")) == jops.table(jf.vec("a"))
    (gc, ge), (wc, we) = pops.hist(tf.vec("v"), 12), \
        jops.hist(jf.vec("v"), 12)
    np.testing.assert_array_equal(gc, np.asarray(wc))
    np.testing.assert_array_equal(ge, we)
    yes = pops.ifelse(tf.vec("b"), tf.vec("v"), -1.0)
    jyes = jops.ifelse(jf.vec("b"), jf.vec("v"), -1.0)
    _close(yes.to_numpy(), np.asarray(jyes.to_numpy()), 0.0)


def test_cut_interaction_impute(frames):
    """cut (right- and left-closed, include_lowest, labels), interaction
    (pairwise and over the tuple), and impute by mean, median, mode and
    on a time column equal the JAX package's."""
    jf, tf = frames
    for kw in ({}, {"right": False}, {"include_lowest": True},
               {"labels": ["x", "y", "z"]}):
        g = pops.cut(tf.vec("v"), [10.0, 30.0, 45.0, 80.0], **kw)
        w = jops.cut(jf.vec("v"), [10.0, 30.0, 45.0, 80.0], **kw)
        assert g.domain == w.domain
        np.testing.assert_array_equal(g.to_numpy(), np.asarray(w.to_numpy()))
    cols = dict(_columns(300), c=np.random.default_rng(1).integers(
        0, 3, 300).astype(np.int32))
    types = dict(_TYPES, c="cat")
    domains = dict(_DOMAINS, c=["p", "q", "r"])
    jx, tx = _both(cols, types=types, domains=domains)
    for pw in (True, False):
        _same_frame(pops.interaction(tx, ["b", "c"], pairwise=pw,
                                     max_factors=5),
                    jops.interaction(jx, ["b", "c"], pairwise=pw,
                                     max_factors=5))
    for col, method in (("v", "mean"), ("v", "median"), ("b", "mode"),
                        ("t", "median"), ("t", "mean")):
        _same_frame(pops.impute(tf, col, method=method),
                    jops.impute(jf, col, method=method), rtol=_RTOL)


@pytest.mark.parametrize("use", ["complete.obs", "everything"])
def test_scale_var_cor_match_jax(frames, use):
    """scale, and the covariance and correlation matrices (complete.obs
    and everything) within 1e-6 of the largest |value|."""
    jf, tf = frames
    _same_frame(pops.scale(tf), jops.scale(jf), rtol=_RTOL)
    for fn, jfn in ((pops.var, jops.var), (pops.cor, jops.cor)):
        got = fn(tf, ["a", "b", "v"], use=use)
        want = jfn(jf, ["a", "b", "v"], use=use)
        assert got["columns"] == want["columns"]
        _close(got["matrix"], want["matrix"])


# ------------------------------------------------------------------ strings

@pytest.mark.parametrize("fn,args", [
    ("toupper", ()), ("tolower", ()), ("trim", ()), ("lstrip", ()),
    ("rstrip", (" x0",)), ("substring", (1, 3)), ("sub", ("w", "W")),
    ("gsub", ("[0-9]", "#")), ("nchar", ()), ("countmatches", ("[wx]",)),
    ("strsplit", ("x",))])
def test_string_verbs_match_jax(fn, args):
    """Each string verb on a categorical column (its domain transformed,
    codes remapped where labels collide) and on a string column equals
    the JAX package's."""
    cols = _columns(200)
    cols["bs"] = np.where(cols["s"] == None, None,          # noqa: E711
                          cols["s"]).astype(object)
    types = dict(_TYPES, bs="cat")
    jf, tf = _both(cols, types=types, domains=_DOMAINS)
    for col in ("bs", "s"):
        kw = {"device": "cpu"} if fn in ("nchar", "countmatches") else {}
        got = getattr(pstr, fn)(tf.vec(col), *args, **kw)
        want = getattr(jstr, fn)(jf.vec(col), *args)
        if fn == "strsplit":
            _same_frame(got, want)
            continue
        assert got.type == want.type
        if got.type == "cat":
            assert got.domain == want.domain
        _close(_host(got), _host(want), 0.0) if got.type == "num" else \
            np.testing.assert_array_equal(_host(got), _host(want))


# --------------------------------------------------------- the AST language

def _run(text):
    """The expression through both packages' ``rapids``."""
    return prapids.rapids(text, device="cpu"), jrapids.rapids(text)


def _same_result(got, want, rtol=_RTOL):
    if isinstance(want, (int, float)):
        assert isinstance(got, float)
        _close([got], [want], rtol)
    elif isinstance(want, list):
        _close(got, want, rtol)
    else:
        _same_frame(got, want, rtol=rtol)


@pytest.mark.parametrize("text", [
    "(GB rfr ['b'] mean 'v' 'all' nrow 'v' 'all' max 'a' 'all')",
    "(cols rfr ['v' 'a'])",
    "(cols_py rfr [0 1])",
    "(rows rfr (> (cols rfr 'v') 40))",
    "(sort rfr ['b' 'v'] [1 0])",
    "(+ (cols rfr 'v') (* 2 (cols rfr 'a')))",
    "(log (cols rfr 'v'))",
    "(sum (cols rfr ['v' 'a']))",
    "(sd (cols rfr 'v'))",
    "(median (cols rfr 'v'))",
    "(cor (cols rfr ['a' 'v']) 'complete.obs')",
    "(apply (cols rfr ['a' 'v']) 2 {x . (mean x)})",
    "(apply (cols rfr ['a' 'v']) 1 'sum')",
    "(ddply rfr ['b'] {g . (nrow g)})",
    "({x y . (- x y)} (cols rfr 'v') 1)",
    "(ifelse (> (cols rfr 'v') 40) 1 0)",
    "(table (cols rfr 'b'))",
    "(unique (cols rfr 'a'))",
    "(as.factor (cols rfr 'a'))",
    "(colnames= (cols rfr ['a' 'v']) [0 1] ['x' 'y'])",
    "(cut (cols rfr 'v') [0 30 50 100] [] 0 1 3)",
    "(h2o.impute rfr 'v' 'median')",
    "(toupper (cols rfr 's'))",
    "(replaceall '[0-9]' '#' (cols rfr 'b') 0)",
    "(nrow rfr)",
])
def test_ast_expressions_match_jax(frames, text):
    """Each special form and op family of the language (column and row
    selection by name, index and mask, sort, group-by triples (merge:
    ``test_merge_matches_jax``),
    arithmetic, reductions, matrix var/cor, apply over both margins with
    a lambda and a reducer name, ddply, immediate lambda application,
    quoted names, number and string lists) gives the JAX package's
    result."""
    _same_result(*_run(text))


def test_tmp_assign_and_rm_use_each_store(frames):
    """``tmp=`` and ``assign`` put the result under the key in each
    package's store, later expressions read it, ``rm`` removes it."""
    for text in ("(tmp= gbtmp (GB rfr ['b'] sum 'v' 'all'))",
                 "(assign doubled (* (cols rfr ['a' 'v']) 2))"):
        _same_result(*_run(text))
    got, want = pdkv.get("gbtmp"), jdkv.get("gbtmp")
    _same_frame(got, want, rtol=_RTOL, exact={"b"})
    _same_result(*_run("(nrow gbtmp)"))
    _same_result(*_run("(max (cols doubled 'v'))"))
    _run("(rm gbtmp)")
    assert pdkv.get("gbtmp") is None and jdkv.get("gbtmp") is None
    assert past.parse("(f 'a b' [1 2] {x . x})") == \
        jast.parse("(f 'a b' [1 2] {x . x})")


# ---------------------------------------------------------------- the prims

@pytest.mark.parametrize("text,rtol", [
    # math and the special functions
    ("(lgamma (abs (cols rfr 'v')))", 1e-5),
    ("(digamma (abs (cols rfr 'v')))", 1e-5),
    ("(trigamma (abs (cols rfr 'v')))", 1e-5),
    ("(cospi (cols rfr 'a'))", 1e-6),
    ("(signif (cols rfr 'v') 3)", 0.0),
    # reducers and cumulative reducers
    ("(sumNA (cols rfr 'v'))", _RTOL),
    ("(h2o.mad (cols rfr 'v'))", _RTOL),
    ("(naCnt (cols rfr ['a' 'v']))", 0.0),
    ("(cumsum (cols rfr 'a'))", _RTOL),
    ("(sumaxis (cols rfr ['a' 'v']) 1 1)", _RTOL),
    ("(which.max (cols rfr ['a' 'v']) 1 0)", 0.0),
    ("(x (t (na.omit (cols rfr ['a' 'v']))) (na.omit (cols rfr ['a' 'v'])))",
     _RTOL),
    # mungers
    ("(levels (cols rfr 'b'))", 0.0),
    ("(relevel (cols rfr 'b') 'hi')", 0.0),
    ("(na.omit (cols rfr ['a' 'b']))", 0.0),
    ("(rank_within_groupby rfr ['b'] ['v'] [1] 'rk' 0)", 0.0),
    ("(:= rfr 7 ['a'] [0 1 2])", 0.0),
    # strings
    ("(tokenize (cols rfr 's') 'x')", 0.0),
    ("(grep (cols rfr 's') 'w1' 0 0 1)", 0.0),
    ("(entropy (cols rfr 's'))", 0.0),
    ("(strDistance (cols rfr 's') (cols rfr 'b') 'lv' 0)", 0.0),
    # time
    ("(year (cols rfr 't'))", 0.0),
    ("(month (cols rfr 't'))", 0.0),
    ("(hour (cols rfr 't'))", 0.0),
    ("(dayOfWeek (cols rfr 't'))", 0.0),
    ("(mktime 2020 0 5 3 4 5 6)", 0.0),
    # fold columns and draws
    ("(kfold_column rfr 5 7)", 0.0),
    ("(modulo_kfold_column rfr 4)", 0.0),
    ("(stratified_kfold_column (cols rfr 'b') 3 2)", 0.0),
    ("(h2o.runif rfr 42)", 0.0),
    ("(h2o.random_stratified_split (cols rfr 'b') 0.3 9)", 0.0),
    ("(isax (cols rfr ['a' 'v' 'b']) 2 4)", 0.0),
])
def test_prims_match_jax(frames, text, rtol):
    """One case per family of primitive: math and the special functions
    (torch.special against jax.scipy.special, 1e-5), reducers, matrix
    products, mungers, strings, time fields, fold columns and the numpy
    draws (bitwise)."""
    _same_result(*_run(text), rtol=rtol)


def test_lazy_frame_matches_jax(frames):
    """The lazy DAG builds the same Rapids text in both packages and
    evaluates to the same frames and scalars."""
    from h2o3_tpu_torch.rapids.expr import LocalBackend
    lp, lj = prapids.lazy("rfr", LocalBackend("cpu")), jrapids.lazy("rfr")
    gp = lp.group_by("b", v=["mean", "sum"]).sort("b")
    gj = lj.group_by("b", v=["mean", "sum"]).sort("b")
    assert gp.ast() == gj.ast()
    _same_frame(gp.frame(), gj.frame(), rtol=_RTOL, exact={"b"})
    assert abs(lp["v"].sum() - lj["v"].sum()) <= _RTOL * abs(lj["v"].sum())
    assert lp.nrow() == lj.nrow() == N
    _same_frame(lp[lp["v"] > 45].frame(), lj[lj["v"] > 45].frame())
