"""Rapids primitive registry: the breadth tier of the expression language
— the port of ``h2o3_tpu/rapids/prims.py``.

Reference: the ``Ast*`` classes under
``water/rapids/ast/prims/{math,reducers,mungers,operators,advmath,matrix,
search,repeaters,string,time,timeseries,assign,misc}``; op tokens match
each class's ``str()`` exactly (e.g. ``AstMktime.str() == "mktime"``,
month/day arguments 0-based per ``AstMktime.java:55-56``).

Each handler receives ``(sess, args)`` with UNevaluated AST nodes and
evaluates what it needs via ``sess._ev``; lambda values (``ast.Lambda``)
pass through unevaluated.  Dense numeric work (distance, mmult, the
cumulative reducers, the special functions through ``torch.special``)
runs on the frames' device; string, time and reshape prims run on the
host like the reference's per-chunk Java loops.  The draws (``h2o.runif``,
``h2o.random_stratified_split``, the fold columns) are numpy's, in the
JAX package's order, so a seed gives its columns bit for bit.
"""

from __future__ import annotations

import math
import re
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, T_STR, T_TIME, Vec
from ..runtime import dkv
from .ast import _binop, nan_reduce

PRIMS = {}


def prim(name):
    def deco(fn):
        PRIMS[name] = fn
        return fn
    return deco


# ------------------------------------------------------------------ helpers
def _fr(x, name="x") -> Frame:
    return Frame([name], [x]) if isinstance(x, Vec) else x


def _mat(fr: Frame) -> torch.Tensor:
    """[padded, C] numeric view (cats as codes)."""
    return torch.stack([v.numeric_data() for v in fr.vecs], dim=1)


def _hostmat(fr: Frame) -> np.ndarray:
    """The numeric view on the host, float64, live rows only."""
    return _mat(fr).cpu().numpy().astype(np.float64)[: fr.nrows]


def _num_frame(arr: torch.Tensor, names, nrows) -> Frame:
    arr = torch.atleast_2d(arr)
    return Frame(list(names)[: arr.shape[1]],
                 [Vec(arr[:, j].to(torch.float32).contiguous(), T_NUM, nrows)
                  for j in range(arr.shape[1])])


def _np_frame(sess, cols: dict, fr=None) -> Frame:
    """A frame from host columns on ``fr``'s device (the session's for a
    result made from no frame)."""
    return Frame.from_numpy(cols, device=sess.dev(fr) if fr is not None
                            else sess.device)


# ------------------------------------------------------------------ math
def _gamma(x):
    # |Gamma(x)| = exp(gammaln(x)); for x < 0 the sign alternates per unit
    # interval: negative exactly when floor(x) is odd
    odd_floor = torch.remainder(torch.floor(x), 2.0) != 0.0
    sign = torch.where((x < 0) & odd_floor, -1.0, 1.0)
    return sign * torch.exp(torch.special.gammaln(x))


_EXTRA_UNARY = {
    "acosh": torch.acosh, "asinh": torch.asinh, "atanh": torch.atanh,
    "cospi": lambda x: torch.cos(math.pi * x),
    "sinpi": lambda x: torch.sin(math.pi * x),
    "tanpi": lambda x: torch.tan(math.pi * x),
    "none": lambda x: x,
    "gamma": _gamma,
    "lgamma": torch.special.gammaln,
    "digamma": torch.special.digamma,
    "trigamma": lambda x: torch.special.polygamma(1, x),
}


def _unary_prim(fn):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        return _num_frame(fn(_mat(fr)), fr.names, fr.nrows)
    return h


for _name, _fn in _EXTRA_UNARY.items():
    PRIMS[_name] = _unary_prim(_fn)


@prim("signif")
def _signif(sess, args):
    fr = _fr(sess._ev(args[0]))
    digits = int(sess._ev(args[1])) if len(args) > 1 else 6
    X = _mat(fr).cpu().numpy().astype(np.float64)

    def sig(v):
        with np.errstate(divide="ignore", invalid="ignore"):
            mag = np.floor(np.log10(np.abs(v)))
        mag = np.where(np.isfinite(mag), mag, 0)
        f = 10.0 ** (digits - 1 - mag)
        return np.round(v * f) / f
    return _num_frame(torch.tensor(sig(X), dtype=torch.float32,
                                   device=sess.dev(fr)), fr.names, fr.nrows)


# ------------------------------------------------------------------ operators
def _logical_scalar(sess, args, op):
    return _binop("&" if op == "&&" else "|", sess._ev(args[0]),
                  sess._ev(args[1]))


PRIMS["&&"] = lambda s, a: _logical_scalar(s, a, "&&")
PRIMS["||"] = lambda s, a: _logical_scalar(s, a, "||")


def _alias(name, target):
    def h(sess, args):
        return _binop(target, sess._ev(args[0]), sess._ev(args[1]))
    PRIMS[name] = h


_alias("%/%", "intDiv")
_alias("%%", "%")


# ------------------------------------------------------------------ reducers
def _red(name, fn):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        return float(fn(_mat(fr)[: fr.nrows]))
    PRIMS[name] = h


_red("all", lambda X: float(bool(
    (torch.nan_to_num(X, nan=1.0) != 0).all())))
_red("any", lambda X: float(bool(
    (torch.nan_to_num(X, nan=0.0) != 0).any())))
_red("any.na", lambda X: float(bool(torch.isnan(X).any())))
_red("naCnt", lambda X: float(torch.isnan(X).sum()))
_red("prod", lambda X: float(torch.prod(X)))
_red("prod.na", lambda X: float(torch.where(torch.isnan(X), 1.0, X).prod()))
_red("sumNA", lambda X: float(nan_reduce("sum", X)))
_red("maxNA", lambda X: float(nan_reduce("max", X)))
_red("minNA", lambda X: float(nan_reduce("min", X)))
_red("h2o.mad", lambda X: float(1.4826 * nan_reduce(
    "median", torch.abs(X - nan_reduce("median", X)))))


def _cum_prim(fn):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        axis = int(sess._ev(args[1])) if len(args) > 1 else 0
        Xp = _mat(fr)
        out = fn(Xp[: fr.nrows], 1 if axis else 0)
        out = F.pad(out, (0, 0, 0, Xp.shape[0] - fr.nrows))
        return _num_frame(out, fr.names, fr.nrows)
    return h


PRIMS["cumsum"] = _cum_prim(lambda X, d: torch.cumsum(X, d))
PRIMS["cumprod"] = _cum_prim(lambda X, d: torch.cumprod(X, d))
PRIMS["cummax"] = _cum_prim(lambda X, d: torch.cummax(X, d).values)
PRIMS["cummin"] = _cum_prim(lambda X, d: torch.cummin(X, d).values)


@prim("sumaxis")
def _sumaxis(sess, args):
    fr = _fr(sess._ev(args[0]))
    na_rm = bool(sess._ev(args[1])) if len(args) > 1 else False
    axis = int(sess._ev(args[2])) if len(args) > 2 else 0
    Xp = _mat(fr)
    X = Xp[: fr.nrows]
    fn = torch.nansum if na_rm else torch.sum
    if axis == 1:                       # row sums -> one column
        out = fn(X, dim=1)
        return _num_frame(F.pad(out, (0, Xp.shape[0] - fr.nrows))[:, None],
                          ["sum"], fr.nrows)
    return _num_frame(fn(X, dim=0)[None, :], fr.names, 1)


@prim("topn")
def _topn(sess, args):
    """(topn frame col nPercent getBottomN) -> [row_idx, value] frame
    (AstTopN: nPercent of rows, 0 = top/bottom 1 row grab)."""
    fr = sess._ev(args[0])
    col = sess._col_names(fr, sess._ev(args[1]))[0]
    npct = float(sess._ev(args[2]))
    bottom = bool(int(sess._ev(args[3]))) if len(args) > 3 else False
    x = np.asarray(fr.vec(col).to_numpy(), np.float64)
    live = np.flatnonzero(~np.isnan(x))
    k = max(1, int(round(npct / 100.0 * len(live))))
    order = np.argsort(x[live])
    pick = live[order[:k]] if bottom else live[order[-k:][::-1]]
    return _np_frame(sess, {"Row Indices": pick.astype(np.float64),
                            col: x[pick]}, fr)


# ------------------------------------------------------------------ matrix
@prim("t")
def _transpose(sess, args):
    fr = _fr(sess._ev(args[0]))
    X = _mat(fr).cpu().numpy()[: fr.nrows].T        # [C, n]
    return _np_frame(sess, {f"c{j}": X[:, j] for j in range(X.shape[1])}
                     or {"c0": np.zeros(0)}, fr)


@prim("x")
def _mmult(sess, args):
    a = _fr(sess._ev(args[0]))
    b = _fr(sess._ev(args[1]))
    Ap = _mat(a)
    out = Ap[: a.nrows] @ _mat(b)[: b.nrows]
    return _num_frame(F.pad(out, (0, 0, 0, Ap.shape[0] - a.nrows)),
                      [f"c{j}" for j in range(out.shape[1])], a.nrows)


# ------------------------------------------------------------------ search
@prim("match")
def _match(sess, args):
    """(match frame table nomatch start_index) — AstMatch."""
    fr = _fr(sess._ev(args[0]))
    table = sess._ev(args[1])
    if not isinstance(table, list):
        table = [table]
    nomatch = sess._ev(args[2]) if len(args) > 2 else float("nan")
    start = int(sess._ev(args[3])) if len(args) > 3 else 1
    vals = fr.vecs[0].to_numpy()
    fill = float(nomatch) if nomatch is not None else np.nan
    out = np.full(len(vals), fill)
    # one lookup over both spellings: numeric table entries match numeric
    # cells, everything else matches by string
    lut = {}
    for i, t in enumerate(table):
        lut[str(t)] = i + start
        if isinstance(t, float) and t.is_integer():
            lut[str(int(t))] = i + start
    for i, x in enumerate(vals[: fr.nrows]):
        if x is None or (isinstance(x, float) and np.isnan(x)):
            continue
        key = str(int(x)) if isinstance(x, float) and x.is_integer() \
            else str(x)
        if key in lut:
            out[i] = lut[key]
    return _np_frame(sess, {"match": out}, fr)


@prim("which")
def _which(sess, args):
    fr = _fr(sess._ev(args[0]))
    x = np.asarray(fr.vecs[0].to_numpy(), np.float64)[: fr.nrows]
    idx = np.flatnonzero(np.nan_to_num(x) != 0).astype(np.float64)
    return _np_frame(sess, {"which": idx}, fr)


def _which_extreme(maximize):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        # na_rm (args[1]) is accepted for API parity; NaNs are always
        # skipped and an all-NaN slice yields NaN (never an exception)
        axis = int(sess._ev(args[2])) if len(args) > 2 else 0
        X = _hostmat(fr)
        f = np.nanargmax if maximize else np.nanargmin
        if axis == 1:
            out = np.array([f(r) if not np.all(np.isnan(r)) else np.nan
                            for r in X], np.float64)
            return _np_frame(sess, {"which.max" if maximize else
                                    "which.min": out}, fr)
        out = np.array([f(X[:, j]) if not np.all(np.isnan(X[:, j]))
                        else np.nan for j in range(X.shape[1])], np.float64)
        return _np_frame(sess, {n: out[j: j + 1]
                                for j, n in enumerate(fr.names)}, fr)
    return h


PRIMS["which.max"] = _which_extreme(True)
PRIMS["which.min"] = _which_extreme(False)


# ------------------------------------------------------------------ repeaters
@prim("rep_len")
def _rep_len(sess, args):
    x = sess._ev(args[0])
    n = int(sess._ev(args[1]))
    if isinstance(x, (Frame, Vec)):
        fr = _fr(x)
        v = np.asarray(fr.vecs[0].to_numpy())[: fr.nrows]
        return _np_frame(sess, {fr.names[0]: np.resize(v, n)}, fr)
    return _np_frame(sess, {"rep_len": np.full(n, float(x))})


@prim("seq")
def _seq(sess, args):
    frm, to = float(sess._ev(args[0])), float(sess._ev(args[1]))
    by = float(sess._ev(args[2])) if len(args) > 2 else \
        (1.0 if to >= frm else -1.0)
    return _np_frame(sess, {"seq": np.arange(frm, to + by * 0.5, by)})


@prim("seq_len")
def _seq_len(sess, args):
    n = int(sess._ev(args[0]))
    return _np_frame(sess, {"seq_len": np.arange(1, n + 1,
                                                 dtype=np.float64)})


# ------------------------------------------------------------------ advmath
@prim("skewness")
def _skewness(sess, args):
    X = _hostmat(_fr(sess._ev(args[0])))
    vals = []
    for j in range(X.shape[1]):
        v = X[:, j]
        v = v[~np.isnan(v)]
        n = len(v)
        s = v.std(ddof=1)
        vals.append(float(n / ((n - 1) * (n - 2))
                          * np.sum(((v - v.mean()) / s) ** 3))
                    if n > 2 and s else np.nan)
    return vals if len(vals) > 1 else vals[0]


@prim("kurtosis")
def _kurtosis(sess, args):
    X = _hostmat(_fr(sess._ev(args[0])))
    vals = []
    for j in range(X.shape[1]):
        v = X[:, j]
        v = v[~np.isnan(v)]
        n = len(v)
        s2 = v.var(ddof=1)
        vals.append(float(np.sum((v - v.mean()) ** 4) / (n * s2 * s2))
                    if n > 1 and s2 else np.nan)
    return vals if len(vals) > 1 else vals[0]


@prim("mode")
def _mode(sess, args):
    fr = _fr(sess._ev(args[0]))
    vals, counts = np.unique(
        fr.vecs[0].numeric_data().cpu().numpy()[: fr.nrows],
        return_counts=True)
    ok = ~np.isnan(vals)
    vals, counts = vals[ok], counts[ok]
    return float(vals[np.argmax(counts)]) if len(vals) else float("nan")


@prim("h2o.runif")
def _runif(sess, args):
    fr = sess._ev(args[0])
    seed = int(sess._ev(args[1])) if len(args) > 1 else -1
    rng = np.random.default_rng(None if seed in (-1,) else seed)
    return _np_frame(sess, {"rnd": rng.random(fr.nrows)}, fr)


@prim("kfold_column")
def _kfold(sess, args):
    fr = sess._ev(args[0])
    nfolds = int(sess._ev(args[1]))
    seed = int(sess._ev(args[2])) if len(args) > 2 else -1
    from ..models.cv import fold_assignment
    folds = fold_assignment(fr.nrows, nfolds, "random",
                            seed if seed != -1 else 0)
    return _np_frame(sess, {"fold": folds.astype(np.float64)}, fr)


@prim("modulo_kfold_column")
def _modulo_kfold(sess, args):
    fr = sess._ev(args[0])
    nfolds = int(sess._ev(args[1]))
    return _np_frame(sess, {"fold": (np.arange(fr.nrows) % nfolds)
                            .astype(np.float64)}, fr)


@prim("stratified_kfold_column")
def _strat_kfold(sess, args):
    fr = _fr(sess._ev(args[0]))
    nfolds = int(sess._ev(args[1]))
    seed = int(sess._ev(args[2])) if len(args) > 2 else -1
    from ..models.cv import fold_assignment
    y = fr.vecs[0].numeric_data().cpu().numpy()[: fr.nrows]
    folds = fold_assignment(fr.nrows, nfolds, "stratified",
                            seed if seed != -1 else 0, y=y)
    return _np_frame(sess, {"fold": folds.astype(np.float64)}, fr)


@prim("h2o.random_stratified_split")
def _strat_split(sess, args):
    fr = _fr(sess._ev(args[0]))
    test_frac = float(sess._ev(args[1]))
    seed = int(sess._ev(args[2])) if len(args) > 2 else -1
    rng = np.random.default_rng(None if seed == -1 else seed)
    y = fr.vecs[0].numeric_data().cpu().numpy()[: fr.nrows]
    out = np.zeros(fr.nrows)
    for cls in np.unique(y[~np.isnan(y)]):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        k = int(round(test_frac * len(idx)))
        out[idx[:k]] = 1.0
    return Frame(["test_train_split"],
                 [Vec.from_numpy(
                     np.where(out > 0, "test", "train").astype(object),
                     T_CAT, domain=["train", "test"], device=sess.dev(fr))])


@prim("distance")
def _distance(sess, args):
    """(distance x y measure) — AstDistance; an [nx, ny] matrix."""
    a = _fr(sess._ev(args[0]))
    b = _fr(sess._ev(args[1]))
    measure = str(sess._ev(args[2])).lower() if len(args) > 2 else "l2"
    A = _mat(a)[: a.nrows]
    B = _mat(b)[: b.nrows]
    if measure in ("cosine", "cosine_sq"):
        An = A / torch.linalg.norm(A, dim=1, keepdim=True).clamp_min(1e-12)
        Bn = B / torch.linalg.norm(B, dim=1, keepdim=True).clamp_min(1e-12)
        D = An @ Bn.T
        if measure == "cosine_sq":
            D = D * D
    elif measure in ("l1",):
        D = torch.abs(A[:, None, :] - B[None, :, :]).sum(-1)
    else:                                           # l2
        a2 = (A * A).sum(1)[:, None]
        b2 = (B * B).sum(1)[None, :]
        D = torch.sqrt((a2 + b2 - 2.0 * (A @ B.T)).clamp_min(0.0))
    D = D.cpu().numpy()
    return _np_frame(sess, {f"C{j + 1}": D[:, j]
                            for j in range(D.shape[1])}, a)


# ------------------------------------------------------------------ mungers
@prim("any.factor")
def _anyfactor(sess, args):
    fr = sess._ev(args[0])
    return float(any(v.type == T_CAT for v in fr.vecs))


def _type_test(types):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        return [float(v.type in types) for v in fr.vecs] \
            if fr.ncols > 1 else float(fr.vecs[0].type in types)
    return h


PRIMS["is.factor"] = _type_test((T_CAT,))
PRIMS["is.numeric"] = _type_test((T_NUM, T_TIME))
PRIMS["is.character"] = _type_test((T_STR,))


@prim("as.character")
def _ascharacter(sess, args):
    fr = _fr(sess._ev(args[0]))
    out = []
    for v in fr.vecs:
        vals = v.to_numpy()
        if v.type in (T_NUM, T_TIME):
            svals = np.asarray(
                ["" if np.isnan(x) else (str(int(x)) if float(x).is_integer()
                                         else str(x)) for x in vals],
                object)
        else:
            svals = np.asarray([("" if x is None else str(x))
                                for x in vals], object)
        out.append(Vec.from_numpy(svals, T_STR))
    return Frame(fr.names, out)


@prim("levels")
def _levels(sess, args):
    fr = _fr(sess._ev(args[0]))
    width = max([v.cardinality for v in fr.vecs if v.type == T_CAT] or [0])
    names, vecs = [], []
    for n, v in zip(fr.names, fr.vecs):
        dom = (v.domain or []) if v.type == T_CAT else []
        names.append(n)
        vecs.append(Vec.from_numpy(
            np.asarray(dom + [""] * (width - len(dom)), object), T_STR))
    return Frame(names, vecs)


@prim("nlevels")
def _nlevels(sess, args):
    v = _fr(sess._ev(args[0])).vecs[0]
    return float(v.cardinality if v.type == T_CAT else 0)


def _cat_frame(sess, fr, vals, domain) -> Frame:
    return Frame(fr.names, [Vec.from_numpy(vals, T_CAT, domain=domain,
                                           device=sess.dev(fr))])


@prim("setLevel")
def _setlevel(sess, args):
    """(setLevel frame level) — every row becomes `level`."""
    fr = _fr(sess._ev(args[0]))
    level = str(sess._ev(args[1]))
    v = fr.vecs[0]
    if v.type != T_CAT or level not in (v.domain or []):
        raise ValueError(f"setLevel: {level!r} not in domain")
    return _cat_frame(sess, fr, np.asarray([level] * fr.nrows, object),
                      v.domain)


@prim("setDomain")
def _setdomain(sess, args):
    fr = _fr(sess._ev(args[0]))
    # (setDomain frame inPlace [levels])
    dom = [str(x) for x in sess._ev(args[-1])]
    codes = fr.vecs[0].numeric_data().cpu().numpy()[: fr.nrows]
    vals = np.asarray([dom[int(c)] if not np.isnan(c) and
                       int(c) < len(dom) else None
                       for c in codes], object)
    return _cat_frame(sess, fr, vals, dom)


@prim("appendLevels")
def _appendlevels(sess, args):
    fr = _fr(sess._ev(args[0]))
    extra = [str(x) for x in sess._ev(args[1])]
    v = fr.vecs[0]
    dom = list(v.domain or []) + [x for x in extra
                                  if x not in (v.domain or [])]
    return _cat_frame(sess, fr, v.to_numpy(), dom)


@prim("relevel")
def _relevel(sess, args):
    """(relevel frame level) — move level to the front of the domain."""
    fr = _fr(sess._ev(args[0]))
    level = str(sess._ev(args[1]))
    v = fr.vecs[0]
    dom = list(v.domain or [])
    if level not in dom:
        raise ValueError(f"relevel: {level!r} not in domain")
    return _cat_frame(sess, fr, v.to_numpy(),
                      [level] + [d for d in dom if d != level])


@prim("relevel.by.freq")
def _relevel_freq(sess, args):
    from collections import Counter
    fr = _fr(sess._ev(args[0]))
    v = fr.vecs[0]
    vals = v.to_numpy()
    counts = Counter(x for x in vals if x is not None)
    dom = [d for d, _ in counts.most_common()]
    dom += [d for d in (v.domain or []) if d not in dom]
    return _cat_frame(sess, fr, vals, dom)


@prim("columnsByType")
def _columns_by_type(sess, args):
    fr = sess._ev(args[0])
    want = str(sess._ev(args[1])).lower() if len(args) > 1 else "numeric"
    sel = {
        "numeric": lambda v: v.type == T_NUM,
        "categorical": lambda v: v.type == T_CAT,
        "string": lambda v: v.type == T_STR,
        "time": lambda v: v.type == T_TIME,
        "bad": lambda v: False,
    }.get(want, lambda v: v.type == T_NUM)
    idx = [float(j) for j, v in enumerate(fr.vecs) if sel(v)]
    return _np_frame(sess, {"columns": np.asarray(idx, np.float64)}, fr)


@prim("na.omit")
def _naomit(sess, args):
    fr = sess._ev(args[0])
    keep = np.ones(fr.nrows, bool)
    for v in fr.vecs:
        x = v.to_numpy()
        if v.type in (T_NUM, T_TIME):
            keep &= ~np.isnan(np.asarray(x, np.float64))
        else:
            keep &= np.asarray([s is not None and s == s for s in x])
    return fr.rows(np.flatnonzero(keep))


@prim("filterNACols")
def _filter_na_cols(sess, args):
    fr = sess._ev(args[0])
    frac = float(sess._ev(args[1])) if len(args) > 1 else 0.1
    keep = [float(j) for j, v in enumerate(fr.vecs)
            if v.rollups().nmissing / max(fr.nrows, 1) < frac]
    return _np_frame(sess, {"columns": np.asarray(keep, np.float64)}, fr)


@prim("h2o.fillna")
def _fillna(sess, args):
    """(h2o.fillna frame method axis maxlen) — forward/backward fill."""
    fr = sess._ev(args[0])
    method = str(sess._ev(args[1])).lower() if len(args) > 1 else "forward"
    axis = int(sess._ev(args[2])) if len(args) > 2 else 0
    maxlen = int(sess._ev(args[3])) if len(args) > 3 else 1

    def fill1d(col):
        col = col.copy()
        if method == "backward":
            col = col[::-1]
        run = 0
        for i in range(1, len(col)):
            if np.isnan(col[i]):
                if run < maxlen and not np.isnan(col[i - 1]):
                    col[i] = col[i - 1]
                    run += 1
            else:
                run = 0
        return col[::-1] if method == "backward" else col

    X = np.apply_along_axis(fill1d, 0 if axis == 0 else 1,
                            _hostmat(fr).copy())
    return _np_frame(sess, {n: X[:, j] for j, n in enumerate(fr.names)}, fr)


@prim("flatten")
def _flatten(sess, args):
    fr = _fr(sess._ev(args[0]))
    v = fr.vecs[0]
    if fr.nrows != 1:
        raise ValueError("flatten expects a 1x1 frame")
    if v.type in (T_NUM, T_TIME):
        return float(np.asarray(v.to_numpy(), np.float64)[0])
    return str(v.to_numpy()[0])


@prim("getrow")
def _getrow(sess, args):
    fr = sess._ev(args[0])
    if fr.nrows != 1:
        raise ValueError("getrow expects a single-row frame")
    return [float(np.asarray(v.to_numpy(), np.float64)[0])
            if v.type in (T_NUM, T_TIME) else v.to_numpy()[0]
            for v in fr.vecs]


@prim("melt")
def _melt(sess, args):
    """(melt frame [id_vars] [value_vars] var_name value_name skipna)."""
    fr = sess._ev(args[0])
    id_vars = sess._col_names(fr, sess._ev(args[1]))
    vv = sess._ev(args[2]) if len(args) > 2 and args[2] is not None else None
    value_vars = sess._col_names(fr, vv) if vv else \
        [c for c in fr.names if c not in id_vars]
    var_name = str(sess._ev(args[3])) if len(args) > 3 else "variable"
    value_name = str(sess._ev(args[4])) if len(args) > 4 else "value"
    skipna = bool(sess._ev(args[5])) if len(args) > 5 else False
    n = fr.nrows
    out_id = {c: [] for c in id_vars}
    out_var, out_val = [], []
    host_ids = {c: _decoded(fr.vec(c)) for c in id_vars}
    for vcol in value_vars:
        vals = np.asarray(fr.vec(vcol).to_numpy(), np.float64)[:n]
        mask = ~np.isnan(vals) if skipna else np.ones(n, bool)
        idx = np.flatnonzero(mask)
        for c in id_vars:
            out_id[c].append(np.asarray(host_ids[c])[idx])
        out_var.append(np.full(len(idx), vcol, object))
        out_val.append(vals[idx])
    cols = {c: np.concatenate(out_id[c]) if out_id[c] else np.zeros(0)
            for c in id_vars}
    cols[var_name] = np.concatenate(out_var) if out_var else \
        np.zeros(0, object)
    cols[value_name] = np.concatenate(out_val) if out_val else np.zeros(0)
    return _np_frame(sess, cols, fr)


@prim("pivot")
def _pivot(sess, args):
    """(pivot frame index column value) — AstPivot."""
    fr = sess._ev(args[0])
    index = sess._col_names(fr, sess._ev(args[1]))[0]
    column = sess._col_names(fr, sess._ev(args[2]))[0]
    value = sess._col_names(fr, sess._ev(args[3]))[0]
    idx_vec = fr.vec(index)
    idx_vals = _decoded(idx_vec)
    col_vals = _decoded(fr.vec(column))
    val_vals = np.asarray(fr.vec(value).to_numpy(), np.float64)
    uidx = sorted(set(str(x) for x in idx_vals[: fr.nrows]))
    ucol = sorted(set(str(x) for x in col_vals[: fr.nrows]))
    pos_i = {v: i for i, v in enumerate(uidx)}
    pos_c = {v: i for i, v in enumerate(ucol)}
    M = np.full((len(uidx), len(ucol)), np.nan)
    for i in range(fr.nrows):
        M[pos_i[str(idx_vals[i])], pos_c[str(col_vals[i])]] = val_vals[i]
    if idx_vec.type in (T_NUM, T_TIME):
        cols = {index: np.asarray([float(x) for x in uidx])}
    else:
        cols = {index: np.asarray(uidx, object)}
    for j, c in enumerate(ucol):
        cols[c] = M[:, j]
    return _np_frame(sess, cols, fr)


@prim("rename")
def _rename(sess, args):
    fr = sess._ev(args[0])
    return fr.rename({str(sess._ev(args[1])): str(sess._ev(args[2]))})


@prim("rank_within_groupby")
def _rank_within(sess, args):
    """(rank_within_groupby fr [groupby] [sortcols] [asc] name sort2by)."""
    fr = sess._ev(args[0])
    by = sess._col_names(fr, sess._ev(args[1]))
    sortcols = sess._col_names(fr, sess._ev(args[2]))
    asc = sess._ev(args[3]) if len(args) > 3 else []
    name = str(sess._ev(args[4])) if len(args) > 4 else "New_Rank_column"
    keys = [fr.vec(c).numeric_data().cpu().numpy()[: fr.nrows] for c in by]
    svals = [fr.vec(c).numeric_data().cpu().numpy()[: fr.nrows]
             for c in sortcols]
    if asc:
        flips = [(-1.0 if not a else 1.0) for a in
                 (asc if isinstance(asc, list) else [asc])]
        svals = [v * flips[i] if i < len(flips) else v
                 for i, v in enumerate(svals)]
    order = np.lexsort(tuple(reversed(keys + svals)))
    _, group_id = np.unique(np.column_stack(keys), axis=0,
                            return_inverse=True)
    group_id = group_id.reshape(-1)
    rank = np.zeros(fr.nrows)
    seen = {}
    for i in order:
        g = group_id[i]
        seen[g] = seen.get(g, 0) + 1
        rank[i] = seen[g]
    return Frame(list(fr.names) + [name],
                 list(fr.vecs) + [Vec.from_numpy(rank, T_NUM,
                                                 device=sess.dev(fr))])


# ------------------------------------------------------------------ assign
@prim("append")
def _append(sess, args):
    fr = sess._ev(args[0])
    val = sess._ev(args[1])
    name = str(sess._ev(args[2]))
    if isinstance(val, (int, float)):
        v = Vec.from_numpy(np.full(fr.nrows, float(val)), T_NUM,
                           device=sess.dev(fr))
    else:
        v = _fr(val).vecs[0]
    names = list(fr.names)
    vecs = list(fr.vecs)
    if name in names:
        vecs[names.index(name)] = v
    else:
        names.append(name)
        vecs.append(v)
    return Frame(names, vecs)


@prim(":=")
def _rect_assign(sess, args):
    """(:= frame rhs col_sel row_sel) — AstRectangleAssign."""
    fr = sess._ev(args[0])
    rhs = sess._ev(args[1])
    col_sel = sess._ev(args[2])
    row_sel = sess._ev(args[3]) if len(args) > 3 else None
    cols = sess._col_names(fr, col_sel)
    if row_sel is None or (isinstance(row_sel, list) and not row_sel):
        rows = np.arange(fr.nrows)
    elif isinstance(row_sel, Frame):
        m = row_sel.vecs[0].numeric_data().cpu().numpy()[: fr.nrows]
        rows = np.flatnonzero(np.nan_to_num(m) != 0)
    elif isinstance(row_sel, list):
        rows = np.asarray(row_sel, np.int64)
    else:
        rows = np.asarray([int(row_sel)])
    dev = sess.dev(fr)
    new_vecs = list(fr.vecs)
    names = list(fr.names)
    for k, c in enumerate(cols):
        j = names.index(c)
        v = fr.vecs[j]
        if isinstance(rhs, (int, float)):
            vals = np.asarray(v.to_numpy()).copy()
            if v.type in (T_NUM, T_TIME):
                vals = np.asarray(vals, np.float64)
            vals[rows] = float(rhs)
            new_vecs[j] = Vec.from_numpy(vals, v.type, domain=v.domain,
                                         device=dev)
        elif isinstance(rhs, str):
            vals = np.asarray(v.to_numpy(), object).copy()
            vals[rows] = rhs
            dom = v.domain
            if v.type == T_CAT and dom is not None and rhs not in dom:
                dom = list(dom) + [rhs]
            new_vecs[j] = Vec.from_numpy(vals, v.type, domain=dom,
                                         device=dev)
        else:
            rf = _fr(rhs)
            src = rf.vecs[min(k, rf.ncols - 1)]
            vals = np.asarray(v.to_numpy()).copy()
            sv = src.to_numpy()
            if v.type in (T_NUM, T_TIME):
                vals = np.asarray(vals, np.float64)
                vals[rows] = np.asarray(sv, np.float64)[: len(rows)]
            else:
                vals = np.asarray(vals, object)
                vals[rows] = np.asarray(sv, object)[: len(rows)]
            new_vecs[j] = Vec.from_numpy(vals, v.type, domain=v.domain,
                                         device=dev)
    return Frame(names, new_vecs, key=fr.key)


# ------------------------------------------------------------------ misc
@prim("ls")
def _ls(sess, args):
    keys = sorted(dkv.keys(""))
    return Frame(["key"], [Vec.from_numpy(np.asarray(keys, object), T_STR)])


# ------------------------------------------------------------------ string
@prim("strlen")
def _strlen(sess, args):
    from .strings import nchar
    fr = _fr(sess._ev(args[0]))
    return Frame(fr.names, [nchar(v, device=sess.dev(fr)) for v in fr.vecs])


@prim("tokenize")
def _tokenize(sess, args):
    """(tokenize frame regex) — hex/RegexTokenizer.java:42-60: every string
    column of a row is split; rows' token runs are delimited by NA rows.
    Output: one string column, the Word2Vec ingestion format."""
    fr = sess._ev(args[0])
    pat = re.compile(str(sess._ev(args[1])))
    out: List = []
    host_cols = [v.to_numpy() for v in fr.vecs]
    for v in fr.vecs:
        if v.type not in (T_STR, T_CAT):
            raise ValueError("tokenize() requires all input columns to be "
                             "of a String type")
    for i in range(fr.nrows):
        for col in host_cols:
            s = col[i]
            if s is None or (isinstance(s, float) and np.isnan(s)):
                continue
            out.extend(tok for tok in pat.split(str(s)) if tok)
        out.append(None)
    return Frame(["tokens"], [Vec.from_numpy(np.asarray(out, object),
                                             T_STR)])


@prim("grep")
def _grep(sess, args):
    """(grep frame regex ignore_case invert output_logical)."""
    fr = _fr(sess._ev(args[0]))
    regex = str(sess._ev(args[1]))
    ignore_case = bool(sess._ev(args[2])) if len(args) > 2 else False
    invert = bool(sess._ev(args[3])) if len(args) > 3 else False
    logical = bool(sess._ev(args[4])) if len(args) > 4 else False
    pat = re.compile(regex, re.IGNORECASE if ignore_case else 0)
    vals = fr.vecs[0].to_numpy()
    hit = np.asarray([bool(pat.search(str(s))) if s is not None else False
                      for s in vals[: fr.nrows]])
    if invert:
        hit = ~hit
    if logical:
        return _np_frame(sess, {"grep": hit.astype(np.float64)}, fr)
    return _np_frame(sess, {"grep": np.flatnonzero(hit).astype(np.float64)},
                     fr)


@prim("entropy")
def _entropy(sess, args):
    fr = _fr(sess._ev(args[0]))
    vals = fr.vecs[0].to_numpy()
    out = np.full(fr.nrows, np.nan)
    for i, s in enumerate(vals[: fr.nrows]):
        if s is None:
            continue
        s = str(s)
        if not s:
            out[i] = 0.0
            continue
        _, counts = np.unique(list(s), return_counts=True)
        p = counts / counts.sum()
        out[i] = float(-np.sum(p * np.log2(p)))
    return _np_frame(sess, {"entropy": out}, fr)


@prim("strDistance")
def _str_distance(sess, args):
    """(strDistance fr1 fr2 measure compare_empty) — Levenshtein and
    Jaccard measures (the reference delegates to a string-distance
    library)."""
    fa = _fr(sess._ev(args[0]))
    a = fa.vecs[0].to_numpy()
    b = _fr(sess._ev(args[1])).vecs[0].to_numpy()
    measure = str(sess._ev(args[2])).lower() if len(args) > 2 else "lv"
    n = min(len(a), len(b))

    def lv(x, y):
        if x is None or y is None:
            return np.nan
        x, y = str(x), str(y)
        prev = list(range(len(y) + 1))
        for i, cx in enumerate(x, 1):
            cur = [i]
            for j, cy in enumerate(y, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (cx != cy)))
            prev = cur
        return float(prev[-1])

    def jaccard(x, y):
        if x is None or y is None:
            return np.nan
        sx, sy = set(str(x)), set(str(y))
        return float(len(sx & sy) / len(sx | sy)) if sx | sy else 1.0

    fn = jaccard if measure == "jaccard" else lv
    return _np_frame(sess, {"distance": np.asarray(
        [fn(a[i], b[i]) for i in range(n)])}, fa)


@prim("num_valid_substrings")
def _num_valid_substrings(sess, args):
    fr = _fr(sess._ev(args[0]))
    with open(str(sess._ev(args[1]))) as f:
        words = set(w.strip() for w in f if w.strip())
    vals = fr.vecs[0].to_numpy()
    out = np.full(fr.nrows, np.nan)
    for i, s in enumerate(vals[: fr.nrows]):
        if s is None:
            continue
        s = str(s)
        out[i] = sum(1 for lo in range(len(s))
                     for hi in range(lo + 2, len(s) + 1) if s[lo:hi] in words)
    return _np_frame(sess, {"num_valid_substrings": out}, fr)


# ------------------------------------------------------------------ time
def _decoded(v: Vec) -> np.ndarray:
    """Host labels for cats, host values otherwise."""
    return v.decoded() if v.type == T_CAT else v.to_numpy()


def _millis_to_dt(fr: Frame):
    # per-column to_numpy, NOT the f32 device matrix: epoch millis
    # (~1.6e12) lose ~2 minutes of precision in float32; TIME columns
    # keep their exact f64 ms on the host (Vec.to_numpy)
    ms = np.column_stack([np.asarray(v.to_numpy(), np.float64)
                          for v in fr.vecs])[: fr.nrows]
    dt = (np.where(np.isnan(ms), 0, ms)).astype("int64") \
        .astype("datetime64[ms]")
    return dt, np.isnan(ms)


def _time_field(extract):
    def h(sess, args):
        fr = _fr(sess._ev(args[0]))
        dt, nan = _millis_to_dt(fr)
        out = extract(dt).astype(np.float64)
        out[nan] = np.nan
        pad = int(fr.vecs[0].numeric_data().shape[0]) - fr.nrows
        return _num_frame(torch.from_numpy(np.pad(out, [(0, pad), (0, 0)]))
                          .to(sess.dev(fr)), fr.names, fr.nrows)
    return h


PRIMS["year"] = _time_field(
    lambda dt: dt.astype("datetime64[Y]").astype(int) + 1970)
PRIMS["month"] = _time_field(
    lambda dt: dt.astype("datetime64[M]").astype(int) % 12 + 1)
PRIMS["day"] = _time_field(
    lambda dt: (dt.astype("datetime64[D]")
                - dt.astype("datetime64[M]")).astype(int) + 1)
PRIMS["dayOfWeek"] = _time_field(
    lambda dt: (dt.astype("datetime64[D]").astype(int) + 3) % 7)
PRIMS["hour"] = _time_field(
    lambda dt: (dt - dt.astype("datetime64[D]"))
    .astype("timedelta64[h]").astype(int))
PRIMS["minute"] = _time_field(
    lambda dt: ((dt - dt.astype("datetime64[D]"))
                .astype("timedelta64[m]").astype(int)) % 60)
PRIMS["second"] = _time_field(
    lambda dt: ((dt - dt.astype("datetime64[D]"))
                .astype("timedelta64[s]").astype(int)) % 60)
PRIMS["millis"] = _time_field(
    lambda dt: dt.astype("int64").astype(np.float64))
PRIMS["week"] = _time_field(
    lambda dt: ((dt.astype("datetime64[D]")
                 - dt.astype("datetime64[Y]")).astype(int)) // 7 + 1)


@prim("mktime")
def _mktime(sess, args):
    """(mktime year month day hour minute second msec) — months and days
    0-based (AstMktime.java:55-56)."""
    parts = []
    nrows = 1
    src = None
    for a in args:
        v = sess._ev(a)
        if isinstance(v, (Frame, Vec)):
            src = _fr(v)
            nrows = src.nrows
            parts.append(_hostmat(src)[:, 0])
        else:
            parts.append(float(v))
    parts = [np.full(nrows, p) if np.isscalar(p) else p for p in parts]
    while len(parts) < 7:
        parts.append(np.zeros(nrows))
    y, mo, d, h, mi, s, ms = parts[:7]
    out = np.zeros(nrows)
    for i in range(nrows):
        t = (np.datetime64(f"{int(y[i]):04d}-01", "M")
             + np.timedelta64(int(mo[i]), "M"))
        t = t.astype("datetime64[D]") + np.timedelta64(int(d[i]), "D")
        t = t.astype("datetime64[ms]") \
            + np.timedelta64(int(h[i]), "h") \
            + np.timedelta64(int(mi[i]), "m") \
            + np.timedelta64(int(s[i]), "s") \
            + np.timedelta64(int(ms[i]), "ms")
        out[i] = t.astype("int64")
    dev = sess.dev(src) if src is not None else sess.device
    return Frame(["mktime"], [Vec.from_numpy(out, T_TIME, device=dev)])


@prim("moment")
def _moment(sess, args):
    return _mktime(sess, args)


@prim("as.Date")
def _as_date(sess, args):
    """(as.Date frame format) — string/cat column -> epoch millis."""
    import datetime as _dt
    fr = _fr(sess._ev(args[0]))
    fmt = str(sess._ev(args[1]))
    # translate Java SimpleDateFormat to strptime
    pyfmt = fmt.replace("yyyy", "%Y").replace("yy", "%y") \
        .replace("MM", "%m").replace("dd", "%d").replace("HH", "%H") \
        .replace("mm", "%M").replace("ss", "%S")
    vals = fr.vecs[0].to_numpy()
    out = np.full(fr.nrows, np.nan)
    for i, s in enumerate(vals[: fr.nrows]):
        if s is None:
            continue
        try:
            t = _dt.datetime.strptime(str(s), pyfmt)
            out[i] = t.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000
        except ValueError:
            pass
    return Frame(fr.names, [Vec.from_numpy(out, T_TIME,
                                           device=sess.dev(fr))])


_TZ = ["UTC"]


@prim("getTimeZone")
def _get_tz(sess, args):
    return _TZ[0]


@prim("setTimeZone")
def _set_tz(sess, args):
    _TZ[0] = str(sess._ev(args[0]))
    return _TZ[0]


@prim("listTimeZones")
def _list_tz(sess, args):
    import zoneinfo
    zones = sorted(zoneinfo.available_timezones())
    return _np_frame(sess, {"timezone": np.asarray(zones, object)})


# ------------------------------------------------------------------ timeseries
@prim("difflag1")
def _difflag1(sess, args):
    fr = _fr(sess._ev(args[0]))
    return _np_frame(sess, {fr.names[0]: np.diff(_hostmat(fr)[:, 0])}, fr)


def _norm_ppf(q):
    return torch.special.ndtri(torch.as_tensor(np.asarray(q, np.float64))) \
        .numpy()


@prim("isax")
def _isax(sess, args):
    fr = sess._ev(args[0])
    num_words = int(sess._ev(args[1]))
    max_card = int(sess._ev(args[2]))
    X = _hostmat(fr)
    mu = X.mean(axis=1, keepdims=True)
    sd = X.std(axis=1, keepdims=True)
    Z = (X - mu) / np.where(sd == 0, 1, sd)
    C = X.shape[1]
    bounds = np.linspace(0, C, num_words + 1).astype(int)
    paa = np.stack([Z[:, bounds[k]: max(bounds[k + 1], bounds[k] + 1)]
                    .mean(axis=1) for k in range(num_words)], axis=1)
    cuts = _norm_ppf(np.arange(1, max_card) / max_card)
    codes = np.searchsorted(cuts, paa)               # [n, words]
    cols = {"iSax_index": np.asarray(["^".join(str(int(c)) for c in row)
                                      for row in codes], object)}
    for k in range(num_words):
        cols[f"iSax_word_{k}"] = codes[:, k].astype(np.float64)
    return _np_frame(sess, cols, fr)
