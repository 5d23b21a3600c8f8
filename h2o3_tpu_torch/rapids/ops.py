"""Munging primitives over Frames (the water/rapids Ast* analogs) — the
port of ``h2o3_tpu/rapids/ops.py``.

sort, merge, group_by and filter run on the frame's device (see
``device.py``); host round trips are limited to O(1) scalars,
group-count-sized arrays and string payloads.  Grouped float sums reduce
the rows sorted by group in a fixed order (``device.segment_sums``, in
float64), so two runs on one card agree bitwise; counts are exact
integers; min and max are order-free.  The JAX package's lineage records
(``lineage.derive``) are not ported: the verbs return the new frame
alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, T_TIME, Vec
from ..runtime.device import Cluster
from . import device as dev


def sort(frame: Frame, by: Union[str, Sequence[str]],
         ascending: Union[bool, Sequence[bool]] = True) -> Frame:
    """Multi-key sort — the AstSort / RadixOrder analog, on the device."""
    by = [by] if isinstance(by, str) else list(by)
    asc = [ascending] * len(by) if isinstance(ascending, bool) \
        else list(ascending)
    if len(asc) != len(by):
        raise ValueError("ascending must match by")
    keys = [dev.sort_key(frame.vec(c)) for c in by]
    order = dev.lex_order(keys, asc)
    return dev.gather_rows(frame, order, frame.nrows)


def _row_mask(frame: Frame, mask) -> torch.Tensor:
    """A boolean [padded] device mask of kept rows from a Vec (nonzero,
    not NA) or a host array."""
    if isinstance(mask, Vec):
        m = (mask.data != 0) & mask.valid_mask()
        if mask.type != T_CAT:
            m = m & ~torch.isnan(mask.data)
        return m.to(frame.device)
    host = np.zeros(frame.padded_rows, bool)
    host[: frame.nrows] = np.asarray(mask)[: frame.nrows].astype(bool)
    return torch.from_numpy(host).to(frame.device)


def filter_rows(frame: Frame, mask) -> Frame:
    """Boolean row filter — the AstRowSlice analog (device compaction)."""
    m = _row_mask(frame, mask)
    m = m & (torch.arange(frame.padded_rows, device=frame.device)
             < frame.nrows)
    n_out = int(m.sum())
    order = torch.argsort((~m).to(torch.uint8), stable=True)  # kept first
    return dev.gather_rows(frame, order, n_out)


def rbind(*frames: Frame) -> Frame:
    """Stack frames vertically — the AstRBind analog."""
    base = frames[0]
    for fr in frames[1:]:
        if fr.names != base.names:
            raise ValueError("rbind: column names differ")
    device = base.device
    vecs = []
    for i, name in enumerate(base.names):
        vs = [fr.vecs[i] for fr in frames]
        t = vs[0].type
        if t == T_CAT:
            # unify domains
            domain: List[str] = []
            seen: Dict[str, int] = {}
            for v in vs:
                for lbl in (v.domain or []):
                    if lbl not in seen:
                        seen[lbl] = len(domain)
                        domain.append(lbl)
            codes = []
            for v in vs:
                remap = np.array([seen[lbl] for lbl in (v.domain or [])],
                                 dtype=np.int32)
                c = v.to_numpy()
                codes.append(np.where(c < 0, -1,
                                      remap[np.clip(c, 0, None)]))
            vecs.append(Vec.from_numpy(np.concatenate(codes), T_CAT,
                                       domain=domain, device=device))
        elif vs[0].data is None:
            vecs.append(Vec.from_numpy(
                np.concatenate([v.host_data for v in vs]), t))
        else:
            vecs.append(Vec.from_numpy(
                np.concatenate([v.host_data if t == T_TIME else v.to_numpy()
                                for v in vs]), t, device=device))
    return Frame(base.names, vecs)


def cbind(*frames: Frame) -> Frame:
    """Stack frames horizontally — the AstCBind analog (a repeated name
    gets a numeric suffix)."""
    names, vecs = [], []
    for fr in frames:
        for n, v in zip(fr.names, fr.vecs):
            nn, k = n, 0
            while nn in names:
                k += 1
                nn = f"{n}{k}"
            names.append(nn)
            vecs.append(v)
    return Frame(names, vecs)


def unique(vec: Vec) -> np.ndarray:
    """Distinct values — the AstUnique analog."""
    if vec.type == T_CAT:
        codes = np.unique(vec.to_numpy())
        return np.asarray([vec.domain[c] for c in codes if c >= 0])
    x = torch.sort(dev.sort_key(vec)).values.cpu().numpy()[: vec.nrows]
    return np.unique(x[np.isfinite(x)])


def _grouped_sum(vals: torch.Tensor, gid: torch.Tensor,
                 nseg: int) -> torch.Tensor:
    """float64 sums of ``vals`` per group id in [0, nseg): the rows sorted
    by group (stably), then each run reduced in a fixed order."""
    order = torch.argsort(gid, stable=True)
    lengths = torch.bincount(gid, minlength=nseg)
    return dev.segment_sums(vals[order].to(torch.float64), lengths)


def table(vec: Vec, weights: Optional[Vec] = None) -> Dict[str, float]:
    """Value counts — the AstTable analog (device counts for cats)."""
    if vec.type == T_CAT:
        K = len(vec.domain or [])
        codes = vec.data
        ok = vec.valid_mask() & (codes >= 0)
        gid = torch.where(codes >= 0, codes, K).long()
        if weights is None:
            counts = torch.bincount(gid[ok], minlength=K + 1)
        else:
            w = ok.to(torch.float32) * weights.numeric_data()
            counts = _grouped_sum(w, gid, K + 1)
        counts = counts[:K].to(torch.float64).cpu().numpy()
        return {vec.domain[i]: float(counts[i]) for i in range(K)}
    x = vec.to_numpy()
    vals, counts = np.unique(x[~np.isnan(x)], return_counts=True)
    return {str(v): int(c) for v, c in zip(vals, counts)}


def ifelse(cond, yes, no) -> Vec:
    """Vectorized conditional — the AstIfElse analog."""
    vecs = [x for x in (cond, yes, no) if isinstance(x, Vec)]
    device = vecs[0].device if vecs else torch.device("cpu")
    c = cond.data if isinstance(cond, Vec) else \
        torch.as_tensor(np.asarray(cond), device=device)
    y = yes.data if isinstance(yes, Vec) else yes
    n = no.data if isinstance(no, Vec) else no
    nrows = cond.nrows if isinstance(cond, Vec) else len(np.asarray(cond))
    out = torch.where(c != 0, y, n)
    return Vec(out.to(torch.float32), T_NUM, nrows)


def hist(vec: Vec, breaks: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram counts — the AstHist analog (device bucketize and exact
    integer counts)."""
    r = vec.rollups()
    lo, hi = r.vmin, r.vmax
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        return np.zeros(breaks), np.linspace(0, 1, breaks + 1)
    edges = np.linspace(lo, hi, breaks + 1)
    x = vec.data
    idx = ((x - lo) / (hi - lo) * breaks).to(torch.int32).clamp(
        0, breaks - 1)
    valid = vec.valid_mask() & ~torch.isnan(x)
    gid = torch.where(valid, idx, breaks).long()
    counts = torch.bincount(gid, minlength=breaks + 1)[:breaks]
    return counts.to(torch.float32).cpu().numpy(), edges


def interaction(frame: Frame, factors: Sequence[str], pairwise: bool = True,
                max_factors: int = 100, min_occurrence: int = 1) -> Frame:
    """Categorical interaction columns — the hex/Interaction analog.

    ``pairwise``: one column per factor pair; otherwise a single column
    over the full tuple.  Levels rank by frequency; beyond ``max_factors``
    (or under ``min_occurrence``) they collapse into "other".
    """
    from itertools import combinations
    factors = list(factors)
    for f in factors:
        if frame.vec(f).type != T_CAT:
            raise ValueError(f"interaction factor {f!r} must be categorical")
    if pairwise and len(factors) >= 2:
        groups = list(combinations(factors, 2))
    else:
        groups = [tuple(factors)]
    out = frame
    for grp in groups:
        labels = None
        for f in grp:
            dec = frame.vec(f).decoded()
            part = np.asarray(["NA" if x is None else str(x) for x in dec],
                              dtype=object)
            labels = part if labels is None else \
                np.asarray([a + "_" + b for a, b in zip(labels, part)],
                           dtype=object)
        uniq, counts = np.unique(labels, return_counts=True)
        order = np.argsort(-counts)
        keep = [u for u, c in zip(uniq[order], counts[order])
                if c >= min_occurrence][:max_factors]
        keepset = set(keep)
        col = np.asarray([x if x in keepset else "other" for x in labels],
                         dtype=object)
        out = out.with_vec("_".join(grp), Vec.from_numpy(
            col, T_CAT, device=frame.device))
    return out


def impute(frame: Frame, column: str, method: str = "mean",
           combine_method: str = "interpolate") -> Frame:
    """Fill a column's NAs in a new frame — the AstImpute analog.

    ``method``: mean | median | mode.  Numeric columns take mean or
    median; categorical ones the mode (the most frequent level).
    """
    v = frame.vec(column)
    if method not in ("mean", "median", "mode"):
        raise ValueError(f"impute method {method!r}: mean | median | mode")
    if v.type != T_CAT and method == "mode":
        raise ValueError("impute method='mode' is for categorical columns")
    if v.type == T_CAT:
        t = table(v)
        if not t:
            return frame
        code = (v.domain or []).index(max(t, key=t.get))
        data = torch.where(v.data < 0, code, v.data)
        return frame.with_vec(column, Vec(data, T_CAT, v.nrows,
                                          domain=v.domain))
    qmethod = {"interpolate": "linear", "lo": "lower",
               "hi": "higher", "low": "lower", "high": "higher",
               "average": "linear"}.get(combine_method, "linear")
    if v.type == T_TIME:
        # fill in the EXACT host ms payload and rebuild (keeps time_base)
        host = np.array(v.to_numpy(), copy=True)
        finite = np.isfinite(host)
        if not finite.any():
            return frame
        fill = float(np.nanquantile(host, 0.5, method=qmethod)) \
            if method == "median" else float(host[finite].mean())
        host[~finite] = fill
        return frame.with_vec(column, Vec.from_numpy(
            host, T_TIME, device=frame.device))
    if method == "median":
        x = v.to_numpy()
        fill = float(np.nanquantile(x, 0.5, method=qmethod)) \
            if np.isfinite(x).any() else 0.0
    else:
        fill = v.rollups().mean
    data = torch.where(torch.isnan(v.data),
                       torch.tensor(fill, dtype=torch.float32,
                                    device=v.device), v.data)
    return frame.with_vec(column, Vec(data, v.type, v.nrows))


def cut(vec: Vec, breaks: Sequence[float],
        labels: Optional[Sequence[str]] = None,
        include_lowest: bool = False, right: bool = True) -> Vec:
    """Numeric -> categorical by interval — the AstCut analog."""
    edges = torch.tensor(list(breaks), dtype=torch.float32,
                         device=vec.device)
    x = vec.data.contiguous()
    idx = torch.searchsorted(edges, x, right=not right) - 1
    nb = len(breaks) - 1
    if include_lowest:
        idx = torch.where(x == edges[0], 0, idx)
    bad = torch.isnan(x) | (idx < 0) | (idx >= nb)
    codes = torch.where(bad, -1, idx).to(torch.int32)
    if labels is None:
        b = list(breaks)
        if right:
            lb0 = "[" if include_lowest else "("
            labels = [f"{lb0 if i == 0 else '('}{b[i]},{b[i+1]}]"
                      for i in range(nb)]
        else:
            labels = [f"[{b[i]},{b[i+1]})" for i in range(nb)]
    return Vec(codes, T_CAT, vec.nrows, domain=list(labels))


def scale(frame: Frame, center: bool = True,
          scale_: bool = True) -> Frame:
    """Standardize numeric columns — the AstScale analog (a device
    pass)."""
    vecs = []
    for v in frame.vecs:
        if v.type == T_NUM:
            r = v.rollups()
            mu = r.mean if center else 0.0
            sd = r.sigma if (scale_ and r.sigma and r.sigma > 0) else 1.0
            vecs.append(Vec((v.data - mu) / sd, T_NUM, v.nrows))
        else:
            vecs.append(v)
    return Frame(frame.names, vecs)


# ---------------------------------------------------------------- group-by
_AGGS = ("count", "sum", "mean", "min", "max", "var", "sd")
_BIG = float(np.float32(3.4e38))


def _device_keys(frame: Frame, by: List[str],
                 cat_remap: Optional[Dict[str, Dict[str, int]]] = None
                 ) -> List[torch.Tensor]:
    """Key columns as float32 device tensors; NA and padding -> +inf."""
    keys = []
    pad = torch.arange(frame.padded_rows, device=frame.device) \
        >= frame.nrows
    for name in by:
        v = frame.vec(name)
        if v.type == T_CAT:
            if cat_remap is not None and name in cat_remap:
                remap = cat_remap[name]
                tbl = torch.tensor(
                    [remap[lbl] for lbl in (v.domain or [])] or [0],
                    dtype=torch.float32, device=v.device)
                k = tbl[v.data.clamp_min(0).long()]
                k = torch.where(v.data < 0, float("inf"), k)
            else:
                k = dev.sort_key(v)
        elif v.data is None:
            raise TypeError(f"column {name!r} is host-only (string key)")
        else:
            k = torch.where(torch.isnan(v.data), float("inf"), v.data)
        keys.append(torch.where(pad, float("inf"), k))
    return keys


def group_by(frame: Frame, by: Union[str, Sequence[str]],
             aggs: Dict[str, Sequence[str]]) -> Frame:
    """Grouped aggregation — the AstGroup analog.

    ``aggs``: {column: [agg, ...]} with aggs from count/sum/mean/min/max/
    var/sd.  Group ids come from a device lexicographic dense rank; the
    rows sorted by it (NA-key rows last) make each group one contiguous
    run, whose sums reduce in a fixed order in float64
    (``device.segment_sums``); min and max are scatter reductions.  Rows
    with NA in any key column are dropped, mirroring AstGroup's default
    NA handling.  Two host syncs: the group count and the results.
    """
    by = [by] if isinstance(by, str) else list(by)
    for col, fns in aggs.items():
        for fn in fns:
            if fn not in _AGGS:
                raise ValueError(f"unknown agg {fn!r} (have {_AGGS})")
    device = frame.device
    keys = _device_keys(frame, by)
    valid = torch.ones(frame.padded_rows, dtype=torch.bool, device=device)
    for k in keys:
        valid = valid & torch.isfinite(k)
    # collapse ALL columns of any-NA rows to +inf before ranking: a
    # partial-NA tuple must not consume a dense rank below G
    keys = [torch.where(valid, k, float("inf")) for k in keys]
    order, rank_sorted = dev.sorted_rank(keys)
    rank = torch.zeros_like(rank_sorted).scatter_(0, order, rank_sorted)
    G = int(torch.where(valid, rank, -1).max()) + 1
    if G <= 0:
        return Frame.from_numpy(
            {**{n: np.array([], object) for n in by},
             **{f"{fn}_{c}": np.array([]) for c, fns in aggs.items()
                for fn in fns}}, device=device)
    # any-NA-key rows -> the overflow segment G (AstGroup drops them); in
    # the sorted order they come after every group
    gid = torch.where(valid, rank.clamp_max(G), G)
    nseg = G + 1
    lengths = torch.bincount(rank_sorted.clamp_max(G), minlength=nseg)

    # one representative row per group (its last), for the key decode
    rep = torch.full((nseg,), -1, dtype=torch.int64, device=device) \
        .scatter_reduce(0, gid, torch.arange(frame.padded_rows,
                                             device=device), "amax")[:G]
    out_cols: Dict[str, np.ndarray] = {}
    types: Dict[str, str] = {}
    domains: Dict[str, Sequence[str]] = {}
    for name in by:
        v = frame.vec(name)
        if v.type == T_CAT:
            out_cols[name] = v.data[rep].cpu().numpy().astype(np.int32)
            types[name] = T_CAT
            domains[name] = v.domain or []
        else:
            out_cols[name] = v.data[rep].cpu().numpy().astype(np.float64)

    for col, fns in aggs.items():
        x = frame.vec(col).numeric_data()
        ok = ~torch.isnan(x)
        xz = torch.nan_to_num(x).to(torch.float64) * ok
        s1 = dev.segment_sums(xz[order], lengths)
        n = dev.segment_sums(ok[order].to(torch.float64), lengths)
        mean = s1 / n.clamp_min(1e-300)
        got = {"count": n, "sum": s1, "mean": mean}
        if any(f in ("min", "max") for f in fns):
            got["min"] = torch.full((nseg,), _BIG, device=device) \
                .scatter_reduce(0, gid, torch.where(ok, x, _BIG), "amin")
            got["max"] = torch.full((nseg,), -_BIG, device=device) \
                .scatter_reduce(0, gid, torch.where(ok, x, -_BIG), "amax")
        if any(f in ("var", "sd") for f in fns):
            # residual pass: stable against E[x^2] - E[x]^2
            resid = (xz - mean[gid]) * ok
            ss = dev.segment_sums((resid * resid)[order], lengths)
            got["var"] = ss / (n - 1).clamp_min(1e-300)
            got["sd"] = got["var"].sqrt()
        host = {f: got[f][:G].cpu().numpy() for f in set(fns)}
        for fn in fns:
            out_cols[f"{fn}_{col}"] = host[fn]
    return Frame.from_numpy(out_cols, types=types, domains=domains,
                            device=device)


# -------------------------------------------------------------------- merge
def _na_vec(template: Vec, n: int, device) -> Vec:
    """All-NA vec of the template's type (the outer join's fill)."""
    if template.type == T_CAT:
        return Vec.from_numpy(np.full(n, -1, np.int32), T_CAT,
                              domain=template.domain, device=device)
    if template.data is None:
        return Vec(None, template.type, n,
                   host_data=np.array([None] * n, dtype=object))
    return Vec.from_numpy(np.full(n, np.nan), template.type, device=device)


def _join_keys(left: Frame, right: Frame, by: List[str]):
    """Both sides' keys dense-ranked together: (lrank, rrank, lvalid,
    rvalid), categorical keys compared by label through one shared
    domain."""
    cat_remap: Dict[str, Dict[str, int]] = {}
    for name in by:
        lv, rv = left.vec(name), right.vec(name)
        if lv.type == T_CAT:
            shared: Dict[str, int] = {}
            for lbl in (lv.domain or []) + (rv.domain or []):
                if lbl not in shared:
                    shared[lbl] = len(shared)
            cat_remap[name] = shared
    lkeys = _device_keys(left, by, cat_remap)
    rkeys = _device_keys(right, by, cat_remap)
    pl = left.padded_rows
    rank = dev.dense_rank([torch.cat([lk, rk])
                           for lk, rk in zip(lkeys, rkeys)])
    lvalid = torch.stack([torch.isfinite(k) for k in lkeys]).all(0)
    rvalid = torch.stack([torch.isfinite(k) for k in rkeys]).all(0)
    return rank[:pl], rank[pl:], lvalid, rvalid


def _unmatched_right(left: Frame, right: Frame, by: List[str]) -> Frame:
    """Right rows whose key matches NO left row (rank membership)."""
    lrank, rrank, lvalid, rvalid = _join_keys(left, right, by)
    nseg = left.padded_rows + right.padded_rows + 2
    lcount = torch.bincount(lrank[lvalid], minlength=nseg)
    unmatched = rvalid & (lcount[rrank] == 0)
    return filter_rows(right, Vec(unmatched.to(torch.float32), T_NUM,
                                  right.nrows))


def merge(left: Frame, right: Frame, by: Union[str, Sequence[str]],
          how: str = "inner") -> Frame:
    """Join — the AstMerge / BinaryMerge analog, a device sort-merge.

    Single- or multi-key equi-join.  Keys from both frames are dense-
    ranked together; match ranges come from per-rank segment tables and
    duplicate expansion from a prefix-sum ownership scan (device.py).
    Output keeps left-row order with duplicate matches adjacent.  NA keys
    never match (BinaryMerge semantics).
    """
    by = [by] if isinstance(by, str) else list(by)
    if how == "right":
        # all.y: a left join from the other side, columns laid out as
        # (left cols, right-only cols)
        out = merge(right, left, by, how="left")
        lcols = [n for n in left.names if n not in by]
        rcols = [n for n in right.names if n not in by]
        return out[by + [c for c in lcols if c in out.names]
                   + [c for c in rcols if c in out.names]]
    if how == "outer":
        li = merge(left, right, by, how="left")
        extra = _unmatched_right(left, right, by)
        if extra.nrows == 0:
            return li
        # align to the left join's layout, NA-filling left-only columns
        # with NA vecs of their type (cat -> -1 codes, left domain)
        aligned = [extra.vec(c) if c in extra.names
                   else _na_vec(left.vec(c), extra.nrows, left.device)
                   for c in li.names]
        return rbind(li, Frame(li.names, aligned))
    if how not in ("inner", "left"):
        raise ValueError("merge supports how='inner'|'left'|'right'|'outer'")
    for name in by:
        lv, rv = left.vec(name), right.vec(name)
        if (lv.data is None) or (rv.data is None):
            raise TypeError(f"merge key {name!r} is a string column; "
                            "convert to categorical first")
        if (lv.type == T_CAT) != (rv.type == T_CAT):
            raise TypeError(f"merge key {name!r} has mismatched types")
    device = left.device
    lrank, rrank, lvalid, rvalid = _join_keys(left, right, by)
    pl, pr = left.padded_rows, right.padded_rows
    nseg = pl + pr + 2
    lrank = torch.where(lvalid, lrank, nseg - 1)
    rrank = torch.where(rvalid, rrank, nseg - 1)

    rorder = torch.argsort(rrank, stable=True)
    rsorted = rrank[rorder]
    # per-rank [start, count) into rsorted — replaces a per-row search
    rstart = torch.full((nseg,), pr, dtype=torch.int64, device=device) \
        .scatter_reduce(0, rsorted, torch.arange(pr, device=device), "amin")
    rcount = torch.bincount(rsorted, minlength=nseg)
    lo = rstart[lrank]
    counts = torch.where(lvalid, rcount[lrank], 0)
    if how == "left":
        out_counts = torch.where(torch.arange(pl, device=device)
                                 < left.nrows, counts.clamp_min(1), 0)
    else:
        out_counts = counts
    starts = torch.cumsum(out_counts, 0) - out_counts
    m = int(starts[-1] + out_counts[-1]) if pl else 0
    p_out = Cluster(device).pad_rows(m)

    li = dev.expand_starts(starts, out_counts, p_out)
    li = li.clamp(0, max(pl - 1, 0))
    off = torch.arange(p_out, device=device) - starts[li]
    matched = counts[li] > 0
    rpos = (lo[li] + torch.where(matched, off, 0)).clamp(0, max(pr - 1, 0))
    ridx = torch.where(matched, rorder[rpos], -1)

    out = dev.gather_rows(left, li, m)
    rcols = [n for n in right.names if n not in by]
    if rcols:
        rsub = dev.gather_rows(right[rcols], ridx.clamp_min(0), m,
                               na_mask=ridx < 0)
        out = cbind(out, rsub)
    return out


def var(frame: Frame, cols: Optional[Sequence[str]] = None,
        use: str = "complete.obs") -> Dict[str, np.ndarray]:
    """Covariance matrix — the h2o.var / CovarianceTask analog.

    ``use``: "complete.obs" drops rows with any NA across the selected
    columns (the reference's default for frames); "everything" propagates
    NaN like R.  On the device: masked mean-centering, then one float32
    X^T X product (TF32 off, as everywhere in the port).
    """
    cols = list(cols) if cols is not None else \
        [n for n in frame.names if frame.vec(n).is_numeric]
    M = frame.matrix(cols)                     # [padded, F]
    # categorical codes use -1 as the NA sentinel; align with numeric NaN
    is_cat = torch.tensor([frame.vec(c).type == T_CAT for c in cols],
                          device=M.device)
    if bool(is_cat.any()):
        M = torch.where(is_cat[None, :] & (M == -1), float("nan"), M)
    valid = frame.valid_mask()
    finite = torch.isfinite(M)
    if use == "complete.obs":
        row_ok = valid & finite.all(dim=1)
    elif use == "everything":
        row_ok = valid
    else:
        raise ValueError(f"unknown use={use!r}")
    n = float(row_ok.sum())
    if n < 2:                                  # R/h2o return NA here
        return {"columns": cols,
                "matrix": np.full((len(cols), len(cols)), np.nan)}
    Mz = torch.where(row_ok[:, None],
                     torch.where(finite, M, float("nan")), 0.0)
    mean = Mz.sum(dim=0) / n
    D = (Mz - mean) * row_ok.to(M.dtype)[:, None]
    C = (D.T @ D) / (n - 1.0)
    return {"columns": cols,
            "matrix": C.cpu().numpy().astype(np.float64)}


def cor(frame: Frame, cols: Optional[Sequence[str]] = None,
        use: str = "complete.obs") -> Dict[str, np.ndarray]:
    """Pearson correlation matrix — the h2o.cor analog (from ``var``)."""
    v = var(frame, cols, use=use)
    C = v["matrix"]
    sd = np.sqrt(np.diag(C))
    with np.errstate(invalid="ignore", divide="ignore"):
        R = np.clip(C / np.outer(sd, sd), -1.0, 1.0)
    return {"columns": v["columns"], "matrix": R}
