"""Cox proportional hazards — the port of ``h2o3_tpu/models/coxph.py``
(hex/coxph/CoxPH.java:28).

The rows are sorted on the host by (stratum, time descending), so every
risk set is a stratum-local prefix: ``_cox_stats`` takes the sums S0 =
Σ w e^eta, S1 = Σ w e^eta x and S2 = Σ w e^eta x x' as cumulative sums
on the device read at the tie boundary less the stratum's offset; a
start column (counting-process rows) subtracts a second prefix over the
rows sorted by start, descending.  The tie groups are contiguous runs
of that order, so Efron's per-group event sums are differences of
prefix sums too (the JAX package takes them with ``segment_sum``):
deterministic on the card, where a float ``index_add_`` is not.  The
[P, P] Newton step is solved on the host in f64.  The prefix sums run
in a fixed blocked order (``cumulative``), so a second fit on the card
is bitwise the first.  The concordance of
the training metrics is Harrell's C as
``metrics.gainslift.concordance_index`` computes it, counted exactly in
O(n log² n) on the device (``concordance``) instead of in O(n²).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class CoxPHParameters(Parameters):
    start_column: Optional[str] = None       # counting-process entry time
    stop_column: str = ""                    # survival time
    event_column: str = ""                   # 1 = event, 0 = censored
    stratify_by: Optional[str] = None        # separate baseline per stratum
    ties: str = "efron"                      # efron | breslow (ref default)
    max_iterations: int = 20
    standardize: bool = True
    # covariate interactions (CoxPHModel.java:52-53): with counting-process
    # episodes they express time-varying coefficients
    interactions: Optional[Sequence[str]] = None        # all pairs among
    interaction_pairs: Optional[Sequence] = None        # explicit (a, b)


# rows a thread sums in order in ``cumulative``
SCAN_BLOCK = 1024


def cumulative(a: torch.Tensor) -> torch.Tensor:
    """[N + 1, ...]: 0, then the prefix sums of ``a`` along its rows, in
    one fixed order on every run: in order within blocks of
    ``SCAN_BLOCK`` rows, then the blocks' totals in order.  (A float
    ``torch.cumsum`` along one dimension is a look-back scan on the card,
    whose order, and so whose last bits, vary by run; along an outer
    dimension of few columns it is one thread a column, in order, over
    all N rows: slow.)"""
    n = a.shape[0]
    flat = a.reshape(n, -1)
    # a second column keeps both scans below on their in-order kernels
    # (one column is a 1-D scan there)
    C = max(flat.shape[1], 2)
    nb = max(-(-n // SCAN_BLOCK), 1)
    blk = flat.new_zeros((nb * SCAN_BLOCK, C))
    blk[:n, : flat.shape[1]] = flat
    blk = blk.reshape(nb, SCAN_BLOCK, C).cumsum(dim=1)
    blk[1:] += blk[:-1, -1].cumsum(dim=0)[:, None, :]
    out = blk.reshape(nb * SCAN_BLOCK, C)[:n, : flat.shape[1]]
    return torch.cat([out.new_zeros((1, flat.shape[1])), out]) \
        .reshape((n + 1,) + tuple(a.shape[1:]))


def _cox_stats(X, w, event, tie_start, tie_end, strat_first, grank, gsize,
               perm2, bpos, bstart, beta, efron: bool, use_start: bool):
    """(neg log PL, gradient, hessian) via stratified prefix risk sets,
    in the dtype of ``X``."""
    eta = X @ beta
    eta = eta - eta.max()
    r = w * torch.exp(eta)
    rX = r[:, None] * X
    rXX = r[:, None, None] * (X[:, :, None] * X[:, None, :])

    def pref(a):
        # stratum-local prefix ending at the tie boundary
        cp = cumulative(a)
        return cp[tie_end + 1] - cp[strat_first]

    S0, S1, S2 = pref(r), pref(rX), pref(rXX)
    if use_start:
        # subtract rows with start >= t: a stratum-local prefix of the
        # start-descending order (bstart = the stratum's offset in it)
        def pref2(a):
            cp = cumulative(a[perm2])
            return cp[bpos] - cp[bstart]
        S0 = S0 - pref2(r)
        S1 = S1 - pref2(rX)
        S2 = S2 - pref2(rXX)

    ew = event * w
    if efron:
        # each tie group's event sums: a contiguous run's prefix difference
        def group(a):
            cp = cumulative(a)
            return cp[tie_end + 1] - cp[tie_start]
        t0 = group(event * r)
        t1 = group(event[:, None] * rX)
        t2 = group(event[:, None, None] * rXX)
        frac = torch.where(gsize > 0, grank / gsize.clamp_min(1.0), 0.0)
        d0 = (S0 - frac * t0).clamp_min(1e-30)
        d1 = S1 - frac[:, None] * t1
        d2 = S2 - frac[:, None, None] * t2
    else:
        d0 = S0.clamp_min(1e-30)
        d1, d2 = S1, S2

    m = d1 / d0[:, None]
    ll = torch.sum(ew * (eta - torch.log(d0)))
    grad = torch.sum(ew[:, None] * (X - m), dim=0)
    hess_i = d2 / d0[:, None, None] - m[:, :, None] * m[:, None, :]
    hess = torch.sum(ew[:, None, None] * hess_i, dim=0)
    return -ll, grad, hess


def concordance(event_time, event, risk, device=None) -> float:
    """Harrell's C with unit weights, as ``metrics.gainslift.
    concordance_index`` defines it (comparable pairs: i an event and
    t_i < t_j; concordant when the earlier row has the higher risk, a tie
    in risk half), counted exactly: the rows ranked by time descending
    (g) and by risk (rr), each event's count of later rows of lower and
    of equal risk is a 2-D dominance count, summed over the dyadic blocks
    of [0, g) with one sort and three searches a level."""
    t = torch.as_tensor(np.asarray(event_time, np.float64), device=device)
    e = torch.as_tensor(np.asarray(event, bool), device=device)
    r = torch.as_tensor(np.asarray(risk, np.float64), device=device)
    ok = torch.isfinite(t) & torch.isfinite(r)
    t, e, r = t[ok], e[ok], r[ok]
    ut = torch.unique(t)
    T = ut.numel()
    g = (T - 1) - torch.searchsorted(ut, t)           # later: smaller g
    ur = torch.unique(r)
    R = ur.numel()
    rr = torch.searchsorted(ur, r)
    cnt = torch.bincount(g, minlength=T)
    before = torch.cumsum(cnt, 0) - cnt               # #{j: g_j < g}
    qg, qr = g[e], rr[e]
    den = int(before[qg].sum())
    less = equal = 0
    level = 0
    while (1 << level) < max(T, 1):
        keys = torch.sort((g >> level) * R + rr).values
        sel = ((qg >> level) & 1) == 1
        base = ((qg[sel] >> level) - 1) * R
        lo = torch.searchsorted(keys, base)
        mid = torch.searchsorted(keys, base + qr[sel])
        hi = torch.searchsorted(keys, base + qr[sel], right=True)
        less += int((mid - lo).sum())
        equal += int((hi - mid).sum())
        level += 1
    num = less + 0.5 * equal
    return float(num / den) if den > 0 else float("nan")


def _interaction_list(p: "CoxPHParameters") -> List[tuple]:
    pairs = [tuple(x) for x in (p.interaction_pairs or ())]
    if p.interactions:
        pairs += list(itertools.combinations(p.interactions, 2))
    return pairs


def expand_interactions(frame: Frame, pairs: Sequence[tuple]) -> Frame:
    """Add product columns for covariate interactions.

    num x num -> one ``a:b`` product column; cat x num -> one slope
    column per level (``cat.level:num`` — the per-level coefficients ARE
    the time-varying betas when the cat is a period indicator);
    cat x cat -> the crossed factor ``a_b``.
    """
    names, vecs = list(frame.names), list(frame.vecs)
    dev = frame.device
    for a, b in pairs:
        va, vb = frame.vec(a), frame.vec(b)
        if va.type == T_CAT and vb.type == T_CAT:
            ca, cb = va.to_numpy(), vb.to_numpy()
            lb = len(vb.domain)
            codes = np.where((ca < 0) | (cb < 0), -1, ca * lb + cb)
            domain = [f"{x}_{y}" for x in va.domain for y in vb.domain]
            names.append(f"{a}_{b}")
            vecs.append(Vec.from_numpy(codes.astype(np.int32), T_CAT,
                                       domain=domain, device=dev))
        elif va.type == T_CAT or vb.type == T_CAT:
            cat, num, cn, nn = (va, vb, a, b) if va.type == T_CAT \
                else (vb, va, b, a)
            codes = cat.to_numpy()
            x = np.nan_to_num(num.to_numpy())
            for li, lvl in enumerate(cat.domain):
                names.append(f"{cn}.{lvl}:{nn}")
                vecs.append(Vec.from_numpy(
                    np.where(codes == li, x, 0.0), T_NUM, device=dev))
        else:
            names.append(f"{a}:{b}")
            vecs.append(Vec.from_numpy(
                np.nan_to_num(va.to_numpy())
                * np.nan_to_num(vb.to_numpy()), T_NUM, device=dev))
    return Frame(names, vecs)


class CoxPHModel(Model):
    algo = "coxph"

    def _with_interactions(self, frame: Frame) -> Frame:
        pairs = [tuple(x) for x in
                 self.output.get("interaction_pairs", ())]
        if pairs and not all(
                (f"{a}:{b}" in frame.names or f"{a}_{b}" in frame.names
                 or any(n.startswith(f"{a}.") and n.endswith(f":{b}")
                        or n.startswith(f"{b}.") and n.endswith(f":{a}")
                        for n in frame.names))
                for a, b in pairs):
            return expand_interactions(frame, pairs)
        return frame

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        beta = torch.as_tensor(np.asarray(self.output["beta_std"],
                                          np.float32), device=X.device)
        return X @ beta                       # linear predictor (log hazard)

    def predict(self, frame: Frame) -> Frame:
        frame = self._with_interactions(frame)
        X = self.datainfo.make_matrix(frame)
        lp = self._predict_raw(X)[: frame.nrows].cpu().numpy()
        return Frame(["lp"], [Vec.from_numpy(lp.astype(np.float64), T_NUM,
                                             device=frame.device)])

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        return {"concordance": self._concordance(frame)}

    def _concordance(self, frame: Frame) -> float:
        p: CoxPHParameters = self.params
        lp = self.predict(frame).vecs[0].to_numpy()
        t = frame.vec(p.stop_column).to_numpy()
        e = frame.vec(p.event_column).to_numpy()
        return concordance(t, e > 0, lp, device=frame.device)


class CoxPH(ModelBuilder):
    """CoxPH builder — H2OCoxProportionalHazardsEstimator analog."""

    algo = "coxph"
    model_class = CoxPHModel
    supervised = False                       # its own response contract
    standard_metrics = False

    def __init__(self, params: Optional[CoxPHParameters] = None, **kw):
        super().__init__(params or CoxPHParameters(**kw))

    def train(self, frame: Frame, valid: Optional[Frame] = None):
        pairs = _interaction_list(self.params)
        if pairs:
            frame = expand_interactions(frame, pairs)
            if valid is not None:
                valid = expand_interactions(valid, pairs)
        return super().train(frame, valid)

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: CoxPHParameters = self.params
        if not p.stop_column or not p.event_column:
            raise ValueError("coxph requires stop_column and event_column")
        if p.ties not in ("efron", "breslow"):
            raise ValueError(f"ties={p.ties!r}: efron|breslow")
        for c in (p.stop_column, p.event_column):
            if c not in frame.names:
                raise ValueError(f"column {c!r} not in frame")
        if p.start_column and p.start_column not in frame.names:
            raise ValueError(f"start column {p.start_column!r} not in frame")
        if p.stratify_by and p.stratify_by not in frame.names:
            raise ValueError(f"strata column {p.stratify_by!r} not in frame")

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        drop = [p.stop_column, p.event_column]
        if p.start_column:
            drop.append(p.start_column)
        if p.stratify_by:
            drop.append(p.stratify_by)
        return DataInfo.fit(
            frame, response_column=None,
            ignored_columns=list(p.ignored_columns) + drop,
            weights_column=p.weights_column, standardize=p.standardize,
            add_intercept=False,             # no intercept in Cox
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> CoxPHModel:
        p: CoxPHParameters = self.params
        t = frame.vec(p.stop_column).to_numpy().astype(np.float64)
        e = frame.vec(p.event_column).to_numpy().astype(np.float64)
        start = frame.vec(p.start_column).to_numpy().astype(np.float64) \
            if p.start_column else None
        if p.stratify_by:
            sv = frame.vec(p.stratify_by)
            strat = sv.to_numpy() if sv.type == T_CAT else \
                np.unique(sv.to_numpy(), return_inverse=True)[1]
        else:
            strat = np.zeros(frame.nrows, np.int64)
        wcol = np.ones(frame.nrows)
        if p.weights_column and p.weights_column in frame.names:
            wcol = np.nan_to_num(frame.vec(p.weights_column).to_numpy())
        ok = ~(np.isnan(t) | np.isnan(e))
        if start is not None:
            ok &= ~np.isnan(start)
        rows = np.flatnonzero(ok)
        # sort by (stratum, -stop): strata contiguous, time DESC inside
        order = np.lexsort((-t[rows], strat[rows]))
        idx = rows[order]
        ts, es, ws = t[idx], e[idx], wcol[idx]
        ss = strat[idx]
        n = len(idx)
        P = di.nfeatures
        if P > 64:
            raise ValueError(
                "coxph: >64 expanded features would make the cumulative "
                "S2 risk-set tensor (N x P x P) exceed device memory; "
                "reduce features")
        X = di.make_matrix(frame)
        dev = X.device
        Xs = X[torch.as_tensor(idx, device=dev)]

        # stratum boundaries + tie blocks within stratum (run-length
        # structures of the (stratum, -time) order, read from flags)
        new_strat = np.concatenate([[True], ss[1:] != ss[:-1]])
        strat_id = np.cumsum(new_strat) - 1
        strat_first = np.flatnonzero(new_strat)[strat_id]
        new_tie = new_strat | np.concatenate([[True], ts[1:] != ts[:-1]])
        gid = np.cumsum(new_tie) - 1
        gstarts = np.flatnonzero(new_tie)
        group_last = np.concatenate([gstarts[1:] - 1, [n - 1]])
        tie_end = group_last[gid]
        tie_start = gstarts[gid]
        # within-group event rank + group event count (Efron)
        ev = es > 0
        cum_ev = np.cumsum(ev)
        ev_before = np.concatenate([[0], cum_ev[gstarts[1:] - 1]])[gid]
        grank = np.where(ev, cum_ev - 1 - ev_before, 0.0)
        gsize = (cum_ev[tie_end] - ev_before) * 1.0
        # counting-process second ordering (start DESC within stratum)
        use_start = start is not None
        if use_start:
            st = start[idx]
            perm2 = np.lexsort((-st, ss))
            st2 = st[perm2]
            ss2 = ss[perm2]
            # stratum offsets within the perm2 ordering
            uniq_s, s_starts = np.unique(ss2, return_index=True)
            lookup = dict(zip(uniq_s, s_starts))
            ends = dict(zip(uniq_s, np.append(s_starts[1:], n)))
            bstart = np.asarray([lookup[s] for s in ss], np.int64)
            # #{start >= t_i} within the stratum, per stratum
            bpos = np.zeros(n, np.int64)
            for s in uniq_s:
                lo, hi = lookup[s], ends[s]
                sel = ss == s
                bpos[sel] = lo + np.searchsorted(
                    -st2[lo:hi], -ts[sel], side="right")
        else:
            perm2 = np.zeros(n, np.int64)
            bpos = np.zeros(n, np.int64)
            bstart = np.zeros(n, np.int64)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)
        args = (f32(ws), f32(es), i64(tie_start), i64(tie_end),
                i64(strat_first), f32(grank), f32(gsize), i64(perm2),
                i64(bpos), i64(bstart))
        beta = np.zeros(P)
        nll = np.inf
        nll_prev = np.inf
        for it in range(p.max_iterations):
            nll, grad, hess = _cox_stats(
                Xs, *args, f32(beta), efron=p.ties == "efron",
                use_start=use_start)
            nll = float(nll)
            g2 = grad.cpu().numpy().astype(np.float64)
            H = hess.cpu().numpy().astype(np.float64)
            step = np.linalg.solve(H + 1e-8 * np.eye(P), g2)
            beta = beta + step
            job.update((it + 1) / p.max_iterations,
                       f"iter={it} -logPL={nll:.5g}")
            if abs(nll_prev - nll) < 1e-9 * max(abs(nll), 1.0):
                break
            nll_prev = nll

        model = CoxPHModel(job.dest_key or dkv.make_key(self.algo), p, di)
        # de-standardized coefficients for reporting
        coef = beta.copy()
        ci = 0
        for s in di.specs:
            if s.width == 1 and di.standardize:
                coef[ci] = beta[ci] / s.sigma
            ci += s.width
        model.output.update({
            "beta_std": beta, "coef": dict(zip(di.coef_names, coef)),
            "neg_log_partial_likelihood": nll, "iterations": it + 1,
            "n_events": int(np.sum(e[ok] > 0)), "ties": p.ties,
            "interaction_pairs": _interaction_list(p),
        })
        model.training_metrics = {
            "neg_log_partial_likelihood": nll,
            "concordance": model._concordance(frame)}
        return model
