"""Quantile binning: the feature-discretization prepass for histogram
trees — the port of ``h2o3_tpu/models/tree/binning.py``.

Each feature gets ``nbins`` regular bins; code ``nbins`` is the NA bin.
Categorical codes are their own bins, capped at ``nbins - 1``.  Numeric
edges are the exact masked quantiles of the JAX package's sketch, taken
with the same float32 arithmetic in the same order (``fit_bins``), so
codes and edges are bitwise those of the JAX package: a one-ulp edge
would move rows across a bin.  Codes are feature-major ``[F, padded]``
int32, the layout the histogram kernels read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ...frame.frame import Frame
from ...frame.vec import T_CAT


@dataclasses.dataclass
class BinnedFrame:
    """Device-resident binned design block + host-side bin metadata."""

    codes: torch.Tensor         # [F, padded_rows] int32 bin codes
    edges: List[np.ndarray]     # per-feature ascending split thresholds
    names: List[str]
    is_cat: List[bool]
    cat_domains: List[Optional[List[str]]]
    nbins: int                  # regular bins; code == nbins means NA

    @property
    def nfeatures(self) -> int:
        return len(self.names)

    @property
    def na_bin(self) -> int:
        return self.nbins

    @property
    def bin_counts(self) -> tuple:
        """Per-feature count of bins in use (codes < this)."""
        out = []
        for e, cat, dom in zip(self.edges, self.is_cat, self.cat_domains):
            if cat:
                out.append(max(min(len(dom or []) or 1, self.nbins), 1))
            else:
                out.append(min(len(e) + 1, self.nbins))
        return tuple(out)


def _sketch(X: torch.Tensor, w: torch.Tensor, n: int, nq: int):
    """Exact masked quantiles + min/max of a [C, padded] f32 block: the
    JAX package's ``_make_sketch_fn``.  Rows past ``n``, non-finite
    values and rows of weight <= 0 sort to the tail as +inf; quantile k
    interpolates position q_k * (m_c - 1) within the m_c valid rows."""
    C, padded = X.shape
    dev = X.device
    iota = torch.arange(padded, device=dev)[None, :]
    valid = (iota < n) & torch.isfinite(X) & (w[None, :] > 0)
    m = valid.sum(dim=1, dtype=torch.int32)                  # [C]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    Xs = torch.sort(torch.where(valid, X, inf), dim=1).values
    lo = torch.where(valid, X, inf).amin(dim=1)
    hi = torch.where(valid, X, -inf).amax(dim=1)
    qs = torch.arange(1, nq + 1, dtype=torch.float32, device=dev) \
        / torch.tensor(nq + 1, dtype=torch.float32, device=dev)
    mm1 = (m - 1).clamp_min(0)[:, None]                      # int32
    pos = qs[None, :] * mm1.to(torch.float32)                # [C, nq]
    p0 = torch.floor(pos).to(torch.int32)
    frac = pos - p0.to(torch.float32)
    v0 = torch.gather(Xs, 1, p0.long())
    v1 = torch.gather(Xs, 1, torch.minimum(p0 + 1, mm1).long())
    # XLA's CPU compiler contracts v0 * (1 - frac) + v1 * frac into
    # fma(v0, 1 - frac, v1 * frac).  The product of two f32 is exact in
    # f64, so one f64 add rounded to f32 gives the fused result (a double
    # rounding could differ only on an exact f32 halfway sum).
    edges = (v0.double() * (1 - frac).double()
             + (v1 * frac).double()).to(torch.float32)
    return edges, lo, hi, m


def fit_bins(frame: Frame, features: List[str], nbins: int = 64,
             sample: int = 1_000_000, seed: int = 0, weights=None,
             histogram_type: str = "quantiles_global") -> BinnedFrame:
    """Sketch each feature's bin edges and encode the frame as bin codes.

    ``histogram_type``: "quantiles_global" (default), "uniform_adaptive"
    (equal-width over the observed range) or "random" (uniform-random
    split points drawn once from ``seed``).  Quantiles are exact over
    all weight > 0 rows while the numeric stack fits a ~2 GB budget;
    beyond it a strided ``sample``-row subsample bounds the sort.
    """
    htype = histogram_type.lower().replace("_", "")
    if htype in ("auto", "quantilesglobal"):
        htype = "quantiles"
    elif htype == "uniformadaptive":
        htype = "uniform"
    elif htype != "random":
        raise ValueError(
            f"unknown histogram_type {histogram_type!r}: use "
            "QuantilesGlobal, UniformAdaptive or Random")
    rng = np.random.default_rng(seed)
    n = frame.nrows
    vecs = [frame.vec(name) for name in features]
    is_cat = [v.type == T_CAT for v in vecs]
    domains = [v.domain if c else None for v, c in zip(vecs, is_cat)]
    num_idx = [f for f, c in enumerate(is_cat) if not c]

    num_edges: dict = {}
    if num_idx:
        full_padded = int(vecs[num_idx[0]].data.shape[0])
        budget_rows = max(int(2e9) // (4 * len(num_idx)), sample)
        stride = 1 if full_padded <= budget_rows \
            else -(-full_padded // max(sample, 1))
        X = torch.stack([vecs[f].data[::stride].to(torch.float32)
                         for f in num_idx], dim=0)
        padded = int(X.shape[1])
        n_eff = min(-(-n // stride), padded)
        if weights is not None:
            wv = torch.as_tensor(weights, dtype=torch.float32,
                                 device=X.device)[::stride]
            if wv.shape[0] < padded:
                wv = torch.nn.functional.pad(wv, (0, padded - wv.shape[0]))
            wv = wv[:padded]
        else:
            wv = torch.ones((padded,), dtype=torch.float32, device=X.device)
        out = _sketch(X, wv, n_eff, nbins - 1)
        edges_q, lo, hi, m = (a.cpu().numpy().astype(np.float64)
                              for a in out)
        if weights is not None and stride > 1:
            # the strided subsample ran before the w > 0 mask: re-sketch
            # from the live rows when a column saw far fewer valid rows
            # than its own finite population could supply
            iota_ok = torch.arange(padded, device=X.device)[None, :] < n_eff
            fin = (torch.isfinite(X) & iota_ok).sum(dim=1).cpu().numpy()
            wl = torch.as_tensor(weights).cpu().numpy()[:n] > 0
            n_live = int(wl.sum())
            want = min(n_live, sample)
            starved = (m < np.maximum(want // 4, nbins)) & \
                (fin >= 2 * np.maximum(m, 1))
            if n_live and starved.any():
                idx = np.flatnonzero(wl)
                if len(idx) > sample:
                    idx = idx[:: -(-len(idx) // sample)]
                idx_d = torch.as_tensor(idx, device=X.device)
                X2 = torch.stack([vecs[f].data[idx_d].to(torch.float32)
                                  for f in num_idx], dim=0)
                out = _sketch(X2, torch.ones((len(idx),), dtype=torch.float32,
                                             device=X.device),
                              len(idx), nbins - 1)
                edges_q, lo, hi, m = (a.cpu().numpy().astype(np.float64)
                                      for a in out)
        for i, f in enumerate(num_idx):
            if m[i] == 0:
                e = np.zeros(0, dtype=np.float32)
            elif htype == "uniform":
                e = np.unique(np.linspace(lo[i], hi[i], nbins + 1)[1:-1]
                              .astype(np.float32))
            elif htype == "random":
                e = np.unique(np.sort(
                    rng.uniform(lo[i], hi[i], nbins - 1)).astype(np.float32))
            else:
                e = np.unique(edges_q[i].astype(np.float32))
                e = e[np.isfinite(e)]
            num_edges[f] = e

    edges_list = []
    for f, cat in enumerate(is_cat):
        if cat:
            card = vecs[f].cardinality
            edges_list.append(np.arange(
                0.5, min(card, nbins) - 0.5 + 1e-9, 1.0, dtype=np.float32))
        else:
            edges_list.append(num_edges[f])

    codes = encode_bins(frame, features, edges_list, is_cat, nbins)
    return BinnedFrame(codes=codes, edges=edges_list, names=list(features),
                       is_cat=is_cat, cat_domains=domains, nbins=nbins)


def edges_matrix(edges_list, nbins: int) -> np.ndarray:
    """Dense [F, nbins] threshold table for the split lookup: row f holds
    feature f's edges, right-padded by repeating the last edge."""
    F = len(edges_list)
    mat = np.zeros((F, nbins), np.float32)
    for f, e in enumerate(edges_list):
        if len(e):
            mat[f, : len(e)] = e
            mat[f, len(e):] = e[-1]
    return mat


def encode_bins(frame: Frame, features: List[str], edges_list, is_cat,
                nbins: int) -> torch.Tensor:
    """Columns -> int32 bin codes [F, padded].  Numerics: the count of
    edges <= x (searchsorted side="right"), NaN -> the NA bin.  Cats: the
    code clamped to ``nbins - 1``; a negative code or NaN -> the NA bin."""
    rows = []
    for name, e, cat in zip(features, edges_list, is_cat):
        x = frame.vec(name).data.to(torch.float32)
        nan = torch.isnan(x)
        if cat:
            xi = torch.where(nan, -1.0, x).to(torch.int32)
            c = torch.where(xi < 0, nbins, torch.clamp_max(xi, nbins - 1))
        else:
            et = torch.as_tensor(np.asarray(e, np.float32), device=x.device)
            c = torch.searchsorted(et, x.contiguous(), right=True) \
                if len(e) else torch.zeros_like(x, dtype=torch.int64)
            c = torch.where(nan, nbins, c)
        rows.append(c.to(torch.int32))
    return torch.stack(rows, dim=0)
