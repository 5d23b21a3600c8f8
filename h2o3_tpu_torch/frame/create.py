"""Frame synthesis and munging utilities behind small REST handlers — the
port of ``h2o3_tpu/frame/create.py``.

Reference handlers: ``water/api/CreateFrameHandler.java`` (h2o.create_frame
random frames), ``MissingInserterHandler.java`` (NA injection),
``InteractionHandler.java`` (categorical interaction columns,
``hex/Interaction.java``), ``TabulateHandler.java`` (``hex/Tabulate.java``
2-column co-occurrence + response means), ``DCTTransformerHandler.java``
(``hex/DCTTransformer.java``).

The draws are numpy's, in the JAX package's order, so a seed gives its
frames bit for bit; the frames land on ``device`` (``cuda`` unless
named; a derived frame on its source's device).  The DCT is a dense
cosine-basis product per axis in float32 on the device (the reference
loops per element); tabulation counts on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import torch

from ..runtime import dkv
from ..runtime.device import resolve_device
from .frame import Frame
from .vec import T_CAT, T_NUM, T_STR, T_TIME, Vec


def create_frame(rows: int = 10_000, cols: int = 10,
                 randomize: bool = True, value: float = 0.0,
                 real_range: float = 100.0,
                 categorical_fraction: float = 0.2, factors: int = 100,
                 integer_fraction: float = 0.2, integer_range: int = 100,
                 binary_fraction: float = 0.1, binary_ones_fraction: float = 0.02,
                 time_fraction: float = 0.0, string_fraction: float = 0.0,
                 missing_fraction: float = 0.01,
                 has_response: bool = False, response_factors: int = 2,
                 positive_response: bool = False, seed: Optional[int] = None,
                 destination_frame: Optional[str] = None,
                 device=None) -> Frame:
    """h2o.create_frame analog (CreateFrameHandler/CreateFrame.java), on
    ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    fracs = (categorical_fraction + integer_fraction + binary_fraction
             + time_fraction + string_fraction)
    if fracs > 1.0 + 1e-9:
        raise ValueError("column-type fractions sum past 1.0")
    rng = np.random.default_rng(seed)
    counts = {
        "cat": int(round(cols * categorical_fraction)),
        "int": int(round(cols * integer_fraction)),
        "bin": int(round(cols * binary_fraction)),
        "time": int(round(cols * time_fraction)),
        "str": int(round(cols * string_fraction)),
    }
    counts["real"] = cols - sum(counts.values())
    if counts["real"] < 0:
        raise ValueError("column-type fractions produce negative real count")
    names: List[str] = []
    vecs: List[Vec] = []

    def _with_missing(arr: np.ndarray) -> np.ndarray:
        if missing_fraction > 0:
            mask = rng.random(rows) < missing_fraction
            arr = arr.astype(np.float64)
            arr[mask] = np.nan
        return arr

    j = 0
    for _ in range(counts["real"]):
        vals = (rng.uniform(-real_range, real_range, rows) if randomize
                else np.full(rows, value))
        vecs.append(Vec.from_numpy(_with_missing(vals), T_NUM,
                                   device=device))
        names.append(f"C{(j := j + 1)}")
    for _ in range(counts["int"]):
        vals = rng.integers(-integer_range, integer_range + 1,
                            rows).astype(np.float64)
        vecs.append(Vec.from_numpy(_with_missing(vals), T_NUM,
                                   device=device))
        names.append(f"C{(j := j + 1)}")
    for _ in range(counts["bin"]):
        vals = (rng.random(rows) < binary_ones_fraction).astype(np.float64)
        vecs.append(Vec.from_numpy(_with_missing(vals), T_NUM,
                                   device=device))
        names.append(f"C{(j := j + 1)}")
    for _ in range(counts["time"]):
        base = 1_500_000_000_000.0
        vals = base + rng.uniform(0, 3.15e10, rows)
        vecs.append(Vec.from_numpy(_with_missing(vals), T_TIME,
                                   device=device))
        names.append(f"C{(j := j + 1)}")
    for _ in range(counts["cat"]):
        codes = rng.integers(0, max(factors, 1), rows).astype(np.int32)
        if missing_fraction > 0:
            codes = np.where(rng.random(rows) < missing_fraction,
                             -1, codes).astype(np.int32)
        dom = [f"c{i}.l{k}" for i, k in
               zip([j] * factors, range(factors))]
        vecs.append(Vec.from_numpy(codes, T_CAT, domain=dom,
                                   device=device))
        names.append(f"C{(j := j + 1)}")
    for _ in range(counts["str"]):
        host = np.array([f"s{rng.integers(0, 1 << 30):x}"
                         for _ in range(rows)], dtype=object)
        vecs.append(Vec(None, T_STR, rows, host_data=host))
        names.append(f"C{(j := j + 1)}")
    if has_response:
        if response_factors > 1:
            codes = rng.integers(0, response_factors, rows).astype(np.int32)
            dom = [f"level{k}" for k in range(response_factors)]
            vecs.insert(0, Vec.from_numpy(codes, T_CAT, domain=dom,
                                          device=device))
        else:
            vals = rng.uniform(0 if positive_response else -real_range,
                               real_range, rows)
            vecs.insert(0, Vec.from_numpy(vals, T_NUM, device=device))
        names.insert(0, "response")
    key = destination_frame or dkv.make_key("createframe")
    return Frame(names, vecs, key=key)


def insert_missing_values(frame: Frame, fraction: float = 0.1,
                          seed: Optional[int] = None) -> Frame:
    """In-place NA injection — MissingInserterHandler analog."""
    rng = np.random.default_rng(seed)
    new_vecs = []
    for vec in frame.vecs:
        if vec.data is None:                   # string vecs: host path
            host = vec.host_data.copy()
            host[rng.random(frame.nrows) < fraction] = None
            new_vecs.append(Vec(None, vec.type, vec.nrows, host_data=host))
            continue
        vals = vec.to_numpy().copy()
        mask = rng.random(len(vals)) < fraction
        if vec.type == T_CAT:
            vals = np.where(mask, -1, vals).astype(np.int32)
            new_vecs.append(Vec.from_numpy(vals, T_CAT, domain=vec.domain,
                                           device=frame.device))
        else:
            vals = vals.astype(np.float64)
            vals[mask] = np.nan
            new_vecs.append(Vec.from_numpy(vals, vec.type,
                                           device=frame.device))
    out = Frame(frame.names, new_vecs, key=None)
    out.key = frame.key
    if frame.key:
        dkv.put(frame.key, out)
    return out


def interaction(frame: Frame, factor_columns: Sequence[str],
                pairwise: bool = False, max_factors: int = 100,
                min_occurrence: int = 1,
                destination_frame: Optional[str] = None) -> Frame:
    """Categorical interaction features — hex/Interaction.java analog.

    Combines the named factor columns into one interaction column (or all
    pairwise combinations), keeping the ``max_factors`` most frequent
    combined levels (rest pooled into ``other``).
    """
    cols = list(factor_columns)
    if len(cols) < 2:
        raise ValueError("interaction needs >= 2 factor columns")
    for c in cols:
        if frame.vec(c).type != T_CAT:
            raise ValueError(f"interaction column {c!r} is not categorical")
    groups = ([(a, b) for i, a in enumerate(cols) for b in cols[i + 1:]]
              if pairwise else [tuple(cols)])
    names: List[str] = []
    vecs: List[Vec] = []
    for group in groups:
        gvecs = [frame.vec(c) for c in group]
        codes = [np.asarray(v.to_numpy()).astype(np.int64) for v in gvecs]
        doms = [v.domain or [] for v in gvecs]
        combo = np.zeros(frame.nrows, np.int64)
        valid = np.ones(frame.nrows, bool)
        for c, d in zip(codes, doms):
            combo = combo * max(len(d), 1) + np.clip(c, 0, None)
            valid &= c >= 0
        labels = {}
        for idx in np.flatnonzero(valid):
            labels.setdefault(int(combo[idx]), 0)
            labels[int(combo[idx])] += 1
        kept = [k for k, n in sorted(labels.items(),
                                     key=lambda kv: -kv[1])
                if n >= min_occurrence][:max_factors]
        kept_set = {k: i for i, k in enumerate(kept)}

        def decode(k: int) -> str:
            parts = []
            for d in reversed(doms):
                parts.append(str(d[k % max(len(d), 1)]))
                k //= max(len(d), 1)
            return "_".join(reversed(parts))

        domain = [decode(k) for k in kept]
        other = len(domain)
        has_other = len(labels) > len(kept)
        if has_other:
            domain = domain + ["other"]
        out_codes = np.full(frame.nrows, -1, np.int32)
        for idx in np.flatnonzero(valid):
            out_codes[idx] = kept_set.get(int(combo[idx]), other)
        vecs.append(Vec.from_numpy(out_codes, T_CAT, domain=domain,
                                   device=frame.device))
        names.append("_".join(group))
    key = destination_frame or dkv.make_key("interaction")
    return Frame(names, vecs, key=key)


def tabulate(frame: Frame, predictor: str, response: str,
             weights_column: Optional[str] = None,
             nbins_predictor: int = 20, nbins_response: int = 10) -> dict:
    """2-column co-occurrence counts + per-level response means —
    hex/Tabulate.java.  Numerics are equal-width binned; the cross table
    is a one-hot x one-hot product (device-friendly form)."""
    def _binned(name: str, nbins: int):
        vec = frame.vec(name)
        vals = np.asarray(vec.to_numpy(), np.float64)
        if vec.type == T_CAT:
            labels = list(vec.domain or [])
            return np.clip(vals, -1, len(labels) - 1).astype(int), labels
        finite = vals[np.isfinite(vals)]
        lo, hi = (float(finite.min()), float(finite.max())) if finite.size \
            else (0.0, 1.0)
        width = (hi - lo) / nbins or 1.0
        safe = np.where(np.isfinite(vals), vals, lo)
        codes = np.where(np.isfinite(vals),
                         np.clip(((safe - lo) / width).astype(int), 0,
                                 nbins - 1), -1)
        labels = [f"[{lo + i * width:.4g}, {lo + (i + 1) * width:.4g})"
                  for i in range(nbins)]
        return codes, labels

    pc, plabels = _binned(predictor, nbins_predictor)
    rc, rlabels = _binned(response, nbins_response)
    w = (np.asarray(frame.vec(weights_column).to_numpy(), np.float64)
         if weights_column else np.ones(frame.nrows))
    P, R = len(plabels), len(rlabels)
    counts = np.zeros((P, R))
    ok = (pc >= 0) & (rc >= 0)
    np.add.at(counts, (pc[ok], rc[ok]), w[ok])
    rvec = frame.vec(response)
    rvals = np.asarray(rvec.to_numpy(), np.float64)
    sums = np.zeros(P)
    wsum = np.zeros(P)
    np.add.at(sums, pc[ok], (rvals * w)[ok])
    np.add.at(wsum, pc[ok], w[ok])
    with np.errstate(invalid="ignore"):
        means = np.where(wsum > 0, sums / wsum, np.nan)
    return {
        "predictor": predictor, "response": response,
        "predictor_levels": plabels, "response_levels": rlabels,
        "count_table": counts.tolist(),
        "response_table": [[lvl, float(m) if np.isfinite(m) else None,
                            float(ws)]
                           for lvl, m, ws in zip(plabels, means, wsum)],
    }


def dct_transform(frame: Frame, dimensions: Sequence[int],
                  inverse: bool = False,
                  destination_frame: Optional[str] = None) -> Frame:
    """Orthonormal DCT-II along each spatial dimension of row-major
    [height, width, depth] columns — hex/DCTTransformer.java.

    The transform is a dense cosine-basis product per axis
    (kron-structured), one float32 einsum on the frame's device.
    """
    dims = [int(d) for d in dimensions]
    while len(dims) < 3:
        dims.append(1)
    h, w, d = dims[:3]
    if h * w * d != frame.ncols:
        raise ValueError(f"dimensions {h}x{w}x{d} != ncols {frame.ncols}")

    def basis(n: int) -> np.ndarray:
        k = np.arange(n)[:, None]
        i = np.arange(n)[None, :]
        B = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
        B[0] /= np.sqrt(2.0)
        return B

    X = np.stack([np.asarray(v.to_numpy(), np.float64)
                  for v in frame.vecs], axis=1)
    N = X.shape[0]
    T = X.reshape(N, h, w, d)
    Bh, Bw, Bd = basis(h), basis(w), basis(d)
    if inverse:
        Bh, Bw, Bd = Bh.T, Bw.T, Bd.T
    dev = frame.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    out = torch.einsum("nhwd,Hh,Ww,Dd->nHWD", f32(T), f32(Bh), f32(Bw),
                       f32(Bd))
    out = out.cpu().numpy().reshape(N, h * w * d)
    vecs = [Vec.from_numpy(out[:, jcol], T_NUM, device=dev)
            for jcol in range(out.shape[1])]
    names = [f"DCT_{i}" for i in range(out.shape[1])]
    key = destination_frame or dkv.make_key("dct")
    return Frame(names, vecs, key=key)
