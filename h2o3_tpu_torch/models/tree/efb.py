"""EFB: exclusive feature bundling, the wide/sparse tree path — the port of
``h2o3_tpu/models/tree/efb.py`` (LightGBM-style bundling; the reference
keeps the per-feature loop over its sparse chunks, water/fvec/NewChunk.java
CX chunks and XGBoost's CSR bridge).

Sparse features that are never non-default on the same row share one
working feature whose bin axis concatenates the members' non-default
bins, so a one-hot-wide frame collapses to a few ~nbins-wide bundles: the
histogram (``hist.hist_varbin`` / ``hist_uniform`` at the working bin
counts), the split search and the partition all run over fewer features.
Bundles exist only in the working space.  The split search unbundles:
member f's default-bin mass (its per-feature mode bin d_f) is
reconstructed as the leaf total minus f's packed slots, so every
candidate's gain is exact per original feature and the recorded tree
stores original (feature, threshold) pairs; traversal, export and serving
see an ordinary tree.  In working space a chosen split is a bin range with
an optional complement (``hist.partition_ranged``).

* ``plan_bundles``: a device prepass (``_plan_stats``: the NA count, the
  strided sample's mode bin, its non-default count and its bit-packed
  non-default mask), then the JAX package's greedy packing on the host;
* ``apply_bundles``: [F, N] codes -> [F_w, N] working codes;
* ``efb_maps``: the static maps of the mixed search (numpy, copied);
* ``best_splits_mixed``: the raw features through the records kernel
  (``hist.split_records``, its scalar form, then ``finish_splits``:
  bitwise the JAX package's XLA ``best_splits`` on integer-valued
  histograms), the bundled members' candidate scans in torch, as the JAX
  package computes them in XLA, and the raw/bundle choice per leaf.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import hist


class BundlePlan(NamedTuple):
    """A bundling decision (hashable: it keys ``efb_maps``' cache).

    ``working``: per working feature ``("raw", orig_idx, B_f)`` or
    ``("bundle", members)``, members a tuple of ``(orig_idx, start_slot,
    B_f, default_bin)``; a bundle's slot 0 is the shared all-default bin,
    member f owns slots ``[start_slot, start_slot + B_f - 2]`` holding its
    non-default original bins in ascending order (d_f skipped).
    """

    working: tuple
    bin_counts: tuple            # per working feature: bins in use

    @property
    def n_working(self) -> int:
        return len(self.working)


def _plan_stats(codes: torch.Tensor, nrows: int, S: int, stride: int,
                nbins: int):
    """The planner's device prepass over [F, padded] codes: per feature
    the NA count over the first ``nrows`` rows, the mode bin of the
    strided sample (the first maximum, as ``jnp.argmax``), the sample's
    non-default count and its non-default mask bit-packed 8 rows a byte
    (most significant bit first): one small fetch instead of the [F, S]
    sample."""
    F = codes.shape[0]
    sub = codes[:, :nrows:stride].long()
    na_cnt = (codes[:, :nrows] == nbins).sum(dim=1)
    counts = torch.zeros((F, nbins + 1), dtype=torch.int64,
                         device=codes.device)
    counts.scatter_add_(1, sub, torch.ones_like(sub))
    d_bin = torch.argmax(counts, dim=1)
    Z = sub != d_bin[:, None]
    nz = Z.sum(dim=1)
    S8 = (S + 7) // 8 * 8
    Zp8 = torch.nn.functional.pad(Z.to(torch.int32), (0, S8 - S)) \
        .view(F, S8 // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=codes.device)
    Zp = (Zp8 * weights).sum(dim=2).to(torch.uint8)
    return tuple(t.cpu().numpy() for t in (na_cnt, d_bin, nz, Zp))


def plan_bundles(codes, bin_counts, nbins: int, nrows: int,
                 sample: int = 16384, min_features: int = 32,
                 min_reduction: float = 0.85) -> Optional[BundlePlan]:
    """Greedy conflict-free packing of sparse features into bundles (the
    JAX package's ``plan_bundles``, field for field).

    ``codes``: [F, padded] bin codes (NA == nbins).  A feature's default
    bin is its sample mode bin; exclusivity (never two members non-default
    on one row) is checked on a strided ~``sample``-row subsample
    (LightGBM's greedy bundling with conflict budget 0 on the sample).
    Features with any NA among the first ``nrows`` rows, or non-default on
    more than half the sample, stay raw.  Returns None unless the packed
    histogram cost drops below ``min_reduction`` of the unbundled cost:
    bundling engages only where it wins.
    """
    F = len(bin_counts)
    if F < min_features:
        return None
    stride = max(1, -(-nrows // sample))
    S = len(range(0, nrows, stride))
    na_cnt, d_bin, nz, Zp = _plan_stats(codes, nrows, S, stride, nbins)
    d_bin = np.asarray(d_bin, np.int64)
    cand = [f for f in range(F)
            if na_cnt[f] == 0 and bin_counts[f] >= 2
            and d_bin[f] < nbins
            and bin_counts[f] - 1 <= nbins - 1
            and nz[f] <= 0.5 * S]
    if len(cand) < 4:
        return None
    # heaviest features first, each into the first conflict-free bundle
    # with slot room (width cap nbins, so bundles fit the B = nbins + 1
    # axis); every bundle is probed (a packed AND of ~S/8 bytes)
    order = sorted(cand, key=lambda f: -int(nz[f]))
    bundles = []           # [members: [(f, B_f, d_f)], packed mask, width]
    for f in order:
        need = bin_counts[f] - 1
        placed = False
        for b in bundles:
            if b[2] + need > nbins:
                continue
            if not np.bitwise_and(b[1], Zp[f]).any():
                b[0].append((f, bin_counts[f], int(d_bin[f])))
                b[1] |= Zp[f]
                b[2] += need
                placed = True
                break
        if not placed:
            bundles.append([[(f, bin_counts[f], int(d_bin[f]))],
                            Zp[f].copy(), 1 + need])
    bundled = {f for b in bundles if len(b[0]) > 1 for f, _, _ in b[0]}
    if not bundled:
        return None
    working, wbins = [], []
    for f in range(F):
        if f not in bundled:
            working.append(("raw", f, int(bin_counts[f])))
            wbins.append(int(bin_counts[f]))
    for b in bundles:
        if len(b[0]) > 1:
            # member starts in original-feature order (determinism)
            members, start = [], 1
            for f, bf, df in sorted(b[0]):
                members.append((f, start, int(bf), df))
                start += bf - 1
            working.append(("bundle", tuple(members)))
            wbins.append(start)

    def packed_cost(bcs):
        return sum(((min(b, nbins) + 2) + 7) // 8 * 8 for b in bcs)

    if packed_cost(wbins) > min_reduction * packed_cost(bin_counts):
        return None
    return BundlePlan(tuple(working), tuple(wbins))


def apply_bundles(codes: torch.Tensor, plan: BundlePlan,
                  nbins: int) -> torch.Tensor:
    """[F, N] original codes -> [F_w, N] int32 working codes.  A bundled
    member's code c maps to slot 0 where c is its default bin, else to
    start + c - (c > d_f); the bundle takes the highest-mapped member
    (LightGBM's conflict tolerance, for conflicts off the sample).  A
    member's NA code maps to the NA bin: the planner bundles no feature
    with an NA among the real rows, so this moves only the padding rows,
    which the JAX package maps past the bin axis."""
    pieces = []
    for w in plan.working:
        if w[0] == "raw":
            pieces.append(codes[w[1]].to(torch.int32))
            continue
        out = None
        for f, start, _, df in w[1]:
            c = codes[f]
            mapped = torch.where(c == df, 0, start + c - (c > df).to(c.dtype))
            mapped = torch.where(c == nbins, nbins, mapped)
            out = mapped if out is None else torch.maximum(out, mapped)
        pieces.append(out.to(torch.int32))
    return torch.stack(pieces)


@functools.lru_cache(maxsize=None)
def efb_maps(plan: BundlePlan, B: int):
    """The static working-space maps of the mixed search (numpy, the JAX
    package's ``efb_maps``).  The raw group: working and original indices.
    The bundle group, per slot s of the [Fb, B-1] regular-bin axis: the
    owning member's slot range [seg_a, seg_b), its original feature, the
    slot's original bin, its default bin, whether the default sits below
    the slot (addD: the default mass joins the left child), and the
    member's first slot above its default (candidate B's anchor: the cut
    right after the default bin)."""
    dense_w = [i for i, w in enumerate(plan.working) if w[0] == "raw"]
    dense_orig = [plan.working[i][1] for i in dense_w]
    bundle_w = [i for i, w in enumerate(plan.working) if w[0] == "bundle"]
    Fb = len(bundle_w)
    shape = (Fb, B - 1)
    seg_a = np.zeros(shape, np.int32)
    seg_b = np.zeros(shape, np.int32)
    ofeat = np.zeros(shape, np.int32)
    obin = np.zeros(shape, np.int32)
    dflt = np.zeros(shape, np.int32)
    addD = np.zeros(shape, bool)
    is_slot = np.zeros(shape, bool)
    is_candB = np.zeros(shape, bool)
    first_above = np.zeros(shape, np.int32)
    for j, wi in enumerate(bundle_w):
        for f, start, bf, df in plan.working[wi][1]:
            end = start + bf - 1
            nd_bins = [b for b in range(bf) if b != df]
            fa = start + sum(1 for b in nd_bins if b < df)
            for k, b in enumerate(nd_bins):
                s = start + k
                seg_a[j, s] = start
                seg_b[j, s] = end
                ofeat[j, s] = f
                obin[j, s] = b
                dflt[j, s] = df
                addD[j, s] = b > df
                is_slot[j, s] = True
                first_above[j, s] = fa
            if fa < end:
                is_candB[j, fa] = True
    return {
        "dense_w": np.asarray(dense_w, np.int32),
        "dense_orig": np.asarray(dense_orig, np.int32),
        "bundle_w": np.asarray(bundle_w, np.int32),
        "seg_a": seg_a, "seg_b": seg_b, "ofeat": ofeat, "obin": obin,
        "dflt": dflt, "addD": addD, "is_slot": is_slot,
        "is_candB": is_candB, "first_above": first_above,
    }


@functools.lru_cache(maxsize=64)
def _device_maps(plan: BundlePlan, B: int, device: str):
    return {k: torch.from_numpy(v).to(device)
            for k, v in efb_maps(plan, B).items()}


def best_splits_mixed(H, nbins: int, plan: BundlePlan, reg_lambda,
                      min_rows, min_split_improvement, feat_mask=None,
                      reg_alpha=0.0, gamma=0.0, min_child_weight=0.0):
    """Best split per leaf over a mixed working space (the JAX package's
    ``best_splits_mixed``, efb.py:256).

    ``H``: [3, L, F_w, B] working histogram.  The raw features take the
    exact search on their sub-block through the records kernel
    (``hist.fused_best_splits``); the bundled members are scanned per slot
    with the reconstructed default mass.  Returns (ofeat, obin, na_left,
    gain, valid, children, wfeat, lo, hi, inv): the first six in ORIGINAL
    feature space for the recorded tree, the last four in WORKING space
    for ``hist.partition_ranged``.  The parameters are scalars.
    """
    dev = H.device
    maps = _device_maps(plan, nbins + 1, str(dev))
    L = H.shape[1]
    # a Python scalar, not a device tensor: building one from the host
    # would copy from pageable memory and wait for the stream every level
    ninf = -torch.inf

    outs = []        # (gain, ofeat, obin, na_left, children, wfeat, lo,
    #                   hi, inv)
    if len(maps["dense_w"]):
        dw = maps["dense_w"].long()
        fm = feat_mask[:, dw] if feat_mask is not None else None
        feat_d, bin_d, nal_d, gain_d, _, ch_d = hist.fused_best_splits(
            H[:, :, dw, :].contiguous(), nbins, reg_lambda, min_rows,
            min_split_improvement, fm, reg_alpha, gamma, min_child_weight)
        fl = feat_d.long()
        outs.append((gain_d, maps["dense_orig"][fl], bin_d, nal_d, ch_d,
                     maps["dense_w"][fl], bin_d,
                     torch.full((L,), nbins, dtype=torch.int32, device=dev),
                     torch.zeros((L,), dtype=torch.bool, device=dev)))

    if len(maps["bundle_w"]):
        bw = maps["bundle_w"].long()
        Hb = H[:, :, bw, :]                         # [3, L, Fb, B]
        Fb, B = Hb.shape[-2], Hb.shape[-1]
        cums = torch.cumsum(Hb, dim=-1)
        tots = cums[..., -1]                        # [3, L, Fb]
        parent = hist._score(tots[0], tots[1], reg_lambda, reg_alpha)
        seg_a, seg_b = maps["seg_a"].long(), maps["seg_b"].long()
        first_above = maps["first_above"].long()
        is_slot, is_candB = maps["is_slot"], maps["is_candB"]
        addD = maps["addD"]
        a_idx = (seg_a - 1).clamp_min(0).expand(3, L, Fb, B - 1)
        b_idx = (seg_b - 1).clamp_min(0).expand(3, L, Fb, B - 1)
        cumA = cums.gather(-1, a_idx)
        cumB = cums.gather(-1, b_idx)
        P = cums[..., :-1] - cumA                   # member prefix incl. s
        S = cumB - cumA                             # member total
        tot = tots[..., None]
        D = tot - S                                 # default-in-f mass

        def gains(GL, HL, CL):
            GR, HR, CR = tot[0] - GL, tot[1] - HL, tot[2] - CL
            g = 0.5 * (hist._score(GL, HL, reg_lambda, reg_alpha)
                       + hist._score(GR, HR, reg_lambda, reg_alpha)
                       - parent[..., None]) - gamma
            ok = (CL >= min_rows) & (CR >= min_rows) & \
                (HL >= min_child_weight) & (HR >= min_child_weight)
            return torch.where(ok, g, ninf), (GL, HL, CL, GR, HR, CR)

        if feat_mask is not None:
            bm = feat_mask[:, bw][..., None]
        else:
            bm = torch.ones((L, Fb, 1), dtype=torch.bool, device=dev)
        aD = addD[None].to(H.dtype)
        # candidate A (cut after slot s's original bin): left = the
        # member's slots <= s, plus the default mass when d_f is below
        left = P + aD * D
        gA, chA = gains(left[0], left[1], left[2])
        gA = torch.where(is_slot[None] & bm, gA, ninf)
        # candidate B (cut right after the default bin), at the member's
        # first slot above its default: left = its slots below d_f + D
        sm1 = (torch.arange(B - 1, device=dev) - 1).clamp_min(0)
        cumS = cums.gather(-1, sm1.expand(3, L, Fb, B - 1))
        first = torch.arange(B - 1, device=dev) == seg_a[None]
        pex = torch.where(first, 0.0, cumS - cumA) + D
        gB, chB = gains(pex[0], pex[1], pex[2])
        gB = torch.where(is_candB[None] & bm, gB, ninf)

        def pick_best(gain3, ch3):
            flat = gain3.reshape(L, -1)
            best = torch.argmax(flat, dim=1)
            gsel = flat.gather(1, best[:, None])[:, 0]
            ch = torch.stack([c.reshape(L, -1).gather(1, best[:, None])[:, 0]
                              for c in ch3], dim=1)
            return gsel, best // (B - 1), best % (B - 1), ch

        gA_s, jA, sA, chA_s = pick_best(gA, chA)
        gB_s, jB, sB, chB_s = pick_best(gB, chB)
        # candidate A's partition: default above the cut -> the right
        # child is the member's tail range; default below -> the LEFT
        # child is its head range, as the complement (inv)
        aD_A = addD[jA, sA]
        loA = torch.where(aD_A, sA, seg_a[jA, sA] - 1)
        hiA = torch.where(aD_A, seg_b[jA, sA] - 1, sA)
        of, wl = maps["ofeat"], maps["bundle_w"]
        candA = (gA_s, of[jA, sA], maps["obin"][jA, sA], aD_A, chA_s,
                 wl[jA], loA, hiA, ~aD_A)
        # candidate B: right = the member's slots above its default
        candB = (gB_s, of[jB, sB], maps["dflt"][jB, sB],
                 torch.ones_like(aD_A), chB_s, wl[jB],
                 first_above[jB, sB] - 1, seg_b[jB, sB] - 1,
                 torch.zeros_like(aD_A))
        useB = gB_s > gA_s
        outs.append(tuple(
            torch.maximum(gA_s, gB_s) if i == 0 else
            torch.where(useB[:, None] if a.dim() == 2 else useB, b, a)
            for i, (a, b) in enumerate(zip(candA, candB))))

    if len(outs) == 1:
        out = outs[0]
    else:
        use_b = outs[1][0] > outs[0][0]
        out = tuple(torch.where(use_b[:, None] if a.dim() == 2 else use_b,
                                b, a) for a, b in zip(outs[0], outs[1]))
    gain, ofeat, obin, na_left, children, wfeat, lo, hi, inv = out
    # the leaf totals are the same under every working feature: working 0
    tot_all = H[:, :, 0, :].sum(dim=-1)                 # [3, L]
    valid = torch.isfinite(gain) & (gain > min_split_improvement) & \
        (tot_all[2] >= 2 * min_rows)
    zero = torch.zeros((), dtype=H.dtype, device=dev)
    children = torch.stack(
        [torch.where(valid, children[:, i], tot_all[i]) for i in range(3)]
        + [torch.where(valid, children[:, i], zero) for i in range(3, 6)],
        dim=1)
    return (ofeat.to(torch.int32), obin.to(torch.int32), na_left, gain,
            valid, children, wfeat.to(torch.int32), lo.to(torch.int32),
            hi.to(torch.int32), inv)
