"""Uplift DRF: treatment-effect forests on the level kernels — the port of
``h2o3_tpu/models/tree/uplift.py`` (hex/tree/uplift/UpliftDRF.java, the
uplift histogram columns of hex/tree/DHistogram.java:80-85 and the
Divergence criteria KL, Euclidean and ChiSquared).

Prediction is p(y=1 | treated) - p(y=1 | control) per leaf, averaged over
the forest; quality is AUUC (qini) over the uplift ranking
(``metrics.uplift``).  The treatment is the last domain level of a
categorical column, else a value > 0.

The two arms share one leaf assignment and each keeps its own stat
planes (w y t, w t, w t) and (w y (1-t), w (1-t), w (1-t)) and its own
fixed-point scale: they ride the batched level histograms as K = 2
(``hist.make_batched_level_fn`` on dense levels,
``hist.make_batched_sparse_level_fn`` on node-sparse ones from
``sparse_depth_threshold``), one ``csrc/hist.cu`` launch per level for
both arms (``split_mode="fused"``), or a launch per arm
(``"separate"``), bitwise alike.  The divergence split search
(``_uplift_best_splits``) is plain torch, as it is XLA in the JAX
package.  With ``H2O3_TPU_AUTOTUNE`` off (the port has no autotuner yet)
the JAX package resolves the knobs as here: ``hist_mode`` "subtract",
``split_mode`` "fused", ``hist_layout`` "sparse".  Row samples and column
masks come from ``shared.draw_generator``; the JAX package draws by
threefry, so the two agree only on unsampled trains (``sample_rate=1``,
``mtries=-2``, the JAX package's parity setting).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ...frame.frame import Frame
from ...frame.vec import T_CAT, T_NUM, Vec
from ...runtime import dkv
from ...runtime.job import Job
from ..datainfo import DataInfo
from . import hist
from .binning import edges_matrix, fit_bins
from .shared import (SharedTree, SharedTreeModel, SharedTreeParameters,
                     StackedTrees, Tree, TreeList, _row_sample, _slot_maps,
                     draw_generator, resolve_hist_layout, resolve_hist_mode,
                     resolve_split_mode, sparse_geometry, split_column_mask,
                     traverse, varbin_kernel_engages)

_EPS = 1e-6


@dataclasses.dataclass
class UpliftDRFParameters(SharedTreeParameters):
    treatment_column: str = ""
    uplift_metric: str = "KL"            # KL | euclidean | chi_squared
    ntrees: int = 50
    max_depth: int = 10
    min_rows: float = 10.0
    sample_rate: float = 0.632
    mtries: int = -2                     # all features by default


def _divergence(pt, pc, metric: str):
    pt = pt.clamp(_EPS, 1 - _EPS)
    pc = pc.clamp(_EPS, 1 - _EPS)
    if metric == "KL":
        return pt * torch.log(pt / pc) + (1 - pt) * torch.log((1 - pt)
                                                              / (1 - pc))
    if metric == "euclidean":
        return (pt - pc) ** 2 + ((1 - pt) - (1 - pc)) ** 2
    if metric == "chi_squared":
        return (pt - pc) ** 2 / pc + ((1 - pt) - (1 - pc)) ** 2 / (1 - pc)
    raise ValueError(f"unknown uplift_metric {metric!r}")


def _uplift_best_splits(Ht, Hc, nbins: int, metric: str, min_rows: float,
                        feat_mask=None):
    """The best divergence-gain split per leaf (UpliftDRF's
    Divergence.value): gain = the rows-weighted divergence of the
    children less the parent's.

    ``Ht``/``Hc``: [3, L, F, B] planes (sum w y, sum w, sum w) of the
    treatment and control arms, B with the NA bin last (NA goes left).
    Prefix sums in sequential bin order (``hist._cumsum_seq``), so the
    CPU and the card agree bitwise.  Returns (feat, bin, valid, gain)."""
    stacked = torch.stack([Ht[0], Ht[1], Hc[0], Hc[1]])     # [4, L, F, B]
    folded = stacked[..., :-1].clone()                     # NA into bin 0
    folded[..., 0] += stacked[..., -1]
    cy1t, cnt, cy1c, cnc = hist._cumsum_seq(folded).unbind(0)
    tot_y1t, tot_nt = cy1t[..., -1], cnt[..., -1]          # [L, F]
    tot_y1c, tot_nc = cy1c[..., -1], cnc[..., -1]
    n_tot = tot_nt + tot_nc
    d_parent = _divergence(tot_y1t / tot_nt.clamp_min(_EPS),
                           tot_y1c / tot_nc.clamp_min(_EPS), metric)
    # split after bin b: left = bins <= b (b in [0, nbins-2])
    ly1t, lnt = cy1t[..., :-1], cnt[..., :-1]
    ly1c, lnc = cy1c[..., :-1], cnc[..., :-1]
    ry1t, rnt = tot_y1t[..., None] - ly1t, tot_nt[..., None] - lnt
    ry1c, rnc = tot_y1c[..., None] - ly1c, tot_nc[..., None] - lnc
    dl = _divergence(ly1t / lnt.clamp_min(_EPS), ly1c / lnc.clamp_min(_EPS),
                     metric)
    dr = _divergence(ry1t / rnt.clamp_min(_EPS), ry1c / rnc.clamp_min(_EPS),
                     metric)
    nl = lnt + lnc
    nr = rnt + rnc
    gain = (nl * dl + nr * dr) / n_tot[..., None].clamp_min(_EPS) \
        - d_parent[..., None]
    ok = (nl >= min_rows) & (nr >= min_rows) & (lnt > 0) & (lnc > 0) \
        & (rnt > 0) & (rnc > 0)
    gain = torch.where(ok, gain, -math.inf)
    if feat_mask is not None:
        m = feat_mask if feat_mask.dim() == 2 else feat_mask[None, :]
        gain = torch.where(m[..., None], gain, -math.inf)
    L = d_parent.shape[0]
    flat = gain.reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    feat = torch.div(best, nbins - 1, rounding_mode="floor").to(torch.int32)
    bin_ = (best % (nbins - 1)).to(torch.int32)
    valid = torch.isfinite(best_gain) & (best_gain > 0)
    return feat, bin_, valid, best_gain


def _leaf_probs(leaf, wv, y, treat, nseg: int):
    """Each final leaf's p(y=1 | treated) and p(y=1 | control) [nseg]
    (0 where an arm has no weight), from the four per-leaf sums taken in
    the histograms' int64 fixed point: exact, so alike on every run and
    device."""
    planes = torch.stack([wv * y * treat, wv * treat, wv * y * (1 - treat),
                          wv * (1 - treat)]).to(torch.float32)
    scale = hist.stat_scale(planes)                         # [2, 4]
    sums = torch.zeros((4, nseg), dtype=torch.int64, device=leaf.device) \
        .index_add_(1, leaf.long(), hist.quantize(planes, scale))
    y1t, nt, y1c, nc = (sums.double() * scale[1][:, None]).float()
    pt = torch.where(nt > 0, y1t / nt.clamp_min(_EPS), 0.0)
    pc = torch.where(nc > 0, y1c / nc.clamp_min(_EPS), 0.0)
    return pt.to(torch.float32), pc.to(torch.float32)


class UpliftDRFModel(SharedTreeModel):
    algo = "upliftdrf"
    exportable = False

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        """[N, 3]: uplift, p(y=1 | treated), p(y=1 | control)."""
        T = max(self.output["ntrees_trained"], 1)
        st_t: StackedTrees = self.output["stacked_pt"]
        st_c: StackedTrees = self.output["stacked_pc"]
        pt = traverse(st_t.levels, st_t.values, X) / T
        pc = traverse(st_c.levels, st_c.values, X) / T
        return torch.stack([pt - pc, pt, pc], dim=1)

    def predict(self, frame: Frame) -> Frame:
        raw = self._predict_raw(self._score_matrix(frame))[: frame.nrows] \
            .cpu().numpy()
        return Frame(["uplift_predict", "p_y1_ct1", "p_y1_ct0"],
                     [Vec.from_numpy(raw[:, j], T_NUM, device=frame.device)
                      for j in range(3)])

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        from ...metrics.uplift import uplift_metrics
        pred = self._predict_raw(self._score_matrix(frame))[: frame.nrows, 0]
        y = self.datainfo.response(frame)[: frame.nrows]
        treat = np.asarray(frame.vec(self.params.treatment_column)
                           .to_numpy(), np.float64)
        return uplift_metrics(pred.cpu().numpy(), y.cpu().numpy(), treat)


def _assert_same_trees(a, b, what: str, only_valid: bool) -> None:
    """The crosschecks' assert: two grows of the first tree,
    ``(levels, leaf)`` each, agree on valid, feature and threshold at
    every level (feature and threshold where valid when
    ``only_valid``: a dense level keeps candidate records on dead nodes,
    a sparse one drops their rows) and on the final leaf of every row."""
    for d, (la, lb) in enumerate(zip(a[0], b[0])):
        va, vb = la[3], lb[3]
        if not torch.equal(va, vb):
            raise AssertionError(f"{what}: uplift trees disagree on valid "
                                 f"at level {d}")
        for i, nm in ((0, "feat"), (1, "thr")):
            xa, xb = la[i], lb[i]
            if only_valid:
                xa, xb = torch.where(va, xa, 0), torch.where(vb, xb, 0)
            if not torch.equal(xa, xb):
                raise AssertionError(f"{what}: uplift trees disagree on "
                                     f"{nm} at level {d}")
    if not torch.equal(a[1], b[1]):
        raise AssertionError(f"{what}: uplift final leaf routing differs")


class UpliftDRF(SharedTree):
    """Treatment-effect forest — hex/tree/uplift/UpliftDRF."""

    algo = "upliftdrf"
    model_class = UpliftDRFModel
    standard_metrics = False

    def __init__(self, params: Optional[UpliftDRFParameters] = None, **kw):
        super().__init__(params or UpliftDRFParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        if not p.treatment_column:
            raise ValueError("upliftdrf requires treatment_column")
        return DataInfo.fit(
            frame, response_column=p.response_column,
            ignored_columns=tuple(p.ignored_columns)
            + (p.treatment_column,),
            weights_column=p.weights_column, standardize=False,
            missing_values_handling="mean_imputation",
            force_classification=True)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> UpliftDRFModel:
        p: UpliftDRFParameters = self.params
        dev = frame.device
        y = torch.nan_to_num(di.response(frame))
        w = di.weights(frame)
        tvec = frame.vec(p.treatment_column)
        if tvec.type == T_CAT:
            treat = (tvec.data == (len(tvec.domain) - 1)).to(torch.float32)
        else:
            treat = (torch.nan_to_num(tvec.data) > 0).to(torch.float32)
        binned = fit_bins(frame, [s.name for s in di.specs], nbins=p.nbins,
                          histogram_type=p.histogram_type,
                          seed=p.effective_seed())
        codes = binned.codes
        edges_mat = torch.from_numpy(
            edges_matrix(binned.edges, p.nbins)).to(dev)
        F, N = codes.shape
        B = p.nbins + 1
        hist_mode = resolve_hist_mode(p)
        split_mode = resolve_split_mode(p)
        hist_layout = resolve_hist_layout(p, hist_mode=hist_mode)
        if hist_layout == "check" and "check" in (hist_mode, split_mode):
            raise ValueError(
                "hist_layout='check' needs a resolved hist_mode/split_mode "
                "(run one crosscheck at a time)")
        use_varbin = varbin_kernel_engages(binned.bin_counts, p.nbins, F,
                                           dev)
        bc = tuple(binned.bin_counts) if use_varbin else None
        lcodes = hist.offset_codes(codes, bc, p.nbins) if use_varbin \
            else codes
        sparse_from0, A_lv, Ap_lv = sparse_geometry(
            p.max_depth, p.nbins, F, p.sparse_depth_threshold,
            "sparse" if hist_layout in ("sparse", "check") else "dense")
        # per level and arm count: the dense and the node-sparse level
        # histograms, built once
        dense_fns = {K: [hist.make_batched_level_fn(d, K, F, B, bc)
                         for d in range(p.max_depth)] for K in (1, 2)}
        sparse_fns = {K: {d: hist.make_batched_sparse_level_fn(
                              Ap_lv[d], A_lv[d], K, F, B, bc)
                          for d in range(sparse_from0, p.max_depth)}
                      for K in (1, 2)}
        col_rate = 1.0 if p.mtries == -2 else \
            max(min(p.mtries if p.mtries > 0 else int(np.sqrt(F)), F), 1) / F
        nbins = p.nbins

        def level_hist(d, arms, stats, scale, carry, batched, mode,
                       sparse=None):
            """Level d's [2, 3, L, F, B] histograms of both arms: one
            launch (``batched``) or one per arm, each arm on its own
            scale row."""
            def run(k0, k1):
                st, sc = stats[k0:k1], scale[k0:k1]
                cr = None if carry is None else carry[k0:k1]
                K = k1 - k0
                if sparse is not None:
                    sleaf, ps = sparse
                    return sparse_fns[K][d](
                        lcodes, sleaf.expand(K, N), st, cr,
                        ps.expand(K, ps.shape[1]), sc)[0]
                if mode == "full":
                    return hist.local_hist(lcodes, arms[:K], st, 2 ** d, F,
                                           B, bc, sc)
                return dense_fns[K][d](lcodes, arms[:K], st, cr, sc)[0]
            if batched:
                return run(0, 2)
            return torch.cat([run(0, 1), run(1, 2)])

        def grow_tree(wv, gen, mode, batched, layout):
            """One uplift tree's level loop; returns (levels, leaf)."""
            leaf = torch.zeros(N, dtype=torch.int32, device=dev)
            levels = []
            # terminality: a dead node's descendants stay dead
            alive = torch.ones(1, dtype=torch.bool, device=dev)
            stats = torch.stack([
                torch.stack([wv * y * treat, wv * treat, wv * treat]),
                torch.stack([wv * y * (1 - treat), wv * (1 - treat),
                             wv * (1 - treat)])]).to(torch.float32)
            scale = hist.stat_scale(stats)                   # [2, 2, 3]
            sparse_from = sparse_from0 if (layout == "sparse"
                                           and mode == "subtract") \
                else p.max_depth
            carry = None
            valid = valid_s = slot_of_leaf = leaf_of_slot = None
            sleaf = right = None
            for d in range(p.max_depth):
                L = 2 ** d
                mask = split_column_mask(L, F, col_rate, gen) \
                    if col_rate < 1.0 else None
                if d >= sparse_from:
                    A = A_lv[d]
                    if d == sparse_from:
                        (child_base, ps_of_slot, real, slot_of_leaf,
                         leaf_of_slot) = _slot_maps(d, A, valid[None], None,
                                                    None)
                        sleaf = slot_of_leaf.gather(1, leaf[None].long())
                    else:
                        (child_base, ps_of_slot, real, slot_of_leaf,
                         leaf_of_slot) = _slot_maps(d, A, valid_s[None],
                                                    slot_of_leaf,
                                                    leaf_of_slot)
                        sleaf = torch.clamp_max(
                            child_base.gather(1, sleaf) + right, A)
                    H = level_hist(d, None, stats, scale, carry, batched,
                                   mode, sparse=(sleaf, ps_of_slot))
                    carry = H
                    mask_s = None if mask is None else mask[leaf_of_slot[0]]
                    feat_s, bin_s, valid_s, _ = _uplift_best_splits(
                        H[0], H[1], nbins, p.uplift_metric, p.min_rows,
                        mask_s)
                    # slots past the live ones carry no rows
                    valid_s = valid_s & real[0]
                    na_s = torch.ones_like(valid_s)
                    # the slot records expanded to the dense [2^d] level
                    sol = slot_of_leaf[0]
                    mapped = sol < A
                    slc = sol.clamp_max(A - 1)
                    feat = torch.where(mapped, feat_s[slc], 0)
                    bin_ = torch.where(mapped, bin_s[slc], 0)
                    valid = mapped & valid_s[slc]
                    thr = edges_mat[feat.long(),
                                    bin_.clamp(0, nbins - 1).long()]
                    tables = [torch.cat([x, torch.zeros_like(x[:1])])
                              for x in (feat_s, bin_s, na_s, valid_s)]
                    right = hist.partition_right(codes, sleaf[0], *tables,
                                                 nbins)[None].long()
                    leaf = (2 * leaf + right[0].to(torch.int32)) \
                        .to(torch.int32)
                    levels.append((feat, thr, torch.ones_like(valid), valid))
                    continue
                arms = leaf[None].expand(2, N)
                H = level_hist(d, arms, stats, scale, carry, batched, mode)
                carry = H
                feat, bin_, valid, _ = _uplift_best_splits(
                    H[0], H[1], nbins, p.uplift_metric, p.min_rows, mask)
                valid = valid & alive
                alive = valid.repeat_interleave(2)
                na_left = torch.ones_like(valid)
                thr = edges_mat[feat.long(), bin_.clamp(0, nbins - 1).long()]
                leaf = hist.partition(codes, leaf, feat, bin_, na_left, valid,
                                      nbins)
                levels.append((feat, thr, na_left, valid))
            return levels, leaf

        seed = p.effective_seed()
        hm = "full" if hist_mode == "full" else "subtract"
        trees_t: List[Tree] = []
        trees_c: List[Tree] = []
        for t_i in range(p.ntrees):
            wv = _row_sample(w, p.sample_rate, seed, 0, t_i)

            def grow(mode=hm, batched=None, layout=None):
                # every grow of a tree draws its column masks afresh from
                # the tree's generator, so crosscheck grows draw alike
                gen = draw_generator(seed, 0, t_i, 0, dev)
                return grow_tree(
                    wv, gen, mode,
                    split_mode != "separate" if batched is None else batched,
                    hist_layout if layout is None else layout)
            if t_i == 0 and hist_layout == "check":
                # dense and node-sparse layouts must grow the same tree
                res = grow(layout="sparse")
                _assert_same_trees(res, grow(layout="dense"),
                                   "hist_layout='check'", only_valid=True)
                hist_layout = "sparse"
            elif t_i == 0 and hist_mode == "check":
                res = grow(mode="subtract", layout="dense")
                _assert_same_trees(res, grow(mode="full", layout="dense"),
                                   "hist_mode='check'", only_valid=False)
            elif t_i == 0 and split_mode == "check":
                res = grow(batched=True)
                _assert_same_trees(res, grow(batched=False),
                                   "split_mode='check'", only_valid=False)
                split_mode = "fused"
            else:
                res = grow(layout="sparse" if hist_layout == "sparse"
                           else "dense")
            levels, leaf = res
            pt_vals, pc_vals = _leaf_probs(leaf, wv, y, treat,
                                           2 ** p.max_depth)
            per = [[lv[i] for lv in levels] for i in range(4)]
            trees_t.append(Tree(*per, pt_vals))
            trees_c.append(Tree(*per, pc_vals))
            job.update((t_i + 1) / p.ntrees, f"tree {t_i + 1}/{p.ntrees}")

        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        model.output["stacked_pt"] = StackedTrees.from_trees(trees_t)
        model.output["stacked_pc"] = StackedTrees.from_trees(trees_c)
        model.output["trees"] = TreeList(model.output["stacked_pt"])
        model.output["ntrees_trained"] = p.ntrees
        model.output["edges"] = binned.edges
        model.output["init_score"] = 0.0
        model.output["nclass_trees"] = 1
        model.output["hist_layout"] = hist_layout
        model.output["hist_kernel"] = "varbin" if use_varbin else "uniform"
        model.output["tree_program"] = "level"

        from ...metrics.uplift import uplift_metrics
        pred = model._predict_raw(model._design(frame))[: frame.nrows, 0]
        model.training_metrics = uplift_metrics(
            pred.cpu().numpy(), y[: frame.nrows].cpu().numpy(),
            treat[: frame.nrows].cpu().numpy())
        return model
