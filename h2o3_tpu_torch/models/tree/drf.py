"""DRF: distributed random forest on the level kernels — the port of
``h2o3_tpu/models/tree/drf.py`` (hex/tree/drf/DRF.java:30).

The bootstrap + mtries variant of SharedTree: each tree trains on a row
sample (rate 1 - 1/e by default) with a random feature subset per split
(mtries), and the forest predicts the average of its trees' leaf
estimates (class probability or mean response).  As in the JAX package
the mean fit rides GBM's Newton machinery with g = -y, h = 1 (a leaf's
value is sum(w y) / sum(w)), mtries is the per-split column rate, and the
trees average instead of summing (initial score 0, divided by T).

At its defaults (``max_depth=20``, ``min_rows=1``) a forest grows past
the node-sparse threshold: ``hist_layout="auto"`` resolves to "sparse",
so its deep levels run over slots of alive nodes.  A response of K > 2
classes grows K class trees a round, each fitting its one-hot column, as
one batched build (``split_mode="fused"``: one histogram launch and one
records launch per level whatever K is) or as a loop of K single builds
(``"separate"``), bitwise alike; the K trees share the round's row
sample.  Under ``tree_program="scan"`` (dense levels: ``hist_layout=
"dense"`` or a depth within ``sparse_depth_threshold``) each tree or
round is the whole-tree program.  A wide sparse frame trains on EFB's
bundled working codes
(``shared.maybe_bundle``, as in the JAX package): the dense layout with
its depth cap, mtries resolved against the working features, and the K
class trees as a loop of single builds.  Not ported here: checkpoints and
continuation, progress snapshots and fault injection (runtime planes),
and the autotuner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...frame.frame import Frame
from ...metrics.core import make_metrics
from ...runtime import dkv
from ...runtime.job import Job
from ..datainfo import DataInfo
from ..scorekeeper import metric_direction, stop_early
from .binning import edges_matrix, fit_bins
from .shared import (SharedTree, SharedTreeModel, SharedTreeParameters,
                     StackedTrees, TreeList, chunk_schedule, efb_bundles,
                     make_multinomial_scan_fn, make_tree_scan_fn,
                     maybe_bundle, record_effective_depth,
                     resolve_hist_layout,
                     resolve_hist_mode, resolve_split_mode,
                     resolve_tree_program, run_hist_crosscheck,
                     run_layout_crosscheck, run_program_crosscheck,
                     run_split_crosscheck, traverse,
                     use_hier_split_search)


@dataclasses.dataclass
class DRFParameters(SharedTreeParameters):
    ntrees: int = 50
    max_depth: int = 20
    min_rows: float = 1.0
    sample_rate: float = 0.632           # DRF.java default (1 - 1/e)
    mtries: int = -1                     # -1: sqrt(F) cls / F/3 reg
    learn_rate: float = 1.0              # no shrinkage in a forest


def _avg_to_preds(avg: torch.Tensor, di: DataInfo, K: int) -> torch.Tensor:
    """The forest's average scores -> predictions: K class probabilities
    (clipped to [0, 1] and normalised) from [N, K], [N, 2] for binomial,
    the mean response otherwise."""
    if di.is_classifier and K > 1:
        pr = avg.clamp(0.0, 1.0)
        return pr / pr.sum(dim=1, keepdim=True).clamp_min(1e-12)
    if di.is_classifier:
        p1 = avg.clamp(0.0, 1.0)
        return torch.stack([1 - p1, p1], dim=1)
    return avg


class DRFModel(SharedTreeModel):
    algo = "drf"
    tree_average = True

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        K = self.output.get("nclass_trees", 1)
        T = self.output["ntrees_trained"]
        return _avg_to_preds(self._raw_scores(X) / max(T, 1),
                             self.datainfo, K)


class DRF(SharedTree):
    algo = "drf"
    model_class = DRFModel
    # stays on the wave path, as in the JAX package: the forest's
    # per-class bootstrap sharing differs from the GBM chunk loop the
    # batched cohort trainer mirrors
    _grid_batchable = False

    def __init__(self, params: Optional[DRFParameters] = None, **kw):
        super().__init__(params or DRFParameters(**kw))
        resolve_hist_mode(self.params)        # fail fast on a bad knob
        resolve_split_mode(self.params)
        resolve_hist_layout(self.params)
        resolve_tree_program(self.params)

    def _col_rate(self, Fw: int, classifier: bool) -> float:
        """mtries -> the per-split column rate over the working features
        (-1: sqrt(F) for classification, F/3 for regression; -2: all).
        Under a bundle plan the masks are drawn over the working features,
        so the rate is resolved against their count, as in the JAX
        package (a rate from the original count would leave ~1 feature a
        split)."""
        mt = self.params.mtries
        if mt == -1:
            m = math.isqrt(Fw) if classifier else max(Fw // 3, 1)
            return max(min(m, Fw), 1) / Fw
        if mt == -2:
            return 1.0
        return max(min(mt, Fw), 1) / Fw

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> DRFModel:
        p: DRFParameters = self.params
        K = di.nclasses if di.is_classifier and di.nclasses > 2 else 1
        dev = frame.device
        y, w = di.response(frame), di.weights(frame)
        binned = fit_bins(frame, [s.name for s in di.specs], nbins=p.nbins,
                          seed=p.effective_seed(),
                          weights=w if p.weights_column else None,
                          histogram_type=p.histogram_type)
        edges_mat = torch.from_numpy(
            edges_matrix(binned.edges, p.nbins)).to(dev)
        y = torch.where(torch.isnan(y), 0.0, y)
        plan, codes, Fw, wbin_counts = maybe_bundle(binned, p, None,
                                                    frame.nrows)
        N = codes.shape[1]
        hier = use_hier_split_search(p)
        hist_mode = resolve_hist_mode(p)
        split_mode = resolve_split_mode(p, plan=plan, hier=hier)
        hist_layout = resolve_hist_layout(p, hist_mode=hist_mode, plan=plan,
                                          hier=hier)
        tree_program = resolve_tree_program(
            p, hist_layout=hist_layout, plan=plan, hier=hier,
            bin_counts=wbin_counts, F=Fw, n_padded=N, device=dev)
        seed = p.effective_seed()
        col_rate = self._col_rate(Fw, di.is_classifier)

        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        if plan is not None:
            model.output["efb_bundles"] = efb_bundles(plan)
        model.output["nclass_trees"] = K
        model.output["binning"] = {"nbins": p.nbins}
        model.output["tree_program"] = tree_program
        model.output["split_search"] = "hier" if hier else "exact"
        record_effective_depth(model, p, Fw, N, hist_layout=hist_layout)

        # the class-major [K, N] one-hot targets of K class trees, or y
        if K > 1:
            target = torch.nn.functional.one_hot(
                y.long().clamp(0, K - 1), K).t().to(torch.float32)
        else:
            target = y
        F_sum = torch.zeros_like(target)
        if valid is not None:
            Xv = model._design(valid)
            y_v, w_v = di.response(valid), di.weights(valid)
            F_v = torch.zeros((K, Xv.shape[0]) if K > 1 else (Xv.shape[0],),
                              dtype=torch.float32, device=dev)

        if "check" in (hist_mode, split_mode, hist_layout, tree_program):
            # the crosschecks on the forest's mean-fit gradients (g = -y,
            # h = 1), the K class trees as one batched build; training
            # then takes the subtraction path, the fused records, the
            # node-sparse levels and the whole-tree program
            kw = dict(max_depth=p.max_depth, nbins=p.nbins, F=Fw,
                      n_padded=N, bin_counts=wbin_counts,
                      reg_lambda=p.reg_lambda, min_rows=p.min_rows,
                      min_split_improvement=p.min_split_improvement,
                      learn_rate=1.0, reg_alpha=p.reg_alpha, gamma=p.gamma,
                      min_child_weight=p.min_child_weight, nk=K)
            g0, h0 = -target * w, w.expand_as(target)
            if hist_mode == "check":
                run_hist_crosscheck(codes, g0, h0, w, edges_mat, seed,
                                    plan=plan, **kw)
                hist_mode = "subtract"
            if split_mode == "check":
                run_split_crosscheck(codes, g0, h0, w, edges_mat, seed,
                                     hist_mode=hist_mode,
                                     col_sample_rate=col_rate, **kw)
                split_mode = "fused"
            if hist_layout == "check":
                run_layout_crosscheck(
                    codes, g0, h0, w, edges_mat, seed,
                    sparse_depth_threshold=p.sparse_depth_threshold,
                    col_sample_rate=col_rate, **kw)
                hist_layout = "sparse"
                model.output["hist_layout"] = hist_layout
            if tree_program == "check":
                run_program_crosscheck(
                    codes, g0, h0, w, edges_mat, seed, hist_mode=hist_mode,
                    split_mode=split_mode, col_sample_rate=col_rate,
                    **{k: v for k, v in kw.items() if k != "bin_counts"})
                tree_program = "scan"
                model.output["tree_program"] = tree_program

        scan_args = (p.max_depth, p.nbins, Fw, N, p.sample_rate, 1.0)
        scan_kw = dict(bin_counts=wbin_counts, hist_mode=hist_mode,
                       split_mode=split_mode, hist_layout=hist_layout,
                       device=dev, hier=hier, plan=plan,
                       sparse_depth_threshold=p.sparse_depth_threshold,
                       tree_program=tree_program)
        scan_fn = make_multinomial_scan_fn(K, *scan_args, mode="drf",
                                           **scan_kw) if K > 1 \
            else make_tree_scan_fn("drf", *scan_args, **scan_kw)
        model.output["hist_kernel"] = \
            "varbin" if scan_fn.build.use_varbin else "uniform"
        scalars = (p.reg_lambda, p.min_rows, p.min_split_improvement, 1.0,
                   col_rate, p.reg_alpha, p.gamma, p.min_child_weight)
        metric_name, maximize = metric_direction(p.stopping_metric,
                                                 di.is_classifier)

        def preds(F, t):            # class-major sums -> predictions
            avg = F / max(t, 1)
            return _avg_to_preds(avg.t() if K > 1 else avg, di, K)

        history, chunks = [], []
        for chunk_no, (c, t_done, score_now) in enumerate(chunk_schedule(
                p.ntrees, p.score_tree_interval)):
            F_sum, chunk = scan_fn(codes, target, w, F_sum, edges_mat, seed,
                                   chunk_no, c, *scalars)
            chunks.append(chunk)
            job.update(t_done / p.ntrees, f"tree {t_done}/{p.ntrees}")
            if valid is not None:
                F_v = F_v + (torch.stack([traverse(ck.levels, ck.values, Xv)
                                          for ck in chunk]) if K > 1
                             else traverse(chunk.levels, chunk.values, Xv))
            if not score_now:
                continue
            m = make_metrics(di, preds(F_sum, t_done), y, w)
            entry = {"iteration": t_done, **m.describe()}
            if valid is not None:
                mv = make_metrics(di, preds(F_v, t_done), y_v, w_v)
                entry.update({f"valid_{k}": v
                              for k, v in mv.describe().items()})
            history.append(entry)
            if p.stopping_rounds:
                key = f"valid_{metric_name}" if valid is not None \
                    else metric_name
                series = [hh.get(key) for hh in history
                          if hh.get(key) is not None]
                if series and stop_early(series, p.stopping_rounds,
                                         p.stopping_tolerance, maximize):
                    break

        stacked = [StackedTrees.concat([ch[k] for ch in chunks])
                   for k in range(K)] if K > 1 \
            else StackedTrees.concat(chunks)
        ntrained = (stacked[0] if K > 1 else stacked).ntrees
        model.output["stacked"] = stacked
        model.output["trees"] = TreeList(stacked)
        model.output["init_score"] = np.zeros(K) if K > 1 else 0.0
        model.output["ntrees_trained"] = ntrained
        model.output["edges"] = binned.edges
        model.scoring_history = history
        # F_sum holds the forest's sums: no second pass over the trees
        model.training_metrics = make_metrics(di, preds(F_sum, ntrained),
                                              y, w)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
