"""GBM: gradient boosting on the level kernels — the single-class path of
``h2o3_tpu/models/tree/gbm.py`` (hex/tree/gbm/GBM.java).

Per boosting round: gradients of the loss (``distributions``), one tree
grown level by level (``shared.make_build_tree_fn``), the Newton leaf
values added to the scores F.  Rounds run in chunks that end on the
scoring intervals (``shared.chunk_schedule``); training metrics come from
F, with no second pass over the ensemble.  Multinomial responses and the
DART booster wait for a later slice and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...frame.frame import Frame
from ...metrics.core import make_metrics
from ...runtime import dkv
from ...runtime.job import Job
from ..datainfo import DataInfo
from ..distributions import make_distribution
from ..scorekeeper import metric_direction
from .binning import edges_matrix, fit_bins
from .shared import (SharedTree, SharedTreeModel, SharedTreeParameters,
                     StackedTrees, TreeList, chunk_schedule,
                     make_tree_scan_fn, record_effective_depth,
                     resolve_hist_layout, resolve_hist_mode,
                     resolve_split_mode, resolve_tree_program,
                     run_hist_crosscheck, run_split_crosscheck, traverse,
                     use_hier_split_search)

_LATER = "ROADMAP Queue 1, 'Rest of the tree family'"


@dataclasses.dataclass
class GBMParameters(SharedTreeParameters):
    pass


class GBMModel(SharedTreeModel):
    algo = "gbm"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        F = self._raw_scores(X)
        dist = make_distribution(self.output["distribution"],
                                 nclasses=self.datainfo.nclasses)
        if self.datainfo.is_classifier:
            p1 = dist.linkinv(F).clamp(0.0, 1.0)
            return torch.stack([1 - p1, p1], dim=1)
        return dist.linkinv(F)


class GBM(SharedTree):
    algo = "gbm"
    model_class = GBMModel

    def __init__(self, params: Optional[GBMParameters] = None, **kw):
        super().__init__(params or GBMParameters(**kw))

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> GBMModel:
        p: GBMParameters = self.params
        if di.is_classifier and di.nclasses > 2:
            raise NotImplementedError(
                f"multinomial GBM/XGBoost is not ported yet ({_LATER}: "
                "batched K trees)")
        if getattr(p, "booster", "gbtree") == "dart":
            raise NotImplementedError(
                f"booster='dart' is not ported yet ({_LATER})")
        dev = frame.device
        dist = make_distribution(p.distribution, nclasses=di.nclasses)
        y, w = di.response(frame), di.weights(frame)
        y, f0 = self._prep_targets(y, w, dist)
        binned = fit_bins(frame, [s.name for s in di.specs], nbins=p.nbins,
                          seed=p.effective_seed(),
                          weights=w if p.weights_column else None,
                          histogram_type=p.histogram_type)
        codes = binned.codes
        edges_mat = torch.from_numpy(
            edges_matrix(binned.edges, p.nbins)).to(dev)
        N = codes.shape[1]
        Fw = binned.nfeatures
        hier = use_hier_split_search(p)
        hist_mode = resolve_hist_mode(p)
        split_mode = resolve_split_mode(p, hier=hier)
        hist_layout = resolve_hist_layout(p, hier=hier)
        tree_program = resolve_tree_program(p)
        seed = p.effective_seed()

        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        model.output["distribution"] = dist.name
        model.output["binning"] = {"nbins": p.nbins}
        model.output["nclass_trees"] = 1
        model.output["tree_program"] = tree_program
        model.output["split_search"] = "hier" if hier else "exact"
        record_effective_depth(model, p, Fw, N, hist_layout=hist_layout)

        F = f0.to(torch.float32).expand(N).clone()
        init_host = float(f0)
        if valid is not None:
            Xv = model._design(valid)
            y_v, w_v = di.response(valid), di.weights(valid)
            F_v = torch.full((Xv.shape[0],), init_host, dtype=torch.float32,
                             device=dev)

        common = dict(max_depth=p.max_depth, nbins=p.nbins, F=Fw,
                      n_padded=N, bin_counts=binned.bin_counts,
                      reg_lambda=p.reg_lambda, min_rows=p.min_rows,
                      min_split_improvement=p.min_split_improvement,
                      learn_rate=p.learn_rate, reg_alpha=p.reg_alpha,
                      gamma=p.gamma, min_child_weight=p.min_child_weight,
                      hist_layout=hist_layout)
        if hist_mode == "check":
            # the crosscheck on the real first-tree gradients (the exact
            # search, also when training takes the hierarchical one),
            # then training proceeds on the subtraction path
            g0, h0 = dist.grad_hess(y, F)
            run_hist_crosscheck(codes, g0 * w, h0 * w, w, edges_mat, seed,
                                **common)
            hist_mode = "subtract"
        if split_mode == "check":
            g0, h0 = dist.grad_hess(y, F)
            run_split_crosscheck(codes, g0 * w, h0 * w, w, edges_mat, seed,
                                 hist_mode=hist_mode,
                                 col_sample_rate=p.col_sample_rate, **common)
            split_mode = "fused"

        scan_fn = make_tree_scan_fn(
            dist, p.max_depth, p.nbins, Fw, N, p.sample_rate,
            p.col_sample_rate_per_tree, bin_counts=binned.bin_counts,
            hist_mode=hist_mode, split_mode=split_mode,
            hist_layout=hist_layout, device=dev, hier=hier)
        model.output["hist_kernel"] = \
            "varbin" if scan_fn.build.use_varbin else "uniform"
        scalars = (p.reg_lambda, p.min_rows, p.min_split_improvement,
                   p.learn_rate, p.col_sample_rate, p.reg_alpha, p.gamma,
                   p.min_child_weight)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        metric_name, maximize = metric_direction(p.stopping_metric,
                                                 di.is_classifier)
        history, chunks = [], []
        for c, t_done, score_now in chunk_schedule(p.ntrees,
                                                   p.score_tree_interval):
            F, chunk = scan_fn(codes, y, w, F, edges_mat, gen, c, *scalars)
            chunks.append(chunk)
            job.update(t_done / p.ntrees, f"tree {t_done}/{p.ntrees}")
            if valid is not None:
                F_v = F_v + traverse(chunk.levels, chunk.values, Xv)
            if not score_now:
                continue
            vstate = (F_v, y_v, w_v) if valid is not None else None
            if self._interval_score(model, t_done, F, y, w, di, dist,
                                    history, vstate, metric_name, maximize):
                break

        stacked = StackedTrees.concat(chunks)
        model.output["stacked"] = stacked
        model.output["trees"] = TreeList(stacked)
        model.output["init_score"] = init_host
        model.output["ntrees_trained"] = stacked.ntrees
        model.output["edges"] = binned.edges
        model.scoring_history = history
        im = getattr(model, "_interval_metrics", None)
        if im is not None and im[0] == stacked.ntrees:
            model.training_metrics = im[1]
            if valid is not None:
                model.validation_metrics = im[2]
        else:
            model.training_metrics = make_metrics(
                di, self._scores_to_preds(F, dist, di), y, w)
            if valid is not None:
                model.validation_metrics = model.model_performance(valid)
        return model
