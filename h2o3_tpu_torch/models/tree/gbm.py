"""GBM: gradient boosting on the level kernels — the gbtree path of
``h2o3_tpu/models/tree/gbm.py`` (hex/tree/gbm/GBM.java).

Per boosting round: gradients of the loss (``distributions``: the ten
families of the JAX package and a custom one), one tree grown level by
level (``shared.make_build_tree_fn``), the Newton leaf values added to
the scores F.  Monotone constraints (``shared.resolve_mono``) and
exclusive feature bundling (``shared.maybe_bundle``) change the level,
not the loop.  A response of K > 2 classes grows K class
trees a round on the softmax gradients (``shared.make_multinomial_scan_fn``:
one batched build of the K trees, GBM.java buildNextKTrees).  Rounds run in
chunks that end on the scoring intervals (``shared.chunk_schedule``);
training metrics come from F, with no second pass over the ensemble.
XGBoost's DART booster (``booster="dart"``) grows one round at a time
instead (``_fit_dart``, the JAX package's per-tree loop): it drops a
random set of earlier trees, fits the new tree to the gradients without
them and rescales both.  Grid cohorts of GBM and XGBoost members grow
through ``grid_batch.train_cohort``, which finishes each member as
``_fit`` finishes a train (``_finalize_fused``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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
                     StackedTrees, Tree, TreeList, _row_sample, _scan_codes,
                     chunk_schedule, draw_generator, efb_bundles,
                     make_build_tree_fn, make_multinomial_scan_fn,
                     make_tree_scan_fn, maybe_bundle, record_effective_depth,
                     resolve_hist_layout, resolve_hist_mode, resolve_mono,
                     resolve_split_mode, resolve_tree_program,
                     run_hist_crosscheck, run_layout_crosscheck,
                     run_program_crosscheck, run_split_crosscheck,
                     stack_trees, traverse,
                     use_hier_split_search)


def tree_scores(trees, X: torch.Tensor, K: int) -> torch.Tensor:
    """The summed scores of a list of trees (``Tree``s, or K class-tree
    lists) over the raw design X, [N] or [K, N] class-major: DART's S_D
    over its dropped trees, as the JAX package's ``drop_sum`` traverses
    them (gbm.py:274), and a validation frame's scores over all."""
    if K == 1:
        return traverse(*stack_trees(trees), X)
    return torch.stack([traverse(*stack_trees([t[k] for t in trees]), X)
                        for k in range(K)])


def dart_scales(kdrop: int, nu: float, normalize_type: str) -> tuple:
    """(a, b): the dropped trees' rescale and the new tree's, libxgboost's
    dart normalisation; with nothing dropped (1, nu)."""
    if not kdrop:
        return 1.0, nu
    if normalize_type == "forest":
        return 1.0 / (1.0 + nu), 1.0 / (1.0 + nu)
    return kdrop / (kdrop + nu), 1.0 / (kdrop + nu)


@dataclasses.dataclass
class GBMParameters(SharedTreeParameters):
    # a custom loss (water/udf/CDistributionFunc analog): an object with
    # the protocol of distributions.CustomDistribution, in torch
    custom_distribution_func: Optional[object] = None


def params_distribution(p, nclasses: int, name: Optional[str] = None):
    """The distribution a tree builder's parameters name (or ``name``),
    with their Tweedie power, quantile and Huber alphas and custom
    function."""
    return make_distribution(
        name or p.distribution, nclasses=nclasses,
        tweedie_power=p.tweedie_power, quantile_alpha=p.quantile_alpha,
        huber_alpha=p.huber_alpha,
        custom_distribution_func=getattr(p, "custom_distribution_func",
                                         None))


class GBMModel(SharedTreeModel):
    algo = "gbm"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        F = self._raw_scores(X)
        if self.output.get("nclass_trees", 1) > 1:
            return torch.softmax(F, dim=1)
        dist = params_distribution(self.params, self.datainfo.nclasses,
                                   self.output["distribution"])
        if self.datainfo.is_classifier:
            p1 = dist.linkinv(F).clamp(0.0, 1.0)
            return torch.stack([1 - p1, p1], dim=1)
        return dist.linkinv(F)


class GBM(SharedTree):
    algo = "gbm"
    model_class = GBMModel
    # grid cohorts batch through the single-class path
    # (grid_batch.train_cohort reuses _prep_targets, _interval_score and
    # _finalize_fused)
    _grid_batchable = True

    def __init__(self, params: Optional[GBMParameters] = None, **kw):
        super().__init__(params or GBMParameters(**kw))

    def _finalize_fused(self, model, di, dist, F, y, w, valid, history,
                        binned, init_host, stacked):
        """The end of a train, shared by ``_fit`` and the grid cohort's
        members: the trees (one ``StackedTrees``, or a list of K class
        stacks) and the initial score into ``model.output``, the scoring
        history, and the training (and validation) metrics, taken from the
        last interval's scoring where it scored this ensemble, else from
        the scores F."""
        ntrained = (stacked[0] if isinstance(stacked, list)
                    else stacked).ntrees
        model.output["trees"] = TreeList(stacked)
        model.output["stacked"] = stacked
        model.output["init_score"] = init_host
        model.output["ntrees_trained"] = ntrained
        model.output["edges"] = binned.edges
        model.scoring_history = history
        im = getattr(model, "_interval_metrics", None)
        if im is not None and im[0] == ntrained:
            model.training_metrics = im[1]
            if valid is not None:
                model.validation_metrics = im[2]
        else:
            model.training_metrics = make_metrics(
                di, self._scores_to_preds(F, dist, di), y, w)
            if valid is not None:
                model.validation_metrics = model.model_performance(valid)
        return model

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> GBMModel:
        p: GBMParameters = self.params
        K = di.nclasses if di.is_classifier and di.nclasses > 2 else 1
        dev = frame.device
        dist = params_distribution(p, di.nclasses)
        if K > 1 and getattr(p, "custom_distribution_func",
                             None) is not None:
            raise ValueError(
                "custom_distribution_func is not supported for multinomial "
                "responses (the K-tree softmax path has its own gradients)")
        if (K > 1) != (dist.name == "multinomial"):
            raise ValueError(
                f"distribution {dist.name!r} does not fit a response of "
                f"{di.nclasses} classes")
        mono = resolve_mono(p, di)
        if mono is not None and K > 1:
            raise ValueError(
                "monotone_constraints: multinomial is not supported")
        if mono is not None and use_hier_split_search(p):
            raise NotImplementedError(
                "monotone_constraints do not compose with the hierarchical "
                "split search (split_search='hier'); use the exact search")
        y, w = di.response(frame), di.weights(frame)
        binned = fit_bins(frame, [s.name for s in di.specs], nbins=p.nbins,
                          seed=p.effective_seed(),
                          weights=w if p.weights_column else None,
                          histogram_type=p.histogram_type)
        edges_mat = torch.from_numpy(
            edges_matrix(binned.edges, p.nbins)).to(dev)
        # EFB: a wide sparse frame trains on bundled working codes; the
        # recorded trees stay in the original feature space
        plan, codes, Fw, wbin_counts = maybe_bundle(binned, p, mono,
                                                    frame.nrows)
        N = codes.shape[1]
        hier = use_hier_split_search(p)
        knobs = dict(mono=mono, plan=plan, hier=hier)
        hist_mode = resolve_hist_mode(p)
        split_mode = resolve_split_mode(p, **knobs)
        hist_layout = resolve_hist_layout(p, hist_mode=hist_mode, **knobs)
        tree_program = resolve_tree_program(
            p, hist_layout=hist_layout, bin_counts=wbin_counts, F=Fw,
            n_padded=N, device=dev, **knobs)
        seed = p.effective_seed()

        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        if plan is not None:
            model.output["efb_bundles"] = efb_bundles(plan)
        model.output["distribution"] = dist.name
        model.output["binning"] = {"nbins": p.nbins}
        model.output["nclass_trees"] = K
        model.output["tree_program"] = tree_program
        model.output["split_search"] = "hier" if hier else "exact"
        record_effective_depth(model, p, Fw, N, hist_layout=hist_layout)

        if K > 1:
            # class-major [K, N] one-hot response and scores; F0 the log
            # of the weighted class prior
            yi = y.long().clamp(0, K - 1)
            target = torch.nn.functional.one_hot(yi, K).t().to(
                torch.float32)
            base = (w * target).sum(dim=1) / w.sum().clamp_min(1e-12)
            init = torch.log(base.clamp(1e-10, 1.0)).to(torch.float32)
            init_host = init.cpu().numpy()
        else:
            y, init = self._prep_targets(y, w, dist)
            target, init_host = y, float(init)

        def start(n):                 # the initial scores of n rows
            f = init.to(torch.float32)
            return f[..., None].expand(*f.shape, n).clone()
        F = start(N)
        if valid is not None:
            Xv = model._design(valid)
            y_v, w_v = di.response(valid), di.weights(valid)
            F_v = start(Xv.shape[0])

        common = dict(max_depth=p.max_depth, nbins=p.nbins, F=Fw,
                      n_padded=N, bin_counts=wbin_counts,
                      reg_lambda=p.reg_lambda, min_rows=p.min_rows,
                      min_split_improvement=p.min_split_improvement,
                      learn_rate=p.learn_rate, reg_alpha=p.reg_alpha,
                      gamma=p.gamma, min_child_weight=p.min_child_weight)
        if "check" in (hist_mode, split_mode, hist_layout, tree_program):
            # the crosschecks on the real first-round gradients (the exact
            # search, also when training takes the hierarchical one), with
            # the K class trees of a multinomial round as one batched
            # build; then training proceeds on the subtraction path, the
            # fused split search, the node-sparse levels and the
            # whole-tree program
            g0, h0 = dist.grad_hess(target, F)
            kw = dict(common, nk=K)
            if hist_mode == "check":
                run_hist_crosscheck(codes, g0 * w, h0 * w, w, edges_mat,
                                    seed, mono=mono, plan=plan, **kw)
                hist_mode = "subtract"
            if split_mode == "check":
                run_split_crosscheck(codes, g0 * w, h0 * w, w, edges_mat,
                                     seed, hist_mode=hist_mode,
                                     col_sample_rate=p.col_sample_rate, **kw)
                split_mode = "fused"
            if hist_layout == "check":
                run_layout_crosscheck(
                    codes, g0 * w, h0 * w, w, edges_mat, seed,
                    sparse_depth_threshold=p.sparse_depth_threshold,
                    col_sample_rate=p.col_sample_rate, **kw)
                hist_layout = "sparse"
                model.output["hist_layout"] = hist_layout
            if tree_program == "check":
                run_program_crosscheck(
                    codes, g0 * w, h0 * w, w, edges_mat, seed,
                    hist_mode=hist_mode, split_mode=split_mode,
                    col_sample_rate=p.col_sample_rate,
                    **{k: v for k, v in kw.items() if k != "bin_counts"})
                tree_program = "scan"
                model.output["tree_program"] = tree_program

        if getattr(p, "booster", "gbtree") == "dart":
            vstate = (valid, Xv, y_v, w_v) if valid is not None else None
            return self._fit_dart(
                job, model, di, dist, codes, target, y, w, F, edges_mat,
                binned, init_host, model._design(frame), vstate, hist_mode,
                split_mode, hist_layout, hier, seed, K, Fw, wbin_counts,
                mono, plan, tree_program)

        scan_args = (p.max_depth, p.nbins, Fw, N, p.sample_rate,
                     p.col_sample_rate_per_tree)
        scan_kw = dict(bin_counts=wbin_counts, hist_mode=hist_mode,
                       split_mode=split_mode, hist_layout=hist_layout,
                       device=dev, hier=hier, plan=plan,
                       sparse_depth_threshold=p.sparse_depth_threshold,
                       tree_program=tree_program)
        scan_fn = make_multinomial_scan_fn(K, *scan_args, **scan_kw) \
            if K > 1 else make_tree_scan_fn(dist, *scan_args, mono=mono,
                                            **scan_kw)
        model.output["hist_kernel"] = \
            "varbin" if scan_fn.build.use_varbin else "uniform"
        scalars = (p.reg_lambda, p.min_rows, p.min_split_improvement,
                   p.learn_rate, p.col_sample_rate, p.reg_alpha, p.gamma,
                   p.min_child_weight)
        metric_name, maximize = metric_direction(p.stopping_metric,
                                                 di.is_classifier)
        history, chunks = [], []
        for chunk_no, (c, t_done, score_now) in enumerate(chunk_schedule(
                p.ntrees, p.score_tree_interval)):
            F, chunk = scan_fn(codes, target, w, F, edges_mat, seed,
                               chunk_no, c, *scalars)
            chunks.append(chunk)
            job.update(t_done / p.ntrees, f"tree {t_done}/{p.ntrees}")
            if valid is not None:
                F_v = F_v + (torch.stack([traverse(ck.levels, ck.values, Xv)
                                          for ck in chunk]) if K > 1
                             else traverse(chunk.levels, chunk.values, Xv))
            if not score_now:
                continue
            vstate = (F_v, y_v, w_v) if valid is not None else None
            if self._interval_score(model, t_done, F, y, w, di, dist,
                                    history, vstate, metric_name, maximize):
                break

        stacked = [StackedTrees.concat([ch[k] for ch in chunks])
                   for k in range(K)] if K > 1 \
            else StackedTrees.concat(chunks)
        return self._finalize_fused(model, di, dist, F, y, w, valid, history,
                                    binned, init_host, stacked)

    def _fit_dart(self, job, model, di, dist, codes, target, y, w, F,
                  edges_mat, binned, init_host, X_tr, vstate, hist_mode,
                  split_mode, hist_layout, hier, seed, K, Fw, bin_counts,
                  mono, plan, tree_program):
        """The DART booster, one round at a time (the JAX package's loop,
        gbm.py:528-683): the dropped trees' scores S_D traversed over the
        raw design, gradients on F - S_D, the new tree grown at learn
        rate 1 and its leaf values scaled by b, the dropped trees' by a,
        and F -= (1 - a) S_D.  The per-tree column mask and the drops are
        drawn from ``np.random.default_rng(seed)`` in the JAX package's
        order (column mask, skip_drop, rate_drop, one_drop), so the drop
        sets are its own; the row sample and per-split masks are the
        port's keyed streams (round t of chunk 0).  A round of K class
        trees is one batched build (``make_build_tree_fn(nk=K)``), or
        under ``split_mode="separate"`` (which the resolvers give the
        hierarchical search, constraints and a plan) a loop of K single
        builds, bitwise alike.  Trees stay a list while
        training, since rescaling rewrites earlier trees, and are stacked
        at the end; a validation frame is scored from all trees at each
        interval.  ``codes`` are a bundle plan's working codes (``Fw``
        features, ``bin_counts``) where one engages.  Under
        ``tree_program="scan"`` a round is the whole-tree program (on a
        card one graph replay a round; its learn rate is always 1)."""
        p = self.params
        dev, N = codes.device, codes.shape[1]
        batched = K > 1 and split_mode == "fused"
        build = make_build_tree_fn(
            p.max_depth, p.nbins, Fw, N, bin_counts=bin_counts,
            hist_mode=hist_mode, split_mode=split_mode,
            hist_layout=hist_layout, device=dev, hier=hier,
            nk=K if batched else 1,
            sparse_depth_threshold=p.sparse_depth_threshold, mono=mono,
            plan=plan, tree_program=tree_program)
        model.output["hist_kernel"] = \
            "varbin" if build.use_varbin else "uniform"
        hcodes = _scan_codes(build, codes, p.nbins, hier)
        scal = (p.reg_lambda, p.min_rows, p.min_split_improvement, 1.0,
                p.col_sample_rate)
        reg = (p.reg_alpha, p.gamma, p.min_child_weight)
        metric_name, maximize = metric_direction(p.stopping_metric,
                                                 di.is_classifier)
        init_v = torch.as_tensor(np.asarray(init_host, np.float32),
                                 device=dev)
        nprng = np.random.default_rng(seed)
        trees, history = [], []
        F_v = None
        for t in range(p.ntrees):
            wv = _row_sample(w, p.sample_rate, seed, 0, t)
            tm = None
            if p.col_sample_rate_per_tree < 1.0:
                m = nprng.random(Fw) < p.col_sample_rate_per_tree
                if not m.any():
                    m[nprng.integers(Fw)] = True
                tm = torch.from_numpy(m).to(dev)
            drop = []
            if trees and nprng.random() >= p.skip_drop:
                md = nprng.random(len(trees)) < p.rate_drop
                if p.one_drop and not md.any():
                    md[nprng.integers(len(trees))] = True
                drop = [int(i) for i in np.flatnonzero(md)]
            S_D = tree_scores([trees[i] for i in drop], X_tr, K) \
                if drop else None
            a, b = dart_scales(len(drop), p.learn_rate, p.normalize_type)
            g, h = dist.grad_hess(target, F if S_D is None else F - S_D)
            gens = [draw_generator(seed, 0, t, k, dev) for k in range(K)]
            if K == 1 or batched:
                levels, vals, cover, leaf = build(
                    codes, g * wv, h * wv, wv, edges_mat,
                    gens if batched else gens[0], *scal,
                    tm.expand(K, Fw) if batched and tm is not None else tm,
                    *reg, hcodes=hcodes)
                vals = vals * b
                per = [(levels, vals, cover, leaf)] if K == 1 else [
                    ([tuple(x[k] for x in lv) for lv in levels], vals[k],
                     cover[k], leaf[k]) for k in range(K)]
            else:
                per = []
                for k in range(K):
                    levels, vals, cover, leaf = build(
                        codes, g[k] * wv, h[k] * wv, wv, edges_mat,
                        gens[k], *scal, tm, *reg, hcodes=hcodes)
                    per.append((levels, vals * b, cover, leaf))
            new = [Tree([lv[0] for lv in levels], [lv[1] for lv in levels],
                        [lv[2] for lv in levels], [lv[3] for lv in levels],
                        vals, cover) for levels, vals, cover, _ in per]
            dF = torch.stack([v[lf.long()] for _, v, _, lf in per])
            F = F + (dF[0] if K == 1 else dF)
            trees.append(new[0] if K == 1 else new)
            if drop:
                for i in drop:
                    for tr in (trees[i] if K > 1 else [trees[i]]):
                        tr.values = tr.values * a
                F = F - (1.0 - a) * S_D
            job.update((t + 1) / p.ntrees, f"tree {t + 1}/{p.ntrees}")
            if (t + 1) % max(1, p.score_tree_interval) and t != p.ntrees - 1:
                continue
            if vstate is not None:
                # rescaling rewrote earlier trees: all of them, anew
                _, Xv, y_v, w_v = vstate
                F_v = (init_v if K == 1 else init_v[:, None]) \
                    + tree_scores(trees, Xv, K)
            if self._interval_score(
                    model, t + 1, F, y, w, di, dist, history,
                    (F_v, y_v, w_v) if vstate is not None else None,
                    metric_name, maximize):
                break
        stacked = StackedTrees.from_trees(trees) if K == 1 else [
            StackedTrees.from_trees([tr[k] for tr in trees])
            for k in range(K)]
        return self._finalize_fused(model, di, dist, F, y, w,
                                    vstate[0] if vstate else None, history,
                                    binned, init_host, stacked)
