"""AdaBoost: SAMME boosting of shallow trees — the port of
``h2o3_tpu/models/adaboost.py`` (hex/adaboost/AdaBoost.java).

Binary AdaBoost with weak tree learners: each learner is one regression
tree on the signed target, grown through the level loop
(``shared.build_tree``: on a card one ``hist`` and one ``split_records``
launch a level) on g = -ysign D, h = w = D, the current row weights D.
Its leaf signs are the learner's votes; the weighted error gives alpha,
one host read a learner (its ``alpha <= 0`` stop needs it), and the row
weights are multiplied by exp(-alpha ysign vote) and renormalized on the
device.  The alphas are folded into the leaf signs, so the model scores
with ``shared.traverse`` and p1 = sigmoid(2 margin).  The histograms sum
D in int64 fixed point on each tree's own power-of-two scale (its L1
norm), so the tiny weights of later learners keep their digits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..frame.frame import Frame
from ..metrics.core import make_metrics
from ..runtime import dkv
from ..runtime.job import Job
from .datainfo import DataInfo
from .tree.binning import edges_matrix, fit_bins
from .tree.shared import (SharedTree, SharedTreeModel, SharedTreeParameters,
                          StackedTrees, build_tree, draw_generator,
                          traverse)


@dataclasses.dataclass
class AdaBoostParameters(SharedTreeParameters):
    nlearners: int = 50
    max_depth: int = 3
    learn_rate: float = 0.5          # shrinkage on alphas
    min_rows: float = 5.0


class AdaBoostModel(SharedTreeModel):
    algo = "adaboost"
    # the archive's tree scorer sums leaf values; this model's p1 is
    # sigmoid(2 margin), which it has no link for
    exportable = False

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        st = self.output["stacked"]
        margin = traverse(st.levels, st.values, X)   # alphas in the values
        p1 = 1.0 / (1.0 + torch.exp(-2.0 * margin))
        return torch.stack([1 - p1, p1], dim=1)


class AdaBoost(SharedTree):
    """AdaBoost builder — H2OAdaBoostEstimator analog (binary)."""

    algo = "adaboost"
    model_class = AdaBoostModel
    force_classification = True

    def __init__(self, params: Optional[AdaBoostParameters] = None, **kw):
        super().__init__(params or AdaBoostParameters(**kw))

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> AdaBoostModel:
        p: AdaBoostParameters = self.params
        if not di.is_classifier or di.nclasses != 2:
            raise ValueError("adaboost requires a binary response")
        dev = frame.device
        y = di.response(frame)
        w0 = di.weights(frame)
        seed = p.effective_seed()
        binned = fit_bins(frame, [s.name for s in di.specs], nbins=p.nbins,
                          histogram_type=p.histogram_type, seed=seed)
        codes = binned.codes
        edges_mat = torch.from_numpy(
            edges_matrix(binned.edges, p.nbins)).to(dev)
        live = w0 > 0
        ysign = torch.where(y > 0.5, 1.0, -1.0) * live
        D = w0 / w0.sum().clamp_min(1e-12)

        model = AdaBoostModel(job.dest_key or dkv.make_key(self.algo), p, di)
        trees: List = []
        alphas: List[float] = []
        for t in range(p.nlearners):
            # a regression weak learner on the signed target, weights D;
            # min_rows as a fraction of the weight, as the JAX package
            # passes it
            tree, leaf = build_tree(
                codes, -ysign * D, D, D, edges_mat, p.nbins, p.max_depth,
                p.reg_lambda, p.min_rows / max(frame.nrows, 1),
                p.min_split_improvement, 1.0,
                draw_generator(seed, 0, t, 0, dev), p.col_sample_rate,
                bin_counts=binned.bin_counts)
            h = torch.sign(tree.values[leaf.long()])
            h = torch.where(h == 0, 1.0, h)
            err = (D * (h != ysign) * live).sum().clamp(1e-10, 1 - 1e-10)
            alpha = 0.5 * torch.log((1 - err) / err) * p.learn_rate
            err_h, alpha_h = torch.stack([err, alpha]).tolist()
            if alpha_h <= 0:
                break
            # fold alpha into the leaf signs: scoring is a plain traversal
            v = torch.sign(tree.values) * alpha_h
            tree.values = torch.where(v == 0, alpha_h, v)
            trees.append(tree)
            alphas.append(alpha_h)
            D = D * torch.exp(-alpha * ysign * h)
            D = D / D.sum().clamp_min(1e-12)
            job.update((t + 1) / p.nlearners,
                       f"learner {t + 1} err={err_h:.4f}")

        model.output.update({"trees": trees, "ntrees_trained": len(trees),
                             "stacked": StackedTrees.from_trees(trees),
                             "alphas": alphas, "nclass_trees": 1,
                             "init_score": 0.0})
        raw = model._predict_raw(model._design(frame))
        model.training_metrics = make_metrics(di, raw, y, w0)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
