"""Aggregator — the port of ``h2o3_tpu/models/aggregator.py``
(hex/aggregator/Aggregator.java): exemplar-based data reduction.

The exemplars are KMeans ``plus_plus`` centres with k =
``target_num_exemplars`` (``kmeans.py``'s blocked distance products),
the counts the final assignment's; the exemplar frame holds the
de-standardized numerics and each categorical decoded by the argmax over
its one-hot block, as the JAX package builds it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo
from .kmeans import KMeans, _as_centers, _lloyd_step


@dataclasses.dataclass
class AggregatorParameters(Parameters):
    target_num_exemplars: int = 100
    rel_tol_num_exemplars: float = 0.5
    standardize: bool = True


class AggregatorModel(Model):
    algo = "aggregator"

    def _predict_raw(self, X):
        raise NotImplementedError("aggregator reduces, not predicts")

    @property
    def aggregated_frame(self) -> Frame:
        return dkv.get(self.output["output_frame_key"])

    def model_performance(self, frame=None):
        return self.training_metrics


class Aggregator(ModelBuilder):
    """Aggregator builder — H2OAggregatorEstimator analog."""

    algo = "aggregator"
    model_class = AggregatorModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[AggregatorParameters] = None, **kw):
        super().__init__(params or AggregatorParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            standardize=p.standardize, use_all_factor_levels=True,
            add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> AggregatorModel:
        p: AggregatorParameters = self.params
        k = min(p.target_num_exemplars, frame.nrows)
        km = KMeans(k=k, standardize=False, seed=p.effective_seed(),
                    max_iterations=10, init="plus_plus")
        # this builder's datainfo, so standardization matches
        X = di.make_matrix(frame)
        w = di.weights(frame)
        rng = np.random.default_rng(p.effective_seed())
        c0 = km._init_centers(X, w, k, rng, di)
        centers, withinss, counts, tot, iters = km._run_lloyd(
            job, X, w, np.asarray(c0), f"exemplars k={k}")
        _, _, counts_t, _ = _lloyd_step(X, w, _as_centers(centers, X))
        counts = counts_t.cpu().numpy().astype(np.float64)
        keep = counts > 0

        # de-standardize exemplar coordinates back to input space
        cols = {}
        ci = 0
        for s in di.specs:
            if s.width == 1:
                vals = centers[keep, ci]
                if di.standardize:
                    vals = vals * s.sigma + s.mean
                cols[s.name] = vals
            else:
                codes = np.argmax(centers[keep, ci:ci + s.width - 1], axis=1)
                lo = 0 if di.use_all_factor_levels else 1
                cols[s.name] = np.asarray(
                    [s.domain[min(c + lo, len(s.domain) - 1)]
                     for c in codes], dtype=object)
            ci += s.width
        cols["counts"] = counts[keep]
        out = Frame.from_numpy(cols, key=dkv.make_key("aggregated"),
                               device=frame.device)

        model = AggregatorModel(job.dest_key or dkv.make_key(self.algo),
                                p, di)
        model.output.update({
            "output_frame_key": out.key,
            "num_exemplars": int(keep.sum()),
            "mapping_counts": counts[keep],
            "init_read_s": km.init_read_s,
            "iterations": iters,
        })
        model.training_metrics = {"num_exemplars": int(keep.sum()),
                                  "rows_in": frame.nrows}
        return model
