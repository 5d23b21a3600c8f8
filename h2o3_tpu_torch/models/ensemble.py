"""Stacked Ensembles: a metalearner over base-model holdout predictions —
the port of ``h2o3_tpu/models/ensemble.py``
(hex/ensemble/StackedEnsemble.java:38).

Base models trained with ``nfolds`` and
``keep_cross_validation_predictions=True`` supply the level-one frame
from their CV holdout predictions (host f64, as ``models/cv.py`` keeps
them); a ``blending_frame`` switches to holdout blending, scored through
each base model's ``_score_matrix``/``_predict_raw`` on its device.  A
binomial base model contributes p1, a multinomial one its K class
probabilities, a regression its prediction.  The metalearner (GLM with
``lambda_=1e-5`` by default, or GBM, DRF, DeepLearning) trains on the
level-one frame on this fit's device; scoring chains the base models'
predictions into the metalearner's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class StackedEnsembleParameters(Parameters):
    base_models: Sequence[Union[str, Model]] = ()
    metalearner_algorithm: str = "auto"     # auto|glm|gbm|drf|deeplearning
    metalearner_params: Optional[dict] = None
    metalearner_nfolds: int = 0
    blending_frame: Optional[Frame] = None


def _resolve(m: Union[str, Model]) -> Model:
    if isinstance(m, Model):
        return m
    got = dkv.get(m)
    if got is None:
        raise KeyError(f"base model {m!r} not found in DKV")
    return got


def _base_columns(model: Model, raw):
    """Level-one columns contributed by one base model's raw predictions
    (a host array or a device tensor, [n, width])."""
    di = model.datainfo
    if di.is_classifier and di.nclasses == 2:
        return [raw[:, 1]]                       # p(positive)
    if di.is_classifier:
        return [raw[:, k] for k in range(di.nclasses)]
    return [raw.reshape(len(raw))]


def _scored(bm: Model, frame: Frame) -> torch.Tensor:
    """A base model's raw predictions of ``frame`` [padded, width] on its
    device, in f32."""
    raw = bm._predict_raw(bm._score_matrix(frame))
    return raw.reshape(raw.shape[0], -1).to(torch.float32)


class StackedEnsembleModel(Model):
    algo = "stackedensemble"

    def _level_one(self, frame: Frame) -> Frame:
        names, vecs = [], []
        for key in self.output["base_model_keys"]:
            bm = _resolve(key)
            for i, col in enumerate(_base_columns(bm, _scored(bm, frame))):
                data = col.clone()
                data[frame.nrows:] = float("nan")
                names.append(f"{key}_p{i}")
                vecs.append(Vec(data, T_NUM, frame.nrows))
        resp = self.params.response_column
        if resp in frame.names:
            # carry the response through unchanged (keeps cat identity)
            names.append(resp)
            vecs.append(frame.vec(resp))
        return Frame(names, vecs)

    def _predict_raw(self, X):
        raise NotImplementedError("ensemble scores via its base models")

    def predict(self, frame: Frame) -> Frame:
        meta = _resolve(self.output["metalearner_key"])
        return meta.predict(self._level_one(frame))

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        meta = _resolve(self.output["metalearner_key"])
        return meta.model_performance(self._level_one(frame))


class StackedEnsemble(ModelBuilder):
    """SE builder — H2OStackedEnsembleEstimator analog."""

    algo = "stackedensemble"
    model_class = StackedEnsembleModel

    def __init__(self, params: Optional[StackedEnsembleParameters] = None,
                 **kw):
        super().__init__(params or StackedEnsembleParameters(**kw))

    def _make_metalearner(self, di: DataInfo) -> ModelBuilder:
        p: StackedEnsembleParameters = self.params
        algo = p.metalearner_algorithm
        mp = dict(p.metalearner_params or {})
        mp.setdefault("response_column", p.response_column)
        mp.setdefault("nfolds", p.metalearner_nfolds)
        mp.setdefault("seed", p.seed)
        mp.setdefault("device", p.device)
        if algo in ("auto", "glm"):
            from .glm import GLM
            mp.setdefault("lambda_", 1e-5)
            return GLM(**mp)
        if algo == "gbm":
            from .tree.gbm import GBM
            return GBM(**mp)
        if algo == "drf":
            from .tree.drf import DRF
            return DRF(**mp)
        if algo == "deeplearning":
            from .deeplearning import DeepLearning
            return DeepLearning(**mp)
        raise ValueError(f"unknown metalearner_algorithm {algo!r}")

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: StackedEnsembleParameters = self.params
        if not p.base_models:
            raise ValueError("stackedensemble requires base_models")
        if p.blending_frame is None:
            for m in p.base_models:
                bm = _resolve(m)
                if bm.cv_predictions is None:
                    raise ValueError(
                        f"base model {bm.key} has no CV holdout predictions; "
                        "train with nfolds>1 and "
                        "keep_cross_validation_predictions=True, or supply "
                        "a blending_frame")

    def level_one_training(self, frame: Frame,
                           base: List[Model]) -> Frame:
        """The metalearner's training frame: each base model's CV holdout
        columns (host f64 to the frame's device in f32, as
        ``Frame.from_numpy`` puts them), or its scores of the
        ``blending_frame`` on the device, then the response."""
        p: StackedEnsembleParameters = self.params
        lf_frame = p.blending_frame if p.blending_frame is not None \
            else frame
        names, vecs = [], []
        for bm in base:
            if p.blending_frame is not None:
                raw = _scored(bm, lf_frame)
            else:
                raw = np.asarray(bm.cv_predictions).reshape(
                    lf_frame.nrows, -1)
            for i, col in enumerate(_base_columns(bm, raw)):
                names.append(f"{bm.key}_p{i}")
                if isinstance(col, torch.Tensor):
                    data = col.clone()
                    data[lf_frame.nrows:] = float("nan")
                    vecs.append(Vec(data, T_NUM, lf_frame.nrows))
                else:
                    vecs.append(Vec.from_numpy(col, T_NUM,
                                               device=lf_frame.device))
        names.append(p.response_column)
        vecs.append(lf_frame.vec(p.response_column))
        return Frame(names, vecs)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> StackedEnsembleModel:
        p: StackedEnsembleParameters = self.params
        base = [_resolve(m) for m in p.base_models]
        model = StackedEnsembleModel(
            job.dest_key or dkv.make_key(self.algo), p, di)
        model.output["base_model_keys"] = [m.key for m in base]
        lone = self.level_one_training(frame, base)

        job.update(0.3, "training metalearner")
        meta = self._make_metalearner(di).train(lone)
        model.output["metalearner_key"] = meta.key
        model.output["metalearner_algo"] = meta.algo
        model.training_metrics = meta.training_metrics
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
