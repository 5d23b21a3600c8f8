"""Model / ModelBuilder: the training and scoring contract — the blocking
path of ``h2o3_tpu/models/base.py`` (hex/ModelBuilder.java:25,
hex/Model.java).

A ModelBuilder validates its parameters, fits a DataInfo, runs ``_fit`` under
a ``Job`` and returns a Model holding the learned state.  ``device`` picks
where it trains: ``cuda`` unless the caller names another, and the frame
must lie there.  The shared options: cross-validation (``nfolds`` or a
``fold_column``: ``models/cv.py``), class balancing (per-class weights
folded into a weights column for the run), and a custom metric that joins
every metrics ``describe()``.  Streaming ingest, checkpoints and warm
starts, checkpoint export and the async scheduler path are not ported
yet: setting any of them raises, and so does an offset column for any
builder but GLM (the JAX package's tree builders and DeepLearning accept
one and never read it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec
from ..runtime import dkv
from ..runtime.device import resolve_device
from ..runtime.job import Job
from .datainfo import MEAN_IMPUTATION, DataInfo

# parameter -> the value that leaves its feature off; anything else raises
_NOT_PORTED = {
    "checkpoint": None, "export_checkpoints_dir": None, "stream": False,
    "warm_start": None, "offset_column": None,
}
# the synthetic weights column of a class-balanced run
BALANCE_WEIGHTS = "_balance_weights_"


@dataclasses.dataclass
class Parameters:
    """Common training parameters — analog of hex.Model.Parameters."""

    response_column: Optional[str] = None
    ignored_columns: Sequence[str] = ()
    weights_column: Optional[str] = None
    offset_column: Optional[str] = None
    seed: int = -1
    standardize: bool = True
    missing_values_handling: str = MEAN_IMPUTATION
    # early stopping (hex/ScoreKeeper.java:319)
    stopping_rounds: int = 0
    stopping_metric: str = "auto"
    stopping_tolerance: float = 1e-3
    # the device the model trains on: "cuda" unless named
    device: Optional[str] = None
    # class balancing (hex/Model.Parameters _balance_classes): per-class
    # weights (the deterministic form of the reference's oversampling)
    # folded into the weights column for the run; validation metrics
    # stay unbalanced
    balance_classes: bool = False
    class_sampling_factors: Optional[Sequence[float]] = None
    # cross-validation (models/cv.py): nfolds > 1 or a fold column
    nfolds: int = 0
    fold_column: Optional[str] = None
    fold_assignment: str = "auto"          # auto|random|modulo|stratified
    keep_cross_validation_predictions: bool = False
    # custom metric UDF: (predictions, y, w) -> (name, value)
    # (water/udf/CMetricFunc), in model_performance's metrics
    custom_metric_func: Optional[Any] = None
    # not ported yet: any value but the default raises (see _NOT_PORTED)
    checkpoint: Optional[str] = None
    export_checkpoints_dir: Optional[str] = None
    stream: bool = False
    warm_start: Optional[Any] = None

    def effective_seed(self) -> int:
        return int(np.random.default_rng().integers(2 ** 31)) \
            if self.seed in (-1, None) else int(self.seed)


class Model:
    """A trained model: params + output + learned state."""

    algo = "model"

    def __init__(self, key: str, params: Parameters, datainfo: DataInfo):
        self.key = key
        self.params = params
        self.datainfo = datainfo
        self.output: Dict[str, Any] = {}
        self.training_metrics = None
        self.validation_metrics = None
        self.cross_validation_metrics = None
        self.cv_predictions: Optional[np.ndarray] = None
        self.scoring_history: List[dict] = []
        dkv.put(key, self)

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        """[padded, nclasses] probabilities or [padded] predictions."""
        raise NotImplementedError

    def _score_matrix(self, frame: Frame) -> torch.Tensor:
        """The matrix ``_predict_raw`` expects: the standardized one-hot
        design (tree models override it with the raw-value design)."""
        return self.datainfo.make_matrix(frame)

    def predict(self, frame: Frame) -> Frame:
        """Score a frame: ``predict`` (label) + one probability column per
        class for classifiers, a single ``predict`` column otherwise."""
        di = self.datainfo
        raw = self._predict_raw(self._score_matrix(frame))[: frame.nrows]
        dev = frame.device
        if di.is_classifier:
            dom = [str(d) for d in di.response_domain]
            raw_np = raw.cpu().numpy()
            labels = np.argmax(raw_np, axis=1)
            if raw_np.shape[1] == 2:
                labels = (raw_np[:, 1] >= self.default_threshold()) \
                    .astype(np.int64)
            vecs = [Vec.from_numpy(labels.astype(np.int32), T_CAT,
                                   domain=dom, device=dev)]
            vecs += [Vec.from_numpy(raw_np[:, k], T_NUM, device=dev)
                     for k in range(raw_np.shape[1])]
            return Frame(["predict"] + dom, vecs)
        return Frame(["predict"], [Vec.from_numpy(
            raw.cpu().numpy().astype(np.float64), T_NUM, device=dev)])

    def default_threshold(self) -> float:
        m = self.training_metrics
        thr = getattr(m, "max_f1_threshold", None) if m is not None else None
        return float(thr) if thr is not None else 0.5

    def model_performance(self, frame: Optional[Frame] = None):
        """Metrics on a frame (None -> the training metrics)."""
        if frame is None:
            return self.training_metrics
        from ..metrics.core import make_metrics
        di = self.datainfo
        raw = self._predict_raw(self._score_matrix(frame))
        return make_metrics(di, raw, di.response(frame), di.weights(frame),
                            custom_metric_func=self.params.custom_metric_func)

    def __repr__(self):
        return f"<{type(self).__name__} {self.key}>"


class ModelBuilder:
    """Base ModelBuilder — analog of hex.ModelBuilder.trainModel()."""

    algo = "model"
    model_class = Model
    supervised = True
    # the builders whose training reads ``offset_column`` (GLM)
    takes_offset = False
    # the builders whose metrics are make_metrics' (binomial, multinomial,
    # regression), which cross-validation and the custom metric need; the
    # isolation forests and uplift score with their own
    standard_metrics = True

    def __init__(self, params: Parameters):
        self.params = params
        self.job: Optional[Job] = None

    def _validate(self, frame: Frame) -> None:
        p = self.params
        for name, off in _NOT_PORTED.items():
            if name == "offset_column" and self.takes_offset:
                continue
            if getattr(p, name, off) != off:
                raise NotImplementedError(
                    f"{self.algo}: {name} is not ported to h2o3_tpu_torch "
                    "yet (ROADMAP Queue 1)")
        if self.supervised:
            if not p.response_column:
                raise ValueError(f"{self.algo}: response_column is required")
            if p.response_column not in frame.names:
                raise ValueError(
                    f"response_column {p.response_column!r} not in frame")
        if not self.standard_metrics and (
                self._cv_requested() or p.custom_metric_func is not None):
            raise ValueError(
                f"{self.algo}: nfolds, fold_column and custom_metric_func "
                "need the binomial, multinomial or regression metrics, "
                "which this model does not make")
        if p.fold_column is not None and p.fold_column not in frame.names:
            raise ValueError(f"fold_column {p.fold_column!r} not in frame")

    def _cv_requested(self) -> bool:
        """nfolds > 1, or a fold column (whose distinct values are the
        folds)."""
        p = self.params
        return bool((p.nfolds and p.nfolds > 1) or p.fold_column)

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame,
            response_column=p.response_column if self.supervised else None,
            ignored_columns=p.ignored_columns,
            weights_column=p.weights_column,
            offset_column=p.offset_column,
            standardize=p.standardize,
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> Model:
        raise NotImplementedError

    def _post_fit(self, model: Model, frame: Frame,
                  valid: Optional[Frame]) -> None:
        """Hook after _fit; default no-op."""

    def _check_device(self, frame: Frame,
                      valid: Optional[Frame] = None) -> torch.device:
        """The device this builder trains on (``params.device``, ``cuda``
        unless named; raises without CUDA); raises unless the frames lie
        there."""
        dev = resolve_device(self.params.device)
        for fr in (frame, valid):
            if fr is not None and fr.device != dev and not (
                    dev.type == fr.device.type == "cuda"
                    and dev.index is None):
                raise ValueError(
                    f"the frame lies on {fr.device}; this model trains on "
                    f"{dev} (Frame.from_numpy(..., device=...))")
        return dev

    def _apply_balance(self, frame: Frame):
        """balance_classes as per-class weights: (the frame with a
        ``_balance_weights_`` column, the parameters that train on it),
        or (frame, None) when there is nothing to balance.  Each class's
        factor is ``class_sampling_factors`` or n / (K · its count),
        times the user's weights."""
        p = self.params
        if not p.balance_classes or not self.supervised:
            return frame, None
        rvec = frame.vec(p.response_column)
        if rvec.type != T_CAT:
            return frame, None              # regression: nothing to balance
        k = len(rvec.domain or [])
        if k <= 0:
            raise ValueError(
                "balance_classes needs a categorical response with a "
                "domain (got a cat column without one)")
        codes = rvec.to_numpy()
        counts = np.bincount(codes[codes >= 0], minlength=k).astype(float)
        counts[counts == 0] = 1.0
        if p.class_sampling_factors is not None:
            factors = np.asarray(p.class_sampling_factors, float)
        else:
            factors = counts.sum() / (k * counts)
        if len(factors) != k:
            raise ValueError(
                f"class_sampling_factors needs {k} entries, got "
                f"{len(factors)}")
        w = np.where(codes >= 0, factors[np.clip(codes, 0, k - 1)], 0.0)
        if p.weights_column:
            w = w * frame.vec(p.weights_column).to_numpy()
        out = frame.with_vec(BALANCE_WEIGHTS, Vec.from_numpy(
            w.astype(np.float64), T_NUM, device=frame.device))
        return out, dataclasses.replace(p, weights_column=BALANCE_WEIGHTS)

    def _balance_valid(self, valid: Optional[Frame],
                       orig: Parameters) -> Optional[Frame]:
        """The validation frame with the synthetic weights column holding
        the USER's weights (or ones): validation metrics are never
        class-balanced, as in the reference."""
        if valid is None or BALANCE_WEIGHTS in valid.names:
            return valid
        uv = valid.vec(orig.weights_column).to_numpy() \
            if orig.weights_column else np.ones(valid.nrows)
        return valid.with_vec(BALANCE_WEIGHTS, Vec.from_numpy(
            np.asarray(uv, np.float64), T_NUM, device=valid.device))

    def train(self, frame: Frame, valid: Optional[Frame] = None) -> Model:
        """Blocking train on ``params.device`` (``cuda`` unless named):
        the trainModel/computeImpl path, through cross-validation when
        asked.  A class-balanced or fold-column run trains under
        parameters installed for the run alone (its weights column, the
        fold column among the ignored ones); the fitted model's DataInfo
        keeps the user's weights column, so new frames score with their
        own weights."""
        self._check_device(frame, valid)
        self._validate(frame)
        orig = self.params
        frame, bal = self._apply_balance(frame)
        if bal is not None:
            self.params = bal
            valid = self._balance_valid(valid, orig)
        p = self.params
        if p.fold_column and p.fold_column not in p.ignored_columns:
            # the folds are not a feature
            self.params = dataclasses.replace(
                p, ignored_columns=tuple(p.ignored_columns)
                + (p.fold_column,))
        try:
            di = self._make_datainfo(frame)
            self.job = Job(f"{self.algo} train",
                           dest_key=dkv.make_key(self.algo))

            def fit(job: Job) -> Model:
                t0 = time.time()
                if self._cv_requested():
                    from .cv import cross_validate
                    model = cross_validate(self, job, frame, di, valid)
                else:
                    model = self._fit(job, frame, di, valid)
                model.output.setdefault("run_time_s", time.time() - t0)
                model.output.setdefault("training_frame_rows", frame.nrows)
                self._post_fit(model, frame, valid)
                return model

            model = self.job.run(fit)
        finally:
            self.params = orig
        if bal is not None:
            model.datainfo = dataclasses.replace(
                model.datainfo, weights_column=orig.weights_column)
        return model
