"""Model / ModelBuilder: the training and scoring contract — the blocking
path of ``h2o3_tpu/models/base.py`` (hex/ModelBuilder.java:25,
hex/Model.java).

A ModelBuilder validates its parameters, fits a DataInfo, runs ``_fit`` under
a ``Job`` and returns a Model holding the learned state.  ``device`` picks
where it trains: ``cuda`` unless the caller names another, and the frame
must lie there.  Cross-validation, class balancing, streaming ingest,
checkpoints and warm starts, checkpoint export and the async scheduler
path are not ported yet: setting any of them raises.
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
    "nfolds": 0, "fold_column": None, "balance_classes": False,
    "class_sampling_factors": None, "checkpoint": None,
    "export_checkpoints_dir": None, "stream": False, "warm_start": None,
    "custom_metric_func": None, "offset_column": None,
}


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
    # not ported yet: any value but the default raises (see _NOT_PORTED)
    checkpoint: Optional[str] = None
    export_checkpoints_dir: Optional[str] = None
    balance_classes: bool = False
    class_sampling_factors: Optional[Sequence[float]] = None
    nfolds: int = 0
    fold_column: Optional[str] = None
    custom_metric_func: Optional[Any] = None
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
        self.scoring_history: List[dict] = []
        dkv.put(key, self)

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        """[padded, nclasses] probabilities or [padded] predictions."""
        raise NotImplementedError

    def _score_matrix(self, frame: Frame) -> torch.Tensor:
        raise NotImplementedError

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
        return make_metrics(di, raw, di.response(frame), di.weights(frame))

    def __repr__(self):
        return f"<{type(self).__name__} {self.key}>"


class ModelBuilder:
    """Base ModelBuilder — analog of hex.ModelBuilder.trainModel()."""

    algo = "model"
    model_class = Model
    supervised = True

    def __init__(self, params: Parameters):
        self.params = params
        self.job: Optional[Job] = None

    def _validate(self, frame: Frame) -> None:
        p = self.params
        for name, off in _NOT_PORTED.items():
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

    def train(self, frame: Frame, valid: Optional[Frame] = None) -> Model:
        """Blocking train on ``params.device`` (``cuda`` unless named):
        the trainModel/computeImpl path."""
        dev = resolve_device(self.params.device)
        for fr in (frame, valid):
            if fr is not None and fr.device != dev and not (
                    dev.type == fr.device.type == "cuda"
                    and dev.index is None):
                raise ValueError(
                    f"the frame lies on {fr.device}; this model trains on "
                    f"{dev} (Frame.from_numpy(..., device=...))")
        self._validate(frame)
        di = self._make_datainfo(frame)
        self.job = Job(f"{self.algo} train", dest_key=dkv.make_key(self.algo))

        def fit(job: Job) -> Model:
            t0 = time.time()
            model = self._fit(job, frame, di, valid)
            model.output.setdefault("run_time_s", time.time() - t0)
            model.output.setdefault("training_frame_rows", frame.nrows)
            self._post_fit(model, frame, valid)
            return model

        return self.job.run(fit)
