"""Infogram / admissible ML — the h2o-admissibleml module analog, the
port of ``h2o3_tpu/models/infogram.py``.

Reference: ``h2o-admissibleml/src/main/java/hex/Infogram/Infogram.java:21``.

Two modes (Infogram.java:182 ``_buildCore``):

- **Core infogram** (no ``protected_columns``): for each predictor X_i a
  model is trained WITHOUT X_i; the last model uses ALL predictors
  (buildTrainingFrames, Infogram.java:538-563).  Net information raw_i =
  max(0, cmi_all − cmi_without_i), scaled by the max
  (InfogramUtils.calculateFinalCMI:213).  Relevance = full-model variable
  importance (extractRelevance:608).
- **Fair infogram** (``protected_columns`` set): model_i = protected ∪
  {X_i}; the last model uses protected columns only.  raw_i = max(0,
  cmi_i − cmi_protected).  Relevance comes from a model on all
  predictors MINUS the protected columns.

Raw CMI of a model = mean log2 predicted-probability of the TRUE class
over rows with positive probability/weight (EstimateCMI.java:29-38) — an
estimate of −H(y | features) whose differences estimate conditional
mutual information.

``admissible_index = sqrt((relevance² + cmi²)/2)`` (distance from the
ideal (1,1) corner's opposite origin, copyGenerateAdmissibleIndex:401);
a feature is *admissible* when both indices clear their thresholds.

The underlying models are the port's GBM, DRF and GLM, trained on the
builder's ``device``; the infogram layer itself is orchestration, and
the CMI estimate reads each model's probabilities on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..frame.frame import Frame
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo

_LOG2 = float(np.log(2.0))


@dataclasses.dataclass
class InfogramParameters(Parameters):
    algorithm: str = "gbm"                 # gbm | drf | glm
    infogram_algorithm_params: Optional[dict] = None
    protected_columns: Optional[Sequence[str]] = None
    total_information_threshold: float = -1.0   # core x-axis threshold
    net_information_threshold: float = -1.0     # core y-axis threshold
    relevance_index_threshold: float = -1.0     # fair x-axis threshold
    safety_index_threshold: float = -1.0        # fair y-axis threshold
    top_n_features: int = 50
    data_fraction: float = 1.0


class InfogramModel(Model):
    algo = "infogram"

    def predict(self, frame: Frame) -> Frame:
        raise NotImplementedError(
            "Infogram is a diagnostic, not a scorer: read "
            "output['admissible_score'] / admissible_features, then train "
            "a downstream model on the admissible columns")

    def admissible_score_frame(self) -> List[dict]:
        return self.output["admissible_score"]

    @property
    def admissible_features(self) -> List[str]:
        return self.output["admissible_features"]


class Infogram(ModelBuilder):
    algo = "infogram"
    model_class = InfogramModel

    def __init__(self, params: Optional[InfogramParameters] = None, **kw):
        super().__init__(params or InfogramParameters(**kw))
        self._seed = None

    def _builder_cls(self):
        from . import GBM, DRF, GLM
        return {"gbm": GBM, "drf": DRF, "glm": GLM}[
            self.params.algorithm.lower()]

    def _sub_params(self) -> dict:
        p = self.params
        base = dict(p.infogram_algorithm_params or {})
        if self._seed is None:
            self._seed = p.effective_seed()
        base.setdefault("seed", self._seed)
        if p.algorithm.lower() in ("gbm", "drf"):
            base.setdefault("ntrees", 20)
            base.setdefault("max_depth", 5)
        elif p.algorithm.lower() == "glm":
            base.setdefault("family", "auto")
        base["response_column"] = p.response_column
        base["device"] = p.device
        if p.weights_column:
            base["weights_column"] = p.weights_column
        return base

    def _train_sub(self, frame: Frame, cols: List[str]):
        p = self.params
        keep = list(cols) + [p.response_column]
        if p.weights_column:
            keep.append(p.weights_column)
        sub = frame[keep]
        return self._builder_cls()(**self._sub_params()).train(sub)

    @staticmethod
    def _mean_log2_prob(model, frame: Frame, y: np.ndarray,
                        w: Optional[np.ndarray]) -> float:
        """EstimateCMI.java:29-38 — mean log2 p(true class) over rows."""
        probs = model._predict_raw(
            model._score_matrix(frame)).cpu().numpy()[: frame.nrows]
        p_true = probs[np.arange(len(y)), y]
        ok = (p_true > 0) & np.isfinite(p_true) & (y >= 0)
        if w is not None:
            ok &= w > 0
        if not ok.any():
            return 0.0
        return float(np.mean(np.log(p_true[ok])) / _LOG2)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> InfogramModel:
        p: InfogramParameters = self.params
        if not di.is_classifier:
            raise ValueError("infogram requires a categorical response")
        protected = list(p.protected_columns or [])
        build_core = not protected
        for c in protected:
            if c not in frame.names:
                raise ValueError(f"protected column {c!r} not in frame")

        # threshold resolution (Infogram.java:184-240)
        if build_core:
            rel_thr = p.total_information_threshold
            cmi_thr = p.net_information_threshold
        else:
            rel_thr = p.relevance_index_threshold
            cmi_thr = p.safety_index_threshold
        rel_thr = 0.1 if rel_thr == -1 else rel_thr
        cmi_thr = 0.1 if cmi_thr == -1 else cmi_thr

        if 0 < p.data_fraction < 1.0:
            frame = frame.split_frame([p.data_fraction],
                                      seed=p.effective_seed())[0]

        skip = {p.response_column, p.weights_column, p.fold_column,
                *protected, *(p.ignored_columns or ())}
        predictors = [c for c in frame.names
                      if c not in skip and c is not None]
        y = np.asarray(frame.vec(p.response_column).to_numpy()).astype(int)
        w = None
        if p.weights_column:
            w = np.asarray(frame.vec(p.weights_column).to_numpy())

        model = InfogramModel(job.dest_key, p, di)

        # relevance model: all predictors (core) / all minus protected
        # (fair) — extractRelevance (Infogram.java:608-622)
        full = self._train_sub(frame, predictors)
        from ..explain import _varimp_of
        vi = _varimp_of(full) or {}
        # fold one-hot names back onto source columns
        rel: Dict[str, float] = {c: 0.0 for c in predictors}
        for name, v in vi.items():
            col = name.split(".", 1)[0] if name not in rel else name
            if col in rel:
                rel[col] += float(v)
        if len(predictors) > p.top_n_features:
            ranked = sorted(predictors, key=lambda c: -rel[c])
            predictors = ranked[: p.top_n_features]
        max_rel = max(rel[c] for c in predictors) or 1.0
        relevance = {c: rel[c] / max_rel for c in predictors}

        # per-predictor CMI models + the reference point
        cmi_raw: Dict[str, float] = {}
        n_models = len(predictors) + 1
        if build_core:
            base_cmi = self._mean_log2_prob(full, frame, y, w)
            for i, c in enumerate(predictors):
                others = [o for o in predictors if o != c]
                m = self._train_sub(frame, others)
                cmi_raw[c] = max(0.0, base_cmi
                                 - self._mean_log2_prob(m, frame, y, w))
                job.update((i + 2) / (n_models + 1),
                           f"infogram model {i + 2}/{n_models}")
        else:
            base_model = self._train_sub(frame, protected)
            base_cmi = self._mean_log2_prob(base_model, frame, y, w)
            for i, c in enumerate(predictors):
                m = self._train_sub(frame, protected + [c])
                cmi_raw[c] = max(0.0, self._mean_log2_prob(m, frame, y, w)
                                 - base_cmi)
                job.update((i + 2) / (n_models + 1),
                           f"infogram model {i + 2}/{n_models}")
        max_cmi = max(cmi_raw.values(), default=0.0)
        scale = 1.0 / max_cmi if max_cmi > 0 else 0.0
        cmi = {c: cmi_raw[c] * scale for c in predictors}

        rows = []
        for c in predictors:
            r, s = relevance[c], cmi[c]
            rows.append({
                "column": c,
                "admissible": float(r >= rel_thr and s >= cmi_thr),
                "admissible_index": float(np.sqrt((r * r + s * s) / 2.0)),
                "relevance": r, "cmi": s, "cmi_raw": cmi_raw[c]})
        rows.sort(key=lambda d: -d["admissible_index"])
        model.output.update({
            "admissible_score": rows,
            "admissible_features": [d["column"] for d in rows
                                    if d["admissible"]],
            "relevance_threshold": rel_thr,
            "cmi_threshold": cmi_thr,
            "build_core": build_core,
            "protected_columns": protected,
            "nmodels_trained": n_models,
            "model_category": "Infogram",
        })
        return model
