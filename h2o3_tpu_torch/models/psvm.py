"""PSVM — the port of ``h2o3_tpu/models/psvm.py`` (hex/psvm/PSVM.java):
a binary kernel SVM on a low-rank feature map.

The gaussian kernel is approximated by random Fourier features of rank
``rank`` (z(x) = sqrt(2/m) cos(x W + b), W and b the JAX package's numpy
draws), which makes the SVM a linear squared-hinge problem in f32,
minimized by ``glm._lbfgs`` (``torch.optim.LBFGS``, strong Wolfe, a
memory of 10) for ``max_iterations`` iterations, as the reference runs
optax's L-BFGS.  Only the gaussian kernel is ported; any other raises,
as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class PSVMParameters(Parameters):
    hyper_param: float = 1.0             # C
    kernel_type: str = "gaussian"
    gamma: float = -1.0                  # -1 -> 1/nfeatures
    rank_ratio: float = -1.0             # -1 -> auto rank
    positive_weight: float = 1.0
    negative_weight: float = 1.0
    sv_threshold: float = 1e-4
    max_iterations: int = 200


class PSVMModel(Model):
    algo = "psvm"

    def _feature_map(self, X: torch.Tensor) -> torch.Tensor:
        W = torch.as_tensor(np.asarray(self.output["rff_w"], np.float32),
                            device=X.device)
        b = torch.as_tensor(np.asarray(self.output["rff_b"], np.float32),
                            device=X.device)
        m = W.shape[1]
        return float(np.sqrt(np.float32(2.0 / m))) * torch.cos(
            X @ W + b[None, :])

    def _beta(self, X):
        return torch.as_tensor(np.asarray(self.output["beta"], np.float32),
                               device=X.device)

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        Z = self._feature_map(X)
        beta = self._beta(X)
        f = Z @ beta[:-1] + beta[-1]
        p1 = torch.sigmoid(2.0 * f)      # decision -> pseudo-probability
        return torch.stack([1 - p1, p1], dim=1)

    def decision_function(self, frame: Frame) -> np.ndarray:
        X = self._score_matrix(frame)
        Z = self._feature_map(X)
        beta = self._beta(X)
        return (Z @ beta[:-1] + beta[-1])[: frame.nrows].cpu().numpy()


class PSVM(ModelBuilder):
    """PSVM builder — H2OSupportVectorMachineEstimator analog."""

    algo = "psvm"
    model_class = PSVMModel

    def __init__(self, params: Optional[PSVMParameters] = None, **kw):
        super().__init__(params or PSVMParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=p.response_column,
            ignored_columns=p.ignored_columns,
            weights_column=p.weights_column,
            standardize=p.standardize,
            missing_values_handling=p.missing_values_handling,
            force_classification=True)

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if self.params.kernel_type != "gaussian":
            raise ValueError("psvm supports kernel_type='gaussian'")

    def _fit(self, job: Job, frame: Frame, di, valid) -> PSVMModel:
        from .glm import _lbfgs
        p: PSVMParameters = self.params
        if di.nclasses != 2:
            raise ValueError("psvm is a binary classifier")
        X = di.make_matrix(frame)
        y01 = torch.nan_to_num(di.response(frame))
        ysvm = 2.0 * y01 - 1.0                       # {-1, +1}
        w = di.weights(frame)
        w = w * torch.where(ysvm > 0, p.positive_weight, p.negative_weight)
        F = X.shape[1]
        gamma = (1.0 / max(F, 1)) if p.gamma <= 0 else p.gamma
        n = frame.nrows
        rank = int(min(max(64, np.sqrt(n) * 4), 1024)) \
            if p.rank_ratio <= 0 else int(max(p.rank_ratio * n, 16))
        rng = np.random.default_rng(p.effective_seed())
        W = rng.normal(0.0, np.sqrt(2.0 * gamma), size=(F, rank))
        b = rng.uniform(0, 2 * np.pi, rank)

        model = PSVMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output["rff_w"] = W
        model.output["rff_b"] = b
        model.output["gamma"] = gamma
        model.output["rank"] = rank
        Z = model._feature_map(X)
        C = p.hyper_param

        def obj(beta):
            f = Z @ beta[:-1] + beta[-1]
            margin = torch.clamp_min(1.0 - ysvm * f, 0.0)
            return 0.5 * torch.sum(beta[:-1] ** 2) \
                + C * torch.sum(w * margin ** 2)

        iters = int(p.max_iterations)
        beta, values = _lbfgs(obj, torch.zeros(rank + 1, dtype=torch.float32,
                                               device=X.device), iters)
        f = Z @ beta[:-1] + beta[-1]
        margins = ysvm * f
        mask = torch.arange(X.shape[0], device=X.device) < n
        n_sv = int(((margins < 1.0 - p.sv_threshold) & mask
                    & (w > 0)).sum())
        model.output.update({
            "beta": beta.cpu().numpy().astype(np.float64),
            "svs_count": n_sv,
            "objective": float(obj(beta)),
            "iterations": len(values),
        })
        from ..metrics.core import make_metrics
        raw = model._predict_raw(X)
        model.training_metrics = make_metrics(di, raw, y01, di.weights(frame))
        return model
