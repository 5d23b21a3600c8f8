"""GLRM — the port of ``h2o3_tpu/models/glrm.py`` (hex/glrm/GLRM.java:52):
a generalized low-rank model by alternating minimization.

The transformed design ``A`` (the PCA transforms, rows of weight 0
zeroed) is factored as ``X Y``.  With the quadratic loss everywhere and
no or quadratic regularizers each iteration is the closed-form
alternating solve (cuBLAS f32 products and [k, k] inverses on the
device); any other loss (``loss``, ``multi_loss`` for the categorical
one-hot blocks, ``loss_by_col``) or regularizer (``l1``,
``non_negative``, ``one_sparse``, ``simplex``) takes the proximal
alternating gradient path, whose step grows by 1.05 on an accepted
iteration and halves on a rejected one.  ``init="svd"`` starts from the
top right singular vectors of ``A`` (the Gram's f64 ``eigh`` on the
host), ``init="random"`` from the JAX package's numpy draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo
from .pca import transform_stats

REGULARIZERS = ("none", "quadratic", "l1", "non_negative", "one_sparse",
                "simplex")


@dataclasses.dataclass
class GLRMParameters(Parameters):
    k: int = 1
    gamma_x: float = 0.0
    gamma_y: float = 0.0
    transform: str = "none"
    max_iterations: int = 100
    init: str = "svd"                  # svd | random
    recover_svd: bool = False
    # loss/regularizer zoo (GlrmLoss/GlrmRegularizer enums)
    loss: str = "quadratic"            # quadratic|absolute|huber|poisson|
    # hinge|logistic
    multi_loss: str = "categorical"    # loss for categorical blocks
    loss_by_col: Optional[dict] = None  # {column: loss}
    regularization_x: str = "none"     # none|quadratic|l1|non_negative|
    # one_sparse|simplex
    regularization_y: str = "none"


# ------------------------------------------------------- losses (GlrmLoss)
def _loss_value_grad(name: str):
    """Elementwise loss l(u, a) and dl/du (u = reconstruction)."""
    if name == "quadratic":
        return (lambda u, a: (u - a) ** 2,
                lambda u, a: 2 * (u - a))
    if name == "absolute":
        return (lambda u, a: torch.abs(u - a),
                lambda u, a: torch.sign(u - a))
    if name == "huber":
        return (lambda u, a: torch.where(torch.abs(u - a) <= 1,
                                         0.5 * (u - a) ** 2,
                                         torch.abs(u - a) - 0.5),
                lambda u, a: torch.clamp(u - a, -1.0, 1.0))
    if name == "poisson":
        return (lambda u, a: torch.exp(torch.clamp(u, -30, 30)) - a * u,
                lambda u, a: torch.exp(torch.clamp(u, -30, 30)) - a)
    if name in ("hinge", "categorical"):
        # a in {0,1} -> s in {-1,+1}; categorical: one-vs-all hinge over
        # the block
        return (lambda u, a: torch.clamp_min(1 - (2 * a - 1) * u, 0.0),
                lambda u, a: torch.where((2 * a - 1) * u < 1,
                                         -(2 * a - 1), 0.0))
    if name == "logistic":
        return (lambda u, a: torch.log1p(torch.exp(-torch.clamp(
            (2 * a - 1) * u, -30, 30))),
                lambda u, a: -(2 * a - 1) / (1 + torch.exp(torch.clamp(
                    (2 * a - 1) * u, -30, 30))))
    raise ValueError(f"unknown glrm loss {name!r}")


# ------------------------------------------- regularizers (GlrmRegularizer)
def _prox(name: str, M, step_gamma):
    """Proximal operator applied row-wise (X) / matrix-wise (Y)."""
    if name == "none":
        return M
    if name == "quadratic":
        return M / (1.0 + 2.0 * step_gamma)
    if name == "l1":
        return torch.sign(M) * torch.clamp_min(torch.abs(M) - step_gamma,
                                               0.0)
    if name == "non_negative":
        return torch.clamp_min(M, 0.0)
    if name == "one_sparse":            # keep the largest entry per row
        keep = torch.argmax(torch.abs(M), dim=-1, keepdim=True)
        mask = torch.arange(M.shape[-1], device=M.device)[None, :] == keep
        return torch.where(mask, torch.clamp_min(M, 0.0), 0.0)
    if name == "simplex":               # project rows onto the simplex
        s = torch.sort(M, dim=-1, descending=True).values
        css = torch.cumsum(s, dim=-1) - 1
        idx = torch.arange(1, M.shape[-1] + 1, device=M.device)
        cond = s - css / idx > 0
        rho = cond.sum(dim=-1, keepdim=True)
        theta = torch.gather(css, -1, rho - 1) / rho
        return torch.clamp_min(M - theta, 0.0)
    raise ValueError(f"unknown glrm regularizer {name!r}")


def _reg_value(name: str, M, gamma):
    if name == "quadratic":
        return gamma * torch.sum(M * M)
    if name == "l1":
        return gamma * torch.sum(torch.abs(M))
    return 0.0


def _design(model, frame: Frame) -> torch.Tensor:
    X = model.datainfo.make_matrix(frame)
    mu = torch.as_tensor(np.asarray(model.output["_mu"], np.float32),
                         device=X.device)
    sd = torch.as_tensor(np.asarray(model.output["_sd"], np.float32),
                         device=X.device)
    return (X - mu[None, :]) * sd[None, :]


class GLRMModel(Model):
    algo = "glrm"

    def _predict_raw(self, X):
        raise NotImplementedError("glrm reconstructs via transform()")

    def _x_factor(self, Xt: torch.Tensor) -> torch.Tensor:
        Y = torch.as_tensor(np.asarray(self.output["archetypes"],
                                       np.float32), device=Xt.device)
        G = Y @ Y.t() + self.params.gamma_x * torch.eye(
            Y.shape[0], device=Xt.device)
        return Xt @ Y.t() @ torch.linalg.inv(G), Y

    def transform(self, frame: Frame) -> Frame:
        """Project new rows onto the archetypes -> X factor frame."""
        Xf, _ = self._x_factor(_design(self, frame))
        Xf = Xf[: frame.nrows].cpu().numpy()
        return Frame([f"Arch{i+1}" for i in range(Xf.shape[1])],
                     [Vec.from_numpy(Xf[:, i].astype(np.float64), T_NUM,
                                     device=frame.device)
                      for i in range(Xf.shape[1])])

    def reconstruct(self, frame: Frame) -> Frame:
        Xf = self.transform(frame)
        Xm = np.stack([v.to_numpy() for v in Xf.vecs], axis=1)
        Y = np.asarray(self.output["archetypes"])
        R = Xm @ Y
        mu = np.asarray(self.output["_mu"])
        sd = np.asarray(self.output["_sd"])
        R = R / np.where(sd == 0, 1, sd)[None, :] + mu[None, :]
        names = self.output["feature_names"]
        return Frame([f"reconstr_{n}" for n in names],
                     [Vec.from_numpy(R[:, i], T_NUM, device=frame.device)
                      for i in range(R.shape[1])])

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        Xt = _design(self, frame)
        Xf, Y = self._x_factor(Xt)
        R = Xt - Xf @ Y
        w = self.datainfo.weights(frame)
        return {"objective": float(((R * R).sum(dim=1) * w).sum())}


class GLRM(ModelBuilder):
    """GLRM builder — H2OGeneralizedLowRankEstimator analog."""

    algo = "glrm"
    model_class = GLRMModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[GLRMParameters] = None, **kw):
        super().__init__(params or GLRMParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            standardize=False, use_all_factor_levels=True,
            add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> GLRMModel:
        p: GLRMParameters = self.params
        if p.init not in ("svd", "random"):
            raise ValueError(f"init={p.init!r}: svd|random")
        k = min(p.k, di.nfeatures)
        X0 = di.make_matrix(frame)
        w = di.weights(frame)
        mu_t, sd_t, _ = transform_stats(X0, w, p.transform)
        A = (X0 - mu_t[None, :]) * sd_t[None, :] * (w[:, None] > 0)
        dev = A.device

        rng = np.random.default_rng(p.effective_seed())
        if p.init == "svd":
            G = (A.t() @ A).cpu().numpy().astype(np.float64)
            vals, vecs = np.linalg.eigh(G)
            Y = vecs[:, np.argsort(vals)[::-1][:k]].T
        else:
            Y = rng.normal(size=(k, di.nfeatures)) / np.sqrt(k)
        Y = torch.as_tensor(np.asarray(Y, np.float32), device=dev)

        # per-design-column losses: numeric -> loss/loss_by_col; categorical
        # one-hot blocks -> multi_loss with {0,1} targets
        loss_by_col = dict(p.loss_by_col or {})
        col_loss: list = []
        for spec in di.specs:
            name = loss_by_col.get(spec.name,
                                   p.multi_loss if spec.type == T_CAT
                                   else p.loss)
            col_loss.extend([name] * spec.width)
        col_loss = col_loss[: di.nfeatures]
        for nm in set(col_loss):
            _loss_value_grad(nm)                 # an unknown loss raises
        for nm in (p.regularization_x, p.regularization_y):
            if nm not in REGULARIZERS:
                raise ValueError(f"unknown glrm regularizer {nm!r}")
        all_quadratic = all(c == "quadratic" for c in col_loss)
        plain_regs = p.regularization_x in ("none", "quadratic") and \
            p.regularization_y in ("none", "quadratic")
        if not (all_quadratic and plain_regs):
            return self._fit_proximal(job, di, A, w, Y, col_loss, k, p,
                                      mu_t, sd_t)

        Ik = torch.eye(k, dtype=torch.float32, device=dev)

        def step(Y):
            Gx = Y @ Y.t() + p.gamma_x * Ik
            X = A @ Y.t() @ torch.linalg.inv(Gx)
            Gy = X.t() @ X + p.gamma_y * Ik
            Y2 = torch.linalg.inv(Gy) @ (X.t() @ A)
            R = A - X @ Y2
            obj = torch.sum(R * R) + p.gamma_x * torch.sum(X * X) \
                + p.gamma_y * torch.sum(Y2 * Y2)
            return X, Y2, obj

        prev = np.inf
        for it in range(p.max_iterations):
            X, Y, obj = step(Y)
            obj = float(obj)
            job.update(it / p.max_iterations, f"iter={it} obj={obj:.5g}")
            if prev - obj < 1e-7 * max(abs(prev), 1.0):
                break
            prev = obj

        model = GLRMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "archetypes": Y.cpu().numpy().astype(np.float64),
            "objective": obj,
            "iterations": it + 1,
            "feature_names": di.coef_names,
            "_mu": mu_t.cpu().numpy().astype(np.float64),
            "_sd": sd_t.cpu().numpy().astype(np.float64),
        })
        if p.recover_svd:
            Xh = X.cpu().numpy().astype(np.float64)
            _, s, _ = np.linalg.svd(Xh @ Y.cpu().numpy(),
                                    full_matrices=False)
            model.output["singular_values"] = s[:k]
        model.training_metrics = {"objective": obj}
        return model

    # ----------------------------------------------- proximal (loss zoo)
    def _fit_proximal(self, job, di, A, w, Y0, col_loss, k, p, mu_t,
                      sd_t) -> GLRMModel:
        """Proximal alternating gradient — the general GlrmLoss/Regularizer
        path (GLRM.java's update_x/update_y with step halving)."""
        n, F = A.shape
        dev = A.device
        obs = (w[:, None] > 0).to(torch.float32)
        loss_names = sorted(set(col_loss))
        masks = {nm: torch.tensor([1.0 if c == nm else 0.0
                                   for c in col_loss], dtype=torch.float32,
                                  device=dev)
                 for nm in loss_names}

        def total_loss_grad(U):
            L = torch.zeros_like(U)
            G = torch.zeros_like(U)
            for nm in loss_names:
                lv, lg = _loss_value_grad(nm)
                m = masks[nm][None, :]
                L = L + m * lv(U, A)
                G = G + m * lg(U, A)
            return torch.sum(L * obs), G * obs

        def prox_iter(X, Y, step):
            _, G = total_loss_grad(X @ Y)
            X2 = _prox(p.regularization_x, X - step * (G @ Y.t()),
                       step * p.gamma_x)
            _, G2 = total_loss_grad(X2 @ Y)
            Y2t = _prox(p.regularization_y, (Y - step * (X2.t() @ G2)).t(),
                        step * p.gamma_y).t()
            lv, _ = total_loss_grad(X2 @ Y2t)
            obj = lv + _reg_value(p.regularization_x, X2, p.gamma_x) \
                + _reg_value(p.regularization_y, Y2t, p.gamma_y)
            return X2, Y2t, obj

        rng = np.random.default_rng(p.effective_seed())
        X = torch.as_tensor((rng.normal(size=(n, k)) * 0.1)
                            .astype(np.float32), device=dev)
        Y = Y0
        step = 1.0 / max(float(torch.abs(A).max()) * F, 1.0)
        lv0, _ = total_loss_grad(X @ Y)
        prev = float(lv0 + _reg_value(p.regularization_x, X, p.gamma_x)
                     + _reg_value(p.regularization_y, Y, p.gamma_y))
        accepted = []
        it = 0
        for it in range(p.max_iterations):
            X2, Y2, obj = prox_iter(X, Y, step)
            obj = float(obj)
            if obj <= prev or not np.isfinite(prev):
                X, Y, prev = X2, Y2, obj
                step *= 1.05                    # accept, grow (GLRM.java)
                accepted.append(True)
            else:
                step *= 0.5                     # reject, halve
                accepted.append(False)
                if step < 1e-12:
                    break
            job.update(it / p.max_iterations, f"iter={it} obj={prev:.5g}")

        model = GLRMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "archetypes": Y.cpu().numpy().astype(np.float64),
            "objective": prev, "iterations": it + 1,
            "feature_names": di.coef_names,
            "_mu": mu_t.cpu().numpy().astype(np.float64),
            "_sd": sd_t.cpu().numpy().astype(np.float64),
            "x_factor": X.cpu().numpy().astype(np.float64),
            "accepted": accepted,
        })
        model.training_metrics = {"objective": prev}
        return model
