"""PCA and SVD — the port of ``h2o3_tpu/models/pca.py``
(hex/pca/PCA.java:41, hex/svd/SVD.java).

The transform (``none``, ``standardize``, ``normalize``, ``demean``,
``descale``) is applied a row block at a time (``datainfo.row_blocks``):
the weighted Gram ``Xt' (w Xt)`` is a sum of cuBLAS f32 products over
the blocks (``_gram``), so a 10M-row design needs no second [N, P]
matrix; the [P, P] Gram goes to the host for an f64 ``eigh``
(``gram_s_v_d``), power iteration with deflation (``power``), or the
Halko sketch (``randomized``: its tall-skinny products on the device,
blocked, a reduced QR, the SVD of the small B on the host).  The sign
convention makes each component's largest entry positive.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from . import datainfo as _di
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo

TRANSFORMS = ("none", "standardize", "normalize", "demean", "descale")


@dataclasses.dataclass
class PCAParameters(Parameters):
    k: int = 1
    transform: str = "none"
    pca_method: str = "gram_s_v_d"      # gram_s_v_d | power | randomized
    use_all_factor_levels: bool = False
    compute_metrics: bool = True
    max_iterations: int = 1000


def _transform_flags(transform: str):
    if transform not in TRANSFORMS:
        raise ValueError(f"transform must be one of {TRANSFORMS}")
    demean = transform in ("standardize", "demean")
    descale = transform in ("standardize", "normalize", "descale")
    return demean, descale


def _blocks(X, mu, sd):
    """(start, stop, the transformed block ``(X - mu) * sd``) over the
    row blocks of X."""
    for r0, r1 in _di.row_blocks(*X.shape):
        yield r0, r1, (X[r0:r1] - mu[None, :]) * sd[None, :]


def _gram(X, w, mu, sd):
    """The weighted Gram ``Xt' (w Xt)`` [P, P] in f32 of the transformed
    design ``Xt = (X - mu) * sd``, summed over row blocks."""
    P = X.shape[1]
    G = torch.zeros((P, P), dtype=X.dtype, device=X.device)
    for r0, r1, Xt in _blocks(X, mu, sd):
        G.addmm_(Xt.t(), Xt * w[r0:r1, None])
    return G


def _moments(X, w):
    """(n = max(sum w, 1), the weighted means [P], the weighted variances
    [P] over n - 1), reduced over row blocks."""
    N, P = X.shape
    n = w.sum().clamp_min(1.0)
    s = torch.zeros(P, dtype=X.dtype, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        s += (X[r0:r1] * w[r0:r1, None]).sum(dim=0)
    mu = s / n
    v = torch.zeros(P, dtype=X.dtype, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        v += ((X[r0:r1] - mu[None, :]) ** 2 * w[r0:r1, None]).sum(dim=0)
    return n, mu, v / (n - 1.0).clamp_min(1.0)


def transform_stats(X, w, transform: str):
    """(mu, sd, n) of the PCA transform: ``Xt = (X - mu) * sd`` with the
    weighted mean when demeaning and 1 / the weighted sd when
    descaling."""
    n, mu_all, var = _moments(X, w)
    demean, descale = _transform_flags(transform)
    mu = mu_all if demean else torch.zeros_like(mu_all)
    sd = torch.where(var > 0, 1.0 / torch.sqrt(var), 1.0) if descale \
        else torch.ones_like(var)
    return mu, sd, n


def _fitted(model, X):
    return (torch.as_tensor(np.asarray(model.output["_mu"], np.float32),
                            device=X.device),
            torch.as_tensor(np.asarray(model.output["_sd"], np.float32),
                            device=X.device))


class _ProjectionMixin:
    """Shared fitted-projection plumbing for PCA/SVD models."""

    def _std_matrix(self, frame: Frame) -> torch.Tensor:
        X = self.datainfo.make_matrix(frame)
        mu, sd = _fitted(self, X)
        return (X - mu[None, :]) * sd[None, :]

    def _score_matrix(self, frame: Frame) -> torch.Tensor:
        # _predict_raw projects in the fitted transform's space
        return self._std_matrix(frame)

    def _project(self, frame: Frame, V: np.ndarray) -> torch.Tensor:
        """The transformed design times ``V``, a row block at a time."""
        X = self.datainfo.make_matrix(frame)
        mu, sd = _fitted(self, X)
        Vd = torch.as_tensor(np.asarray(V, np.float32), device=X.device)
        out = torch.empty((X.shape[0], Vd.shape[1]), dtype=X.dtype,
                          device=X.device)
        for r0, r1, Xt in _blocks(X, mu, sd):
            out[r0:r1] = Xt @ Vd
        return out

    def _reconstruction_mse(self, frame: Frame, V: np.ndarray) -> dict:
        X = self.datainfo.make_matrix(frame)
        w = self.datainfo.weights(frame)
        mu, sd = _fitted(self, X)
        Vd = torch.as_tensor(np.asarray(V, np.float32), device=X.device)
        se = torch.zeros((), dtype=X.dtype, device=X.device)
        for r0, r1, Xt in _blocks(X, mu, sd):
            R = Xt - (Xt @ Vd) @ Vd.t()
            se += ((R * R).sum(dim=1) * w[r0:r1]).sum()
        return {"reconstruction_mse": float(se / w.sum().clamp_min(1.0))}

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout (the JAX
        package's ``export/mojo.py::_extract`` for PCA and SVD): the
        components and the transform's mu and 1/sd, scored by
        ``ScoringModel._score_pca``."""
        from ..export.mojo import archive_meta
        o = self.output
        return archive_meta(self, "pca"), {
            "eigenvectors": np.asarray(o.get("eigenvectors", o.get("v")),
                                       np.float64),
            "mu": np.asarray(o["_mu"], np.float64),
            "sd": np.asarray(o["_sd"], np.float64)}


def _frame_of(Z: np.ndarray, prefix: str, device) -> Frame:
    return Frame([f"{prefix}{i + 1}" for i in range(Z.shape[1])],
                 [Vec.from_numpy(Z[:, i].astype(np.float64), T_NUM,
                                 device=device) for i in range(Z.shape[1])])


class PCAModel(_ProjectionMixin, Model):
    algo = "pca"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        V = torch.as_tensor(np.asarray(self.output["eigenvectors"],
                                       np.float32), device=X.device)
        return X @ V

    def predict(self, frame: Frame) -> Frame:
        Z = self._project(frame, self.output["eigenvectors"])
        return _frame_of(Z[: frame.nrows].cpu().numpy(), "PC", frame.device)

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        # reconstruction MSE in the transformed space on the given frame
        return self._reconstruction_mse(frame, self.output["eigenvectors"])


class PCA(ModelBuilder):
    """PCA builder — h2o.prcomp / H2OPrincipalComponentAnalysisEstimator
    analog."""

    algo = "pca"
    model_class = PCAModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[PCAParameters] = None, **kw):
        super().__init__(params or PCAParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            standardize=False, use_all_factor_levels=p.use_all_factor_levels,
            add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> PCAModel:
        p: PCAParameters = self.params
        k = min(p.k, di.nfeatures)
        X = di.make_matrix(frame)
        w = di.weights(frame)
        mu, sd, n = transform_stats(X, w, p.transform)

        if p.pca_method == "randomized":
            eigvec, eigval = self._randomized(X, w, mu, sd, k, n, p)
        elif p.pca_method == "power":
            eigvec, eigval = self._power(X, w, mu, sd, k, n, p)
        elif p.pca_method == "gram_s_v_d":
            G = _gram(X, w, mu, sd)
            G = G.cpu().numpy().astype(np.float64) \
                / max(float(n) - 1.0, 1.0)
            vals, vecs = np.linalg.eigh(G)
            order = np.argsort(vals)[::-1][:k]
            eigval, eigvec = vals[order], vecs[:, order]
        else:
            raise ValueError(f"pca_method={p.pca_method!r}: gram_s_v_d|"
                             "power|randomized")

        eigval = np.maximum(np.asarray(eigval, np.float64), 0.0)
        sdev = np.sqrt(eigval)
        eigvec = sign_convention(eigvec)

        tv = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
        for r0, r1, Xt in _blocks(X, mu, sd):
            tv += (Xt * Xt * w[r0:r1, None]).sum(dim=0)
        total_var = float((tv / (n - 1.0).clamp_min(1.0)).sum())
        pve = sdev ** 2 / total_var if total_var > 0 else sdev * 0

        model = PCAModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "eigenvectors": np.asarray(eigvec, np.float64),
            "std_deviation": sdev,
            "pct_variance": pve,
            "cum_pct_variance": np.cumsum(pve),
            "coef_names": di.coef_names,
            "k": int(k),
            "_mu": mu.cpu().numpy().astype(np.float64),
            "_sd": sd.cpu().numpy().astype(np.float64),
        })
        if p.compute_metrics:
            model.training_metrics = {"total_variance": total_var}
        return model

    # -------------------------------------------------- iterative methods
    def _power(self, X, w, mu, sd, k, n, p):
        """Power iteration with deflation on the [P,P] Gram (PCA.java
        Power), on the host in f64."""
        G = _gram(X, w, mu, sd)
        G = G.cpu().numpy().astype(np.float64) / max(float(n) - 1.0, 1.0)
        P = G.shape[0]
        rng = np.random.default_rng(p.effective_seed())
        vecs, vals = [], []
        for _ in range(k):
            v = rng.normal(size=P)
            v /= np.linalg.norm(v)
            for _ in range(p.max_iterations):
                v2 = G @ v
                for u in vecs:
                    v2 -= (u @ v2) * u
                nv = np.linalg.norm(v2)
                if nv == 0:
                    break
                v2 /= nv
                if np.abs(v2 @ v) > 1 - 1e-12:
                    v = v2
                    break
                v = v2
            lam = float(v @ G @ v)
            vecs.append(v)
            vals.append(lam)
        return np.stack(vecs, axis=1), np.array(vals)

    def _randomized(self, X, w, mu, sd, k, n, p):
        """Halko randomized SVD: the sketch and 2 power passes as blocked
        tall-skinny products, then the SVD of B on the host."""
        P = X.shape[1]
        rng = np.random.default_rng(p.effective_seed())
        ell = min(P, k + 8)
        Om = torch.as_tensor(rng.normal(size=(P, ell)).astype(np.float32),
                             device=X.device)
        N = X.shape[0]

        def wx_times(M):                       # (Xt * w) @ M, [N, ell]
            Y = torch.empty((N, M.shape[1]), dtype=X.dtype,
                            device=X.device)
            for r0, r1, Xt in _blocks(X, mu, sd):
                Y[r0:r1] = (Xt * w[r0:r1, None]) @ M
            return Y

        def xt_times(Q):                       # Xt' @ Q, [P, ell]
            out = torch.zeros((P, Q.shape[1]), dtype=X.dtype,
                              device=X.device)
            for r0, r1, Xt in _blocks(X, mu, sd):
                out += Xt.t() @ Q[r0:r1]
            return out

        Y = wx_times(Om)
        for _ in range(2):
            Q, _ = torch.linalg.qr(Y)
            Y = wx_times(xt_times(Q))
        Q, _ = torch.linalg.qr(Y)
        sw = torch.sqrt(w)
        B = torch.zeros((Q.shape[1], P), dtype=X.dtype, device=X.device)
        for r0, r1, Xt in _blocks(X, mu, sd):
            B += Q[r0:r1].t() @ (Xt * sw[r0:r1, None])
        Bh = B.cpu().numpy().astype(np.float64)
        _, s, Vt = np.linalg.svd(Bh, full_matrices=False)
        vals = (s ** 2) / max(float(n) - 1.0, 1.0)
        return Vt[:k].T, vals[:k]


def sign_convention(V: np.ndarray) -> np.ndarray:
    """Each column with its largest |entry| positive (prcomp-like)."""
    V = np.array(V, np.float64)
    for j in range(V.shape[1]):
        i = np.argmax(np.abs(V[:, j]))
        if V[i, j] < 0:
            V[:, j] = -V[:, j]
    return V


# ============================================================ SVD builder
@dataclasses.dataclass
class SVDParameters(PCAParameters):
    nv: int = 1
    svd_method: str = "gram_s_v_d"
    keep_u: bool = True


class SVDModel(_ProjectionMixin, Model):
    algo = "svd"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        V = torch.as_tensor(np.asarray(self.output["v"], np.float32),
                            device=X.device)
        d = torch.as_tensor(np.asarray(self.output["d"], np.float32),
                            device=X.device)
        return (X @ V) / d[None, :].clamp_min(1e-30)

    def predict(self, frame: Frame) -> Frame:
        d = torch.as_tensor(np.asarray(self.output["d"], np.float32))
        U = self._project(frame, self.output["v"])
        U = U / d.to(U.device)[None, :].clamp_min(1e-30)
        return _frame_of(U[: frame.nrows].cpu().numpy(), "u", frame.device)

    def model_performance(self, frame=None):
        if frame is None:
            return self.training_metrics
        return self._reconstruction_mse(frame, self.output["v"])


class SVD(PCA):
    """SVD builder — hex/svd/SVD.java analog (d, V, optional U)."""

    algo = "svd"
    model_class = SVDModel

    def __init__(self, params: Optional[SVDParameters] = None, **kw):
        ModelBuilder.__init__(self, params or SVDParameters(**kw))

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> SVDModel:
        p: SVDParameters = self.params
        k = min(p.nv, di.nfeatures)
        X = di.make_matrix(frame)
        w = di.weights(frame)
        mu, sd, _ = transform_stats(X, w, p.transform)
        G = _gram(X, w, mu, sd)
        vals, vecs = np.linalg.eigh(G.cpu().numpy().astype(np.float64))
        order = np.argsort(vals)[::-1][:k]
        vals = np.maximum(vals[order], 0.0)
        V = vecs[:, order]
        d = np.sqrt(vals)
        model = SVDModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "d": d, "v": V, "coef_names": di.coef_names, "k": int(k),
            "_mu": mu.cpu().numpy().astype(np.float64),
            "_sd": sd.cpu().numpy().astype(np.float64),
        })
        model.training_metrics = {"d": d.tolist()}
        if p.keep_u:
            u = model.predict(frame)
            u_key = dkv.make_key("svd_u")
            u.key = u_key
            dkv.put(u_key, u)
            model.output["u_key"] = u_key
        return model
