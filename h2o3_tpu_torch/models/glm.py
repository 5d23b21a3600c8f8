"""GLM: generalized linear models with elastic-net regularization — the
port of ``h2o3_tpu/models/glm.py``.

Reference: ``hex/glm/GLM.java:1573`` (GLMDriver; IRLSM:2143, L-BFGS:2757,
COD:2840), ``hex/glm/GLMTask.java`` (gradient/Hessian MRTasks),
``hex/gram/Gram.java:1017`` (distributed X'X accumulation, reduce = matrix
add, Cholesky on the driver), families/links in ``hex/glm/GLMModel.java:978``.

The per-iteration hot loop is the weighted Gram ``X'WX`` and ``X'Wz`` over
the design matrix (``weighted_gram``): f32 matrix products on the device,
accumulated over row blocks so that no second [N, P] tensor exists beside
the design, in full f32 (no TF32: a 10-bit mantissa would move the
coefficients).  The small P x P system is fetched once an IRLS iteration
and solved on the host in f64 (``_solve_penalized``: one solve for pure
L2, cyclic coordinate descent on the Gram for L1 or ``non_negative``),
as the reference's driver does: this is the design, not a fallback.  The
lambda path warm-starts each lambda from the last, with ``beta_epsilon``
ending its IRLS loop.  Multinomial runs per-class Newton blocks on softmax
probabilities; L-BFGS and ordinal (proportional odds, softplus gaps for
ordered thresholds) minimize their objectives with ``torch.optim.LBFGS``
(strong-Wolfe line search) on the device, with the JAX package's
iteration caps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..frame.frame import Frame
from ..metrics.core import make_metrics
from ..runtime import dkv
from ..runtime.job import Job
from ..runtime.observability import log
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


# ------------------------------------------------------------------- families
class _Family:
    name = "gaussian"

    def linkinv(self, eta):
        return eta

    def variance(self, mu):
        return torch.ones_like(mu)

    def dlinkinv(self, eta, mu):
        """d mu / d eta."""
        return torch.ones_like(eta)

    def deviance(self, y, mu, w):
        return (w * (y - mu) ** 2).sum()

    def init_eta(self, y, w):
        mean = (w * y).sum() / w.sum().clamp_min(1e-12)
        return torch.full_like(y, float(mean))


class _Gaussian(_Family):
    pass


class _Binomial(_Family):
    name = "binomial"

    def linkinv(self, eta):
        return torch.sigmoid(eta)

    def variance(self, mu):
        return mu * (1 - mu)

    def dlinkinv(self, eta, mu):
        return mu * (1 - mu)

    def deviance(self, y, mu, w):
        mu = mu.clamp(1e-15, 1 - 1e-15)
        return -2 * (w * (y * torch.log(mu)
                          + (1 - y) * torch.log1p(-mu))).sum()

    def init_eta(self, y, w):
        p = ((w * y).sum() / w.sum().clamp_min(1e-12)).clamp(1e-6, 1 - 1e-6)
        return torch.full_like(y, float(torch.log(p / (1 - p))))


class _Quasibinomial(_Binomial):
    name = "quasibinomial"


def _mean_eta(y, w):
    """The log of the weighted mean response (at least 1e-6), every row."""
    m = ((w * y).sum() / w.sum().clamp_min(1e-12)).clamp_min(1e-6)
    return torch.full_like(y, float(torch.log(m)))


class _Poisson(_Family):
    name = "poisson"

    def linkinv(self, eta):
        return torch.exp(eta.clamp(-30, 30))

    def variance(self, mu):
        return mu

    def dlinkinv(self, eta, mu):
        return mu

    def deviance(self, y, mu, w):
        mu = mu.clamp_min(1e-15)
        t = torch.where(y > 0, y * torch.log(y / mu), 0.0)
        return 2 * (w * (t - (y - mu))).sum()

    def init_eta(self, y, w):
        return _mean_eta(y, w)


class _Gamma(_Family):
    name = "gamma"

    def linkinv(self, eta):
        return torch.exp(eta.clamp(-30, 30))

    def variance(self, mu):
        return mu * mu

    def dlinkinv(self, eta, mu):
        return mu

    def deviance(self, y, mu, w):
        mu = mu.clamp_min(1e-15)
        ys = y.clamp_min(1e-15)
        return 2 * (w * (-torch.log(ys / mu) + (ys - mu) / mu)).sum()

    def init_eta(self, y, w):
        return _mean_eta(y, w)


class _Tweedie(_Family):
    name = "tweedie"

    def __init__(self, p: float):
        self.p = float(p)

    def linkinv(self, eta):
        return torch.exp(eta.clamp(-30, 30))

    def variance(self, mu):
        return torch.pow(mu.clamp_min(1e-15), self.p)

    def dlinkinv(self, eta, mu):
        return mu

    def deviance(self, y, mu, w):
        p = self.p
        mu = mu.clamp_min(1e-15)
        if p == 1.0:
            return _Poisson().deviance(y, mu, w)
        if p == 2.0:
            return _Gamma().deviance(y, mu, w)
        ys = y.clamp_min(0.0)
        a = torch.where(ys > 0, torch.pow(ys.clamp_min(1e-15), 2 - p)
                        / ((1 - p) * (2 - p)), 0.0)
        b = ys * torch.pow(mu, 1 - p) / (1 - p)
        c = torch.pow(mu, 2 - p) / (2 - p)
        return 2 * (w * (a - b + c)).sum()

    def init_eta(self, y, w):
        return _mean_eta(y, w)


class _NegativeBinomial(_Family):
    name = "negativebinomial"

    def __init__(self, theta: float):
        self.theta = float(theta)          # inverse dispersion

    def linkinv(self, eta):
        return torch.exp(eta.clamp(-30, 30))

    def variance(self, mu):
        return mu + self.theta * mu * mu

    def dlinkinv(self, eta, mu):
        return mu

    def deviance(self, y, mu, w):
        mu = mu.clamp_min(1e-15)
        th = self.theta
        ys = y.clamp_min(0.0)
        t1 = torch.where(ys > 0, ys * torch.log(ys / mu), 0.0)
        t2 = (ys + 1.0 / th) * torch.log((1 + th * mu) / (1 + th * ys))
        return 2 * (w * (t1 + t2)).sum()

    def init_eta(self, y, w):
        return _mean_eta(y, w)


def _make_family(name: str, params) -> _Family:
    if name == "tweedie":
        return _Tweedie(params.tweedie_variance_power)
    if name == "negativebinomial":
        return _NegativeBinomial(params.theta)
    return {"gaussian": _Gaussian, "binomial": _Binomial,
            "quasibinomial": _Quasibinomial, "poisson": _Poisson,
            "gamma": _Gamma}[name]()


# -------------------------------------------------------------- device passes
# the rows of one block of the Gram's accumulation: X * w of a block is its
# only temporary (1 GiB)
GRAM_BLOCK_BYTES = 1 << 30


def weighted_gram(X: torch.Tensor, wi: torch.Tensor,
                  z: Optional[torch.Tensor] = None):
    """(X' diag(wi) X [P, P], X' (wi z) [P] or None) in f32, the GramTask
    (gram/Gram.java:1017): the Gram summed over row blocks of X, so the
    weighted block is the only temporary."""
    N, P = X.shape
    rb = max(1, GRAM_BLOCK_BYTES // (4 * P))
    G = torch.zeros((P, P), dtype=torch.float32, device=X.device)
    for r0 in range(0, N, rb):
        Xb = X[r0:r0 + rb]
        G.addmm_((Xb * wi[r0:r0 + rb, None]).t(), Xb)
    return G, (None if z is None else X.t() @ (wi * z))


def irls_stats(family: _Family, X, y, w, beta, offset):
    """One IRLS step's (Gram, X'Wz, deviance) at ``beta`` [P] f32: the
    working response z and weights of the family's link, as the JAX
    package's ``_make_irls_step``."""
    eta = X @ beta + offset
    mu = family.linkinv(eta)
    g = family.dlinkinv(eta, mu).clamp_min(1e-10)
    var = family.variance(mu).clamp_min(1e-10)
    z = (eta - offset) + (y - mu) / g
    gram, xtwz = weighted_gram(X, w * g * g / var, z)
    return gram, xtwz, family.deviance(y, mu, w)


def softmax_stats(K: int, X, y, w, beta, offset):
    """Multinomial's per-class diagonal Newton blocks at ``beta`` [P, K]
    f32: ([K, P, P] Grams, [P, K] X'Wz, the weighted negative
    log-likelihood), as the JAX package's ``_make_softmax_stats``."""
    eta = X @ beta + offset[:, None]
    probs = torch.softmax(eta, dim=1)
    yi = y.long().clamp(0, K - 1)
    p_true = probs.gather(1, yi[:, None])[:, 0].clamp(1e-15, 1.0)
    ll = -(w * torch.log(p_true)).sum()
    grams, xtwz = [], []
    for k in range(K):
        mu = probs[:, k]
        wk = torch.maximum(w * mu * (1 - mu), 1e-10 * w)
        zk = eta[:, k] - offset + ((yi == k).to(mu.dtype) - mu) \
            / (mu * (1 - mu)).clamp_min(1e-10)
        gk, ck = weighted_gram(X, wk, zk)
        grams.append(gk)
        xtwz.append(ck)
    return torch.stack(grams), torch.stack(xtwz).t(), ll


def _host(*tensors) -> List[np.ndarray]:
    """The tensors on the host in f64 (one fetch an IRLS iteration)."""
    return [t.detach().cpu().numpy().astype(np.float64) for t in tensors]


# -------------------------------------------------------------------- solver
def _solve_penalized(gram: np.ndarray, xtwz: np.ndarray, n: float,
                     lam: float, alpha: float, beta0: np.ndarray,
                     penalize: np.ndarray, max_inner: int = 100,
                     tol: float = 1e-8,
                     nonneg: Optional[np.ndarray] = None) -> np.ndarray:
    """Solve 0.5 b'Gb - c'b + lam*(alpha*|b|_1 + (1-alpha)/2 |b|_2^2).

    G = gram/n, c = xtwz/n.  Pure L2 -> one Cholesky solve; any L1 or
    sign constraint -> cyclic coordinate descent on the Gram (the
    reference's COD, GLM.java:2840).  ``penalize`` masks out the
    intercept; ``nonneg`` marks coefficients clamped to >= 0 (the GLM
    ``non_negative`` option — per-coordinate projection, which for CD is
    the exact constrained minimizer).
    """
    G = gram / n
    c = xtwz / n
    # ``penalize`` is a per-coefficient penalty FACTOR (glmnet-style):
    # 0 = unpenalized (intercept, spline null space), 1 = standard, other
    # values scale both the L1 and L2 shares (GAM penalty eigenvalues)
    l2 = lam * (1 - alpha) * penalize
    l1 = lam * alpha * penalize
    constrained = nonneg is not None and bool(np.any(nonneg))
    if np.all(l1 == 0.0) and not constrained:
        A = G + np.diag(l2 + 1e-10)
        try:
            return np.linalg.solve(A, c)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(A, c, rcond=None)[0]
    beta = beta0.copy()
    if constrained:
        beta[nonneg] = np.maximum(beta[nonneg], 0.0)
    d = np.diag(G).copy()
    Gb = G @ beta
    # the sweep's scalars as Python floats and G's columns as contiguous
    # rows: the same IEEE-754 double operations in the same order as on
    # numpy scalars and strided columns, several times faster
    Gt = np.ascontiguousarray(G.T)
    cs, ds, l1s, l2s = c.tolist(), d.tolist(), l1.tolist(), l2.tolist()
    pen = (penalize > 0).tolist()
    clamp = nonneg.tolist() if constrained else [False] * len(beta)
    b = beta.tolist()
    for _ in range(max_inner):
        delta = 0.0
        for j in range(len(b)):
            r = cs[j] - (Gb.item(j) - ds[j] * b[j])
            if pen[j]:
                # np.sign: +-1, 0.0 at either zero, NaN kept
                sgn = 1.0 if r > 0 else -1.0 if r < 0 else \
                    0.0 if r == 0 else r
                bj = sgn * max(abs(r) - l1s[j], 0.0) \
                    / (ds[j] + l2s[j] + 1e-12)
            else:
                bj = r / (ds[j] + 1e-12)
            if clamp[j]:
                bj = max(bj, 0.0)
            diff = bj - b[j]
            if diff != 0.0:
                Gb += Gt[j] * diff
                delta = max(delta, abs(diff))
                b[j] = bj
        if delta < tol:
            break
    beta[:] = b
    return beta


def _lbfgs(obj, x0: torch.Tensor, iters: int):
    """Minimize ``obj`` from ``x0`` with ``torch.optim.LBFGS`` (strong
    Wolfe line search, a memory of 10 as optax's default): ``iters``
    iterations, as optax's fixed-length scan runs them, with torch's
    tolerances at 0 (on an f32 objective they would stop it early, away
    from the optimum); it stops sooner only where the line search makes
    no step.  Returns (x, the objective's last evaluation in each
    iteration)."""
    x = x0.clone().requires_grad_(True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=iters, history_size=10,
                            line_search_fn="strong_wolfe",
                            tolerance_grad=0.0, tolerance_change=0.0)
    values = {}

    def closure():
        opt.zero_grad()
        v = obj(x)
        v.backward()
        values[opt.state[x].get("n_iter", 0)] = float(v.detach())
        return v

    opt.step(closure)
    return x.detach(), [values[k] for k in sorted(values)]


# ---------------------------------------------------------------- parameters
@dataclasses.dataclass
class GLMParameters(Parameters):
    family: str = "auto"                  # auto|gaussian|binomial|quasibinomial|
    # poisson|gamma|tweedie|negativebinomial|multinomial|ordinal
    alpha: float = 0.5
    lambda_: Union[float, Sequence[float], None] = None   # None -> 0 / search
    lambda_search: bool = False
    nlambdas: int = 30
    lambda_min_ratio: float = 1e-4
    solver: str = "irlsm"
    # sign constraint (GLMParameters._non_negative): True = every
    # non-intercept coefficient >= 0; a list of column names constrains
    # only those columns
    non_negative: Union[bool, Sequence[str]] = False
    # per-column penalty factors {column: factor}; cat columns apply the
    # factor to every one-hot slot (glmnet penalty.factor)
    penalty_factors: Optional[dict] = None
    tweedie_variance_power: float = 1.5
    theta: float = 1.0                    # negative binomial
    beta_epsilon: float = 1e-5
    compute_p_values: bool = False
    # the design always holds the intercept column: anything but True
    # raises (the JAX package's field is read nowhere either)
    intercept: bool = True
    max_iterations: int = 50


class GLMModel(Model):
    algo = "glm"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=X.device)
        beta = dev(self.output["beta_std"])
        family = self.output["family"]
        if family == "multinomial":
            return torch.softmax(X @ beta, dim=1)
        if family == "ordinal":
            thetas = dev(self.output["ordinal_thresholds"])
            eta = X @ beta                    # intercept col has beta 0
            cdf = torch.sigmoid(thetas[None, :] - eta[:, None])
            ends = torch.zeros((cdf.shape[0], 1), device=X.device)
            cdf = torch.cat([ends, cdf, ends + 1], dim=1)
            return torch.diff(cdf, dim=1).clamp(0.0, 1.0)
        mu = _make_family(family, self.params).linkinv(X @ beta)
        if self.datainfo.is_classifier:
            return torch.stack([1 - mu, mu], dim=1)
        return mu

    @property
    def coef(self) -> dict:
        return dict(zip(self.output["coef_names"], self.output["beta"]))

    @property
    def coef_norm(self) -> dict:
        return dict(zip(self.output["coef_names"],
                        self.output["beta_std_flat"]))

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout that
        ``export.mojo.from_reference`` reads (the JAX package's
        ``export/mojo.py::_extract`` for GLM): the family's link in the
        metadata and the standardized coefficients ``beta`` ([P], or [P,
        K] for multinomial).  The archive's scorer has no ordinal form, in
        either package, so an ordinal model raises."""
        from ..export.mojo import archive_meta
        fam = self.output.get("family", "gaussian")
        if fam == "ordinal":
            raise ValueError("an ordinal GLM has no archive form: the "
                             "numpy scorer scores no cumulative-logit "
                             "thresholds")
        meta = archive_meta(self, "glm")
        meta["link"] = {"binomial": "logit", "quasibinomial": "logit",
                        "poisson": "log", "gamma": "log", "tweedie": "log",
                        "negativebinomial": "log"}.get(fam, "identity")
        return meta, {"beta": np.asarray(self.output["beta_std"],
                                         np.float64)}


class GLM(ModelBuilder):
    """GLM builder — h2o.glm / H2OGeneralizedLinearEstimator analog."""

    algo = "glm"
    model_class = GLMModel
    takes_offset = True

    def __init__(self, params: Optional[GLMParameters] = None, **kw):
        super().__init__(params or GLMParameters(**kw))
        if self.params.intercept is not True:
            raise NotImplementedError(
                "GLM: intercept=False is not ported to h2o3_tpu_torch; "
                "the design always holds the intercept column")

    def _resolve_family(self, di: DataInfo) -> str:
        fam = self.params.family
        if fam in ("auto", None):
            if di.is_classifier:
                fam = "binomial" if di.nclasses == 2 else "multinomial"
            else:
                fam = "gaussian"
        if fam in ("binomial", "quasibinomial") and not di.is_classifier:
            raise ValueError(f"family={fam} needs a categorical response")
        if fam == "multinomial" and di.nclasses < 3:
            fam = "binomial"
        if fam == "ordinal" and (not di.is_classifier or di.nclasses < 3):
            raise ValueError("family=ordinal needs a categorical response "
                             "with 3+ ordered levels")
        return fam

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> GLMModel:
        p: GLMParameters = self.params
        fam_name = self._resolve_family(di)
        X = di.make_matrix(frame)
        y = torch.nan_to_num(di.response(frame))
        w = di.weights(frame)
        offset = di.offsets(frame)
        offset = offset if offset is not None else torch.zeros_like(y)
        n = float(w.sum())
        P = di.nfeatures
        penalize = np.ones(P)
        if di.add_intercept:
            penalize[-1] = 0.0
        if p.penalty_factors:
            for spec in di.specs:
                f = p.penalty_factors.get(spec.name)
                if f is not None:
                    penalize[spec.offset: spec.offset + spec.width] = f
        nonneg = np.zeros(P, dtype=bool)
        if p.non_negative is True:
            nonneg[:] = True
            if di.add_intercept:
                nonneg[-1] = False
        elif p.non_negative:
            want = set(p.non_negative)
            matched = set()
            for spec in di.specs:
                if spec.name in want:
                    nonneg[spec.offset: spec.offset + spec.width] = True
                    matched.add(spec.name)
            if want - matched:
                raise ValueError(
                    f"non_negative names not in the design: "
                    f"{sorted(want - matched)}")
        if nonneg.any() and (fam_name in ("multinomial", "ordinal")
                             or p.solver.lower() in ("l_bfgs", "lbfgs")):
            raise ValueError("non_negative requires the IRLSM/COD solver "
                             "on a non-multinomial family")
        nonneg = nonneg if nonneg.any() else None
        args = (job, di, X, y, w, offset, n)
        if fam_name == "ordinal":
            lam0 = 0.0 if p.lambda_ is None else float(np.max(p.lambda_))
            return self._fit_ordinal(*args, lam0, valid)
        lambdas = self._lambda_path(p, X, y, w, di, fam_name)
        if fam_name == "multinomial":
            return self._fit_multinomial(*args, penalize, lambdas, valid)
        if p.solver.lower() in ("l_bfgs", "lbfgs"):
            return self._fit_lbfgs(*args, penalize, lambdas[-1], fam_name,
                                   valid)
        return self._fit_single(*args, penalize, lambdas, fam_name, valid,
                                nonneg)

    # -------------------------------------------------------- lambda path
    def _lambda_path(self, p: GLMParameters, X, y, w, di,
                     fam_name) -> List[float]:
        if p.lambda_ is not None and not p.lambda_search:
            return list(np.atleast_1d(np.asarray(p.lambda_,
                                                 dtype=np.float64)))
        if not p.lambda_search:
            return [0.0]
        # lambda_max, the smallest lambda zeroing every coefficient:
        # max |X'W(y - ybar)| / (n alpha)
        fam = _make_family(fam_name, p)
        mu0 = fam.linkinv(fam.init_eta(y, w))
        grad = (X.t() @ (w * (y - mu0))).abs().cpu().numpy()
        if di.add_intercept:
            grad = grad[:-1]
        n = max(float(w.sum()), 1.0)
        lmax = float(grad.max()) / max(p.alpha, 1e-3) / n
        return list(np.geomspace(lmax, lmax * p.lambda_min_ratio,
                                 p.nlambdas))

    # ------------------------------------------------------------- l-bfgs
    def _fit_lbfgs(self, job, di, X, y, w, offset, n, penalize,
                   lam, fam_name, valid) -> GLMModel:
        """L-BFGS — GLM.java:2757's solver=L_BFGS: deviance/(2n) +
        lam*(1-alpha)/2 |b|_2^2, with no L1 (the reference drops it
        without ADMM and so does this solver), at most
        min(max_iterations, 100) iterations."""
        p: GLMParameters = self.params
        if p.alpha > 0 and (np.asarray(lam) > 0).any():
            log.warning("solver='lbfgs' ignores the L1 component "
                        "(alpha=%s); keeping the L2 share", p.alpha)
        fam = _make_family(fam_name, p)
        pen = torch.as_tensor(penalize, dtype=torch.float32,
                              device=X.device)
        lamf = float(lam)

        def obj(beta):
            mu = fam.linkinv(X @ beta + offset)
            return fam.deviance(y, mu, w) / (2 * n) \
                + 0.5 * lamf * (pen * beta ** 2).sum()

        beta0 = torch.zeros(di.nfeatures, dtype=torch.float32,
                            device=X.device)
        if di.add_intercept:
            beta0[-1] = fam.init_eta(y, w)[0]
        beta_t, values = _lbfgs(obj, beta0, int(min(p.max_iterations, 100)))
        hist = [{"lambda": lamf, "iteration": i, "deviance": v * 2 * n,
                 "delta": float("nan")} for i, v in enumerate(values)]
        # the Gram at the solution (p-values in _finalize)
        gram, _, dev = irls_stats(fam, X, y, w, beta_t, offset)
        gram, dev = _host(gram, dev)
        model = GLMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        self._finalize(model, di, beta_t.cpu().numpy().astype(np.float64),
                       fam_name, X, y, w, n, float(dev), hist, lamf, valid,
                       gram_last=gram)
        return model

    # ----------------------------------------------------------- ordinal
    def _fit_ordinal(self, job, di, X, y, w, offset, n, lam,
                     valid) -> GLMModel:
        """Proportional odds (cumulative logit) — GLM.java family=ordinal:
        P(y <= j) = sigmoid(theta_j - X beta) with ordered thresholds
        theta_0 + cumulative softplus gaps, fit jointly by L-BFGS on the
        penalized NLL (at most min(4 max_iterations, 200) iterations);
        the intercept column is absorbed into the thresholds."""
        p: GLMParameters = self.params
        K, P = di.nclasses, di.nfeatures
        Pf = P - 1 if di.add_intercept else P
        yi = y.long().clamp(0, K - 1)
        lamf = float(lam)
        dev = X.device

        def unpack(prm):
            gaps = torch.nn.functional.softplus(prm[Pf + 1:])
            thetas = prm[Pf] + torch.cat([torch.zeros(1, device=dev),
                                          torch.cumsum(gaps, 0)])
            return prm[:Pf], thetas

        def nll(prm):
            beta, thetas = unpack(prm)
            bfull = torch.cat([beta, torch.zeros(P - Pf, device=dev)])
            eta = X @ bfull + offset
            cdf = torch.sigmoid(thetas[None, :] - eta[:, None])
            ends = torch.zeros((cdf.shape[0], 1), device=dev)
            probs = torch.diff(torch.cat([ends, cdf, ends + 1], dim=1),
                               dim=1).clamp(1e-12, 1.0)
            pick = probs.gather(1, yi[:, None])[:, 0]
            return -(w * torch.log(pick)).sum() / n

        def obj(prm):
            return nll(prm) + 0.5 * lamf * (unpack(prm)[0] ** 2).sum()

        p0 = torch.cat([torch.zeros(Pf), torch.tensor([-1.0]),
                        torch.full((K - 2,), 0.5)]).to(dev)
        iters = int(min(p.max_iterations * 4, 200))
        prm, values = _lbfgs(obj, p0, iters)
        beta, thetas = unpack(prm)
        final_nll = float(nll(prm))        # penalty-free, at the end point

        model = GLMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        beta_full = np.zeros(P)
        beta_full[:Pf] = beta.cpu().numpy().astype(np.float64)
        # destandardized for reporting (what _finalize does elsewhere)
        beta_orig = beta_full.copy()
        if di.standardize:
            ci = 0
            for spec in di.specs:
                if spec.type != "cat" and spec.width == 1 \
                        and ci < Pf and spec.sigma:
                    beta_orig[ci] = beta_full[ci] / spec.sigma
                ci += spec.width
        model.output.update({
            "family": "ordinal",
            "beta_std": beta_full,
            "ordinal_thresholds": thetas.cpu().numpy().astype(np.float64),
            "coef_names": di.coef_names,
            "beta_std_flat": beta_full.tolist(),
            "beta": beta_orig.tolist(),
            "iterations": iters,
            "residual_deviance": final_nll * 2 * n,
        })
        model.scoring_history = [
            {"iteration": i, "deviance": v * 2 * n}
            for i, v in enumerate(values[-5:])]
        model.training_metrics = make_metrics(di, model._predict_raw(X),
                                              y, w)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model

    # ------------------------------------------------------- single-class
    def _fit_single(self, job, di, X, y, w, offset, n, penalize,
                    lambdas, fam_name, valid, nonneg) -> GLMModel:
        """IRLSM over the lambda path: per lambda, warm-started from the
        last, IRLS iterations (a device Gram at the current beta, its
        penalized solve on the host) until max|delta beta| <
        ``beta_epsilon`` or ``max_iterations``.  The history has one
        entry per lambda (its iterations and deviance), as the JAX
        package's fused path records it, or, under ``non_negative``, one
        per iteration, as its host loop does."""
        p: GLMParameters = self.params
        fam = _make_family(fam_name, p)
        beta = np.zeros(di.nfeatures, dtype=np.float64)
        if di.add_intercept:
            beta[-1] = float(fam.init_eta(y, w)[0])
        hist = []
        for li, lam in enumerate(lambdas):
            for it in range(p.max_iterations):
                gram, xtwz, dev = _host(*irls_stats(
                    fam, X, y, w, torch.as_tensor(
                        beta, dtype=torch.float32, device=X.device),
                    offset))
                new_beta = _solve_penalized(gram, xtwz, n, lam, p.alpha,
                                            beta, penalize, nonneg=nonneg)
                delta = float(np.max(np.abs(new_beta - beta)))
                beta = new_beta
                if nonneg is not None:
                    hist.append({"lambda": lam, "iteration": it,
                                 "deviance": float(dev), "delta": delta})
                job.update((li + (it + 1) / p.max_iterations)
                           / len(lambdas),
                           f"lambda={lam:.3g} iter={it} dev={float(dev):.4g}")
                if delta < p.beta_epsilon:
                    break
            if nonneg is None:
                hist.append({"lambda": float(lam), "iteration": it + 1,
                             "deviance": float(dev), "delta": float("nan")})
        gram_fin = None
        if p.compute_p_values and lambdas[-1] == 0.0:
            gram_fin = _host(irls_stats(fam, X, y, w, torch.as_tensor(
                beta, dtype=torch.float32, device=X.device), offset)[0])[0]
        model = GLMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        self._finalize(model, di, beta, fam_name, X, y, w, n, float(dev),
                       hist, lambdas[-1], valid, gram_last=gram_fin)
        return model

    # -------------------------------------------------------- multinomial
    def _fit_multinomial(self, job, di, X, y, w, offset, n,
                         penalize, lambdas, valid) -> GLMModel:
        """Block-wise per-class Newton steps on the softmax probabilities
        (the COD-multinomial analog, GLM.java:1643): per iteration the K
        class Grams on the device, K penalized solves on the host, until
        max|delta beta| < ``beta_epsilon`` or the log-likelihood stops
        moving (1e-8 n)."""
        p: GLMParameters = self.params
        K, P = di.nclasses, di.nfeatures
        beta = np.zeros((P, K), dtype=np.float64)
        hist = []
        lam = lambdas[-1]
        ll_prev = np.inf
        for it in range(p.max_iterations):
            grams, xtwz, ll = _host(*softmax_stats(
                K, X, y, w, torch.as_tensor(beta, dtype=torch.float32,
                                            device=X.device), offset))
            delta = 0.0
            for k in range(K):
                bk = _solve_penalized(grams[k], xtwz[:, k], n, lam, p.alpha,
                                      beta[:, k], penalize)
                delta = max(delta, float(np.max(np.abs(bk - beta[:, k]))))
                beta[:, k] = bk
            ll = float(ll)
            hist.append({"lambda": lam, "iteration": it, "logloss": ll / n,
                         "delta": delta})
            job.update((it + 1) / p.max_iterations, f"iter={it} ll={ll:.4g}")
            if delta < p.beta_epsilon or abs(ll_prev - ll) < 1e-8 * n:
                break
            ll_prev = ll
        model = GLMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        self._finalize(model, di, beta, "multinomial", X, y, w, n, 2 * ll,
                       hist, lam, valid)
        return model

    # ------------------------------------------------------------ finalize
    def _finalize(self, model, di, beta_std, fam_name, X, y, w, n,
                  deviance, hist, lam, valid, gram_last=None):
        """The coefficients de-standardized to the data's scale, the
        deviances, p-values for an unpenalized single-class fit
        (``compute_p_values``: the inverse Gram, the family's dispersion,
        ``scipy.stats.norm``), and the training (and validation)
        metrics."""
        p: GLMParameters = self.params
        means = np.zeros(di.nfeatures)
        sigmas = np.ones(di.nfeatures)
        i = 0
        for s in di.specs:
            if s.type == "cat":
                i += s.width
            else:
                if di.standardize:
                    means[i], sigmas[i] = s.mean, s.sigma
                i += 1
        b = np.asarray(beta_std, np.float64)
        multi = b.ndim == 2
        bo = b / sigmas[:, None] if multi else b / sigmas
        if di.add_intercept:
            bo[-1] = b[-1] - (means[:-1] / sigmas[:-1]) @ b[:-1]
        model.output.update({
            "family": fam_name, "beta_std": np.asarray(beta_std, np.float32),
            "beta_std_flat": b.ravel().tolist(), "beta": bo,
            "coef_names": di.coef_names, "lambda": lam, "alpha": p.alpha,
            "iterations": len(hist), "residual_deviance": float(deviance),
            "rank": int(np.count_nonzero(np.atleast_2d(b))),
        })
        if fam_name != "multinomial":
            fam = _make_family(fam_name, p)
            mu0 = fam.linkinv(fam.init_eta(y, w))
            model.output["null_deviance"] = float(fam.deviance(y, mu0, w))
        model.scoring_history = hist
        if p.compute_p_values and lam == 0.0 and not multi \
                and gram_last is not None:
            try:
                inv = np.linalg.inv(gram_last)
            except np.linalg.LinAlgError:
                inv = None
            if inv is not None:
                from scipy.stats import norm
                disp = (deviance / max(n - len(b), 1.0)
                        if fam_name in ("gaussian", "gamma", "tweedie")
                        else 1.0)
                se = np.sqrt(np.maximum(np.diag(inv) * disp, 0.0))
                zval = np.where(se > 0, b / np.maximum(se, 1e-30), np.nan)
                model.output.update({
                    "std_errs": se, "z_values": zval,
                    "p_values": 2 * (1 - norm.cdf(np.abs(zval)))})
        model.training_metrics = make_metrics(di, model._predict_raw(X), y,
                                              w)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
