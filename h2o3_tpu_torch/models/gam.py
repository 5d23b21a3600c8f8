"""GAM: spline smooths with curvature penalties over the GLM — the port
of ``h2o3_tpu/models/gam.py`` (hex/gam/GAM.java:53).

Each ``gam_column`` expands into a spline basis with a penalty matrix,
identifiability-centered, and the penalized GLM runs over [basis, other
features].  Basis families: ``bs="cr"`` (cubic regression splines at
quantile knots, the integrated squared second derivative penalty),
``bs="tp"`` (thin-plate regression splines over one to three columns:
radial basis at data knots, the polynomial null space projected out, the
bending-energy penalty) and ``bs="is"`` (monotone I-splines whose
coefficients the GLM's ``non_negative`` keeps >= 0).

The bases are the JAX package's numpy and scipy code, copied as it is
(``_crs_construct`` through ``_center_and_diagonalize``) and run on the
host; each penalty is diagonalized once per smooth (Demmler-Reinsch), so
it becomes per-column ridge factors (``penalty_factors``) on the port's
GLM, and each null space stays unpenalized.  The expanded frame's columns
go to the fit's device, where the GLM builds its design and Gram.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder
from .datainfo import DataInfo
from .glm import GLM, GLMParameters


@dataclasses.dataclass
class GAMParameters(GLMParameters):
    # entries are column names, or LISTS of names for multi-predictor
    # thin-plate smooths (the reference's nested gam_columns)
    gam_columns: Sequence = ()
    num_knots: int = 8
    scale: float = 1.0                  # smoothing strength per gam column
    # basis per smooth: "cr" | "tp" | "is" — a single string applies to
    # every smooth (the reference's bs array of 0=cr/1=tp/2=is codes)
    bs: object = "cr"
    # monotone (I-spline) smooths: constrain coefficients >= 0
    splines_non_negative: bool = True


def _crs_construct(knots: np.ndarray):
    """CRS machinery for one knot vector: returns (F_full, S).

    ``F_full`` [K, K] maps knot values -> second derivatives at the knots
    (natural boundary: zero curvature at the ends); ``S`` [K, K] is the
    integrated squared second derivative penalty  D' B^{-1} D  (the exact
    curvature penalty the reference's penalty_matrix encodes).
    """
    K = len(knots)
    h = np.diff(knots).astype(np.float64)
    D = np.zeros((K - 2, K))
    B = np.zeros((K - 2, K - 2))
    for i in range(K - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        B[i, i] = (h[i] + h[i + 1]) / 3.0
        if i < K - 3:
            B[i, i + 1] = h[i + 1] / 6.0
            B[i + 1, i] = h[i + 1] / 6.0
    F = np.linalg.solve(B, D)                      # [K-2, K]
    F_full = np.vstack([np.zeros(K), F, np.zeros(K)])
    S = D.T @ F                                    # [K, K], PSD
    return F_full, S


def _crs_eval(x: np.ndarray, knots: np.ndarray,
              F_full: np.ndarray) -> np.ndarray:
    """Cardinal CRS basis values [n, K]: row r gives the weights such that
    f(x_r) = weights . f(knots) for the natural interpolating spline."""
    K = len(knots)
    h = np.diff(knots)
    xc = np.clip(x, knots[0], knots[-1])
    j = np.clip(np.searchsorted(knots, xc, side="right") - 1, 0, K - 2)
    kj, kj1 = knots[j], knots[j + 1]
    hj = h[j]
    am = (kj1 - xc) / hj
    ap = (xc - kj) / hj
    cm = ((kj1 - xc) ** 3 / hj - hj * (kj1 - xc)) / 6.0
    cp = ((xc - kj) ** 3 / hj - hj * (xc - kj)) / 6.0
    n = len(x)
    X = np.zeros((n, K))
    rows = np.arange(n)
    np.add.at(X, (rows, j), am)
    np.add.at(X, (rows, j + 1), ap)
    X += cm[:, None] * F_full[j] + cp[:, None] * F_full[j + 1]
    return X


def _tp_eta(r: np.ndarray, d: int) -> np.ndarray:
    """Thin-plate radial basis function for d input dimensions (m=2)."""
    if d == 1:
        return r ** 3 / 12.0
    if d == 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (r * r) * np.log(np.maximum(r, 1e-300)) / (8 * np.pi)
        return np.where(r > 0, out, 0.0)
    return -r / 8.0                         # d == 3 (odd-d general form)


def _tp_construct(Xk: np.ndarray):
    """Thin-plate machinery for one knot matrix [k, d]: returns (Z, S).

    ``Z`` [k, k-d-1] projects radial coefficients onto the null space of
    the polynomial constraint T'delta = 0 (T = [1, x1..xd] at the knots);
    ``S = Z' E Z`` is the bending-energy penalty with E the knot-knot
    radial matrix — the standard TPRS construction
    (ThinPlateRegressionUtils.java computes the same pieces distributedly).
    """
    k, d = Xk.shape
    r = np.linalg.norm(Xk[:, None, :] - Xk[None, :, :], axis=2)
    E = _tp_eta(r, d)
    T = np.concatenate([np.ones((k, 1)), Xk], axis=1)        # [k, d+1]
    q, _ = np.linalg.qr(T, mode="complete")
    Z = q[:, d + 1:]                                         # [k, k-d-1]
    S = Z.T @ E @ Z
    return Z, (S + S.T) / 2


def _tp_eval(X: np.ndarray, Xk: np.ndarray, Z: np.ndarray) -> np.ndarray:
    """Projected radial design block [n, k-d-1] for rows X [n, d]."""
    d = Xk.shape[1]
    r = np.linalg.norm(X[:, None, :] - Xk[None, :, :], axis=2)
    return _tp_eta(r, d) @ Z


def _is_basis(x: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """I-spline (monotone) basis [n, K]: cumulative integrals of cubic
    M-splines — each column rises 0 -> 1, so non-negative coefficients
    give a monotone-increasing smooth (GamSplines/ISplines analog)."""
    from scipy.interpolate import BSpline
    order = 4                                # cubic
    t = np.concatenate([[knots[0]] * order, knots[1:-1],
                        [knots[-1]] * order])
    nb = len(t) - order
    xc = np.clip(x, knots[0], knots[-1])
    B = np.empty((len(x), nb))
    for j in range(nb):
        coef = np.zeros(nb)
        coef[j] = 1.0
        B[:, j] = BSpline(t, coef, order - 1)(xc)
    # I_j(x) = sum of B-spline columns m >= j+1 (integrated M-splines);
    # drop the first cumulative column (constant 1 = intercept clash)
    I = np.cumsum(B[:, ::-1], axis=1)[:, ::-1]
    return I[:, 1:]


def _center_and_diagonalize(Xb: np.ndarray, S: np.ndarray):
    """Sum-to-zero centering + Demmler-Reinsch diagonalization.

    Returns (T, factors): the [K, K-1] transform applied to the basis and
    the per-output-column penalty factors (eigenvalues of the centered
    penalty; ~0 = unpenalized null space — the linear trend).
    """
    K = Xb.shape[1]
    # Z: orthogonal complement of the column-mean constraint (mgcv's
    # sum-to-zero identifiability absorbing the intercept)
    c = Xb.mean(axis=0)
    q, _ = np.linalg.qr(np.concatenate([c[:, None],
                                        np.eye(K)[:, : K - 1]], axis=1))
    Z = q[:, 1:K]                                   # [K, K-1]
    Sc = Z.T @ S @ Z
    d, U = np.linalg.eigh((Sc + Sc.T) / 2)
    d = np.maximum(d, 0.0)
    T = Z @ U                                       # [K, K-1]
    return T, d


class GAMModel(Model):
    algo = "gam"

    def _block(self, m: dict, frame: Frame) -> np.ndarray:
        """Design block [n, width] for one smooth on any frame."""
        if m["kind"] == "cr":
            x = np.nan_to_num(frame.vec(m["cols"][0]).to_numpy(),
                              nan=m["mean"])
            B = _crs_eval(x, m["knots"], m["F_full"]) @ m["T"]
            return B / m["col_scale"][None, :]
        if m["kind"] == "tp":
            X = np.stack([np.nan_to_num(frame.vec(c).to_numpy(), nan=mu)
                          for c, mu in zip(m["cols"], m["means"])], axis=1)
            Xs = (X - np.asarray(m["means"])) / np.asarray(m["sigmas"])
            B = _tp_eval(Xs, m["knots"], m["Z"]) @ m["T"]
            B = B / m["col_scale"][None, :]
            return np.concatenate([B, Xs], axis=1)   # + linear null space
        x = np.nan_to_num(frame.vec(m["cols"][0]).to_numpy(),
                          nan=m["mean"])              # "is"
        return _is_basis(x, m["knots"])

    def _expand(self, frame: Frame) -> Frame:
        meta = self.output["gam_meta"]
        smooth_cols = {c for m in meta for c in m["cols"]}
        names, vecs = [], []
        for n, v in zip(frame.names, frame.vecs):
            if n not in smooth_cols:
                names.append(n)
                vecs.append(v)
        for m in meta:
            B = self._block(m, frame)
            for j in range(B.shape[1]):
                names.append(f"{m['name']}_gam{j}")
                vecs.append(Vec.from_numpy(B[:, j], T_NUM,
                                            device=frame.device))
        return Frame(names, vecs)

    def _predict_raw(self, X):
        raise NotImplementedError("gam scores via its GLM")

    def predict(self, frame: Frame) -> Frame:
        glm = dkv.get(self.output["glm_key"])
        return glm.predict(self._expand(frame))

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        glm = dkv.get(self.output["glm_key"])
        return glm.model_performance(self._expand(frame))

    @property
    def coef(self) -> dict:
        return dkv.get(self.output["glm_key"]).coef


class GAM(ModelBuilder):
    """GAM builder — H2OGeneralizedAdditiveEstimator analog."""

    algo = "gam"
    model_class = GAMModel

    def __init__(self, params: Optional[GAMParameters] = None, **kw):
        super().__init__(params or GAMParameters(**kw))

    def _smooth_specs(self) -> List[dict]:
        """Normalize gam_columns/bs into per-smooth descriptors."""
        p: GAMParameters = self.params
        entries = [e if isinstance(e, (list, tuple)) else [e]
                   for e in p.gam_columns]
        bs = p.bs
        kinds = list(bs) if isinstance(bs, (list, tuple)) \
            else [bs] * len(entries)
        if len(kinds) != len(entries):
            raise ValueError("bs must be one kind or one per gam_columns "
                             "entry")
        code = {0: "cr", 1: "tp", 2: "is", "cr": "cr", "tp": "tp",
                "is": "is", "ms": "is"}
        out = []
        for cols, k in zip(entries, kinds):
            kind = code.get(k)
            if kind is None:
                raise ValueError(f"unknown basis {k!r} (cr | tp | is)")
            if kind != "tp" and len(cols) > 1:
                raise ValueError("multi-column smooths need bs='tp'")
            if kind == "tp" and len(cols) > 3:
                raise ValueError(
                    "thin-plate smooths support up to 3 columns (the m=2 "
                    "radial basis needs 2m > d)")
            out.append({"cols": list(cols), "kind": kind,
                        "name": "_".join(cols)})
        return out

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        p: GAMParameters = self.params
        if not p.gam_columns:
            raise ValueError("gam requires gam_columns")
        for s in self._smooth_specs():
            for c in s["cols"]:
                if c not in frame.names:
                    raise ValueError(f"gam column {c!r} not in frame")

    @staticmethod
    def _quantile_knots(x: np.ndarray, k: int, col: str) -> np.ndarray:
        knots = np.unique(np.quantile(x, np.linspace(0, 1, max(k, 4))))
        if len(knots) < 4:
            raise ValueError(
                f"gam column {col!r} has too few distinct values "
                f"({len(knots)}) for a spline")
        return knots

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> GAMModel:
        p: GAMParameters = self.params
        meta: List[dict] = []
        factors: Dict[str, float] = {}
        nonneg: List[str] = []
        model = GAMModel(job.dest_key or dkv.make_key(self.algo), p, di)
        for s in self._smooth_specs():
            name, cols = s["name"], s["cols"]
            if s["kind"] == "cr":
                x = frame.vec(cols[0]).to_numpy()
                x = x[~np.isnan(x)]
                knots = self._quantile_knots(x, p.num_knots, cols[0])
                F_full, S = _crs_construct(knots)
                Xb = _crs_eval(np.nan_to_num(frame.vec(cols[0]).to_numpy(),
                                             nan=float(x.mean())),
                               knots, F_full)
                T, d = _center_and_diagonalize(Xb, S)
                col_scale = np.maximum((Xb @ T).std(axis=0), 1e-12)
                meta.append({**s, "knots": knots, "F_full": F_full, "T": T,
                             "mean": float(x.mean()),
                             "col_scale": col_scale})
                # penalty factor for the scaled column: the design column
                # is Bt/s, so its coefficient is s*beta and a factor f
                # penalizes f*s^2*beta^2 — realizing scale*d_j*beta^2
                # needs f = scale*d/s^2.  d is normalized by its largest
                # eigenvalue (the reference scales penalty matrices
                # likewise) so scale=1 smooths mildly regardless of knot
                # spacing / data units.
                d_max = max(float(d.max()), 1e-30)
                for j, dj in enumerate(d):
                    factors[f"{name}_gam{j}"] = float(
                        p.scale * (dj / d_max)
                        / max(col_scale[j] ** 2, 1e-30))
            elif s["kind"] == "tp":
                Xcols, means, sigmas = [], [], []
                for c in cols:
                    xc = frame.vec(c).to_numpy()
                    mu = float(np.nanmean(xc))
                    sd = float(np.nanstd(xc)) or 1.0
                    Xcols.append(np.nan_to_num(xc, nan=mu))
                    means.append(mu)
                    sigmas.append(sd)
                X = (np.stack(Xcols, axis=1) - np.asarray(means)) \
                    / np.asarray(sigmas)
                dcols = X.shape[1]
                k = max(p.num_knots, dcols + 3)
                # deterministic space-filling knots: evenly strided rows
                # of the lexicographic sort (kmeans-free knot placement)
                order = np.lexsort(X.T[::-1])
                idx = order[np.linspace(0, len(order) - 1, k).astype(int)]
                knots = np.unique(X[idx], axis=0)
                Z, S = _tp_construct(knots)
                B = _tp_eval(X, knots, Z)
                T, d = _center_and_diagonalize(B, S)
                col_scale = np.maximum((B @ T).std(axis=0), 1e-12)
                meta.append({**s, "knots": knots, "Z": Z, "T": T,
                             "means": means, "sigmas": sigmas,
                             "col_scale": col_scale})
                # TP factors are normalized on the SCALED columns (the
                # radial basis has tiny raw magnitudes, so the CRS-style
                # d/col_scale^2 blows up): f_raw = d_j/col_scale_j^2,
                # rescaled so the stiffest direction gets exactly
                # ``scale`` — scale=1 then smooths mildly, matching the
                # CRS knob's feel.
                f_raw = np.maximum(np.asarray(d, float), 0.0) \
                    / np.maximum(col_scale ** 2, 1e-30)
                f_max = max(float(f_raw.max()), 1e-30)
                nrad = len(col_scale)
                for j in range(nrad):
                    factors[f"{name}_gam{j}"] = float(
                        p.scale * f_raw[j] / f_max)
                for j in range(dcols):            # linear null space
                    factors[f"{name}_gam{nrad + j}"] = 0.0
            else:                                 # "is" — monotone
                x = frame.vec(cols[0]).to_numpy()
                x = x[~np.isnan(x)]
                knots = self._quantile_knots(x, p.num_knots, cols[0])
                meta.append({**s, "knots": knots, "mean": float(x.mean())})
                width = _is_basis(np.asarray([knots[0]]), knots).shape[1]
                for j in range(width):
                    cname = f"{name}_gam{j}"
                    factors[cname] = float(p.scale)
                    if p.splines_non_negative:
                        nonneg.append(cname)
        model.output["gam_meta"] = meta

        # non-gam predictors keep the user's lambda as their factor
        base_lam = 0.0 if p.lambda_ is None else float(np.max(p.lambda_))
        expanded = model._expand(frame)
        for n in expanded.names:
            if n not in factors and n != p.response_column:
                factors[n] = base_lam
        job.update(0.3, "fitting penalized GLM over the spline bases")
        glm = GLM(response_column=p.response_column, family=p.family,
                  alpha=0.0, lambda_=1.0, penalty_factors=factors,
                  weights_column=p.weights_column,
                  non_negative=nonneg or False,
                  seed=p.effective_seed(),
                  max_iterations=p.max_iterations,
                  device=p.device).train(
            expanded, model._expand(valid) if valid is not None else None)
        model.output["glm_key"] = glm.key
        model.output["family"] = glm.output.get("family")
        model.training_metrics = glm.training_metrics
        model.validation_metrics = glm.validation_metrics
        return model
