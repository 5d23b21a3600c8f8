"""KMeans — the port of ``h2o3_tpu/models/kmeans.py``
(hex/kmeans/KMeans.java:26).

Lloyd iterations on the standardized one-hot design (all factor levels,
no intercept): the [rows, k] distances ``|x|^2 - 2 X C^T + |c|^2`` are
a cuBLAS f32 product, the assignment an argmin, the new centre sums the
product ``A^T X`` of the weighted one-hot assignment; each is reduced
over row blocks (``datainfo.row_blocks``), so no [N, P] temporary
exists beside the design.  The inits (``random``, ``plus_plus``,
``furthest``, ``user``) make the JAX package's numpy draws in its
order; ``plus_plus`` and ``furthest`` read the [N] distances back to the
host once a centre, as the reference does (``output["init_read_s"]``
holds their seconds).  ``estimate_k`` grows k while the within-SS drops
below 0.8 of the last.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT, Vec
from ..runtime import dkv
from ..runtime.job import Job
from . import datainfo as _di
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class KMeansParameters(Parameters):
    k: int = 1
    estimate_k: bool = False
    init: str = "furthest"            # random | plus_plus | furthest | user
    user_points: Optional[np.ndarray] = None
    max_iterations: int = 10
    standardize: bool = True


class ModelMetricsClustering:
    """totss / tot_withinss / betweenss + per-cluster breakdown.

    Analog of ``hex/ModelMetricsClustering.java``.
    """

    def __init__(self, totss, tot_withinss, withinss, sizes):
        self.totss = float(totss)
        self.tot_withinss = float(tot_withinss)
        self.betweenss = self.totss - self.tot_withinss
        self.withinss = [float(v) for v in withinss]
        self.size = [int(v) for v in sizes]

    def describe(self) -> dict:
        return {"totss": self.totss, "tot_withinss": self.tot_withinss,
                "betweenss": self.betweenss, "withinss": self.withinss,
                "size": self.size}

    def __repr__(self):
        return (f"ModelMetricsClustering(totss={self.totss:.4g}, "
                f"tot_withinss={self.tot_withinss:.4g}, "
                f"betweenss={self.betweenss:.4g}, k={len(self.size)})")


def _d2(Xb: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[rows, k] squared distances of a row block to the centres."""
    d2 = ((Xb * Xb).sum(dim=1, keepdim=True) - 2.0 * Xb @ centers.t()
          + (centers * centers).sum(dim=1)[None, :])
    return d2.clamp_min(0.0)


def _lloyd_step(X, w, centers):
    """One Lloyd iteration: (assignment [N], centre sums [k, P], weights
    [k], within-SS [k]), reduced over row blocks."""
    N, P = X.shape
    k = centers.shape[0]
    sums = torch.zeros((k, P), dtype=X.dtype, device=X.device)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device)
    withinss = torch.zeros(k, dtype=X.dtype, device=X.device)
    assign = torch.empty(N, dtype=torch.int64, device=X.device)
    ks = torch.arange(k, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        Xb = X[r0:r1]
        mind2, a = _d2(Xb, centers).min(dim=1)
        assign[r0:r1] = a
        A = (a[:, None] == ks[None, :]).to(X.dtype) * w[r0:r1, None]
        sums += A.t() @ Xb
        counts += A.sum(dim=0)
        withinss += (A * mind2[:, None]).sum(dim=0)
    return assign, sums, counts, withinss


def _min_d2(X, w, centers):
    """[N] weighted squared distance of each row to its nearest centre."""
    N, P = X.shape
    out = torch.empty(N, dtype=X.dtype, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        out[r0:r1] = _d2(X[r0:r1], centers).min(dim=1).values * w[r0:r1]
    return out


def _weighted_mean(X, w):
    """[P] weighted column means, reduced over row blocks."""
    N, P = X.shape
    s = torch.zeros(P, dtype=X.dtype, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        s += (X[r0:r1] * w[r0:r1, None]).sum(dim=0)
    return s / w.sum().clamp_min(1.0)


def _as_centers(c, X: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(c, np.float32), device=X.device)


class KMeansModel(Model):
    algo = "kmeans"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        centers = _as_centers(self.output["centers_std"], X)
        out = torch.empty(X.shape[0], dtype=torch.float32, device=X.device)
        for r0, r1 in _di.row_blocks(*X.shape):
            out[r0:r1] = _d2(X[r0:r1], centers).argmin(dim=1).float()
        return out

    def predict(self, frame: Frame) -> Frame:
        X = self.datainfo.make_matrix(frame)
        labels = self._predict_raw(X)[: frame.nrows].cpu().numpy() \
            .astype(np.int32)
        k = len(self.output["centers"])
        return Frame(["predict"], [Vec.from_numpy(
            labels, T_CAT, domain=[str(i) for i in range(k)],
            device=frame.device)])

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        di = self.datainfo
        X = di.make_matrix(frame)
        w = di.weights(frame)
        _, _, counts, withinss = _lloyd_step(
            X, w, _as_centers(self.output["centers_std"], X))
        gmean = _weighted_mean(X, w)
        totss = float(_min_d2(X, w, gmean[None, :]).sum())
        return ModelMetricsClustering(totss, float(withinss.sum()),
                                      withinss.cpu().numpy(),
                                      counts.cpu().numpy())

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout (the JAX
        package's ``export/mojo.py::_extract`` for KMeans): the
        standardized centres, scored by ``ScoringModel._score_kmeans``."""
        from ..export.mojo import archive_meta
        return archive_meta(self, "kmeans"), {
            "centers_std": np.asarray(self.output["centers_std"],
                                      np.float64)}


class KMeans(ModelBuilder):
    """KMeans builder — h2o.kmeans / H2OKMeansEstimator analog."""

    algo = "kmeans"
    model_class = KMeansModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[KMeansParameters] = None, **kw):
        super().__init__(params or KMeansParameters(**kw))
        self.init_rows: list = []
        self.init_read_s = 0.0          # the host reads of the distances

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            weights_column=p.weights_column, standardize=p.standardize,
            use_all_factor_levels=True, add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    # ------------------------------------------------------------------ init
    def _init_centers(self, X, w, k: int, rng: np.random.Generator,
                      di: DataInfo) -> np.ndarray:
        """[k, P] f32 initial centres, drawn as the JAX package draws
        them; the rows chosen are kept in ``self.init_rows``."""
        p: KMeansParameters = self.params
        wh = w.cpu().numpy()
        valid_idx = np.flatnonzero(wh > 0)
        self.init_rows = []
        if p.init == "user":
            if p.user_points is None:
                raise ValueError("init='user' requires user_points")
            pts = np.asarray(p.user_points, np.float64)
            if pts.shape[1] != X.shape[1]:
                if any(s.width > 1 for s in di.specs):
                    raise ValueError(
                        "init='user' with categorical features requires "
                        f"points in the one-hot-expanded space "
                        f"([k, {X.shape[1]}]), got {pts.shape}")
                raise ValueError(
                    f"user_points must be [k, {X.shape[1]}], got {pts.shape}")
            if p.standardize:
                means = np.array([s.mean for s in di.specs for _ in
                                  range(s.width)])
                sigmas = np.array([s.sigma for s in di.specs for _ in
                                   range(s.width)])
                pts = (pts - means) / sigmas
            return pts.astype(np.float32)
        if p.init not in ("random", "plus_plus", "furthest"):
            raise ValueError(f"init={p.init!r}: random|plus_plus|furthest|"
                             "user")
        if p.init == "random":
            idx = rng.choice(valid_idx, size=k, replace=False)
            self.init_rows = [int(i) for i in idx]
            return X[torch.as_tensor(idx, device=X.device)].cpu().numpy()
        # plus_plus / furthest: sequential greedy seeding by distance, the
        # [N] distances read back to the host once a centre
        first = int(rng.choice(valid_idx))
        self.init_rows = [first]
        centers = [X[first].cpu().numpy()]
        t_read = 0.0
        for _ in range(1, k):
            t0 = time.perf_counter()
            d2 = _min_d2(X, w, _as_centers(np.stack(centers), X)) \
                .cpu().numpy()
            t_read += time.perf_counter() - t0
            if p.init == "furthest":
                nxt = int(np.argmax(d2))
            else:                                  # plus_plus: D^2 sampling
                s = d2.sum()
                probs = d2 / s if s > 0 else wh / wh.sum()
                nxt = int(rng.choice(len(d2), p=probs))
            self.init_rows.append(nxt)
            centers.append(X[nxt].cpu().numpy())
        self.init_read_s += t_read
        return np.stack(centers)

    # ------------------------------------------------------------------- fit
    def _run_lloyd(self, job, X, w, centers0: np.ndarray, tag: str):
        p: KMeansParameters = self.params
        centers = _as_centers(centers0, X)
        prev_tot = np.inf
        iters = 0
        for it in range(max(p.max_iterations, 1)):
            _, sums, counts, withinss = _lloyd_step(X, w, centers)
            counts_h = counts.cpu().numpy().astype(np.float64)
            sums_h = sums.cpu().numpy().astype(np.float64)
            old = centers.cpu().numpy().astype(np.float64)
            new = np.where(counts_h[:, None] > 0,
                           sums_h / np.maximum(counts_h[:, None], 1e-12),
                           old)
            tot = float(withinss.sum())
            job.update(it / max(p.max_iterations, 1),
                       f"{tag} iter={it} tot_withinss={tot:.5g}")
            shift = float(np.max(np.abs(new - old)))
            centers = _as_centers(new, X)
            iters = it + 1
            if tot >= prev_tot * (1 - 1e-6) and shift < 1e-7:
                break
            prev_tot = tot
        _, _, counts, withinss = _lloyd_step(X, w, centers)
        return (centers.cpu().numpy().astype(np.float64),
                withinss.cpu().numpy(), counts.cpu().numpy(),
                float(withinss.sum()), iters)

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> KMeansModel:
        p: KMeansParameters = self.params
        rng = np.random.default_rng(p.effective_seed())
        X = di.make_matrix(frame)
        w = di.weights(frame)
        self.init_read_s = 0.0
        totss = float(_min_d2(X, w, _weighted_mean(X, w)[None, :]).sum())

        if p.estimate_k:
            # grow k while tot_withinss improves enough (KMeans.java
            # estimate_k): accept k+1 only on a drop below 0.8 of the last
            best = None
            prev = totss
            for k in range(1, max(p.k, 2) + 1):
                c0 = self._init_centers(X, w, k, rng, di)
                res = self._run_lloyd(job, X, w, c0, f"k={k}")
                if best is None or res[3] < prev * 0.8:
                    best, prev, best_k = res, res[3], k
                else:
                    break
            centers, withinss, counts, tot, iters = best
            k = best_k
        else:
            k = p.k
            c0 = self._init_centers(X, w, k, rng, di)
            centers, withinss, counts, tot, iters = self._run_lloyd(
                job, X, w, c0, f"k={k}")

        model = KMeansModel(job.dest_key or dkv.make_key(self.algo), p, di)
        # de-standardized centers for reporting (KMeansModel.Output._centers)
        destd = centers.copy()
        if p.standardize:
            col = 0
            for s in di.specs:
                if s.width == 1:
                    destd[:, col] = centers[:, col] * s.sigma + s.mean
                col += s.width
        model.output.update({
            "centers": destd, "centers_std": centers, "k": int(k),
            "iterations": iters, "coef_names": di.coef_names,
            "init_rows": list(self.init_rows),
            "init_read_s": self.init_read_s,
        })
        model.training_metrics = ModelMetricsClustering(
            totss, tot, withinss, counts)
        if valid is not None:
            model.validation_metrics = model.model_performance(valid)
        return model
