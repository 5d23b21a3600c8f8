"""ModelSelection: best-subset GLM search — the port of
``h2o3_tpu/models/modelselection.py`` (hex/modelselection).

Modes: ``maxr`` (sequential-replacement best subset), ``forward`` (the
greedy direction), ``backward`` (drop the smallest |standardized
coefficient|), each through the port's GLM fits on this fit's device,
and ``maxrsweep`` (ModelSelection.java:89: the same search scored by
sweeping the cross-product matrix, no GLM inside the search).  The
result reports the best predictor subset per size with its R^2
(gaussian) or AUC.

``maxrsweep``'s cross-product matrix [Z' W Z] of the design and the
response is one f32 product on the device summed over 1 GiB row blocks
(``datainfo.row_blocks``: a block of [X, y] is the only temporary, no
second [N, P] copy), in full f32 (TF32 off, as ``glm.weighted_gram``);
the sweeps and the sequential replacement run on the host in f64, the
JAX package's code as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.device import resolve_device
from ..runtime.job import Job
from . import datainfo as _di
from .base import Model, ModelBuilder, Parameters
from .glm import GLM


def cross_products(X: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """[Z' diag(w) Z] [P+1, P+1] in f32 for Z = [X, y], summed over the
    row blocks of Z (the JAX package's ``(Z * w).T @ Z``)."""
    N, P = X.shape
    C = torch.zeros((P + 1, P + 1), dtype=torch.float32, device=X.device)
    for r0, r1 in _di.row_blocks(N, P + 1):
        Zb = torch.cat([X[r0:r1], y[r0:r1, None]], dim=1)
        C.addmm_((Zb * w[r0:r1, None]).t(), Zb)
    return C


@dataclasses.dataclass
class ModelSelectionParameters(Parameters):
    mode: str = "maxr"                   # maxr | maxrsweep | forward | backward
    max_predictor_number: int = 0        # 0 = all
    min_predictor_number: int = 1
    family: str = "auto"
    alpha: float = 0.0
    lambda_: float = 0.0
    intercept: bool = True
    # maxrsweep only: also build a GLM per best subset (reference's
    # build_glm_model); off by default — the sweeps already yield the
    # coefficients
    build_glm_model: bool = False


class ModelSelectionModel(Model):
    algo = "modelselection"

    def result(self) -> Frame:
        """Per-size best subsets — the reference's result() frame."""
        rows = self.output["subsets"]
        return Frame.from_numpy({
            "model_size": np.asarray([r["size"] for r in rows], np.float64),
            "best_r2_value": np.asarray([r["metric"] for r in rows],
                                        np.float64),
            "predictor_names": np.asarray(
                [", ".join(r["predictors"]) for r in rows], dtype=object),
            "model_id": np.asarray([r["model_key"] for r in rows],
                                   dtype=object),
        }, device=resolve_device(self.params.device))

    def best_model(self, size: Optional[int] = None) -> Model:
        if self.output.get("mode") == "maxrsweep" and not getattr(
                self.params, "build_glm_model", False):
            raise ValueError(
                "maxrsweep ran without build_glm_model=True; read "
                "coefficients from result()/output['subsets'] instead")
        rows = self.output["subsets"]
        if size is None:
            row = max(rows, key=lambda r: r["metric"])
        else:
            row = next(r for r in rows if r["size"] == size)
        return dkv.get(row["model_key"])

    def coef(self, size: int) -> Dict[str, float]:
        return dict(self.best_model(size).coef)

    def _predict_raw(self, X):
        raise NotImplementedError("use best_model(size).predict(...)")


class ModelSelection(ModelBuilder):
    algo = "modelselection"
    model_class = ModelSelectionModel

    def __init__(self, params: Optional[ModelSelectionParameters] = None,
                 **kw):
        super().__init__(params or ModelSelectionParameters(**kw))

    def _fit(self, job: Job, frame: Frame, di, valid) -> ModelSelectionModel:
        p: ModelSelectionParameters = self.params
        predictors = [s.name for s in di.specs]
        maxp = p.max_predictor_number or len(predictors)
        maxp = min(maxp, len(predictors))

        def fit_subset(cols: Sequence[str]) -> Model:
            m = GLM(response_column=p.response_column,
                    weights_column=p.weights_column,
                    family=p.family, alpha=p.alpha,
                    lambda_=p.lambda_, seed=p.effective_seed(),
                    device=p.device) \
                .train(frame[list(cols) + [p.response_column]
                             + ([p.weights_column] if p.weights_column
                                else [])])
            return m

        def metric(m: Model) -> float:
            tm = m.training_metrics
            r2 = getattr(tm, "r2", float("nan"))
            if np.isfinite(r2):
                return float(r2)
            return float(getattr(tm, "auc", float("nan")))

        subsets: List[dict] = []
        if p.mode in ("maxr", "forward"):
            chosen: List[str] = []
            for size in range(1, maxp + 1):
                best = None
                for cand in predictors:
                    if cand in chosen:
                        continue
                    m = fit_subset(chosen + [cand])
                    v = metric(m)
                    if best is None or v > best[0]:
                        best = (v, cand, m)
                chosen.append(best[1])
                best_m, best_v = best[2], best[0]
                if p.mode == "maxr" and size >= 2:
                    # sequential replacement: try swapping each chosen
                    # predictor for each unchosen one (maxr refinement)
                    improved = True
                    while improved:
                        improved = False
                        for i, old in enumerate(list(chosen)):
                            for cand in predictors:
                                if cand in chosen:
                                    continue
                                trial = list(chosen)
                                trial[i] = cand
                                m2 = fit_subset(trial)
                                v2 = metric(m2)
                                if v2 > best_v + 1e-10:
                                    chosen = trial
                                    best_m, best_v = m2, v2
                                    improved = True
                subsets.append({"size": size, "predictors": list(chosen),
                                "metric": best_v,
                                "model_key": best_m.key})
                job.update(size / maxp, f"size {size}/{maxp}")
        elif p.mode == "backward":
            chosen = list(predictors)
            m = fit_subset(chosen)
            subsets.append({"size": len(chosen), "predictors": list(chosen),
                            "metric": metric(m), "model_key": m.key})
            while len(chosen) > max(p.min_predictor_number, 1):
                # drop the predictor with the smallest |standardized coef|
                coefs = dict(m.coef_norm)
                drop = None
                drop_mag = np.inf
                for name in chosen:
                    mags = [abs(v) for k, v in coefs.items()
                            if k == name or k.startswith(f"{name}.")]
                    mag = max(mags) if mags else 0.0
                    if mag < drop_mag:
                        drop_mag, drop = mag, name
                chosen.remove(drop)
                m = fit_subset(chosen)
                subsets.append({"size": len(chosen),
                                "predictors": list(chosen),
                                "metric": metric(m), "model_key": m.key})
                job.update(1 - len(chosen) / len(predictors),
                           f"size {len(chosen)}")
            subsets.reverse()
        elif p.mode == "maxrsweep":
            subsets = self._maxrsweep(job, frame, di, p, predictors, maxp,
                                      fit_subset)
        else:
            raise ValueError(f"unknown mode {p.mode!r}")

        model = ModelSelectionModel(
            job.dest_key or dkv.make_key(self.algo), p, di)
        model.output["subsets"] = subsets
        model.output["mode"] = p.mode
        best = max(subsets, key=lambda r: r["metric"])
        if best.get("model_key"):
            model.training_metrics = dkv.get(
                best["model_key"]).training_metrics
        return model

    # -- maxrsweep: sweep-operator subset search (ModelSelection.java:89) --
    @staticmethod
    def _sweep(M: np.ndarray, idx: Sequence[int]) -> Optional[np.ndarray]:
        """Symmetric sweep of M on the given pivots; None if singular."""
        M = M.copy()
        for k in idx:
            d = M[k, k]
            if abs(d) < 1e-10:
                return None
            col = M[:, k].copy()
            rowk = M[k, :].copy()
            M -= np.outer(col, rowk) / d
            M[:, k] = col / d
            M[k, :] = rowk / d
            M[k, k] = -1.0 / d
        return M

    def _maxrsweep(self, job: Job, frame: Frame, di, p, predictors, maxp,
                   fit_subset) -> List[dict]:
        """maxr's sequential-replacement search, but each candidate subset
        is scored by sweeping the cross-product matrix instead of fitting
        a GLM: err(S) = CPM swept on S's design columns (+ intercept),
        read at the [y, y] cell; coefficients fall out at [cols, y]."""
        if di.is_classifier:
            raise ValueError("maxrsweep supports regression only "
                             "(ModelSelection.java:134)")
        X = di.make_matrix(frame)                  # [padded, cols+icpt]
        y = di.response(frame)
        w = di.weights(frame)
        y = torch.where(w > 0, torch.nan_to_num(y), 0.0)
        CPM = cross_products(X, y, w).cpu().numpy().astype(np.float64)
        names = di.coef_names                      # expanded design names
        yi = CPM.shape[0] - 1                      # y cell index
        icpt = [names.index("Intercept")] if "Intercept" in names else []
        groups: Dict[str, List[int]] = {}
        for pred in predictors:
            groups[pred] = [j for j, nm in enumerate(names)
                            if nm == pred or nm.startswith(pred + ".")]

        def sweep_cols(M: np.ndarray, cols: Sequence[int]) -> np.ndarray:
            """Sweep pivots in order, skipping singular ones (empty
            one-hot levels)."""
            for k in cols:
                nxt = self._sweep(M, [k])
                if nxt is not None:
                    M = nxt
            return M

        # incremental search: the classical sweep trick — keep the matrix
        # swept on the chosen set; evaluating a candidate sweeps ONLY its
        # own columns (O(g*p^2)), never the whole subset again
        base = sweep_cols(CPM, icpt)
        sst = float(base[yi, yi])
        sse_none = sst if sst > 0 else 1.0

        def r2(sse: float) -> float:
            return 1.0 - sse / sse_none

        subsets: List[dict] = []
        chosen: List[str] = []
        M_chosen = base
        best_sse = sse_none
        for size in range(1, maxp + 1):
            best = None
            for cand in predictors:
                if cand in chosen:
                    continue
                v = float(sweep_cols(M_chosen, groups[cand])[yi, yi])
                if best is None or v < best[0]:
                    best = (v, cand)
            chosen.append(best[1])
            best_sse = best[0]
            M_chosen = sweep_cols(M_chosen, groups[best[1]])
            if size >= 2:                          # sequential replacement
                improved = True
                while improved:
                    improved = False
                    for i in range(len(chosen)):
                        # un-swept base + everything but position i, ONCE;
                        # each candidate then adds only its own columns
                        keep = [j for c in chosen if c != chosen[i]
                                for j in groups[c]]
                        M_minus = sweep_cols(base, keep)
                        for cand in predictors:
                            if cand in chosen:
                                continue
                            v = float(sweep_cols(
                                M_minus, groups[cand])[yi, yi])
                            if v < best_sse - 1e-10:
                                chosen[i] = cand
                                best_sse = v
                                M_chosen = sweep_cols(M_minus,
                                                      groups[cand])
                                improved = True
                                break
                        if improved:
                            break
            row = {"size": size, "predictors": list(chosen),
                   "metric": r2(best_sse), "model_key": None}
            if p.build_glm_model:
                m = fit_subset(chosen)
                row["model_key"] = m.key
            else:
                cols = icpt + [j for c in chosen for j in groups[c]]
                M = M_chosen
                # de-standardize: x_std=(x-m)/s => b_raw=b_std/s and the
                # intercept absorbs -sum(b_std*m/s) (GLM's reporting units)
                mean_s = {}
                for s in di.specs:
                    if s.type != "cat":
                        mean_s[s.name] = (s.mean, s.sigma)
                coefs = {}
                icpt_adj = 0.0
                for j in cols:
                    nm = names[j]
                    if nm == "Intercept":
                        continue
                    b = float(M[j, yi])
                    if nm in mean_s:
                        m_, s_ = mean_s[nm]
                        coefs[nm] = b / s_
                        icpt_adj += b * m_ / s_
                    else:
                        coefs[nm] = b
                if icpt:
                    coefs["Intercept"] = float(M[icpt[0], yi]) - icpt_adj
                row["coefficients"] = coefs
            subsets.append(row)
            job.update(size / maxp, f"maxrsweep size {size}/{maxp}")
        return subsets
