"""Naive Bayes — the port of ``h2o3_tpu/models/naivebayes.py``
(hex/naivebayes/NaiveBayes.java).

The per-class sufficient statistics are two cuBLAS f32 products over
row blocks of the one-hot design (``_class_moments``: ``Y_w' X`` and
``Y_w' X^2``, categorical level counts and numeric moments from the same
products); the Laplace-smoothed level tables, the Gaussian numerics with
the ``min_sdev``/``eps_sdev`` and ``min_prob``/``eps_prob`` floors and
the priors are formed on the host in f64.  Scoring is one product with
the log-probability table plus the per-class Gaussian terms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_CAT
from ..runtime import dkv
from ..runtime.job import Job
from . import datainfo as _di
from .base import Model, ModelBuilder, Parameters
from .datainfo import DataInfo


@dataclasses.dataclass
class NaiveBayesParameters(Parameters):
    laplace: float = 0.0
    min_sdev: float = 1e-3
    eps_sdev: float = 0.0
    min_prob: float = 1e-3
    eps_prob: float = 0.0
    standardize: bool = False
    compute_metrics: bool = True


def _class_moments(X, Y, w):
    """([K, P] weighted per-class sums of X and X^2, [K] class weights),
    summed over row blocks."""
    N, P = X.shape
    K = Y.shape[1]
    M1 = torch.zeros((K, P), dtype=X.dtype, device=X.device)
    M2 = torch.zeros((K, P), dtype=X.dtype, device=X.device)
    nk = torch.zeros(K, dtype=X.dtype, device=X.device)
    for r0, r1 in _di.row_blocks(N, P):
        Xb = X[r0:r1]
        Yw = Y[r0:r1] * w[r0:r1, None]
        M1 += Yw.t() @ Xb
        M2 += Yw.t() @ (Xb * Xb)
        nk += Yw.sum(dim=0)
    return M1, M2, nk


class NaiveBayesModel(Model):
    algo = "naivebayes"

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        out = self.output

        def dev(name, dtype=torch.float32):
            return torch.as_tensor(np.asarray(out[name]), dtype=dtype,
                                   device=X.device)
        log_cat = dev("_log_cat_table")                              # [P, K]
        mu = dev("_num_mu")                                          # [K, Pn]
        inv2v = dev("_num_inv2var")
        logsd = dev("_num_logsd")
        num_idx = dev("_num_idx", torch.int64)
        logprior = dev("_log_prior")                                 # [K]

        ll = X @ log_cat + logprior[None, :]
        if num_idx.shape[0]:
            Xn = X[:, num_idx]                                       # [N, Pn]
            diff = Xn[:, None, :] - mu[None, :, :]          # [N, K, Pn]
            ll = ll - torch.sum(diff * diff * inv2v[None] + logsd[None],
                                dim=2)
        ll = ll - ll.max(dim=1, keepdim=True).values
        probs = torch.exp(ll)
        return probs / probs.sum(dim=1, keepdim=True)

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive layout (the JAX
        package's ``export/mojo.py::_extract`` for NaiveBayes), scored by
        ``ScoringModel._score_naivebayes``."""
        from ..export.mojo import archive_meta
        o = self.output
        return archive_meta(self, "naivebayes"), {
            "log_cat_table": np.asarray(o["_log_cat_table"]),
            "log_prior": np.asarray(o["_log_prior"]),
            "num_idx": np.asarray(o["_num_idx"]),
            "num_mu": np.asarray(o["_num_mu"]),
            "num_inv2var": np.asarray(o["_num_inv2var"]),
            "num_logsd": np.asarray(o["_num_logsd"])}


class NaiveBayes(ModelBuilder):
    """NaiveBayes builder — h2o.naiveBayes / H2ONaiveBayesEstimator
    analog."""

    algo = "naivebayes"
    model_class = NaiveBayesModel

    def __init__(self, params: Optional[NaiveBayesParameters] = None, **kw):
        super().__init__(params or NaiveBayesParameters(**kw))

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        di = DataInfo.fit(
            frame, response_column=p.response_column,
            ignored_columns=p.ignored_columns,
            weights_column=p.weights_column, standardize=False,
            use_all_factor_levels=True, add_intercept=False,
            missing_values_handling=p.missing_values_handling)
        if not di.is_classifier:
            raise ValueError("naivebayes requires a categorical response")
        return di

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> NaiveBayesModel:
        p: NaiveBayesParameters = self.params
        X = di.make_matrix(frame)
        y = di.response(frame)
        w = di.weights(frame)
        K = di.nclasses
        Y = (y.clamp(0, K - 1).to(torch.int64)[:, None]
             == torch.arange(K, device=X.device)[None, :]).to(torch.float32)
        M1, M2, nk = _class_moments(X, Y, w)
        M1 = M1.cpu().numpy().astype(np.float64)
        M2 = M2.cpu().numpy().astype(np.float64)
        nk = nk.cpu().numpy().astype(np.float64)
        n = nk.sum()

        P = di.nfeatures
        log_cat = np.zeros((P, K))
        num_idx, num_mu, num_var = [], [], []
        for s in di.specs:
            sl = slice(s.offset, s.offset + s.width)
            if s.type == T_CAT:
                counts = M1[:, sl].T                 # [W, K] level counts
                # the NA bucket (last level of the block) contributes
                # nothing at score time (NaiveBayes.java skips NAs): out
                # of the denominator too
                denom = counts[:-1].sum(axis=0) + p.laplace * (s.width - 1)
                probs = (counts + p.laplace) / np.maximum(denom[None, :],
                                                          1e-30)
                # NaiveBayes.java: probability <= eps_prob -> min_prob
                probs = np.where(probs <= max(p.eps_prob, 1e-30),
                                 p.min_prob, probs)
                log_cat[sl, :] = np.log(probs)
                log_cat[s.offset + s.width - 1, :] = 0.0
            else:
                mu_k = M1[:, s.offset] / np.maximum(nk, 1e-30)
                var_k = M2[:, s.offset] / np.maximum(nk, 1e-30) - mu_k**2
                sd_k = np.sqrt(np.maximum(var_k, 0.0) * nk
                               / np.maximum(nk - 1.0, 1.0))
                # NaiveBayes.java: sdev <= eps_sdev -> min_sdev
                sd_k = np.where(sd_k <= max(p.eps_sdev, 1e-30),
                                p.min_sdev, sd_k)
                num_idx.append(s.offset)
                num_mu.append(mu_k)
                num_var.append(sd_k**2)
        prior = nk / max(n, 1e-30)

        model = NaiveBayesModel(job.dest_key or dkv.make_key(self.algo), p, di)
        if num_idx:
            mu = np.stack(num_mu, axis=1)                   # [K, Pn]
            var = np.stack(num_var, axis=1)
        else:
            mu, var = np.zeros((K, 0)), np.ones((K, 0))
        model.output.update({
            "apriori": prior,
            "levels": list(di.response_domain),
            "coef_names": di.coef_names,
            "_log_cat_table": log_cat,
            "_num_idx": np.asarray(num_idx, np.int64),
            "_num_mu": mu,
            "_num_inv2var": 1.0 / (2.0 * var),
            "_num_logsd": 0.5 * np.log(2 * np.pi * var),
            "_log_prior": np.log(np.maximum(prior, 1e-30)),
        })
        if p.compute_metrics:
            from ..metrics.core import make_metrics
            raw = model._predict_raw(X)
            model.training_metrics = make_metrics(di, raw, y, w)
            if valid is not None:
                model.validation_metrics = model.model_performance(valid)
        return model
