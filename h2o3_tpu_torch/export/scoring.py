"""Standalone scoring for exported models — numpy + stdlib ONLY.

Reference: ``h2o-genmodel`` — ``hex/genmodel/MojoModel.java:12``,
``EasyPredictModelWrapper.java:65``: a zero-dependency scoring library
that loads a model archive and predicts with no cluster.

The port's copy of ``h2o3_tpu/export/scoring.py`` for the families the
serving plane packs (``tree``: GBM/XGBoost/DRF, and ``isolation``), the
numpy oracle behind ``PackedScorer``'s ``"ref"``/``"check"`` score
modes, for ``glm`` (the standardized one-hot design, the family's
link) and for ``deeplearning`` (the same design through the layers:
tanh or rectifier, softmax or the de-standardized regression), for
``kmeans``, ``pca`` (PCA and SVD) and ``naivebayes`` on the same design,
and for ``isotonic`` on its feature column; tree models also give their
TreeSHAP contributions (``treeshap.py``).  The archive format lives in
mojo.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..serving import pack as _pack

# the families scored on the standardized one-hot design
_STANDARDIZED = ("glm", "deeplearning", "kmeans", "pca", "naivebayes")


class ScoringModel:
    """Loaded portable model — the MojoModel/EasyPredictModelWrapper analog."""

    def __init__(self, meta: dict, arrays: Dict[str, np.ndarray]):
        self.meta = meta
        self.arrays = arrays
        self.algo = meta["algo"]
        self.spec = meta["datainfo"]

    # ------------------------------------------------------- featurization
    def _columns(self, data: Dict[str, np.ndarray], n: int):
        cols = {}
        for s in self.spec["specs"]:
            name = s["name"]
            if name not in data:
                cols[name] = np.full(n, np.nan)
                continue
            col = np.asarray(data[name])
            if s["type"] == "cat":
                if col.dtype == object or col.dtype.kind in "US":
                    lookup = {lbl: i for i, lbl in enumerate(s["domain"])}
                    col = np.array([lookup.get(str(v), -1) for v in col],
                                   dtype=np.float64)
                else:
                    col = col.astype(np.float64)
                    col[~np.isfinite(col)] = -1
            else:
                col = col.astype(np.float64)
            cols[name] = col
        return cols

    def _design_standardized(self, data: Dict[str, np.ndarray], n: int):
        """One-hot + impute + standardize matrix (DataInfo.make_matrix)."""
        cols = self._columns(data, n)
        out = []
        for s in self.spec["specs"]:
            x = cols[s["name"]]
            if s["type"] == "cat":
                lo = 0 if self.spec["use_all_factor_levels"] else 1
                width = s["width"] - 1
                levels = np.arange(lo, lo + width)
                onehot = (x[:, None] == levels[None, :]).astype(np.float64)
                na = (x < 0)[:, None].astype(np.float64)
                out.append(np.concatenate([onehot, na], axis=1))
            else:
                xi = np.where(np.isnan(x), s["mean"], x)
                if self.spec["standardize"]:
                    xi = (xi - s["mean"]) / s["sigma"]
                out.append(xi[:, None])
        if self.spec["add_intercept"]:
            out.append(np.ones((n, 1)))
        return np.concatenate(out, axis=1)

    def _design_raw(self, data: Dict[str, np.ndarray], n: int):
        """Raw-value matrix for tree traversal (cat codes, NaN missing).

        float32, matching the training design: thresholds are f32 values of
        f32 data, so comparing in f64 flips ties at the split boundaries.
        """
        cols = self._columns(data, n)
        out = []
        for s in self.spec["specs"]:
            x = cols[s["name"]]
            if s["type"] == "cat":
                x = np.where(x < 0, np.nan, x)
            out.append(x)
        return np.stack(out, axis=1).astype(np.float32)

    # ------------------------------------------------------------ predict
    def predict(self, data) -> dict:
        """Score rows.  ``data``: dict of column arrays, or a single row dict.

        Returns {"predict": labels-or-values, "probabilities": [n, K]?}.
        """
        single = all(np.isscalar(v) or isinstance(v, str)
                     for v in data.values())
        if single:
            data = {k: np.asarray([v]) for k, v in data.items()}
        else:
            data = {k: np.asarray(v) for k, v in data.items()}
        n = len(next(iter(data.values())))
        family = self.meta["family"]
        if family in _STANDARDIZED:
            raw = getattr(self, f"_score_{family}")(
                self._design_standardized(data, n))
        elif family == "isotonic":
            raw = self._score_isotonic(data)
        else:
            raw = self.score_raw(self._design_raw(data, n))
        domain = self.spec.get("response_domain")
        if domain:
            labels = np.asarray(domain, dtype=object)[np.argmax(raw, axis=1)]
            if raw.shape[1] == 2:
                thr = self.meta.get("default_threshold", 0.5)
                labels = np.asarray(domain, dtype=object)[
                    (raw[:, 1] >= thr).astype(int)]
            out = {"predict": labels, "probabilities": raw}
        else:
            out = {"predict": raw.reshape(-1)}
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    def score_raw(self, X: np.ndarray) -> np.ndarray:
        """Raw f32 design matrix (``_design_raw``) -> probabilities
        ``[n, K]`` or values ``[n]``."""
        family = self.meta["family"]
        if family == "tree":
            return self._score_tree(X)
        if family == "isolation":
            return self._score_isolation(X)
        raise ValueError(f"no standalone scorer for family {family!r}")

    def predict_contributions(self, data) -> dict:
        """TreeSHAP contributions — EasyPredictModelWrapper
        ``predictContributions`` analog (binomial/regression tree models;
        the JAX package's ``ScoringModel.predict_contributions``).

        Returns {"names": [...features, "BiasTerm"], "contributions":
        [n, F+1]}; rows sum to the margin prediction.
        """
        if self.meta.get("family") != "tree":
            raise ValueError("contributions are for tree models")
        if int(self.meta.get("nclass_trees", 1)) > 1:
            raise ValueError("contributions support binomial/regression "
                             "models only")
        if "covers" not in self.arrays:
            raise ValueError("artifact has no covers; re-export from a "
                             "model trained with cover recording")
        from . import treeshap
        T = int(self.meta["ntrees"])
        depth = int(self.meta["depth"])
        trees = []
        for t in range(T):
            trees.append(treeshap._ShapTree(
                [self.arrays[f"feat_{d}"][t] for d in range(depth)],
                [self.arrays[f"thr_{d}"][t] for d in range(depth)],
                [self.arrays[f"na_left_{d}"][t] for d in range(depth)],
                [self.arrays[f"valid_{d}"][t] for d in range(depth)],
                self.arrays["values"][t], self.arrays["covers"][t]))
        data = {k: np.asarray(v) for k, v in data.items()}
        n = len(next(iter(data.values())))
        X = self._design_raw(data, n).astype(np.float64)
        if self.meta.get("tree_average", False):
            scale, init = 1.0 / max(T, 1), 0.0
        else:
            scale, init = 1.0, float(self.meta["init_score"])
        contribs = treeshap.ensemble_contributions(trees, X, init, scale)
        names = [s["name"] for s in self.spec["specs"]] + ["BiasTerm"]
        return {"names": names, "contributions": contribs}

    # ------------------------------------------------------------ families
    def _linkinv(self, eta):
        link = self.meta.get("link", "identity")
        if link == "logit":
            return 1.0 / (1.0 + np.exp(-eta))
        if link == "log":
            return np.exp(eta)
        return eta

    def _score_glm(self, X):
        """The standardized design (``_design_standardized``) ->
        probabilities ``[n, K]`` or values ``[n]``."""
        beta = self.arrays["beta"]
        if beta.ndim == 2:                         # multinomial
            eta = X @ beta
            eta -= eta.max(axis=1, keepdims=True)
            p = np.exp(eta)
            return p / p.sum(axis=1, keepdims=True)
        mu = self._linkinv(X @ beta)
        if self.spec.get("response_domain"):
            return np.stack([1 - mu, mu], axis=1)
        return mu

    def _score_deeplearning(self, X):
        """The standardized design (``_design_standardized``) through the
        layers ``W_i``, ``b_i`` -> probabilities ``[n, K]`` or values
        ``[n]``.  An output of several columns without a response domain
        is an autoencoder's reconstruction, which this scorer does not
        make."""
        h = X
        act = self.meta["activation"]
        i = 0
        while f"W_{i}" in self.arrays:
            h = h @ self.arrays[f"W_{i}"] + self.arrays[f"b_{i}"]
            if f"W_{i + 1}" in self.arrays:          # a hidden layer
                h = np.tanh(h) if act == "tanh" else np.maximum(h, 0.0)
            i += 1
        if self.spec.get("response_domain"):
            e = np.exp(h - h.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if h.shape[1] != 1:
            raise ValueError("an autoencoder's archive: the numpy scorer "
                             "makes no reconstruction")
        return h.reshape(-1) * self.meta.get("response_sigma", 1.0) \
            + self.meta.get("response_mean", 0.0)

    def _packed(self, prefix=""):
        """Bitpacked node planes for one class group, packed once and
        cached — the layout serving/kernel.py puts on device."""
        cache = self.__dict__.setdefault("_pack_cache", {})
        pk = cache.get(prefix)
        if pk is None:
            pk = _pack.pack_group(self.arrays, int(self.meta["depth"]),
                                  prefix=prefix)
            cache[prefix] = pk
        return pk

    def _traverse(self, X, prefix=""):
        """Sum of packed-tree leaf values — GenModel tree walk.

        The heap-layout level arrays flatten once into the serving
        pack's bitpacked node planes, then descend iteratively with an
        early exit once every (row, tree) sits on a leaf.
        """
        i32, f32, roots = self._packed(prefix)
        leaves = _pack.traverse(i32, f32, roots, X,
                                int(self.meta["depth"]))
        return leaves.sum(axis=1)

    def _score_tree(self, X):
        K = int(self.meta.get("nclass_trees", 1))
        avg = self.meta.get("tree_average", False)
        T = int(self.meta["ntrees"])
        if K > 1:
            scores = np.stack([self._traverse(X, prefix=f"k{k}_")
                               for k in range(K)], axis=1)
            scores += np.asarray(self.meta["init_score"])[None, :]
            if avg:
                p = np.clip(scores / max(T, 1), 0, 1)
                return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
            e = np.exp(scores - scores.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        s = self._traverse(X) + float(self.meta["init_score"])
        if avg:
            s = s / max(T, 1)
        if self.spec.get("response_domain"):
            p1 = np.clip(s if avg else 1 / (1 + np.exp(-s)), 0.0, 1.0)
            return np.stack([1 - p1, p1], axis=1)
        link = self.meta.get("link", "identity")
        return np.exp(s) if link == "log" else s

    def _score_isolation(self, X):
        T = int(self.meta["ntrees"])
        mean_len = self._traverse(X) / max(T, 1)
        c = max(self.meta["c_norm"], 1e-9)
        return np.exp2(-mean_len / c)

    def _score_kmeans(self, X):
        """The nearest standardized centre's index, as a float [n]."""
        C = self.arrays["centers_std"]
        d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        return np.argmin(d2, axis=1).astype(np.float64)

    def _score_pca(self, X):
        """The rows in the fitted transform's space times the components
        [n, k] (``predict`` returns them flattened, as the JAX package's
        scorer does)."""
        mu, sd = self.arrays["mu"], self.arrays["sd"]
        Xt = (X - mu[None, :]) * sd[None, :]
        return Xt @ self.arrays["eigenvectors"]

    def _score_naivebayes(self, X):
        """The class probabilities [n, K]: the level table's product plus
        the Gaussian terms of the numeric columns."""
        ll = X @ self.arrays["log_cat_table"] \
            + self.arrays["log_prior"][None, :]
        idx = self.arrays["num_idx"].astype(int)
        if len(idx):
            Xn = X[:, idx]
            mu = self.arrays["num_mu"]
            diff = Xn[:, None, :] - mu[None, :, :]
            ll = ll - (diff * diff * self.arrays["num_inv2var"][None]
                       + self.arrays["num_logsd"][None]).sum(axis=2)
        ll -= ll.max(axis=1, keepdims=True)
        p = np.exp(ll)
        return p / p.sum(axis=1, keepdims=True)

    def _score_isotonic(self, data):
        """The thresholds' linear interpolation of the feature column,
        NaN outside them under ``out_of_bounds="na"``."""
        x = np.asarray(data[self.meta["feature"]], np.float64)
        tx, ty = self.arrays["thresholds_x"], self.arrays["thresholds_y"]
        pred = np.interp(x, tx, ty)
        if self.meta.get("out_of_bounds") == "na":
            pred = np.where((x < tx[0]) | (x > tx[-1]), np.nan, pred)
        return np.where(np.isnan(x), np.nan, pred)
