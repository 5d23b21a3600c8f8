"""Standalone scoring for exported tree ensembles — numpy + stdlib ONLY.

Reference: ``h2o-genmodel`` — ``hex/genmodel/MojoModel.java:12``,
``EasyPredictModelWrapper.java:65``: a zero-dependency scoring library
that loads a model archive and predicts with no cluster.

The port's copy of ``h2o3_tpu/export/scoring.py`` for the families the
serving plane packs (``tree``: GBM/XGBoost/DRF, and ``isolation``).  It
is the numpy oracle behind ``PackedScorer``'s ``"ref"``/``"check"``
score modes.  The archive format lives in mojo.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..serving import pack as _pack


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
        """TreeSHAP contributions: not ported yet (needs the port of
        ``h2o3_tpu/export/treeshap.py``)."""
        raise NotImplementedError(
            "predict_contributions needs treeshap, which h2o3_tpu_torch "
            "has not ported yet")

    # ------------------------------------------------------------ families
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
