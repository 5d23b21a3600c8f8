"""TreeSHAP: exact Shapley feature contributions for tree ensembles.

Reference: ``h2o-extensions/xgboost/.../predict/PredictTreeSHAPTask.java``
and ``h2o-genmodel`` EasyPredictModelWrapper ``predictContributions`` —
both run Lundberg's TreeSHAP (Algorithm 2 of the Tree SHAP paper) per row
per tree on the CPU using per-node covers recorded at training time.

The port's copy of ``h2o3_tpu/export/treeshap.py``, numpy-only as there:
the trained models (``SharedTreeModel.predict_contributions``, which
bring their trees and design to the host once) and the portable scoring
artifact (export/scoring.py, numpy and stdlib only) share it.  Trees here
are the perfect-depth per-level arrays of models/tree/shared.py: an
invalid interior node routes everything left, so it behaves as a leaf
whose value/cover are the cover-weighted aggregate of its subtree (all
cover sits on the leftmost path by construction).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class _ShapTree:
    """One tree unpacked into heap-ordered node arrays."""

    def __init__(self, feat, thr, na_left, valid, values, cover):
        depth = len(feat)
        self.depth = depth
        # per-level arrays; level d has 2^d nodes
        self.feat = [np.asarray(f, np.int64) for f in feat]
        self.thr = [np.asarray(t, np.float64) for t in thr]
        self.na_left = [np.asarray(n, bool) for n in na_left]
        self.valid = [np.asarray(v, bool) for v in valid]
        leaf_values = np.asarray(values, np.float64)
        leaf_cover = np.asarray(cover, np.float64)
        # bottom-up node value/cover (cover-weighted subtree means)
        self.value = [None] * (depth + 1)
        self.cover = [None] * (depth + 1)
        self.value[depth] = leaf_values
        self.cover[depth] = leaf_cover
        for d in range(depth - 1, -1, -1):
            cl = self.cover[d + 1][0::2]
            cr = self.cover[d + 1][1::2]
            vl = self.value[d + 1][0::2]
            vr = self.value[d + 1][1::2]
            c = cl + cr
            with np.errstate(invalid="ignore", divide="ignore"):
                v = np.where(c > 0, (vl * cl + vr * cr) / np.maximum(c, 1e-300),
                             0.0)
            self.value[d] = v
            self.cover[d] = c

    def is_leaf(self, d: int, i: int) -> bool:
        return d == self.depth or not self.valid[d][i]


def _extend(m, pz, po, pi):
    """EXTEND from the TreeSHAP paper: grow the feature path."""
    # m: list of [feature, zero_frac, one_frac, weight]
    l = len(m)
    m.append([pi, pz, po, 1.0 if l == 0 else 0.0])
    for i in range(l - 1, -1, -1):
        m[i + 1][3] += po * m[i][3] * (i + 1) / (l + 1)
        m[i][3] = pz * m[i][3] * (l - i) / (l + 1)


def _unwind(m, i):
    """UNWIND: undo the EXTEND that added path element i (new list)."""
    l = len(m) - 1
    pz, po = m[i][1], m[i][2]
    out = [row[:] for row in m]
    n = out[l][3]
    for j in range(l - 1, -1, -1):
        if po != 0:
            t = out[j][3]
            out[j][3] = n * (l + 1) / ((j + 1) * po)
            n = t - out[j][3] * pz * (l - j) / (l + 1)
        else:
            out[j][3] = out[j][3] * (l + 1) / (pz * (l - j))
    for j in range(i, l):
        out[j][0], out[j][1], out[j][2] = out[j + 1][0], out[j + 1][1], \
            out[j + 1][2]
    return out[:l]


def _unwound_sum(m, i):
    l = len(m) - 1
    pz, po = m[i][1], m[i][2]
    total = 0.0
    if po != 0:
        n = m[l][3]
        for j in range(l - 1, -1, -1):
            t = n / ((j + 1) * po)          # = unwound weight / (l+1)
            total += t
            n = m[j][3] - t * pz * (l - j)
    else:
        for j in range(l - 1, -1, -1):
            total += m[j][3] / (pz * (l - j))
    return total * (l + 1)


def _shap_recurse(tree: _ShapTree, x, phi, d, i, m, pz, po, pi):
    m = [row[:] for row in m]
    _extend(m, pz, po, pi)
    if tree.is_leaf(d, i):
        v = tree.value[d][i]
        for j in range(1, len(m)):
            w = _unwound_sum(m, j)
            phi[m[j][0]] += w * (m[j][2] - m[j][1]) * v
        return
    f = int(tree.feat[d][i])
    xv = x[f]
    goes_left = (not np.isnan(xv) and xv < tree.thr[d][i]) or \
        (np.isnan(xv) and tree.na_left[d][i])
    hot, cold = (2 * i, 2 * i + 1) if goes_left else (2 * i + 1, 2 * i)
    c_parent = tree.cover[d][i]
    if c_parent <= 0:
        return
    iz, io = 1.0, 1.0
    k = next((j for j in range(1, len(m)) if m[j][0] == f), None)
    if k is not None:
        iz, io = m[k][1], m[k][2]
        m = _unwind(m, k)
    ch, cc = tree.cover[d + 1][hot], tree.cover[d + 1][cold]
    _shap_recurse(tree, x, phi, d + 1, hot, m, iz * ch / c_parent, io, f)
    _shap_recurse(tree, x, phi, d + 1, cold, m, iz * cc / c_parent, 0.0, f)


def tree_contributions(tree: _ShapTree, X: np.ndarray) -> np.ndarray:
    """Per-row SHAP values for one tree: [n, F+1] (last col = bias)."""
    n, F = X.shape
    out = np.zeros((n, F + 1), np.float64)
    for r in range(n):
        phi = np.zeros(F, np.float64)
        _shap_recurse(tree, X[r], phi, 0, 0, [], 1.0, 1.0, -1)
        out[r, :F] = phi
        out[r, F] = tree.value[0][0]
    return out


def ensemble_contributions(trees: List[_ShapTree], X: np.ndarray,
                           init_score: float = 0.0,
                           scale: float = 1.0) -> np.ndarray:
    """Summed SHAP over an ensemble; bias column absorbs init_score.

    Invariant (tested): ``contribs.sum(axis=1) == margin prediction``.
    ``scale`` handles averaged ensembles (DRF: 1/ntrees).
    """
    n, F = X.shape
    out = np.zeros((n, F + 1), np.float64)
    for t in trees:
        out += tree_contributions(t, X)
    out *= scale
    out[:, F] += init_score
    return out


def shap_trees_from_model(trees) -> List[_ShapTree]:
    """Build _ShapTrees from host ``Tree`` objects (cover required)."""
    out = []
    for t in trees:
        if t.cover is None:
            raise ValueError(
                "tree has no recorded covers; contributions need a model "
                "trained by this version (re-train to enable TreeSHAP)")
        out.append(_ShapTree([np.asarray(f) for f in t.feat],
                             [np.asarray(x) for x in t.thr],
                             [np.asarray(x) for x in t.na_left],
                             [np.asarray(x) for x in t.valid],
                             np.asarray(t.values), np.asarray(t.cover)))
    return out
