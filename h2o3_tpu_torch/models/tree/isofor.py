"""Isolation Forest and Extended Isolation Forest — the port of
``h2o3_tpu/models/tree/isofor.py`` (hex/tree/isofor/IsolationForest.java:33,
hex/tree/isoforextended/ExtendedIsolationForest.java).

An isolation tree grows on a row sample of at most ``sample_size`` rows.
A level needs only each leaf's min, max and count over its sampled rows
of the drawn feature (``scatter_reduce`` on the device); the split draws
(a random feature and a uniform threshold per leaf; an EIF's random
hyperplane with ``extension_level + 1`` non-zero components) are numpy
draws on the host, in the JAX package's order from
``np.random.default_rng(seed)``, so one seed grows bitwise the same trees
on the CPU, on the card and in the JAX package (there the ensemble's
stats run over every row with the others masked out; here they run over
the sampled rows alone, the same numbers).  A leaf's value is its
isolation path length (valid splits above it plus c(final count)), so
scoring is the tree traversal and the anomaly score ``2^(-E[h]/c(n))``.
An IsolationForest exports in the portable archive's ``isolation``
family (``to_archive``), which ``PackedScorer`` serves through
``csrc/traverse.cu``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ...frame.frame import Frame
from ...frame.vec import T_NUM, Vec
from ...runtime import dkv
from ...runtime.job import Job
from ..base import ModelBuilder
from ..datainfo import DataInfo
from .shared import (SharedTreeModel, SharedTreeParameters, StackedTrees,
                     Tree, traverse)

_BIG = 3.4e38


def _avg_path_length(n) -> float:
    """c(n): the expected path length of an unsuccessful BST search
    (iForest eq. 1)."""
    if n <= 1:
        return 0.0
    if n == 2:
        return 1.0
    h = math.log(n - 1) + 0.5772156649015329
    return 2.0 * h - 2.0 * (n - 1) / n


@dataclasses.dataclass
class IsolationForestParameters(SharedTreeParameters):
    ntrees: int = 50
    sample_size: int = 256
    max_depth: int = 8
    contamination: float = -1.0          # optional threshold quantile


@dataclasses.dataclass
class ExtendedIsolationForestParameters(IsolationForestParameters):
    extension_level: int = 0             # 0 == standard iForest


def _segment(x: torch.Tensor, leaf: torch.Tensor, L: int, reduce: str,
             init: float) -> torch.Tensor:
    """Per-leaf ``reduce`` ("amin", "amax", "sum") of ``x`` [S] or [S, F]
    over leaves ``leaf`` [S]; a leaf without rows keeps ``init``."""
    shape = (L,) + tuple(x.shape[1:])
    idx = leaf.long().view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    out = torch.full(shape, init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, idx, x, reduce, include_self=False)


def _termination_depths(valid_levels: List[np.ndarray],
                        max_depth: int) -> np.ndarray:
    """Per final leaf: the valid splits along its ancestor path."""
    Lfin = 2 ** max_depth
    depths = np.zeros(Lfin, np.int64)
    for d, v in enumerate(valid_levels):
        depths += v[np.arange(Lfin) >> (max_depth - d)].astype(np.int64)
    return depths


def _path_values(valid_levels, leaf: torch.Tensor, depth: int) -> np.ndarray:
    """Each final leaf's path length: its termination depth plus c(the
    sampled rows that end in it)."""
    cnt = torch.bincount(leaf.long(), minlength=2 ** depth).cpu().numpy()
    pl = _termination_depths(valid_levels, depth) \
        + np.array([_avg_path_length(int(c)) for c in cnt])
    return pl.astype(np.float32)


def _project(Xz: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products of [S, F] rows with their [S, F] normals, in
    feature order (a fixed order, so the CPU and the card agree
    bitwise)."""
    proj = Xz[:, 0] * normals[:, 0]
    for j in range(1, Xz.shape[1]):
        proj = proj + Xz[:, j] * normals[:, j]
    return proj


def _anomaly_frame(names, mean_len: np.ndarray, c: float, dev) -> Frame:
    score = np.exp2(-mean_len / max(c, 1e-9))
    return Frame(names, [Vec.from_numpy(score, T_NUM, device=dev),
                         Vec.from_numpy(mean_len, T_NUM, device=dev)])


class IsolationForestModel(SharedTreeModel):
    algo = "isolationforest"

    def _path_lengths(self, X: torch.Tensor) -> torch.Tensor:
        st: StackedTrees = self.output["stacked"]
        return traverse(st.levels, st.values, X) / st.ntrees

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        c = self.output["c_norm"]
        return torch.exp2(-self._path_lengths(X) / max(c, 1e-9))

    def predict(self, frame: Frame) -> Frame:
        """``predict`` (the anomaly score) and ``mean_length``."""
        X = self._design(frame)
        mean_len = self._path_lengths(X)[: frame.nrows].cpu().numpy() \
            .astype(np.float64)
        return _anomaly_frame(["predict", "mean_length"], mean_len,
                              self.output["c_norm"], frame.device)

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        score = self.predict(frame).vecs[0].to_numpy()
        return {"mean_score": float(np.mean(score)),
                "max_score": float(np.max(score))}

    def to_archive(self):
        """``(meta, arrays)`` in the portable archive's ``isolation``
        family (the JAX package's ``export/mojo.py::_extract``): the tree
        arrays, ``c_norm`` and the depth; ``ScoringModel`` and
        ``PackedScorer`` score it."""
        meta, arrays = super().to_archive()
        for k in ("tree_average", "nclass_trees", "link", "init_score"):
            meta.pop(k)
        meta.update(family="isolation", depth=self.params.max_depth,
                    c_norm=float(self.output["c_norm"]))
        # an isolation tree grows on below a node that did not split (its
        # rows all go left, and a deeper level may split them on another
        # feature), but the packed walk stops at an invalid node: such a
        # node is written as a split that sends every row left (threshold
        # NaN, NA left), so the export scores as ``predict`` does.  The
        # JAX package's export writes it invalid and scores otherwise.
        depth = meta["depth"]
        below = np.zeros_like(arrays[f"valid_{depth - 1}"])
        for d in range(depth - 1, -1, -1):
            valid = arrays[f"valid_{d}"]
            through = ~valid & below
            arrays[f"valid_{d}"] = valid | through
            arrays[f"thr_{d}"] = np.where(through, np.float32(np.nan),
                                          arrays[f"thr_{d}"])
            arrays[f"na_left_{d}"] = arrays[f"na_left_{d}"] | through
            if d:          # whether a level d-1 node has a splitting one
                below = (valid | below).reshape(valid.shape[0], -1, 2) \
                    .any(-1)
        return meta, arrays


class IsolationForest(ModelBuilder):
    """Isolation Forest builder — H2OIsolationForestEstimator."""

    algo = "isolationforest"
    model_class = IsolationForestModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[IsolationForestParameters] = None,
                 **kw):
        super().__init__(params or IsolationForestParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if self.params.monotone_constraints:
            raise ValueError(
                "monotone_constraints is only enforced for GBM/XGBoost; "
                f"{self.algo} would silently ignore it")

    def _make_datainfo(self, frame: Frame) -> DataInfo:
        p = self.params
        return DataInfo.fit(
            frame, response_column=None, ignored_columns=p.ignored_columns,
            standardize=False, add_intercept=False,
            missing_values_handling=p.missing_values_handling)

    @staticmethod
    def _sample(nrows: int, size: int, rng: np.random.Generator, dev):
        """The tree's row sample: ``min(size, nrows)`` rows without
        replacement (the JAX package's draw)."""
        idx = rng.choice(nrows, size=min(size, nrows), replace=False)
        return torch.from_numpy(idx).to(dev)

    def _grow(self, Xs: torch.Tensor, depth: int, rng):
        """One isolation tree on its sampled rows Xs [S, F]: per-level
        feature, threshold and valid (NaN goes left), and each sampled
        row's final leaf."""
        S, Fn = Xs.shape
        dev = Xs.device
        leaf = torch.zeros(S, dtype=torch.int64, device=dev)
        feat_l, thr_l, val_l = [], [], []
        for d in range(depth):
            L = 2 ** d
            f = rng.integers(0, Fn, size=L).astype(np.int32)
            fj = torch.from_numpy(f).to(dev)
            x = Xs.gather(1, fj.long()[leaf][:, None])[:, 0]
            act = ~torch.isnan(x)
            la, xa = leaf[act], x[act]
            stats = torch.stack([
                _segment(xa, la, L, "amin", _BIG),
                _segment(xa, la, L, "amax", -_BIG),
                _segment(torch.ones_like(xa), la, L, "sum", 0.0)])
            mn_h, mx_h, cnt_h = stats.cpu().numpy().astype(np.float64)
            valid = (cnt_h > 1) & (mx_h > mn_h)
            u = rng.random(L)
            mn_h = np.where(valid, mn_h, 0.0)
            mx_h = np.where(valid, mx_h, 0.0)
            thr = (mn_h + u * (mx_h - mn_h)).astype(np.float32)
            vj = torch.from_numpy(valid).to(dev)
            tj = torch.from_numpy(thr).to(dev)
            right = torch.where(torch.isnan(x), False, x >= tj[leaf])
            leaf = 2 * leaf + (right & vj[leaf]).long()
            feat_l.append(f)
            thr_l.append(thr)
            val_l.append(valid)
        return feat_l, thr_l, val_l, leaf

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> IsolationForestModel:
        p: IsolationForestParameters = self.params
        rng = np.random.default_rng(p.effective_seed())
        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        X = model._design(frame)
        dev = X.device
        depth = p.max_depth
        trees: List[Tree] = []
        for t in range(p.ntrees):
            idx = self._sample(frame.nrows, p.sample_size, rng, dev)
            feat_l, thr_l, val_l, leaf = self._grow(X[idx], depth, rng)
            pl = _path_values(val_l, leaf, depth)

            def on(a, dtype):
                return torch.from_numpy(np.asarray(a, dtype)).to(dev)
            trees.append(Tree([on(f, np.int32) for f in feat_l],
                              [on(x, np.float32) for x in thr_l],
                              [on(np.ones(len(v)), bool) for v in val_l],
                              [on(v, bool) for v in val_l],
                              on(pl, np.float32)))
            job.update((t + 1) / p.ntrees, f"itree {t + 1}/{p.ntrees}")
        model.output.update({
            "stacked": StackedTrees.from_trees(trees), "trees": trees,
            "ntrees_trained": len(trees),
            "c_norm": _avg_path_length(min(p.sample_size, frame.nrows)),
            "nclass_trees": 1, "init_score": 0.0,
        })
        score = model.predict(frame).vecs[0].to_numpy()
        model.training_metrics = {"mean_score": float(np.mean(score)),
                                  "max_score": float(np.max(score))}
        if p.contamination > 0:
            model.output["threshold"] = float(
                np.quantile(score, 1.0 - p.contamination))
        return model


# ===================================================== extended isolation
@dataclasses.dataclass
class _EITree:
    normals: List[np.ndarray]     # per level [L, F]
    offsets: List[np.ndarray]     # per level [L]
    valid: List[np.ndarray]       # per level [L]
    values: np.ndarray            # [2^depth] path lengths


class ExtendedIsolationForestModel(SharedTreeModel):
    algo = "extendedisolationforest"
    exportable = False

    def _path_lengths(self, X: torch.Tensor) -> torch.Tensor:
        dev = X.device
        total = torch.zeros(X.shape[0], dtype=torch.float32, device=dev)
        Xz = torch.nan_to_num(X)
        for t in self.output["trees"]:
            node = torch.zeros(X.shape[0], dtype=torch.int64, device=dev)
            for nm, off, vd in zip(t.normals, t.offsets, t.valid):
                nmj = torch.from_numpy(nm).to(dev)
                offj = torch.from_numpy(off).to(dev)
                vj = torch.from_numpy(vd).to(dev)
                right = (_project(Xz, nmj[node]) >= offj[node]) & vj[node]
                node = 2 * node + right.long()
            total = total + torch.from_numpy(t.values).to(dev)[node]
        return total / len(self.output["trees"])

    def _predict_raw(self, X: torch.Tensor) -> torch.Tensor:
        c = self.output["c_norm"]
        return torch.exp2(-self._path_lengths(X) / max(c, 1e-9))

    def predict(self, frame: Frame) -> Frame:
        """``anomaly_score`` and ``mean_length``."""
        X = self._design(frame)
        mean_len = self._path_lengths(X)[: frame.nrows].cpu().numpy() \
            .astype(np.float64)
        return _anomaly_frame(["anomaly_score", "mean_length"], mean_len,
                              self.output["c_norm"], frame.device)

    def model_performance(self, frame: Optional[Frame] = None):
        if frame is None:
            return self.training_metrics
        score = self.predict(frame).vecs[0].to_numpy()
        return {"mean_score": float(np.mean(score))}


class ExtendedIsolationForest(IsolationForest):
    """Extended IF builder — H2OExtendedIsolationForestEstimator."""

    algo = "extendedisolationforest"
    model_class = ExtendedIsolationForestModel

    def __init__(self, params: Optional[ExtendedIsolationForestParameters]
                 = None, **kw):
        ModelBuilder.__init__(
            self, params or ExtendedIsolationForestParameters(**kw))

    def _grow_ei(self, Xs: torch.Tensor, depth: int, ext: int, rng):
        """One extended isolation tree on its sampled rows Xs [S, F]
        (NaN as 0): per-level normals, offsets and valid, and each
        sampled row's final leaf."""
        S, Fn = Xs.shape
        dev = Xs.device
        leaf = torch.zeros(S, dtype=torch.int64, device=dev)
        norm_l, off_l, val_l = [], [], []
        for d in range(depth):
            L = 2 ** d
            # the bounding box per (leaf, feature) for the intercept
            stats = torch.stack([_segment(Xs, leaf, L, "amin", _BIG),
                                 _segment(Xs, leaf, L, "amax", -_BIG)])
            mn, mx = stats.cpu().numpy().astype(np.float64)
            cnt = torch.bincount(leaf, minlength=L).cpu().numpy() \
                .astype(np.float64)
            valid = (cnt > 1) & (mx > mn).any(axis=1)
            occupied = cnt[:, None] > 0
            mn = np.where(occupied, mn, 0.0)
            mx = np.where(occupied, np.maximum(mx, mn), 0.0)
            # a random hyperplane with ext+1 non-zero components
            nm = rng.normal(size=(L, Fn))
            if ext + 1 < Fn:
                for i in range(L):
                    keep = rng.choice(Fn, size=ext + 1, replace=False)
                    z = np.ones(Fn, bool)
                    z[keep] = False
                    nm[i, z] = 0.0
            nm /= np.maximum(np.linalg.norm(nm, axis=1, keepdims=True),
                             1e-12)
            pt = mn + rng.random((L, Fn)) * np.maximum(mx - mn, 0.0)
            off = np.sum(nm * pt, axis=1)
            nm32, off32 = nm.astype(np.float32), off.astype(np.float32)
            nmj = torch.from_numpy(nm32).to(dev)
            offj = torch.from_numpy(off32).to(dev)
            vj = torch.from_numpy(valid).to(dev)
            right = (_project(Xs, nmj[leaf]) >= offj[leaf]) & vj[leaf]
            leaf = 2 * leaf + right.long()
            norm_l.append(nm32)
            off_l.append(off32)
            val_l.append(valid)
        return norm_l, off_l, val_l, leaf

    def _fit(self, job: Job, frame: Frame, di: DataInfo,
             valid: Optional[Frame]) -> ExtendedIsolationForestModel:
        p: ExtendedIsolationForestParameters = self.params
        rng = np.random.default_rng(p.effective_seed())
        model = self.model_class(job.dest_key or dkv.make_key(self.algo),
                                 p, di)
        Xz = torch.nan_to_num(model._design(frame))
        ext = min(p.extension_level, Xz.shape[1] - 1)
        depth = p.max_depth
        trees: List[_EITree] = []
        for t in range(p.ntrees):
            idx = self._sample(frame.nrows, p.sample_size, rng, Xz.device)
            norm_l, off_l, val_l, leaf = self._grow_ei(Xz[idx], depth, ext,
                                                       rng)
            trees.append(_EITree(norm_l, off_l, val_l,
                                 _path_values(val_l, leaf, depth)))
            job.update((t + 1) / p.ntrees, f"eitree {t + 1}/{p.ntrees}")
        model.output.update({
            "trees": trees, "ntrees_trained": len(trees),
            "c_norm": _avg_path_length(min(p.sample_size, frame.nrows)),
        })
        score = model.predict(frame).vecs[0].to_numpy()
        model.training_metrics = {"mean_score": float(np.mean(score))}
        return model
