"""Bitpacked flattened ensemble layout — numpy + stdlib ONLY.

Reference layout: the GPU tree-boosting paper (arXiv:1706.08359) flattens
an ensemble into a contiguous node array so traversal is one loop over
depth steps with no per-tree dispatch.  Here every node of every tree is
packed into two parallel planes:

* ``nodes_i32[N]`` — one int32 word per node::

      bits  0..9   feature id          (design-matrix column, F < 1024)
      bit   10     NA-goes-left        (missing value routed left)
      bit   11     leaf flag           (word is a terminal node)
      bits  12..31 left-child delta    (child_index - node_index, >= 0)

* ``nodes_f32[N]`` — split threshold (internal) or leaf value (leaf).

Trees are concatenated (BFS order per tree, levels contiguous) with the
root index of tree ``t`` in ``roots[t]``; a multinomial ensemble
concatenates its K per-class groups so ``roots`` has ``K*T`` entries.
Leaves are packed as self-loops (delta unused behind the leaf mask), so
a fixed ``depth``-step descent is branch-free: rows that reach a leaf
early simply re-read it.

This module is imported by ``export/scoring.py`` (the deployment
contract's numpy-only half) — it imports numpy only; the torch twin in
``serving/kernel.py`` and the CUDA kernel in ``csrc/traverse.cu`` share
these constants.  It is a copy of ``h2o3_tpu/serving/pack.py`` (the port
imports nothing of the JAX package), and the tests hold the two bitwise
equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

FEAT_MASK = 0x3FF            # bits 0..9
NA_LEFT_BIT = 10
LEAF_BIT = 11
DELTA_SHIFT = 12
DELTA_MASK = 0xFFFFF         # 20 bits
MAX_FEATURES = FEAT_MASK + 1


@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    """Device-shaped ensemble: two node planes + per-tree root offsets."""
    nodes_i32: np.ndarray    # [N] int32 packed words
    nodes_f32: np.ndarray    # [N] float32 threshold-or-leaf-value
    roots: np.ndarray        # [K*T] int32 tree start indices
    n_class: int             # K (class-tree groups; 1 for binomial/reg)
    ntrees: int              # T per group
    depth: int               # max depth (traversal step count)
    nfeatures: int           # design-matrix width F

    @property
    def n_nodes(self) -> int:
        return int(self.nodes_i32.shape[0])

    def nbytes(self) -> int:
        return int(self.nodes_i32.nbytes + self.nodes_f32.nbytes
                   + self.roots.nbytes)


def pack_group(arrays: Dict[str, np.ndarray], depth: int, prefix: str = "",
               base: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack one class group of heap-layout trees into node planes.

    ``arrays`` holds the mojo export layout: ``{prefix}feat_d`` /
    ``thr_d`` / ``na_left_d`` / ``valid_d`` as ``[T, 2^d]`` plus
    ``{prefix}values`` as ``[T, 2^depth]``.  A heap slot exists iff its
    parent chain is valid; an existing slot is internal iff ``valid``,
    else it is a leaf whose value sits at ``values[i << (depth - d)]``
    (the all-left heap descendant — exactly where the level-walk
    scorer lands).  Returns ``(nodes_i32, nodes_f32, roots)`` with node
    indices offset by ``base`` (for multi-group concatenation).
    """
    values = np.asarray(arrays[f"{prefix}values"], dtype=np.float32)
    T = values.shape[0]
    exist = [np.ones((T, 1), dtype=bool)]
    valid = []
    for d in range(depth):
        v = np.asarray(arrays[f"{prefix}valid_{d}"], dtype=bool)
        internal = exist[d] & v
        nxt = np.zeros((T, 2 ** (d + 1)), dtype=bool)
        nxt[:, 0::2] = internal
        nxt[:, 1::2] = internal
        valid.append(v)
        exist.append(nxt)

    counts = np.stack([e.sum(axis=1) for e in exist])        # [depth+1, T]
    level_off = np.zeros_like(counts)
    if depth:
        level_off[1:] = np.cumsum(counts[:-1], axis=0)
    tree_size = counts.sum(axis=0).astype(np.int64)          # [T]
    tree_base = np.zeros(T, dtype=np.int64)
    tree_base[1:] = np.cumsum(tree_size)[:-1]
    tree_base += base

    # absolute node index per existing heap slot, level by level
    idx = []
    for d in range(depth + 1):
        rank = np.cumsum(exist[d], axis=1) - 1
        idx.append(tree_base[:, None] + level_off[d][:, None] + rank)

    total = int(tree_size.sum())
    i32 = np.zeros(total, dtype=np.int32)
    f32 = np.zeros(total, dtype=np.float32)
    leaf_word = np.int32(1 << LEAF_BIT)
    for d in range(depth + 1):
        e, ix = exist[d], idx[d]
        if d < depth:
            internal = e & valid[d]
            leaf = e & ~valid[d]
            if internal.any():
                feat = np.asarray(arrays[f"{prefix}feat_{d}"],
                                  dtype=np.int64)
                thr = np.asarray(arrays[f"{prefix}thr_{d}"],
                                 dtype=np.float32)
                nal = np.asarray(arrays[f"{prefix}na_left_{d}"], dtype=bool)
                if (feat[internal] < 0).any() or \
                        (feat[internal] >= MAX_FEATURES).any():
                    raise ValueError(
                        f"packed layout holds feature ids < {MAX_FEATURES}")
                delta = idx[d + 1][:, 0::2] - ix
                if (delta[internal] > DELTA_MASK).any():
                    raise ValueError("left-child delta overflows 20 bits "
                                     f"(depth {depth} tree too large)")
                word = (feat & FEAT_MASK) \
                    | (nal.astype(np.int64) << NA_LEFT_BIT) \
                    | (delta << DELTA_SHIFT)
                sel = ix[internal] - base
                i32[sel] = (word[internal] & 0xFFFFFFFF).astype(
                    np.uint32).view(np.int32)
                f32[sel] = thr[internal]
        else:
            leaf = e
        if leaf.any():
            # leaf value = where the heap level-walk bottoms out
            col = np.arange(e.shape[1], dtype=np.int64) << (depth - d)
            lv = values[:, col]                              # [T, 2^d]
            sel = ix[leaf] - base
            i32[sel] = leaf_word
            f32[sel] = lv[leaf]
    return i32, f32, tree_base.astype(np.int32)


def pack_ensemble(meta: dict, arrays: Dict[str, np.ndarray],
                  nfeatures: int) -> PackedEnsemble:
    """Pack a tree/isolation export (mojo ``_extract`` output) whole.

    Multinomial groups (``k{k}_`` prefixes) concatenate k-major so the
    scored ``[B, K*T]`` leaf matrix reshapes to ``[B, K, T]``.
    """
    if nfeatures >= MAX_FEATURES:
        raise ValueError(f"packed layout supports < {MAX_FEATURES} "
                         f"features, got {nfeatures}")
    K = int(meta.get("nclass_trees", 1) or 1)
    depth = int(meta["depth"])
    prefixes = [f"k{k}_" for k in range(K)] if K > 1 else [""]
    i32s, f32s, roots = [], [], []
    base = 0
    for p in prefixes:
        gi, gf, gr = pack_group(arrays, depth, prefix=p, base=base)
        i32s.append(gi)
        f32s.append(gf)
        roots.append(gr)
        base += gi.shape[0]
    return PackedEnsemble(
        nodes_i32=np.concatenate(i32s), nodes_f32=np.concatenate(f32s),
        roots=np.concatenate(roots), n_class=K,
        ntrees=int(meta["ntrees"]), depth=depth, nfeatures=nfeatures)


def traverse(nodes_i32: np.ndarray, nodes_f32: np.ndarray,
             roots: np.ndarray, X: np.ndarray, depth: int) -> np.ndarray:
    """Iterative packed descent — the numpy "ref" oracle.

    ``X`` is the raw f32 design matrix (cat codes, NaN missing).
    Returns the ``[n, R]`` leaf-value matrix (R = len(roots)).  Early
    exit: node-sparse deep trees bottom out levels before
    ``depth``, so once every (row, tree) sits on a leaf the remaining
    steps are identity self-loops and the walk stops.
    """
    n = X.shape[0]
    node = np.broadcast_to(roots.astype(np.int64)[None, :],
                           (n, roots.shape[0])).copy()
    for _ in range(depth):
        w = nodes_i32[node]
        leaf = (w >> LEAF_BIT) & 1
        if leaf.all():
            break
        feat = (w & FEAT_MASK).astype(np.int64)
        nal = (w >> NA_LEFT_BIT) & 1
        delta = ((w >> DELTA_SHIFT) & DELTA_MASK).astype(np.int64)
        thr = nodes_f32[node]
        x = np.take_along_axis(X, feat, axis=1)
        right = np.where(np.isnan(x), nal == 0, x >= thr)
        node += np.where(leaf == 1, 0, delta + right.astype(np.int64))
    return nodes_f32[node]
