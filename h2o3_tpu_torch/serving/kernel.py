"""Packed-ensemble traversal on the device — the online scoring program.

``PackedScorer`` uploads the bitpacked ensemble (serving/pack.py layout)
once and scores a ``[B, F]`` request batch in one traversal launch:
every (row, tree) node pointer descends ``depth`` steps through the
node planes, then the ``[B, K, T]`` class sum, the link and the softmax
run as plain torch on the same device.

``traverse`` dispatches on the device of its tensors:

* a CUDA tensor launches the hand-written kernel ``csrc/traverse.cu``
  (the port of the JAX package's Pallas ``_make_pallas_traverse``), and
  raises if it cannot be built or launched.  It reads each node as one
  8-byte record, pack.py's two planes side by side (``interleave``);
  ``PackedScorer`` builds that plane once at publish;
* a CPU tensor runs ``traverse_torch``, the plain torch version of the
  same descent (the port of ``_traverse_xla``), on the record plane's
  two columns (``planes``).

``PackedScorer.score(..., score_mode=...)``: ``"packed"`` runs the
device program, ``"ref"`` the numpy ``ScoringModel`` walk, ``"check"``
runs both and raises on divergence.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import native
from ..runtime.config import config
from ..runtime.device import resolve_device
from . import pack as packmod

_SCORE_MODES = ("packed", "ref", "check")

_P = ctypes.c_void_p
_I = ctypes.c_int
TRAVERSE = native.Kernel("traverse", {
    "traverse_launch": ((_P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
})


# ------------------------------------------------------------ traversal

def traverse_torch(nodes_i32: torch.Tensor, nodes_f32: torch.Tensor,
                   roots: torch.Tensor, X: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """Plain torch descent: ``[B, F]`` batch -> ``[B, R]`` leaf values."""
    B = X.shape[0]
    node = roots.long().unsqueeze(0).expand(B, -1)
    for _ in range(depth):
        w = torch.take(nodes_i32, node)
        leaf = (w >> packmod.LEAF_BIT) & 1
        feat = (w & packmod.FEAT_MASK).long()
        nal = (w >> packmod.NA_LEFT_BIT) & 1
        delta = (w >> packmod.DELTA_SHIFT) & packmod.DELTA_MASK
        thr = torch.take(nodes_f32, node)
        x = torch.gather(X, 1, feat)
        right = torch.where(torch.isnan(x), nal == 0, x >= thr)
        node = node + torch.where(leaf == 1, 0, delta + right.int())
    return torch.take(nodes_f32, node)


def interleave(nodes_i32: torch.Tensor,
               nodes_f32: torch.Tensor) -> torch.Tensor:
    """The node record plane: ``[N, 2]`` int32, word and threshold (or
    leaf value) bits side by side, one 8-byte record per node."""
    return torch.stack([nodes_i32, nodes_f32.view(torch.int32)],
                       dim=1).contiguous()


def planes(nodes: torch.Tensor):
    """The record plane's two columns as pack.py's planes (strided views,
    no copy): the words ``[N]`` int32 and the thresholds ``[N]`` f32."""
    return nodes[:, 0], nodes.view(torch.float32)[:, 1]


def _check_operands(nodes, roots, X):
    dev = X.device
    for name, t, dtype, ndim in (("nodes", nodes, torch.int32, 2),
                                 ("roots", roots, torch.int32, 1),
                                 ("X", X, torch.float32, 2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, "
                             f"got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodes.shape[1] != 2:
        raise ValueError("nodes must be the [N, 2] record plane "
                         f"(interleave), got {tuple(nodes.shape)}")
    if X.shape[1] >= packmod.MAX_FEATURES:
        raise ValueError(f"X has {X.shape[1]} features; the packed layout "
                         f"holds < {packmod.MAX_FEATURES}")


def traverse(nodes: torch.Tensor, roots: torch.Tensor, X: torch.Tensor,
             depth: int) -> torch.Tensor:
    """``[B, F]`` batch -> ``[B, R]`` leaf values, R = K*T trees, from the
    ``[N, 2]`` record plane ``interleave(nodes_i32, nodes_f32)``.

    CPU tensors take ``traverse_torch`` on the plane's two columns; CUDA
    tensors launch the kernel on the current stream (counted in
    ``TRAVERSE.launches``) or raise."""
    _check_operands(nodes, roots, X)
    if X.device.type == "cpu":
        return traverse_torch(*planes(nodes), roots, X, depth)
    if X.device.type != "cuda":
        raise ValueError(f"no traversal for device {X.device}")
    B, F = X.shape
    R = roots.shape[0]
    out = torch.empty((B, R), dtype=torch.float32, device=X.device)
    if B == 0 or R == 0:
        return out
    lib = TRAVERSE.lib()
    with torch.cuda.device(X.device):
        rc = lib.traverse_launch(
            nodes.data_ptr(), roots.data_ptr(), X.data_ptr(),
            out.data_ptr(), B, F, R, int(depth),
            torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {rc}")
    TRAVERSE.count()
    return out


# ---------------------------------------------------------- the program

def _postprocess(sums, init, family: str, n_class: int, avg: bool,
                 ntrees: int, binomial: bool, link: str, c_norm: float):
    """[B, K] per-class leaf sums -> probability/score matrix (torch).

    Mirrors ``ScoringModel._score_tree`` / ``_score_isolation``.
    """
    if family == "isolation":
        mean_len = sums[:, 0] / max(ntrees, 1)
        return torch.exp2(-mean_len / max(c_norm, 1e-9))[:, None]
    if n_class > 1:
        scores = sums + init[None, :]
        if avg:
            p = torch.clamp(scores / max(ntrees, 1), 0, 1)
            return p / p.sum(dim=1, keepdim=True).clamp_min(1e-12)
        return torch.softmax(scores, dim=1)
    s = sums[:, 0] + init[0]
    if avg:
        s = s / max(ntrees, 1)
    if binomial:
        p1 = torch.clamp(s if avg else torch.sigmoid(s), 0.0, 1.0)
        return torch.stack([1 - p1, p1], dim=1)
    return (torch.exp(s) if link == "log" else s)[:, None]


class PackedScorer:
    """Device-resident packed ensemble + its scoring program.

    Built from a numpy ``ScoringModel`` (``export.mojo.from_reference``
    or ``import_mojo``) — the scoring model stays attached as featurizer
    and as the "ref"/"check" oracle.  ``score(X)`` maps a raw f32 design
    batch to the probability matrix ``ScoringModel`` would produce;
    ``predict_rows`` adds row featurization and label decode.
    """

    def __init__(self, scoring_model, device=None):
        meta = scoring_model.meta
        if meta.get("family") not in ("tree", "isolation"):
            raise ValueError("packed serving supports tree/isolation "
                             f"ensembles, not {meta.get('family')!r}")
        self.device = resolve_device(device)
        self.ref = scoring_model
        self.meta = meta
        spec = meta["datainfo"]
        self.nfeatures = len(spec["specs"])
        self.packed = packmod.pack_ensemble(meta, scoring_model.arrays,
                                            self.nfeatures)
        w = self.packed.nodes_i32
        feats = w[((w >> packmod.LEAF_BIT) & 1) == 0] & packmod.FEAT_MASK
        if feats.size and int(feats.max()) >= self.nfeatures:
            # the kernel indexes the row by feature id unchecked
            raise ValueError(f"a split reads feature {int(feats.max())} "
                             f"of a {self.nfeatures}-feature design")
        self.family = meta["family"]
        self.n_class = self.packed.n_class
        self.ntrees = self.packed.ntrees
        self.depth = self.packed.depth
        self.avg = bool(meta.get("tree_average", False))
        self.binomial = bool(spec.get("response_domain")) \
            and self.n_class == 1 and self.family == "tree"
        self.link = meta.get("link", "identity")
        self.c_norm = float(meta.get("c_norm", 1.0))
        init = meta.get("init_score", 0.0)
        self._init = np.atleast_1d(np.asarray(init, np.float32))
        # device residency: the record plane and the roots uploaded once,
        # reused every launch
        i32, f32, roots = (torch.from_numpy(np.ascontiguousarray(a)) for a in (
            self.packed.nodes_i32, self.packed.nodes_f32, self.packed.roots))
        self._d_nodes, self._d_roots, self._d_init = (
            t.to(self.device) for t in (interleave(i32, f32), roots,
                                        torch.from_numpy(self._init)))

    # ------------------------------------------------------------ device
    def score_tensor(self, X: torch.Tensor) -> torch.Tensor:
        """``[B, F]`` f32 batch on ``self.device`` -> score matrix there:
        one traversal launch, then the class sum and the link."""
        leaves = traverse(self._d_nodes, self._d_roots, X, self.depth)
        K, T = self.n_class, self.ntrees
        sums = leaves.view(X.shape[0], K, T).sum(dim=2)
        return _postprocess(sums, self._d_init, self.family, K, self.avg,
                            T, self.binomial, self.link, self.c_norm)

    # ----------------------------------------------------------- scoring
    def _packed_scores(self, X: np.ndarray) -> np.ndarray:
        Xd = torch.from_numpy(X).to(self.device)
        return self.score_tensor(Xd).cpu().numpy()

    def _ref_scores(self, X: np.ndarray) -> np.ndarray:
        out = self.ref.score_raw(X)
        return out[:, None] if out.ndim == 1 else out

    def score(self, X: np.ndarray,
              score_mode: Optional[str] = None) -> np.ndarray:
        """Raw f32 design batch ``[B, F]`` -> probability/score matrix."""
        mode = (score_mode if score_mode is not None
                else config().serve_score_mode) or "packed"
        if mode not in _SCORE_MODES:
            raise ValueError(f"score_mode {mode!r} not in {_SCORE_MODES}")
        X = np.ascontiguousarray(X, dtype=np.float32)
        if mode == "ref":
            return self._ref_scores(X)
        out = self._packed_scores(X)
        if mode == "check":
            ref = self._ref_scores(X)
            if not np.allclose(out, ref, rtol=1e-4, atol=1e-5,
                               equal_nan=True):
                diff = float(np.nanmax(np.abs(out - ref)))
                raise AssertionError(
                    f"score_mode='check' diverged: packed vs ref "
                    f"max|diff|={diff:.3e}")
        return out

    # --------------------------------------------------------- row plane
    def featurize(self, rows) -> np.ndarray:
        """List of row dicts -> raw f32 design matrix (cat codes, NaN)."""
        cols = {}
        for s in self.meta["datainfo"]["specs"]:
            name = s["name"]
            vals = [r.get(name) for r in rows]
            cols[name] = np.asarray(
                ["" if v is None else v for v in vals]
                if any(isinstance(v, str) for v in vals)
                else [np.nan if v is None else v for v in vals])
        return self.ref._design_raw(cols, len(rows))

    def decode(self, probs: np.ndarray) -> dict:
        """Probability matrix -> the ScoringModel.predict output shape."""
        domain = self.meta["datainfo"].get("response_domain")
        if domain and self.family == "tree":
            labels = np.asarray(domain, dtype=object)[
                np.argmax(probs, axis=1)]
            if probs.shape[1] == 2:
                thr = self.meta.get("default_threshold", 0.5)
                labels = np.asarray(domain, dtype=object)[
                    (probs[:, 1] >= thr).astype(int)]
            return {"predict": labels, "probabilities": probs}
        return {"predict": probs[:, 0]}

    def predict_rows(self, rows,
                     score_mode: Optional[str] = None) -> dict:
        return self.decode(self.score(self.featurize(rows),
                                      score_mode=score_mode))
