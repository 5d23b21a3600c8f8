"""Word2Vec — the port of ``h2o3_tpu/models/word2vec.py``
(hex/word2vec/Word2Vec.java:15): skip-gram with negative sampling.

The vocabulary, the frequent-word subsampling, the window draws and the
(centre, context) pairs are host work with the JAX package's numpy draws
in its order (``skipgram_pairs``: the draws one call at a time as the
reference makes them, the pairs laid out with numpy); the negatives are
drawn a minibatch at a time from the unigram^0.75 table.  Each minibatch
is one SGNS step on the device (``_sgns_step``): gathers of the centre,
context and negative rows, the sigmoid gradients, and the updates
accumulated into U and V by ``index_put_(..., accumulate=True)`` under
deterministic algorithms, so duplicate rows sum in a fixed order and a
second train on the card is bitwise the first.  The words column lives
on the host; ``device`` names where the embeddings train.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..runtime import dkv
from ..runtime.device import resolve_device
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters


@dataclasses.dataclass
class Word2VecParameters(Parameters):
    vec_size: int = 100
    window_size: int = 5
    min_word_freq: int = 5
    epochs: int = 5
    learn_rate: float = 0.025       # init_learning_rate
    negative_samples: int = 5
    sent_sample_rate: float = 1e-3  # frequent-word subsampling
    batch_size: int = 8192


def _accumulate(T: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """``T[idx] += vals`` with duplicate indices summed in a fixed order
    (deterministic algorithms on for the call)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        T.index_put_((idx,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was)


def _sgns_step(U, V, center, context, neg, lr):
    """One SGNS minibatch, U and V updated in place."""
    u = U[center]                                  # [B, D]
    vpos = V[context]                              # [B, D]
    vneg = V[neg]                                  # [B, k, D]
    spos = torch.sigmoid(torch.sum(u * vpos, dim=1))                 # [B]
    sneg = torch.sigmoid(torch.einsum("bd,bkd->bk", u, vneg))        # [B, k]
    gpos = (spos - 1.0)[:, None]                   # dL/d(u.vpos)
    gneg = sneg[:, :, None]                        # dL/d(u.vneg)
    du = gpos * vpos + torch.einsum("bk,bkd->bd", sneg, vneg)
    _accumulate(U, center, -lr * du)
    _accumulate(V, context, -lr * gpos * u)
    _accumulate(V, neg.reshape(-1),
                (-lr * gneg * u[:, None, :]).reshape(-1, U.shape[1]))


def _sentences(raw) -> List[List[str]]:
    """NA rows delimit sentences."""
    sents: List[List[str]] = []
    cur: List[str] = []
    for wd in raw:
        if wd is None or (isinstance(wd, float) and np.isnan(wd)):
            if cur:
                sents.append(cur)
            cur = []
        else:
            cur.append(str(wd))
    if cur:
        sents.append(cur)
    return sents


def skipgram_pairs(sents, vocab, keep_p, window_size: int,
                   rng: np.random.Generator):
    """(centres, contexts) int32 of the skip-gram pairs, in the JAX
    package's order and from its draws: per sentence, one ``random()``
    per in-vocabulary word (kept below its keep probability), then one
    window ``integers(1, window_size + 1)`` per kept word; the pairs of
    each kept word with its window's other words, in order."""
    ids_all: List[int] = []
    lo_all: List[int] = []
    hi_all: List[int] = []
    for s in sents:
        ids = [vocab[wd] for wd in s if wd in vocab
               and rng.random() < keep_p[vocab[wd]]]
        base = len(ids_all)
        for i in range(len(ids)):
            win = int(rng.integers(1, window_size + 1))
            lo_all.append(base + max(0, i - win))
            hi_all.append(base + min(len(ids), i + win + 1))
        ids_all += ids
    ids_np = np.asarray(ids_all, np.int64)
    lo = np.asarray(lo_all, np.int64)
    cnt = np.asarray(hi_all, np.int64) - lo - 1      # the centre itself out
    pos = np.repeat(np.arange(len(ids_np)), cnt)
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    j = np.repeat(lo, cnt) + within
    j = j + (j >= pos)                               # skip the centre
    return ids_np[pos].astype(np.int32), ids_np[j].astype(np.int32)


class Word2VecModel(Model):
    algo = "word2vec"

    def find_synonyms(self, word: str, count: int = 10) -> Dict[str, float]:
        vocab: Dict[str, int] = self.output["vocab"]
        if word not in vocab:
            return {}
        E = self.output["embeddings"]
        v = E[vocab[word]]
        sims = E @ v / (np.linalg.norm(E, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(sims)[::-1]
        words = self.output["words"]
        out = {}
        for i in order:
            if words[i] != word:
                out[words[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "none"):
        """Word -> embedding frame; 'average' pools NA-delimited sequences."""
        if aggregate_method not in ("none", "average"):
            raise ValueError(f"aggregate_method={aggregate_method!r}: "
                             "none|average")
        vocab = self.output["vocab"]
        E = self.output["embeddings"]
        col = frame.vecs[0]
        words = col.host_data if col.data is None else col.decoded()
        D = E.shape[1]
        if aggregate_method == "none":
            M = np.zeros((frame.nrows, D))
            for i, wd in enumerate(words):
                j = vocab.get(str(wd), -1)
                M[i] = E[j] if j >= 0 else np.nan
        else:
            seqs, cur = [], []
            for wd in words:
                if wd is None or (isinstance(wd, float) and np.isnan(wd)):
                    seqs.append(cur)
                    cur = []
                else:
                    cur.append(str(wd))
            seqs.append(cur)
            seqs = [s for s in seqs if s]
            M = np.zeros((len(seqs), D))
            for i, s in enumerate(seqs):
                vs = [E[vocab[wd]] for wd in s if wd in vocab]
                M[i] = np.mean(vs, axis=0) if vs else np.nan
        dev = self.output["device"]
        return Frame([f"C{i+1}" for i in range(D)],
                     [Vec.from_numpy(M[:, i], T_NUM, device=dev)
                      for i in range(D)])

    def _predict_raw(self, X):
        raise NotImplementedError("word2vec transforms, not predicts")

    def model_performance(self, frame=None):
        return self.training_metrics


class Word2Vec(ModelBuilder):
    """Word2Vec builder — H2OWord2vecEstimator analog."""

    algo = "word2vec"
    model_class = Word2VecModel
    supervised = False
    standard_metrics = False

    def __init__(self, params: Optional[Word2VecParameters] = None, **kw):
        super().__init__(params or Word2VecParameters(**kw))

    def _check_device(self, frame: Frame,
                      valid: Optional[Frame] = None) -> torch.device:
        # the words column lives on the host: only the device is resolved
        return resolve_device(self.params.device)

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if frame.ncols != 1:
            raise ValueError("word2vec expects a single words column")

    def _make_datainfo(self, frame: Frame):
        return None                      # no tabular featurization

    def _fit(self, job: Job, frame: Frame, di, valid) -> Word2VecModel:
        p: Word2VecParameters = self.params
        dev = resolve_device(p.device)
        col = frame.vecs[0]
        raw = col.host_data if col.data is None else col.decoded()
        rng = np.random.default_rng(p.effective_seed())

        sents = _sentences(raw)
        freq: Dict[str, int] = {}
        for s in sents:
            for wd in s:
                freq[wd] = freq.get(wd, 0) + 1
        words = sorted([w for w, c in freq.items() if c >= p.min_word_freq])
        vocab = {w: i for i, w in enumerate(words)}
        V = len(words)
        if V < 2:
            raise ValueError("word2vec: vocabulary too small "
                             f"(min_word_freq={p.min_word_freq})")
        counts = np.array([freq[w] for w in words], np.float64)
        total = counts.sum()
        # subsample frequent words (word2vec's t-threshold)
        keep_p = np.minimum(
            1.0, np.sqrt(p.sent_sample_rate / (counts / total))
            + p.sent_sample_rate / (counts / total))
        neg_table = counts ** 0.75
        neg_table /= neg_table.sum()

        centers, contexts = skipgram_pairs(sents, vocab, keep_p,
                                           p.window_size, rng)
        if not len(centers):
            raise ValueError("word2vec: no training pairs generated")

        D = p.vec_size
        U = torch.as_tensor(rng.uniform(-0.5 / D, 0.5 / D, (V, D))
                            .astype(np.float32), device=dev)
        Vc = torch.zeros((V, D), dtype=torch.float32, device=dev)
        B = min(p.batch_size, len(centers))
        npairs = len(centers)
        steps_per_epoch = max(npairs // B, 1)
        total_steps = int(p.epochs) * steps_per_epoch
        step_i = 0
        c_dev = torch.as_tensor(centers, dtype=torch.int64, device=dev)
        x_dev = torch.as_tensor(contexts, dtype=torch.int64, device=dev)
        for epoch in range(int(p.epochs)):
            perm = rng.permutation(npairs)
            for b in range(steps_per_epoch):
                sl = perm[b * B:(b + 1) * B]
                if len(sl) < B:
                    sl = np.concatenate([sl, perm[: B - len(sl)]])
                neg = rng.choice(V, size=(B, p.negative_samples),
                                 p=neg_table)
                lr = p.learn_rate * max(
                    1e-4, 1.0 - step_i / max(total_steps, 1))
                sl_d = torch.as_tensor(sl, device=dev)
                _sgns_step(U, Vc, c_dev[sl_d], x_dev[sl_d],
                           torch.as_tensor(neg, dtype=torch.int64,
                                           device=dev), lr)
                step_i += 1
            job.update((epoch + 1) / p.epochs, f"epoch {epoch + 1}")

        model = Word2VecModel(job.dest_key or dkv.make_key(self.algo), p, di)
        model.output.update({
            "embeddings": U.cpu().numpy().astype(np.float64),
            "vocab": vocab, "words": words, "vocab_size": V,
            "pairs_trained": npairs * int(p.epochs),
            "steps": step_i, "device": dev,
        })
        model.training_metrics = {"vocab_size": V, "pairs": npairs}
        return model
