"""Continuous micro-batching + the published-model registry.

Requests land in an admission queue; a ticker thread drains up to
``serve_max_batch`` rows per tick into one preallocated ``[max_batch,
F]`` buffer (short batches pad), and scores it with ONE traversal
launch: on a CUDA device the rows are written into a pinned host
buffer, copied to the device buffer (one H2D copy), scored, and the
result comes back in one D2H copy.  Slices of the result go back to
the waiting callers.  Knobs ride ``H2O3_TPU_SERVE_*`` (runtime/config):
tick interval, batch capacity, queue depth, deadline.

Metric series (runtime/observability registry, the JAX package's
names): ``serve_batch_size`` (rows per launch), ``serve_queue_depth``
(rows waiting at drain), ``serve_latency_seconds{phase=queue|device|
total}``, ``serve_rejected_total{reason=queue_full|deadline}`` and
``serve_published_models``.

``publish(key, model)`` packs a model (a port ``ScoringModel`` or the
path of an archive), uploads it to the device, starts its batcher and
warms it so the first real request pays no build.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..runtime import observability as obs
from ..runtime.config import config

_BATCH_BUCKETS = (1., 2., 4., 8., 16., 32., 64., 128., 256., 512., 1024.)


class DeadlineExceeded(RuntimeError):
    """A request waited in the serving queue past its per-request
    deadline (``H2O3_TPU_SERVE_DEADLINE_MS``) and was shed, so clients
    retry elsewhere instead of hanging behind a backed-up device."""


class _Pending:
    __slots__ = ("X", "out", "error", "event", "t_enqueue")

    def __init__(self, X: np.ndarray):
        self.X = X
        self.out: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.t_enqueue = time.perf_counter()


class MicroBatcher:
    """Continuous micro-batcher in front of one ``PackedScorer``.

    ``launches`` counts the scoring calls it made (warm-up included):
    each is one traversal launch on the scorer's device.
    """

    def __init__(self, scorer, max_batch: Optional[int] = None,
                 tick_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        cfg = config()
        self.scorer = scorer
        self.max_batch = int(max_batch or cfg.serve_max_batch)
        self.tick_s = float(tick_ms if tick_ms is not None
                            else cfg.serve_tick_ms) / 1000.0
        self.queue_depth = int(queue_depth or cfg.serve_queue_depth)
        # per-request queue deadline (0 = none): expired requests are
        # shed at drain time and during close(), never dispatched
        self.deadline_s = float(deadline_ms if deadline_ms is not None
                                else cfg.serve_deadline_ms) / 1000.0
        self.launches = 0
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._host, self._dbuf = self._buffers()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # ---------------------------------------------------------- callers
    def submit(self, X: np.ndarray,
               score_mode: Optional[str] = None) -> np.ndarray:
        """Score a raw f32 design matrix; blocks until the demuxed
        result is ready.  Requests wider than the device buffer score
        in max_batch-row chunks through the same queue."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        if score_mode not in (None, "", "packed"):
            # parity modes bypass the shared buffer: they are a
            # debugging surface, not the hot path
            return self.scorer.score(X, score_mode=score_mode)
        chunks = [X[i:i + self.max_batch]
                  for i in range(0, X.shape[0], self.max_batch)] or [X]
        pending = []
        with self._cv:
            if self._closed:
                raise RuntimeError("serving batcher is shut down")
            if self._queued_rows + X.shape[0] > self.queue_depth:
                obs.inc("serve_rejected_total", reason="queue_full")
                raise RuntimeError(
                    f"serving queue full ({self._queued_rows} rows "
                    f"waiting, depth {self.queue_depth})")
            for c in chunks:
                p = _Pending(c)
                self._queue.append(p)
                pending.append(p)
            self._queued_rows += X.shape[0]
            self._cv.notify()
        outs = []
        for p in pending:
            p.event.wait()
            if p.error is not None:
                raise p.error
            outs.append(p.out)
            obs.observe("serve_latency_seconds",
                        time.perf_counter() - p.t_enqueue, phase="total")
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def warmup(self) -> float:
        """Build the kernel + launch the full-buffer shape; returns
        seconds."""
        t0 = time.perf_counter()
        dummy = np.zeros((self.max_batch, self.scorer.nfeatures),
                         dtype=np.float32)
        self.scorer.score(dummy)
        with self._lock:
            self.launches += 1
        return time.perf_counter() - t0

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=2.0)
        with self._cv:
            leftovers = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
        # shutdown drain: requests already past their deadline shed,
        # the rest error as a shutdown — nothing hangs
        now = time.perf_counter()
        for p in leftovers:
            if self.deadline_s > 0 and now - p.t_enqueue > self.deadline_s:
                self._expire(p, now)
            else:
                p.error = RuntimeError("serving batcher shut down")
                p.event.set()

    # ----------------------------------------------------------- ticker
    def _expire(self, p: "_Pending", now: float) -> None:
        obs.inc("serve_rejected_total", reason="deadline")
        p.error = DeadlineExceeded(
            f"request waited {(now - p.t_enqueue) * 1e3:.0f}ms in the "
            f"serving queue, past its {self.deadline_s * 1e3:.0f}ms "
            f"deadline")
        p.event.set()

    def _drain_locked(self):
        batch, rows = [], 0
        now = time.perf_counter()
        while self._queue and rows + self._queue[0].X.shape[0] \
                <= self.max_batch:
            p = self._queue.popleft()
            self._queued_rows -= p.X.shape[0]
            if self.deadline_s > 0 \
                    and now - p.t_enqueue > self.deadline_s:
                self._expire(p, now)     # shed, don't dispatch
                continue
            rows += p.X.shape[0]
            batch.append(p)
        return batch, rows

    def _buffers(self):
        """The host buffer the ticker fills and the device buffer the
        kernel reads: one tensor on the CPU, pinned host + device
        buffers on CUDA (one H2D copy per tick)."""
        dev = self.scorer.device
        shape = (self.max_batch, self.scorer.nfeatures)
        if dev.type == "cpu":
            host = torch.zeros(shape, dtype=torch.float32)
            return host, host
        host = torch.zeros(shape, dtype=torch.float32, pin_memory=True)
        return host, torch.empty(shape, dtype=torch.float32, device=dev)

    def _run(self):
        host, dbuf = self._host, self._dbuf
        buf = host.numpy()
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                # continuous batching: the tick window lets co-arriving
                # requests coalesce into one launch
                deadline = self._queue[0].t_enqueue + self.tick_s
            delay = deadline - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            with self._cv:
                batch, rows = self._drain_locked()
                obs.set_gauge("serve_queue_depth", self._queued_rows)
            if not batch:
                continue
            if obs.enabled():
                obs.histogram("serve_batch_size",
                              buckets=_BATCH_BUCKETS).observe(rows)
            t_launch = time.perf_counter()
            for p in batch:
                obs.observe("serve_latency_seconds",
                            t_launch - p.t_enqueue, phase="queue")
            buf[:] = 0.0
            off = 0
            for p in batch:
                buf[off:off + p.X.shape[0]] = p.X
                off += p.X.shape[0]
            try:
                if dbuf is not host:
                    # the D2H copy below waits for this copy on the same
                    # stream, so the host buffer is free at the next tick
                    dbuf.copy_(host, non_blocking=True)
                out = self.scorer.score_tensor(dbuf).cpu().numpy()
                with self._lock:
                    self.launches += 1
            except Exception as e:       # noqa: BLE001 — demux the error
                obs.log.exception("serving: scoring launch failed")
                for p in batch:
                    p.error = e
                    p.event.set()
                continue
            obs.observe("serve_latency_seconds",
                        time.perf_counter() - t_launch, phase="device")
            off = 0
            for p in batch:
                p.out = out[off:off + p.X.shape[0]]
                off += p.X.shape[0]
                p.event.set()


# ----------------------------------------------------------- publishing

class ServingEntry:
    """One published model: packed scorer + its micro-batcher."""

    def __init__(self, key: str, scorer, batcher: MicroBatcher,
                 warmup_s: float):
        self.key = key
        self.scorer = scorer
        self.batcher = batcher
        self.warmup_s = warmup_s

    def predict_rows(self, rows, score_mode: Optional[str] = None) -> dict:
        X = self.scorer.featurize(rows)
        probs = self.batcher.submit(X, score_mode=score_mode)
        return self.scorer.decode(np.asarray(probs))


_registry: Dict[str, ServingEntry] = {}
_registry_lock = threading.Lock()


def publish(key: str, model, warm: bool = True,
            device=None) -> ServingEntry:
    """Pack + upload + batch + warm one model for realtime scoring
    (idempotent: a key already published returns its entry).

    ``model`` is a port ``ScoringModel`` (``export.mojo.from_reference``
    or ``import_mojo``), a tree model trained by the port (carried over
    through its ``to_archive()``), or the path of an archive.  ``device``
    defaults to ``cuda``.
    """
    with _registry_lock:
        ent = _registry.get(key)
    if ent is not None:
        return ent
    from ..export.mojo import import_mojo
    from .kernel import PackedScorer
    if isinstance(model, (str, os.PathLike)):
        model = import_mojo(os.fspath(model))
    elif hasattr(model, "to_archive"):
        from ..export.mojo import from_reference
        model = from_reference(*model.to_archive())
    scorer = PackedScorer(model, device=device)
    batcher = MicroBatcher(scorer)
    warmup_s = batcher.warmup() if warm else 0.0
    ent = ServingEntry(key, scorer, batcher, warmup_s)
    with _registry_lock:
        ent = _registry.setdefault(key, ent)
        n = len(_registry)
    if ent.batcher is not batcher:       # lost the publish race
        batcher.close()
        return ent
    obs.set_gauge("serve_published_models", n)
    obs.record("serve_publish", model=key, device=str(scorer.device),
               warmup_s=warmup_s)
    return ent


def ensure_published(key: str) -> ServingEntry:
    """The entry published under ``key``.  The port has no model store
    to publish from on first traffic, so an unknown key raises."""
    with _registry_lock:
        ent = _registry.get(key)
    if ent is None:
        raise KeyError(f"no published model {key!r}")
    return ent


def unpublish(key: str) -> bool:
    with _registry_lock:
        ent = _registry.pop(key, None)
        n = len(_registry)
    if ent is None:
        return False
    ent.batcher.close()
    obs.set_gauge("serve_published_models", n)
    obs.record("serve_unpublish", model=key)
    return True


def shutdown_all():
    """Drain-and-stop every published batcher (process shutdown)."""
    with _registry_lock:
        entries = list(_registry.values())
        _registry.clear()
    for ent in entries:
        ent.batcher.close()
    obs.set_gauge("serve_published_models", 0)
