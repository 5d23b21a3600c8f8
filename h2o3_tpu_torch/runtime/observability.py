"""Telemetry for the port's serving plane: a logger, an event ring and
the metric registry.

A copy of the part of ``h2o3_tpu/runtime/observability.py`` that the
serving plane calls: counters, gauges and fixed-bucket histograms keyed
by ``(name, labels)`` under the same series names, so one dashboard
reads either package.  The JAX package's trace, wire-merge and profiler
planes are not ported.
"""

from __future__ import annotations

import bisect
import collections
import logging
import threading
import time
from typing import Any, Dict, List, Tuple

from .config import config

_EVENTS = collections.deque(maxlen=2000)
_lock = threading.Lock()

# master switch (H2O3_TPU_METRICS / config().metrics_enabled):
# observe()/inc()/set_gauge() return immediately when off
_enabled = True


def enabled() -> bool:
    return _enabled


log = logging.getLogger("h2o3_tpu_torch")


def apply_config(cfg) -> None:
    """Apply config-driven telemetry state (at import and on
    config.reload)."""
    global _enabled
    log.setLevel(cfg.log_level)
    _enabled = bool(cfg.metrics_enabled)


apply_config(config())


# ------------------------------------------------------------------- events

def record(kind: str, **fields) -> None:
    """Append a timeline event."""
    with _lock:
        _EVENTS.append({"ts": time.time(), "kind": kind, **fields})


def timeline_events(limit: int = 500) -> List[Dict]:
    with _lock:
        return list(_EVENTS)[-int(limit):]


# ------------------------------------------------------------------ metrics

# log-spaced latency buckets (seconds), ~100 us .. 500 s — the JAX
# package's edges, so histograms from either package merge by summation
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(f * 10.0 ** e, 10)
    for e in range(-4, 3) for f in (1.0, 2.5, 5.0))

_LabelKey = Tuple[Tuple[str, str], ...]
_REGISTRY: "collections.OrderedDict[Tuple[str, _LabelKey], Any]" = \
    collections.OrderedDict()


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: _LabelKey):
        self.name, self.labels, self.value = name, labels, 0.0

    def inc(self, delta: float = 1.0) -> None:
        with _lock:
            self.value += delta


class Gauge:
    """Last-value gauge."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: _LabelKey):
        self.name, self.labels, self.value = name, labels, 0.0

    def set(self, value: float) -> None:
        with _lock:
            self.value = float(value)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations
    <= ``buckets[i]``; the final slot is the +Inf overflow."""
    __slots__ = ("name", "labels", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, labels: _LabelKey,
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        self.name, self.labels = name, labels
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with _lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


def _series(cls, name: str, labels: Dict[str, Any], **kw):
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    with _lock:
        m = _REGISTRY.get(key)
    if m is None:
        m = cls(name, key[1], **kw)
        with _lock:
            m = _REGISTRY.setdefault(key, m)
    return m


def counter(name: str, **labels) -> Counter:
    return _series(Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _series(Gauge, name, labels)


def histogram(name: str, buckets: Tuple[float, ...] = LATENCY_BUCKETS,
              **labels) -> Histogram:
    return _series(Histogram, name, labels, buckets=buckets)


def inc(name: str, delta: float = 1.0, **labels) -> None:
    if _enabled:
        counter(name, **labels).inc(delta)


def set_gauge(name: str, value: float, **labels) -> None:
    if _enabled:
        gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one latency/size observation into a labeled histogram."""
    if _enabled:
        histogram(name, **labels).observe(value)
