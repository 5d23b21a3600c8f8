"""Runtime configuration — the ``H2O3_TPU_*`` env surface of the port.

A copy of the serving and tree-training part of
``h2o3_tpu/runtime/config.py``: one typed config read from the
environment at first use.  The env names are the
JAX package's, so one deployment's settings drive either package.  The
JAX package's ``serve_impl`` knob has no counterpart: on the port the
tensor's device picks the traversal (the CUDA kernel on a card, the
plain torch version on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional


@dataclasses.dataclass
class Config:
    # logging
    log_level: str = "INFO"
    # telemetry master switch (runtime/observability.py)
    metrics_enabled: bool = True
    # online scoring plane (serving/): micro-batch tick interval, device
    # batch capacity (one preallocated buffer — requests pad into it),
    # admission queue depth in ROWS (overflow is rejected, not queued)
    # and parity mode ("packed" | "ref" | "check")
    serve_tick_ms: float = 2.0
    serve_max_batch: int = 256
    serve_queue_depth: int = 4096
    serve_score_mode: str = "packed"
    # per-request serving deadline in ms (0 = none): a request that
    # cannot be dispatched to the device before its deadline is shed
    # instead of waiting in the queue — also during shutdown drain
    serve_deadline_ms: float = 0.0
    # tree histogram layout: "" lets training choose (the packed
    # variable-bin kernel on a CUDA device when packing saves work), and
    # "varbin" forces the packed layout on any device — the JAX package
    # reads the same knob (models/tree/shared.py varbin_kernel_engages)
    hist_impl: str = ""

    @staticmethod
    def from_env() -> "Config":
        e = os.environ.get
        return Config(
            log_level=e("H2O3_TPU_LOG_LEVEL", "INFO"),
            metrics_enabled=e("H2O3_TPU_METRICS", "1")
            not in ("0", "false", "no"),
            serve_tick_ms=float(e("H2O3_TPU_SERVE_TICK_MS", 2.0)),
            serve_max_batch=int(e("H2O3_TPU_SERVE_MAX_BATCH", 256)),
            serve_queue_depth=int(e("H2O3_TPU_SERVE_QUEUE", 4096)),
            serve_score_mode=e("H2O3_TPU_SERVE_SCORE_MODE", "packed"),
            serve_deadline_ms=float(e("H2O3_TPU_SERVE_DEADLINE_MS", 0.0)),
            hist_impl=e("H2O3_TPU_HIST_IMPL", ""),
        )


_config: Optional[Config] = None
_lock = threading.Lock()


def config() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = Config.from_env()
        return _config


def reload() -> Config:
    """Re-read the environment (tests / dynamic reconfiguration)."""
    global _config
    with _lock:
        _config = Config.from_env()
        cfg = _config
    from . import observability
    observability.apply_config(cfg)
    return cfg
