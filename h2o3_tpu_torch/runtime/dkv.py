"""The local key/value store — the part of ``h2o3_tpu/runtime/dkv.py``
the training path uses.

Keys name frames, models and jobs (``Key.make()``, water/Key.java:44).
The JAX package's coordinator RPC, write-ahead log and scope tracking are
not ported: one process owns the store.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_store: Dict[str, Any] = {}
_counter = 0
_lock = threading.Lock()


def make_key(prefix: str) -> str:
    """Fresh unique key ``{prefix}_{n}``."""
    global _counter
    with _lock:
        _counter += 1
        return f"{prefix}_{_counter}"


def put(key: str, value: Any) -> str:
    with _lock:
        _store[key] = value
    return key


def get(key: str) -> Optional[Any]:
    with _lock:
        return _store.get(key)


def remove(key: str) -> None:
    with _lock:
        _store.pop(key, None)
