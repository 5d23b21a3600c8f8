"""Concurrent model building — the ParallelModelBuilder analog, the port
of ``h2o3_tpu/models/parallel.py``.

Reference: ``hex/ParallelModelBuilder.java`` (bounded-pool fork of model
builds with a completer callback) and ``hex/CVModelBuilder.java:16-28``
(CV fold models built N-at-a-time).  There, parallelism wins by using
many JVM cores.  Here the builds share one card, one stream and one
interpreter: each build thread issues its work on the device's current
stream, and each member's host syncs stall the other threads' launches.
Concurrency is kept for parity with the reference, not for speed: on an
H100, two concurrent grid waves built 0.44-0.79 times the member trees/s
of the same members built one after another (``chip_smoke.py`` phase
54; PERF.md).  Every member draws from its own ``torch.Generator``, so a
member is bitwise its sequential train.

Builds run on a short-lived bounded ``ThreadPoolExecutor`` owned by the
caller: a private pool per parallel phase, so a parent build never waits
behind its own children.

Thread-safety contract: builders share no mutable per-build state (each
thunk constructs its own builder and reads frames without writing them);
the kernel wrappers' launch counts and the key store take locks.  The
whole-tree scan program (``tree_program="scan"``) captures CUDA graphs,
whose capture and sync-debug mode are process-wide: ``GridSearch`` refuses
it under ``parallelism`` > 1.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Callable, List, Optional, Sequence

# Cooperative max_runtime_secs deadline, thread-local so concurrent grids
# don't see each other's budgets.  ``map_builds`` (and the batched cohort
# trainer) arm it per worker thread; ``shared.chunk_schedule`` polls it at
# every tree-chunk fence via ``check_deadline``: an in-flight member
# therefore stops within one chunk of the budget instead of finishing its
# build.
_DEADLINE = threading.local()


class DeadlineExceeded(Exception):
    """Raised at a chunk fence once the cooperative deadline passes."""


def set_deadline(deadline: Optional[float]) -> None:
    """Arm (monotonic-clock timestamp) or clear (None) this thread's
    cooperative deadline."""
    _DEADLINE.at = deadline


def get_deadline() -> Optional[float]:
    return getattr(_DEADLINE, "at", None)


def check_deadline() -> None:
    """Raise ``DeadlineExceeded`` if this thread's deadline has passed."""
    at = getattr(_DEADLINE, "at", None)
    if at is not None and time.monotonic() > at:
        raise DeadlineExceeded(
            f"max_runtime_secs deadline passed (cooperative cancel at "
            f"chunk fence, {time.monotonic() - at:.1f}s over)")


def effective_parallelism(requested: int, n_tasks: int) -> int:
    """Resolve the ``parallelism`` parameter: 0 and 1 build one at a
    time, n > 1 at most n at a time (never more than ``n_tasks``)."""
    return max(1, min(int(requested) or 1, n_tasks))


def map_builds(thunks: Sequence[Callable[[], object]],
               parallelism: int,
               deadline: Optional[float] = None) -> List[object]:
    """Run build thunks, at most ``parallelism`` concurrently; results in
    input order.  The first raised exception propagates (after letting
    in-flight builds finish — matching reference CV semantics where a
    failed fold cancels the CV job but not mid-build siblings).

    ``deadline`` (monotonic timestamp) arms the cooperative
    max_runtime_secs cancel around each thunk: tree drivers poll it at
    chunk fences (``check_deadline``), so a slow wave stops within one
    chunk of the budget instead of overshooting by whole builds."""
    def run(t):
        prev = get_deadline()
        set_deadline(deadline)
        try:
            return t()
        finally:
            set_deadline(prev)

    if parallelism <= 1:
        return [run(t) for t in thunks]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=parallelism,
            thread_name_prefix="parallel-build") as ex:
        futures = [ex.submit(run, t) for t in thunks]
        return [f.result() for f in futures]
