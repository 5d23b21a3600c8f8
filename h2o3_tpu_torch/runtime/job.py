"""Jobs — the blocking-run part of ``h2o3_tpu/runtime/job.py``.

Every training run is a ``Job`` in the store with status, progress and
timing (water/Job.java:24).  The port runs jobs inline only: no thread,
no scheduler queue, no journal.
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable, Optional

from . import dkv

CREATED = "CREATED"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"


class Job:
    """A tracked unit of work — analog of water.Job."""

    def __init__(self, description: str, dest_key: Optional[str] = None):
        self.key = dkv.make_key("job")
        self.description = description
        self.dest_key = dest_key
        self.status = CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.exception: Optional[BaseException] = None
        self.traceback = ""
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.result: Any = None
        dkv.put(self.key, self)

    def run(self, fn: Callable[["Job"], Any]) -> Any:
        """Run ``fn(self)`` inline, tracking status and exceptions."""
        self.status = RUNNING
        self.start_time = time.time()
        try:
            self.result = fn(self)
            self.status = DONE
            self.progress = 1.0
            return self.result
        except BaseException as e:
            self.status = FAILED
            self.exception = e
            self.traceback = traceback.format_exc()
            raise
        finally:
            self.end_time = time.time()

    def update(self, progress: float, msg: str = "") -> None:
        self.progress = float(progress)
        self.progress_msg = msg