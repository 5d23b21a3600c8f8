"""Segment models: train one model per data segment — the port of
``h2o3_tpu/models/segments.py``.

Reference: ``hex/segments/SegmentModels.java:18`` + ``SegmentModelsBuilder``
(h2o.train_segments in h2o-py): partition the frame by the segment
columns' value tuples and run the same builder spec on every partition,
collecting per-segment models and statuses.

Segments are found with the device group-by (``rapids.ops.group_by``)
and their rows move with the device filter (``ops.filter_rows``); the
segments train one after another on the frame's device.  As in the JAX
package, each segment's row mask is built on the host from the decoded
key columns (one pass over the frame per segment).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.observability import record


@dataclasses.dataclass
class SegmentResult:
    segment: dict
    model_key: Optional[str]
    status: str                  # SUCCEEDED | FAILED
    error: Optional[str] = None
    nrows: int = 0


class SegmentModels:
    """Result container — hex/segments/SegmentModels.java analog."""

    def __init__(self, key: str, results: List[SegmentResult],
                 device=None):
        self.key = key
        self.results = results
        self.device = device          # where as_frame puts its table
        dkv.put(key, self)

    def as_frame(self) -> Frame:
        cols: Dict[str, np.ndarray] = {}
        segs = [r.segment for r in self.results]
        for name in segs[0]:
            cols[name] = np.asarray([s[name] for s in segs], dtype=object)
        cols["model"] = np.asarray(
            [r.model_key or "" for r in self.results], dtype=object)
        cols["status"] = np.asarray([r.status for r in self.results],
                                    dtype=object)
        cols["errors"] = np.asarray([r.error or "" for r in self.results],
                                    dtype=object)
        return Frame.from_numpy(cols, device=self.device)

    def model(self, **segment) -> object:
        for r in self.results:
            if all(str(r.segment.get(k)) == str(v)
                   for k, v in segment.items()):
                if r.model_key is None:
                    raise KeyError(f"segment {segment} failed: {r.error}")
                return dkv.get(r.model_key)
        raise KeyError(f"no segment {segment}")


def train_segments(builder_factory: Callable[[], object], frame: Frame,
                   segment_columns: Union[str, Sequence[str]],
                   segments: Optional[Frame] = None,
                   valid: Optional[Frame] = None) -> SegmentModels:
    """h2o.train_segments analog.

    ``builder_factory`` returns a FRESH builder per segment (builders hold
    per-run state); ``segments`` optionally restricts to listed tuples.
    """
    from ..rapids import ops
    segment_columns = [segment_columns] if isinstance(segment_columns, str) \
        else list(segment_columns)
    uniq = ops.group_by(frame, segment_columns,
                        {frame.names[0]: ["count"]})
    wanted: Optional[set] = None
    if segments is not None:
        wanted = set()
        cols = [segments.vec(c).decoded() for c in segment_columns]
        for i in range(segments.nrows):
            wanted.add(tuple(str(c[i]) for c in cols))

    results: List[SegmentResult] = []
    seg_cols = [uniq.vec(c).decoded() for c in segment_columns]
    for i in range(uniq.nrows):
        seg = {c: seg_cols[j][i] for j, c in enumerate(segment_columns)}
        if wanted is not None and \
                tuple(str(v) for v in seg.values()) not in wanted:
            continue
        mask = np.ones(frame.nrows, bool)
        for c, v in seg.items():
            col = frame.vec(c).decoded()
            mask &= np.asarray([str(x) == str(v) for x in col])
        sub = ops.filter_rows(frame, mask)
        sub_valid = None
        if valid is not None:
            vmask = np.ones(valid.nrows, bool)
            for c, v in seg.items():
                col = valid.vec(c).decoded()
                vmask &= np.asarray([str(x) == str(v) for x in col])
            if vmask.any():
                sub_valid = ops.filter_rows(valid, vmask)
        try:
            b = builder_factory()
            m = b.train(sub.drop(segment_columns), sub_valid.drop(
                segment_columns) if sub_valid is not None else None)
            results.append(SegmentResult(seg, m.key, "SUCCEEDED",
                                         nrows=sub.nrows))
            record("segment_trained", segment=str(seg), model=m.key)
        except Exception as e:                          # noqa: BLE001
            results.append(SegmentResult(seg, None, "FAILED", repr(e),
                                         nrows=sub.nrows))
    return SegmentModels(dkv.make_key("segment_models"), results,
                         device=frame.device)
