"""Single decision tree (DT) — the port of ``h2o3_tpu/models/tree/dt.py``
(hex/tree/dt/DT.java).

The degenerate forest: one unsampled tree over every feature at each
split (``mtries=-2``, ``sample_rate=1``), grown through DRF's level loop
(dense levels, then node-sparse ones past ``sparse_depth_threshold``) and
predicting per-leaf class frequencies or the mean response.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .drf import DRF, DRFModel, DRFParameters
from .shared import SharedTree


@dataclasses.dataclass
class DTParameters(DRFParameters):
    ntrees: int = 1
    max_depth: int = 20
    sample_rate: float = 1.0
    mtries: int = -2                     # all features at every split
    min_rows: float = 10.0


class DTModel(DRFModel):
    algo = "dt"


class DecisionTree(DRF):
    algo = "dt"
    model_class = DTModel

    def __init__(self, params: Optional[DTParameters] = None, **kw):
        SharedTree.__init__(self, params or DTParameters(**kw))
