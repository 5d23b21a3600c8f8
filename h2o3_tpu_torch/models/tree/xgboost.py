"""XGBoost-parameter-compatible booster — the port of
``h2o3_tpu/models/tree/xgboost.py`` (h2o-extensions/xgboost,
XGBoostModel.java:260-298).

The same estimator surface and split math as the JAX package: XGBoost's
defaults (depth 6, eta 0.3, lambda 1, min_child_weight 1, 256 bins), the
h2o-py alias names and objective names, and ``scale_pos_weight`` folded
into a row-weight column, on the port's GBM training loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...frame.frame import Frame
from ...frame.vec import T_CAT, T_NUM, Vec
from ..base import ModelBuilder
from .gbm import GBM, GBMModel
from .shared import (SharedTreeParameters, resolve_hist_layout,
                     resolve_hist_mode, resolve_split_mode,
                     resolve_tree_program)

# h2o-py H2OXGBoostEstimator alias -> canonical field
_ALIASES = {
    "eta": "learn_rate",
    "subsample": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "colsample_bylevel": "col_sample_rate",
    "max_bins": "nbins",
    "min_split_loss": "gamma",
    "n_estimators": "ntrees",
    "max_leaves": None,                 # accepted, depthwise growth only
    "tree_method": None,
    "grow_policy": None,
    "backend": None,
    "gpu_id": None,
}

# xgboost objective -> distribution
_OBJECTIVES = {
    "reg:squarederror": "gaussian",
    "reg:linear": "gaussian",
    "binary:logistic": "bernoulli",
    "multi:softprob": "multinomial",
    "multi:softmax": "multinomial",
    "count:poisson": "poisson",
    "reg:gamma": "gamma",
    "reg:tweedie": "tweedie",
}


@dataclasses.dataclass
class XGBoostParameters(SharedTreeParameters):
    # xgboost defaults (XGBoostModel.java createParams defaults)
    ntrees: int = 50
    max_depth: int = 6
    learn_rate: float = 0.3
    min_rows: float = 1.0
    reg_lambda: float = 1.0
    reg_alpha: float = 0.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    nbins: int = 256
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    booster: str = "gbtree"              # gbtree (dart: not ported yet)
    scale_pos_weight: float = 1.0


class XGBoostModel(GBMModel):
    algo = "xgboost"


class XGBoost(GBM):
    """XGBoost-compatible ModelBuilder — H2OXGBoostEstimator analog."""

    algo = "xgboost"
    model_class = XGBoostModel

    def __init__(self, params: Optional[XGBoostParameters] = None, **kw):
        if params is None:
            canon = {}
            for k, v in kw.items():
                if k == "objective":
                    canon["distribution"] = _OBJECTIVES.get(v, v)
                    continue
                if k in _ALIASES:
                    tgt = _ALIASES[k]
                    if tgt is not None:
                        canon[tgt] = v
                    continue
                canon[k] = v
            params = XGBoostParameters(**canon)
        if params.booster not in ("gbtree", "dart"):
            raise ValueError(
                f"booster={params.booster!r} not supported (gbtree, dart); "
                "gblinear maps to GLM in this framework")
        resolve_hist_mode(params)        # fail fast on a bad hist_mode
        resolve_split_mode(params)       # ... and on a bad split_mode
        resolve_hist_layout(params)      # ... and on a bad hist_layout
        resolve_tree_program(params)     # ... and on a bad tree_program
        ModelBuilder.__init__(self, params)

    def train(self, frame: Frame, valid: Optional[Frame] = None):
        p: XGBoostParameters = self.params
        scaled = self._apply_scale_pos_weight(frame) \
            if p.scale_pos_weight != 1.0 else None
        if scaled is None:
            return super().train(frame, valid)
        frame2, params2 = scaled
        self.params = params2
        try:
            return super().train(frame2, valid)
        finally:
            self.params = p              # stays reusable

    def _apply_scale_pos_weight(self, frame: Frame):
        """Fold scale_pos_weight into a row-weight column (binary only)."""
        p: XGBoostParameters = self.params
        rv = frame.vec(p.response_column)
        if rv.type != T_CAT or len(rv.domain or []) != 2:
            return None
        codes = rv.to_numpy()
        w = np.where(codes == 1, p.scale_pos_weight, 1.0)
        if p.weights_column:
            w = w * frame.vec(p.weights_column).to_numpy()
        names = list(frame.names) + ["_xgb_w_"]
        vecs = list(frame.vecs) + [Vec.from_numpy(w, T_NUM,
                                                  device=frame.device)]
        return (Frame(names, vecs),
                dataclasses.replace(p, weights_column="_xgb_w_"))
