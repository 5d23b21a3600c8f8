"""Models: the training contract with its shared options
(cross-validation in ``cv``), the GBM distributions (``distributions``:
the JAX package's ten families and a custom one), the tree family, GLM,
DeepLearning and the grid search."""

from .deeplearning import DeepLearning, DeepLearningParameters
from .distributions import CustomDistribution, make_distribution
from .glm import GLM, GLMParameters
from .grid import Grid, GridSearch
from .tree.drf import DRF
from .tree.dt import DecisionTree
from .tree.gbm import GBM, GBMParameters
from .tree.isofor import ExtendedIsolationForest, IsolationForest
from .tree.uplift import UpliftDRF
from .tree.xgboost import XGBoost, XGBoostParameters

__all__ = ["CustomDistribution", "DRF", "DecisionTree", "DeepLearning",
           "DeepLearningParameters", "ExtendedIsolationForest", "GBM",
           "GBMParameters", "GLM", "GLMParameters", "Grid", "GridSearch",
           "IsolationForest", "UpliftDRF", "XGBoost", "XGBoostParameters",
           "make_distribution"]
