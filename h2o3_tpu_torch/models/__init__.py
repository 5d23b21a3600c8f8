"""Models: the training contract with its shared options
(cross-validation in ``cv``), the tree family, GLM, DeepLearning and the
grid search."""

from .deeplearning import DeepLearning, DeepLearningParameters
from .glm import GLM, GLMParameters
from .grid import Grid, GridSearch
from .tree.drf import DRF
from .tree.dt import DecisionTree
from .tree.isofor import ExtendedIsolationForest, IsolationForest
from .tree.uplift import UpliftDRF

__all__ = ["DRF", "DecisionTree", "DeepLearning", "DeepLearningParameters",
           "ExtendedIsolationForest", "GLM",
           "GLMParameters", "Grid", "GridSearch", "IsolationForest",
           "UpliftDRF"]
