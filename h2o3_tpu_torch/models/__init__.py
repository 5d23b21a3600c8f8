"""Models: the training contract, the tree family, GLM and the grid
search."""

from .glm import GLM, GLMParameters
from .grid import Grid, GridSearch
from .tree.drf import DRF
from .tree.dt import DecisionTree
from .tree.isofor import ExtendedIsolationForest, IsolationForest
from .tree.uplift import UpliftDRF

__all__ = ["DRF", "DecisionTree", "ExtendedIsolationForest", "GLM",
           "GLMParameters", "Grid", "GridSearch", "IsolationForest",
           "UpliftDRF"]
