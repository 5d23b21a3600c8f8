"""Models: the training contract, the tree family and the grid search."""

from .grid import Grid, GridSearch
from .tree.drf import DRF

__all__ = ["DRF", "Grid", "GridSearch"]
