"""Models: the training contract, the tree family and the grid search."""

from .grid import Grid, GridSearch

__all__ = ["Grid", "GridSearch"]
