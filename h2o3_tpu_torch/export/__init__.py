"""Portable model artifacts + standalone scoring (h2o-genmodel analog)."""

from .mojo import from_reference, import_mojo
from .scoring import ScoringModel

__all__ = ["ScoringModel", "from_reference", "import_mojo"]
