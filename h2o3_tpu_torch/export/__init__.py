"""Portable model artifacts + standalone scoring (h2o-genmodel analog)."""

from .mojo import export_mojo, from_reference, import_mojo
from .scoring import ScoringModel

__all__ = ["ScoringModel", "export_mojo", "from_reference", "import_mojo"]
