"""Frames and columns on the device."""

from .frame import Frame
from .vec import T_CAT, T_NUM, Vec

__all__ = ["Frame", "Vec", "T_CAT", "T_NUM"]
