"""Frames and columns on the device, and the file import (``parse``)."""

from .frame import Frame
from .vec import T_BAD, T_CAT, T_NUM, T_STR, T_TIME, T_UUID, Vec

__all__ = ["Frame", "Vec", "T_BAD", "T_CAT", "T_NUM", "T_STR", "T_TIME",
           "T_UUID"]
