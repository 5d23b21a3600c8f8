"""String munging ops — the water/rapids/ast/prims/string Ast* analogs,
the port of ``h2o3_tpu/rapids/strings.py``.

toupper/tolower/trim/substring/replace (sub/gsub)/split/nchar work on
string AND categorical columns: a categorical column transforms its
DOMAIN only (the reference's trick: O(cardinality), codes untouched), a
string column maps its host payload.  A result that needs a device (the
codes of a categorical, the lengths of ``nchar``) lies on the input
column's device; ``nchar`` and ``countmatches`` of a host-only string
column put their numbers on ``device`` (``cuda`` unless named).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..frame.frame import Frame
from ..frame.vec import T_CAT, T_STR, Vec
from ..runtime.device import resolve_device


def _out_device(vec: Vec, device=None):
    """The device of a result computed from ``vec``."""
    return vec.device if vec.device is not None else resolve_device(device)


def _map_vec(vec: Vec, fn) -> Vec:
    """Apply a str->str function to a cat (domain-only) or str column."""
    if vec.type == T_CAT:
        new_domain = [fn(lbl) for lbl in (vec.domain or [])]
        # transformed labels may collide (e.g. tolower): remap codes
        uniq: List[str] = []
        remap = {}
        for lbl in new_domain:
            if lbl not in remap:
                remap[lbl] = len(uniq)
                uniq.append(lbl)
        table = np.asarray([remap[lbl] for lbl in new_domain], np.int32)
        codes = vec.to_numpy()
        new_codes = np.where(codes >= 0, table[np.clip(codes, 0, None)]
                             if len(table) else -1, -1)
        return Vec.from_numpy(new_codes.astype(np.int32), T_CAT,
                              domain=uniq, device=vec.device)
    if vec.type == T_STR:
        out = np.array([None if v is None else fn(str(v))
                        for v in vec.host_data[: vec.nrows]], dtype=object)
        return Vec(None, T_STR, vec.nrows, host_data=out)
    raise TypeError(f"string op on {vec.type} column")


def toupper(vec: Vec) -> Vec:
    return _map_vec(vec, str.upper)


def tolower(vec: Vec) -> Vec:
    return _map_vec(vec, str.lower)


def trim(vec: Vec) -> Vec:
    return _map_vec(vec, str.strip)


def lstrip(vec: Vec, chars: Optional[str] = None) -> Vec:
    return _map_vec(vec, lambda s: s.lstrip(chars))


def rstrip(vec: Vec, chars: Optional[str] = None) -> Vec:
    return _map_vec(vec, lambda s: s.rstrip(chars))


def substring(vec: Vec, start: int, end: Optional[int] = None) -> Vec:
    return _map_vec(vec, lambda s: s[start:end])


def sub(vec: Vec, pattern: str, replacement: str) -> Vec:
    """Replace the FIRST regex match (AstSub)."""
    pat = re.compile(pattern)
    return _map_vec(vec, lambda s: pat.sub(replacement, s, count=1))


def gsub(vec: Vec, pattern: str, replacement: str) -> Vec:
    """Replace ALL regex matches (AstGSub)."""
    pat = re.compile(pattern)
    return _map_vec(vec, lambda s: pat.sub(replacement, s))


def nchar(vec: Vec, device=None) -> Vec:
    """Per-row string length as a numeric column (AstStrLength)."""
    if vec.type == T_CAT:
        lens = np.asarray([len(lbl) for lbl in (vec.domain or [])],
                          np.float64)
        codes = vec.to_numpy()
        out = np.where(codes >= 0, lens[np.clip(codes, 0, None)]
                       if len(lens) else np.nan, np.nan)
        return Vec.from_numpy(out, device=vec.device)
    if vec.type == T_STR:
        out = np.asarray([np.nan if v is None else float(len(str(v)))
                          for v in vec.host_data[: vec.nrows]])
        return Vec.from_numpy(out, device=_out_device(vec, device))
    raise TypeError(f"nchar on {vec.type} column")


def strsplit(vec: Vec, pattern: str) -> Frame:
    """Split each value into columns C1..Ck (AstStrSplit)."""
    pat = re.compile(pattern)
    vals = vec.decoded() if vec.type == T_CAT else vec.host_data[: vec.nrows]
    parts = [pat.split(str(v)) if v is not None else [] for v in vals]
    k = max((len(p) for p in parts), default=0)
    names, out_vecs = [], []
    for j in range(k):
        arr = np.array([p[j] if j < len(p) else None for p in parts],
                       dtype=object)
        names.append(f"C{j + 1}")
        out_vecs.append(Vec(None, T_STR, len(arr), host_data=arr))
    return Frame(names, out_vecs)


def countmatches(vec: Vec, pattern: str, device=None) -> Vec:
    """Occurrences of the regex per row (AstCountMatches)."""
    pat = re.compile(pattern)
    if vec.type == T_CAT:
        cnt = np.asarray([float(len(pat.findall(lbl)))
                          for lbl in (vec.domain or [])])
        codes = vec.to_numpy()
        out = np.where(codes >= 0, cnt[np.clip(codes, 0, None)]
                       if len(cnt) else np.nan, np.nan)
        return Vec.from_numpy(out, device=vec.device)
    out = np.asarray([np.nan if v is None else float(len(pat.findall(str(v))))
                      for v in vec.host_data[: vec.nrows]])
    return Vec.from_numpy(out, device=_out_device(vec, device))
