"""The native CSV tokenizer: ``csrc/fastcsv.cpp`` through ctypes — the
port's copy of ``h2o3_tpu/native/__init__.py`` (numpy and ctypes only).

``fastcsv.cpp`` is host C++ (the water/parser/CsvParser fast path):
numeric cells go straight into column-major double buffers with no
per-cell Python objects; text cells are flagged with byte ranges for the
host-side categorical/string pass.  The buffer API is pointer-based, so
the same entry points tokenize ``bytes`` and zero-copy ``mmap`` views.
``parse_view`` fans newline-aligned byte ranges over a thread pool
(ctypes releases the GIL) and calls ``on_range`` as each range lands, so
the caller overlaps the device copy of early ranges with tokenizing the
later ones.

The library is built at first use with ``g++ -O3 -shared -fPIC`` (the
JAX package's flags) into ``_build/libfastcsv-<hash>.so``, the hash
taken over the source and the flags as ``native.py`` names the CUDA
libraries.  Unlike the JAX package, which answers ``None`` on any build
failure and lets the parse fall to pandas or the stdlib without a word,
a failed build raises with the compiler's output: ``load()`` returns the
library or raises.  ``parse_view`` still answers ``None`` where the input
does not fit the fast path (a buffer past 2 GiB, a range that stopped
early), and the parser then takes its fallback engines, as there.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Optional

import numpy as np

from .native import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "fastcsv.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    """The library's path: its name hashes the flags and the source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastcsv-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (PATH, $CXX): the native CSV "
                           "tokenizer of h2o3_tpu_torch cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run([cxx, *GXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE} (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)              # atomic against a concurrent build


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        pd, pu8 = ctypes.POINTER(ctypes.c_double), \
            ctypes.POINTER(ctypes.c_uint8)
        pi32, pll = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(LL)
        for fn, res, args in (
                ("fastcsv_ncols", I, [P, LL, ctypes.c_char]),
                ("fastcsv_parse_range", LL,
                 [P, LL, LL, ctypes.c_char, I, LL, LL, LL, pd, pu8, pi32,
                  pll]),
                ("fastcsv_count_lines", LL,
                 [P, LL, LL, ctypes.POINTER(I)]),
                ("fastcsv_find_newline", LL, [P, LL, LL]),
                ("fastcsv_count_quotes", LL, [P, LL, LL]),
                ("fastcsv_gather_cells", None, [P, pi32, pi32, LL, I, P])):
            f = getattr(lib, fn)
            f.restype = res
            f.argtypes = args
        _lib = lib
        return _lib


def _as_view(data) -> np.ndarray:
    """Zero-copy 1-D uint8 view over bytes / mmap / numpy input."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8 or data.ndim != 1 \
                or not data.flags.c_contiguous:
            raise ValueError("parse view must be a contiguous 1-D uint8 "
                             "array")
        return data
    return np.frombuffer(data, dtype=np.uint8)


def gather_cells(view, starts: np.ndarray, ends: np.ndarray,
                 width: int) -> np.ndarray:
    """Variable-length cells gathered into a fixed-width ``|S width|``
    column (NUL-padded), whose vectorised ``np.unique``/compare path
    replaces a per-cell Python decode loop."""
    lib = load()
    view = _as_view(view)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    ends = np.ascontiguousarray(ends, dtype=np.int32)
    n = len(starts)
    width = max(int(width), 1)
    out = np.empty(n * width, dtype=np.uint8)
    lib.fastcsv_gather_cells(
        view.ctypes.data,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, width, out.ctypes.data)
    return out.view(dtype=f"S{width}")


def ncols_of(view, sep: str = ",") -> int:
    view = _as_view(view)
    return int(load().fastcsv_ncols(view.ctypes.data, len(view),
                                    sep.encode()[0:1]))


def _range_bounds(lib, addr, n: int, threads: int, quoted: bool) -> list:
    """Newline-aligned byte cut points: even byte cuts, each aligned
    forward to the next line start.  When the buffer holds quotes, a cut
    whose quote-count prefix parity is odd sits inside a quoted field
    (the "" escape keeps parity) and merges into the previous range, so
    writer-quoted files without embedded newlines still tokenize in
    parallel."""
    bounds = [0]
    for t in range(1, threads):
        pos = int(lib.fastcsv_find_newline(addr, n * t // threads, n))
        pos = n if pos < 0 else pos + 1
        if pos > bounds[-1]:
            bounds.append(pos)
    bounds.append(n)
    if quoted and len(bounds) > 2:
        safe = [0]
        parity = 0
        for k in range(1, len(bounds) - 1):
            parity += int(lib.fastcsv_count_quotes(
                addr, bounds[k - 1], bounds[k]))
            if parity % 2 == 0:
                safe.append(bounds[k])
        safe.append(n)
        bounds = safe
    return bounds


def parse_view(view, sep: str = ",", ncols: Optional[int] = None,
               threads: Optional[int] = None,
               on_range: Optional[Callable] = None,
               stats: Optional[dict] = None):
    """Tokenize a CSV byte view natively, in parallel ranges when safe.

    ``view`` is a contiguous 1-D uint8 array over ``bytes`` or an mmap.
    ``H2O3_PARSE_THREADS`` sets the ranges (default min(16, cores)); a
    buffer shorter than ``H2O3_PARSE_RANGE_MIN`` bytes (4 MiB) takes one
    range.  ``on_range(row_lo, nrows, values_T, flags_T)`` fires as each
    range completes (completion order, on the pool's threads) with
    zero-copy row-major views of that range's rows.  A range that
    stopped early (an over-wide row mid-buffer) aborts the parse
    (``None``) and the caller takes the strict engines; the rows its
    ranges already handed out never reach a result.

    Returns (values [rows, ncols] f64 with NaN for non-numeric, flags
    [rows, ncols] uint8 text markers, offsets [rows, ncols, 2] byte
    ranges, consumed bytes), or ``None`` as above or for a buffer past
    the int32 offsets' 2 GiB."""
    lib = load()
    view = _as_view(view)
    n = len(view)
    if n > (1 << 31) - 16:               # int32 offsets: defer
        return None
    addr = view.ctypes.data
    sepc = sep.encode()[0:1]
    if ncols is None:
        ncols = int(lib.fastcsv_ncols(addr, n, sepc))
    t0 = time.perf_counter()
    has_quotes = ctypes.c_int(0)
    total_lines = int(lib.fastcsv_count_lines(addr, 0, n,
                                              ctypes.byref(has_quotes)))
    t_scan = time.perf_counter() - t0
    max_rows = max(total_lines + 2, 4)
    # np.empty: the tokenizer writes every returned row slot, and
    # zero-filling ~2.6x the input costs first-touch page time at scale
    values = np.empty(ncols * max_rows, np.float64)
    flags = np.empty(ncols * max_rows, np.uint8)
    offsets = np.empty(ncols * max_rows * 2, np.int32)
    vp = values.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    fp = flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    op = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    V = values.reshape(ncols, max_rows)
    F = flags.reshape(ncols, max_rows)
    O = offsets.reshape(ncols, max_rows, 2)

    if threads is None:
        threads = int(os.environ.get("H2O3_PARSE_THREADS", 0)) \
            or min(16, os.cpu_count() or 1)
    range_min = int(os.environ.get("H2O3_PARSE_RANGE_MIN", 1 << 22))
    t0 = time.perf_counter()
    if threads <= 1 or n < range_min:
        consumed = ctypes.c_longlong(0)
        rows = int(lib.fastcsv_parse_range(
            addr, 0, n, sepc, ncols, max_rows, 0, max_rows, vp, fp, op,
            ctypes.byref(consumed)))
        keep = [(0, rows)]
        tail = int(consumed.value)
        if on_range is not None and rows > 0:
            on_range(0, rows, V.T[:rows], F.T[:rows])
    else:
        bounds = _range_bounds(lib, addr, n, threads,
                               bool(has_quotes.value))
        ranges = [(bounds[i], bounds[i + 1])
                  for i in range(len(bounds) - 1)
                  if bounds[i + 1] > bounds[i]]
        # each range's first row: the cumulative newline counts (an
        # upper bound where blank lines leave gaps, compacted below)
        counts = [int(lib.fastcsv_count_lines(addr, a, b, None))
                  for a, b in ranges]
        counts[-1] += 0 if view[-1] == 0x0A else 1
        bases = np.concatenate([[0], np.cumsum(counts)])[:-1]

        def work(k):
            a, b = ranges[k]
            consumed = ctypes.c_longlong(0)
            got = int(lib.fastcsv_parse_range(
                addr, a, b, sepc, ncols, max_rows, int(bases[k]),
                int(bases[k]) + counts[k], vp, fp, op,
                ctypes.byref(consumed)))
            b0 = int(bases[k])
            if on_range is not None and got > 0:
                on_range(b0, got, V.T[b0:b0 + got], F.T[b0:b0 + got])
            return k, got, int(consumed.value)

        results = [None] * len(ranges)
        with concurrent.futures.ThreadPoolExecutor(len(ranges)) as ex:
            for fut in concurrent.futures.as_completed(
                    [ex.submit(work, k) for k in range(len(ranges))]):
                k, got, consumed_k = fut.result()
                results[k] = (got, consumed_k)
        keep = [(int(bases[k]), results[k][0]) for k in range(len(ranges))]
        # a range that stopped early invalidates the later row bases
        for k in range(len(ranges) - 1):
            if results[k][1] != ranges[k][1]:
                return None
        tail = results[-1][1]
    if stats is not None:
        stats["scan_s"] = round(t_scan, 4)
        stats["tokenize_s"] = round(time.perf_counter() - t0, 4)
        stats["ranges"] = len(keep)
        stats["has_quotes"] = bool(has_quotes.value)
    keep = [(b, c) for b, c in keep if c > 0]
    contiguous = all(keep[i][0] + keep[i][1] == keep[i + 1][0]
                     for i in range(len(keep) - 1))
    if keep and contiguous:
        # the common case (no blank lines): strided views, no copy
        a = keep[0][0]
        b = keep[-1][0] + keep[-1][1]
        return V.T[a:b], F.T[a:b], O.transpose(1, 0, 2)[a:b], tail
    rows_idx = np.concatenate([np.arange(b, b + c) for b, c in keep]) \
        if keep else np.zeros(0, np.int64)
    return (V.T[rows_idx], F.T[rows_idx],
            O.transpose(1, 0, 2)[rows_idx], tail)
