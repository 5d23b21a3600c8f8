"""File import: CSV (and SVMLight, ARFF) files -> typed Frames on the
device — the port of ``h2o3_tpu/frame/parse.py``
(water/parser/ParseDataset.java:31,60,133,688).

The hot path is the JAX package's mmap'd pipeline: the file is mapped
(never copied), cut at newline-aligned byte ranges, and the native
tokenizer (``fastcsv``, ``csrc/fastcsv.cpp``) tokenizes the ranges on a
thread pool.  As each range lands, its numeric columns are cast to
float32 on the host (so each value is bitwise what ``Vec.from_numpy``
makes) and copied to the device from a pinned staging buffer, so the
copy of early ranges hides the tokenizing of later ones.  Text columns
take a vectorised host pass (fixed-width byte gather + ``np.unique``).
Type guessing mirrors ParseSetup: numeric > time > categorical > string,
with a cardinality heuristic for cat-vs-str; categorical domains are the
sorted labels, so ``"10"`` sorts before ``"2"``.

pandas' reader and the stdlib tokenizer are the fallback engines, taken
where the native path defers as the JAX package's does (a separator of
more than one byte, an empty input, an unterminated quote, a header that
does not match the column count, a range that stopped early).  A failed
build of the tokenizer or an error inside it raises: it never turns into
the fallback silently.  pandas is imported lazily and is optional:
without it the stdlib engine parses, and time columns, which need
``pandas.to_datetime``, come out as categorical or string columns.

Not ported yet: parquet, orc and feather (pyarrow), avro, xls/xlsx, SQL
and Hive imports, persist URIs other than local paths, the lineage
records (ROADMAP Queue 1 item 8), the multi-process parse and fault
injection (item 9).
"""

from __future__ import annotations

import csv
import io
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import fastcsv
from ..runtime import dkv
from ..runtime.device import Cluster, resolve_device
from .frame import Frame
from .vec import T_CAT, T_NUM, T_STR, T_TIME, Vec

_NA = {"", "na", "n/a", "nan", "null", "none", "?", "-", "NA", "NaN", "NULL",
       "None"}

# per-stage wall seconds of the most recent native-path parse in this
# process: mmap, scan, tokenize, device copies, decode/typing, Vec build
last_parse_stats: Dict[str, float] = {}

# cat-vs-str heuristic: mostly-unique, high-cardinality text is a string
_STR_UNIQUE_RATIO = 0.95
_STR_MIN_CARD = 100
_GATHER_MAX_WIDTH = 512          # cells wider than this take the slow loop


class _DeviceChunks(list):
    """Per-range float32 pieces of one numeric column already on the
    device, in row order; concatenated there at Vec assembly."""


class _Factored:
    """A text column as its distinct cells and each row's index into
    them: the type guesser works per distinct cell, not per row
    (``_factored_to_vec``).  ``raw`` holds one of the column's own values
    for each label (the labels themselves for decoded cells), for the
    time guess, which the JAX package runs on the values, not on their
    ``str``."""

    def __init__(self, labels: np.ndarray, inv: np.ndarray, raw=None):
        self.labels = labels                 # object or str array
        self.inv = inv                       # [rows] int64
        self.raw = labels if raw is None else raw

    def __len__(self):
        return len(self.inv)

    def materialize(self) -> np.ndarray:
        """The per-row object column."""
        return self.labels[self.inv]


def _guess_numeric(sample: Sequence[str]) -> bool:
    seen = False
    for s in sample:
        if s in _NA:
            continue
        seen = True
        try:
            float(s)
        except ValueError:
            return False
    return seen


def _parse_time_column(values: np.ndarray, counts=None):
    """An object column as datetimes -> ms since the epoch (f64), or
    None (also when pandas is not installed).  ``counts`` gives each
    value's rows when ``values`` are a column's distinct cells (each
    parses alone under ``format="mixed"``; the 90% rule counts rows)."""
    try:
        import pandas as pd
        with np.errstate(all="ignore"):
            dt = pd.to_datetime(pd.Series(values), errors="coerce",
                                format="mixed")
        ok = dt.notna().to_numpy()
        real = np.array([v not in _NA for v in values.astype(str)])
        w = np.ones(len(values)) if counts is None else counts
        if (w * real).sum() == 0 or \
                (w * (ok & real)).sum() / (w * real).sum() < 0.9:
            return None
        # robust to pandas' ns/us/ms internal resolution
        ms = dt.to_numpy().astype("datetime64[ms]").astype("int64") \
            .astype(np.float64)
        ms[~ok] = np.nan
        return ms
    except Exception:
        return None


_COUNT_SPAN = 1 << 20      # integer spans counted, not sorted


def _distinct(vals: np.ndarray, na: np.ndarray):
    """The distinct values of a numeric column's present rows, as values
    of its dtype, and each present row's index into them.  A column of
    integers over a span under ``_COUNT_SPAN`` (without -0.0) counts
    them; any other sorts the bit patterns, so that distinct bits stay
    distinct values."""
    x = vals[~na]
    if len(x):
        with np.errstate(invalid="ignore"):     # inf, NaN: not exact
            iv = x.astype(np.int64)
        lo, hi = int(iv.min()), int(iv.max())
        exact = vals.dtype.kind in "iu" or bool(
            (iv == x).all() and not np.signbit(x[iv == 0]).any())
        if exact and hi - lo < _COUNT_SPAN:
            present = np.flatnonzero(np.bincount(iv - lo))
            lut = np.zeros(hi - lo + 1, np.int64)
            lut[present] = np.arange(len(present))
            return (present + lo).astype(vals.dtype), lut[iv - lo]
    keys = x.view(np.dtype(f"i{vals.itemsize}")) if vals.dtype.kind == "f" \
        else x
    uniq = np.unique(keys)
    return uniq.view(vals.dtype), np.searchsorted(uniq, keys)


def _numeric_cat_vec(values: np.ndarray, device) -> Vec:
    """A numeric column typed categorical: the JAX package's
    ``_column_to_vec`` result (labels ``str`` of each value, NaN
    missing, the domain sorted as strings) from the distinct values
    alone, not one string per row (``str`` of a float is its shortest
    repr in its own width, so distinct values are distinct labels)."""
    vals = np.ascontiguousarray(values)
    na = np.isnan(vals) if vals.dtype.kind == "f" \
        else np.zeros(len(vals), bool)
    uniq, inv = _distinct(vals, na)
    labels = uniq.astype(str)
    order = np.argsort(labels, kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = np.full(len(vals), -1, np.int32)
    codes[~na] = rank[inv]
    return Vec.from_numpy(codes, T_CAT, domain=[str(u) for u in
                                                labels[order]],
                          device=device)


def _factored_to_vec(col: _Factored, coltype: Optional[str], device) -> Vec:
    """Type-guess a text column and build its Vec (ParseSetup): the NA
    test, the numeric guess on the first 1,000 present rows, the time
    guess (90% of the present rows), cat-vs-str and the codes, each taken
    once per distinct cell, with the JAX package's per-row results."""
    lab_u, first, back = np.unique(col.labels.astype(str), return_index=True,
                                   return_inverse=True)
    inv = back.reshape(-1)[col.inv]
    na_u = np.isin(lab_u, list(_NA))
    na = na_u[inv]
    if coltype in (None, T_NUM):
        if _guess_numeric(list(lab_u[inv[~na][:1000]])):
            num_u = np.full(len(lab_u), np.nan, dtype=np.float64)
            try:
                num_u[~na_u] = lab_u[~na_u].astype(np.float64)
                return Vec.from_numpy(num_u[inv], T_NUM, device=device)
            except ValueError:
                pass
    if coltype in (None, T_TIME):
        ms = _parse_time_column(np.asarray(col.raw, dtype=object)[first],
                                np.bincount(inv, minlength=len(lab_u)))
        if ms is not None:
            return Vec.from_numpy(ms[inv], T_TIME, device=device)
    uniq = lab_u[~na_u]                  # every label occurs in a row
    if coltype != T_CAT and (coltype == T_STR or (
            len(uniq) >= _STR_MIN_CARD and len(uniq) > _STR_UNIQUE_RATIO
            * max(int((~na).sum()), 1))):
        host = lab_u.astype(object)[inv]
        host[na] = None
        return Vec(None, T_STR, len(host), host_data=host)
    codes = np.searchsorted(uniq, lab_u).astype(np.int32)[inv]
    codes[na] = -1
    return Vec.from_numpy(codes, T_CAT, domain=[str(u) for u in uniq],
                          device=device)


def _column_to_vec(values: np.ndarray, name: str,
                   coltype: Optional[str] = None, device=None) -> Vec:
    """Type-guess one parsed column and build its Vec (ParseSetup):
    numeric, numeric typed "cat" and datetime64 arrays directly, any
    other column as its distinct cells (``_factored_to_vec``)."""
    if isinstance(values, _Factored):
        return _factored_to_vec(values, coltype, device)
    values = np.asarray(values)
    if values.dtype.kind in "ifb" and coltype in (None, T_NUM):
        return Vec.from_numpy(values.astype(np.float32), T_NUM, device=device)
    if values.dtype.kind in "if" and coltype == T_CAT:
        return _numeric_cat_vec(values, device)
    if values.dtype.kind == "M":  # datetime64 from pandas
        ms = values.astype("datetime64[ms]").astype("int64") \
            .astype(np.float64)
        ms[np.isnat(values)] = np.nan
        return Vec.from_numpy(ms, T_TIME, device=device)
    labels, first, inv = np.unique(values.astype(str), return_index=True,
                                   return_inverse=True)
    return _factored_to_vec(_Factored(labels, inv.reshape(-1),
                                      raw=values[first]), coltype, device)


def _factorize_cells(fixed: np.ndarray) -> _Factored:
    """A fixed-width ``|S w|`` cell column as its distinct cells, decoded
    and quote-unescaped once each.  Cells of up to 8 bytes are ranked as
    big-endian integers of their zero-padded bytes (the bytes' order)."""
    n, w = len(fixed), fixed.dtype.itemsize
    if w <= 8:
        pad = np.zeros((n, 8), np.uint8)
        pad[:, :w] = fixed.view(np.uint8).reshape(n, w)
        keys = pad.view(">u8").ravel().astype(np.uint64)
        uniq = np.unique(keys)
        inv = np.searchsorted(uniq, keys)
        cells = uniq.astype(">u8").view("S8")
    else:
        cells, inv = np.unique(fixed, return_inverse=True)
    labels = np.char.decode(cells, "utf-8", "replace").astype(object)
    for i in np.flatnonzero(np.char.find(cells, b'""') >= 0):
        labels[i] = labels[i].replace('""', '"')
    return _Factored(labels, inv.reshape(-1))


def _decode_text_column(body, offs: np.ndarray, j: int):
    """One column's raw cell bytes (the tokenizer's offsets) as Python
    strings, with RFC-4180 quote unescaping.  The fixed-width gather
    packs the cells into an ``|S width|`` column, factorised per distinct
    cell (``_Factored``) unless a cell ends in NUL bytes, which the S
    dtype drops: then it is decoded in one ``np.char.decode`` and the
    cells holding escaped quotes or NULs are redone one by one."""
    nrows = len(offs)
    starts = offs[:, j, 0]
    ends = offs[:, j, 1]
    width = int((ends - starts).max()) if nrows else 0
    if 0 < width <= _GATHER_MAX_WIDTH:
        fixed = fastcsv.gather_cells(body, starts, ends, width)
        lens = np.minimum(np.maximum(ends - starts, 0), width)
        if (np.char.str_len(fixed) == lens).all():
            return _factorize_cells(fixed)
        col = np.char.decode(fixed, "utf-8", "replace").astype(object)
        redo = np.char.find(fixed, b'""') >= 0
        redo |= np.char.str_len(fixed) != lens
        if redo.any():
            view = memoryview(body)
            for i in np.flatnonzero(redo):
                cell = bytes(view[starts[i]:ends[i]]).decode(errors="replace")
                col[i] = cell.replace('""', '"')
        return col
    view = memoryview(body) if not isinstance(body, bytes) else body
    col = np.empty(nrows, dtype=object)
    for i in range(nrows):
        s, e = offs[i, j]
        cell = bytes(view[s:e]).decode(errors="replace")
        col[i] = cell.replace('""', '"') if '""' in cell else cell
    return col


def _pandas_safe() -> bool:
    """pandas' reader runs on the main thread only, as in the JAX package
    (its pyarrow-backed strings crashed when first built on another
    thread there); other threads take the stdlib engine."""
    return threading.current_thread() is threading.main_thread()


def _stage_chunk(col: np.ndarray, dev: torch.device):
    """One range of one numeric column on ``dev``: cast to float32 on the
    host, then copied.  On a CUDA device the cast lands in a pinned
    buffer and the copy is asynchronous; the buffer is returned with the
    chunk and kept until the frame is assembled."""
    if dev.type != "cuda":
        return torch.from_numpy(np.asarray(col, np.float32)), None
    pinned = torch.empty(len(col), dtype=torch.float32, pin_memory=True)
    pinned.numpy()[:] = col
    return pinned.to(dev, non_blocking=True), pinned


def _parse_csv_native(path_or_buf, header, sep, col_names,
                      col_types: Optional[Dict[str, str]] = None,
                      device=None, on_range=None):
    """The native tokenizer path: the parallel mmap'd pipeline.

    Paths are mmap'd, buffers get a zero-copy uint8 view.  As each range
    lands (on the tokenizer's pool threads) its numeric columns go to the
    device (``_stage_chunk``); text-flagged columns are decoded on the
    host afterwards.  Returns (names, cols), each column a numpy array
    or ``_DeviceChunks``, or None where the input does not fit this path
    (the JAX package's deferrals)."""
    sepc = sep if sep is not None else ","
    if len(sepc) != 1:
        return None
    fastcsv.load()                      # a failed build raises here
    dev = resolve_device(device)
    col_types = col_types or {}
    stats: Dict[str, float] = {}
    t_all = time.perf_counter()
    if isinstance(path_or_buf, str):
        import mmap as _mmap
        t0 = time.perf_counter()
        with open(path_or_buf, "rb") as f:
            try:
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            except ValueError:           # empty file: the fallbacks
                return None
        view = np.frombuffer(mm, np.uint8)
        first_nl = mm.find(b"\n")
        stats["mmap_s"] = round(time.perf_counter() - t0, 4)
    else:
        data = path_or_buf if isinstance(path_or_buf, bytes) else None
        if data is None:
            data = path_or_buf.read()
            if isinstance(data, str):
                data = data.encode()
        if not len(data):
            return None
        view = np.frombuffer(data, np.uint8)
        first_nl = data.find(b"\n")
    first = bytes(view[: first_nl if first_nl >= 0 else len(view)]) \
        .decode(errors="replace")
    head_cells = [c.strip().strip('"') for c in first.split(sepc)]
    has_header = (not _guess_numeric(head_cells)) if header is None \
        else bool(header)
    body = view[first_nl + 1:] if has_header and first_nl >= 0 else view
    if not len(body):
        return None
    ncols = fastcsv.ncols_of(body, sepc)
    if not ncols:
        return None
    if col_names:                        # explicit names override a header
        names = list(col_names)
    elif has_header:
        names = head_cells
    else:
        names = [f"C{i+1}" for i in range(ncols)]
    if len(names) != ncols:
        return None

    dev_chunks: List[Optional[list]] = [
        [] if col_types.get(nm) in (None, T_NUM) else None for nm in names]
    dev_time = [0.0]
    lock = threading.Lock()

    def _on_range(row_lo, nrows, Vt, Ft):
        if on_range is not None:
            on_range(row_lo, nrows, Vt, Ft)
        t0 = time.perf_counter()
        for j in range(ncols):
            if dev_chunks[j] is None:
                continue
            if Ft[:, j].any():           # text seen: the column is host's
                dev_chunks[j] = None
                continue
            chunk, pinned = _stage_chunk(Vt[:, j], dev)
            with lock:
                if dev_chunks[j] is not None:
                    dev_chunks[j].append((row_lo, chunk, pinned))
        with lock:
            dev_time[0] += time.perf_counter() - t0

    out = fastcsv.parse_view(body, sepc, ncols=ncols, on_range=_on_range,
                             stats=stats)
    if out is None:
        return None
    vals, flags, offs, consumed = out
    if consumed != len(body):
        return None              # an unterminated quote etc.: the fallbacks
    nrows = len(vals)
    t0 = time.perf_counter()
    cols = {}
    for j, name in enumerate(names):
        chunks = dev_chunks[j]
        if chunks is not None and nrows and \
                sum(int(c.shape[0]) for _, c, _ in chunks) == nrows:
            ordered = sorted(chunks, key=lambda rc: rc[0])
            cols[name] = _DeviceChunks(c for _, c, _ in ordered)
            # the staging buffers outlive their copies: parse_csv drops
            # them after it synchronises
            cols[name].pinned = [p for _, _, p in ordered]
        elif flags[:, j].any():
            # numeric cells keep their text form for uniform type guessing
            cols[name] = _decode_text_column(body, offs, j)
        else:
            cols[name] = vals[:, j]
    stats["device_s"] = round(dev_time[0], 4)
    stats["decode_s"] = round(time.perf_counter() - t0, 4)
    stats["native_total_s"] = round(time.perf_counter() - t_all, 4)
    stats["rows"] = nrows
    stats["bytes"] = int(len(view))
    last_parse_stats.clear()
    last_parse_stats.update(stats)
    return names, cols


def _first_line_header(raw, path, sep) -> bool:
    """The first-line header guess of every engine, so the result does
    not depend on which engine ran."""
    if raw is not None:
        first = raw.split(b"\n", 1)[0].decode(errors="replace")
    else:
        with open(path, "r", errors="replace") as fh:
            first = fh.readline()
    sepc = sep if sep is not None else ","
    return not _guess_numeric([c.strip().strip('"')
                               for c in first.strip().split(sepc)])


def parse_csv(path_or_buf, destination_frame: Optional[str] = None,
              header: Optional[bool] = None, sep: Optional[str] = None,
              col_types: Optional[Dict[str, str]] = None,
              col_names: Optional[List[str]] = None, on_range=None,
              device=None) -> Frame:
    """Parse a CSV file or buffer into a Frame on ``device`` (``cuda``
    unless named): ParseDataset.parse.

    The native tokenizer parses, then, where it defers, pandas' reader
    (main thread, when installed), then the stdlib tokenizer.
    ``on_range(row_lo, nrows, vals, flags)`` fires per byte range as the
    native tokenizer lands it, on its pool threads; the other engines
    parse whole files and never fire it."""
    dev = resolve_device(device)
    col_types = col_types or {}
    last_parse_stats.clear()             # other engines leave no stale stats
    # read a stream once up front, so the native attempt cannot exhaust
    # it before another engine runs; paths are mmap'd by the native path
    source = path_or_buf
    raw: Optional[bytes] = None
    if isinstance(path_or_buf, bytes):
        raw = source = path_or_buf
    elif not isinstance(path_or_buf, str):
        raw = path_or_buf.read()
        if isinstance(raw, str):
            raw = raw.encode()
        source = raw
    names = cols = None
    parsed = _parse_csv_native(source, header, sep, col_names,
                               col_types=col_types, device=dev,
                               on_range=on_range)
    if parsed is not None:
        names, cols = parsed
    if names is None:
        use_pandas = _pandas_safe()
        if use_pandas:
            try:
                import pandas as pd
            except ImportError:
                use_pandas = False
        if use_pandas:
            eff_header = header if header is not None else \
                _first_line_header(raw, path_or_buf, sep)
            df = pd.read_csv(
                io.BytesIO(raw) if raw is not None else path_or_buf,
                sep=sep if sep is not None else ",",
                header=0 if eff_header else None,
                na_values=sorted(_NA), keep_default_na=True, engine="c",
                low_memory=False)
            if col_names:
                df.columns = col_names
            names = [str(c) for c in df.columns]
            cols = {n: df[n].to_numpy() for n in names}
        else:
            sd = io.StringIO(raw.decode(errors="replace")) \
                if raw is not None else path_or_buf
            names, cols = _parse_csv_stdlib(sd, header, sep, col_names)
    t0 = time.perf_counter()
    vecs = [_assemble_vec(cols[n], n, col_types.get(n), dev) for n in names]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)      # the frame is on the card
    if last_parse_stats:
        last_parse_stats["vec_s"] = round(time.perf_counter() - t0, 4)
        from ..runtime.observability import record
        record("parse", **last_parse_stats)
    key = destination_frame or dkv.make_key(
        os.path.basename(str(path_or_buf)) if isinstance(path_or_buf, str)
        else "frame")
    return Frame(names, vecs, key=key)


def _assemble_vec(col, name: str, coltype: Optional[str], device) -> Vec:
    """Vec from one parsed column: device chunks concatenate in place;
    host arrays go through the type guesser."""
    if isinstance(col, _DeviceChunks):
        data = torch.cat(list(col)) if len(col) > 1 else col[0]
        return _device_numeric_vec(data)
    return _column_to_vec(col, name, coltype, device)


def _parse_csv_stdlib(path_or_buf, header, sep, col_names):
    """The dependency-free tokenizer (CsvParser)."""
    if isinstance(path_or_buf, str):
        fh = open(path_or_buf, "r", newline="")
    else:
        fh = path_or_buf
    try:
        sample = fh.read(64 * 1024)
        fh.seek(0)
        try:
            dialect = csv.Sniffer().sniff(sample, delimiters=sep or ",;\t| ")
        except csv.Error:  # e.g. single-column files
            class dialect(csv.excel):
                delimiter = sep or ","
        rows = list(csv.reader(fh, dialect))
    finally:
        if isinstance(path_or_buf, str):
            fh.close()
    if not rows:
        raise ValueError("empty file")
    if header is None:
        header = not _guess_numeric(rows[0])
    if header:
        names, rows = [str(c) for c in rows[0]], rows[1:]
    else:
        names = col_names or [f"C{i+1}" for i in range(len(rows[0]))]
    cols = {n: np.array([r[i] if i < len(r) else "" for r in rows],
                        dtype=object)
            for i, n in enumerate(names)}
    return names, cols


def _local(uri: str) -> str:
    """A local path from a path or a ``file://`` URI; other schemes
    raise (their persist backends are not ported yet)."""
    scheme, sep, rest = uri.partition("://")
    if not sep:
        return uri
    if scheme == "file":
        return rest if rest.startswith("/") else "/" + rest
    raise NotImplementedError(
        f"{uri!r}: h2o3_tpu_torch imports local files only; persist URIs "
        "are not ported yet (ROADMAP Queue 1 item 8)")


def _open_decompressed(uri: str) -> io.TextIOBase:
    """Open a (possibly compressed) local file as text; compression by
    extension (gzip, zip's first entry, bz2, xz)."""
    path = _local(uri)
    raw = open(path, "rb")
    base = path.lower()
    if base.endswith(".gz"):
        import gzip
        return io.TextIOWrapper(gzip.GzipFile(fileobj=raw), newline="")
    if base.endswith(".zip"):
        import zipfile
        zf = zipfile.ZipFile(raw)
        names = [n for n in zf.namelist() if not n.endswith("/")]
        if not names:
            raise ValueError(f"{uri}: empty zip archive")
        return io.TextIOWrapper(zf.open(names[0]), newline="")
    if base.endswith(".bz2"):
        import bz2
        return io.TextIOWrapper(bz2.BZ2File(raw), newline="")
    if base.endswith(".xz"):
        import lzma
        return io.TextIOWrapper(lzma.LZMAFile(raw), newline="")
    return io.TextIOWrapper(raw, newline="")


def _expand_paths(path) -> List[str]:
    """A path, glob, directory or list of them -> the files, sorted per
    pattern (a directory lists its files)."""
    import glob as _glob
    paths = path if isinstance(path, (list, tuple)) else [path]
    out: List[str] = []
    for p in paths:
        lp = _local(p)
        pattern = os.path.join(lp, "*") if os.path.isdir(lp) else lp
        matches = sorted(m for m in _glob.glob(pattern) if os.path.isfile(m))
        if matches:
            out.extend(matches)
        elif os.path.exists(lp):
            out.append(lp)
        else:
            raise FileNotFoundError(p)
    return out


_COMPRESSED = (".gz", ".zip", ".bz2", ".xz")


def parse_files(paths: Sequence[str],
                destination_frame: Optional[str] = None,
                header: Optional[bool] = None, sep: Optional[str] = None,
                col_types: Optional[Dict[str, str]] = None,
                col_names: Optional[List[str]] = None,
                chunksize: int = 1_000_000, device=None) -> Frame:
    """Many CSV shards into one Frame (MultiFileParseTask).

    Uncompressed shards take the native pipeline of ``parse_csv``;
    compressed shards stream through pandas in ``chunksize``-row chunks
    (the stdlib tokenizer without pandas).  Numeric chunks go to the
    device as they come; text and categorical columns gather on the host,
    since their domain must be whole before codes exist (the reference's
    cluster-wide domain merge, ParseDataset.java:501-600)."""
    dev = resolve_device(device)
    col_types = col_types or {}
    try:
        import pandas as pd
    except ImportError:
        pd = None
    dev_chunks: Dict[str, list] = {}
    host_chunks: Dict[str, list] = {}
    staged: list = []           # pinned buffers, kept past the sync below
    names: Optional[List[str]] = None

    def eat(df_names, df_cols):
        nonlocal names
        if names is None:
            names = list(df_names)
            for n in names:
                dev_chunks[n] = []
                host_chunks[n] = []
        elif list(df_names) != names:
            raise ValueError(f"shard schema mismatch: {df_names} vs {names}")
        for n in names:
            raw_col = df_cols[n]
            if isinstance(raw_col, _DeviceChunks):
                staged.extend(raw_col.pinned)
                if host_chunks[n]:     # the column went host in a shard
                    host_chunks[n].extend(c.cpu().numpy() for c in raw_col)
                else:
                    dev_chunks[n].extend(raw_col)
                continue
            arr = raw_col.materialize() if isinstance(raw_col, _Factored) \
                else np.asarray(raw_col)
            if arr.dtype.kind in "if" and col_types.get(n) in (None, T_NUM) \
                    and not host_chunks[n]:
                dev_chunks[n].append(torch.from_numpy(
                    np.asarray(arr, np.float32)).to(dev))
            else:
                if dev_chunks[n]:      # late type widening: pull back
                    host_chunks[n] = [c.cpu().numpy() for c in dev_chunks[n]]
                    dev_chunks[n] = []
                host_chunks[n].append(arr)

    for uri in paths:
        if not uri.lower().endswith(_COMPRESSED):
            # pandas reads header=None as "every shard has a header":
            # mirrored, so the engine cannot change the result
            parsed = _parse_csv_native(_local(uri), header in (None, True),
                                       sep, col_names, col_types=col_types,
                                       device=dev)
            if parsed is not None:
                eat(*parsed)
                continue
        fh = _open_decompressed(uri)
        try:
            if pd is not None:
                for df in pd.read_csv(
                        fh, sep=sep if sep is not None else ",",
                        header=0 if header in (None, True) else None,
                        na_values=sorted(_NA), keep_default_na=True,
                        engine="c", chunksize=chunksize):
                    if col_names:
                        df.columns = col_names
                    eat([str(c) for c in df.columns],
                        {str(c): df[c].to_numpy() for c in df.columns})
            else:
                eat(*_parse_csv_stdlib(fh, header, sep, col_names))
        finally:
            fh.close()
    if names is None:
        raise ValueError("no data parsed")
    vecs = []
    for n in names:
        if dev_chunks[n]:
            data = torch.cat(dev_chunks[n]) if len(dev_chunks[n]) > 1 \
                else dev_chunks[n][0]
            vecs.append(_device_numeric_vec(data))
        else:
            col = np.concatenate(host_chunks[n]) if len(host_chunks[n]) > 1 \
                else host_chunks[n][0]
            vecs.append(_column_to_vec(col, n, col_types.get(n), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    key = destination_frame or dkv.make_key(
        os.path.basename(str(paths[0])) or "frame")
    return Frame(names, vecs, key=key)


def _device_numeric_vec(data: torch.Tensor) -> Vec:
    """A numeric Vec from a float32 column already on its device, padded
    with NaN to the row multiple."""
    n = int(data.shape[0])
    padded = Cluster(data.device).pad_rows(n)
    if padded > n:
        data = torch.cat([data, torch.full((padded - n,), float("nan"),
                                           dtype=torch.float32,
                                           device=data.device)])
    return Vec(data, T_NUM, n)


def parse_svmlight(path: str, destination_frame: Optional[str] = None,
                   device=None) -> Frame:
    """SVMLight sparse format -> dense Frame (SVMLightParser): lines
    ``<target> <idx>:<val> ...``, 1-based indices unless an index 0
    shows the file is 0-based."""
    dev = resolve_device(device)
    targets, rows, max_idx = [], [], 0
    fh = _open_decompressed(path)
    for line in fh:
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        targets.append(float(parts[0]))
        pairs = []
        for tok in parts[1:]:
            i, _, v = tok.partition(":")
            idx = int(i)
            pairs.append((idx, float(v)))
            max_idx = max(max_idx, idx)
        rows.append(pairs)
    fh.close()
    min_idx = min((i for pairs in rows for i, _ in pairs), default=1)
    base = 0 if min_idx == 0 else 1
    n, d = len(rows), max_idx + 1 - base
    X = np.zeros((n, d), np.float32)
    for r, pairs in enumerate(rows):
        for idx, v in pairs:
            X[r, idx - base] = v
    names = ["target"] + [f"C{j+1}" for j in range(d)]
    vecs = [Vec.from_numpy(np.asarray(targets, np.float64), T_NUM,
                           device=dev)]
    vecs += [Vec.from_numpy(X[:, j], T_NUM, device=dev) for j in range(d)]
    return Frame(names, vecs, key=destination_frame or dkv.make_key("svm"))


def parse_arff(path: str, destination_frame: Optional[str] = None,
               device=None) -> Frame:
    """ARFF -> Frame (ARFFParser): the @attribute lines decide the
    types."""
    dev = resolve_device(device)
    names, types, domains = [], [], []
    data_lines = []
    in_data = False
    fh = _open_decompressed(path)
    for line in fh:
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        low = s.lower()
        if in_data:
            data_lines.append(s)
        elif low.startswith("@attribute"):
            rest = s.split(None, 1)[1]
            if rest.startswith('"') or rest.startswith("'"):
                q = rest[0]
                name = rest[1:rest.index(q, 1)]
                spec = rest[rest.index(q, 1) + 1:].strip()
            else:
                name, _, spec = rest.partition(" ")
                spec = spec.strip()
            names.append(name)
            if spec.startswith("{"):
                types.append(T_CAT)
                domains.append([v.strip().strip("'\"")
                                for v in spec.strip("{}").split(",")])
            elif spec.lower() in ("numeric", "real", "integer"):
                types.append(T_NUM)
                domains.append(None)
            elif spec.lower().startswith("date"):
                types.append(T_TIME)
                domains.append(None)
            else:
                types.append(T_STR)
                domains.append(None)
        elif low.startswith("@data"):
            in_data = True
    fh.close()
    rows = list(csv.reader(data_lines))
    vecs = []
    for i, (n, t, dom) in enumerate(zip(names, types, domains)):
        col = np.array([r[i].strip() if i < len(r) else "" for r in rows],
                       dtype=object)
        if t == T_CAT:
            lookup = {s: k for k, s in enumerate(dom)}
            codes = np.array([lookup.get(v, -1) for v in col], np.int32)
            vecs.append(Vec.from_numpy(codes, T_CAT, domain=dom, device=dev))
        elif t == T_NUM:
            vals = np.array([np.nan if v in _NA else float(v) for v in col],
                            np.float64)
            vecs.append(Vec.from_numpy(vals, T_NUM, device=dev))
        else:
            vecs.append(_column_to_vec(col, n, t, dev))
    return Frame(names, vecs, key=destination_frame or dkv.make_key("arff"))


_NOT_PORTED_FORMATS = (".parquet", ".pq", ".orc", ".feather", ".avro",
                       ".xlsx", ".xls")


def import_file(path, destination_frame: Optional[str] = None,
                **kw) -> Frame:
    """h2o.import_file: a path, a glob, a directory or a list of paths on
    ``device`` (``cuda`` unless the keyword names another).  Compressed
    shards (gzip, zip, bz2, xz) decompress; ``.svm``/``.svmlight`` and
    ``.arff`` go to their parsers; one uncompressed file to
    ``parse_csv``, anything else to ``parse_files``.  The frame carries
    ``source_uri``."""
    paths = _expand_paths(path)
    low = paths[0].lower()
    device = kw.get("device")
    for ext, fn in ((".svm", parse_svmlight), (".svmlight", parse_svmlight),
                    (".arff", parse_arff)):
        if low.endswith(ext) or low.endswith(ext + ".gz"):
            if len(paths) > 1:
                raise ValueError(f"multi-file {ext} import not supported")
            fr = fn(paths[0], destination_frame=destination_frame,
                    device=device)
            break
    else:
        if low.endswith(_NOT_PORTED_FORMATS):
            raise NotImplementedError(
                f"{paths[0]!r}: h2o3_tpu_torch imports CSV, SVMLight and "
                "ARFF files; the columnar, avro and spreadsheet formats are "
                "not ported yet (ROADMAP Queue 1 item 8)")
        if len(paths) == 1 and not low.endswith(_COMPRESSED):
            fr = parse_csv(paths[0], destination_frame=destination_frame,
                           **kw)
        else:
            fr = parse_files(paths, destination_frame=destination_frame,
                             **kw)
    fr.source_uri = path if isinstance(path, str) else list(path)
    return fr


def export_file(frame: Frame, uri: str, header: bool = True) -> str:
    """Write a Frame as CSV to a local path (h2o.export_file): decoded
    labels, empty cells for missing values."""
    path = _local(uri)
    if path.lower().endswith((".parquet", ".pq", ".feather")):
        raise NotImplementedError(
            "columnar export needs pyarrow, which h2o3_tpu_torch does not "
            "use yet (ROADMAP Queue 1 item 8); export CSV")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    cols = [v.decoded() for v in frame.vecs]
    with open(path, "w", newline="") as out:
        wr = csv.writer(out)
        if header:
            wr.writerow(frame.names)
        for i in range(frame.nrows):
            wr.writerow(["" if (c[i] is None or (isinstance(c[i], float)
                                                 and np.isnan(c[i])))
                         else c[i] for c in cols])
    return uri


def upload_string(text: str, **kw) -> Frame:
    return parse_csv(io.StringIO(text), **kw)


def from_pandas(df, destination_frame: Optional[str] = None,
                device=None) -> Frame:
    """A Frame from a pandas DataFrame (h2o.H2OFrame(df)): numeric and
    bool -> num, datetime64 -> time, pandas categorical -> cat in its
    category order, object/string -> the parser's type guesser.  Needs
    pandas."""
    import pandas as pd
    dev = resolve_device(device)
    names, vecs = [], []
    for c in df.columns:
        s = df[c]
        name = str(c)
        if isinstance(s.dtype, pd.CategoricalDtype):
            vec = Vec.from_numpy(s.cat.codes.to_numpy(np.int32), T_CAT,
                                 domain=[str(v) for v in s.cat.categories],
                                 device=dev)
        elif s.dtype.kind in "biuf":
            vec = Vec.from_numpy(s.to_numpy(dtype=np.float64,
                                            na_value=np.nan), T_NUM,
                                 device=dev)
        elif s.dtype.kind == "M":
            vec = _column_to_vec(s.to_numpy(), name, device=dev)
        else:
            vals = np.asarray(["" if v is None or v is pd.NA else v
                               for v in s.to_numpy()], dtype=object)
            vec = _column_to_vec(vals, name, device=dev)
        names.append(name)
        vecs.append(vec)
    return Frame(names, vecs, key=destination_frame or dkv.make_key("pandas"))


def H2OFrame(python_obj, destination_frame: Optional[str] = None,
             device=None) -> Frame:
    """h2o.H2OFrame: a pandas DataFrame, a dict of columns, a list of rows
    (the first row the header if it is all strings) or a 2-D array."""
    dev = resolve_device(device)
    try:
        import pandas as pd
        if isinstance(python_obj, pd.DataFrame):
            return from_pandas(python_obj, destination_frame, device=dev)
    except ImportError:
        pass
    if isinstance(python_obj, dict):
        names, vecs = [], []
        for k, v in python_obj.items():
            arr = np.asarray(v)
            if arr.dtype == object:
                arr = np.asarray(["" if x is None else x for x in arr],
                                 dtype=object)
            names.append(str(k))
            vecs.append(_column_to_vec(arr, str(k), device=dev))
        return Frame(names, vecs,
                     key=destination_frame or dkv.make_key("pyobj"))
    arr = np.asarray(python_obj, dtype=object)
    one_d = arr.ndim == 1
    if one_d:
        arr = arr[:, None]
    # the header guess only for 2-D input: a 1-D list is pure data
    if not one_d and arr.shape[0] and \
            all(isinstance(v, str) for v in arr[0]):
        header, body = [str(v) for v in arr[0]], arr[1:]
    else:
        header, body = [f"C{j + 1}" for j in range(arr.shape[1])], arr
    names, vecs = [], []
    for j, name in enumerate(header):
        vals = np.asarray(["" if v is None else v for v in body[:, j]],
                          dtype=object)
        names.append(name)
        vecs.append(_column_to_vec(vals, name, device=dev))
    return Frame(names, vecs, key=destination_frame or dkv.make_key("pyobj"))
