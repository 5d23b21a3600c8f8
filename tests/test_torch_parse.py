"""h2o3_tpu_torch's file import held against the JAX package's.

The same files, written here from ``np.random.default_rng`` seeds, go
through the JAX package's ``parse_csv`` / ``import_file`` /
``upload_string`` and the port's (``h2o3_tpu_torch.frame.parse``, on the
CPU).  Names, types and domains must be equal and every column bitwise:
float32 numerics, int32 categorical codes, a time column's float64 ms on
the host and its float32 device payload, a string column's host values.
Floats are written with 9 significant digits (``%.9g``), so each reads
back as the float32 it was.  The cases: a header present, absent (and
guessed), ``col_types`` and ``col_names``, ``sep=";"``, NA tokens and
quoted fields (escaped quotes, separators inside quotes), a
high-cardinality string column and a time column, many tiny byte ranges,
a glob, a directory, a list and gzip and zip shards, SVMLight and ARFF,
``upload_string``, an ``export_file`` round trip, the frame's row
operations, ``H2OFrame`` and object columns, and the branch without
pandas (the stdlib engine held against the native one).  A failed build of the tokenizer
and an error inside it raise instead of taking the stdlib engine.
"""

import datetime
import gzip
import io
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as Frame_j
from h2o3_tpu.frame import parse as JP

from h2o3_tpu_torch import fastcsv
from h2o3_tpu_torch import import_file, upload_string
from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.frame import parse as P

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

_CATS = ["lvl0", "lvl1", '"lvl,2"', '"say ""hi"""', "lvl4"]


def _stdlib_frame(path):
    """A CSV file through the stdlib tokenizer alone, typed as
    ``parse_csv`` types it, on the CPU."""
    names, cols = P._parse_csv_stdlib(path, None, None, None)
    return Frame(names, [P._column_to_vec(cols[n], n, device="cpu")
                         for n in names])


def _mixed_lines(seed, n=240, sep=",", header=True):
    """A CSV of six columns: f32 numerics with NA tokens, small integers,
    labels (some quoted, with a separator or escaped quotes inside), a
    timestamp, a high-cardinality string and negative numbers."""
    rng = np.random.default_rng(seed)
    na = ["NA", "", "nan", "?", "NULL"]
    lines = [sep.join(["num", "int", "cat", "when", "txt", "neg"])] \
        if header else []
    for i in range(n):
        num = "%.9g" % np.float32(rng.normal() * 100) \
            if rng.random() > 0.1 else na[i % len(na)]
        cat = _CATS[rng.integers(0, len(_CATS))] if sep == "," else \
            f"lvl{rng.integers(0, 5)}"
        when = f"2021-{rng.integers(1, 13):02d}-{rng.integers(1, 29):02d} " \
            f"{rng.integers(0, 24):02d}:{rng.integers(0, 60):02d}:00"
        lines.append(sep.join([
            num, str(rng.integers(0, 40)), cat, when,
            f"id{rng.integers(0, 10 ** 9)}",
            "%.9g" % np.float32(-abs(rng.normal()))]))
    return lines


def _numeric_lines(seed, n=200):
    rng = np.random.default_rng(seed)
    return [",".join("%.9g" % np.float32(v) for v in rng.normal(size=3))
            for _ in range(n)]


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def assert_frames_equal(jfr, tfr):
    """Names, types, domains and every column bitwise."""
    assert jfr.names == tfr.names
    assert jfr.types() == tfr.types()
    assert jfr.nrows == tfr.nrows
    for name in jfr.names:
        jv, tv = jfr.vec(name), tfr.vec(name)
        assert jv.domain == tv.domain, name
        a, b = jv.to_numpy(), tv.to_numpy()
        if jv.type in ("str", "uuid"):
            assert list(a) == list(b), name
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
        if jv.type == "time":
            assert jv.time_base == tv.time_base
            np.testing.assert_array_equal(
                np.asarray(jv.data)[: jv.nrows].view(np.int32),
                tv.data[: tv.nrows].numpy().view(np.int32), err_msg=name)


# ------------------------------------------------------------ parse_csv

_CASES = {
    "header": (dict(), dict()),
    "header_guessed_absent": (dict(numeric=True), dict()),
    "header_false_col_names": (
        dict(header=False),
        dict(header=False, col_names=["a", "b", "c", "d", "e", "f"])),
    "col_types": (dict(), dict(col_types={"int": "cat", "txt": "str",
                                          "cat": "str", "num": "num"})),
    "col_names": (dict(), dict(col_names=["a", "b", "c", "d", "e", "f"])),
    "sep_semicolon": (dict(sep=";"), dict(sep=";")),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_parse_csv_matches_jax(tmp_path, case):
    """Each case parses the same file in both packages to the same frame:
    header present or absent (guessed on an all-numeric file), explicit
    names and types, another separator; NA tokens and quoted fields
    throughout, a time and a high-cardinality string column."""
    write, kw = _CASES[case]
    if write.get("numeric"):
        lines = _numeric_lines(3)
    else:
        lines = _mixed_lines(1, sep=write.get("sep", ","),
                             header=write.get("header", True))
    path = _write(tmp_path / "f.csv", lines)
    jfr = JP.parse_csv(path, **kw)
    tfr = P.parse_csv(path, device="cpu", **kw)
    assert_frames_equal(jfr, tfr)
    if case == "header":
        assert tfr.types() == {"num": "num", "int": "num", "cat": "cat",
                               "when": "time", "txt": "str", "neg": "num"}
        assert P.last_parse_stats["rows"] == 240
        # the buffer and stream routes give the frame the path route gives
        raw = open(path, "rb").read()
        assert_frames_equal(jfr, P.parse_csv(raw, device="cpu"))
        assert_frames_equal(jfr, P.parse_csv(io.BytesIO(raw), device="cpu"))
    if case == "header_guessed_absent":
        assert tfr.names == ["C1", "C2", "C3"]


_RAW = {
    # a cell ending in NUL bytes (the S dtype drops them): the per-cell path
    "trailing_nul": b"k,v\nab\x00,1\nab,2\n\x00,3\nab,4\n",
    # cells past 8 bytes, escaped quotes, a label that unescapes into
    # another's text
    "wide_escaped": b'k,v\n"a ""quoted"" label",1\nplain-longer-label,2\n'
                    b'"a ""quoted"" label",3\nx,4\n"x",5\n',
    # numbers and text in one column: the numeric guess fails on a row
    # past the sample's first values
    "mixed_numeric": b"k,v\n" + b"".join(b"%d,%d\n" % (i, i)
                                        for i in range(1100)) + b"oops,1\n",
    # numeric text with NA tokens, typed as a number
    "numeric_text": b'k,v\n"1.5",1\nNA,2\n"-2",3\n?,4\n',
}


@pytest.mark.parametrize("case", sorted(_RAW))
def test_text_cells_match_jax(case):
    """Text columns through the tokenizer's text path (factorised per
    distinct cell, or cell by cell where a cell ends in NUL bytes): the
    JAX package's frame."""
    raw = _RAW[case]
    assert_frames_equal(JP.parse_csv(raw), P.parse_csv(raw, device="cpu"))


_NUMERIC_CATS = {
    "small_ints": np.arange(300, dtype=np.float64)[
        np.random.default_rng(3).integers(0, 300, 5000)],
    "signed_zero_nan": np.array([0.0, -0.0, 1.0, np.nan, 2.5, -0.0]),
    "wide_span": np.array([1e12, 3.0, np.nan, 1e12 + 1]),
    "infinities": np.array([np.inf, 1.0, -np.inf, np.nan]),
    "float32": np.array([0.1, 0.2, 0.1, -7.0], np.float32),
    "int64": np.array([5, 10, 2, 10], np.int64),
}


@pytest.mark.parametrize("case", sorted(_NUMERIC_CATS))
def test_numeric_column_typed_cat_matches_jax(case):
    """A numeric column typed "cat" (counted where its values are
    integers over a short span, else sorted by bit pattern): the JAX
    package's labels (the str of each value, -0.0 its own), domain order
    and codes."""
    values = _NUMERIC_CATS[case]
    jv = JP._column_to_vec(values, "x", "cat")
    tv = P._column_to_vec(values, "x", "cat", device="cpu")
    assert tv.type == jv.type == "cat" and tv.domain == jv.domain
    np.testing.assert_array_equal(tv.to_numpy(), np.asarray(jv.to_numpy()))


def test_many_tiny_ranges_match_jax_and_one_range(tmp_path, monkeypatch):
    """16 byte ranges over a small file (nearly every cut lands mid-row and
    is realigned to a line start; the quote-parity merge runs): the same
    frame as the JAX package's ranged parse and as the port's one-range
    parse."""
    path = _write(tmp_path / "f.csv", _mixed_lines(2, n=97))
    monkeypatch.setenv("H2O3_PARSE_THREADS", "16")
    monkeypatch.setenv("H2O3_PARSE_RANGE_MIN", "1")
    ranged = P.parse_csv(path, device="cpu")
    assert P.last_parse_stats["ranges"] > 1
    assert_frames_equal(JP.parse_csv(path), ranged)
    monkeypatch.setenv("H2O3_PARSE_THREADS", "1")
    single = P.parse_csv(path, device="cpu")
    assert P.last_parse_stats["ranges"] == 1
    assert_frames_equal(single, ranged)


# ------------------------------------------------------------ import_file

def _shards(tmp_path, k=3):
    d = tmp_path / "shards"
    d.mkdir()
    paths = []
    for i in range(k):
        lines = _mixed_lines(10 + i, n=60)
        paths.append(_write(d / f"part-{i}.csv", lines))
    return d, paths


@pytest.mark.parametrize("kind", ["glob", "dir", "list", "gz", "zip"])
def test_import_file_sources_match_jax(tmp_path, kind):
    """``import_file`` of a glob, a directory, a list of shards, gzip
    shards and a zip archive: the JAX package's frame."""
    d, paths = _shards(tmp_path)
    if kind == "glob":
        src = str(d / "part-*.csv")
    elif kind == "dir":
        src = str(d)
    elif kind == "list":
        src = paths
    elif kind == "gz":
        src = []
        for p in paths:
            with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
                g.write(f.read())
            src.append(p + ".gz")
    else:
        src = str(tmp_path / "one.zip")
        with zipfile.ZipFile(src, "w") as z:
            z.write(paths[0], "part-0.csv")
    tfr = import_file(src, device="cpu")
    assert_frames_equal(JP.import_file(src), tfr)
    assert tfr.source_uri == src
    assert tfr.nrows == (60 if kind == "zip" else 180)


@pytest.mark.parametrize("fmt", ["svmlight", "arff"])
def test_svmlight_and_arff_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(5)
    if fmt == "svmlight":
        lines = []
        for i in range(40):
            idx = sorted(rng.choice(np.arange(1, 9), 3, replace=False))
            lines.append(f"{i % 2} " + " ".join(
                f"{j}:{'%.9g' % np.float32(rng.normal())}" for j in idx)
                + (" # note" if i % 7 == 0 else ""))
        path = _write(tmp_path / "f.svm", lines)
    else:
        lines = ["% a comment", "@relation r", "@attribute x numeric",
                 "@attribute 'k k' {red,green,blue}", "@attribute s string",
                 "@data"]
        for i in range(40):
            x = "%.9g" % np.float32(rng.normal()) if i % 9 else "?"
            lines.append(f"{x},{['red', 'green', 'blue'][i % 3]},w{i}")
        path = _write(tmp_path / "f.arff", lines)
    assert_frames_equal(JP.import_file(path), import_file(path, device="cpu"))


# ---------------------------------------------- upload_string, export_file

def test_upload_string_and_export_round_trip(tmp_path):
    """``upload_string`` parses text as the JAX package does;
    ``export_file`` writes the same CSV bytes as the JAX package's export
    of its frame, and the port's import of it gives the frame back
    (the time column comes back as a numeric column of its ms, rounded
    to float32)."""
    text = "\n".join(_mixed_lines(4, n=50)) + "\n"
    jfr = JP.upload_string(text)
    tfr = upload_string(text, device="cpu")
    assert_frames_equal(jfr, tfr)
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert P.export_file(tfr, str(ours)) == str(ours)
    JP.export_file(jfr, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    back = import_file(str(ours), device="cpu")
    assert back.names == tfr.names
    for name in ("num", "int", "neg", "txt"):
        a, b = back.vec(name).to_numpy(), tfr.vec(name).to_numpy()
        if tfr.vec(name).type == "str":
            assert list(a) == list(b)
        else:
            np.testing.assert_array_equal(a, b)
    assert back.vec("when").type == "num"
    np.testing.assert_array_equal(
        back.vec("when").to_numpy(),
        tfr.vec("when").to_numpy().astype(np.float32))
    assert list(back.vec("cat").decoded()) == list(tfr.vec("cat").decoded())


def test_frame_row_ops_match_jax(tmp_path):
    """``split_frame`` (the same numpy draws), ``rows``, ``filter``,
    ``drop``, ``rename``, ``cbind``, ``head`` and ``summary`` against the
    JAX package on a parsed frame (its numeric, categorical and string
    columns; the JAX package's ``rows`` passes a time column's device
    seconds back in as ms, so the time column stays out)."""
    path = _write(tmp_path / "f.csv", _mixed_lines(6, n=120))
    cols = ["num", "int", "cat", "txt", "neg"]
    jfr, tfr = JP.parse_csv(path)[cols], P.parse_csv(path, device="cpu")[cols]
    for a, b in zip(jfr.split_frame([0.6, 0.3], seed=4),
                    tfr.split_frame([0.6, 0.3], seed=4)):
        assert_frames_equal(a, b)
    idx = np.array([5, 0, 119, 7, 7])
    assert_frames_equal(jfr.rows(idx), tfr.rows(idx))
    mask = np.arange(120) % 3 == 0
    assert_frames_equal(jfr.filter(mask), tfr.filter(mask))
    assert_frames_equal(jfr.drop(["txt"]).rename({"num": "x"}),
                        tfr.drop(["txt"]).rename({"num": "x"}))
    assert_frames_equal(jfr[["num"]].cbind(jfr[["neg"]]),
                        tfr[["num"]].cbind(tfr[["neg"]]))
    assert tfr.shape == (120, 5) and tfr.ncols == 5
    assert tfr.padded_rows == 120 and tfr.head(4).nrows == 4
    # the rollups: counts, min and max exact; mean and sigma are f32 sums
    # in another order (the JAX package batches its columns), to 1e-5
    js, ts = jfr.summary(), tfr.describe()
    assert js.keys() == ts.keys()
    for name in cols:
        assert js[name].keys() == ts[name].keys()
        for k, v in js[name].items():
            if k in ("mean", "sigma"):
                np.testing.assert_allclose(ts[name][k], v, rtol=1e-5)
            else:
                assert ts[name][k] == v, (name, k)


_OBJECTS = {
    "datetimes": [datetime.datetime(2020, 1, i % 28 + 1, 3)
                  for i in range(50)],
    # the time guess reads the values, not their str: ints are epoch
    # times in both packages, their labels would not be
    "ints_and_text": list(range(45)) + ["x"] * 5,
    "floats_and_text": [i + 0.5 for i in range(45)] + ["x"] * 5,
    "date_text_with_na": [f"2021-03-{i % 28 + 1:02d}" for i in range(50)]
    + ["NA"],
    "bools": [True, False] * 10,
}


@pytest.mark.parametrize("case", sorted(_OBJECTS))
def test_object_columns_match_jax(case):
    """Object columns (as ``H2OFrame`` and pandas hand them over), typed
    by the guess and by each explicit type, as the JAX package types
    them."""
    vals = np.array(_OBJECTS[case], dtype=object)
    for coltype in (None, "cat", "str", "time"):
        assert_frames_equal(
            Frame_j(["c"], [JP._column_to_vec(vals, "c", coltype)]),
            Frame(["c"], [P._column_to_vec(vals, "c", coltype,
                                           device="cpu")]))


@pytest.mark.parametrize("kind", ["dict", "rows"])
def test_h2oframe_matches_jax(kind):
    rng = np.random.default_rng(9)
    x = rng.normal(size=30).astype(np.float32)
    lab = np.array(["a", "b", None, "c", "10", "2"], dtype=object)[
        rng.integers(0, 6, 30)]
    if kind == "dict":
        obj = {"x": x, "lab": lab}
    else:
        obj = [["x", "lab"]] + [[float(a), b] for a, b in zip(x, lab)]
    assert_frames_equal(JP.H2OFrame(obj), P.H2OFrame(obj, device="cpu"))


# ---------------------------------------------------------- without pandas

def test_no_pandas_branch(tmp_path, monkeypatch):
    """With pandas not importable: the time column falls to the string
    types in both packages alike; the stdlib engine gives the native
    engine's frame; an input the native path defers on (an unterminated
    quote) takes the stdlib engine, as the JAX package's; gzip shards
    stream through the stdlib engine; ``from_pandas`` raises."""
    path = _write(tmp_path / "f.csv", _mixed_lines(7, n=80))
    monkeypatch.setitem(sys.modules, "pandas", None)
    native = P.parse_csv(path, device="cpu")
    assert native.vec("when").type != "time"
    assert_frames_equal(JP.parse_csv(path), native)
    assert_frames_equal(native, _stdlib_frame(path))
    bad = "a,b\n1,x\n2,\"open\n3,y\n"
    assert_frames_equal(JP.parse_csv(bad.encode()),
                        P.parse_csv(bad.encode(), device="cpu"))
    assert not P.last_parse_stats            # the native path deferred
    gz = str(tmp_path / "f.csv.gz")
    with open(path, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert_frames_equal(JP.import_file([gz, gz]),
                        import_file([gz, gz], device="cpu"))
    with pytest.raises(ImportError):
        P.from_pandas(object(), device="cpu")


# ------------------------------------------------------ the native library

def test_failed_build_and_tokenizer_error_raise(tmp_path, monkeypatch):
    """A tokenizer that does not build raises with the compiler's output,
    and an error inside the tokenizer propagates: neither turns into the
    stdlib engine.  The library's name hashes its source."""
    path = _write(tmp_path / "f.csv", _numeric_lines(1, n=10))
    good = fastcsv.lib_path()
    assert os.path.basename(good).startswith("libfastcsv-")
    bad = tmp_path / "fastcsv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastcsv, "SOURCE", str(bad))
    monkeypatch.setattr(fastcsv, "_lib", None)
    assert fastcsv.lib_path() != good
    with pytest.raises(RuntimeError, match="failed on"):
        P.parse_csv(path, device="cpu")
    monkeypatch.undo()

    def boom(*a, **k):
        raise MemoryError("tokenizer")
    monkeypatch.setattr(fastcsv, "parse_view", boom)
    with pytest.raises(MemoryError):
        P.parse_csv(path, device="cpu")
    assert _stdlib_frame(path).nrows == 10
