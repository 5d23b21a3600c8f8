"""Grep: regex search over raw text files — the ``hex/grep/Grep.java``
analog, the port of ``h2o3_tpu/models/grep.py``.

The reference distributes a regex match over a file's raw byte chunks
(MRTask) and reports per-match offsets.  Here it is host work (a text
scan is no device math) over the file import's path expansion and
decompression (``frame.parse``); the match table lands on ``device``
(``cuda`` unless named).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.job import Job
from .base import Model, ModelBuilder, Parameters


@dataclasses.dataclass
class GrepParameters(Parameters):
    regex: str = ""


class GrepModel(Model):
    algo = "grep"

    def result(self) -> Frame:
        return dkv.get(self.output["matches_frame"])

    def _predict_raw(self, X):
        raise NotImplementedError("grep produces a match table")


def grep(path, regex: str, destination_frame: Optional[str] = None,
         device=None) -> Frame:
    """Search file(s) for a regex; returns (file, offset, match) rows."""
    from ..frame.parse import _expand_paths, _open_decompressed
    pat = re.compile(regex.encode())     # byte-level: true byte offsets
    files: List[str] = []
    offsets: List[float] = []
    matches: List[str] = []
    for uri in _expand_paths(path):
        fh = _open_decompressed(uri)
        data = fh.read()
        fh.close()
        if isinstance(data, str):
            data = data.encode()
        for m in pat.finditer(data):
            files.append(uri)
            offsets.append(float(m.start()))
            matches.append(m.group(0).decode(errors="replace"))
    fr = Frame.from_numpy({
        "file": np.asarray(files, dtype=object),
        "byte_offset": np.asarray(offsets, np.float64),
        "match": np.asarray(matches, dtype=object)},
        key=destination_frame or dkv.make_key("grep"), device=device)
    return fr


class Grep(ModelBuilder):
    algo = "grep"
    model_class = GrepModel
    supervised = False

    def __init__(self, params: Optional[GrepParameters] = None, **kw):
        super().__init__(params or GrepParameters(**kw))

    def train_on_path(self, path) -> GrepModel:
        p: GrepParameters = self.params
        if not p.regex:
            raise ValueError("grep requires regex")
        job = Job(f"grep {p.regex!r}")

        def run(j):
            fr = grep(path, p.regex, device=p.device)
            model = GrepModel(dkv.make_key(self.algo), p, None)
            model.output["matches_frame"] = fr.key
            model.output["n_matches"] = fr.nrows
            return model
        return job.run(run)
