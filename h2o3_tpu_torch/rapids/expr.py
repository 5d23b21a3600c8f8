"""Lazy Rapids expression DAG — the h2o-py ``ExprNode``/``H2OFrame``
analog, the port of ``h2o3_tpu/rapids/expr.py``.

Reference: ``h2o-py/h2o/expr.py:27-34`` — client-side frames are lazy AST
nodes; operations build ``(op args...)`` strings which only execute (via
/99/Rapids) when results are demanded, and materialized results are cached
under session-temp DKV keys.

``LazyFrame`` wraps either a DKV key or an unevaluated AST.  Arithmetic,
comparison, slicing, sort/merge/group-by compose lazily; ``.frame()`` /
``.collect()`` force evaluation through a ``Backend`` — in-process
(ast.rapids) or remote (client.H2OConnection posts to /99/Rapids).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Union

import numpy as np

_TMP = itertools.count()


class Backend:
    """Evaluation target for lazy expressions."""

    def rapids(self, text: str):
        raise NotImplementedError

    def frame_by_key(self, key: str):
        raise NotImplementedError


class LocalBackend(Backend):
    """In-process evaluation; ``device`` places results made from no
    frame (``cuda`` unless named)."""

    def __init__(self, device=None):
        self.device = device

    def rapids(self, text: str):
        from .ast import rapids
        return rapids(text, device=self.device)

    def frame_by_key(self, key: str):
        from ..runtime import dkv
        return dkv.get(key)


def _quote(s: str) -> str:
    return "'" + str(s).replace("'", "\\'") + "'"


def _lit(v) -> str:
    if isinstance(v, LazyFrame):
        return v.ast()
    if isinstance(v, str):
        return _quote(v)
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + " ".join(_lit(x) for x in v) + "]"
    return repr(float(v)) if isinstance(v, float) else repr(v)


class LazyFrame:
    """A deferred frame: either a DKV key or an AST over other frames."""

    def __init__(self, ast_or_key: str, backend: Optional[Backend] = None,
                 is_key: bool = False):
        self._ast = ast_or_key
        self._is_key = is_key
        self._backend = backend or LocalBackend()
        self._cached_key: Optional[str] = None

    # ------------------------------------------------------------ plumbing
    @staticmethod
    def from_key(key: str, backend: Optional[Backend] = None) -> "LazyFrame":
        return LazyFrame(key, backend, is_key=True)

    def ast(self) -> str:
        if self._cached_key is not None:
            return self._cached_key
        return self._ast

    def _op(self, op: str, *args) -> "LazyFrame":
        parts = " ".join(_lit(a) for a in args)
        return LazyFrame(f"({op} {self.ast()}{' ' if parts else ''}{parts})",
                         self._backend)

    # ----------------------------------------------------------- execution
    def execute(self) -> "LazyFrame":
        """Force evaluation into a session temp key (h2o-py _eager)."""
        if self._is_key or self._cached_key is not None:
            return self
        key = f"rapids_tmp_{next(_TMP)}"
        self._backend.rapids(f"(tmp= {key} {self._ast})")
        self._cached_key = key
        return self

    def frame(self):
        """Materialize to a concrete Frame (local backends)."""
        if self._is_key:
            return self._backend.frame_by_key(self._ast)
        self.execute()
        return self._backend.frame_by_key(self._cached_key)

    def collect(self) -> np.ndarray:
        return self.frame().to_numpy()

    def scalar(self) -> float:
        """Evaluate an aggregate expression to a number."""
        out = self._backend.rapids(self._ast)
        return float(out)

    # ---------------------------------------------------------- operations
    def __add__(self, o):
        return self._op("+", o)

    def __radd__(self, o):
        return LazyFrame(f"(+ {_lit(o)} {self.ast()})", self._backend)

    def __sub__(self, o):
        return self._op("-", o)

    def __mul__(self, o):
        return self._op("*", o)

    def __truediv__(self, o):
        return self._op("/", o)

    def __pow__(self, o):
        return self._op("^", o)

    def __lt__(self, o):
        return self._op("<", o)

    def __le__(self, o):
        return self._op("<=", o)

    def __gt__(self, o):
        return self._op(">", o)

    def __ge__(self, o):
        return self._op(">=", o)

    def __eq__(self, o):                         # noqa: A003
        return self._op("==", o)

    def __ne__(self, o):
        return self._op("!=", o)

    def __and__(self, o):
        return self._op("&", o)

    def __or__(self, o):
        return self._op("|", o)

    def __getitem__(self, sel) -> "LazyFrame":
        if isinstance(sel, LazyFrame):           # boolean row mask
            return LazyFrame(f"(rows {self.ast()} {sel.ast()})",
                             self._backend)
        if isinstance(sel, str):
            return self._op("cols", [sel])
        if isinstance(sel, (list, tuple)):
            return self._op("cols", list(sel))
        raise TypeError(f"bad selector {sel!r}")

    def log(self):
        return self._op("log")

    def exp(self):
        return self._op("exp")

    def abs(self):                               # noqa: A003
        return self._op("abs")

    def sqrt(self):
        return self._op("sqrt")

    def isna(self):
        return self._op("is.na")

    def ifelse(self, yes, no):
        return self._op("ifelse", yes, no)

    def sum(self):                               # noqa: A003
        return self._op("sum").scalar()

    def mean(self):
        return self._op("mean").scalar()

    def max(self):                               # noqa: A003
        return self._op("max").scalar()

    def min(self):                               # noqa: A003
        return self._op("min").scalar()

    def sd(self):
        return self._op("sd").scalar()

    def median(self):
        return self._op("median").scalar()

    def nrow(self) -> int:
        return int(self._op("nrow").scalar())

    def ncol(self) -> int:
        return int(self._op("ncol").scalar())

    def sort(self, by: Union[str, Sequence[str]],
             ascending=True) -> "LazyFrame":
        by = [by] if isinstance(by, str) else list(by)
        asc = [ascending] * len(by) if isinstance(ascending, bool) \
            else list(ascending)
        return self._op("sort", by, [1 if a else 0 for a in asc])

    def merge(self, other: "LazyFrame", by: Union[str, Sequence[str]],
              all_left: bool = False) -> "LazyFrame":
        by = [by] if isinstance(by, str) else list(by)
        return self._op("merge", other, all_left, by)

    def group_by(self, by: Union[str, Sequence[str]],
                 **aggs: Union[str, Sequence[str]]) -> "LazyFrame":
        """group_by(by, col=\"mean\", other_col=[\"sum\", \"max\"])."""
        by = [by] if isinstance(by, str) else list(by)
        parts: List[str] = []
        for col, fns in aggs.items():
            for fn in ([fns] if isinstance(fns, str) else fns):
                parts += [fn, _quote(col), _quote("all")]
        return LazyFrame(
            f"(GB {self.ast()} {_lit(by)} {' '.join(parts)})", self._backend)

    def rbind(self, other: "LazyFrame") -> "LazyFrame":
        return self._op("rbind", other)

    # -------------------------------------------------- string verbs
    def toupper(self) -> "LazyFrame":
        return self._op("toupper")

    def tolower(self) -> "LazyFrame":
        return self._op("tolower")

    def trim(self) -> "LazyFrame":
        return self._op("trim")

    def nchar(self) -> "LazyFrame":
        return self._op("nchar")

    def substring(self, start: int, end=None) -> "LazyFrame":
        return self._op("substring", start) if end is None else \
            self._op("substring", start, end)

    def sub(self, pattern: str, replacement: str) -> "LazyFrame":
        """Replace first match (client arg order, like h2o-py)."""
        return LazyFrame(f"(replacefirst {_lit(pattern)} "
                         f"{_lit(replacement)} {self.ast()} FALSE)",
                         self._backend)

    def gsub(self, pattern: str, replacement: str) -> "LazyFrame":
        return LazyFrame(f"(replaceall {_lit(pattern)} "
                         f"{_lit(replacement)} {self.ast()} FALSE)",
                         self._backend)

    def countmatches(self, pattern: str) -> "LazyFrame":
        return self._op("countmatches", pattern)

    # -------------------------------------------------- stats verbs
    def scale(self, center: bool = True, scale: bool = True) -> "LazyFrame":
        return self._op("scale", center, scale)

    def impute(self, column, method: str = "mean") -> "LazyFrame":
        return self._op("h2o.impute", column, method)

    def var(self, use: str = "complete.obs"):
        """Covariance matrix Frame for multi-column frames; a float
        (like sd()/mean()) when the frame has a single column."""
        out = self._backend.rapids(f'(var {self.ast()} {_quote(use)})')
        return out if not isinstance(out, (int, float)) else float(out)

    def cor(self, use: str = "complete.obs"):
        return self._backend.rapids(f'(cor {self.ast()} {_quote(use)})')

    def cbind(self, other: "LazyFrame") -> "LazyFrame":
        return self._op("cbind", other)

    def unique(self) -> "LazyFrame":
        return self._op("unique")

    def asfactor(self) -> "LazyFrame":
        return self._op("as.factor")

    def asnumeric(self) -> "LazyFrame":
        return self._op("as.numeric")

    def __repr__(self):
        return f"<LazyFrame {self.ast()[:120]}>"


def lazy(frame_or_key, backend: Optional[Backend] = None) -> LazyFrame:
    """Wrap a Frame (by key) or key string as a lazy expression root."""
    key = frame_or_key if isinstance(frame_or_key, str) \
        else frame_or_key.key
    if key is None:
        from ..runtime import dkv
        key = dkv.make_key("frame")
        dkv.put(key, frame_or_key)
        frame_or_key.key = key
    return LazyFrame.from_key(key, backend)
