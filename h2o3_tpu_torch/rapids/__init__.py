"""Rapids: dataframe munging on the device — the port of
``h2o3_tpu/rapids``.

Reference: ``water/rapids/``, a Lisp-like expression language with its
``Ast*`` primitives, distributed radix sort and merge
(``RadixOrder.java``/``BinaryMerge.java``) and group-by (``AstGroup``).
The munging verbs are plain functions over Frames (``ops``, ``strings``);
the expression interpreter (``ast``, ``prims``) and the lazy client DAG
(``expr``) mirror h2o-py's ExprNode protocol.  Row-scale work (sort keys,
segment aggregation, joins, filters) runs as torch ops on the frame's
device (``device``): the sort is a stable radix argsort, the group-by a
dense rank with fixed-order sums over the sorted runs, the merge a joint
dense rank with segment tables and a prefix-sum expansion.
"""

from .ops import (sort, group_by, merge, rbind, cbind, filter_rows, unique,
                  table, ifelse, hist, impute, cut, scale, interaction,
                  var, cor)
from .strings import (toupper, tolower, trim, lstrip, rstrip, substring,
                      sub, gsub, nchar, strsplit, countmatches)
from .ast import rapids
from .expr import lazy, LazyFrame
