"""Grid search: Cartesian and RandomDiscrete hyperparameter walkers — the
port of ``h2o3_tpu/models/grid.py``.

Reference: ``hex/grid/GridSearch.java`` and ``HyperSpaceWalker.java``
(Cartesian and RandomDiscrete walkers with max_models / max_runtime_secs
budgets and early stopping over the model sequence) and
``hex/grid/Grid.java`` (the model container and its sorted metric table).

Combos that differ only in scalar hyperparameters train as batched
cohorts (``models/tree/grid_batch.py``: one level loop for G members);
every other combo, and every member a cohort turns away (the reason is
recorded as a ``grid_batch_fallback`` event), takes the wave path: waves
of ``parallelism`` concurrent ``builder.train`` calls
(``models/parallel.py::map_builds``), each member bitwise its sequential
train.  Not ported yet: ``Grid.save``/``load`` (``persist/``).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..frame.frame import Frame
from ..runtime import dkv
from ..runtime.device import resolve_device
from ..runtime.observability import record
from .base import Model
from .parallel import effective_parallelism, map_builds
from .scorekeeper import METRIC_MAXIMIZE, stop_early


class _FailedBuild:
    """A wave member whose build raised: its error's repr."""

    def __init__(self, error: str):
        self.error = error


def default_sort_metric(model: Model) -> (str, bool):
    """(metric, lower_is_better) by model category (Leaderboard defaults)."""
    di = model.datainfo
    if di.is_classifier and di.nclasses == 2:
        return "auc", False
    if di.is_classifier:
        return "logloss", True
    return "rmse", True


def model_metric(model: Model, metric: str) -> Optional[float]:
    """A metric off the CV metrics when present, else the validation, else
    the training metrics."""
    for m in (getattr(model, "cross_validation_metrics", None),
              model.validation_metrics, model.training_metrics):
        if m is None:
            continue
        v = getattr(m, metric, None)
        if v is None and isinstance(m, dict):
            v = m.get(metric)
        if v is not None:
            return float(v)
    return None


class Grid:
    """A trained grid — the hex/grid/Grid.java analog."""

    def __init__(self, key: str, models: List[Model],
                 hyper_names: Sequence[str], entries: List[dict],
                 sort_metric: str, decreasing: bool,
                 failed_entries: Optional[List[dict]] = None):
        self.key = key
        self.models = models
        self.hyper_names = list(hyper_names)
        self.entries = entries
        self.sort_metric = sort_metric
        self.decreasing = decreasing
        # the combos whose build failed, each with its "error" repr: the
        # grid completes on the others
        self.failed_entries = list(failed_entries or [])
        dkv.put(key, self)

    def _order(self) -> List[int]:
        vals = [model_metric(m, self.sort_metric) for m in self.models]
        keyed = [(v if v is not None else np.inf * (1 if not self.decreasing
                                                    else -1), i)
                 for i, v in enumerate(vals)]
        return [i for _, i in sorted(keyed, reverse=self.decreasing)]

    @property
    def best_model(self) -> Model:
        return self.models[self._order()[0]]

    def sorted_metric_table(self) -> List[dict]:
        return [{**self.entries[i], "model_id": self.models[i].key,
                 self.sort_metric: model_metric(self.models[i],
                                                self.sort_metric)}
                for i in self._order()]

    def __repr__(self):
        return (f"<Grid {self.key}: {len(self.models)} models by "
                f"{self.sort_metric}>")


class GridSearch:
    """The grid search — h2o.grid / H2OGridSearch analog.

    ``search_criteria``: {"strategy": "Cartesian"} (default) or
    {"strategy": "RandomDiscrete", "max_models": N, "max_runtime_secs": S,
    "seed": K, "stopping_rounds": R, "stopping_tolerance": T}; for
    batched cohorts also ``successive_halving`` (bool), ``halving_eta``
    (default 3) and ``halving_metric``.

    ``grid_batch``: "on" trains every cohort of combos that differ only in
    scalar hyperparameters as one batched build; "auto" does so where the
    cohort's resident state fits ``grid_batch.GRID_STATE_BUDGET``; "off"
    is the wave path alone.  ``parallelism`` n > 1 builds the wave path
    in waves of n concurrent members (threads sharing the card; budgets
    and sequence early stopping are re-checked between waves, so a wave
    may overshoot by at most n - 1 models, as in the reference's parallel
    walker); 0 (auto) and 1 build one member at a time.  The waves are
    kept for parity, not speed: on an H100 two concurrent waves built
    0.44-0.79 times the member trees/s of sequential ones (one stream,
    one interpreter; ``chip_smoke.py`` phase 54, PERF.md).  The whole-tree
    scan program (``tree_program`` "scan" or "check") captures CUDA
    graphs, whose capture is process-wide, so it is refused under n > 1.
    ``base_params`` go to every member's builder (``device`` included).
    """

    def __init__(self, builder_cls, hyper_params: Dict[str, Sequence],
                 search_criteria: Optional[dict] = None,
                 parallelism: int = 0, grid_batch: str = "auto",
                 **base_params):
        if parallelism < 0:
            raise ValueError(f"parallelism={parallelism}: use 0 (auto), 1 "
                             "or n > 1 concurrent members")
        programs = [str(base_params.get("tree_program", "auto")).lower()] \
            + [str(v).lower() for v in hyper_params.get("tree_program", ())]
        if parallelism > 1 and any(p in ("scan", "check") for p in programs):
            raise ValueError(
                f"parallelism={parallelism} with tree_program='scan'/'check':"
                " the whole-tree program captures CUDA graphs, whose capture"
                " mode and sync-debug mode are process-wide, so concurrent "
                "members cannot capture; use parallelism=1 or the level "
                "program")
        mode = str(grid_batch).lower()
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"grid_batch={grid_batch!r}: use auto | on | "
                             "off")
        self.builder_cls = builder_cls
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        self.search_criteria = dict(search_criteria or
                                    {"strategy": "Cartesian"})
        self.parallelism = parallelism
        self.grid_batch = mode
        self.base_params = base_params

    def _combos(self) -> List[dict]:
        names = list(self.hyper_params)
        all_combos = [dict(zip(names, vals)) for vals in
                      itertools.product(*(self.hyper_params[n]
                                          for n in names))]
        sc = self.search_criteria
        if sc.get("strategy", "Cartesian").lower() in (
                "randomdiscrete", "random_discrete"):
            rng = np.random.default_rng(sc.get("seed", 0))
            rng.shuffle(all_combos)
        return all_combos

    def train(self, frame: Frame, valid: Optional[Frame] = None,
              sort_metric: Optional[str] = None) -> Grid:
        from .tree import grid_batch as gb
        # the members' device (cuda unless named): without CUDA this
        # raises here, not as a failed entry per member
        resolve_device(self.base_params.get("device"))
        sc = self.search_criteria
        max_models = sc.get("max_models", None)
        max_secs = sc.get("max_runtime_secs", None)
        stop_rounds = sc.get("stopping_rounds", 0)
        stop_tol = sc.get("stopping_tolerance", 1e-3)
        t0 = time.time()
        # max_runtime_secs: checked between cohorts and waves, and by the
        # cohort trainer at each chunk fence
        deadline = (time.monotonic() + max_secs) if max_secs else None
        models, entries = [], []
        failed_entries: List[dict] = []
        metric, decreasing = None, None
        series: List[float] = []
        combos = self._combos()

        def note(combo, m):
            nonlocal metric, decreasing
            models.append(m)
            entries.append(combo)
            if metric is None:
                if sort_metric is None:
                    metric, lower = default_sort_metric(m)
                else:
                    metric = sort_metric
                    lower = not METRIC_MAXIMIZE.get(sort_metric, False)
                decreasing = not lower
            v = model_metric(m, metric)
            if v is not None:
                series.append(v)

        def seq_stop() -> bool:
            # early stop over the sequence of models, checked between
            # cohorts and waves
            return bool(stop_rounds and series and stop_early(
                series, stop_rounds, stop_tol, maximize=decreasing))

        def out_of_time() -> bool:
            return bool(max_secs and time.time() - t0 > max_secs)

        remaining = list(range(len(combos)))
        stopped = False
        if self.grid_batch in ("auto", "on") and len(combos) > 1:
            scope = remaining[:max_models] if max_models else remaining
            cohorts, rest = gb.plan_cohorts(
                self.builder_cls, self.base_params,
                [combos[i] for i in scope])
            for j, reason in rest:
                record("grid_batch_fallback", combo=combos[scope[j]],
                       reason=reason)
            taken = set()
            for co in cohorts:
                idxs = [scope[j] for j in co]
                if stopped or out_of_time():
                    break
                if self.grid_batch == "auto":
                    rep = self.builder_cls(
                        **{**self.base_params, **combos[idxs[0]]})
                    why = gb.resolve_grid_batch(
                        len(idxs), frame.nrows, max(len(frame.names) - 1, 1),
                        rep.params.max_depth, rep.params.nbins)
                    if why is not None:
                        record("grid_batch_fallback", members=len(idxs),
                               reason=why)
                        continue
                try:
                    res = gb.train_cohort(
                        self.builder_cls, self.base_params,
                        [combos[i] for i in idxs], frame, valid,
                        search_criteria=sc, deadline=deadline)
                except gb.CohortFallback as e:
                    record("grid_batch_fallback", members=len(idxs),
                           reason=str(e))
                    continue
                for i, (m, err) in zip(idxs, res):
                    taken.add(i)
                    if err is not None:
                        failed_entries.append({**combos[i], "error": err})
                    else:
                        note(combos[i], m)
                stopped = seq_stop()
            remaining = [i for i in remaining if i not in taken]

        # the wave path: waves of ``par`` concurrent members (one at a
        # time for parallelism 0 and 1); the deadline is armed in each
        # member's thread and polled at its chunk fences
        par = effective_parallelism(self.parallelism, len(remaining))
        pos = 0
        while pos < len(remaining) and not stopped:
            if out_of_time() or (max_models and len(models) >= max_models):
                break
            wave = remaining[pos: pos + par]
            if max_models:
                wave = wave[: max_models - len(models)]
            pos += len(wave)

            def build(i):
                # a failing member (a mid-build DeadlineExceeded included)
                # becomes a failed_entries row
                try:
                    return self.builder_cls(
                        **{**self.base_params, **combos[i]}).train(
                            frame, valid)
                except Exception as e:                  # noqa: BLE001
                    return _FailedBuild(repr(e))

            for i, m in zip(wave, map_builds(
                    [lambda i=i: build(i) for i in wave], par,
                    deadline=deadline)):
                if isinstance(m, _FailedBuild):
                    failed_entries.append({**combos[i], "error": m.error})
                    continue
                note(combos[i], m)
            stopped = seq_stop()
        if not models:
            raise ValueError(
                "grid search trained no models"
                + (f"; member failures: {failed_entries}"
                   if failed_entries else ""))
        return Grid(dkv.make_key("grid"), models, list(self.hyper_params),
                    entries, metric, decreasing,
                    failed_entries=failed_entries)
