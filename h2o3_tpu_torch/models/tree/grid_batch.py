"""Batched grid cohorts: G grid members of one shape grown as one build —
the port of ``h2o3_tpu/models/tree/grid_batch.py``.

Reference: ``hex/grid/GridSearch.java`` trains every hyperparameter combo
as a job of its own.  Members that differ only in scalar hyperparameters
(``BATCHABLE``: learning rate, sample rates, lambda/alpha/gamma,
min_rows/min_child_weight/min_split_improvement, seed) grow trees of one
shape, so the JAX package grows them together, the member axis G where
the multinomial build has its class axis K: one histogram launch and one
records launch per level for all G members (``shared.make_grid_scan_fn``;
the records in the per-row form of ``csrc/split_records.cu``), each
member with its own parameters, draws and scores.  A loop of sequential
trains is its bitwise oracle.

Successive halving (``search_criteria={"successive_halving": True}``)
retires losing members at scoring fences through the ``alive`` mask: a
retired member's row weights are 0, so every split of its trees is
invalid, its leaf values are 0 and its scores stay as they were.

Anything that changes a tree's shape or the build's path falls back to
the wave path of ``grid.py`` (``CohortFallback`` with the reason): the
multinomial response, the hierarchical search, non-fused split modes,
the crosscheck modes, DART, monotone constraints, a custom distribution,
calibration, an engaged EFB plan, CV folds, checkpoints, and the options
the port has not ported, where the member's own builder then raises.
Not ported here: the JAX package's recovery journals, progress snapshots
and ``grid_member`` fault injection (``runtime/{recovery,snapshot,
failure}.py``).  Under ``tree_program="scan"`` a cohort round is the
whole-tree program (``make_grid_scan_fn(tree_program="scan")``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...runtime import dkv
from ...runtime import observability as obs
from ...runtime.job import DONE, FAILED, RUNNING, Job
from .. import parallel

#: per-member knobs that batch as ``[G]`` operands (or per-member host
#: state, for ``seed``); any other knob changes the build and so splits
#: cohorts
BATCHABLE = frozenset({
    "learn_rate", "sample_rate", "col_sample_rate",
    "col_sample_rate_per_tree", "reg_lambda", "reg_alpha", "gamma",
    "min_child_weight", "min_rows", "min_split_improvement", "seed",
})

# The device-memory budget of a cohort's resident state that the JAX
# package's autotuner sets for a GPU backend (h2o3_tpu/runtime/
# autotune.py:99, ``_HBM_BUDGET["gpu"]``): a copied constant, not a
# measurement of any card.  Only this memory half of its
# ``resolve_grid_batch`` is ported; its cost half rests on TPU constants.
GRID_STATE_BUDGET = 1.6e10


class CohortFallback(Exception):
    """This cohort cannot take the batched path: its members take the
    wave path instead (the reason is the argument)."""


def _eligibility(builder_cls, p) -> Optional[str]:
    """Parameter-level disqualifiers, checked before any device work: the
    fallback reason, or None when the member may batch."""
    if not getattr(builder_cls, "_grid_batchable", False):
        return f"{getattr(builder_cls, 'algo', builder_cls.__name__)} " \
               "has no batched-cohort trainer"
    if getattr(p, "nfolds", 0) and p.nfolds > 1:
        return "nfolds (CV folds already multiply the build)"
    if getattr(p, "checkpoint", None) is not None \
            or getattr(p, "warm_start", None) is not None:
        return "checkpoint/warm_start continuation"
    if getattr(p, "balance_classes", False):
        return "balance_classes"
    if getattr(p, "monotone_constraints", None):
        return "monotone_constraints"
    if getattr(p, "custom_distribution_func", None) is not None:
        return "custom_distribution_func"
    if getattr(p, "booster", "gbtree") == "dart":
        return "dart booster (per-tree drop state is sequential)"
    if str(getattr(p, "histogram_type", "auto")).lower() == "random":
        return "random histogram_type (per-seed bin edges cannot share " \
               "one binning)"
    if str(getattr(p, "split_search", "auto")).lower() == "hier":
        return "hierarchical split search"
    if str(getattr(p, "split_mode", "auto")).lower() not in ("auto",
                                                             "fused"):
        return "split_mode (batched builds are fused-only)"
    for knob in ("hist_mode", "hist_layout", "tree_program"):
        if str(getattr(p, knob, "auto")).lower() == "check":
            return f"{knob}=check (per-member crosscheck diagnostics)"
    if str(getattr(p, "efb", "auto")).lower() == "on":
        return "efb=on (bundled working codes are per-plan)"
    if getattr(p, "calibrate_model", False):
        return "calibrate_model"
    if getattr(p, "export_checkpoints_dir", None):
        return "export_checkpoints_dir"
    if getattr(p, "stream", False):
        return "stream mode"
    if getattr(p, "scale_pos_weight", 1.0) != 1.0:
        return "scale_pos_weight (XGBoost.train folds it into a weight " \
               "column)"
    return None


def plan_cohorts(builder_cls, base_params: dict,
                 combos: Sequence[dict]) -> Tuple[List[List[int]],
                                                  List[Tuple[int, str]]]:
    """Partition combo indices into batchable cohorts.

    Returns ``(cohorts, rest)``: cohorts are index lists (len >= 2) whose
    members agree on every non-``BATCHABLE`` parameter; ``rest`` carries
    ``(index, reason)`` for members that must take the wave path
    (ineligible params, bad combos, or no shape-compatible partner).
    """
    groups: Dict[tuple, List[int]] = {}
    rest: List[Tuple[int, str]] = []
    for i, combo in enumerate(combos):
        try:
            b = builder_cls(**{**base_params, **combo})
        except Exception as e:                          # noqa: BLE001
            rest.append((i, f"builder rejected params: {e!r}"))
            continue
        reason = _eligibility(builder_cls, b.params)
        if reason is not None:
            rest.append((i, reason))
            continue
        key = tuple(sorted((k, repr(v)) for k, v in combo.items()
                           if k not in BATCHABLE))
        groups.setdefault(key, []).append(i)
    cohorts = []
    for members in groups.values():
        if len(members) >= 2:
            cohorts.append(members)
        else:
            rest.append((members[0],
                         "singleton cohort (no shape-compatible partner)"))
    return cohorts, rest


def cohort_state_bytes(G: int, N: int, F: int, max_depth: int,
                       nbins: int) -> float:
    """The resident state of a G-member cohort by the JAX package's
    formula (``autotune.resolve_grid_batch`` at K = 1: a cohort is
    single-class): the F/g/h/w row vectors plus a level histogram and its
    subtraction carry, per member."""
    B = nbins + 1
    W = 2 ** max(max_depth - 1, 0)
    return float(G) * (16.0 * N + 2 * 3.0 * W * F * B * 4.0)


def resolve_grid_batch(G: int, N: int, F: int, max_depth: int,
                       nbins: int) -> Optional[str]:
    """``grid_batch="auto"``: None when the cohort's state fits
    ``GRID_STATE_BUDGET`` (it batches), else the reason it takes the wave
    path."""
    state = cohort_state_bytes(G, N, F, max_depth, nbins)
    if state > GRID_STATE_BUDGET:
        return (f"cohort state {state:.4g} B over the budget "
                f"{GRID_STATE_BUDGET:.4g} B (scheduler-parallel)")
    return None


def _halving_rungs(G: int, ntrees: int, eta: float) -> List[Tuple[int,
                                                                  int]]:
    """Successive-halving schedule ``[(tree_count, keep), ...]``:
    geometric tree budgets and survivor counts (G members at
    ntrees/eta^R, keep G/eta each rung, the last survivors train to
    completion).  A rung takes effect at the first scoring fence at or
    after its tree count (retirement needs fresh interval metrics)."""
    if eta <= 1.0 or G < 2:
        return []
    R = int(math.floor(math.log(G) / math.log(eta) + 1e-9))
    rungs = []
    for i in range(R):
        trees = int(math.ceil(ntrees / eta ** (R - i)))
        keep = int(math.ceil(G / eta ** (i + 1)))
        if trees >= ntrees or keep >= G:
            continue
        rungs.append((trees, keep))
    return rungs


def train_cohort(builder_cls, base_params: dict, combos: Sequence[dict],
                 frame, valid=None, search_criteria: Optional[dict] = None,
                 deadline: Optional[float] = None
                 ) -> List[Tuple[Optional[object], Optional[str]]]:
    """Train G shape-compatible grid members as one batched build.

    GBM's single-class training loop with the member axis G: shared binning,
    DataInfo and initial score (the same for every member by cohort
    construction), each member's seed resolved once and pinned (so that
    its sequential twin regrows the same trees), one chunk loop, per-member
    ``StackedTrees`` chunks, interval scoring, early stopping and
    successive halving through the host-side ``alive`` mask, the
    validation frame scored per member, and each member finished as its
    own train finishes (``_finalize_fused``).  ``deadline`` (a
    ``time.monotonic()`` value) is armed as the thread's cooperative
    deadline (``models/parallel.py``) and polled at every chunk fence: the
    members then keep the trees grown so far.

    Returns ``[(model, None) | (None, error_str)]`` aligned with
    ``combos``.  Raises ``CohortFallback`` before any device work when
    the cohort cannot batch.
    """
    from ..scorekeeper import METRIC_MAXIMIZE, metric_direction
    from .binning import edges_matrix, fit_bins
    from .gbm import params_distribution
    from .shared import (StackedTrees, chunk_schedule,
                         make_grid_scan_fn, plan_for,
                         record_effective_depth, resolve_hist_layout,
                         resolve_hist_mode, resolve_tree_program, traverse)

    G = len(combos)
    if G < 2:
        raise CohortFallback("singleton cohort")
    builders = []
    for combo in combos:
        b = builder_cls(**{**base_params, **combo})
        reason = _eligibility(builder_cls, b.params)
        if reason is not None:
            raise CohortFallback(reason)
        # resolve seed=-1 once and pin it: the member's sequential twin
        # must regrow the same trees
        b.params = dataclasses.replace(b.params,
                                       seed=b.params.effective_seed())
        builders.append(b)
    rep = builders[0]
    p0 = rep.params
    dev = rep._check_device(frame, valid)
    try:
        rep._validate(frame)
    except NotImplementedError as e:
        raise CohortFallback(str(e))
    di = rep._make_datainfo(frame)
    if di.is_classifier and di.nclasses > 2:
        raise CohortFallback(
            "multinomial response (class trees already occupy the batch "
            "axis)")
    dist = params_distribution(p0, di.nclasses)
    y, w = di.response(frame), di.weights(frame)
    y, init = rep._prep_targets(y, w, dist)
    binned = fit_bins(frame, [s.name for s in di.specs], nbins=p0.nbins,
                      seed=p0.seed,
                      weights=w if p0.weights_column else None,
                      histogram_type=p0.histogram_type)
    codes = binned.codes
    edges_mat = torch.from_numpy(edges_matrix(binned.edges, p0.nbins)).to(dev)
    N = codes.shape[1]
    if plan_for(binned, p0, None, frame.nrows) is not None:
        raise CohortFallback("EFB bundling engaged")
    Fw = binned.nfeatures
    hist_mode = resolve_hist_mode(p0)
    # past the threshold the cohort grows node-sparse levels, as each
    # member's own train does: its depth does not depend on G
    hist_layout = resolve_hist_layout(p0, hist_mode=hist_mode)
    # "scan" grows each round as the whole-tree program; where the
    # members' own trains would refuse it, so does the cohort
    try:
        tree_program = resolve_tree_program(
            p0, hist_layout=hist_layout, bin_counts=binned.bin_counts, F=Fw,
            n_padded=N, device=dev)
    except ValueError as e:
        raise CohortFallback(str(e))
    scan_fn = make_grid_scan_fn(
        G, dist, p0.max_depth, p0.nbins, Fw, N,
        bin_counts=binned.bin_counts, hist_mode=hist_mode,
        hist_layout=hist_layout, device=dev,
        sparse_depth_threshold=p0.sparse_depth_threshold,
        tree_program=tree_program)

    algo = rep.algo
    obs.set_gauge("grid_cohort_size", float(G), algo=algo)
    obs.record("grid_cohort_start", algo=algo, size=G,
               tree_program=tree_program)
    t_start = time.time()
    models, jobs = [], []
    for g, b in enumerate(builders):
        m = b.model_class(dkv.make_key(algo), b.params, di)
        m.output["distribution"] = dist.name
        m.output["binning"] = {"nbins": p0.nbins}
        m.output["nclass_trees"] = 1
        m.output["tree_program"] = tree_program
        m.output["split_search"] = "exact"
        m.output["hist_kernel"] = \
            "varbin" if scan_fn.build.use_varbin else "uniform"
        m.output["grid_cohort"] = {"size": G, "member": g}
        record_effective_depth(m, b.params, Fw, N, hist_layout=hist_layout)
        job = Job(f"{algo} train", dest_key=m.key)
        job.status = RUNNING
        job.start_time = t_start
        models.append(m)
        jobs.append(job)

    if valid is not None:
        Xv = models[0]._design(valid)
        y_v, w_v = di.response(valid), di.weights(valid)
        Fvs = [init.to(torch.float32).expand(Xv.shape[0]).clone()
               for _ in range(G)]
    init_host = float(init)
    F = init.to(torch.float32).expand(G, N).clone()

    def arr(name):
        return torch.tensor([float(getattr(b.params, name))
                             for b in builders], dtype=torch.float32,
                            device=dev)

    def rates(name):
        return tuple(float(getattr(b.params, name)) for b in builders)

    seeds = [int(b.params.seed) for b in builders]
    head = (arr("reg_lambda"), arr("min_rows"),
            arr("min_split_improvement"), arr("learn_rate"),
            rates("col_sample_rate"), rates("sample_rate"),
            rates("col_sample_rate_per_tree"))
    tail = (arr("reg_alpha"), arr("gamma"), arr("min_child_weight"))
    metric_name, maximize = metric_direction(p0.stopping_metric,
                                             di.is_classifier)
    sc = dict(search_criteria or {})
    h_metric = sc.get("halving_metric") or metric_name
    h_maximize = METRIC_MAXIMIZE.get(h_metric, False) \
        if h_metric != metric_name else maximize
    rungs = _halving_rungs(G, p0.ntrees,
                           float(sc.get("halving_eta", 3.0))) \
        if sc.get("successive_halving") else []

    chunks: List[list] = [[] for _ in range(G)]
    histories: List[list] = [[] for _ in range(G)]
    alive = [True] * G                 # still growing trees
    failed: List[Optional[str]] = [None] * G
    nt = [0] * G                       # trees trained per member

    def member_failed(g: int, e: BaseException) -> None:
        failed[g] = repr(e)
        alive[g] = False
        obs.record("grid_member_failed", algo=algo, member=g, error=repr(e))

    # max_runtime_secs: the deadline is armed in this thread and polled
    # at every chunk fence (shared.chunk_schedule); past it every member
    # keeps the trees grown so far
    prev_deadline = parallel.get_deadline()
    if deadline is not None:
        parallel.set_deadline(deadline)
    try:
        for chunk_no, (c, t_done, score_now) in enumerate(
                chunk_schedule(p0.ntrees, p0.score_tree_interval)):
            if not any(alive):
                break
            live = [g for g in range(G) if alive[g]]
            F, per = scan_fn(codes, y, w, F, edges_mat, seeds, chunk_no, c,
                             *head, list(alive), *tail)
            for g in live:
                try:
                    chunks[g].append(per[g])
                    nt[g] = t_done
                    jobs[g].update(t_done / p0.ntrees,
                                   f"tree {t_done}/{p0.ntrees}")
                    if valid is not None:
                        Fvs[g] = Fvs[g] + traverse(per[g].levels, per[g].values,
                                                   Xv)
                except Exception as e:                      # noqa: BLE001
                    member_failed(g, e)
            if not score_now:
                continue
            for g in live:
                if not alive[g]:
                    continue
                try:
                    vstate = (Fvs[g], y_v, w_v) if valid is not None else None
                    if builders[g]._interval_score(
                            models[g], t_done, F[g], y, w, di, dist,
                            histories[g], vstate, metric_name, maximize):
                        alive[g] = False            # the member's early stop
                except Exception as e:                      # noqa: BLE001
                    member_failed(g, e)
            # successive halving: at each rung's fence keep the best ``keep``
            # members by metric; the others retire through the alive mask
            while rungs and t_done >= rungs[0][0]:
                _, keep = rungs.pop(0)
                live_now = [g for g in range(G)
                            if alive[g] and failed[g] is None]
                if len(live_now) <= keep:
                    continue
                key = f"valid_{h_metric}" if valid is not None else h_metric
                worst = math.inf if h_maximize else -math.inf

                def rank(g):
                    v = histories[g][-1].get(key) if histories[g] else None
                    return worst if v is None else v

                for g in sorted(live_now, key=rank, reverse=h_maximize)[keep:]:
                    alive[g] = False
                    models[g].output["halving"] = {"retired_at": int(t_done),
                                                   "rung_keep": keep}
                    obs.inc("grid_members_retired_total", algo=algo)
                    obs.record("grid_member_retired", algo=algo, member=g,
                               trees=int(t_done))
    except parallel.DeadlineExceeded:
        obs.record("grid_cohort_deadline", algo=algo, trees=max(nt))
    finally:
        parallel.set_deadline(prev_deadline)

    results: List[Tuple[Optional[object], Optional[str]]] = []
    for g in range(G):
        if failed[g] is None and not chunks[g]:
            failed[g] = "DeadlineExceeded('max_runtime_secs deadline " \
                        "before the first tree chunk')"
        jobs[g].end_time = time.time()
        if failed[g] is not None:
            jobs[g].status = FAILED
            results.append((None, failed[g]))
            continue
        try:
            m = builders[g]._finalize_fused(
                models[g], di, dist, F[g], y, w, valid, histories[g], binned,
                init_host, StackedTrees.concat(chunks[g]))
            m.output.setdefault("run_time_s", time.time() - t_start)
            m.output.setdefault("training_frame_rows", frame.nrows)
            builders[g]._post_fit(m, frame, valid)
            jobs[g].status = DONE
            jobs[g].progress = 1.0
            jobs[g].result = m
            results.append((m, None))
        except Exception as e:                          # noqa: BLE001
            jobs[g].status = FAILED
            jobs[g].exception = e
            results.append((None, repr(e)))
    return results
