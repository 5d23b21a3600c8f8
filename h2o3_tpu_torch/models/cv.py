"""Cross-validation — the port of ``h2o3_tpu/models/cv.py``.

Reference: ``hex/CVModelBuilder.java:10`` + ``hex/FoldAssignment.java`` +
ModelBuilder's CV code: build N fold models, gather their holdout
predictions into the main model's CV metrics, then train the final model
on all the data.

As in the JAX package, every fold model trains on the FULL frame with its
holdout rows' weights zeroed (a synthetic weight column), not on a row
slice, so the folds share one geometry, and the fold draws are numpy's,
so a seed gives the JAX package's folds bit for bit.  The folds train one
after another: the base ``parallelism`` field that would run them on
``models/parallel.py::map_builds`` comes with the runtime planes (ROADMAP
Queue 1 item 9), and no result depends on the order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..frame.frame import Frame
from ..frame.vec import T_NUM, Vec
from ..metrics.core import make_metrics
from ..runtime.job import Job

CV_WEIGHTS = "_cv_weights_"


def fold_assignment(n: int, nfolds: int, scheme: str, seed: int,
                    y: Optional[np.ndarray] = None) -> np.ndarray:
    """Row -> fold index (hex/FoldAssignment.java). Schemes: auto|random|
    modulo|stratified."""
    if scheme in ("auto", "random"):
        rng = np.random.default_rng(seed)
        return rng.integers(0, nfolds, size=n)
    if scheme == "modulo":
        return np.arange(n) % nfolds
    if scheme == "stratified":
        if y is None:
            raise ValueError("stratified fold assignment needs a response")
        rng = np.random.default_rng(seed)
        folds = np.zeros(n, dtype=np.int64)
        for cls in np.unique(y[~np.isnan(y)]):
            idx = np.nonzero(y == cls)[0]
            rng.shuffle(idx)
            folds[idx] = np.arange(len(idx)) % nfolds
        return folds
    raise ValueError(f"unknown fold_assignment {scheme!r}")


def row_folds(p, frame: Frame, di) -> np.ndarray:
    """Each row's fold: the fold column's distinct values in sorted
    order, else ``fold_assignment`` over ``p.nfolds`` folds with the
    run's seed (the response's codes for the stratified scheme)."""
    if p.fold_column is not None:
        fc = frame.vec(p.fold_column).to_numpy()
        return np.unique(fc, return_inverse=True)[1].reshape(-1)
    y = di.response(frame)[: frame.nrows].cpu().numpy() \
        if di.response_column else None
    return fold_assignment(frame.nrows, p.nfolds, p.fold_assignment,
                           p.effective_seed(), y=y)


def cross_validate(builder, job: Job, frame: Frame, di, valid):
    """N-fold CV: fold models -> holdout predictions -> CV metrics ->
    the final model on all rows (``output["cv_fold_models"]`` holds the
    fold models' keys, ``cv_predictions`` the holdout predictions when
    ``keep_cross_validation_predictions``)."""
    p = builder.params
    folds = row_folds(p, frame, di)
    nfolds = int(folds.max()) + 1
    width = di.nclasses if di.is_classifier else 1
    holdout = np.full((frame.nrows, width), np.nan, dtype=np.float64)
    base_w = np.ones(frame.nrows)
    if p.weights_column is not None:
        base_w = np.nan_to_num(frame.vec(p.weights_column).to_numpy())
    fold_di = dataclasses.replace(di, weights_column=CV_WEIGHTS)

    cv_models = []
    for f in range(nfolds):
        w_f = np.where(folds != f, base_w, 0.0)
        fold_frame = frame.with_vec(CV_WEIGHTS, Vec.from_numpy(
            w_f, T_NUM, device=frame.device))
        fold_builder = type(builder)(dataclasses.replace(
            p, nfolds=0, fold_column=None, weights_column=CV_WEIGHTS))
        m = Job(f"{builder.algo} cv fold {f}").run(
            lambda j: fold_builder._fit(j, fold_frame, fold_di, None))
        cv_models.append(m)
        job.update(0.7 * (f + 1) / nfolds, f"cv fold {f + 1}/{nfolds}")

    X_full = cv_models[0]._score_matrix(frame)
    for f, m in enumerate(cv_models):
        hold = folds == f
        raw = m._predict_raw(X_full)[: frame.nrows].double().cpu().numpy()
        holdout[hold] = raw.reshape(frame.nrows, width)[hold]

    model = builder._fit(job, frame, di, valid)
    raw_pad = np.zeros((frame.padded_rows, width))
    raw_pad[: frame.nrows] = np.nan_to_num(holdout)
    raw_t = torch.as_tensor(raw_pad.squeeze(1) if width == 1 else raw_pad,
                            dtype=torch.float32, device=frame.device)
    model.cross_validation_metrics = make_metrics(
        di, raw_t, di.response(frame), di.weights(frame))
    model.output["cv_fold_models"] = [m.key for m in cv_models]
    if p.keep_cross_validation_predictions:
        model.cv_predictions = holdout
    return model
