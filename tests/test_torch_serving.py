"""h2o3_tpu_torch's serving slice held against the JAX package.

The same inputs, made with numpy from one seed, go through the JAX
function and its port: the traversal (bitwise against ``_traverse_xla``
and the Pallas kernel in interpret mode), the packer (bitwise), models
trained by the JAX package and carried across with ``from_reference``
(to f32 tolerance: the class sum runs in another order and the
``exp``/sigmoid implementations differ), the archive round trip and the
publish -> predict_rows path.  All of it runs on the CPU, where the
port's wrapper takes its plain torch version.
"""

import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from h2o3_tpu import Frame
from h2o3_tpu.export import mojo as jmojo
from h2o3_tpu.export.scoring import ScoringModel as JScoringModel
from h2o3_tpu.models import GBM, DRF, IsolationForest
from h2o3_tpu.serving import batcher as jbatcher
from h2o3_tpu.serving import kernel as jkernel
from h2o3_tpu.serving import pack as jpack

from h2o3_tpu_torch.export.mojo import from_reference, import_mojo
from h2o3_tpu_torch.runtime import observability as obs
from h2o3_tpu_torch.serving import batcher, kernel, pack

# port vs JAX scores: f32 class sums in another order, torch's sigmoid
# and softmax against jnp's 1/(1+exp(-s)) and exp/sum
RTOL, ATOL = 1e-5, 1e-6


def _random_heap_group(rng, T, depth, F, prefix=""):
    """Synthetic heap-layout trees in the archive format (as in
    tests/test_serving.py)."""
    arrays = {f"{prefix}values": rng.normal(size=(T, 2 ** depth))
              .astype(np.float32)}
    for d in range(depth):
        w = 2 ** d
        arrays[f"{prefix}feat_{d}"] = rng.integers(0, F, (T, w))
        arrays[f"{prefix}thr_{d}"] = rng.normal(size=(T, w)) \
            .astype(np.float32)
        arrays[f"{prefix}na_left_{d}"] = rng.integers(0, 2, (T, w)) \
            .astype(bool)
        arrays[f"{prefix}valid_{d}"] = rng.random((T, w)) < 0.8
    return arrays


def _nan_batch(rng, n, F):
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.15] = np.nan
    return X


# ---------------------------------------------------------- (a) traversal

@pytest.mark.parametrize("depth", [0, 3, 6, 9])
def test_traverse_bitwise_vs_xla_and_pallas(depth):
    rng = np.random.default_rng(100 + depth)
    T, F, n = 7, 5, 40
    arrays = _random_heap_group(rng, T, depth, F)
    X = _nan_batch(rng, n, F)
    i32, f32, roots = pack.pack_group(arrays, depth)
    for a, b in zip((i32, f32, roots), jpack.pack_group(arrays, depth)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype

    got = kernel.traverse(torch.from_numpy(i32), torch.from_numpy(f32),
                          torch.from_numpy(roots), torch.from_numpy(X),
                          depth).numpy()
    xla = np.asarray(jkernel._traverse_xla(i32, f32, roots, X, depth))
    pallas = np.asarray(jkernel._make_pallas_traverse(
        depth, T, F, 8, interpret=True)(i32, f32, roots, X))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, pack.traverse(i32, f32, roots, X,
                                                     depth))


def test_pack_ensemble_bitwise_multinomial():
    rng = np.random.default_rng(5)
    depth, F = 4, 6
    arrays = {}
    for k in range(3):
        arrays.update(_random_heap_group(rng, 4, depth, F, f"k{k}_"))
    meta = {"nclass_trees": 3, "depth": depth, "ntrees": 4}
    mine = pack.pack_ensemble(meta, arrays, F)
    ref = jpack.pack_ensemble(meta, arrays, F)
    for f in ("nodes_i32", "nodes_f32", "roots"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert (mine.n_class, mine.ntrees, mine.depth) == (3, 4, depth)


def test_traverse_rejects_bad_operands():
    i32 = torch.zeros(3, dtype=torch.int32)
    f32 = torch.zeros(3)
    roots = torch.zeros(1, dtype=torch.int32)
    X = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="nodes_i32"):
        kernel.traverse(i32.long(), f32, roots, X, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.traverse(i32, f32, roots, torch.zeros(4, 2).t(), 1)
    with pytest.raises(ValueError, match="differ"):
        kernel.traverse(i32, f32[:2], roots, X, 1)


# ------------------------------------------------- (b) carried-over models

def _frames(rng, n=600):
    X = rng.normal(size=(n, 3))
    cat = np.array(["u", "v", "w"], dtype=object)[rng.integers(0, 3, n)]
    y_num = X @ [1.0, -2.0, 0.5] + (cat == "v") * 1.5 \
        + 0.1 * rng.normal(size=n)
    y_bin = np.where(y_num > 0, "yes", "no").astype(object)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "c": cat}
    return cols, y_num, y_bin


def _train(kind):
    """(model, training columns) for one model family, small."""
    rng = np.random.default_rng(42)
    if kind == "gbm_multinomial":
        n = 400
        X = rng.normal(size=(n, 3))
        cls = np.argmax(X + 0.2 * rng.normal(size=(n, 3)), axis=1)
        data = {f"x{j}": X[:, j] for j in range(3)}
        y = np.array(["a", "b", "c"], dtype=object)[cls]
        m = GBM(response_column="y", ntrees=3, max_depth=4, seed=1) \
            .train(Frame.from_numpy({**data, "y": y}))
        return m, data
    if kind == "isolation_forest":
        data = {"a": rng.normal(size=400), "b": rng.normal(size=400)}
        m = IsolationForest(ntrees=6, max_depth=6, seed=2) \
            .train(Frame.from_numpy(data))
        return m, data
    cols, y_num, y_bin = _frames(rng)
    if kind == "gbm_regression":
        fr = Frame.from_numpy({**cols, "y": y_num})
        return GBM(response_column="y", ntrees=4, max_depth=4,
                   seed=1).train(fr), cols
    fr = Frame.from_numpy({**cols, "y": y_bin})
    if kind == "drf":
        return DRF(response_column="y", ntrees=4, seed=1,
                   max_depth=6).train(fr), cols
    assert kind == "gbm_binomial"
    return GBM(response_column="y", ntrees=6, max_depth=5, seed=1) \
        .train(fr), cols


@pytest.fixture(scope="module")
def trained(cl):
    """Lazily trained JAX models, one per family, shared by the module's
    tests (each xdist worker trains only the families it runs)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _train(kind)
        return cache[kind]
    return get


def _na_rows(data, rng, k=40):
    """Row dicts from the training columns, with missing cells."""
    n = len(next(iter(data.values())))
    rows = []
    for i in rng.integers(0, n, k):
        row = {c: (v[i].item() if hasattr(v[i], "item") else v[i])
               for c, v in data.items()}
        for c in rng.choice(list(data), rng.integers(0, 3), replace=False):
            row.pop(c)
        rows.append(row)
    return rows


def _assert_same_predictions(mine, ref):
    if "probabilities" in ref:
        np.testing.assert_allclose(mine["probabilities"],
                                   ref["probabilities"], rtol=RTOL,
                                   atol=ATOL)
        assert (mine["predict"] == ref["predict"]).all()
    else:
        np.testing.assert_allclose(mine["predict"], ref["predict"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gbm_binomial", "gbm_regression",
                                  "gbm_multinomial", "drf",
                                  "isolation_forest"])
def test_carried_model_matches_jax_scorer(trained, kind):
    m, data = trained(kind)
    meta, arrays = jmojo._extract(m)
    ref = jkernel.PackedScorer(JScoringModel(meta, arrays), impl="xla")
    mine = kernel.PackedScorer(from_reference(meta, arrays), device="cpu")
    rows = _na_rows(data, np.random.default_rng(7))
    X = ref.featurize(rows)
    np.testing.assert_array_equal(mine.featurize(rows), X)
    np.testing.assert_allclose(mine.score(X), ref.score(X), rtol=RTOL,
                               atol=ATOL)
    # "check" holds the torch program against the port's numpy walk
    mine.score(X, score_mode="check")
    _assert_same_predictions(mine.predict_rows(rows),
                             ref.predict_rows(rows))
    assert (mine.n_class, mine.ntrees, mine.depth, mine.avg) == \
        (ref.n_class, ref.ntrees, ref.depth, ref.avg)


# --------------------------------------------------- (c) archive round trip

def test_archive_round_trip(trained, tmp_path):
    m, data = trained("gbm_regression")
    path = str(tmp_path / "model.zip")
    jmojo.export_mojo(m, path)
    from_zip = kernel.PackedScorer(import_mojo(path), device="cpu")
    direct = kernel.PackedScorer(from_reference(*jmojo._extract(m)),
                                 device="cpu")
    X = direct.featurize(_na_rows(data, np.random.default_rng(11)))
    np.testing.assert_array_equal(from_zip.score(X), direct.score(X))
    names = [s["name"] for s in direct.meta["datainfo"]["specs"]]
    jax_sm = jmojo.import_mojo(path)
    want = jax_sm.predict({c: X[:, i] for i, c in enumerate(names)})
    np.testing.assert_allclose(from_zip.score(X)[:, 0], want["predict"],
                               rtol=RTOL, atol=ATOL)


def test_import_mojo_rejects_h2o_mojo(tmp_path):
    path = str(tmp_path / "h2o.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("model.ini", "[info]\nalgorithm = gbm\n")
    with pytest.raises(ValueError, match="H2O MOJO"):
        import_mojo(path)


# ------------------------------------------------------- (d) whole slice

def test_publish_predict_rows_matches_jax(trained, tmp_path):
    m, data = trained("gbm_binomial")
    rows = _na_rows(data, np.random.default_rng(13), k=24)
    key = "torch-slice-parity"
    path = str(tmp_path / "model.zip")
    jmojo.export_mojo(m, path)
    try:
        ref = jbatcher.publish(key, m, journal=False).predict_rows(rows)
        ent = batcher.publish(key, from_reference(*jmojo._extract(m)),
                              device="cpu")
        _assert_same_predictions(ent.predict_rows(rows), ref)
        assert batcher.publish(key, None) is ent       # idempotent
        assert batcher.ensure_published(key) is ent
        assert ent.batcher.launches >= 2               # warm-up + a tick
        assert any(e["kind"] == "serve_publish" and e["model"] == key
                   for e in obs.timeline_events())
        # an archive path publishes the same model
        ent2 = batcher.publish(key + "-zip", path, device="cpu")
        _assert_same_predictions(ent2.predict_rows(rows), ref)
    finally:
        jbatcher.unpublish(key)
        batcher.shutdown_all()
    with pytest.raises(KeyError):
        batcher.ensure_published(key)
    assert not batcher.unpublish(key)


# ------------------------------------------------- (e) the port's batcher

@pytest.fixture(scope="module")
def synth_scorer():
    """A port PackedScorer on the CPU over a synthetic binomial export."""
    rng = np.random.default_rng(21)
    F, depth = 6, 5
    meta = {"algo": "gbm", "family": "tree", "tree_average": False,
            "nclass_trees": 1, "ntrees": 9, "depth": depth,
            "link": "identity", "init_score": 0.1,
            "default_threshold": 0.5,
            "datainfo": {"specs": [{"name": f"x{i}", "type": "num"}
                                   for i in range(F)],
                         "response_domain": ["no", "yes"]}}
    sm = from_reference(meta, _random_heap_group(rng, 9, depth, F))
    return kernel.PackedScorer(sm, device="cpu")


def test_score_mode_knob_and_ref(synth_scorer):
    ps = synth_scorer
    X = _nan_batch(np.random.default_rng(3), 16, ps.nfeatures)
    np.testing.assert_allclose(ps.score(X, score_mode="packed"),
                               ps.score(X, score_mode="ref"),
                               rtol=1e-4, atol=1e-5)
    ps.score(X, score_mode="check")
    with pytest.raises(ValueError, match="score_mode"):
        ps.score(X, score_mode="bogus")
    with pytest.raises(NotImplementedError, match="treeshap"):
        ps.ref.predict_contributions({"x0": [0.0]})


def _wait_queued(mb, rows, timeout=10.0):
    """Wait until ``rows`` rows sit in the batcher's queue."""
    t_end = time.monotonic() + timeout
    while mb._queued_rows < rows:
        assert time.monotonic() < t_end, "request never reached the queue"
        time.sleep(0.005)


def test_microbatcher_concurrent_demux(synth_scorer):
    ps = synth_scorer
    X = _nan_batch(np.random.default_rng(1), 64, ps.nfeatures)
    want = ps.score(X)
    mb = batcher.MicroBatcher(ps, max_batch=32, tick_ms=2.0,
                              queue_depth=4096)
    try:
        assert mb.warmup() > 0
        outs = [None] * 16
        errs = []

        def client(i):
            try:
                outs[i] = mb.submit(X[4 * i:4 * i + 4])
            except Exception as e:           # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not errs and not any(t.is_alive() for t in ts)
        np.testing.assert_allclose(np.concatenate(outs), want, rtol=1e-6,
                                   atol=1e-7)
        # wide requests chunk through the same queue
        np.testing.assert_allclose(mb.submit(np.concatenate([X, X])),
                                   np.concatenate([want, want]),
                                   rtol=1e-6, atol=1e-7)
        assert mb.launches >= 1 + 4
    finally:
        mb.close()


def test_microbatcher_queue_overflow(synth_scorer):
    ps = synth_scorer
    mb = batcher.MicroBatcher(ps, max_batch=8, tick_ms=500.0, queue_depth=8)
    X = _nan_batch(np.random.default_rng(2), 8, ps.nfeatures)
    try:
        def fill():
            try:
                mb.submit(X)
            except RuntimeError:
                pass                       # close() errors the leftover

        t = threading.Thread(target=fill, daemon=True)
        t.start()                          # fills the queue for a while
        _wait_queued(mb, 8)
        with pytest.raises(RuntimeError, match="queue full"):
            mb.submit(X)
    finally:
        mb.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_microbatcher_deadline_sheds(synth_scorer):
    ps = synth_scorer
    # the tick lands the first drain well past the 50 ms deadline
    mb = batcher.MicroBatcher(ps, max_batch=8, tick_ms=300.0,
                              queue_depth=64, deadline_ms=50.0)
    try:
        before = obs.counter("serve_rejected_total",
                             reason="deadline").value
        X = _nan_batch(np.random.default_rng(3), 2, ps.nfeatures)
        with pytest.raises(batcher.DeadlineExceeded, match="deadline"):
            mb.submit(X)
        if obs.enabled():
            assert obs.counter("serve_rejected_total",
                               reason="deadline").value > before
        assert mb.launches == 0            # shed, never dispatched
    finally:
        mb.close()


def test_microbatcher_close_sheds_expired_and_errors_waiters(synth_scorer):
    ps = synth_scorer
    X = _nan_batch(np.random.default_rng(4), 2, ps.nfeatures)
    mb = batcher.MicroBatcher(ps, max_batch=8, tick_ms=500.0,
                              queue_depth=64, deadline_ms=30.0)
    errs = []

    def client():
        try:
            mb.submit(X)
        except BaseException as e:           # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    _wait_queued(mb, 2)
    time.sleep(0.05)                         # stale by close time
    mb.close()
    t.join(timeout=10)
    assert len(errs) == 1 and isinstance(errs[0], batcher.DeadlineExceeded)
    with pytest.raises(RuntimeError, match="shut down"):
        mb.submit(X)
