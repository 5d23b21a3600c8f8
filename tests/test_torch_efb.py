"""h2o3_tpu_torch's exclusive feature bundling (EFB) held against the JAX
package.

The same numpy inputs from one seed go through the JAX function and its
port: the bundle plan and the working codes of a one-hot-wide frame (the
JAX package's ``tests/test_efb.py::_onehot_frame``), the mixed split
search (the raw features through the records kernel, the bundled members'
scans) and the ranged partition, and GBM, DRF and DecisionTree trained by
both packages with ``efb="auto"``.  All of it runs on the CPU, where the
kernel wrappers take their plain torch versions.

Tolerances.  The plan and the working codes are bitwise (on the real
rows: the two packages pad to other lengths); the mixed search and the
partition are bitwise on an integer-valued histogram (every partial sum
exact, the trick of tests/test_mesh_hier.py).  Trained trees have the
same (feature, threshold, NA direction, valid) on every level (the
frame's signal leaves no near-tied gains), leaf values agree to rtol
1e-5 and predictions to rtol 1e-4 (f32 sums in another order); a bundled
GBM predicts within 1e-4 of its unbundled train, as the JAX package
holds its own (tests/test_efb.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import DRF as JDRF
from h2o3_tpu.models import GBM as JGBM
from h2o3_tpu.models.tree import binning as jbin
from h2o3_tpu.models.tree import efb as jefb
from h2o3_tpu.models.tree import hist as jhist
from h2o3_tpu.models.tree.dt import DecisionTree as JDT

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DRF, DecisionTree, GridSearch
from h2o3_tpu_torch.models.tree import binning, efb, hist, shared
from h2o3_tpu_torch.models.tree.gbm import GBM

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)


def _int_hist(rng, L, F, B):
    """Integer-valued H [3, L, F, B] with a populated NA bin."""
    g = rng.integers(-4, 5, (L, F, B))
    h = rng.integers(0, 4, (L, F, B))
    c = rng.integers(0, 4, (L, F, B))
    return np.stack([g, h, c]).astype(np.float32)


def _same_trees(ja, tb, depth, rtol=1e-5):
    jt, tt = list(ja.output["trees"]), list(tb.output["trees"])
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        for d in range(depth):
            for name in ("feat", "na_left", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {d}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].numpy().view(np.int32))
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=rtol, atol=1e-6)


def _col(m, fr, name):
    return np.asarray(m.predict(fr).vec(name).to_numpy())


def _onehot_cols(n=2000, groups=4, levels=10, seed=3):
    """The JAX package's ``tests/test_efb.py::_onehot_frame``: one-hot
    expanded categoricals (exclusive within a group) and two numerics."""
    rng = np.random.default_rng(seed)
    cols, gidx = {}, []
    for g in range(groups):
        z = rng.integers(0, levels, n)
        gidx.append(z)
        for lv in range(levels):
            cols[f"g{g}_l{lv}"] = (z == lv).astype(np.float64)
    for j in range(2):
        cols[f"num{j}"] = rng.normal(size=n)
    cols["y"] = (gidx[0] % 3 == 0) * 2.0 + 0.5 * (gidx[1] % 2) \
        + cols["num0"] * 0.3 + 0.05 * rng.normal(size=n)
    cols["yb"] = np.where(cols["y"] > 1.0, "a", "b").astype(object)
    return cols


@pytest.fixture(scope="module")
def efb_frames():
    cols = _onehot_cols()
    return cols, JFrame.from_numpy(cols), Frame.from_numpy(cols,
                                                           device="cpu")


def _jax_bundles(jfr, cols, nbins=32):
    """The bundle count of the JAX package's plan of the frame (its DRF
    and DT do not record one)."""
    feats = [c for c in cols if c not in ("y", "yb")]
    jb = jbin.fit_bins(jfr, feats, nbins=nbins)
    plan = jefb.plan_bundles(jb.codes, jb.bin_counts, jb.nbins, jfr.nrows)
    return sum(1 for w in plan.working if w[0] == "bundle")


def test_plan_and_working_codes_bitwise_jax(efb_frames):
    cols, jfr, fr = efb_frames
    feats = [c for c in cols if c not in ("y", "yb")]
    jb = jbin.fit_bins(jfr, feats, nbins=32)
    tb = binning.fit_bins(fr, feats, nbins=32)
    n = fr.nrows
    jplan = jefb.plan_bundles(jb.codes, jb.bin_counts, jb.nbins, n)
    tplan = efb.plan_bundles(tb.codes, tb.bin_counts, tb.nbins, n)
    assert jplan is not None and tuple(tplan) == tuple(jplan)
    assert shared.efb_bundles(tplan) >= 1
    np.testing.assert_array_equal(
        efb.apply_bundles(tb.codes, tplan, tb.nbins).numpy()[:, :n],
        np.asarray(jefb.apply_bundles(jb.codes, jplan))[:, :n])
    for k, v in efb.efb_maps(tplan, 33).items():
        np.testing.assert_array_equal(v, jefb.efb_maps(jplan, 33)[k])
    # a dense frame, and the efb="off" knob, bundle nothing
    rng = np.random.default_rng(0)
    dense = Frame.from_numpy({f"x{j}": rng.normal(size=600)
                              for j in range(40)}, device="cpu")
    db = binning.fit_bins(dense, list(dense.names), nbins=32)
    assert efb.plan_bundles(db.codes, db.bin_counts, 32, 600) is None
    assert shared.maybe_bundle(tb, shared.SharedTreeParameters(efb="off"),
                               None, n)[0] is None
    assert shared.maybe_bundle(tb, shared.SharedTreeParameters(),
                               (1.0,) * len(feats), n)[0] is None


def test_mixed_search_and_ranged_partition_bitwise(efb_frames):
    """``best_splits_mixed`` on an integer-valued working histogram (with
    a feature mask) and ``partition_ranged`` on its records are bitwise
    the JAX package's."""
    cols, jfr, fr = efb_frames
    feats = [c for c in cols if c not in ("y", "yb")]
    tb = binning.fit_bins(fr, feats, nbins=32)
    plan = efb.plan_bundles(tb.codes, tb.bin_counts, 32, fr.nrows)
    jplan = jefb.BundlePlan(*plan)
    rng = np.random.default_rng(9)
    L = 4
    H = _int_hist(rng, L, plan.n_working, 33)
    mask = rng.random((L, plan.n_working)) < 0.8
    args = (1.0, 1.0, 1e-5)
    mixed = jax.jit(jefb.best_splits_mixed,
                    static_argnames=("nbins", "plan"))
    want = mixed(jnp.asarray(H), nbins=32, plan=jplan, reg_lambda=1.0,
                 min_rows=1.0, min_split_improvement=1e-5,
                 feat_mask=jnp.asarray(mask))
    got = efb.best_splits_mixed(torch.from_numpy(H), 32, plan, *args,
                                torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    wc = efb.apply_bundles(tb.codes, plan, 32)
    leaf = torch.from_numpy(rng.integers(0, L, wc.shape[1]).astype(np.int32))
    feat, _, na_left, _, valid, _, wfeat, lo, hi, inv = got
    a = hist.partition_ranged(wc, leaf, wfeat, lo, hi, inv, na_left, valid,
                              32)
    b = jhist.partition_ranged(jnp.asarray(wc.numpy()),
                               jnp.asarray(leaf.numpy()),
                               *(jnp.asarray(x.numpy()) for x in
                                 (wfeat, lo, hi, inv, na_left, valid)),
                               jnp.int32(32))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a prefix split (lo = bin, hi = nbins, inv off) is the plain rule
    bins = torch.from_numpy(rng.integers(0, 31, L).astype(np.int32))
    np.testing.assert_array_equal(
        hist.partition_ranged(wc, leaf, wfeat, bins,
                              torch.full((L,), 32, dtype=torch.int32),
                              torch.zeros(L, dtype=torch.bool), na_left,
                              valid, 32).numpy(),
        hist.partition(wc, leaf, wfeat, bins, na_left, valid, 32).numpy())


_EFB = dict(ntrees=3, max_depth=2, nbins=32, seed=3,
            score_tree_interval=10 ** 9)


@pytest.mark.parametrize("algo", ["gbm", "drf", "dt"])
def test_bundled_trains_match_jax(efb_frames, algo):
    """GBM, DRF (one unsampled tree over every feature: the shape of DT,
    so that the JAX package compiles one program for both) and DT with
    efb="auto" in both packages: the same bundles, the dense layout, the
    same trees (original features) and predictions; GBM also within 1e-4
    of its unbundled train."""
    cols, jfr, fr = efb_frames
    cfg = dict(_EFB, response_column="y", ignored_columns=["yb"])
    if algo != "gbm":
        cfg.update(ntrees=1, sample_rate=1.0, mtries=-2, min_rows=10)
    pair = {"gbm": (JGBM, GBM), "drf": (JDRF, DRF),
            "dt": (JDT, DecisionTree)}[algo]
    jm = pair[0](**cfg).train(jfr)
    tm = pair[1](device="cpu", **cfg).train(fr)
    assert tm.output["efb_bundles"] == _jax_bundles(jfr, cols) >= 1
    if algo == "gbm":
        assert jm.output["efb_bundles"] == tm.output["efb_bundles"]
    assert tm.output["hist_layout"] == "dense"
    _same_trees(jm, tm, 2)
    np.testing.assert_allclose(_col(tm, fr, "predict"),
                               _col(jm, jfr, "predict"), rtol=1e-4,
                               atol=1e-6)
    if algo == "gbm":
        off = GBM(device="cpu", efb="off", **cfg).train(fr)
        assert "efb_bundles" not in off.output
        assert np.abs(_col(tm, fr, "predict")
                      - _col(off, fr, "predict")).max() < 1e-4


def test_bundled_forest_on_working_features(efb_frames):
    """DRF at its defaults (one tree) on a bundled frame: the dense
    layout and its depth cap, mtries resolved against the working
    features; a 3-class forest trains bundled too (its class trees as a
    loop of single builds)."""
    cols, _, fr = efb_frames
    m = DRF(response_column="yb", ignored_columns=["y"], ntrees=1,
            nbins=32, seed=1, device="cpu").train(fr)
    assert m.output["efb_bundles"] >= 1
    assert m.output["hist_layout"] == "dense"
    feats = [c for c in cols if c not in ("y", "yb")]
    tb = binning.fit_bins(fr, feats, nbins=32)
    Fw = efb.plan_bundles(tb.codes, tb.bin_counts, 32, fr.nrows).n_working
    assert DRF()._col_rate(Fw, True) == int(np.sqrt(Fw)) / Fw
    assert m.output["effective_max_depth"] == shared.effective_max_depth(
        20, 32, Fw, fr.padded_rows, "dense")
    rng = np.random.default_rng(4)
    c3 = dict(cols, k=np.asarray(["a", "b", "c"], object)[
        rng.integers(0, 3, fr.nrows)])
    fr3 = Frame.from_numpy(c3, device="cpu")
    m3 = DRF(response_column="k", ignored_columns=["y", "yb"], ntrees=1,
             max_depth=3, nbins=32, seed=1, device="cpu").train(fr3)
    assert m3.output["efb_bundles"] == m.output["efb_bundles"]
    assert m3.output["nclass_trees"] == 3
    assert np.isfinite(_col(m3, fr3, "a")).all()


def test_grid_cohort_falls_back_when_bundling_engages(efb_frames):
    """A grid whose members' frame bundles takes the wave path, with the
    JAX package's reason."""
    from h2o3_tpu_torch.models.tree import grid_batch as gb
    cols, _, fr = efb_frames
    base = dict(_EFB, response_column="y", ignored_columns=["yb"],
                device="cpu")
    combos = [{"learn_rate": 0.1}, {"learn_rate": 0.2}]
    with pytest.raises(gb.CohortFallback, match="EFB bundling engaged"):
        gb.train_cohort(GBM, base, combos, fr)
    g = GridSearch(GBM, {"learn_rate": [0.1, 0.2]}, grid_batch="on",
                   **base).train(fr)
    assert len(g.models) == 2
    assert all(m.output.get("grid_cohort") is None
               and m.output["efb_bundles"] >= 1 for m in g.models)
