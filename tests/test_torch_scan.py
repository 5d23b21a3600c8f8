"""h2o3_tpu_torch's whole-tree scan program (``tree_program="scan"``)
held against the port's level program and against the JAX package's
scan.

The scan grows the root level, then every deeper level as one
fixed-width program at the deepest level's width W = 2^(D-1)
(``shared._make_scan_build``, ``hist.make_batched_scan_level_fn``); on a
CUDA device a tree is one captured graph replayed once a tree (card
tests in tests/test_torch_cuda.py).  The same numpy inputs from one seed
go through both packages, with the JAX side run as its own
tests/test_tree_scan.py runs it.  All of it runs on the CPU, where the
kernel wrappers take their plain torch versions.

Tolerances: inside the port the scan is bitwise the level program
(every level's arrays, leaf values, covers and the final leaf of every
row), since its histograms are exact integer sums whatever the width.
Against the JAX package, the build-level cases use integer-valued
gradients (every f32 partial sum of the JAX side exact) and compare
every level's valid, feature and NA direction exactly and thresholds
bitwise, leaf values to rtol 1e-5; the trains compare the same way on
frames whose splits clear their runners-up (the JAX side sums in f32
over its 8-device CPU mesh).  The JAX side draws its column masks from
its own keys, so its cases run unsampled; the port's level-parity cases
sample.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import DRF as JDRF
from h2o3_tpu.models import GBM as JGBM
from h2o3_tpu.models import GridSearch as JGridSearch
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models.tree import shared as jshared
from h2o3_tpu.models.tree.gbm import GBMParameters as JGBMParameters

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models import DRF, GridSearch
from h2o3_tpu_torch.models.tree import hist, shared
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMParameters
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.testing import same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

F, N, NBINS = 5, 256, 16


def _problem(seed, K=None):
    """Codes with NA bins, integer-valued gradients, unit h and w, sorted
    edges: numpy, from one seed."""
    rng = np.random.default_rng(seed)
    codes = np.where(rng.random((F, N)) < 0.05, NBINS,
                     rng.integers(0, NBINS, (F, N))).astype(np.int32)
    lead = (K,) if K else ()
    g = rng.integers(-3, 4, (*lead, N)).astype(np.float32)
    edges = np.sort(rng.normal(size=(F, NBINS)), axis=1).astype(np.float32)
    return codes, g, edges


def _port_build(md, prog, codes, g, edges, *, hm="subtract", sm="fused",
                nk=1, min_rows=1.0, rate=1.0, tree_mask=None, seed=3):
    fn = shared.make_build_tree_fn(md, NBINS, F, N, hist_mode=hm,
                                   split_mode=sm, device="cpu", nk=nk,
                                   tree_program=prog)
    gens = [shared.draw_generator(seed, 0, 0, k, "cpu") for k in range(nk)]
    gt = torch.from_numpy(g)
    ones = torch.ones_like(gt)
    return fn(torch.from_numpy(codes), gt, ones, torch.ones(N),
              torch.from_numpy(edges), gens if nk > 1 else gens[0], 0.0,
              min_rows, 1e-5, 0.1, rate, tree_mask, 0.0, 0.0, 0.0)


def _jax_build(md, codes, g, edges, *, hm="subtract", sm="fused", nk=1,
               min_rows=1.0):
    fn = jshared.make_build_tree_fn(md, NBINS, F, N, "f32", hist_mode=hm,
                                    split_mode=sm, nk=nk,
                                    tree_program="scan")
    if nk > 1:
        keys = jax.random.split(jax.random.PRNGKey(11), nk)
        tm = jnp.ones((nk, F), bool)
        h = jnp.ones((nk, N), jnp.float32)
    else:
        keys, tm, h = jax.random.PRNGKey(7), jnp.ones(F, bool), \
            jnp.ones(N, jnp.float32)
    return fn(jnp.asarray(codes), jnp.asarray(g), h,
              jnp.ones(N, jnp.float32), jnp.asarray(edges), keys, 0.0,
              min_rows, 1e-5, 0.1, 1.0, tm, 0.0, 0.0, 0.0)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bitwise(a, b):
    """Two builds' results bitwise: every level's (feat, thr, na_left,
    valid), the leaf values, the covers and the final leaves."""
    assert len(a[0]) == len(b[0])
    for d, (la, lb) in enumerate(zip(a[0], b[0])):
        for name, x, y in zip(("feat", "thr", "na_left", "valid"), la, lb):
            assert x.shape == y.shape, (name, d)
            assert torch.equal(_bits(x), _bits(y)), (name, d)
    for i, name in ((1, "values"), (2, "cover"), (3, "leaf")):
        assert torch.equal(_bits(a[i]), _bits(b[i])), name


def _assert_matches_jax(port, jx, K=None):
    """Port and JAX builds: valid, feature and NA direction equal, the
    thresholds bitwise, leaf values to rtol 1e-5 (leading K if given)."""
    for d, (lp, lj) in enumerate(zip(port[0], jx[0])):
        for i, name in ((3, "valid"), (0, "feat"), (2, "na_left")):
            np.testing.assert_array_equal(lp[i].numpy(), np.asarray(lj[i]),
                                          err_msg=f"{name} level {d}")
        np.testing.assert_array_equal(lp[1].numpy().view(np.int32),
                                      np.asarray(lj[1]).view(np.int32),
                                      err_msg=f"thr level {d}")
    np.testing.assert_allclose(port[1].numpy(), np.asarray(jx[1]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(jx[3]))


# ------------------------------------------------- (a) the build, bitwise

@pytest.mark.parametrize("hm", ["subtract", "full"])
@pytest.mark.parametrize("sm", ["separate", "fused"])
def test_scan_bitwise_level_and_matches_jax(cl, hm, sm):
    """Depth 4, both hist and split modes: the port's scan is bitwise its
    level program with per-split column sampling on (rate 0.8, a tree
    mask), and matches the JAX package's scan unsampled."""
    codes, g, edges = _problem(1)
    tm = torch.ones(F, dtype=torch.bool)
    tm[2] = False
    kw = dict(hm=hm, sm=sm, rate=0.8, tree_mask=tm)
    _assert_bitwise(_port_build(4, "level", codes, g, edges, **kw),
                    _port_build(4, "scan", codes, g, edges, **kw))
    port = _port_build(4, "scan", codes, g, edges, hm=hm, sm=sm)
    _assert_bitwise(port, _port_build(4, "level", codes, g, edges, hm=hm,
                                      sm=sm))
    # the JAX scan with its fused records (one compile per hist mode):
    # its split modes agree bitwise on these integer-valued histograms
    _assert_matches_jax(port, _jax_build(4, codes, g, edges, hm=hm))


def test_scan_early_exit_bitwise(cl):
    """min_rows so large that nothing below level 1 splits: the carried
    ``dead`` predicate skips the histogram and the partition at levels 2
    and 3, and the tree is bitwise the level program's and matches the
    JAX scan's."""
    codes, g, edges = _problem(2)
    kw = dict(min_rows=100.0)
    port = _port_build(4, "scan", codes, g, edges, **kw)
    assert bool(port[0][0][3].any())              # the root splits
    assert not any(bool(lv[3].any()) for lv in port[0][2:])
    _assert_bitwise(_port_build(4, "level", codes, g, edges, **kw), port)
    _assert_matches_jax(port, _jax_build(4, codes, g, edges, **kw))


@pytest.mark.parametrize("hm", ["subtract", "full"])
def test_scan_batched_k_bitwise_level_and_matches_jax(cl, hm):
    """K = 3 trees in one batched build: bitwise the batched level build
    with sampling on (each tree its own generator) and unsampled, and the
    JAX batched scan (its subtraction program; the full rebuild is held
    against it at K = 1) unsampled."""
    codes, g, edges = _problem(4, K=3)
    tm = torch.ones((3, F), dtype=torch.bool)
    tm[1, 0] = False
    kw = dict(hm=hm, nk=3, rate=0.7, tree_mask=tm)
    _assert_bitwise(_port_build(4, "level", codes, g, edges, **kw),
                    _port_build(4, "scan", codes, g, edges, **kw))
    port = _port_build(4, "scan", codes, g, edges, hm=hm, nk=3)
    _assert_bitwise(port, _port_build(4, "level", codes, g, edges, hm=hm,
                                      nk=3))
    _assert_matches_jax(port, _jax_build(4, codes, g, edges, nk=3))


def test_scan_level_fn_padded_slots_inert_and_dead_passthrough():
    """``make_batched_scan_level_fn`` at W = 8 on a level of 4 live
    children: its first 4 slots are bitwise ``make_batched_level_fn``'s
    level 2, the padded ones exact zeros; with every row on an even
    child, the ``dead`` passthrough is bitwise the compaction's result."""
    codes, g, _ = _problem(5, K=2)
    rng = np.random.default_rng(5)
    ct = torch.from_numpy(codes)
    stats = torch.stack([torch.from_numpy(g), torch.ones(2, N),
                         torch.ones(2, N)], dim=1)
    scale = hist.stat_scale(stats)
    B = NBINS + 1
    leaf1 = torch.from_numpy(rng.integers(0, 2, (2, N)).astype(np.int32))
    H1, _ = hist.make_batched_level_fn(1, 2, F, B)(
        ct, leaf1, stats, hist.local_hist(ct, torch.zeros_like(leaf1),
                                          stats, 1, F, B, None, scale),
        scale)
    leaf2 = (2 * leaf1 + torch.from_numpy(
        rng.integers(0, 2, (2, N)).astype(np.int32))).to(torch.int32)
    H2, _ = hist.make_batched_level_fn(2, 2, F, B)(ct, leaf2, stats, H1,
                                                   scale)
    lev = hist.make_batched_scan_level_fn(8, 2, F, B)
    carry = torch.nn.functional.pad(H1, (0, 0, 0, 0, 0, 2))
    Hs, nxt = lev(ct, leaf2, stats, carry, scale, torch.tensor(False))
    assert same_bits(Hs[:, :, :4], H2)
    assert not bool(Hs[:, :, 4:].any())
    assert nxt.shape == (2, 3, 4, F, B) and same_bits(nxt, Hs[:, :, :4])
    even = (2 * leaf1).to(torch.int32)
    live, _ = lev(ct, even, stats, carry, scale, torch.tensor(False))
    skip, _ = lev(ct, even, stats, carry, scale, torch.tensor(True))
    assert same_bits(live, skip)
    one, _ = hist.make_scan_level_fn(8, F, B)(ct, leaf2[1], stats[1],
                                              carry[1], scale[1])
    assert same_bits(one, Hs[1])                  # the one-tree form


def test_scan_grows_two_histogram_geometries_at_any_depth(monkeypatch):
    """One fixed-width program below the root: the scan's histograms take
    two leaf counts (the root's 1 and W/2) at depths 3, 4 and 6, while the
    level program's grow one per level; both launch one histogram and one
    records call a level."""
    codes, g, edges = _problem(6)
    seen = []
    real = hist.hist_uniform

    def spy(codes, leaf, stats, L, *a, **kw):
        seen.append(L)
        return real(codes, leaf, stats, L, *a, **kw)
    monkeypatch.setattr(hist, "hist_uniform", spy)
    for md in (3, 4, 6):
        for prog in ("scan", "level"):
            seen.clear()
            _port_build(md, prog, codes, g, edges)
            assert len(seen) == md
            want = {1, 2 ** (md - 2)} if prog == "scan" else \
                {2 ** max(d - 1, 0) for d in range(md)}
            assert set(seen) == want, (md, prog, seen)


# ------------------------------------------------------ (b) the crosscheck

def test_program_crosscheck_runs_clean_and_catches_a_fault(monkeypatch):
    """``run_program_crosscheck`` passes on a clean build (one tree and a
    K = 2 round) and raises on a scan that differs from the level build
    by one leaf value's last bit: it compares bitwise."""
    codes, g, edges = _problem(7)
    args = (torch.from_numpy(codes), torch.from_numpy(g), torch.ones(N),
            torch.ones(N), torch.from_numpy(edges), 3)
    kw = dict(max_depth=4, nbins=NBINS, F=F, n_padded=N, learn_rate=0.1)
    shared.run_program_crosscheck(*args, **kw)
    gk = torch.from_numpy(_problem(8, K=2)[1])
    shared.run_program_crosscheck(args[0], gk, torch.ones(2, N), args[3],
                                  args[4], 3, nk=2, **kw)
    real = shared._make_scan_build

    def faulty(*a, **k):
        build = real(*a, **k)

        def wrong(*args, **kws):
            levels, vals, cover, leaf = build(*args, **kws)
            v = vals.clone()
            v.view(torch.int32)[0] += 1
            return levels, v, cover, leaf
        wrong.max_depth = build.max_depth
        return wrong
    monkeypatch.setattr(shared, "_make_scan_build", faulty)
    with pytest.raises(AssertionError, match="leaf values"):
        shared.run_program_crosscheck(*args, **kw)


# ------------------------------------------------ (c) refusals, downgrades

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_scan_refusals(cl, pkg):
    """An explicit "scan" raises the same ValueError in both packages:
    monotone constraints, the hierarchical search, effective depth 1,
    engaged node-sparse levels, an unknown program."""
    Params, resolve = (GBMParameters, shared.resolve_tree_program) \
        if pkg == "port" else (JGBMParameters, jshared.resolve_tree_program)
    p = Params(response_column="y", tree_program="scan", max_depth=5)
    with pytest.raises(ValueError, match="mono"):
        resolve(p, mono=(1.0,))
    with pytest.raises(ValueError, match="hier"):
        resolve(p, hier=True)
    with pytest.raises(ValueError, match="depth"):
        resolve(Params(response_column="y", tree_program="scan",
                       max_depth=1))
    deep = Params(response_column="y", tree_program="scan", max_depth=12,
                  sparse_depth_threshold=3)
    with pytest.raises(ValueError, match="sparse"):
        resolve(deep, hist_layout="sparse")
    with pytest.raises(ValueError, match="tree_program"):
        resolve(Params(response_column="y", tree_program="bogus"))
    assert resolve(p) == "scan"


def test_check_and_auto_downgrade_as_the_jax_package(cl):
    """"check" resolves to "level" wherever the scan cannot grow the
    build (and where the packed histogram engages: on a CUDA device), to
    "check" elsewhere; "auto" is "level"; both packages alike on the
    shapes they share."""
    cases = [(dict(tree_program="check", max_depth=12,
                   sparse_depth_threshold=3), dict(hist_layout="sparse"),
              "level"),
             (dict(tree_program="check", max_depth=5),
              dict(mono=(1.0,)), "level"),
             (dict(tree_program="check", max_depth=1), {}, "level"),
             (dict(tree_program="check", max_depth=5), {}, "check"),
             (dict(max_depth=5), {}, "level")]
    for prm, kw, want in cases:
        for Params, resolve in ((GBMParameters, shared.resolve_tree_program),
                                (JGBMParameters,
                                 jshared.resolve_tree_program)):
            got = resolve(Params(response_column="y", **prm), **kw)
            assert got == want, (prm, kw, got)
    p = GBMParameters(response_column="y", tree_program="check",
                      max_depth=6, nbins=256)
    bc = (12, 7, 256, 256, 22)
    assert shared.resolve_tree_program(p, bin_counts=bc, F=5,
                                       n_padded=4096, device="cuda") \
        == "level"
    assert shared.resolve_tree_program(p, bin_counts=bc, F=5,
                                       n_padded=4096, device="cpu") \
        == "check"


def test_build_fn_rejects_what_the_scan_cannot_grow():
    with pytest.raises(ValueError, match="sparse"):
        shared.make_build_tree_fn(10, 16, 5, 4096, hist_layout="sparse",
                                  sparse_depth_threshold=2, device="cpu",
                                  tree_program="scan")
    with pytest.raises(ValueError, match="depth"):
        shared.make_build_tree_fn(1, 16, 5, 256, device="cpu",
                                  tree_program="scan")
    with pytest.raises(ValueError, match="monotone"):
        shared.make_build_tree_fn(4, 16, 5, 256, device="cpu",
                                  split_mode="separate", mono=(1.0,) * 5,
                                  tree_program="scan")
    with pytest.raises(ValueError, match="tree_program"):
        shared.make_build_tree_fn(4, 16, 5, 256, device="cpu",
                                  tree_program="check")


# ------------------------------------------------------------ (d) trains

def _reg_cols(n=400, seed=0):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 5))
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * r.normal(size=n)
    cols = {f"x{j}": X[:, j] for j in range(5)}
    cols["y"] = y
    return cols


def _multi_cols(n=400, seed=1):
    r = np.random.default_rng(seed)
    centers = np.array([[2, 0], [-2, 1], [0, -2]])
    labels = r.integers(0, 3, n)
    X = centers[labels] + r.normal(size=(n, 2))
    return {"x0": X[:, 0], "x1": X[:, 1],
            "y": np.array(["a", "b", "c"], dtype=object)[labels]}


def _frames(cols, key):
    return (JFrame.from_numpy(cols, key=key),
            Frame.from_numpy(cols, device="cpu"))


def _class_trees(m):
    K = m.output.get("nclass_trees", 1)
    for t, r in enumerate(m.output["trees"]):
        for k, tree in enumerate(r if K > 1 else [r]):
            yield t, k, tree


def _assert_trains_match_jax(jm, tm):
    """Every tree of both trains: the same valid, feature and NA
    direction, thresholds bitwise, leaf values to rtol 1e-5."""
    jt, tt = list(_class_trees(jm)), list(_class_trees(tm))
    assert len(jt) == len(tt) > 0
    for (t, k, a), (_, _, b) in zip(jt, tt):
        for d in range(len(b.feat)):
            msg = f"round {t} class {k} level {d}"
            for name in ("valid", "feat", "na_left"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {msg}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].numpy().view(np.int32), err_msg=f"thr {msg}")
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{t} {k}")


def _stacks(m):
    st = m.output["stacked"]
    return st if isinstance(st, list) else [st]


def _assert_same_model(a, b):
    """Bitwise the same trees (every level's fields of every class) and
    leaf values."""
    for sa, sb in zip(_stacks(a), _stacks(b)):
        assert (sa.ntrees, sa.depth) == (sb.ntrees, sb.depth)
        for la, lb in zip(sa.levels, sb.levels):
            for x, y in zip(la, lb):
                assert torch.equal(_bits(x), _bits(y))
        assert same_bits(sa.values, sb.values)
        assert same_bits(sa.covers, sb.covers)


_KW = dict(response_column="y", ntrees=4, max_depth=4, nbins=16, seed=7)


def test_gbm_scan_and_check(cl):
    """A gaussian GBM under "scan" and "check": bitwise the level train
    (and the model reports its program), and matches the JAX package's
    scan train."""
    jfr, fr = _frames(_reg_cols(), "torch_scan_reg")
    m_lv = GBM(**_KW, tree_program="level", device="cpu").train(fr)
    m_sc = GBM(**_KW, tree_program="scan", device="cpu").train(fr)
    m_ck = GBM(**_KW, tree_program="check", device="cpu").train(fr)
    _assert_same_model(m_lv, m_sc)
    _assert_same_model(m_lv, m_ck)
    assert (m_lv.output["tree_program"], m_sc.output["tree_program"],
            m_ck.output["tree_program"]) == ("level", "scan", "scan")
    jm = JGBM(**_KW, tree_program="scan").train(jfr)
    _assert_trains_match_jax(jm, m_sc)


def test_multinomial_scan_batched_and_k_loop(cl):
    """A 3-class GBM under "scan": the batched round and the K loop of
    single scans (split_mode="separate") are bitwise the level train, and
    match the JAX package's scan train."""
    jfr, fr = _frames(_multi_cols(), "torch_scan_multi")
    kw = dict(_KW, ntrees=3, max_depth=3)
    m_lv = GBM(**kw, device="cpu").train(fr)
    m_sc = GBM(**kw, tree_program="scan", device="cpu").train(fr)
    m_sep = GBM(**kw, tree_program="scan", split_mode="separate",
                device="cpu").train(fr)
    assert m_sc.output["nclass_trees"] == 3
    _assert_same_model(m_lv, m_sc)
    _assert_same_model(m_lv, m_sep)
    jm = JGBM(**kw, tree_program="scan").train(jfr)
    _assert_trains_match_jax(jm, m_sc)


def test_dart_scan(cl):
    """XGBoost's DART booster under "scan" (the round grown at learn rate
    1, rescaled after): bitwise its level train, sampled too, and the
    JAX package's unsampled scan train."""
    jfr, fr = _frames(_reg_cols(seed=3), "torch_scan_dart")
    kw = dict(_KW, booster="dart", rate_drop=0.3, one_drop=True)
    m_sc = XGBoost(**kw, tree_program="scan", device="cpu").train(fr)
    _assert_same_model(XGBoost(**kw, device="cpu").train(fr), m_sc)
    smp = dict(kw, sample_rate=0.8, col_sample_rate=0.7)
    _assert_same_model(XGBoost(**smp, device="cpu").train(fr),
                       XGBoost(**smp, tree_program="scan",
                               device="cpu").train(fr))
    jm = JXGBoost(**kw, tree_program="scan").train(jfr)
    _assert_trains_match_jax(jm, m_sc)


def test_dense_drf_scan(cl):
    """A forest on the dense layout under "scan": bitwise its level
    train with its bootstrap and mtries sampling, and the JAX package's
    unsampled scan forest (every feature, every row)."""
    jfr, fr = _frames(_reg_cols(seed=5), "torch_scan_drf")
    kw = dict(_KW, hist_layout="dense", max_depth=5)
    _assert_same_model(DRF(**kw, device="cpu").train(fr),
                       DRF(**kw, tree_program="scan", device="cpu")
                       .train(fr))
    full = dict(kw, sample_rate=1.0, mtries=-2)
    m_sc = DRF(**full, tree_program="scan", device="cpu").train(fr)
    _assert_same_model(DRF(**full, device="cpu").train(fr), m_sc)
    assert m_sc.output["tree_program"] == "scan"
    jm = JDRF(**full, tree_program="scan").train(jfr)
    _assert_trains_match_jax(jm, m_sc)
    with pytest.raises(ValueError, match="sparse"):
        DRF(response_column="y", ntrees=1, tree_program="scan",
            device="cpu").train(fr)


def test_cohort_scan(cl):
    """A G = 3 grid cohort under "scan": each member bitwise its level
    cohort's and its sequential scan train's, the program reported, and
    the JAX package's scan cohort matched."""
    jfr, fr = _frames(_reg_cols(seed=6), "torch_scan_grid")
    hp = {"learn_rate": [0.05, 0.1, 0.3]}
    kw = dict(_KW, ntrees=3)

    def grid(prog, batch):
        g = GridSearch(GBM, hp, grid_batch=batch, tree_program=prog,
                       device="cpu", **kw).train(fr)
        return {m.params.learn_rate: m for m in g.models}
    sc, lv, seq = grid("scan", "on"), grid("level", "on"), grid("scan", "off")
    assert len(sc) == 3
    for lr, m in sc.items():
        assert m.output["grid_cohort"]["size"] == 3
        assert m.output["tree_program"] == "scan"
        _assert_same_model(m, lv[lr])
        _assert_same_model(m, seq[lr])
    jg = JGridSearch(JGBM, hp, grid_batch="on", tree_program="scan",
                     **kw).train(jfr)
    for jm in jg.models:
        assert jm.output["tree_program"] == "scan"
        _assert_trains_match_jax(jm, sc[jm.params.learn_rate])
