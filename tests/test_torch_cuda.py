"""The port's CUDA kernels (traversal, level histograms, split records,
the fine histogram of the hierarchical search) against their plain torch
versions, and small trains against the CPU plain route, on the card.
Every test here needs a CUDA device and nvcc; without them it skips.  On
a CUDA machine run them with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py boots the JAX package's CPU mesh,
which these tests do not use.)
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.serving import kernel, pack

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (the CPU paths are tests/test_torch_serving.py "
                    "and tests/test_torch_training.py)")
    return torch.device("cuda")


def _planes(rng, T, depth, F, dev):
    arrays = {"values": rng.normal(size=(T, 2 ** depth)).astype(np.float32)}
    for d in range(depth):
        w = 2 ** d
        arrays[f"feat_{d}"] = rng.integers(0, F, (T, w))
        arrays[f"thr_{d}"] = rng.normal(size=(T, w)).astype(np.float32)
        arrays[f"na_left_{d}"] = rng.integers(0, 2, (T, w)).astype(bool)
        arrays[f"valid_{d}"] = rng.random((T, w)) < 0.8
    return [torch.from_numpy(a).to(dev)
            for a in pack.pack_group(arrays, depth)]


@pytest.mark.parametrize("depth,T,F,B", [(0, 3, 4, 5), (3, 33, 7, 9),
                                         (6, 64, 40, 256), (10, 300, 32, 37),
                                         (12, 5, 1023, 17)])
def test_kernel_bitwise_equals_plain(cuda, depth, T, F, B):
    rng = np.random.default_rng(depth * 1000 + T)
    i32, f32, roots = _planes(rng, T, depth, F, cuda)
    X = rng.normal(size=(B, F)).astype(np.float32)
    X[rng.random((B, F)) < 0.1] = np.nan
    Xd = torch.from_numpy(X).to(cuda)
    before = kernel.TRAVERSE.launches
    got = kernel.traverse(i32, f32, roots, Xd, depth)
    want = kernel.traverse_torch(i32, f32, roots, Xd, depth)
    torch.cuda.synchronize()
    assert kernel.TRAVERSE.launches == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(), pack.traverse(i32.cpu().numpy(),
                                         f32.cpu().numpy(),
                                         roots.cpu().numpy(), X, depth))


def test_kernel_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(1)
    i32, f32, roots = _planes(rng, 2, 2, 3, cuda)
    with pytest.raises(ValueError, match="X on"):
        kernel.traverse(i32, f32, roots, torch.zeros(4, 3), 2)


# ------------------------------------------------- training kernels

from h2o3_tpu_torch.models.tree import hist  # noqa: E402


def _hist_inputs(rng, F, nbins, L, n, nan_share, integer, dev):
    """Codes of mixed cardinality (NA = nbins), leaves in [0, L) with some
    -1 rows, and (g, h, w) stats: small integers or real values."""
    bin_counts = tuple(int(b) for b in
                       rng.integers(2, nbins + 1, F))
    codes = np.stack([np.where(rng.random(n) < nan_share, nbins,
                               rng.integers(0, bc, n))
                      for bc in bin_counts]).astype(np.int32)
    leaf = rng.integers(-1, L, n).astype(np.int32)
    if integer:
        st = np.stack([rng.integers(-3, 4, n), rng.integers(0, 3, n),
                       rng.integers(0, 2, n)]).astype(np.float32)
    else:
        p = rng.random(n).astype(np.float32)
        st = np.stack([p - (rng.random(n) < 0.3), p * (1 - p),
                       np.ones(n)]).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (codes, leaf, st)]
    return bin_counts, t[0], t[1], t[2]


def _assert_bitwise(got, *wants):
    """The histograms sum in int64 fixed point, exactly: a kernel launch
    equals its plain version (on the card and on the CPU) and a second
    launch bit for bit, on integer-valued and on real stats alike."""
    for want in wants:
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.cpu().numpy().view(np.int32))


def _cpu(*ts):
    return [t.cpu() for t in ts]


_HIST_CASES = [(8, 256, 1, 1_000_003), (8, 256, 32, 500_001),
               (3, 17, 4, 1_001), (5, 64, 8, 77_777), (11, 1024, 2, 20_000),
               (2, 256, 64, 100_000)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("F,nbins,L,n", _HIST_CASES)
def test_hist_uniform_equals_plain(cuda, F, nbins, L, n, integer):
    rng = np.random.default_rng(F * 7 + L + n % 97)
    _, codes, leaf, st = _hist_inputs(rng, F, nbins, L, n, 0.05, integer,
                                      cuda)
    before = hist.HIST.launches
    got = hist.hist_uniform(codes, leaf, st, L, nbins + 1)
    again = hist.hist_uniform(codes, leaf, st, L, nbins + 1)
    want = hist.hist_uniform_torch(codes, leaf, st, L, nbins + 1)
    cpu = hist.hist_uniform_torch(*_cpu(codes, leaf, st), L, nbins + 1)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 2
    assert got.shape == (3, L, F, nbins + 1)
    _assert_bitwise(got, want, again, cpu)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("F,nbins,L,n", _HIST_CASES)
def test_hist_varbin_equals_plain(cuda, F, nbins, L, n, integer):
    rng = np.random.default_rng(F * 11 + L + n % 89)
    bc, codes, leaf, st = _hist_inputs(rng, F, nbins, L, n, 0.05, integer,
                                       cuda)
    g = hist.offset_codes(codes, bc, nbins)
    layout = hist.packed_layout(bc, nbins + 1)
    before = hist.HIST.launches
    got = hist.hist_varbin(g, leaf, st, L, bc, nbins + 1)
    again = hist.hist_varbin(g, leaf, st, L, bc, nbins + 1)
    want = hist.hist_varbin_torch(g, leaf, st, L, layout)
    cpu = hist.hist_varbin_torch(*_cpu(g, leaf, st), L, layout)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 2
    _assert_bitwise(got, want, again, cpu)
    # the packed layout sums the same quantised values: the same dense H
    dense = hist.expand_varbin(got, bc, L, nbins + 1)
    _assert_bitwise(dense, hist.hist_uniform_torch(codes, leaf, st, L,
                                                   nbins + 1))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("L,F,nbins", [(1, 8, 256), (32, 8, 256),
                                       (5, 3, 2), (64, 13, 33)])
def test_split_records_equal_plain(cuda, L, F, nbins, integer):
    rng = np.random.default_rng(L * 100 + F + nbins)
    B = nbins + 1
    if integer:
        H = np.stack([rng.integers(-20, 21, (L, F, B)),
                      rng.integers(0, 30, (L, F, B)),
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    else:
        H = np.stack([rng.normal(size=(L, F, B)),
                      rng.random((L, F, B)) * 5,
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    H[:, :, :, rng.random(B) < 0.1] = 0.0          # empty bins
    Hd = torch.from_numpy(H).to(cuda)
    for lam, mr, alpha, gamma, mcw in ((1.0, 1.0, 0.0, 0.0, 1.0),
                                       (0.0, 10.0, 0.5, 0.1, 0.0)):
        before = hist.SPLIT_RECORDS.launches
        got = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw)
        want = hist._split_records_torch(Hd, lam, mr, alpha, gamma, mcw)
        cpu = hist._split_records_torch(Hd.cpu(), lam, mr, alpha, gamma,
                                        mcw)
        torch.cuda.synchronize()
        assert hist.SPLIT_RECORDS.launches == before + 1
        # the same IEEE operations in the same order: bitwise on any H
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())


def test_small_train_splits_match_cpu_plain_route(cuda):
    """Three trees on the card (varbin + records kernels) against the same
    train on the CPU through the plain versions: the same splits."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    rng = np.random.default_rng(3)
    n = 20_000
    x0 = rng.normal(size=n).astype(np.float32)
    x0[rng.random(n) < 0.05] = np.nan
    cols = {"x0": x0, "x1": rng.integers(0, 7, n).astype(np.float32),
            "c": rng.integers(0, 30, n),
            "y": np.where(np.nan_to_num(x0) + 0.3 * (rng.random(n) < 0.5)
                          > 0.2, "a", "b").astype(object)}
    types, domains = {"c": "cat"}, {"c": [str(i) for i in range(30)]}
    cfg = dict(response_column="y", max_depth=4, nbins=64, seed=1, ntrees=3,
               score_tree_interval=10 ** 9)
    models = {}
    for dev in ("cuda", "cpu"):
        fr = Frame.from_numpy(cols, types=types, domains=domains, device=dev)
        models[dev] = XGBoost(device=dev, **cfg).train(fr)
    a, b = models["cuda"], models["cpu"]
    assert a.output["hist_kernel"] == "varbin"
    for ta, tb in zip(a.output["trees"], b.output["trees"]):
        for d in range(len(ta.feat)):
            va, vb = ta.valid[d].cpu().numpy(), tb.valid[d].numpy()
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(ta.feat[d].cpu().numpy()[va],
                                          tb.feat[d].numpy()[vb])
            np.testing.assert_array_equal(ta.thr[d].cpu().numpy()[va],
                                          tb.thr[d].numpy()[vb])
        np.testing.assert_allclose(ta.values.cpu().numpy(),
                                   tb.values.numpy(), rtol=1e-4, atol=1e-6)


# ------------------------------------- the hierarchical search's kernels

# (nbins, L, F, K, n): the bench geometry (S = 16, W = 16) at the deepest
# level and at the root with a ragged n; nbins = 61, W = 8 puts the NA
# code on slot 5 of super-bin 7 (it must not land); K = 3 lets two
# selected super-bins coincide
_FINE_CASES = [(256, 32, 8, 2, 1_000_003), (256, 1, 8, 2, 999_983),
               (61, 4, 5, 2, 200_001), (32, 16, 3, 3, 77_777),
               (1024, 8, 11, 2, 20_000)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("nbins,L,F,K,n", _FINE_CASES)
def test_fine_hist_equals_plain(cuda, nbins, L, F, K, n, integer):
    rng = np.random.default_rng(nbins + L * 7 + n % 101)
    S, W = hist.superbin_geometry(nbins)
    _, codes, leaf, st = _hist_inputs(rng, F, nbins, L, n, 0.05, integer,
                                      cuda)
    sel_np = rng.integers(0, S, (L, F, K)).astype(np.int32)
    sel_np[:, 0, 0] = S - 1         # the super-bin the NA code aliases into
    sel = torch.from_numpy(sel_np).to(cuda)
    before = hist.FINE_HIST.launches
    got = hist.fine_hist(codes, leaf, st, sel, W, nbins)
    again = hist.fine_hist(codes, leaf, st, sel, W, nbins)
    want = hist.fine_hist_torch(codes, leaf, st, sel, W, nbins)
    cpu = hist.fine_hist_torch(*_cpu(codes, leaf, st, sel), W, nbins)
    torch.cuda.synchronize()
    assert hist.FINE_HIST.launches == before + 2
    assert got.shape == (3, L, F, K, W)
    _assert_bitwise(got, want, again, cpu)
    g16 = codes.to(torch.int16)
    if int(codes.max()) < 32_000:
        _assert_bitwise(hist.fine_hist(g16, leaf, st, sel, W, nbins), got)


def test_fine_hist_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(5)
    _, codes, leaf, st = _hist_inputs(rng, 3, 32, 2, 1000, 0.0, True, cuda)
    sel = torch.zeros((2, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="sel is on"):
        hist.fine_hist(codes, leaf, st, sel, 4, 32)
    with pytest.raises(ValueError, match="leaf is on"):
        hist.fine_hist(codes, leaf.cpu(), st, sel.to(cuda), 4, 32)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("F,nbins,L,n", [(8, 16, 1, 1_000_003),
                                         (8, 16, 16, 500_001),
                                         (5, 64, 8, 77_777)])
def test_hist_uniform_planes4_equals_plain(cuda, F, nbins, L, n, integer):
    rng = np.random.default_rng(F * 13 + L + n % 83)
    _, codes, leaf, st = _hist_inputs(rng, F, nbins, L, n, 0.05, integer,
                                      cuda)
    before = hist.HIST.launches
    got = hist.hist_uniform(codes, leaf, st, L, nbins + 1, planes=4)
    again = hist.hist_uniform(codes, leaf, st, L, nbins + 1, planes=4)
    want = hist.hist_uniform_torch(codes, leaf, st, L, nbins + 1, planes=4)
    cpu = hist.hist_uniform_torch(*_cpu(codes, leaf, st), L, nbins + 1,
                                  planes=4)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 2
    assert got.shape == (4, L, F, nbins + 1)
    _assert_bitwise(got, want, again, cpu)
    three = hist.hist_uniform(codes, leaf, st, L, nbins + 1)
    _assert_bitwise(got[:3], three)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_histograms_non_finite_stat_equal_plain(cuda, bad):
    """A non-finite stat makes its plane NaN throughout in each kernel, as
    in its plain version; the other planes are unchanged, bitwise."""
    rng = np.random.default_rng(21)
    nbins, L, F, n = 256, 8, 8, 100_003
    S, W = hist.superbin_geometry(nbins)
    bc, codes, leaf, st = _hist_inputs(rng, F, nbins, L, n, 0.05, False,
                                       cuda)
    st[2, 777] = bad
    sel = torch.from_numpy(rng.integers(0, S, (L, F, 2)).astype(
        np.int32)).to(cuda)
    g = hist.offset_codes(codes, bc, nbins)
    layout = hist.packed_layout(bc, nbins + 1)
    got = [hist.hist_uniform(codes, leaf, st, L, nbins + 1, planes=4),
           hist.hist_varbin(g, leaf, st, L, bc, nbins + 1),
           hist.fine_hist(codes, leaf, st, sel, W, nbins)]
    want = [hist.hist_uniform_torch(codes, leaf, st, L, nbins + 1, 4),
            hist.hist_varbin_torch(g, leaf, st, L, layout),
            hist.fine_hist_torch(codes, leaf, st, sel, W, nbins)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert torch.isnan(got[0][2]).all() and torch.isfinite(got[0][:2]).all()
    assert torch.isnan(got[1][:, 2::3]).all()
    assert torch.isnan(got[2][2]).all() and torch.isfinite(got[2][:2]).all()


def test_small_hier_train_matches_cpu_plain_route(cuda):
    """Three hierarchical-search trees on the card (coarse hist and fine
    hist kernels) against the same train on the CPU through the plain
    versions: the same valid flags, features and NA directions, and the
    same partition of the rows at every level, so a threshold differs
    only across a structural tie (no row of the node between the two)."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree import binning
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    rng = np.random.default_rng(4)
    n = 20_000
    x0 = rng.normal(size=n).astype(np.float32)
    x0[rng.random(n) < 0.05] = np.nan
    cols = {"x0": x0, "x1": rng.normal(size=n).astype(np.float32),
            "c": rng.integers(0, 30, n),
            "y": np.where(np.nan_to_num(x0) + 0.5 * rng.normal(size=n)
                          > 0.2, "a", "b").astype(object)}
    types, domains = {"c": "cat"}, {"c": [str(i) for i in range(30)]}
    cfg = dict(response_column="y", max_depth=4, nbins=64, seed=1, ntrees=3,
               score_tree_interval=10 ** 9, split_search="hier")
    models = {}
    fine0, split0 = hist.FINE_HIST.launches, hist.SPLIT_RECORDS.launches
    for dev in ("cuda", "cpu"):
        fr = Frame.from_numpy(cols, types=types, domains=domains, device=dev)
        models[dev] = XGBoost(device=dev, **cfg).train(fr)
    assert hist.FINE_HIST.launches == fine0 + 3 * 4
    assert hist.SPLIT_RECORDS.launches == split0
    a, b = models["cuda"], models["cpu"]
    # each level's rows, routed by the CPU tree: a threshold may differ
    # only where both trees' bins send every row of the node alike
    fr = Frame.from_numpy(cols, types=types, domains=domains, device="cpu")
    binned = binning.fit_bins(fr, ["x0", "x1", "c"], nbins=64, seed=1)
    for ea, eb in zip(binned.edges, b.output["edges"]):
        np.testing.assert_array_equal(ea, eb)
    codes = binned.codes
    edges = torch.from_numpy(binning.edges_matrix(binned.edges, 64))
    ties = 0
    for ta, tb in zip(a.output["trees"], b.output["trees"]):
        leaf = torch.zeros(n, dtype=torch.int32)
        for d in range(len(ta.feat)):
            va, vb = ta.valid[d].cpu().numpy(), tb.valid[d].numpy()
            np.testing.assert_array_equal(va, vb)
            for nm in ("feat", "na_left"):
                np.testing.assert_array_equal(
                    getattr(ta, nm)[d].cpu().numpy()[va],
                    getattr(tb, nm)[d].numpy()[vb])
            feat, nal, valid = tb.feat[d], tb.na_left[d], tb.valid[d]
            rows = edges[feat.long()]
            la, lb = (hist.partition(codes, leaf, feat, (
                rows == thr[:, None]).int().argmax(1).to(torch.int32), nal,
                valid, 64) for thr in (ta.thr[d].cpu(), tb.thr[d]))
            assert torch.equal(la, lb), f"level {d} routes differently"
            ties += int((ta.thr[d].cpu() != tb.thr[d])[valid].sum())
            leaf = lb
        np.testing.assert_allclose(ta.values.cpu().numpy(),
                                   tb.values.numpy(), rtol=1e-4, atol=1e-6)
    assert ties <= 2, ties
    pa = a.predict(Frame.from_numpy(cols, types=types, domains=domains,
                                    device="cuda")).vec("a").to_numpy()
    pb = b.predict(Frame.from_numpy(cols, types=types, domains=domains,
                                    device="cpu")).vec("a").to_numpy()
    np.testing.assert_allclose(pa, pb, rtol=1e-4)
