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
from h2o3_tpu_torch.testing import same_bits, tie_hist

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
                                         (12, 5, 1023, 17), (10, 300, 32, 1),
                                         (10, 300, 32, 8), (10, 300, 32, 256),
                                         (6, 150, 32, 1024),
                                         (12, 9, 1023, 64),
                                         (5, 3, 4, 600_000)])
def test_kernel_bitwise_equals_plain(cuda, depth, T, F, B):
    """The kernel on the record plane equals the plain descent on the two
    planes bitwise, at batches from one row to a ragged 1,024, and at
    600,000 rows: more row tiles (8 rows) than a grid's y dimension holds
    (65,535), still one launch."""
    rng = np.random.default_rng(depth * 1000 + T)
    i32, f32, roots = _planes(rng, T, depth, F, cuda)
    X = rng.normal(size=(B, F)).astype(np.float32)
    X[rng.random((B, F)) < 0.1] = np.nan
    Xd = torch.from_numpy(X).to(cuda)
    before = kernel.TRAVERSE.launches
    got = kernel.traverse(kernel.interleave(i32, f32), roots, Xd, depth)
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
        kernel.traverse(kernel.interleave(i32, f32), roots,
                        torch.zeros(4, 3), 2)


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


def _records_hist(rng, L, F, nbins, kind):
    B = nbins + 1
    if kind.startswith("tie"):
        a, b = (int(x) for x in kind.split("_")[1:])
        return tie_hist(a, b, L, F)
    if kind == "real":
        H = np.stack([rng.normal(size=(L, F, B)),
                      rng.random((L, F, B)) * 5,
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    else:
        H = np.stack([rng.integers(-20, 21, (L, F, B)),
                      rng.integers(0, 30, (L, F, B)),
                      rng.integers(0, 40, (L, F, B))]).astype(np.float32)
    H[:, :, :, rng.random(B) < 0.1] = 0.0          # empty bins
    if kind.startswith("nan_"):
        H["ghw".index(kind[4])] = np.nan           # a non-finite stat
    return H


# (L, F, nbins, kind): the bench's root and deepest level, nbins across
# the warp width and at the launcher's smallest B = 3, edge cases of the
# block argmax (NaN planes, every gain -inf via min_rows, ties of two bins
# in one thread, in one warp and across warps)
_RECORDS_CASES = [(1, 8, 256, "integer"), (32, 8, 256, "integer"),
                  (1, 8, 256, "real"), (32, 8, 256, "real"),
                  (5, 3, 2, "integer"), (5, 3, 2, "real"),
                  (64, 13, 33, "integer"), (64, 13, 33, "real"),
                  (7, 5, 31, "real"), (7, 5, 32, "real"),
                  (33, 7, 1023, "real"), (4, 8, 256, "nan_g"),
                  (4, 8, 256, "nan_h"), (4, 8, 256, "nan_w"),
                  (3, 5, 256, "neg_inf"), (2, 3, 0, "tie_3_259"),
                  (2, 3, 0, "tie_3_35"),
                  (2, 3, 0, "tie_3_20"), (2, 3, 0, "tie_10_245")]


@pytest.mark.parametrize("L,F,nbins,kind", _RECORDS_CASES)
def test_split_records_equal_plain(cuda, L, F, nbins, kind):
    rng = np.random.default_rng(L * 100 + F + nbins)
    H = _records_hist(rng, L, F, nbins, kind)
    nbins = H.shape[-1] - 1
    Hd = torch.from_numpy(H).to(cuda)
    for lam, mr, alpha, gamma, mcw in ((1.0, 1.0, 0.0, 0.0, 1.0),
                                       (0.0, 10.0, 0.5, 0.1, 0.0)):
        if kind == "neg_inf":
            mr = 1e9
        before = hist.SPLIT_RECORDS.launches
        got = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw)
        again = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw)
        want = hist._split_records_torch(Hd, lam, mr, alpha, gamma, mcw)
        cpu = hist._split_records_torch(Hd.cpu(), lam, mr, alpha, gamma,
                                        mcw)
        torch.cuda.synchronize()
        assert hist.SPLIT_RECORDS.launches == before + 2
        # the same IEEE operations in the same order: bitwise on any H,
        # NaN bits included, and a second launch bitwise the first
        assert same_bits(got, want) and same_bits(again, got)
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
        if kind == "neg_inf":
            assert (got[..., 0] == -torch.inf).all()
            assert (got[..., 1] == 0).all()
        if kind.startswith("tie"):
            assert (got[..., 1] == 3 if kind != "tie_10_245"
                    else got[..., 1] == 10).all()


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


# --------------------------------- the K axis of the histogram kernel

# (K, F, nbins, L, n, codes): K trees in one launch, on codes they share
# (read with a stride of 0) or on each tree's own prefix (a [K, F, n] view
# of an [F, K, n] buffer, as make_batched_level_fn compacts them)
_BATCHED_CASES = [(1, 8, 256, 1, 1_000_003, "shared"),
                  (3, 8, 256, 1, 999_983, "shared"),
                  (3, 8, 256, 16, 500_001, "own"),
                  (7, 5, 64, 4, 77_777, "own"),
                  (7, 3, 17, 2, 1_001, "shared")]


def _batched_inputs(rng, K, F, nbins, L, n, codes_kind, integer, dev):
    bc, codes, _, _ = _hist_inputs(rng, F, nbins, L, n, 0.05, integer, dev)
    if codes_kind == "own":
        own = [codes[:, rng.permutation(n)] for _ in range(K)]
        codes = torch.stack(own, dim=1).transpose(0, 1)     # [K, F, n]
    leaf = torch.from_numpy(rng.integers(-1, L, (K, n)).astype(
        np.int32)).to(dev)
    sts = [_hist_inputs(rng, 1, 2, 1, n, 0.0, integer, dev)[3] * (10.0 ** k)
           for k in range(K)]                  # trees on scales far apart
    return bc, codes, leaf, torch.stack(sts)


def _tree(codes, k):
    return codes[k] if codes.dim() == 3 else codes


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("K,F,nbins,L,n,codes_kind", _BATCHED_CASES)
def test_hist_batched_equals_plain_and_single_launches(cuda, K, F, nbins, L,
                                                       n, codes_kind,
                                                       integer):
    """One K-batched launch of ``csrc/hist.cu`` (blockIdx.z = tree, each
    tree on its own fixed-point scale) equals its plain version bitwise,
    and each tree's histogram equals a launch of that tree alone, on both
    layouts, at a ragged n, with rows of leaf -1."""
    rng = np.random.default_rng(K * 13 + L + n % 83)
    bc, codes, leaf, st = _batched_inputs(rng, K, F, nbins, L, n,
                                          codes_kind, integer, cuda)
    B = nbins + 1
    scale = hist.stat_scale(st)
    before = hist.HIST.launches
    got = hist.hist_uniform(codes, leaf, st, L, B, scale=scale)
    gcodes = hist.offset_codes(codes, bc, nbins)
    packed = hist.hist_varbin(gcodes, leaf, st, L, bc, B, scale)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 2
    assert got.shape == (K, 3, L, F, B)
    _assert_bitwise(got, hist.hist_uniform_torch(codes, leaf, st, L, B,
                                                 scale=scale))
    _assert_bitwise(packed, hist.hist_varbin_torch(
        gcodes, leaf, st, L, hist.packed_layout(bc, B), scale))
    for k in range(K):
        _assert_bitwise(got[k], hist.hist_uniform(
            _tree(codes, k).contiguous(), leaf[k], st[k], L, B))
        _assert_bitwise(packed[k], hist.hist_varbin(
            _tree(gcodes, k).contiguous(), leaf[k], st[k], L, bc, B))
    _assert_bitwise(hist.expand_varbin(packed, bc, L, B), got)


def test_small_multinomial_train_matches_cpu_plain_route(cuda):
    """A 3-class XGBoost on the card: one hist and one split_records launch
    per level for all three class trees; bitwise the K loop of single
    builds (split_mode="separate") on the card, and the same splits as the
    CPU plain route on the first round."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    from h2o3_tpu_torch.testing import same_bits
    rng = np.random.default_rng(4)
    n = 30_000
    x0 = rng.normal(size=n).astype(np.float32)
    x0[rng.random(n) < 0.05] = np.nan
    x1 = rng.integers(0, 2400, n).astype(np.float32)
    cols = {"x0": x0, "x1": x1, "c": rng.integers(0, 30, n),
            "y": np.where(np.nan_to_num(x0) + 0.3 * (rng.random(n) < 0.5)
                          < 0.2, "NO", np.where(x1 >= 1700, "LONG",
                                                "SHORT")).astype(object)}
    types, domains = {"c": "cat"}, {"c": [str(i) for i in range(30)]}
    cfg = dict(response_column="y", max_depth=4, nbins=64, seed=1, ntrees=3,
               score_tree_interval=10 ** 9)
    models = {}
    for dev in ("cuda", "cpu"):
        fr = Frame.from_numpy(cols, types=types, domains=domains, device=dev)
        before = (hist.HIST.launches, hist.SPLIT_RECORDS.launches)
        models[dev] = XGBoost(device=dev, **cfg).train(fr)
        if dev == "cuda":
            assert (hist.HIST.launches - before[0],
                    hist.SPLIT_RECORDS.launches - before[1]) == (12, 12)
            # sampled (the card's generators draw other numbers than the
            # CPU's, so only here): the batched build against the K loop
            sampled = dict(cfg, sample_rate=0.8, col_sample_rate=0.8,
                           col_sample_rate_per_tree=0.7)
            fus = XGBoost(device=dev, **sampled).train(fr)
            sep = XGBoost(device=dev, split_mode="separate",
                          **sampled).train(fr)
    a, b = models["cuda"], models["cpu"]
    assert a.output["nclass_trees"] == 3
    for sa, ss in zip(fus.output["stacked"], sep.output["stacked"]):
        for la, ls in zip(sa.levels, ss.levels):
            for x, y in zip(la, ls):
                assert torch.equal(x, y)
        assert same_bits(sa.values, ss.values)
    for ta, tb in zip(a.output["trees"][0], b.output["trees"][0]):
        for d in range(len(ta.feat)):
            va, vb = ta.valid[d].cpu().numpy(), tb.valid[d].numpy()
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(ta.feat[d].cpu().numpy()[va],
                                          tb.feat[d].numpy()[vb])
            np.testing.assert_array_equal(ta.thr[d].cpu().numpy()[va],
                                          tb.thr[d].numpy()[vb])
        np.testing.assert_allclose(ta.values.cpu().numpy(),
                                   tb.values.numpy(), rtol=1e-4, atol=1e-6)


# (L, F, nbins, kind) for the per-row form: the bench grid's root and
# deepest level of a 4-member cohort (4 and 128 leaves), a ragged small
# case and a NaN plane
_ROWS_CASES = [(4, 8, 256, "integer"), (4, 8, 256, "real"),
               (128, 8, 256, "real"), (12, 5, 31, "real"),
               (8, 8, 256, "nan_g")]


@pytest.mark.parametrize("L,F,nbins,kind", _ROWS_CASES)
def test_split_records_per_row_equal_plain(cuda, L, F, nbins, kind):
    """The per-row form (one lam, alpha, gamma, min_rows, mcw per leaf,
    leaf 1 ruled out by its min_rows and min_child_weight, the last leaf
    a retired member's all-zero histogram): bitwise its plain version on
    the card, a second launch bitwise the first, equal to the plain
    version on the CPU; counted in SPLIT_RECORDS_ROWS and never in the
    scalar form's count."""
    rng = np.random.default_rng(L * 7 + F + nbins)
    H = _records_hist(rng, L, F, nbins, kind)
    H[:, -1] = 0.0
    Hd = torch.from_numpy(H).to(cuda)
    lam = rng.choice([0.0, 1.0, 2.5], L).astype(np.float32)
    rows = rng.choice([1.0, 10.0], L).astype(np.float32)
    alpha = rng.choice([0.0, 0.5], L).astype(np.float32)
    gamma = rng.choice([0.0, 0.1], L).astype(np.float32)
    mcw = rng.choice([0.0, 1.0], L).astype(np.float32)
    rows[1], mcw[1] = 1e9, 1e9
    prm = [torch.from_numpy(x) for x in (lam, rows, alpha, gamma, mcw)]
    dprm = [p.to(cuda) for p in prm]
    before = (hist.SPLIT_RECORDS.launches, hist.SPLIT_RECORDS_ROWS.launches)
    got = hist.split_records(Hd, nbins, *dprm)
    again = hist.split_records(Hd, nbins, *dprm)
    want = hist._split_records_torch(Hd, *dprm)
    cpu = hist._split_records_torch(Hd.cpu(), *prm)
    torch.cuda.synchronize()
    assert (hist.SPLIT_RECORDS.launches,
            hist.SPLIT_RECORDS_ROWS.launches) == (before[0], before[1] + 2)
    assert same_bits(got, want) and same_bits(again, got)
    # against the CPU as values: a NaN's payload differs by device
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
    assert (got[1, :, 0] == -torch.inf).all()


@pytest.mark.parametrize("nbins", [31, 256])
def test_split_records_equal_leaves_per_row_equal_scalar(cuda, nbins):
    """Per-leaf tensors holding one value for every leaf: the per-row
    launch is bitwise the scalar launch (NaN plane included)."""
    L, F = 16, 8
    rng = np.random.default_rng(nbins)
    H = _records_hist(rng, L, F, nbins, "real")
    H[0, 3] = np.nan
    Hd = torch.from_numpy(H).to(cuda)
    for scal in ((1.0, 1.0, 0.0, 0.0, 1.0), (0.0, 10.0, 0.5, 0.1, 0.0)):
        per = [torch.full((L,), v, dtype=torch.float32, device=cuda)
               for v in scal]
        a = hist.split_records(Hd, nbins, *per)
        b = hist.split_records(Hd, nbins, *scal)
        torch.cuda.synchronize()
        assert same_bits(a, b)


def test_small_grid_cohort_bitwise_sequential_members(cuda):
    """A 2-member cohort on a small frame on the card: one hist and one
    per-row split_records launch per level for both members, no scalar
    records launch; each member bitwise its own sequential train on the
    card (trees, leaf values, predictions), sampled members too."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models import GridSearch
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    rng = np.random.default_rng(5)
    n = 30_000
    x0 = rng.normal(size=n).astype(np.float32)
    x0[rng.random(n) < 0.05] = np.nan
    x1 = rng.integers(0, 2400, n).astype(np.float32)
    cols = {"x0": x0, "x1": x1, "c": rng.integers(0, 30, n),
            "y": np.where(np.nan_to_num(x0) + 0.3 * (rng.random(n) < 0.5)
                          < 0.2, "NO", "YES").astype(object)}
    fr = Frame.from_numpy(cols, types={"c": "cat"},
                          domains={"c": [str(i) for i in range(30)]})
    cfg = dict(response_column="y", max_depth=4, nbins=64, seed=1, ntrees=3)
    for hp, extra in (({"learn_rate": [0.1, 0.3]}, {}),
                      ({"sample_rate": [0.8, 1.0]},
                       {"col_sample_rate": 0.7})):
        before = (hist.HIST.launches, hist.SPLIT_RECORDS.launches,
                  hist.SPLIT_RECORDS_ROWS.launches)
        g = GridSearch(XGBoost, hp, grid_batch="on", **cfg,
                       **extra).train(fr)
        torch.cuda.synchronize()
        assert (hist.HIST.launches - before[0],
                hist.SPLIT_RECORDS.launches - before[1],
                hist.SPLIT_RECORDS_ROWS.launches - before[2]) == (12, 0, 12)
        for m in g.models:
            assert m.output["grid_cohort"]["size"] == 2
            (name, val), = ((k, getattr(m.params, k)) for k in hp)
            seq = XGBoost(**cfg, **extra, **{name: val}).train(fr)
            a, b = m.output["stacked"], seq.output["stacked"]
            for la, lb in zip(a.levels, b.levels):
                for x, y in zip(la, lb):
                    assert torch.equal(x, y)
            assert same_bits(a.values, b.values)
            np.testing.assert_array_equal(
                m.predict(fr).vec("YES").to_numpy(),
                seq.predict(fr).vec("YES").to_numpy())


# ------------------------------------------------ node-sparse deep levels

def _slot_level_inputs(rng, K, A_prev, A, bc, nbins, n, integer, dev,
                       skewed=False):
    """A sparse level's inputs on ``dev``: codes [F, n] (feature f's
    regular codes below its bin count ``bc[f]``), each tree's parent
    slots (3/4 of them valid, so that the A slots overflow where 2 x the
    valid ones pass A), each row's slot in [0, A] (some rows on the
    sentinel A), stats [K, 3, n] and a carry [K, 3, A_prev, F, B].
    ``skewed``: 70% of a tree's rows on one slot, and a third of the live
    slots empty."""
    codes = np.stack([np.where(rng.random(n) < 0.05, nbins,
                               rng.integers(0, b, n))
                      for b in bc]).astype(np.int16)
    valid = torch.from_numpy(rng.random((K, A_prev)) < 0.75)
    _, ps, real = hist.sparse_slot_maps(valid, A)
    live = real.sum(1, keepdim=True)
    sleaf = torch.from_numpy(rng.integers(0, 1 << 30, (K, n))) % (live + 1)
    if skewed:
        sleaf = torch.where(sleaf % 3 == 1, live, sleaf)   # empty slots
        heavy = torch.from_numpy(rng.random((K, n)) < 0.7)
        sleaf = torch.where(heavy, 5, sleaf)
    sleaf = torch.where(sleaf == live, A, sleaf)       # the sentinel slot
    if integer:
        st = np.stack([rng.integers(-3, 4, (K, n)), rng.integers(0, 3, (K, n)),
                       rng.integers(0, 2, (K, n))], axis=1)
    else:
        p = rng.random((K, n))
        st = np.stack([p - (rng.random((K, n)) < 0.4), p * (1 - p),
                       rng.random((K, n)) < 0.632], axis=1)
    carry = rng.random((K, 3, A_prev, len(bc), nbins + 1)) * n / A_prev
    return [torch.as_tensor(x).to(dev) for x in (
        codes, sleaf, st.astype(np.float32), carry.astype(np.float32), ps)]


def _launch_counts():
    return (hist.HIST.launches, hist.HIST_WINDOWS.launches,
            hist.SLOT_COMPACT.launches, hist.SPLIT_RECORDS.launches)


def _launched(before):
    return tuple(a - b for a, b in zip(_launch_counts(), before))


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("K", [1, 3])
def test_sparse_level_at_4096_slots_equals_plain(cuda, K, integer, varbin,
                                                 skewed):
    """A node-sparse level at the slot geometry of DRF's deep levels
    (2,048 or 4,096 parent slots, A = 4,096 slots, F = 8, nbins 64), one
    ``slot_compact`` and one windowed ``hist`` launch for all K trees,
    equals the same level on the CPU (the plain versions) bitwise, on
    uniform and on skewed slots (one slot holding most rows, a third
    empty); on the kernel's slot-ordered prefix the windowed ``hist`` is
    bitwise its plain version and the full-prefix (``row_start=None``)
    launch; the records over the K*A slots equal their plain version
    bitwise, in one launch."""
    F, nbins, n = 8, 64, 400_003
    B = nbins + 1
    A_prev = 2048 if K == 1 else 4096
    rng = np.random.default_rng(K * 7 + integer + 2 * varbin + 4 * skewed)
    bc = (nbins, 12, nbins, 7, nbins, 40, 3, nbins)
    on_card = _slot_level_inputs(rng, K, A_prev, 4096, bc, nbins, n,
                                 integer, cuda, skewed)
    H = {}
    for dev, (codes, sleaf, st, carry, ps) in (
            ("cuda", on_card), ("cpu", [x.cpu() for x in on_card])):
        codes = hist.offset_codes(codes, bc, nbins) if varbin else codes
        fn = hist.make_batched_sparse_level_fn(A_prev, 4096, K, F, B,
                                               bc if varbin else None)
        before = _launch_counts()
        H[dev], _ = fn(codes, sleaf, st, carry, ps)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _launched(before) == (0, 1, 1, 0)
            cc, pleaf, pst, rs, _ = hist.slot_compact(codes, sleaf, st, ps,
                                                      A_prev)
    assert H["cuda"].shape == (K, 3, 4096, F, B)
    _assert_bitwise(H["cuda"].cpu(), H["cpu"])
    # the level's scale, from the card's stats: pst past the count is
    # unwritten
    sc = hist.stat_scale(on_card[2])
    if varbin:
        args = (pleaf, pst, A_prev, bc, B, sc)
        win = hist.hist_varbin(cc, *args, row_start=rs)
        full = hist.hist_varbin(cc, *args)
        plain = hist.hist_varbin_torch(cc, pleaf, pst, A_prev,
                                       hist.packed_layout(bc, B), sc)
    else:
        win = hist.hist_uniform(cc, pleaf, pst, A_prev, B, scale=sc,
                                row_start=rs)
        full = hist.hist_uniform(cc, pleaf, pst, A_prev, B, scale=sc)
        plain = hist.hist_uniform_torch(cc, pleaf, pst, A_prev, B, scale=sc)
    torch.cuda.synchronize()
    _assert_bitwise(win, plain)
    _assert_bitwise(full, win)
    before = hist.SPLIT_RECORDS.launches
    got = hist.batched_splits(hist.fused_best_splits, H["cuda"], nbins, 1.0,
                              1.0, 1e-5)
    want = hist.batched_splits(hist.best_splits, H["cuda"], nbins, 1.0,
                               1.0, 1e-5)
    torch.cuda.synchronize()
    assert hist.SPLIT_RECORDS.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                           b.contiguous().view(-1).view(torch.uint8))


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_slot_compact_kernel_equals_plain(cuda, K, skewed):
    """``csrc/slot_compact.cu`` against ``slot_compact_torch`` at 4,096
    slots: the same row_start and chosen slots; each window the same set
    of rows (the codes carry each row's number) with the same codes,
    stats and parent slot, row by row once both are sorted by row; the
    same tail of leaf -1 (its codes and stats are left unwritten); and
    the windowed histograms of the two prefixes bitwise."""
    nbins, n, A = 64, 400_003, 4096
    A_prev = 2048 if K == 1 else 4096
    rng = np.random.default_rng(30 + K + 2 * skewed)
    bc = (nbins, 12, nbins, 7, nbins, 40, 3, nbins)
    codes, sleaf, st, _, ps = _slot_level_inputs(
        rng, K, A_prev, A, bc, nbins, n, False, cuda, skewed)
    rowid = torch.arange(n, dtype=torch.int32, device=cuda)
    c32 = torch.cat([rowid[None], codes.int()])          # [1 + F, n]
    before = hist.SLOT_COMPACT.launches
    got = hist.slot_compact(c32, sleaf, st, ps, A_prev)
    want = hist.slot_compact_torch(c32, sleaf, st, ps, A_prev)
    again = hist.slot_compact(c32, sleaf, st, ps, A_prev)
    torch.cuda.synchronize()
    assert hist.SLOT_COMPACT.launches == before + 2
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert torch.equal(again[3], got[3])
    total = want[3][:, -1].cpu()
    for out in (got, again):
        cc, pleaf, pst = (x.cpu() for x in out[:3])
        wc, wl, wst = (x.cpu() for x in want[:3])
        for k in range(K):
            t = int(total[k])
            # within its window each row keeps its parent slot, so one
            # stable sort by (parent slot, row) gives the plain order
            key = pleaf[k, :t].long() * n + cc[k, 0, :t].long()
            order = torch.argsort(key)
            assert torch.equal(cc[k][:, :t][:, order], wc[k][:, :t])
            assert torch.equal(pleaf[k, :t][order], wl[k, :t])
            assert same_bits(pst[k][:, :t][:, order], wst[k][:, :t])
            assert bool((pleaf[k, t:] == -1).all())
            assert torch.equal(pleaf[k, t:], wl[k, t:])
    g = hist.offset_codes(codes, bc, nbins)
    sc = hist.stat_scale(st)
    Hs = [hist.hist_varbin(x[0], x[1], x[2], A_prev, bc, nbins + 1, sc,
                           row_start=x[3])
          for x in (hist.slot_compact(g, sleaf, st, ps, A_prev),
                    hist.slot_compact_torch(g, sleaf, st, ps, A_prev))]
    torch.cuda.synchronize()
    _assert_bitwise(Hs[0], Hs[1])


def test_small_drf_train_matches_cpu(cuda):
    """A binomial and a 3-class DRF at depth 12 with sparse levels from
    depth 4 on the card: one hist and one records launch per level of
    every tree or round, whatever K (at a sparse level the windowed hist,
    after one slot_compact launch); the same trees as the CPU, unsampled;
    sampled, the batched 3-class round bitwise its K loop."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree.drf import DRF
    rng = np.random.default_rng(8)
    n = 30_000
    x0 = rng.normal(size=n).astype(np.float32)
    x0[rng.random(n) < 0.05] = np.nan
    x1 = rng.integers(0, 2400, n).astype(np.float32)
    y3 = np.where(np.nan_to_num(x0) + 0.3 * (rng.random(n) < 0.5) < 0.2,
                  "NO", np.where(x1 >= 1700, "LONG", "SHORT")).astype(object)
    cols = {"x0": x0, "x1": x1, "c": rng.integers(0, 30, n), "y3": y3,
            "y2": np.where(y3 == "NO", "NO", "YES").astype(object)}
    types, domains = {"c": "cat"}, {"c": [str(i) for i in range(30)]}
    base = dict(max_depth=12, nbins=64, seed=1, ntrees=2, sample_rate=1.0,
                mtries=-2, sparse_depth_threshold=4,
                score_tree_interval=10 ** 9)
    frames = {d: Frame.from_numpy(cols, types=types, domains=domains,
                                  device=d) for d in ("cuda", "cpu")}
    for resp, other in (("y2", "y3"), ("y3", "y2")):
        cfg = dict(base, response_column=resp, ignored_columns=[other])
        before = _launch_counts()
        a = DRF(device="cuda", **cfg).train(frames["cuda"])
        torch.cuda.synchronize()
        # 2 trees (rounds) x 12 levels, 8 of them node-sparse
        assert _launched(before) == (8, 16, 16, 24)
        b = DRF(device="cpu", **cfg).train(frames["cpu"])
        sa = a.output["stacked"]
        sb = b.output["stacked"]
        for x, y in zip(sa if isinstance(sa, list) else [sa],
                        sb if isinstance(sb, list) else [sb]):
            for la, lb in zip(x.levels, y.levels):
                for u, v in zip(la, lb):
                    assert torch.equal(u.cpu(), v)
            np.testing.assert_allclose(x.values.cpu().numpy(),
                                       y.values.numpy(), rtol=1e-6)
    sampled = dict(base, response_column="y3", ignored_columns=["y2"],
                   sample_rate=0.632, mtries=-1)
    fus = DRF(device="cuda", **sampled).train(frames["cuda"])
    sep = DRF(device="cuda", split_mode="separate", **sampled).train(
        frames["cuda"])
    for x, y in zip(fus.output["stacked"], sep.output["stacked"]):
        for la, lb in zip(x.levels, y.levels):
            for u, v in zip(la, lb):
                assert torch.equal(u, v)
        assert torch.equal(x.values, y.values)


# ------------------------------------------- import and the other builders

def _uplift_csv(path, n, seed):
    """A CSV of four f32 features (``%.9g``, some missing), a category, a
    treatment arm and a binary response with a planted effect."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[rng.random((n, 4)) < 0.03] = np.nan
    c = rng.integers(0, 5, n)
    treat = rng.integers(0, 2, n)
    effect = np.where(np.nan_to_num(X[:, 0]) > 0, 0.3, -0.05)
    y = rng.random(n) < np.clip(1 / (1 + np.exp(-np.nan_to_num(X[:, 1])))
                                + treat * effect, 0.01, 0.99)
    cells = [np.where(np.isnan(X[:, j]), "",
                      np.char.mod("%.9g", X[:, j].astype(np.float64)))
             for j in range(4)]
    cells += [np.char.add("k", c.astype(str)),
              np.array(["control", "treatment"])[treat],
              np.array(["no", "yes"])[y.astype(int)]]
    with open(path, "w") as f:
        f.write("x0,x1,x2,x3,c,treatment,y\n")
        f.write("\n".join(",".join(r) for r in zip(*cells)) + "\n")
    return str(path)


def _same_stack(a, b):
    for la, lb in zip(a.levels, b.levels):
        for u, v in zip(la, lb):
            assert torch.equal(u.cpu(), v.cpu())
    assert torch.equal(a.values.cpu(), b.values.cpu())


def test_fastcsv_import_onto_cuda_equals_cpu(cuda, tmp_path, monkeypatch):
    """The tokenizer builds with g++; a CSV imported onto the card in 8
    byte ranges (each range's numeric columns copied from a pinned buffer
    as it lands) is bitwise the CPU import of the same file."""
    from h2o3_tpu_torch import fastcsv, import_file
    from h2o3_tpu_torch.frame import parse
    fastcsv.load()
    assert fastcsv.lib_path().endswith(".so")
    path = _uplift_csv(tmp_path / "u.csv", 50_000, 4)
    monkeypatch.setenv("H2O3_PARSE_THREADS", "8")
    monkeypatch.setenv("H2O3_PARSE_RANGE_MIN", "1")
    a = import_file(path)
    stats = dict(parse.last_parse_stats)
    b = import_file(path, device="cpu")
    assert a.device.type == "cuda" and stats["ranges"] == 8
    assert a.types() == b.types() and a.names == b.names
    for name in a.names:
        va, vb = a.vec(name), b.vec(name)
        assert va.domain == vb.domain
        assert torch.equal(va.data.cpu().view(torch.uint8),
                           vb.data.view(torch.uint8)), name


def test_small_dt_and_uplift_trains_match_cpu(cuda, tmp_path):
    """A depth-10 DT (node-sparse from depth 4) and a depth-6 uplift
    forest (node-sparse from depth 3) trained on the card from an
    imported CSV: one ``hist`` launch per level (both uplift arms on the
    K axis; at a sparse level the windowed form, after one
    ``slot_compact`` launch) and, for the DT, one records launch per
    level; the same trees
    and leaf values, bitwise, as the CPU's plain route; the uplift's arm
    loop (``split_mode="separate"``) two launches a level, bitwise."""
    from h2o3_tpu_torch import import_file
    from h2o3_tpu_torch.models.tree.dt import DecisionTree
    from h2o3_tpu_torch.models.tree.uplift import UpliftDRF
    path = _uplift_csv(tmp_path / "u.csv", 40_000, 5)
    frames = {d: import_file(path, device=d) for d in ("cuda", "cpu")}
    dt = dict(response_column="y", ignored_columns=["treatment"],
              max_depth=10, sparse_depth_threshold=4, nbins=64, seed=1)
    up = dict(response_column="y", treatment_column="treatment", ntrees=2,
              max_depth=6, sparse_depth_threshold=3, sample_rate=1.0,
              nbins=64, seed=1)
    before = _launch_counts()
    a = DecisionTree(device="cuda", **dt).train(frames["cuda"])
    torch.cuda.synchronize()
    assert _launched(before) == (4, 6, 6, 10)      # 6 node-sparse levels
    b = DecisionTree(device="cpu", **dt).train(frames["cpu"])
    _same_stack(a.output["stacked"], b.output["stacked"])
    before = _launch_counts()
    u = UpliftDRF(device="cuda", **up).train(frames["cuda"])
    torch.cuda.synchronize()
    assert _launched(before) == (6, 6, 6, 0)       # 2 trees x (3 + 3)
    v = UpliftDRF(device="cpu", **up).train(frames["cpu"])
    before = _launch_counts()
    s = UpliftDRF(device="cuda", split_mode="separate", **up).train(
        frames["cuda"])
    torch.cuda.synchronize()
    assert _launched(before) == (12, 12, 12, 0)    # one launch an arm
    for key in ("stacked_pt", "stacked_pc"):
        _same_stack(u.output[key], v.output[key])
        _same_stack(u.output[key], s.output[key])


def test_small_isolation_forests_match_cpu(cuda, tmp_path):
    """IsolationForest and EIF on the card grow bitwise the CPU's trees
    from the same seed (the numpy draws, exact min/max); the published
    IsolationForest's scores through ``traverse.cu`` equal ``predict``."""
    from h2o3_tpu_torch import import_file
    from h2o3_tpu_torch.export.mojo import from_reference
    from h2o3_tpu_torch.models.tree.isofor import (ExtendedIsolationForest,
                                                   IsolationForest)
    path = _uplift_csv(tmp_path / "u.csv", 30_000, 6)
    frames = {d: import_file(path, device=d) for d in ("cuda", "cpu")}
    cfg = dict(ignored_columns=["y", "treatment"], ntrees=5, seed=7)
    m = {d: IsolationForest(device=d, **cfg).train(frames[d])
         for d in frames}
    _same_stack(m["cuda"].output["stacked"], m["cpu"].output["stacked"])
    e = {d: ExtendedIsolationForest(device=d, extension_level=1, **cfg)
         .train(frames[d]) for d in frames}
    for ta, tb in zip(e["cuda"].output["trees"], e["cpu"].output["trees"]):
        for x, y in zip(ta.normals + ta.offsets, tb.normals + tb.offsets):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ta.values, tb.values)
    ps = kernel.PackedScorer(from_reference(*m["cuda"].to_archive()))
    X = m["cuda"]._design(frames["cuda"])[: frames["cuda"].nrows]
    before = kernel.TRAVERSE.launches
    got = ps.score_tensor(X)[:, 0].cpu().numpy()
    assert kernel.TRAVERSE.launches == before + 1
    np.testing.assert_allclose(
        got, m["cuda"].predict(frames["cuda"]).vec("predict").to_numpy(),
        rtol=1e-5)


def _dart_frame(dev, n=30_000):
    """The bench frame's draws with the 3-class ``delay_class`` response,
    on ``dev``."""
    from bench import make_airlines_like
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.testing import delay_class
    cols, types, domains = make_airlines_like(n)
    cols["delay_class"] = delay_class(cols)
    return Frame.from_numpy(cols, types=types, domains=domains, device=dev)


def test_small_dart_train_matches_cpu(cuda):
    """XGBoost's DART booster on the card: one ``hist`` and one records
    launch per level (24 each for 6 depth-4 trees); the same splits at
    every valid node and leaf values to rtol 1e-4 as the CPU train of the
    same frame (the drop sets come from the same numpy draws); the K = 3
    round bitwise its K loop on the card."""
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    cfg = dict(booster="dart", rate_drop=0.3, one_drop=True, max_depth=4,
               nbins=64, seed=1, ntrees=6, score_tree_interval=10 ** 9)
    binary = dict(cfg, response_column="dep_delayed_15min",
                  ignored_columns=["delay_class"])
    frames = {d: _dart_frame(d) for d in ("cuda", "cpu")}
    before = (hist.HIST.launches, hist.SPLIT_RECORDS.launches)
    a = XGBoost(device="cuda", **binary).train(frames["cuda"])
    torch.cuda.synchronize()
    assert (hist.HIST.launches - before[0],
            hist.SPLIT_RECORDS.launches - before[1]) == (24, 24)
    b = XGBoost(device="cpu", **binary).train(frames["cpu"])
    for ta, tb in zip(a.output["trees"], b.output["trees"]):
        for d in range(4):
            va, vb = ta.valid[d].cpu().numpy(), tb.valid[d].numpy()
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(ta.feat[d].cpu().numpy()[va],
                                          tb.feat[d].numpy()[vb])
            np.testing.assert_array_equal(ta.thr[d].cpu().numpy()[va],
                                          tb.thr[d].numpy()[vb])
        np.testing.assert_allclose(ta.values.cpu().numpy(),
                                   tb.values.numpy(), rtol=1e-4, atol=1e-6)
    multi = dict(cfg, response_column="delay_class",
                 ignored_columns=["dep_delayed_15min"], ntrees=3,
                 sample_rate=0.8, col_sample_rate_per_tree=0.7)
    before = hist.HIST.launches
    fus = XGBoost(device="cuda", **multi).train(frames["cuda"])
    torch.cuda.synchronize()
    assert hist.HIST.launches - before == 12
    sep = XGBoost(device="cuda", split_mode="separate", **multi).train(
        frames["cuda"])
    for sa, ss in zip(fus.output["stacked"], sep.output["stacked"]):
        _same_stack(sa, ss)


def test_small_glm_fit_matches_cpu(cuda):
    """GLM on the card (binomial IRLSM, and COD at alpha 0.5 with a
    lambda): coefficients to rtol 1e-4 of the CPU fit's; a second card
    fit bitwise the first; the Gram's matmuls never on TF32."""
    from h2o3_tpu_torch.models import GLM
    assert not torch.backends.cuda.matmul.allow_tf32
    frames = {d: _dart_frame(d, 50_000) for d in ("cuda", "cpu")}
    for kw in (dict(), dict(alpha=0.5, lambda_=1e-3)):
        cfg = dict(response_column="dep_delayed_15min",
                   ignored_columns=["delay_class"], **kw)
        m = {d: GLM(device=d, **cfg).train(frames[d]) for d in frames}
        again = GLM(device="cuda", **cfg).train(frames["cuda"])
        assert not torch.backends.cuda.matmul.allow_tf32
        b, bc = (np.asarray(x.output["beta_std_flat"])
                 for x in (m["cuda"], m["cpu"]))
        assert np.abs(b - bc).max() <= 1e-4 * np.abs(bc).max()
        np.testing.assert_array_equal(
            b, np.asarray(again.output["beta_std_flat"]))


# ------------------------------------------------- DeepLearning and CV

_DL_CFG = dict(response_column="dep_delayed_15min",
               ignored_columns=["delay_class"], hidden=(32, 32),
               precision="f32", mini_batch_size=256,
               train_samples_per_iteration=256 * 20, epochs=1.875,
               stopping_rounds=0, seed=3)


def test_small_dl_train_matches_cpu(cuda):
    """DeepLearning f32 on the card against the same train (the same
    CPU-drawn initial weights, permutation and offsets, and the same
    column rollups: their one-pass f32 sums differ by device) on the CPU:
    60 steps, weights to 1e-4 of the largest, probabilities to 1e-5; a
    second card train bitwise the first."""
    from h2o3_tpu_torch.models import DeepLearning
    frames = {d: _dart_frame(d, 8_192) for d in ("cuda", "cpu")}
    for v, w in zip(frames["cuda"].vecs, frames["cpu"].vecs):
        w._rollups = v.rollups()
    m = {d: DeepLearning(device=d, **_DL_CFG).train(frames[d])
         for d in frames}
    assert m["cuda"].output["samples_trained"] == 60 * 256
    again = DeepLearning(device="cuda", **_DL_CFG).train(frames["cuda"])
    for (W, b), (Wc, bc), (W2, b2) in zip(m["cuda"].output["weights"],
                                          m["cpu"].output["weights"],
                                          again.output["weights"]):
        assert np.abs(W - Wc).max() <= 1e-4 * np.abs(Wc).max()
        assert np.abs(b - bc).max() <= 1e-4 * max(np.abs(bc).max(), 1e-3)
        np.testing.assert_array_equal(W, W2)
        np.testing.assert_array_equal(b, b2)
    p = {d: m[d].predict(frames[d]).vec("YES").to_numpy() for d in m}
    np.testing.assert_allclose(p["cuda"], p["cpu"], rtol=0, atol=1e-5)


def test_dl_bf16_product_is_f32_before_the_bias(cuda):
    """``precision="bf16"`` multiplies bf16 operands on the tensor cores
    into an f32 product: within f32 accumulation of the f64 product of
    the rounded operands, not the bf16-rounded product; its gradients are
    f32; a bf16 train runs."""
    from h2o3_tpu_torch.models import DeepLearning
    from h2o3_tpu_torch.models import deeplearning as dl
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((512, 300), generator=gen, device=cuda,
                    requires_grad=True)
    w = torch.randn((300, 200), generator=gen, device=cuda,
                    requires_grad=True)
    out = dl.product(a, w, bf16=True)
    assert out.dtype == torch.float32
    exact = a.detach().bfloat16().double() @ w.detach().bfloat16().double()
    err = (out.detach().double() - exact).abs().max().item()
    rounded = (out.detach().bfloat16().double() - exact).abs().max().item()
    assert err <= 1e-5 * exact.abs().max().item() < rounded
    out.sum().backward()
    assert a.grad.dtype == w.grad.dtype == torch.float32
    fr = _dart_frame("cuda", 8_192)
    m = DeepLearning(**dict(_DL_CFG, precision="bf16")).train(fr)
    assert np.isfinite(m.training_metrics.logloss)


def test_dl_f32_runs_with_tf32_off(cuda):
    """The f32 path refuses to train with TF32 matmuls allowed, and
    trains with them off (the default)."""
    from h2o3_tpu_torch.models import DeepLearning
    fr = _dart_frame("cuda", 4_096)
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            DeepLearning(**_DL_CFG).train(fr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert np.isfinite(DeepLearning(**_DL_CFG).train(fr)
                       .training_metrics.logloss)


def test_cv_train_fold_count_and_launches(cuda):
    """XGBoost with nfolds=3 on the card: 3 fold models, and one ``hist``
    and one records launch a level of every tree of the 4 models (32 each
    for 2 depth-4 trees)."""
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    fr = _dart_frame("cuda", 8_192)
    before = (hist.HIST.launches, hist.SPLIT_RECORDS.launches)
    m = XGBoost(response_column="dep_delayed_15min",
                ignored_columns=["delay_class"], ntrees=2, max_depth=4,
                nbins=64, seed=1, nfolds=3).train(fr)
    torch.cuda.synchronize()
    assert len(m.output["cv_fold_models"]) == 3
    assert (hist.HIST.launches - before[0],
            hist.SPLIT_RECORDS.launches - before[1]) == (32, 32)
    assert np.isfinite(m.cross_validation_metrics.auc)


# (L, F, nbins, kind): the bench's root and deepest level, a ragged bin
# count, integer and real stats (both with populated NA bins), NaN planes
_MONO_CASES = [(1, 8, 256, "integer"), (32, 8, 256, "real"),
               (64, 13, 33, "integer"), (7, 5, 31, "real"),
               (4, 8, 256, "nan_g"), (4, 8, 256, "nan_h")]


@pytest.mark.parametrize("L,F,nbins,kind", _MONO_CASES)
def test_split_records_mono_equal_plain(cuda, L, F, nbins, kind):
    """The monotone form of the records kernel against its plain version
    on the card and on the CPU, bitwise (NaN bits included), counted in
    its own form; with every constraint 0 it is bitwise the scalar
    form."""
    rng = np.random.default_rng(L * 100 + F + nbins + 7)
    H = _records_hist(rng, L, F, nbins, kind)
    H[..., -1] = np.abs(H[..., -1]) + 1.0          # NA bins with mass
    Hd = torch.from_numpy(H).to(cuda)
    mono = torch.from_numpy(rng.integers(-1, 2, F).astype(np.float32))
    md = mono.to(cuda)
    for prm in ((1.0, 1.0, 0.0, 0.0, 1.0), (0.0, 10.0, 0.5, 0.1, 0.0)):
        lam, mr, alpha, gamma, mcw = prm
        before = (hist.SPLIT_RECORDS_MONO.launches,
                  hist.SPLIT_RECORDS.launches)
        got = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw,
                                 mono=md)
        again = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw,
                                   mono=md)
        want = hist._split_records_torch(Hd, lam, mr, alpha, gamma, mcw, md)
        cpu = hist._split_records_torch(Hd.cpu(), lam, mr, alpha, gamma,
                                        mcw, mono)
        torch.cuda.synchronize()
        assert (hist.SPLIT_RECORDS_MONO.launches,
                hist.SPLIT_RECORDS.launches) == (before[0] + 2, before[1])
        assert same_bits(got, want) and same_bits(again, got)
        np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
        free = hist.split_records(Hd, nbins, lam, mr, alpha, gamma, mcw,
                                  mono=torch.zeros_like(md))
        assert same_bits(free, hist.split_records(Hd, nbins, lam, mr, alpha,
                                                  gamma, mcw))


def _onehot_cols(n=20_000, groups=4, levels=10, seed=3):
    """A one-hot-wide frame (exclusive columns within a group), two
    numerics and a response that rises in num0."""
    rng = np.random.default_rng(seed)
    cols, gidx = {}, []
    for g in range(groups):
        z = rng.integers(0, levels, n)
        gidx.append(z)
        for lv in range(levels):
            cols[f"g{g}_l{lv}"] = (z == lv).astype(np.float32)
    for j in range(2):
        cols[f"num{j}"] = rng.normal(size=n).astype(np.float32)
    cols["y"] = ((gidx[0] % 3 == 0) * 2.0 + 0.5 * (gidx[1] % 2)
                 + np.sin(2.0 * cols["num0"]) + cols["num0"]
                 + 0.05 * rng.normal(size=n)).astype(np.float32)
    return cols


def test_small_bundled_and_monotone_trains_match_cpu(cuda):
    """A bundled GBM (efb="auto") and a monotone GBM on the card against
    the same trains on the CPU: the same bundles, the same splits at every
    valid node, leaf values to rtol 1e-4; the monotone build launches the
    records kernel's monotone form once a level of every tree, the scalar
    form never; the bundled one its scalar form (the raw features)."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree.gbm import GBM
    cols = _onehot_cols()
    cfg = dict(response_column="y", ntrees=3, max_depth=4, nbins=64, seed=1,
               score_tree_interval=10 ** 9)
    for extra in ({}, {"monotone_constraints": {"num0": 1}}):
        models, launches = {}, {}
        for dev in ("cuda", "cpu"):
            fr = Frame.from_numpy(cols, device=dev)
            before = (hist.SPLIT_RECORDS.launches,
                      hist.SPLIT_RECORDS_MONO.launches)
            models[dev] = GBM(device=dev, **cfg, **extra).train(fr)
            launches[dev] = (hist.SPLIT_RECORDS.launches - before[0],
                             hist.SPLIT_RECORDS_MONO.launches - before[1])
        a, b = models["cuda"], models["cpu"]
        if extra:
            assert "efb_bundles" not in a.output
            assert launches["cuda"] == (0, 12)
        else:
            assert a.output["efb_bundles"] == b.output["efb_bundles"] >= 1
            assert launches["cuda"] == (12, 0)
        for ta, tb in zip(a.output["trees"], b.output["trees"]):
            for d in range(len(ta.feat)):
                va, vb = ta.valid[d].cpu().numpy(), tb.valid[d].numpy()
                np.testing.assert_array_equal(va, vb)
                np.testing.assert_array_equal(ta.feat[d].cpu().numpy()[va],
                                              tb.feat[d].numpy()[vb])
                np.testing.assert_array_equal(ta.thr[d].cpu().numpy()[va],
                                              tb.thr[d].numpy()[vb])
            np.testing.assert_allclose(ta.values.cpu().numpy(),
                                       tb.values.numpy(), rtol=1e-4,
                                       atol=1e-6)


# ------------------------------------------- the whole-tree program (scan)

def _scan_cols(n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    cols = {f"x{j}": rng.normal(size=n).astype(np.float32) for j in range(4)}
    cols["k"] = rng.integers(0, 9, n).astype(np.float32)
    z = cols["x0"] + np.sin(cols["x1"]) + 0.3 * (cols["k"] > 4)
    cols["y"] = np.where(z + 0.3 * rng.normal(size=n) > 0.2, "a", "b") \
        .astype(object)
    cols["c"] = np.where(z < -0.5, "lo", np.where(z < 0.7, "mid", "hi")) \
        .astype(object)
    return cols


def _same_stacks(a, b):
    sa = a.output["stacked"] if isinstance(a.output["stacked"], list) \
        else [a.output["stacked"]]
    sb = b.output["stacked"] if isinstance(b.output["stacked"], list) \
        else [b.output["stacked"]]
    for x, y in zip(sa, sb):
        assert (x.ntrees, x.depth) == (y.ntrees, y.depth)
        for la, lb in zip(x.levels, y.levels):
            for p, q in zip(la, lb):
                assert (same_bits(p, q) if p.is_floating_point()
                        else torch.equal(p, q))
        assert same_bits(x.values, y.values)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_scan_train_is_one_graph_replay_a_tree(cuda, kind):
    """An XGBoost under tree_program="scan" on the card: one capture, one
    graph replay a tree (a round of K = 3 trees for the multinomial
    response), the capture's recorded launches one ``hist`` and one
    ``split_records`` a level, a private pool, and every tree bitwise the
    card's level train."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models.tree import shared
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    cols = _scan_cols()
    resp, other = ("y", "c") if kind == "binomial" else ("c", "y")
    cfg = dict(response_column=resp, ignored_columns=[other], ntrees=4,
               max_depth=5, nbins=64, seed=1, score_tree_interval=10 ** 9)
    fr = Frame.from_numpy(cols, device="cuda")
    lv = XGBoost(device="cuda", **cfg).train(fr)
    shared.SCAN_GRAPHS.reset()
    sc = XGBoost(device="cuda", tree_program="scan", **cfg).train(fr)
    g = shared.SCAN_GRAPHS
    assert sc.output["tree_program"] == "scan"
    assert (g.captures, g.replays) == (1, 4)
    assert g.per_replay == {"hist": 5, "split_records": 5}
    assert g.pool_bytes > 0
    _same_stacks(lv, sc)


def test_scan_replays_keep_each_trees_arrays(cuda):
    """One scan build grows two trees (two replays of its one graph): the
    first tree's arrays, cloned out of the graph's static outputs, are
    unchanged by the second replay, and each tree is bitwise the level
    build's on the same inputs."""
    from h2o3_tpu_torch.models.tree import shared
    rng = np.random.default_rng(11)
    F, N, nbins = 6, 50_000, 32
    codes = torch.from_numpy(rng.integers(0, nbins + 1, (F, N))
                             .astype(np.int16)).to(cuda)
    edges = torch.sort(torch.randn(F, nbins), dim=1).values.to(cuda)
    kw = dict(device=cuda, split_mode="fused")
    scan = shared.make_build_tree_fn(5, nbins, F, N, tree_program="scan",
                                     **kw)
    level = shared.make_build_tree_fn(5, nbins, F, N, **kw)
    out, want = [], []
    for t in range(2):
        g = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
        h = torch.ones_like(g)
        args = (codes, g, h, torch.ones_like(g), edges)
        tail = (0.0, 1.0, 1e-5, 0.1, 0.8, None, 0.0, 0.0, 0.0)
        out.append(scan(*args, shared.draw_generator(1, 0, t, 0, cuda),
                        *tail))
        want.append(level(*args, shared.draw_generator(1, 0, t, 0, cuda),
                          *tail))
    assert len(scan.graphs) == 1
    for got, ref in zip(out, want):
        for la, lb in zip(got[0], ref[0]):
            for p, q in zip(la, lb):
                assert (same_bits(p, q) if p.is_floating_point()
                        else torch.equal(p, q))
        assert same_bits(got[1], ref[1]) and torch.equal(got[3], ref[3])


def test_scan_warmup_raises_on_a_host_sync(cuda, monkeypatch):
    """The tree program's warm-up runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation in
    it raises instead of being captured, and the mode is restored."""
    from h2o3_tpu_torch.models.tree import hist, shared
    real = hist.partition

    def syncing(codes, leaf, *a):
        int(leaf.max())                  # reads a device value on the host
        return real(codes, leaf, *a)
    monkeypatch.setattr(hist, "partition", syncing)
    rng = np.random.default_rng(2)
    F, N, nbins = 3, 4096, 16
    codes = torch.from_numpy(rng.integers(0, nbins, (F, N))
                             .astype(np.int16)).to(cuda)
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(cuda)
    build = shared.make_build_tree_fn(3, nbins, F, N, device=cuda,
                                      tree_program="scan")
    mode = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        build(codes, g, torch.ones_like(g), torch.ones_like(g),
              torch.zeros((F, nbins), device=cuda),
              shared.draw_generator(1, 0, 0, 0, cuda), 0.0, 1.0, 1e-5, 0.1,
              1.0, None, 0.0, 0.0, 0.0)
    assert torch.cuda.get_sync_debug_mode() == mode


# ------------------------------------------- the unsupervised families
def _algo_frames(cuda, n=4096, seed=15):
    """A small frame on the card and the same on the CPU: three numerics
    (one with NaN), a 5-level categorical, a binary response, a numeric
    response, a fold column and a survival time and event."""
    from h2o3_tpu_torch.frame import Frame
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    c = rng.integers(0, 5, n)
    eta = X[:, 0] - 0.5 * X[:, 1] + 0.3 * (c == 2)
    T = rng.exponential(1.0 / np.exp(0.6 * X[:, 0]))
    C = rng.exponential(2.0, n)
    cols = {"x0": X[:, 0], "x1": X[:, 1] * 3, "x2": X[:, 2],
            "c": np.array(list("abcde"), dtype=object)[c],
            "y": np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "p",
                          "n").astype(object),
            "yr": eta + rng.normal(size=n),
            "fold": rng.integers(0, 3, n).astype(float),
            "stop": np.round(np.minimum(T, C), 1) + 0.05,
            "event": (T <= C).astype(float)}
    cols["x2"][rng.random(n) < 0.05] = np.nan
    fr, frc = (Frame.from_numpy(cols, device=d) for d in (cuda, "cpu"))
    for v, w in zip(fr.vecs, frc.vecs):
        if v.data is not None:           # both standardize alike
            w._rollups = v.rollups()
    return fr, frc


_UNSUP = ["y", "yr", "fold", "stop", "event"]
_ALGO_CASES = {
    "kmeans": (dict(k=4, seed=1, ignored_columns=_UNSUP),
               ("centers", "init_rows")),
    "aggregator": (dict(target_num_exemplars=20, seed=1,
                        ignored_columns=_UNSUP), ("mapping_counts",)),
    "pca": (dict(k=3, transform="standardize", pca_method="randomized",
                 seed=1, ignored_columns=_UNSUP), ("eigenvectors",)),
    "svd": (dict(nv=3, transform="demean", ignored_columns=_UNSUP),
            ("d", "v")),
    "glrm": (dict(k=2, loss="huber", multi_loss="huber",
                  regularization_x="l1", gamma_x=0.05, max_iterations=10,
                  seed=1, transform="standardize", ignored_columns=_UNSUP),
             ("objective", "accepted")),
    "naivebayes": (dict(response_column="y", laplace=1.0,
                        ignored_columns=["yr", "fold", "stop", "event"]),
                   ("_log_cat_table", "_num_mu")),
    "quantile": (dict(ignored_columns=["c", "y"]), ("quantiles",)),
    "isotonicregression": (dict(response_column="yr", ignored_columns=[
        "x1", "x2", "c", "y", "fold", "stop", "event"]),
        ("thresholds_x", "thresholds_y")),
    "coxph": (dict(stop_column="stop", event_column="event", ties="efron",
                   ignored_columns=["c", "y", "yr", "fold"]),
              ("beta_std", "neg_log_partial_likelihood")),
    "psvm": (dict(response_column="y", seed=1, max_iterations=200,
                  ignored_columns=["yr", "fold", "stop", "event"]),
             ("objective",)),
    "targetencoder": (dict(response_column="y", columns=["c"],
                           data_leakage_handling="k_fold",
                           fold_column="fold", noise=0.01, seed=1),
                      ("encoding_tables",)),
}


def _outputs_close(a, b, key):
    """Card against CPU: arrays to 1e-4 of the largest; other values
    equal."""
    x, y = a.output[key], b.output[key]
    if key in ("encoding_tables", "quantiles", "init_rows", "accepted",
               "mapping_counts"):
        assert repr(x) == repr(y), key
        return
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if key in ("eigenvectors", "v"):
        from h2o3_tpu_torch.models.pca import sign_convention
        x, y = sign_convention(x), sign_convention(y)
    assert np.abs(x - y).max() <= 1e-4 * max(np.abs(y).max(), 1e-30), key


@pytest.mark.parametrize("algo", sorted(_ALGO_CASES))
def test_unsupervised_family_card_against_cpu(cuda, algo):
    """Each new family trains on the card by default: the fit against
    the same fit on the CPU (the same draws; arrays to 1e-4 of the
    largest, selections and host tables equal; for the proximal GLRM
    (huber losses: continuous gradients) and PSVM, whose iterates part
    in the last bits, the objective and the accept/reject sequence), and
    a second card train bitwise the first in every array it outputs."""
    from h2o3_tpu_torch import models
    cls = {m.algo: m for m in (models.KMeans, models.Aggregator,
                               models.PCA, models.SVD, models.GLRM,
                               models.NaiveBayes, models.Quantile,
                               models.IsotonicRegression, models.CoxPH,
                               models.PSVM, models.TargetEncoder)}[algo]
    cfg, keys = _ALGO_CASES[algo]
    fr, frc = _algo_frames(cuda)
    m, m2 = cls(**cfg).train(fr), cls(**cfg).train(fr)
    mc = cls(device="cpu", **cfg).train(frc)
    for key in keys:
        _outputs_close(m, mc, key)
    for key, v in m.output.items():
        if isinstance(v, np.ndarray) or key in keys:
            assert repr(v) == repr(m2.output[key]), key
            if not isinstance(v, (dict, list)):
                assert np.array_equal(np.asarray(v),
                                      np.asarray(m2.output[key])), key


def test_word2vec_card_against_cpu(cuda):
    """Word2Vec on the card: the CPU's vocabulary, embeddings to 1e-4 of
    the largest (the same pairs and negatives), a second train bitwise
    (duplicate rows summed in a fixed order)."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models import Word2Vec
    rng = np.random.default_rng(4)
    words = []
    for _ in range(600):
        words += [f"w{i}" for i in rng.integers(0, 40, rng.integers(3, 12))]
        words.append(None)
    fr = Frame.from_numpy({"w": np.array(words, dtype=object)},
                          types={"w": "str"}, device="cpu")
    cfg = dict(vec_size=16, epochs=3, min_word_freq=2, seed=2,
               batch_size=256, sent_sample_rate=0.01)
    m, m2 = Word2Vec(**cfg).train(fr), Word2Vec(**cfg).train(fr)
    mc = Word2Vec(device="cpu", **cfg).train(fr)
    assert m.output["device"].type == "cuda"
    assert m.output["words"] == mc.output["words"]
    E, Ec = m.output["embeddings"], mc.output["embeddings"]
    assert np.abs(E - Ec).max() <= 1e-4 * np.abs(Ec).max()
    assert np.array_equal(E, m2.output["embeddings"])


# -------------------------------------------- the composite builders
def _composite_frames(cuda, n=20_000):
    """The bench frame's draws at ``n`` rows with a numeric response
    ``yr``, on the card and on the CPU, the CPU frame with the card
    frame's rollups (both standardize alike)."""
    from bench import make_airlines_like
    from h2o3_tpu_torch.frame import Frame
    cols, types, domains = make_airlines_like(n)
    rng = np.random.default_rng(48)
    cols["yr"] = (0.002 * (cols["crs_dep_time"] / 100 - 12) ** 2
                  - 0.0005 * cols["distance"] / 100
                  + 0.1 * rng.normal(size=n)).astype(np.float32)
    fr, frc = (Frame.from_numpy(cols, types=types, domains=domains,
                                device=d) for d in (cuda, "cpu"))
    for v, w in zip(fr.vecs, frc.vecs):
        if v.data is not None:
            w._rollups = v.rollups()
    return fr, frc


def _same_levels(a, b):
    for la, lb in zip(a.levels, b.levels):
        for u, v in zip(la, lb):
            assert torch.equal(u.cpu(), v.cpu())
    assert torch.equal(a.values.cpu(), b.values.cpu())


def test_adaboost_card_equals_its_plain_route(cuda):
    """AdaBoost on the card: one ``hist`` and one records launch per
    level of every learner (10 learners x 3 levels); every learner's
    splits, leaf values and alphas bitwise the same fit through the port's
    plain versions on the card (``testing.plain_route``); a second fit
    bitwise the first."""
    from h2o3_tpu_torch.models import AdaBoost
    from h2o3_tpu_torch.testing import plain_route
    fr, _ = _composite_frames(cuda)
    cfg = dict(response_column="dep_delayed_15min", ignored_columns=["yr"],
               nlearners=10, seed=1)
    before = _launch_counts()
    m = AdaBoost(**cfg).train(fr)
    torch.cuda.synchronize()
    assert _launched(before) == (30, 0, 0, 30)
    m2 = AdaBoost(**cfg).train(fr)
    with plain_route(hist):
        mp = AdaBoost(**cfg).train(fr)
    for other in (m2, mp):
        assert other.output["alphas"] == m.output["alphas"]
        _same_levels(m.output["stacked"], other.output["stacked"])


def test_rulefit_card_rules_and_glm(cuda):
    """RuleFit on the card: the generator's launches (trees x levels),
    the rule columns bitwise those of the plain route's fit, the L1
    GLM's fitted values within 1e-4 of the largest of the same GLM
    fitted on the CPU over the card's rule frame (its coefficients are
    not unique: a rule is the sum of its two children's, so the design
    is singular and the two solves part there), a second fit bitwise."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.models import GLM, RuleFit
    from h2o3_tpu_torch.runtime import dkv
    from h2o3_tpu_torch.testing import plain_route
    fr, frc = _composite_frames(cuda)
    cfg = dict(response_column="yr", ignored_columns=["dep_delayed_15min"],
               rule_generation_ntrees=4, lambda_=1e-3, seed=1)
    before = _launch_counts()
    m = RuleFit(**cfg).train(fr)
    torch.cuda.synchronize()
    assert _launched(before) == (12, 0, 0, 12)
    m2 = RuleFit(**cfg).train(fr)
    with plain_route(hist):
        mp = RuleFit(**cfg).train(fr)
    R = m.rule_columns(fr)
    assert torch.equal(R, m2.rule_columns(fr))
    assert torch.equal(R, mp.rule_columns(fr))
    glm, glm2 = (dkv.get(x.output["glm_key"]) for x in (m, m2))
    b = np.asarray(glm.output["beta_std_flat"])
    assert np.array_equal(b, np.asarray(glm2.output["beta_std_flat"]))
    gf = m._glm_frame(fr, with_response=True)
    gfc = Frame(gf.names, [_vec_on(v, "cpu") for v in gf.vecs])
    for v, w in zip(gf.vecs, gfc.vecs):
        w._rollups = v.rollups()
    gc = GLM(response_column="yr", alpha=1.0, lambda_=1e-3, seed=1,
             device="cpu").train(gfc)
    p = glm.predict(gf).vec("predict").to_numpy()
    pc = gc.predict(gfc).vec("predict").to_numpy()
    assert np.abs(p - pc).max() <= 1e-4 * np.abs(pc).max()


def _vec_on(v, device):
    """A copy of a device Vec on ``device``."""
    from h2o3_tpu_torch.frame.vec import Vec
    return Vec(v.data.to(device), v.type, v.nrows, domain=v.domain)


@pytest.mark.parametrize("family", ["stackedensemble", "gam", "anovaglm",
                                    "modelselection"])
def test_composite_family_card_against_cpu(cuda, family):
    """StackedEnsemble (GBM and GLM bases, nfolds=3), GAM (cr), ANOVAGLM
    and ModelSelection (maxr and maxrsweep) on the card against the same
    fit on the CPU: coefficients within 1e-4 of the largest, the ANOVA
    sums of squares within 1e-4 of the full deviance, the same subsets
    with R^2 within 1e-5; a second card fit bitwise the first."""
    from h2o3_tpu_torch import models
    from h2o3_tpu_torch.runtime import dkv
    fr, frc = _composite_frames(cuda)
    reg = dict(response_column="yr", ignored_columns=["dep_delayed_15min"],
               seed=1)

    def fit(dev, frame):
        if family == "stackedensemble":
            base = dict(response_column="dep_delayed_15min",
                        ignored_columns=["yr"], nfolds=3, seed=1,
                        keep_cross_validation_predictions=True, device=dev)
            bases = [models.GBM(ntrees=5, max_depth=4, **base).train(frame),
                     models.GLM(**base).train(frame)]
            m = models.StackedEnsemble(
                response_column="dep_delayed_15min", base_models=bases,
                seed=1, device=dev).train(frame)
            return [dkv.get(m.output["metalearner_key"])
                    .output["beta_std_flat"]]
        if family == "gam":
            m = models.GAM(gam_columns=["crs_dep_time"], device=dev,
                           **reg).train(frame)
            return [dkv.get(m.output["glm_key"]).output["beta_std_flat"]]
        if family == "anovaglm":
            m = models.ANOVAGLM(device=dev, **reg).train(frame)
            dev_full = dkv.get(m.output["full_model"]) \
                .output["residual_deviance"]
            return [[r["ss"] / dev_full for r in m.output["anova_table"]]]
        out = []
        for mode in ("maxr", "maxrsweep"):
            m = models.ModelSelection(mode=mode, max_predictor_number=2,
                                      device=dev, **reg).train(frame)
            out.append([r["metric"] for r in m.output["subsets"]])
            out.append([", ".join(r["predictors"])
                        for r in m.output["subsets"]])
        return out

    got, again, cpu = fit("cuda", fr), fit("cuda", fr), fit("cpu", frc)
    for a, b, c in zip(got, again, cpu):
        assert repr(a) == repr(b)
        if isinstance(a[0], str):
            assert a == c
            continue
        a, c = np.asarray(a, np.float64), np.asarray(c, np.float64)
        tol = 1e-5 if family == "modelselection" else 1e-4
        assert np.abs(a - c).max() <= tol * max(np.abs(c).max(), 1.0)


def test_group_by_on_the_card_bitwise_run_to_run(cuda):
    """A group-by of 300k rows over two keys (NA keys among them) on the
    card: a second run bitwise the first (each group's sums reduce its
    run of the sorted rows in a fixed order, no float atomics); keys,
    counts, min and max bitwise the CPU's; sums, means and sds within
    1e-6 of the largest |value| (f64 sums in another order, stored as
    f32)."""
    from h2o3_tpu_torch.frame import Frame
    from h2o3_tpu_torch.rapids import ops
    rng = np.random.default_rng(17)
    n = 300_000
    k = rng.integers(0, 50, n).astype(np.int32)
    k[rng.random(n) < 0.01] = -1
    cols = {"k": k, "g": rng.integers(0, 40, n).astype(np.float64),
            "x": rng.normal(10.0, 3.0, n)}
    kw = dict(types={"k": "cat"}, domains={"k": [str(i) for i in range(50)]})
    aggs = {"x": ["count", "sum", "mean", "min", "max", "sd"]}
    fr = Frame.from_numpy(cols, device=cuda, **kw)
    frc = Frame.from_numpy(cols, device="cpu", **kw)
    a, b = (ops.group_by(fr, ["k", "g"], aggs) for _ in range(2))
    c = ops.group_by(frc, ["k", "g"], aggs)
    assert a.nrows == c.nrows > 1500
    for name in a.names:
        x, y, z = (f.vec(name).to_numpy() for f in (a, b, c))
        assert np.array_equal(np.asarray(x).view(np.uint8),
                              np.asarray(y).view(np.uint8)), name
        if name in ("k", "g", "count_x", "min_x", "max_x"):
            np.testing.assert_array_equal(x, z, err_msg=name)
        else:
            assert np.abs(x - z).max() <= 1e-6 * np.abs(z).max(), name
