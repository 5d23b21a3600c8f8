"""The port's CUDA kernels (traversal, level histograms, split records)
against their plain torch versions, and a small train against the CPU
plain route, on the card.  Every test here needs a CUDA device and nvcc;
without them it skips.  On a CUDA machine run them with:

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


def _assert_hist_close(got, want, integer):
    """Integer-valued stats: bitwise (every sum exact).  Real stats:
    ``want`` is the plain version in f64, and the kernel's f32 sums (in
    a run-dependent atomic order) lie within 1e-5 of each plane's total
    of it."""
    if integer:
        assert torch.equal(got, want)
        return
    for s in range(3):
        a, b = (got[s], want[s]) if want.dim() == 4 else \
            (got[:, s::3], want[:, s::3])
        scale = max(float(b.abs().sum()), 1.0)
        err = float((a.double() - b).abs().max())
        assert err <= 1e-5 * scale, (s, err, scale)


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
    want = hist.hist_uniform_torch(codes, leaf,
                                   st if integer else st.double(), L,
                                   nbins + 1)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 1
    assert got.shape == (3, L, F, nbins + 1)
    _assert_hist_close(got, want, integer)


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
    want = hist.hist_varbin_torch(g, leaf, st if integer else st.double(),
                                  L, layout)
    torch.cuda.synchronize()
    assert hist.HIST.launches == before + 1
    _assert_hist_close(got, want, integer)
    dense = hist.expand_varbin(got, bc, L, nbins + 1)
    ref = hist.hist_uniform_torch(codes, leaf,
                                  st if integer else st.double(), L,
                                  nbins + 1)
    _assert_hist_close(dense, ref, integer)


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
