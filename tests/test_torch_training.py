"""h2o3_tpu_torch's training slice held against the JAX package.

The same numpy inputs from one seed go through the JAX function and its
port, module by module and for the slice as a whole: binning (codes and
edges bitwise), the level histograms (against the Pallas kernels in
interpret mode and the einsum program), the subtract level, the split
records, ``finish_splits`` and ``partition``, and an XGBoost trained by
both packages on the airlines-shaped bench frame.  All of it runs on the
CPU, where the port's kernel wrappers take their plain torch versions.

Tolerances.  The JAX side runs on the suite's 8-device CPU mesh: its
subtract path orients and sums per shard and psums the shard
histograms, and its einsum contracts in another order, so histogram sums
agree bitwise only where the stats are integer-valued (every partial sum
is then exact — the trick of tests/test_mesh_hier.py) and to 1e-5 of each
plane's total otherwise.  The port's histograms are int64 fixed point
(each stat rounded once onto a power-of-two scale, every sum exact): on
real-valued stats they are bitwise an independent numpy implementation
of that contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models.tree import binning as jbin
from h2o3_tpu.models.tree import hist as jhist

from bench import make_airlines_like

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models.tree import binning, hist
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.serving import batcher
from h2o3_tpu_torch.testing import tie_hist

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)

N_BIN = 4032          # a multiple of the JAX mesh's 64-row padding
# the slice's frame: 3,904 rows (also a multiple of 64), chosen because
# every split of the 5-tree model wins by a clear gain margin (see
# test_slice_trees_match_jax); at 4,032 rows one level-3 node has two
# features within 5e-6 relative gain, which f32 noise may order either way
N_SLICE = 3904


def _airlines(n, nan_share=0.05, seed=1):
    cols, types, domains = make_airlines_like(n)
    rng = np.random.default_rng(seed)
    for k in ("year", "distance", "crs_dep_time"):
        cols[k] = cols[k].copy()
        cols[k][rng.random(n) < nan_share] = np.nan
    return cols, types, domains


def _stats(rng, n, integer):
    if integer:
        return np.stack([rng.integers(-3, 4, n), rng.integers(0, 3, n),
                         rng.integers(0, 2, n)]).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    return np.stack([p - (rng.random(n) < 0.4), p * (1 - p),
                     (rng.random(n) < 0.9)]).astype(np.float32)


def _close(got, want, integer):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
        return
    for s in range(want.shape[0]):
        scale = max(float(np.abs(want[s]).sum()), 1.0)
        assert float(np.abs(got[s] - want[s]).max()) <= 1e-5 * scale


# ------------------------------------------------------------ (a) binning

@pytest.mark.parametrize("nbins", [32, 256])
def test_binning_codes_and_edges_bitwise(nbins):
    cols, types, domains = _airlines(N_BIN)
    feats = [c for c in cols if c != "dep_delayed_15min"]
    a = jbin.fit_bins(JFrame.from_numpy(cols, types=types, domains=domains),
                      feats, nbins=nbins, seed=1)
    b = binning.fit_bins(Frame.from_numpy(cols, types=types, domains=domains,
                                          device="cpu"),
                         feats, nbins=nbins, seed=1)
    assert a.bin_counts == b.bin_counts
    for ea, eb in zip(a.edges, b.edges):
        assert ea.dtype == eb.dtype == np.float32
        np.testing.assert_array_equal(ea.view(np.int32), eb.view(np.int32))
    np.testing.assert_array_equal(np.asarray(a.codes)[:, :N_BIN],
                                  b.codes.numpy()[:, :N_BIN])
    np.testing.assert_array_equal(binning.edges_matrix(b.edges, nbins),
                                  jbin.edges_matrix(a.edges, nbins))


# --------------------------------------------------------- (b) histograms

def _hist_case(seed, n, F, nbins, L, integer):
    rng = np.random.default_rng(seed)
    bin_counts = (7, nbins, 22, 3, nbins - 5)[:F]
    codes = np.stack([np.where(rng.random(n) < 0.1, nbins,
                               rng.integers(0, bc, n))
                      for bc in bin_counts]).astype(np.int32)
    leaf = rng.integers(0, L, n).astype(np.int32)
    return bin_counts, codes, leaf, _stats(rng, n, integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("L", [1, 4])
def test_hist_uniform_vs_pallas_and_einsum(L, integer):
    n, F, nbins = 2048, 5, 64
    B = nbins + 1
    _, codes, leaf, st = _hist_case(L + 10 * integer, n, F, nbins, L, integer)
    got = hist.local_hist(torch.from_numpy(codes), torch.from_numpy(leaf),
                          torch.from_numpy(st), L, F, B).numpy()
    jargs = (jnp.asarray(codes), jnp.asarray(leaf), *map(jnp.asarray, st))
    pallas = jhist.make_hist_fn(L, F, B, n, force_impl="pallas_interpret",
                                precision="f32")(*jargs)
    einsum = jhist.make_hist_fn(L, F, B, n, force_impl="einsum")(*jargs)
    _close(got, pallas, integer)
    _close(got, einsum, integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("L", [1, 4])
def test_hist_varbin_vs_pallas_and_dense(L, integer):
    n, F, nbins = 2048, 5, 64
    B = nbins + 1
    bc, codes, leaf, st = _hist_case(L + 20 * integer, n, F, nbins, L,
                                     integer)
    gcodes = hist.offset_codes(torch.from_numpy(codes), bc, nbins)
    jg = jhist.offset_codes(jnp.asarray(codes), bc, nbins)
    np.testing.assert_array_equal(gcodes.numpy(), np.asarray(jg))
    assert gcodes.dtype == torch.int16
    packed = hist.hist_varbin(gcodes, torch.from_numpy(leaf),
                              torch.from_numpy(st), L, bc, B)
    raw = jhist._make_pallas_varbin_hist(L, F, bc, B, n, interpret=True,
                                         precision="f32")(
        jg, jnp.asarray(leaf), *map(jnp.asarray, st))
    _close(packed.numpy()[None], np.asarray(raw)[None], integer)
    dense = hist.local_hist(gcodes, torch.from_numpy(leaf),
                            torch.from_numpy(st), L, F, B,
                            bin_counts=bc).numpy()
    ref = jhist.make_hist_fn(L, F, B, n, force_impl="einsum")(
        jnp.asarray(codes), jnp.asarray(leaf), *map(jnp.asarray, st))
    _close(dense, ref, integer)


def _np_fixed_point(st):
    """An independent numpy reading of the fixed-point contract: each
    plane's scale 2^s with sum|x| * 2^s < 2^62, the stats rounded
    half to even to int64, and each plane's inverse scale (NaN where the
    plane holds a non-finite stat)."""
    m = np.abs(st.astype(np.float64)).sum(axis=1)
    finite = np.isfinite(m)
    e = np.frexp(np.where(finite, m, 0.0))[1]            # m < 2^e
    s = 62 - e
    q = np.rint(st.astype(np.float64) * np.ldexp(1.0, s)[:, None])
    q = np.where(finite[:, None], q, 0.0).astype(np.int64)
    return q, np.where(finite, np.ldexp(1.0, -s), np.nan)


def _np_uniform_hist(codes, leaf, st, L, B, planes=3):
    """[planes, L, F, B]: np.add.at of the int64 fixed-point stats, then
    int64 -> f64 -> x 2^-s -> f32."""
    F, n = codes.shape
    q, inv = _np_fixed_point(st)
    if planes == 4:
        q, inv = np.concatenate([q, np.abs(q[:1])]), inv[[0, 1, 2, 0]]
    H = np.zeros((planes, L, F, B), np.int64)
    for f in range(F):
        ok = (leaf >= 0) & (leaf < L) & (codes[f] >= 0) & (codes[f] < B)
        for p in range(planes):
            np.add.at(H[p], (leaf[ok], f, codes[f][ok]), q[p][ok])
    return (H.astype(np.float64) * inv[:, None, None, None]).astype(
        np.float32)


@pytest.mark.parametrize("L", [1, 4])
def test_hist_plain_versions_equal_numpy_fixed_point(L):
    """The quantised plain versions, on real-valued stats, are bitwise an
    independent numpy int64 implementation of the same contract, and the
    packed layout expands to the uniform histogram bitwise (both sum the
    same quantised values exactly)."""
    n, F, nbins = 3001, 5, 64
    B = nbins + 1
    bc, codes, leaf, st = _hist_case(40 + L, n, F, nbins, L, False)
    leaf[::7] = -1
    st[0] *= 1e3                     # planes of unlike magnitudes
    want = _np_uniform_hist(codes, leaf, st, L, B)
    t = [torch.from_numpy(a) for a in (codes, leaf, st)]
    got = hist.hist_uniform(*t, L, B).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    g = hist.offset_codes(t[0], bc, nbins)
    dense = hist.local_hist(g, t[1], t[2], L, F, B, bin_counts=bc).numpy()
    np.testing.assert_array_equal(dense.view(np.int32),
                                  want.view(np.int32))


def test_hist_scale_bound_and_integer_stats():
    """The scale puts the largest possible slot (every row, all of one
    sign, in one slot) just under 2^62: it does not wrap, for n a power
    of two and for one row more; integer-valued stats stay exact; a
    caller's scale of more rows gives the same sums."""
    for n in (4096, 4097):
        for m in (np.float32(1.0), np.float32(0.75),
                  np.nextafter(np.float32(2.0), np.float32(0))):
            st = np.stack([np.full(n, -m), np.full(n, m),
                           np.ones(n)]).astype(np.float32)
            t = torch.from_numpy(st)
            scale = hist.stat_scale(t)
            q = hist.quantize(t, scale)
            total = q.abs().sum(dim=1)
            assert (total < 2 ** 62).all() and (total >= 2 ** 60).all()
            codes = torch.zeros((2, n), dtype=torch.int32)
            leaf = torch.zeros(n, dtype=torch.int32)
            H = hist.hist_uniform(codes, leaf, t, 1, 3, planes=4).numpy()
            exact = np.float32(n * np.float64(m))
            assert H[0, 0, 0, 0] == -exact and H[1, 0, 0, 0] == exact
            assert H[3, 0, 0, 0] == exact and H[2, 0, 0, 0] == n
    rng = np.random.default_rng(9)
    n = 5000
    codes = rng.integers(0, 9, (3, n)).astype(np.int32)
    leaf = rng.integers(0, 2, n).astype(np.int32)
    st = np.stack([rng.integers(-2 ** 20, 2 ** 20, n),
                   rng.integers(0, 2 ** 21, n),
                   rng.integers(0, 2, n)]).astype(np.float32)
    want = np.zeros((3, 2, 3, 9), np.int64)
    for f in range(3):
        for p in range(3):
            np.add.at(want[p], (leaf, f, codes[f]), st[p].astype(np.int64))
    t = [torch.from_numpy(a) for a in (codes, leaf, st)]
    got = hist.hist_uniform(*t, 2, 9)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    wide = hist.stat_scale(torch.from_numpy(np.tile(st, 8)))
    assert (wide[0] < hist.stat_scale(t[2])[0]).all()
    np.testing.assert_array_equal(
        hist.hist_uniform(*t, 2, 9, scale=wide).numpy(), got.numpy())
    with pytest.raises(ValueError, match="scale"):
        hist.hist_uniform(*t, 2, 9, scale=wide.float())


@pytest.mark.parametrize("case", ["weights", "outlier"])
def test_hist_wide_range_stats_small_leaf(case):
    """Stats over many magnitudes on the one scale of their tree: a
    weights column spanning 1e-4 to 1e3 (g, h and w all weighted), or a
    gaussian g with one residual of 1e6.  Rows of leaf -1 stand for the
    rest of the tree: they set the scale but land in no slot.  A small
    leaf holds 12 rows of the smallest stats.  Every slot of k rows is
    within k * 2^-(s+1) plus half an f32 spacing of its f64 sum; the
    small leaf's slots are within one f32 spacing of it, as the JAX
    einsum's are; the whole histogram is within the f32 tolerance of the
    einsum."""
    rng = np.random.default_rng(31)
    n, F, nbins, L = 20000, 3, 16, 4
    B = nbins + 1
    codes = rng.integers(0, B, (F, n)).astype(np.int32)
    leaf = rng.integers(-1, L - 1, n).astype(np.int32)
    small = rng.choice(n, 12, replace=False)
    leaf[small] = L - 1
    p = rng.random(n)
    g, h = p - (rng.random(n) < p), p * (1 - p)
    if case == "weights":
        w = 10.0 ** rng.uniform(-4, 3, n)
        w[small] = 10.0 ** rng.uniform(-4, -3, small.size)
        st = np.stack([w * g, w * h, w])
    else:
        g = rng.normal(size=n)
        g[small] *= 1e-4
        g[np.flatnonzero(leaf == 0)[0]] = 1e6
        st = np.stack([g, np.ones(n), np.ones(n)])
    st = st.astype(np.float32)
    t = [torch.from_numpy(a) for a in (codes, leaf, st)]
    got = hist.hist_uniform(*t, L, B).numpy()
    inv = hist.stat_scale(t[2])[1].numpy()                # 2^-s
    truth = np.zeros((3, L, F, B))
    k = np.zeros((L, F, B))
    mag = np.zeros((3, L, F, B))
    ok = leaf >= 0
    for f in range(F):
        at = (leaf[ok], f, codes[f][ok])
        np.add.at(k, at, 1.0)
        for q in range(3):
            np.add.at(truth[q], at, st[q][ok].astype(np.float64))
            np.add.at(mag[q], at, np.abs(st[q][ok]).astype(np.float64))
    err = np.abs(got - truth)
    bound = (k * 0.5 * inv[:, None, None, None]
             + 0.5 * np.spacing(np.abs(got)) + 2.0 ** -50 * mag)
    assert (err <= bound).all()
    einsum = np.asarray(jhist.make_hist_fn(L, F, B, n, force_impl="einsum")(
        jnp.asarray(codes), jnp.asarray(leaf), *map(jnp.asarray, st)))
    _close(got, einsum, False)
    want = truth[:, L - 1].astype(np.float32)
    np.testing.assert_array_max_ulp(got[:, L - 1], want, maxulp=1)
    np.testing.assert_array_max_ulp(einsum[:, L - 1], want, maxulp=1)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_hist_non_finite_stat_is_never_finite(bad):
    """A NaN or infinite stat on any row, in or out of the level's leaves:
    the JAX package's einsum program makes that plane non-finite
    throughout, and so does the port (NaN; the Pallas kernel makes a
    part of those slots non-finite, every one of them NaN here too); the
    other planes keep their sums."""
    n, F, nbins, L = 2048, 5, 64, 4
    B = nbins + 1
    bc, codes, leaf, st = _hist_case(77, n, F, nbins, L, False)
    for row_leaf in (2, -1):
        s2, lf2 = st.copy(), leaf.copy()
        s2[1, 100], lf2[100] = bad, row_leaf
        t = [torch.from_numpy(a) for a in (codes, lf2, s2)]
        got = hist.local_hist(*t, L, F, B).numpy()
        g = hist.offset_codes(t[0], bc, nbins)
        packed = hist.local_hist(g, t[1], t[2], L, F, B,
                                 bin_counts=bc).numpy()
        jargs = (jnp.asarray(codes), jnp.asarray(lf2),
                 *map(jnp.asarray, s2))
        einsum = np.asarray(jhist.make_hist_fn(
            L, F, B, n, force_impl="einsum")(*jargs))
        pallas = np.asarray(jhist.make_hist_fn(
            L, F, B, n, force_impl="pallas_interpret",
            precision="f32")(*jargs))
        assert not np.isfinite(einsum[1]).any()
        for H in (got, packed):
            assert np.isnan(H[1]).all()
            assert np.isnan(H[1][~np.isfinite(pallas[1])]).all()
            _close(H[[0, 2]], einsum[[0, 2]], False)
        plain = hist.hist_uniform_torch(*t, L, B).numpy()
        np.testing.assert_array_equal(plain, got)


def test_hist_tiles_cover_the_output_once():
    """The kernel's tiles partition the [Q, L] output: every (packed bin,
    leaf) in exactly one tile, each tile of three 8-byte int64 sums per
    (bin, leaf) within the shared-memory budget (or flagged for global
    atomics)."""
    bc = (21, 12, 7, 256, 256, 22, 256, 256)           # the bench frame
    for layout in (hist.packed_layout(bc, 257), hist.uniform_layout(8, 257),
                   hist.uniform_layout(3, 20_000)):
        for L in (1, 2, 8, 32, 64, 256):
            tiles, smem = hist.hist_tiles(layout, L)
            seen = np.zeros((layout.Q, L), np.int32)
            for fa, fb, qa, qn, l0, ln, use_smem, copies in tiles:
                seen[qa:qa + qn, l0:l0 + ln] += 1
                assert qa == layout.qstart[fa]
                assert qa + qn == layout.qstart[fb - 1] + layout.qlen[fb - 1]
                if use_smem:
                    assert qn * ln * 24 <= hist.HIST_SMEM_BUDGET
                    assert copies * (qn * ln * 24 + 8 * (copies > 1)) \
                        <= smem
            assert (seen == 1).all()


# ------------------------------------------------------ (c) subtract level

@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_subtract_levels(integer, varbin):
    n, F, nbins = 2048, 5, 64
    B = nbins + 1
    bc, codes, _, st = _hist_case(7 + integer, n, F, nbins, 1, integer)
    rng = np.random.default_rng(5)
    jargs_st = tuple(map(jnp.asarray, st))
    tcodes = torch.from_numpy(codes)
    lcodes = hist.offset_codes(tcodes, bc, nbins) if varbin else tcodes
    leaf = np.zeros(n, np.int32)
    jcarry = carry = None
    for d in range(4):
        if d:
            leaf = 2 * leaf + (rng.random(n) < 0.35 + 0.1 * d)
            leaf = leaf.astype(np.int32)
        jfn = jhist.make_subtract_level_fn(d, F, B, n)
        jl = (jnp.asarray(codes), jnp.asarray(leaf)) + jargs_st
        jH, jcarry = jfn(*jl) if d == 0 else jfn(*jl, jcarry)
        fn = hist.make_subtract_level_fn(
            d, F, B, bin_counts=bc if varbin else None)
        H, carry = fn(lcodes, torch.from_numpy(leaf),
                      *torch.from_numpy(st), carry)
        assert H.shape == (3, 2 ** d, F, B)
        _close(H.numpy(), jH, integer)


def test_expand_varbin_caches_its_gather_map():
    """The dense gather map goes to the device once per (bin_counts, B,
    device): a second call reuses the cached tensor (no host-to-device copy
    per level) and expands bitwise as the first."""
    bc, B, L = (5, 3, 17, 1), 18, 3
    Q = hist.packed_layout(bc, B).Q
    packed = torch.from_numpy(np.random.default_rng(8).normal(
        size=(Q, 3 * L)).astype(np.float32))
    hist._qmap_device.cache_clear()
    first = hist.expand_varbin(packed, bc, L, B)
    qd = hist._qmap_device(bc, B, "cpu")
    again = hist.expand_varbin(packed, bc, L, B)
    info = hist._qmap_device.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    assert hist._qmap_device(bc, B, "cpu") is qd
    assert torch.equal(first, again)
    want = packed.numpy()[hist._qmap_dense(bc, B)].reshape(
        len(bc), B, L, 3).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(first.numpy(), want)


# ---------------------------------------------------- (d) split records

def _level_hist(seed, L, F, nbins, integer):
    rng = np.random.default_rng(seed)
    B = nbins + 1
    if integer:
        H = np.stack([rng.integers(-20, 21, (L, F, B)),
                      rng.integers(0, 30, (L, F, B)),
                      rng.integers(0, 40, (L, F, B))])
    else:
        H = np.stack([rng.normal(size=(L, F, B)) * 3,
                      rng.random((L, F, B)) * 5,
                      rng.integers(0, 40, (L, F, B))])
    H = H.astype(np.float32)
    H[:, :, :, rng.random(B) < 0.1] = 0.0
    return H


_PARAMS = [(1.0, 1.0, 0.0, 0.0, 1.0), (0.0, 10.0, 0.5, 0.1, 0.0)]


def _records_case(kind, prm):
    """(H, nbins, params) of one records case: random H (integer or real
    valued) at nbins = 31, or an edge case of the kernel's argmax on
    integer-valued H: a plane made NaN by a non-finite stat, every gain
    -inf (min_rows out of reach), a tie of bins 3 and 35 and one of bins
    3 and 20, nbins = 2 and 33."""
    if kind in ("integer", "real"):
        integer = kind == "integer"
        return _level_hist(3 + integer, 4, 5, 31, integer), 31, prm
    if kind.startswith("nbins"):
        nbins = int(kind[5:])
        return _level_hist(17 + nbins, 4, 5, nbins, True), nbins, prm
    if kind.startswith("tie"):
        a, b = (int(x) for x in kind.split("_")[1:])
        return tie_hist(a, b, 2, 3), a + b + 2, prm
    H = _level_hist(19, 4, 5, 31, True)
    if kind == "all_gains_neg_inf":
        return H, 31, (prm[0], 1e9) + tuple(prm[2:])
    H["gw".index(kind[4]) * 2] = np.nan        # nan_g_plane, nan_w_plane
    return H, 31, prm


_RECORDS_KINDS = [pytest.param("integer", id="True"),
                  pytest.param("real", id="False"),
                  "nan_g_plane", "nan_w_plane", "all_gains_neg_inf",
                  "tie_3_35", "tie_3_20", "nbins2", "nbins33"]


@pytest.mark.parametrize("prm", _PARAMS)
@pytest.mark.parametrize("kind", _RECORDS_KINDS)
def test_split_records_vs_xla_and_pallas(kind, prm):
    H, nbins, (lam, mr, alpha, gamma, mcw) = _records_case(kind, prm)
    got = hist.split_records(torch.from_numpy(H), nbins, lam, mr, alpha,
                             gamma, mcw).numpy()
    xla = np.asarray(jhist._split_records_xla(jnp.asarray(H), lam, mr, alpha,
                                              gamma, mcw))
    pallas = np.asarray(jhist.split_records(
        jnp.asarray(H), nbins, lam, mr, alpha, gamma, mcw,
        force_impl="pallas_interpret"))
    if kind != "real":
        # integer-valued H: every partial sum is exact on each side
        np.testing.assert_array_equal(got, xla)
        if kind == "nan_g_plane":
            # NaN gains: argmax takes the first NaN in the port and in
            # _split_records_xla; the TPU kernel's `gain == max` never
            # holds for a NaN max, so there it picks no bin
            assert np.isnan(got[..., 0]).all()
            assert (pallas[..., 1] == nbins + 1).all()
        else:
            np.testing.assert_array_equal(got, pallas)
        if kind in ("all_gains_neg_inf", "nan_w_plane"):
            assert (got[..., 0] == -np.inf).all() and (got[..., 1] == 0).all()
        if kind.startswith("tie"):
            assert (got[..., 1] == 3).all()     # the first of the two bins
        return
    # real H: the prefix sums run in another order on each side (JAX's
    # associative scan, the TPU kernel's matmul, the port's sequential
    # f32 adds), so the sums differ in their last bits and the gains by a
    # few ulps; the argmax agrees where no two bins tie that closely
    for ref in (xla, pallas):
        same_bin = got[..., 1] == ref[..., 1]
        assert same_bin.mean() > 0.95
        np.testing.assert_allclose(got[..., 9:], ref[..., 9:], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[same_bin][:, 0],
                                   ref[same_bin][:, 0], rtol=1e-4, atol=1e-4)


def test_finish_splits_and_partition_bitwise():
    L, F, nbins = 8, 5, 31
    H = _level_hist(11, L, F, nbins, True)
    rec = np.array(jhist._split_records_xla(jnp.asarray(H), 1.0, 1.0, 0.0,
                                            0.0, 1.0))
    mask = np.random.default_rng(2).random((L, F)) < 0.8
    for fm in (None, mask):
        a = jhist.finish_splits(jnp.asarray(rec), 1.0, 1e-5,
                                None if fm is None else jnp.asarray(fm))
        b = hist.finish_splits(torch.from_numpy(rec), 1.0, 1e-5,
                               None if fm is None else torch.from_numpy(fm))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        feat, bin_, na_left, _, valid, _ = b
    rng = np.random.default_rng(4)
    n = 3000
    codes = np.stack([np.where(rng.random(n) < 0.1, nbins,
                               rng.integers(0, nbins, n))
                      for _ in range(F)]).astype(np.int32)
    leaf = rng.integers(0, L, n).astype(np.int32)
    want = jhist.partition(jnp.asarray(codes), jnp.asarray(leaf),
                           jnp.asarray(feat.numpy()), jnp.asarray(bin_.numpy()),
                           jnp.asarray(na_left.numpy()),
                           jnp.asarray(valid.numpy()), jnp.int32(nbins))
    got = hist.partition(torch.from_numpy(codes), torch.from_numpy(leaf),
                         feat, bin_, na_left, valid, nbins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_best_splits_equals_fused():
    """The separate oracle and the fused records path pick the same split,
    and on integer-valued H both are bitwise the JAX package's
    multi-pass ``best_splits``, with and without a feature mask."""
    mask = np.random.default_rng(6).random((8, 5)) < 0.7
    for integer in (False, True):
        Hn = _level_hist(13, 8, 5, 31, integer)
        H = torch.from_numpy(Hn)
        for fm in (None, mask):
            tm = None if fm is None else torch.from_numpy(fm)
            a = hist.best_splits(H, 31, 1.0, 1.0, 1e-5, tm, 0.0, 0.0, 1.0)
            b = hist.fused_best_splits(H, 31, 1.0, 1.0, 1e-5, tm, 0.0, 0.0,
                                       1.0)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
            if not integer:
                continue
            want = jhist.best_splits(jnp.asarray(Hn), 31, 1.0, 1.0, 1e-5,
                                     None if fm is None else jnp.asarray(fm),
                                     0.0, 0.0, 1.0)
            for x, y in zip(want, a):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())


# ---------------------------------------------------------- (e) the slice

_CFG = dict(response_column="dep_delayed_15min", max_depth=4, nbins=32,
            seed=1, ntrees=5, score_tree_interval=10 ** 9)


@pytest.fixture(scope="module")
def port_trained():
    # the frame as bench_trees makes it, with no missing values: every NA
    # bucket is then exactly empty, so NA directions cannot tie by noise
    # (on a frame with NaNs, a node whose NA bucket empties keeps an f32
    # residue from the subtraction, and the NA direction follows that
    # noise in either package)
    cols, types, domains = make_airlines_like(N_SLICE)
    jfr = JFrame.from_numpy(cols, types=types, domains=domains)
    fr = Frame.from_numpy(cols, types=types, domains=domains, device="cpu")
    return cols, jfr, fr, XGBoost(device="cpu", **_CFG).train(fr)


@pytest.fixture(scope="module")
def trained(port_trained):
    """The port's train and the JAX package's: only the tests that read
    the JAX model ask for it, so an xdist worker that runs none of them
    never trains it."""
    cols, jfr, fr, tm = port_trained
    return cols, jfr, JXGBoost(**_CFG).train(jfr), fr, tm


def test_slice_trees_match_jax(trained, monkeypatch):
    """Every level of every tree: the same (feat, na_left, valid), the
    thresholds bitwise (so the same bin), leaf values to rtol 1e-4.

    The frame's signal leaves no near-tied gains: retraining with the
    records captured, every valid node of every tree has its winning
    feature ahead of the runner-up feature by more than 1e-3 of the gain,
    far above the f32 noise of the two packages' summation orders."""
    _, _, jm, fr, tm = trained
    jt, tt = list(jm.output["trees"]), list(tm.output["trees"])
    assert len(jt) == len(tt) == 5
    for a, b in zip(jt, tt):
        assert len(a.feat) == len(b.feat) == 4
        for d in range(4):
            for name in ("feat", "na_left", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {d}")
            np.testing.assert_array_equal(
                np.asarray(a.thr[d]).view(np.int32),
                b.thr[d].numpy().view(np.int32))
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=1e-4, atol=1e-7)

    records = []
    real = hist.split_records

    def spy(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]
    monkeypatch.setattr(hist, "split_records", spy)
    again = XGBoost(device="cpu", **_CFG).train(fr)
    margins = []
    for t, tree in enumerate(again.output["trees"]):
        for d in range(4):
            gains = records[4 * t + d][..., 0].sort(
                dim=1, descending=True).values
            for l in np.flatnonzero(tree.valid[d].numpy()):
                top, second = float(gains[l, 0]), float(gains[l, 1])
                margins.append((top - second) / abs(top))
    assert len(records) == 20 and margins
    assert min(margins) > 1e-3, min(margins)


def test_slice_predictions_and_metrics_match_jax(trained):
    cols, jfr, jm, fr, tm = trained
    pj = np.asarray(jm.predict(jfr).vec("YES").to_numpy())
    pt = tm.predict(fr).vec("YES").to_numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    a, b = jm.training_metrics, tm.training_metrics
    assert abs(a.auc - b.auc) <= 1e-5
    assert abs(a.logloss - b.logloss) <= 1e-5


def test_trained_port_model_publishes(port_trained):
    """The ROADMAP gate: a trained port model publishes into the serving
    plane (through to_archive + from_reference) and answers predict_rows
    as model.predict does."""
    cols, _, fr, tm = port_trained
    n = 300
    rows = []
    for i in range(n):
        r = {}
        for k, v in cols.items():
            if k == "dep_delayed_15min":
                continue
            if k in ("carrier", "origin", "dest"):
                r[k] = str(int(v[i]))
            elif not np.isnan(v[i]):
                r[k] = float(v[i])
        rows.append(r)
    ent = batcher.publish("torch-training-test", tm, device="cpu")
    try:
        got = ent.predict_rows(rows)
    finally:
        batcher.shutdown_all()
    want = tm.predict(fr)
    np.testing.assert_allclose(got["probabilities"][:, 1],
                               want.vec("YES").to_numpy()[:n], rtol=1e-5)
    dom = np.asarray(["NO", "YES"], dtype=object)
    np.testing.assert_array_equal(
        got["predict"], dom[want.vec("predict").to_numpy()[:n]])


def test_check_modes_run(port_trained):
    """hist_mode="check" and split_mode="check" run their crosschecks on
    the first tree and then train the default path."""
    *_, fr, tm = port_trained
    m = XGBoost(device="cpu", hist_mode="check", split_mode="check",
                **_CFG).train(fr)
    for a, b in zip(m.output["trees"], tm.output["trees"]):
        for d in range(len(a.feat)):
            np.testing.assert_array_equal(a.feat[d].numpy(),
                                          b.feat[d].numpy())


def test_varbin_layout_trains_the_same_trees(port_trained, monkeypatch):
    """H2O3_TPU_HIST_IMPL=varbin forces the packed histogram layout on the
    CPU (on a card it engages by itself where packing saves work, as at
    nbins=128 here): the same trees as the uniform layout, since both
    give the same sums up to f32 rounding."""
    from h2o3_tpu_torch.runtime import config
    *_, fr, _ = port_trained
    cfg = {**_CFG, "nbins": 128, "ntrees": 2}
    plain = XGBoost(device="cpu", **cfg).train(fr)
    monkeypatch.setenv("H2O3_TPU_HIST_IMPL", "varbin")
    config.reload()
    try:
        m = XGBoost(device="cpu", **cfg).train(fr)
    finally:
        monkeypatch.delenv("H2O3_TPU_HIST_IMPL")
        config.reload()
    assert m.output["hist_kernel"] == "varbin"
    assert plain.output["hist_kernel"] == "uniform"
    for a, b in zip(m.output["trees"], plain.output["trees"]):
        for d in range(len(a.feat)):
            for name in ("feat", "thr", "na_left", "valid"):
                np.testing.assert_array_equal(getattr(a, name)[d].numpy(),
                                              getattr(b, name)[d].numpy())
        np.testing.assert_allclose(a.values.numpy(), b.values.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_gaussian_gbm_matches_jax():
    """The gaussian distribution and the regression metrics: a GBM on a
    numeric response, with a validation frame, against the JAX package."""
    from h2o3_tpu.models import GBM as JGBM
    from h2o3_tpu_torch.models.tree.gbm import GBM
    rng = np.random.default_rng(8)
    n = 2048
    x0 = rng.normal(size=n).astype(np.float32)
    x1 = rng.integers(0, 9, n).astype(np.float32)
    y = (2.0 * x0 + np.where(x1 > 4, 1.5, -0.5)
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    cols = {"x0": x0, "x1": x1, "y": y}
    cfg = dict(response_column="y", distribution="gaussian", max_depth=3,
               nbins=16, ntrees=3, seed=1, learn_rate=0.3,
               score_tree_interval=10 ** 9)
    jfr = JFrame.from_numpy(cols)
    jm = JGBM(**cfg).train(jfr, valid=jfr)
    fr = Frame.from_numpy(cols, device="cpu")
    m = GBM(device="cpu", **cfg).train(fr, valid=fr)
    for a, b in zip(jm.output["trees"], m.output["trees"]):
        for d in range(3):
            np.testing.assert_array_equal(np.asarray(a.feat[d]),
                                          b.feat[d].numpy())
            np.testing.assert_array_equal(np.asarray(a.thr[d]),
                                          b.thr[d].numpy())
    np.testing.assert_allclose(m.predict(fr).vec("predict").to_numpy(),
                               np.asarray(jm.predict(jfr).vec("predict")
                                          .to_numpy()), rtol=1e-4,
                               atol=1e-5)
    for ma, mb in ((jm.training_metrics, m.training_metrics),
                   (jm.validation_metrics, m.validation_metrics)):
        assert abs(ma.rmse - mb.rmse) <= 1e-5 * ma.rmse
        assert abs(ma.r2 - mb.r2) <= 1e-5


def test_builders_default_to_the_card(monkeypatch):
    """``make_build_tree_fn`` and ``make_tree_scan_fn`` resolve an omitted
    device like the entry points: ``cuda``, where the packed histogram
    layout engages on the bench frame's bin counts; without CUDA they
    raise instead of taking the CPU's uniform layout."""
    from h2o3_tpu_torch.models.distributions import make_distribution
    from h2o3_tpu_torch.models.tree import shared
    bc = (21, 12, 7, 256, 256, 22, 256, 256)
    args = (6, 256, 8, 4096)
    dist = make_distribution("bernoulli")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        shared.make_build_tree_fn(*args, bin_counts=bc)
    with pytest.raises(RuntimeError, match="CUDA"):
        shared.make_tree_scan_fn(dist, *args, 1.0, 1.0, bin_counts=bc)
    assert not shared.make_build_tree_fn(*args, bin_counts=bc,
                                         device="cpu").use_varbin
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert shared.make_build_tree_fn(*args, bin_counts=bc).use_varbin
    assert shared.make_tree_scan_fn(dist, *args, 1.0, 1.0,
                                    bin_counts=bc).build.use_varbin
    assert not shared.make_tree_scan_fn(dist, *args, 1.0, 1.0,
                                        bin_counts=bc,
                                        device="cpu").build.use_varbin


def test_device_cluster_one_shard():
    """One row shard: columns pad to a multiple of 8, as the JAX package
    pads them on a one-device mesh."""
    from h2o3_tpu_torch.runtime import device
    cl = device.Cluster(device.resolve_device("cpu"))
    assert cl.device.type == "cpu" and cl.n_row_shards == 1
    assert [cl.pad_rows(n) for n in (0, 1, 8, 9)] == [8, 8, 8, 16]
    fr = Frame.from_numpy({"x": np.arange(9, dtype=np.float32)},
                          device="cpu")
    assert fr.nrows == 9
    assert fr.vec("x").data.shape[0] == cl.pad_rows(9)
