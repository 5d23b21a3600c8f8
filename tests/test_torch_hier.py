"""h2o3_tpu_torch's hierarchical split search held against the JAX package.

The same numpy inputs from one seed go through the JAX function and its
port: the fine histogram (against the einsum program and the Pallas
kernel in interpret mode), the |g| plane of the uniform histogram,
``select_superbins`` and ``best_splits_hier``, and whole trains with
``split_search="hier"`` (the XGBoost slice and a gaussian GBM).  All of it
runs on the CPU, where the port's kernel wrappers take their plain torch
versions.

Tolerances.  The JAX side runs on the suite's 8-device CPU mesh and sums
per shard before its psum, and its einsum contracts in another order, so
histogram sums agree bitwise only where the stats are integer-valued
(every partial sum is then exact) and to 1e-5 of each plane's total
otherwise; the search functions are bitwise on integer-valued
histograms.  The port's histograms are int64 fixed point (exact sums
of the stats rounded on a power-of-two scale), bitwise an independent
numpy implementation of that contract.  In a train, a structural tie
can be left to f32 noise in either package: two candidate bins of one
feature with no row of the node between them split the node's rows the
same way, so their gains are equal in exact arithmetic and each package
keeps the one its rounding puts first.  (The port scores a fine slot
from the coarse prefix before its super-bin, the value the boundary
before it is scored with, so a tie across that boundary is exact there
and the first candidate wins, as in exact arithmetic; the slice's
trees then match the JAX package's thresholds bitwise.)  The slice test
checks every threshold bitwise except at verified ties on valid nodes,
and there the two packages send every row the same way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu import Frame as JFrame
from h2o3_tpu.models import XGBoost as JXGBoost
from h2o3_tpu.models.tree import hist as jhist

from bench import make_airlines_like

from h2o3_tpu_torch.frame import Frame
from h2o3_tpu_torch.models.tree import binning, hist
from h2o3_tpu_torch.models.tree.xgboost import XGBoost

# the slice's frame and model, as tests/test_torch_training.py trains them
N_SLICE = 3904
_CFG = dict(response_column="dep_delayed_15min", max_depth=4, nbins=32,
            seed=1, ntrees=5, score_tree_interval=10 ** 9,
            split_search="hier")


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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------ (a) fine histogram

# (nbins, L, F, K): nbins = 61 gives S = 8, W = 8 and S*W = 64 > nbins,
# so the NA code 61 would alias into slot 5 of super-bin 7 unless masked
# (tests/test_hist_kernel.py's geometry); nbins = 256 is the bench's
# S = 16, W = 16
_FINE = [(61, 4, 5, 2), (256, 8, 5, 2), (61, 2, 3, 3)]


def _fine_case(seed, nbins, L, F, K, n, integer):
    rng = np.random.default_rng(seed)
    S, W = hist.superbin_geometry(nbins)
    codes = rng.integers(0, nbins + 1, (F, n)).astype(np.int32)
    codes[:, rng.random(n) < 0.1] = nbins                     # NA rows
    leaf = rng.integers(-1, L, n).astype(np.int32)            # -1 rows too
    sel = rng.integers(0, S, (L, F, K)).astype(np.int32)
    sel[0, 0, :] = S - 1            # the super-bin the NA code aliases into
    return W, codes, leaf, _stats(rng, n, integer), sel


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("nbins,L,F,K", _FINE)
def test_fine_hist_vs_einsum_and_pallas(nbins, L, F, K, integer):
    n = 2048
    W, codes, leaf, st, sel = _fine_case(nbins + L + integer, nbins, L, F,
                                         K, n, integer)
    got = hist.make_fine_hist_fn(L, F, W, K, nbins)(*_t(codes, leaf, st,
                                                        sel)).numpy()
    assert got.shape == (3, L, F, K, W)
    jargs = (jnp.asarray(codes), jnp.asarray(leaf), *map(jnp.asarray, st),
             jnp.asarray(sel))
    einsum = jhist.make_fine_hist_fn(L, F, W, K, nbins, n,
                                     force_impl="einsum")(*jargs)
    pallas = jhist.make_fine_hist_fn(L, F, W, K, nbins, n,
                                     force_impl="pallas_interpret",
                                     precision="f32")(*jargs)
    _close(got, einsum, integer)
    _close(got, pallas, integer)
    # the NA code never lands: at nbins = 61 slot 5 of super-bin 7 is
    # code 61, the NA code itself, so it stays empty though leaf 0 has NA
    # rows of feature 0 and sel[0, 0, 0] names super-bin 7
    if nbins == 61:
        assert ((leaf == 0) & (codes[0] == nbins)).any()
        assert (got[:, 0, 0, 0, 5] == 0).all()
        assert (got[:, 0, 0, 0, :5] != 0).any()


def _np_fixed_point(st):
    """An independent numpy reading of the fixed-point contract (as in
    tests/test_torch_training.py): the int64 stats rounded half to even
    on each plane's scale 2^s, sum|x| * 2^s < 2^62, and the inverse
    scales (NaN for a plane with a non-finite stat)."""
    m = np.abs(st.astype(np.float64)).sum(axis=1)
    finite = np.isfinite(m)
    e = np.frexp(np.where(finite, m, 0.0))[1]
    s = 62 - e
    q = np.rint(st.astype(np.float64) * np.ldexp(1.0, s)[:, None])
    q = np.where(finite[:, None], q, 0.0).astype(np.int64)
    return q, np.where(finite, np.ldexp(1.0, -s), np.nan)


@pytest.mark.parametrize("nbins,L,F,K", _FINE)
def test_fine_hist_plain_equals_numpy_fixed_point(nbins, L, F, K):
    """On real-valued stats the quantised ``fine_hist_torch`` is bitwise a
    numpy int64 loop over (row, feature, k) of the same contract."""
    n = 1999
    W, codes, leaf, st, sel = _fine_case(7 * nbins + L, nbins, L, F, K, n,
                                         False)
    st[0] *= 37.0
    q, inv = _np_fixed_point(st)
    H = np.zeros((3, L, F, K, W), np.int64)
    for r in range(n):
        if not 0 <= leaf[r] < L:
            continue
        for f in range(F):
            c = codes[f, r]
            for k in range(K):
                if c < nbins and sel[leaf[r], f, k] == c // W:
                    H[:, leaf[r], f, k, c % W] += q[:, r]
    want = (H.astype(np.float64) * inv[:, None, None, None, None]).astype(
        np.float32)
    got = hist.fine_hist(*_t(codes, leaf, st, sel), W, nbins).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_fine_hist_non_finite_stat_is_never_finite(bad):
    """As for the level histograms: a NaN or infinite stat makes its plane
    non-finite throughout in the JAX package's einsum program, and NaN
    throughout in the port, whose non-finite slots cover the Pallas
    kernel's; the other planes keep their sums."""
    nbins, L, F, K, n = 61, 4, 5, 2, 2048
    W, codes, leaf, st, sel = _fine_case(5, nbins, L, F, K, n, False)
    for row_leaf in (1, -1):
        s2, lf2 = st.copy(), leaf.copy()
        s2[0, 9], lf2[9] = bad, row_leaf
        got = hist.fine_hist(*_t(codes, lf2, s2, sel), W, nbins).numpy()
        jargs = (jnp.asarray(codes), jnp.asarray(lf2),
                 *map(jnp.asarray, s2), jnp.asarray(sel))
        einsum = np.asarray(jhist.make_fine_hist_fn(
            L, F, W, K, nbins, n, force_impl="einsum")(*jargs))
        pallas = np.asarray(jhist.make_fine_hist_fn(
            L, F, W, K, nbins, n, force_impl="pallas_interpret",
            precision="f32")(*jargs))
        assert not np.isfinite(einsum[0]).any()
        assert np.isnan(got[0]).all()
        assert np.isnan(got[0][~np.isfinite(pallas[0])]).all()
        _close(got[1:], einsum[1:], False)


def test_fine_hist_rejects_bad_operands():
    W, codes, leaf, st, sel = _fine_case(1, 61, 4, 5, 2, 64, True)
    c, lf, s, sl = _t(codes, leaf, st, sel)
    with pytest.raises(ValueError, match="sel must be"):
        hist.fine_hist(c, lf, s, sl.long(), W, 61)
    with pytest.raises(ValueError, match="built for sel"):
        hist.make_fine_hist_fn(4, 5, W, 3, 61)(c, lf, s, sl)
    with pytest.raises(ValueError, match="sel is on"):
        hist.fine_hist(c, lf, s, sl.to("meta"), W, 61)


def test_fine_tiles_fit_shared_memory():
    """The fine kernel's tiles cover the [F*K*W, L] output once and each
    block's sums (three 8-byte int64 fixed-point sums per slot) plus its
    slice of sel fit two blocks per SM; a small tile keeps as many
    lane-striped copies (a power of two, at most 32, each one slot longer)
    as fit a quarter of an SM."""
    for nbins in (32, 61, 256, 1024):
        S, W = hist.superbin_geometry(nbins)
        for F, K in ((8, 2), (3, 3), (40, 2)):
            for L in (1, 2, 8, 32, 64):
                tiles, n_tiles, smem = hist._fine_meta(L, F, K, W, "cpu")
                tiles = tiles.numpy()
                seen = np.zeros((F * K * W, L), np.int32)
                for fa, fb, qa, qn, l0, ln, use_smem, copies in tiles:
                    assert (qa, qn) == (fa * K * W, (fb - fa) * K * W)
                    seen[qa:qa + qn, l0:l0 + ln] += 1
                    assert use_smem == 1 and 1 <= copies <= 32
                    assert copies & (copies - 1) == 0
                    per = qn * ln * 24
                    assert per <= hist.HIST_SMEM_BUDGET
                    if copies > 1:
                        assert copies * (per + 8) <= hist._COPIES_SMEM
                    # one copy per lane, or as many as fit: twice as many
                    # would not
                    assert copies == 32 or \
                        2 * copies * (per + 8) > hist._COPIES_SMEM
                assert (seen == 1).all() and n_tiles == len(tiles)
                assert smem <= 227 * 1024 // 2


# --------------------------------------------------- (b) the |g| plane

@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("L", [1, 4])
def test_hist_uniform_planes4_vs_einsum_and_pallas(L, integer):
    n, F, B = 2048, 5, 17
    rng = np.random.default_rng(30 + L + integer)
    codes = rng.integers(0, B, (F, n)).astype(np.int32)
    leaf = rng.integers(-1, L, n).astype(np.int32)
    st = _stats(rng, n, integer)
    got = hist.hist_uniform(*_t(codes, leaf, st), L, B, planes=4).numpy()
    assert got.shape == (4, L, F, B)
    three = hist.hist_uniform(*_t(codes, leaf, st), L, B).numpy()
    np.testing.assert_array_equal(got[:3], three)
    jargs = (jnp.asarray(codes), jnp.asarray(leaf), *map(jnp.asarray, st))
    einsum = jhist.make_hist_fn(L, F, B, n, force_impl="einsum",
                                planes=4)(*jargs)
    pallas = jhist.make_hist_fn(L, F, B, n, force_impl="pallas_interpret",
                                precision="f32", planes=4)(*jargs)
    _close(got, einsum, integer)
    _close(got, pallas, integer)
    with pytest.raises(ValueError, match="planes"):
        hist.hist_uniform(*_t(codes, leaf, st), L, B, planes=5)


@pytest.mark.parametrize("L", [1, 4])
def test_hist_uniform_planes4_plain_equals_numpy_fixed_point(L):
    """The |g| plane sums |round(g * 2^s_g)| on g's scale: bitwise an
    independent numpy int64 sum on real-valued stats."""
    n, F, B = 3001, 5, 17
    rng = np.random.default_rng(60 + L)
    codes = rng.integers(0, B, (F, n)).astype(np.int32)
    leaf = rng.integers(-1, L, n).astype(np.int32)
    st = _stats(rng, n, False)
    q, inv = _np_fixed_point(st)
    q = np.concatenate([q, np.abs(q[:1])])
    H = np.zeros((4, L, F, B), np.int64)
    for f in range(F):
        ok = leaf >= 0
        for p in range(4):
            np.add.at(H[p], (leaf[ok], f, codes[f][ok]), q[p][ok])
    want = (H.astype(np.float64)
            * inv[[0, 1, 2, 0]][:, None, None, None]).astype(np.float32)
    got = hist.hist_uniform(*_t(codes, leaf, st), L, B, planes=4).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --------------------------------------------------- (c) the search

def test_top_k_order_is_jax_top_k():
    """Ties go to the lower index, +0 ranks above -0 and a NaN by its
    sign, as in ``jax.lax.top_k`` (``torch.topk`` promises no order for
    ties)."""
    x = np.array([[1.0, -np.inf, 3.0, 3.0, -np.inf, 1.0],
                  [-0.0, 0.0, -np.inf, -np.inf, -np.inf, -np.inf],
                  [np.nan, 2.0, -np.nan, 2.0, 0.0, -1.0],
                  [-np.inf] * 6], np.float32)
    x[2, 2] = -np.abs(x[2, 2])             # a NaN with its sign bit set
    for k in (1, 2, 6):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = hist._top_k_indices(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)


def _search_case(seed, nbins, L, F, n, signal):
    """Coarse and fine histograms built from rows with integer-valued
    stats, with: feature 0 carrying a step at the super-bin edge
    (2W - 1, when ``signal``), leaf L-1 too small for min_rows = 10 so
    every boundary there is ruled out, and a mask that drops feature 1
    for every leaf and a random third of the rest."""
    rng = np.random.default_rng(seed)
    S, W = hist.superbin_geometry(nbins)
    codes = rng.integers(0, nbins + 1, (F, n)).astype(np.int32)
    leaf = rng.integers(0, L - 1, n).astype(np.int32)
    leaf[rng.choice(n, 12, replace=False)] = L - 1
    st = _stats(rng, n, True)
    if signal:
        st[0] = np.where(codes[0] <= 2 * W - 1, -2.0, 2.0) + st[0] % 2
    mask = rng.random((L, F)) < 0.7
    mask[:, 1] = False
    mask[:, 0] = True
    c, lf, s = _t(codes, leaf, st)
    Hc = hist.hist_uniform(hist.coarse_codes(c, nbins), lf, s, L, S + 1)
    return S, W, c, lf, s, Hc, mask


_PRM = [(1.0, 1.0, 0.0, 0.0, 1.0), (0.0, 10.0, 0.5, 0.1, 0.0)]


@pytest.mark.parametrize("prm", _PRM)
@pytest.mark.parametrize("nbins,K", [(61, 2), (256, 2), (32, 3)])
def test_select_superbins_and_best_splits_hier_bitwise(nbins, K, prm):
    lam, mr, alpha, gamma, mcw = prm
    L, F, n = 4, 5, 2048
    S, W, c, lf, s, Hc, mask = _search_case(nbins + K, nbins, L, F, n,
                                            signal=True)
    jHc = jnp.asarray(Hc.numpy())
    for fm in (None, mask):
        tm = None if fm is None else torch.from_numpy(fm)
        jm = None if fm is None else jnp.asarray(fm)
        sel, ub = hist.select_superbins(Hc, nbins, W, K, lam, alpha, gamma,
                                        mr, mcw, tm)
        jsel, jub = jhist.select_superbins(jHc, nbins, W, K, lam, alpha,
                                           gamma, mr, mcw, jm)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))
        if fm is not None:
            # the masked feature's boundaries all tie at -inf: top_k's
            # lower-index rule picks boundary 0, super-bins 0 and 1
            assert (sel[:, 1, :2].numpy() == [0, 1]).all()
        Hf = hist.fine_hist(c, lf, s, sel, W, nbins)
        got = hist.best_splits_hier(Hc, Hf, sel, ub, nbins, W, lam, mr,
                                    1e-5, tm, alpha, gamma, mcw)
        want = jhist.best_splits_hier(jHc, jnp.asarray(Hf.numpy()), jsel,
                                      jub, nbins, W, lam, mr, 1e-5, jm,
                                      alpha, gamma, mcw)
        for name, x, y in zip(("feat", "bin", "na_left", "gain", "valid",
                               "children"), want[:6], got[:6]):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                          err_msg=name)
        # the level path computes the coarse totals once for both calls
        coarse = hist.coarse_totals(Hc, lam, alpha)
        shared = hist.best_splits_hier(
            Hc, Hf, hist.select_superbins(Hc, nbins, W, K, lam, alpha, gamma,
                                          mr, mcw, tm, coarse=coarse)[0],
            ub, nbins, W, lam, mr, 1e-5, tm, alpha, gamma, mcw,
            coarse=coarse)
        for x, y in zip(got[:6], shared[:6]):
            assert torch.equal(x, y)
        if mr == 10.0:
            # leaf L-1's 12 rows: min_rows rules out every boundary, all
            # gains tie at -inf and the leaf does not split
            assert np.isneginf(got[3].numpy()[L - 1])
            assert not got[4].numpy()[L - 1]
        else:
            # the step at the super-bin edge: the coarse boundary 2W - 1
            # (also fine slot W - 1 of super-bin 1) of feature 0 wins
            assert (got[0].numpy()[:L - 1] == 0).all()
            assert (got[1].numpy()[:L - 1] == 2 * W - 1).all()


# ------------------------------------------------------------ (d) trains

@pytest.fixture(scope="module")
def trained():
    cols, types, domains = make_airlines_like(N_SLICE)
    jfr = JFrame.from_numpy(cols, types=types, domains=domains)
    jm = JXGBoost(**_CFG).train(jfr)
    fr = Frame.from_numpy(cols, types=types, domains=domains, device="cpu")
    # the port's train, watched: each level's rows (the leaf ids that
    # partition routes) and the inputs of best_splits_hier
    parts, searches = [], []
    real_part, real_best = hist.partition, hist.best_splits_hier

    def spy_part(codes, leaf, feat, bin_, na_left, valid, na_bin):
        parts.append((leaf.clone(), bin_.clone()))
        return real_part(codes, leaf, feat, bin_, na_left, valid, na_bin)

    def spy_best(Hc, Hf, sel, ub, nbins, W, *args, **kw):
        searches.append((Hc, Hf, sel, nbins, W, args))
        return real_best(Hc, Hf, sel, ub, nbins, W, *args, **kw)

    hist.partition, hist.best_splits_hier = spy_part, spy_best
    try:
        tm = XGBoost(device="cpu", **_CFG).train(fr)
    finally:
        hist.partition, hist.best_splits_hier = real_part, real_best
    return cols, types, domains, jfr, jm, fr, tm, parts, searches


def test_hier_slice_trees_match_jax(trained):
    """Every level of every tree: the same (feat, na_left, valid); the
    thresholds bitwise, except where the two packages' bins are a verified
    structural tie (no row of the node has a code between them, so both
    send every row the same way); leaf values to rtol 1e-4.

    The frame's signal leaves no near-tied features: every valid node's
    winning feature leads the best candidate of any other feature by more
    than 1e-3 of the gain."""
    cols, types, domains, _, jm, fr, tm, parts, searches = trained
    assert tm.output["split_search"] == "hier"
    feats = [c for c in cols if c != "dep_delayed_15min"]
    binned = binning.fit_bins(fr, feats, nbins=32, seed=1)
    codes = binned.codes.numpy()
    edges = binning.edges_matrix(binned.edges, 32)
    jt, tt = list(jm.output["trees"]), list(tm.output["trees"])
    assert len(jt) == len(tt) == 5 and len(parts) == 20
    ties = 0
    for t, (a, b) in enumerate(zip(jt, tt)):
        assert len(a.feat) == len(b.feat) == 4
        for d in range(4):
            for name in ("feat", "na_left", "valid"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)[d]),
                    getattr(b, name)[d].numpy(), err_msg=f"{name} {t} {d}")
            ja, tb = np.asarray(a.thr[d]), b.thr[d].numpy()
            leaf, bins = (x.numpy() for x in parts[4 * t + d])
            for l in np.flatnonzero(ja.view(np.int32) != tb.view(np.int32)):
                assert b.valid[d][l], (t, d, l)
                f = int(b.feat[d][l])
                jb = int(np.flatnonzero(edges[f] == ja[l])[0])
                lo, hi = sorted((jb, int(bins[l])))
                node = codes[f][:leaf.shape[0]][leaf == l]
                assert not ((node > lo) & (node <= hi) & (node < 32)).any(), \
                    f"tree {t} level {d} leaf {l}: bins {lo}, {hi} differ"
                ties += 1
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=1e-4, atol=1e-7)
    assert ties <= 2, ties

    margins = []
    for t, tree in enumerate(tt):
        for d in range(4):
            Hc, Hf, sel, nbins, W, args = searches[4 * t + d]
            lam, mr, _, fm, alpha, gamma, mcw = args
            cols_, _ = hist.hier_candidates(Hc, Hf, sel, nbins, W, lam, mr,
                                            fm, alpha, gamma, mcw)
            gain, feat = cols_[0].numpy(), cols_[5].numpy()
            for l in np.flatnonzero(tree.valid[d].numpy()):
                f = int(tree.feat[d][l])
                top = gain[l][feat[l] == f].max()
                second = gain[l][feat[l] != f].max()
                margins.append((top - second) / abs(top))
    assert len(margins) > 20
    assert min(margins) > 1e-3, min(margins)


def test_hier_slice_predictions_and_metrics_match_jax(trained):
    *_, jfr, jm, fr, tm, _, _ = trained
    pj = np.asarray(jm.predict(jfr).vec("YES").to_numpy())
    pt = tm.predict(fr).vec("YES").to_numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    a, b = jm.training_metrics, tm.training_metrics
    assert abs(a.auc - b.auc) <= 1e-5
    assert abs(a.logloss - b.logloss) <= 1e-5


def test_hier_check_modes_and_exact_search(trained):
    """hist_mode="check" crosschecks the exact search on the first tree,
    split_mode="check" resolves to "separate" under hier (the JAX
    package's resolver), and training then grows the same hier trees;
    split_search="auto" is the exact search."""
    cols, types, domains, _, _, fr, tm, _, _ = trained
    m = XGBoost(device="cpu", hist_mode="check", split_mode="check",
                **_CFG).train(fr)
    for a, b in zip(m.output["trees"], tm.output["trees"]):
        for d in range(len(a.feat)):
            for name in ("feat", "thr", "na_left", "valid"):
                np.testing.assert_array_equal(getattr(a, name)[d].numpy(),
                                              getattr(b, name)[d].numpy())
    exact = XGBoost(device="cpu", **{**_CFG, "split_search": "auto",
                                     "ntrees": 1}).train(fr)
    assert exact.output["split_search"] == "exact"


def test_hier_gaussian_gbm_matches_jax():
    """A gaussian GBM with split_search="hier" on a numeric response,
    with a validation frame, against the JAX package's."""
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
               score_tree_interval=10 ** 9, split_search="hier")
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


def test_hier_with_monotone_constraints_raises():
    cols = {"x": np.arange(64, dtype=np.float32),
            "y": np.where(np.arange(64) % 3 == 0, "a", "b").astype(object)}
    fr = Frame.from_numpy(cols, device="cpu")
    with pytest.raises(NotImplementedError, match="monotone"):
        XGBoost(response_column="y", ntrees=1, split_search="hier",
                monotone_constraints={"x": 1}, device="cpu").train(fr)
