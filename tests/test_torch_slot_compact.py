"""The node-sparse level's slot-ordered compaction and per-tile row windows
(``hist.slot_compact``, ``hist.slot_tiles``, ``hist.window_grid``) on the
CPU.  ``csrc/slot_compact.cu`` and the windowed launch of ``csrc/hist.cu``
run only on the card (``tests/test_torch_cuda.py``); here their plain
version is held to the compaction's contract, the level built through it
is held to the JAX package's level (a compaction in row order) and
bitwise to itself over a prefix in row order, and a simulation of the
windowed kernel's block mapping (the plan's scan, its binary search, the
chunks) over the host's tiles and grid bound is held to cover every
(tree, feature, chosen row) once.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models.tree import hist
from h2o3_tpu_torch.testing import same_bits

# the suite's xdist workers share the host's cores: one torch thread
# each (by default every worker would start one per core)
torch.set_num_threads(1)


def _level_case(rng, K, A_prev, A, n, case, p_valid=0.75):
    """Slot maps and each row's slot for one level of K trees.  ``case``:
    "uniform" (rows spread over the live slots, some on the sentinel A),
    "skewed" (80% of a tree's rows on one slot), "empty" (only a third
    of the live slots hold rows), "dropped" (more alive children than A
    slots: later pairs dropped, their rows on A)."""
    valid = torch.from_numpy(rng.random((K, A_prev)) < p_valid)
    _, ps, real = hist.sparse_slot_maps(valid, A)
    live = real.sum(1).numpy()
    sleaf = np.empty((K, n), np.int64)
    for k in range(K):
        slots = np.arange(live[k])
        if case == "empty":
            slots = rng.choice(slots, max(1, live[k] // 3), replace=False)
        s = rng.choice(np.append(slots, A), n)
        if case == "skewed":
            s = np.where(rng.random(n) < 0.8, rng.choice(slots), s)
        sleaf[k] = s
    return torch.from_numpy(sleaf), ps, real, valid


def _chosen_reference(sleaf, ps, A_prev):
    """Per tree: each slot's smaller-child flag by counting in numpy (the
    left child where its rows are at most the right one's)."""
    K, A = ps.shape
    out = np.zeros((K, A), bool)
    for k in range(K):
        cnt = np.bincount(sleaf[k].numpy(), minlength=A + 1)[:A]
        cl = np.zeros(A_prev, np.int64)
        cr = np.zeros(A_prev, np.int64)
        np.add.at(cl, ps[k, 0::2].numpy(), cnt[0::2])
        np.add.at(cr, ps[k, 1::2].numpy(), cnt[1::2])
        left = (cl <= cr)[ps[k].numpy()]
        out[k] = np.where(np.arange(A) & 1, ~left, left)
    return out


@pytest.mark.parametrize("case", ["uniform", "skewed", "empty", "dropped"])
@pytest.mark.parametrize("K", [1, 3])
def test_slot_compact_windows_hold_the_chosen_rows(K, case):
    """Each parent slot's window holds exactly the rows of its chosen
    child, in row order, with their codes, stats and parent slot; no row
    of the sentinel slot or of an unchosen child appears; the tail past
    the count carries leaf -1."""
    rng = np.random.default_rng(K * 10 + len(case))
    n = 4001
    A_prev, A = (40, 48) if case == "dropped" else (32, 64)
    p_valid = 0.95 if case == "dropped" else 0.75
    sleaf, ps, real, valid = _level_case(rng, K, A_prev, A, n, case,
                                         p_valid)
    if case == "dropped":                    # pairs past the A slots
        assert bool((2 * valid.sum(1) > A).all())
        assert bool((real.sum(1) == A).all())
    rowid = torch.arange(n, dtype=torch.int32)
    codes = torch.stack([rowid, rowid * 7 % 65]).to(torch.int32)
    stats = torch.from_numpy(rng.normal(size=(K, 3, n)).astype(np.float32))
    cc, pleaf, st, rs, chosen_slot = hist.slot_compact(codes, sleaf, stats,
                                                       ps, A_prev)
    cap1 = n // 2 + 1
    assert cc.shape == (K, 2, cap1) and pleaf.shape == (K, cap1)
    assert st.shape == (K, 3, cap1) and rs.shape == (K, A_prev + 1)
    assert rs.dtype == pleaf.dtype == torch.int32
    want_chosen = _chosen_reference(sleaf, ps, A_prev)
    np.testing.assert_array_equal(chosen_slot.numpy(), want_chosen)
    for k in range(K):
        s = sleaf[k].numpy()
        on_slot = s < A
        par = np.where(on_slot, ps[k].numpy()[np.minimum(s, A - 1)], -1)
        take = on_slot & want_chosen[k][np.minimum(s, A - 1)]
        total = int(take.sum())
        assert int(rs[k, 0]) == 0 and int(rs[k, -1]) == total <= n // 2
        assert bool((rs[k, 1:] >= rs[k, :-1]).all())
        for p in range(A_prev):
            a, b = int(rs[k, p]), int(rs[k, p + 1])
            want = np.flatnonzero(take & (par == p))
            got = cc[k, 0, a:b].numpy()
            np.testing.assert_array_equal(got, want)   # row order
            assert bool((pleaf[k, a:b] == p).all())
            np.testing.assert_array_equal(cc[k, 1, a:b].numpy(),
                                          codes[1, want].numpy())
            assert same_bits(st[k, :, a:b], stats[k][:, want])
        assert not np.isin(np.flatnonzero(~take), cc[k, 0, :total]).any()
        assert bool((pleaf[k, total:] == -1).all())


def test_slot_counts_count_the_sentinel_and_out_of_range_slots():
    """The count pass's plain version: rows per (tree, slot), the
    sentinel A included; a slot outside [0, A] counts as A (as in the
    kernel)."""
    sleaf = torch.tensor([[0, 1, 1, 4, 4, 4, 7, -2], [3, 3, 3, 3, 0, 2, 4,
                                                      4]])
    got = hist.slot_counts_torch(sleaf, 4)
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 2, 0, 0, 5], [1, 0, 1, 4, 2]]


def _level_inputs(rng, K, case, integer):
    """A sparse level of K trees at a small size: codes [F, n] of mixed
    bin counts (some NA), each row's slot (``_level_case``), stats [K, 3,
    n] integer-valued or float."""
    n, nbins = 3000, 30
    bc = (nbins, 9, nbins, 4, 17)
    A_prev, A = (40, 48) if case == "dropped" else (32, 64)
    sleaf, ps, _, _ = _level_case(rng, K, A_prev, A, n, case,
                                  0.95 if case == "dropped" else 0.75)
    codes = np.stack([np.where(rng.random(n) < 0.1, nbins,
                               rng.integers(0, b, n))
                      for b in bc]).astype(np.int32)
    if integer:
        st = np.stack([rng.integers(-3, 4, (K, n)), rng.integers(0, 3, (K, n)),
                       rng.integers(0, 2, (K, n))], axis=1)
    else:
        p = rng.random((K, n))
        st = np.stack([p - (rng.random((K, n)) < 0.4), p * (1 - p),
                       rng.random((K, n)) < 0.632], axis=1)
    return (n, nbins, bc, A_prev, A, torch.from_numpy(codes), sleaf, ps,
            torch.from_numpy(st.astype(np.float32)))


def _parent_hists(lcodes, sleaf, ps, stats, A_prev, A, F, B, bc, parts):
    """The carry a real build hands the level: each parent slot's
    histogram over the rows of its two child slots (sentinel rows in
    none), for each of ``parts`` equal row blocks -> [parts, K, 3,
    A_prev, F, B]."""
    K, n = sleaf.shape
    on = sleaf < A
    par = torch.where(on, ps.long().gather(1, sleaf.clamp(max=A - 1)), -1)
    m = n // parts
    return torch.stack([hist.local_hist(
        lcodes[:, i * m:(i + 1) * m].contiguous(),
        par[:, i * m:(i + 1) * m].to(torch.int32).contiguous(),
        stats[..., i * m:(i + 1) * m].contiguous(), A_prev, F, B, bc)
        for i in range(parts)])


@pytest.mark.parametrize("case", ["skewed", "dropped"])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_sparse_level_vs_jax_row_order_compaction(K, varbin, integer, case):
    """The sparse level's H through the slot-ordered compaction matches
    the JAX package's ``make_batched_sparse_level_fn`` (its compaction in
    ROW order, per row shard of its CPU mesh), both on the carry of the
    parent slots' own histograms: bitwise on integer-valued stats, else to
    1e-5 of each plane's L1 norm (it sums in f32)."""
    import jax.numpy as jnp
    from h2o3_tpu.models.tree import hist as jhist
    from h2o3_tpu.runtime.cluster import cluster

    rng = np.random.default_rng(100 + 8 * K + 4 * varbin + 2 * integer
                                + (case == "dropped"))
    n, nbins, bc, A_prev, A, codes, sleaf, ps, stats = _level_inputs(
        rng, K, case, integer)
    F, B = len(bc), nbins + 1
    lbc = bc if varbin else None
    lcodes = hist.offset_codes(codes, bc, nbins) if varbin else codes
    shards = cluster().n_row_shards
    assert n % shards == 0
    jcarry = _parent_hists(lcodes, sleaf, ps, stats, A_prev, A, F, B, lbc,
                           shards)
    carry = _parent_hists(lcodes, sleaf, ps, stats, A_prev, A, F, B, lbc,
                          1)[0]
    H, nxt = hist.make_batched_sparse_level_fn(A_prev, A, K, F, B, lbc)(
        lcodes, sleaf, stats, carry, ps)
    assert H.shape == (K, 3, A, F, B) and nxt is H
    jcodes = jhist.offset_codes(jnp.asarray(codes.numpy()), bc, nbins) \
        if varbin else jnp.asarray(codes.numpy())
    jfn = jhist.make_batched_sparse_level_fn(A_prev, A, K, F, B, n,
                                             bin_counts=lbc,
                                             precision="f32")
    st = stats.numpy()
    want, _ = jfn(jcodes, jnp.asarray(sleaf.numpy().astype(np.int32)),
                  *(jnp.asarray(st[:, s]) for s in range(3)),
                  jnp.asarray(jcarry.numpy()), jnp.asarray(ps.numpy()))
    got, want = H.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        for k in range(K):
            for s in range(3):
                tol = 1e-5 * max(float(np.abs(want[k, s]).sum()), 1.0)
                assert float(np.abs(got[k, s] - want[k, s]).max()) <= tol


def _in_row_order(codes, sleaf, stats, ps_of_slot, A_prev):
    """``slot_compact_torch`` with each tree's prefix rebuilt in ROW
    order: the rows whose slot is a chosen child, by increasing row
    number, with their codes, parent slot and stats (the windows of its
    ``row_start`` no longer hold them: only the CPU path, which sums by
    leaf id, may take this)."""
    ccodes, pleaf, st, rs, chosen_slot = hist.slot_compact_torch(
        codes, sleaf, stats, ps_of_slot, A_prev)
    A = ps_of_slot.shape[1]
    for k in range(sleaf.shape[0]):
        s = sleaf[k].numpy()
        on = s < A
        rows = np.flatnonzero(on & chosen_slot[k].numpy()[np.minimum(
            s, A - 1)])
        m = len(rows)
        assert m == int(rs[k, -1])
        ccodes[k, :, :m] = codes[:, rows]
        pleaf[k, :m] = ps_of_slot[k][s[rows]].to(torch.int32)
        st[k, :, :m] = stats[k][:, rows]
    return ccodes, pleaf, st, rs, chosen_slot


@pytest.mark.parametrize("case", ["skewed", "dropped"])
@pytest.mark.parametrize("varbin", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_sparse_level_bitwise_row_order_compaction(monkeypatch, K, varbin,
                                                   case):
    """The sparse level's H through the slot-ordered compaction is
    bitwise the one through a compaction of the same rows in row order
    (the order the level used before), on float stats: the histograms
    are exact integer sums, so the order of rows cannot show."""
    rng = np.random.default_rng(200 + 8 * K + 4 * varbin
                                + (case == "dropped"))
    n, nbins, bc, A_prev, A, codes, sleaf, ps, stats = _level_inputs(
        rng, K, case, False)
    F, B = len(bc), nbins + 1
    lbc = bc if varbin else None
    lcodes = hist.offset_codes(codes, bc, nbins) if varbin else codes
    carry = torch.from_numpy((rng.random((K, 3, A_prev, F, B)) * n / A_prev)
                             .astype(np.float32))
    fn = hist.make_batched_sparse_level_fn(A_prev, A, K, F, B, lbc)
    H, _ = fn(lcodes, sleaf, stats, carry, ps)
    monkeypatch.setattr(hist, "slot_compact", _in_row_order)
    want, _ = fn(lcodes, sleaf, stats, carry, ps)
    assert same_bits(H, want)


def test_row_start_is_checked_and_ignored_by_the_plain_histograms():
    """On the CPU the histograms sum by leaf id: ``row_start`` changes
    nothing there, but a malformed one raises on every path."""
    rng = np.random.default_rng(3)
    n, F, nbins, L = 500, 3, 8, 6
    codes = torch.from_numpy(rng.integers(0, nbins + 1, (F, n))
                             .astype(np.int16))
    leaf = torch.from_numpy(np.sort(rng.integers(-1, L, n)).astype(np.int32))
    leaf = torch.cat([leaf[leaf >= 0], leaf[leaf < 0]])
    stats = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    rs = torch.from_numpy(np.searchsorted(
        leaf[leaf >= 0].numpy(), np.arange(L + 1)).astype(np.int32))
    bc = (nbins,) * F
    for fn, c, args in ((hist.hist_uniform, codes, (nbins + 1,)),
                        (hist.hist_varbin, hist.offset_codes(codes, bc, nbins),
                         (bc, nbins + 1))):
        assert same_bits(fn(c, leaf, stats, L, *args, row_start=rs),
                         fn(c, leaf, stats, L, *args))
        with pytest.raises(ValueError, match="row_start"):
            fn(c, leaf, stats, L, *args, row_start=rs.long())
        with pytest.raises(ValueError, match="row_start"):
            fn(c, leaf, stats, L, *args, row_start=rs[:-1])


# ------------------------------------------- the windowed kernel's blocks

def _simulate_blocks(tiles, row_start, R, blocks, n):
    """The windowed ``hist_kernel``'s work, block by block, as hist.cu
    computes it: ``plan_kernel``'s exclusive scan of ceil(window rows / R)
    per (tree, tile) item, then per block b < the plan's total (which must
    not pass the grid's ``blocks``) its item by binary search and rows
    [lo + c R, min(hi, lo + (c + 1) R)).  Returns the (tree, tile, first
    row, end row) of every block that works."""
    T = tiles.shape[0]
    lo = np.clip(row_start[:, tiles[:, 4]], 0, n)                # [K, T]
    hi = np.clip(row_start[:, tiles[:, 4] + tiles[:, 5]], lo, n)
    chunks = ((hi - lo + R - 1) // R).reshape(-1)
    plan = np.concatenate([[0], np.cumsum(chunks)])
    total = int(plan[-1])
    assert total <= blocks
    spans = []
    for b in range(blocks):
        if b >= total:
            continue
        i = int(np.searchsorted(plan, b, side="right")) - 1  # plan[i] <= b
        k, t = divmod(i, T)
        r0 = lo[k, t] + (b - plan[i]) * R
        spans.append((k, t, r0, min(hi[k, t], r0 + R)))
    return spans


@pytest.mark.parametrize("layout_kind", ["slot", "wide"])
@pytest.mark.parametrize("K", [1, 3])
def test_window_blocks_cover_every_feature_and_chosen_row_once(K,
                                                               layout_kind):
    """Over ``slot_tiles``'s tiles and ``window_grid``'s bound, the
    simulated blocks of a windowed launch read every (tree, feature,
    chosen row) exactly once, on skewed windows (one parent slot holding
    most rows, several chunks) with empty ones, and never a tail row; the
    tiles cover every (feature, leaf) once and fit the budget."""
    rng = np.random.default_rng(40 + K + len(layout_kind))
    if layout_kind == "slot":        # 8 features of mixed bins, nbins 64
        layout = hist.packed_layout((64, 12, 64, 7, 64, 40, 3, 64), 65)
        L = 512
    else:                            # feature ranges, one too wide for smem
        qlen = (2000, 1500, 4100, 800, 300, 3000)
        qstart = tuple(int(x) for x in np.cumsum((0,) + qlen[:-1]))
        layout = hist.HistLayout((0,) * 6, qstart, qlen, sum(qlen))
        L = 40
    tiles, smem = hist.slot_tiles(layout, L)
    per_q = 3 * 8
    cover = np.zeros((layout.F, L), np.int64)
    for fa, fb, qa, qn, l0, ln, use, cp in tiles:
        cover[fa:fb, l0:l0 + ln] += 1
        assert qa == layout.qstart[fa]
        assert qn == layout.qstart[fb - 1] + layout.qlen[fb - 1] - qa
        if use:
            assert cp * (qn * ln * per_q + 8 * (cp > 1)) <= smem
            assert qn * ln * per_q <= hist.HIST_SMEM_BUDGET
        else:
            assert (l0, ln) == (0, L)
    assert bool((cover == 1).all())
    n_ranges = len(set(tiles[:, 0].tolist()))
    if layout_kind == "slot":
        # all 8 features a tile: 376 packed bins x 24 B, 10 slots a tile
        assert n_ranges == 1 and layout.Q == 376 and tiles[0, 5] == 10
    else:
        assert n_ranges > 1 and (tiles[:, 6] == 0).any()
    n = 30_001
    cap1 = n // 2 + 1
    rs = np.zeros((K, L + 1), np.int64)
    for k in range(K):
        w = rng.integers(0, 40, L) * (rng.random(L) < 0.6)   # empty slots
        w[rng.integers(L)] = 9_000                          # one heavy slot
        w = np.minimum(np.cumsum(w), n // 2)
        rs[k, 1:] = w
    R, blocks = hist.window_grid(cap1, tiles.shape[0], n_ranges, smem, 132,
                                 K)
    spans = _simulate_blocks(tiles, rs, R, blocks, cap1)
    assert max(hi - lo for _, _, lo, hi in spans) <= R
    assert max(rs[:, -1]) > 2 * R          # the heavy window takes chunks
    reads = np.zeros((K, layout.F, cap1), np.int64)
    for k, t, r0, r1 in spans:
        fa, fb, l0, ln = tiles[t, 0], tiles[t, 1], tiles[t, 4], tiles[t, 5]
        assert rs[k, l0] <= r0 and r1 <= rs[k, l0 + ln]   # its own rows
        reads[k, fa:fb, r0:r1] += 1
    for k in range(K):
        assert bool((reads[k, :, :rs[k, -1]] == 1).all())
        assert bool((reads[k, :, rs[k, -1]:] == 0).all())
