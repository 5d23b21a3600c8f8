// Level histograms of tree training for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of h2o3_tpu/models/tree/hist.py:
//   _make_pallas_hist        (:80)  the uniform bin axis, B bins per feature;
//   _make_pallas_varbin_hist (:256) the packed ragged bin axis, one
//                                   pad8(B_f + 2)-row segment per feature.
// Both compute, for every row r with 0 <= leaf[r] < L and every feature f,
//   H[s][leaf[r]][q(f, r)] += stats[s][r]      s = 0 (g), 1 (h), 2 (w)
// and, with planes = 4 (the uniform axis only, as make_hist_fn's
// planes=4), H[3][leaf[r]][q(f, r)] += |stats[0][r]|, the |g| plane,
// where q is the row's packed bin: q = code_off[f] + codes[f][r].  The
// uniform layout is code_off[f] = f * B (raw codes); the varbin layout
// takes codes already offset (offset_codes) with code_off[f] = 0.  A bin
// outside its feature's segment [qstart[f], qstart[f] + qlen[f]) and a
// row whose leaf is outside [0, L) add nothing (the tail of a compacted
// row prefix carries leaf -1).  The output is written through three
// strides: hist_uniform's dense [planes, L, F*B] and hist_varbin's packed
// [Q8, L, 3] (row q, column 3 l + s) are two stride sets of one body.
//
// Design.  On the TPU the histogram was a one-hot matmul on the MXU,
// because a vector machine serializes scatters.  Hopper scatters well into
// shared memory, so this is the classic privatised histogram (gpu_hist,
// which the JAX package named as the design it replaced): the tile body
// of hist_common.cuh, with integer fixed-point sums, so the histogram is
// exact and the same run to run.  This file holds only its slot function.
//
// Tiling.  A whole level does not fit in shared memory: at depth 6 a
// level histograms up to L = 32 leaf slots (16 parent slots on the
// subtract path), 3 x 16 x 1,136 packed rows x 8 B = 436 KB for the bench
// frame, against 227 KB a block can use.  The wrapper
// (models/tree/hist.py::hist_tiles) cuts the output into tiles of a
// contiguous feature range x a leaf range, each at most `smem_budget`
// bytes: the leaf range is the largest even split of L that lets the
// widest feature segment fit, and features are packed greedily into
// ranges at that leaf width.  blockIdx.x is the tile and blockIdx.y the
// row range: the tiles of one row range run side by side, so the leaf and
// stat rows they all read come from L2 after the first.  A tile whose
// single feature does not fit even at one leaf is marked use_smem = 0 and
// adds straight to global memory.
//
// Row windows (the node-sparse levels).  There L is up to 4,096 parent
// slots, and with every tile reading every row the ~600 tiles of a deep
// level each walked the whole prefix of n / 2 + 1 rows to keep the few
// of their slots.  csrc/slot_compact.cu writes the prefix ordered by
// parent slot, each slot's rows in a window [row_start[k][l],
// row_start[k][l + 1]), so a tile over leaves [l0, l0 + ln) reads only
// [row_start[k][l0], row_start[k][l0 + ln]).  A narrower leaf range then
// costs no extra reads while a further feature range rereads every row,
// so these launches take models/tree/hist.py::slot_tiles: the widest
// feature ranges that fit at one leaf (all 8 bench features, 368 packed
// rows at nbins 64: 8.8 KB a slot, 11 slots a tile), each at the widest
// leaf range that fits.  Rows per slot are far from even (DRF's min_rows = 1 and row
// sampling), so blocks are handed out by rows: plan_kernel scans, on the
// device, ceil(window rows / R) chunks per (tree, tile); a 1-D grid sized
// by the host's bound on that total (no host sync) finds each block's
// (tree, tile, chunk) by binary search, and blocks past the total exit.
// One slot holding most of a level's rows is then many chunks of its
// tile, not one block's serial walk.
//
// The K axis.  A multinomial round grows K class trees, level by level;
// the JAX package vmaps the level histogram over them
// (_make_batched_level_fn, hist.py:637), which Pallas lowers to one
// pallas_call with K prepended to the grid.  Here blockIdx.z is the tree
// (over row windows, the tree is part of each block's work item):
// each tree has its own leaf ids, stats, fixed-point scales and output,
// and its own codes below the root (its compacted row prefix), while at
// the root all K trees read one code plane (stride 0, no K copies).  A
// tree's histogram is bitwise the one a launch of that tree alone gives:
// the same tiles and the same exact integer sums.  So one launch serves a
// whole level of all K trees, whatever K is.
//
// What bounds it on this card: the shared-memory atomics, not the bytes,
// on the dense levels.
// Per 10M-row bench tree on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, CUDA events) it takes 1.95 ms on the exact levels
// against a 0.24 ms byte bound (codes 2 B, leaf 4 B and stats 12 B per
// row, the output once), and 2.73 ms as the hierarchical search's coarse
// pass against 0.38 ms.  Every (row, feature) lands 3 (or 4) 64-bit adds,
// each one or two native ATOMS.ADD (the f32 tile this replaced ran a
// compare-and-swap loop per add and took 3.19 and 6.42 ms;
// tools/hist_ab.py times the two in turns), and rows of one leaf with the
// same low-cardinality code (day_of_week has 7 bins; on the coarse pass
// four of the eight features put every row of a leaf in one super-bin)
// land on one word, where the atomic unit serialises them.  The design's
// answer is the lane-striped copies of hist_common.cuh, which cut the
// coarse pass by a quarter; what is left is the adds themselves.  At
// the node-sparse levels of a 10M-row DRF tree at its defaults (same
// card) the windowed launches take 2.73 ms at the 12 levels against a
// 0.18 ms byte bound, where the same kernel over the same prefix without
// windows took 50.56 ms: a level costs 0.18-0.27 ms whatever its rows
// (2.45M to 0.15M in windows), so what is left there is per tile, the
// zeroing and flushing of 373 shared tiles of up to 96 KB at 4,096
// slots and the output's int64 zeroing and dequantising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using hist_common::kThreads;
using hist_common::kTileInts;
using hist_common::u64;

template <typename CodeT>
struct BinSlots {
  const CodeT* codes;
  long long code_stride;
  const int32_t* fmeta;          // [3, F]: code_off, qstart, qlen
  int F, fa, fb;

  template <class Emit>
  __device__ __forceinline__ void each(int r, int, Emit emit) const {
    for (int f = fa; f < fb; ++f) {
      const int q = __ldg(fmeta + f) +
                    (int)__ldg(codes + (long long)f * code_stride + r);
      const int s0 = __ldg(fmeta + F + f);
      if (q < s0 || q >= s0 + __ldg(fmeta + 2 * F + f)) continue;
      emit(q);
    }
  }
};

// Per-tree strides of the K axis (tree k): tree k reads codes + k *
// code, leaf + k * leaf, stats + k * stat, its scales at qscale + k *
// scale, and adds into out + k * out.  code is 0 where the K trees share
// one [F, n] code plane (the root level); K = 1 takes all 0.
struct TreeStrides {
  long long code, leaf, stat, scale, out;
};

// The row windows of the slot geometry (null row_start: none).  Tree k's
// rows of leaf (parent slot) l lie at [row_start[k][l], row_start[k][l +
// 1]) of its prefix; plan [K*T + 1] is the exclusive scan, over the (tree,
// tile) items i = k * T + t, of ceil(rows of item i / rows) chunks, its
// last entry their total.
struct Windows {
  const int32_t* row_start;
  const int32_t* plan;
  int L, T, K, rows;
};

// One block of 1,024 threads writes `plan`: per (tree, tile) item its
// window's chunks of w.rows rows, scanned in rounds of 1,024 items.
__global__ void __launch_bounds__(1024)
plan_kernel(const int32_t* __restrict__ tiles, const int32_t* __restrict__ rs,
            int L, int T, int K, int rows, int n, int32_t* __restrict__ plan) {
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  const int items = K * T;
  for (int base = 0; base < items; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < items) {
      const int k = i / T;
      const int32_t* tl = tiles + (size_t)(i - k * T) * kTileInts;
      const int32_t* w = rs + (size_t)k * (L + 1);
      const int lo = min(max(w[tl[4]], 0), n);
      const int hi = min(max(w[tl[4] + tl[5]], lo), n);
      v = (hi - lo + rows - 1) / rows;
    }
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int x = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += u;
      }
      warp_sum[lane] = x;                     // inclusive, per warp
    }
    __syncthreads();
    incl += (warp ? warp_sum[warp - 1] : 0) + carry;
    if (i < items) plan[i] = incl - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) plan[items] = carry;
}

// Three blocks of 512 threads an SM: at most 42 registers a thread.  The
// per-tree pointers of the K axis took the kernel from 40 registers to 56
// (two blocks an SM), which cost a 10M-row tree 18% (PERF.md);
// with this bound ptxas recomputes the offsets instead of holding them.
//
// kWindows = false: blockIdx = (tile, row slice, tree), the slice of
// rows_per_block rows read whole.  kWindows = true: a 1-D grid over the
// plan's chunks (the host's bound on their total; blocks past it exit);
// block b finds its item i (plan[i] <= b < plan[i + 1]) by binary search,
// every thread alike (the plan is small and stays in L1), and reads rows
// [lo + c * rows, min(hi, lo + (c + 1) * rows)) of its tile's window [lo,
// hi), c = b - plan[i].
template <typename CodeT, bool kWindows>
__global__ void __launch_bounds__(kThreads, 3)
hist_kernel(const CodeT* __restrict__ codes, long long code_stride,
            const int32_t* __restrict__ leaf,
            const float* __restrict__ stats, long long stat_stride,
            const double* __restrict__ qscale,
            const int32_t* __restrict__ fmeta, int F,
            const int32_t* __restrict__ tiles, int n, int rows_per_block,
            int planes, u64* __restrict__ out, long long ss, long long sl,
            long long sq, TreeStrides kst, Windows w) {
  extern __shared__ u64 sums[];
  long long k;
  int tile, r0, r1;
  if (kWindows) {
    const int b = blockIdx.x;
    const int items = w.T * w.K;
    if (b >= __ldg(w.plan + items)) return;
    int lo = 0, hi = items;                     // plan[lo] <= b < plan[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(w.plan + mid) <= b) lo = mid; else hi = mid;
    }
    k = lo / w.T;
    tile = lo - (int)k * w.T;
    const int32_t* tl = tiles + (size_t)tile * kTileInts;
    const int32_t* rs = w.row_start + k * (w.L + 1);
    const int a = min(max(__ldg(rs + __ldg(tl + 4)), 0), n);
    const int e = min(max(__ldg(rs + __ldg(tl + 4) + __ldg(tl + 5)), a), n);
    r0 = a + (b - __ldg(w.plan + lo)) * w.rows;
    r1 = min(e, r0 + w.rows);
  } else {
    k = blockIdx.z;
    tile = blockIdx.x;
    r0 = blockIdx.y * rows_per_block;
    r1 = min(n, r0 + rows_per_block);
  }
  codes += k * kst.code;
  leaf += k * kst.leaf;
  stats += k * kst.stat;
  qscale += k * kst.scale;
  out += k * kst.out;
  const hist_common::Tile t(tiles + (size_t)tile * kTileInts);
  const BinSlots<CodeT> slots{codes, code_stride, fmeta, F, t.fa, t.fb};
  hist_common::tile_body(slots, t, sums, leaf, stats, stat_stride, qscale,
                         planes, r0, r1, out, ss, sl, sq);
}

template <typename CodeT>
int launch(const void* codes, long long code_stride, const int32_t* leaf,
           const float* stats, long long stat_stride, const double* qscale,
           const int32_t* fmeta, int F, const int32_t* tiles, int n_tiles,
           int n, int rows_per_block, int smem_bytes, int planes, u64* out,
           long long ss, long long sl, long long sq, int K, TreeStrides kst,
           const Windows& w, int grid_blocks, cudaStream_t stream) {
  if (w.row_start == nullptr) {
    auto kern = hist_kernel<CodeT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n_tiles, (n + rows_per_block - 1) / rows_per_block, K);
    kern<<<grid, kThreads, smem_bytes, stream>>>(
        (const CodeT*)codes, code_stride, leaf, stats, stat_stride, qscale,
        fmeta, F, tiles, n, rows_per_block, planes, out, ss, sl, sq, kst, w);
    return (int)cudaGetLastError();
  }
  auto kern = hist_kernel<CodeT, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  plan_kernel<<<1, 1024, 0, stream>>>(tiles, w.row_start, w.L, n_tiles, K,
                                      w.rows, n, const_cast<int32_t*>(w.plan));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_blocks, kThreads, smem_bytes, stream>>>(
      (const CodeT*)codes, code_stride, leaf, stats, stat_stride, qscale,
      fmeta, F, tiles, n, rows_per_block, planes, out, ss, sl, sq, kst, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  The kernel
// adds into `out` (int64 fixed point), which the caller zeroes and
// dequantises.  codes: [F, code_stride] of int16 (code_bytes 2) or int32
// (4); leaf: [n] int32; stats: [3, stat_stride] f32; qscale: [3] f64, each
// stat plane's scale 2^s_p; fmeta: [3, F] int32 (code_off, qstart, qlen);
// tiles: [n_tiles, 8] int32; planes: 3, or 4 to add the |g| plane at
// 3 * ss.  K trees (K >= 1) in one launch: tree k's codes, leaf, stats,
// scales and output lie k * (code_k, leaf_k, stat_k, scale_k, out_k)
// elements further on (code_k = 0: the trees share the codes).
//
// Row windows: with row_start [K, L + 1] int32 (not null), where each
// tree's leaf l holds the rows [row_start[k][l], row_start[k][l + 1]) of
// its prefix of n rows, a tile over leaves [l0, l0 + ln) reads only
// [row_start[k][l0], row_start[k][l0 + ln]), in chunks of window_rows
// rows; plan is [K * n_tiles + 1] int32 scratch and grid_blocks at least
// K * n_tiles plus the chunks the windows can need (rows_per_block is
// then unused).  Null row_start: every tile reads all n rows, in slices
// of rows_per_block.  Every pointer is a device pointer.
extern "C" int hist_launch(const void* codes, int code_bytes,
                           long long code_stride, const int32_t* leaf,
                           const float* stats, long long stat_stride,
                           const double* qscale, const int32_t* fmeta,
                           int F, const int32_t* tiles, int n_tiles, int n,
                           int rows_per_block, int smem_bytes, int planes,
                           long long* out, long long ss, long long sl,
                           long long sq, int K, long long code_k,
                           long long leaf_k, long long stat_k,
                           long long scale_k, long long out_k,
                           const int32_t* row_start, int L, int32_t* plan,
                           int window_rows, int grid_blocks,
                           cudaStream_t stream) {
  if (n <= 0 || n_tiles <= 0 || K == 0) return (int)cudaSuccess;
  if ((planes != 3 && planes != 4) || K < 0 || K > 65535)
    return (int)cudaErrorInvalidValue;
  if (row_start == nullptr ? rows_per_block <= 0
                           : (plan == nullptr || window_rows <= 0 ||
                              grid_blocks <= 0 || L <= 0))
    return (int)cudaErrorInvalidValue;
  u64* o = reinterpret_cast<u64*>(out);
  const TreeStrides kst{code_k, leaf_k, stat_k, scale_k, out_k};
  const Windows w{row_start, plan, L, n_tiles, K, window_rows};
  if (code_bytes == 2)
    return launch<int16_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, fmeta, F, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, planes, o, ss, sl, sq,
                           K, kst, w, grid_blocks, stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, fmeta, F, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, planes, o, ss, sl, sq,
                           K, kst, w, grid_blocks, stream);
  return (int)cudaErrorInvalidValue;
}
