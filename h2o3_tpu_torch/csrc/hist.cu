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
// What bounds it on this card: the shared-memory atomics, not the bytes.
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
// coarse pass by a quarter; what is left is the adds themselves.

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

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const CodeT* __restrict__ codes, long long code_stride,
            const int32_t* __restrict__ leaf,
            const float* __restrict__ stats, long long stat_stride,
            const double* __restrict__ qscale,
            const int32_t* __restrict__ fmeta, int F,
            const int32_t* __restrict__ tiles, int n, int rows_per_block,
            int planes, u64* __restrict__ out, long long ss, long long sl,
            long long sq) {
  extern __shared__ u64 sums[];
  const hist_common::Tile t(tiles + (size_t)blockIdx.x * kTileInts);
  const BinSlots<CodeT> slots{codes, code_stride, fmeta, F, t.fa, t.fb};
  hist_common::tile_body(slots, t, sums, leaf, stats, stat_stride, qscale,
                         planes, n, rows_per_block, out, ss, sl, sq);
}

template <typename CodeT>
int launch(const void* codes, long long code_stride, const int32_t* leaf,
           const float* stats, long long stat_stride, const double* qscale,
           const int32_t* fmeta, int F, const int32_t* tiles, int n_tiles,
           int n, int rows_per_block, int smem_bytes, int planes, u64* out,
           long long ss, long long sl, long long sq, cudaStream_t stream) {
  auto kern = hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n + rows_per_block - 1) / rows_per_block);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      (const CodeT*)codes, code_stride, leaf, stats, stat_stride, qscale,
      fmeta, F, tiles, n, rows_per_block, planes, out, ss, sl, sq);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  The kernel
// adds into `out` (int64 fixed point), which the caller zeroes and
// dequantises.  codes: [F, code_stride] of int16 (code_bytes 2) or int32
// (4); leaf: [n] int32; stats: [3, stat_stride] f32; qscale: [3] f64, each
// stat plane's scale 2^s_p; fmeta: [3, F] int32 (code_off, qstart, qlen);
// tiles: [n_tiles, 8] int32; planes: 3, or 4 to add the |g| plane at
// 3 * ss.  Every pointer is a device pointer.
extern "C" int hist_launch(const void* codes, int code_bytes,
                           long long code_stride, const int32_t* leaf,
                           const float* stats, long long stat_stride,
                           const double* qscale, const int32_t* fmeta,
                           int F, const int32_t* tiles, int n_tiles, int n,
                           int rows_per_block, int smem_bytes, int planes,
                           long long* out, long long ss, long long sl,
                           long long sq, cudaStream_t stream) {
  if (n <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || (planes != 3 && planes != 4))
    return (int)cudaErrorInvalidValue;
  u64* o = reinterpret_cast<u64*>(out);
  if (code_bytes == 2)
    return launch<int16_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, fmeta, F, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, planes, o, ss, sl, sq,
                           stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, fmeta, F, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, planes, o, ss, sl, sq,
                           stream);
  return (int)cudaErrorInvalidValue;
}
