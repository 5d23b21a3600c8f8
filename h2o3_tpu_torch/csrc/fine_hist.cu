// Fine-refinement histogram of the hierarchical split search, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel h2o3_tpu/models/tree/hist.py::
// _make_pallas_fine_hist (:1130).  For every row r with 0 <= leaf[r] < L
// and every feature f whose code c = codes[f][r] is a regular bin
// (0 <= c < nbins: the NA code nbins never lands, even where nbins < S*W
// would alias it into a slot of the last super-bin), and every k with
// sel[leaf[r]][f][k] == c / W:
//   H[s][leaf[r]][f][k][c % W] += stats[s][r]     s = 0 (g), 1 (h), 2 (w)
// H is [3, L, F, K, W], contiguous; sel [L, F, K] int32 names the K
// super-bins (of W fine bins each) chosen per (leaf, feature) by the
// coarse pass.  A row whose leaf is outside [0, L) adds nothing.
//
// Design.  The TPU body built a one-hot [W*TF*K, R] matrix of "the row's
// code falls on fine slot t of its leaf's k-th super-bin" and contracted
// it with the stats on the MXU, with the per-row super-bin table itself a
// one-hot(leaf) x sel product: a chip without scatters or gathers.  Here
// it is the privatised tile of hist_common.cuh, which csrc/hist.cu shares,
// with integer fixed-point sums (exact, the same run to run): the packed
// axis is the K*W fine slots of each feature (q = f*K*W + k*W + t), the
// output is tiled over (feature range x leaf range) by
// models/tree/hist.py::hist_tiles under the same shared-memory budget,
// and each block stages the tile's slice of sel in shared memory before
// its sums.  This file holds only that staging and its slot function.
//
// What bounds it on this card: the shared-memory atomics, as for hist.cu.
// Per 10M-row hier bench tree on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, CUDA events) it takes 4.41 ms against a 0.86 ms byte
// bound (codes, leaf and stats once per tile, 48 B a row at F = 8 with
// int32 codes; the f32 tile this replaced took 6.12 ms,
// tools/hist_ab.py): every landing (row, feature, k) adds three 64-bit
// sums, each one or two native 32-bit ATOMS.ADD, and low-cardinality
// features put every row of a leaf on a few words (day_of_week's seven
// codes fall in super-bin 0 at W = 16), where the atomic unit serialises
// them; the lane-striped copies spread those words where the tile is
// small (the first levels).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using hist_common::kThreads;
using hist_common::kTileInts;
using hist_common::u64;

template <typename CodeT>
struct FineSlots {
  const CodeT* codes;
  long long code_stride;
  const int32_t* ssel;           // the tile's sel [ln, nf, K], in shared memory
  int fa, fb, K, W, nbins;

  template <class Emit>
  __device__ __forceinline__ void each(int r, int lf, Emit emit) const {
    const int nf = fb - fa;
    const int32_t* srow = ssel + lf * nf * K;
    for (int f = fa; f < fb; ++f) {
      const int c = (int)__ldg(codes + (long long)f * code_stride + r);
      if ((unsigned)c >= (unsigned)nbins) continue;   // NA (and padding)
      const int sb = c / W;
      const int q0 = f * K * W + c - sb * W;
      const int32_t* sk = srow + (f - fa) * K;
      for (int k = 0; k < K; ++k)
        if (sk[k] == sb) emit(q0 + k * W);
    }
  }
};

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
fine_hist_kernel(const CodeT* __restrict__ codes, long long code_stride,
                 const int32_t* __restrict__ leaf,
                 const float* __restrict__ stats, long long stat_stride,
                 const double* __restrict__ qscale,
                 const int32_t* __restrict__ sel, int L, int F, int K,
                 int W, int nbins, const int32_t* __restrict__ tiles, int n,
                 int rows_per_block, u64* __restrict__ out) {
  // smem: the tile's sel [ln, nf, K] int32, 8-byte aligned, then the sums
  extern __shared__ u64 smem[];
  const hist_common::Tile t(tiles + (size_t)blockIdx.x * kTileInts);
  const int nf = t.fb - t.fa;
  const int nsel = t.ln * nf * K;
  int32_t* ssel = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < nsel; i += blockDim.x) {
    const int k = i % K;
    const int rest = i / K;
    const int fl = rest % nf;
    const int lf = rest / nf;
    ssel[i] = __ldg(sel + ((long long)(lf + t.l0) * F + t.fa + fl) * K + k);
  }
  const long long sl = (long long)F * K * W;      // output strides
  const FineSlots<CodeT> slots{codes, code_stride, ssel, t.fa, t.fb, K, W,
                               nbins};
  const int r0 = blockIdx.y * rows_per_block;
  hist_common::tile_body(slots, t, smem + (nsel + 1) / 2, leaf, stats,
                         stat_stride, qscale, 3, r0,
                         min(n, r0 + rows_per_block), out, L * sl, sl, 1);
}

template <typename CodeT>
int launch(const void* codes, long long code_stride, const int32_t* leaf,
           const float* stats, long long stat_stride, const double* qscale,
           const int32_t* sel, int L, int F, int K, int W, int nbins,
           const int32_t* tiles, int n_tiles, int n, int rows_per_block,
           int smem_bytes, u64* out, cudaStream_t stream) {
  auto kern = fine_hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n + rows_per_block - 1) / rows_per_block);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      (const CodeT*)codes, code_stride, leaf, stats, stat_stride, qscale,
      sel, L, F, K, W, nbins, tiles, n, rows_per_block, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  The kernel
// adds into `out` [3, L, F, K, W] int64 fixed point, which the caller
// zeroes and dequantises.  codes: [F, code_stride] of int16 (code_bytes 2)
// or int32 (4); leaf: [n] int32; stats: [3, stat_stride] f32; qscale: [3]
// f64, each stat plane's scale 2^s_p; sel: [L, F, K] int32; tiles:
// [n_tiles, 8] int32 over the packed axis of F segments of K*W slots;
// smem_bytes holds the largest tile's sel slice (8-byte aligned) and
// sums.  Every pointer is a device pointer.
extern "C" int fine_hist_launch(const void* codes, int code_bytes,
                                long long code_stride, const int32_t* leaf,
                                const float* stats, long long stat_stride,
                                const double* qscale, const int32_t* sel,
                                int L, int F, int K, int W, int nbins,
                                const int32_t* tiles, int n_tiles, int n,
                                int rows_per_block, int smem_bytes,
                                long long* out, cudaStream_t stream) {
  if (n <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || K <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  u64* o = reinterpret_cast<u64*>(out);
  if (code_bytes == 2)
    return launch<int16_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, sel, L, F, K, W, nbins, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, o, stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, code_stride, leaf, stats, stat_stride,
                           qscale, sel, L, F, K, W, nbins, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, o, stream);
  return (int)cudaErrorInvalidValue;
}
