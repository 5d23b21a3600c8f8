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
// it is csrc/hist.cu's privatised histogram: the packed axis is the K*W
// fine slots of each feature (q = f*K*W + k*W + t), the output is tiled
// over (feature range x leaf range) by models/tree/hist.py::hist_tiles
// under the same shared-memory budget, each block zeroes its tile in
// shared memory, stages the tile's slice of sel beside it, adds each of
// its rows' (g, h, w) with shared atomics into the slot its code selects,
// and adds the tile's non-zero entries to the global output at the end in
// f64 (an f64 buffer that the wrapper rounds to f32 once, as hist.cu's:
// many f32 block partials of a hot slot added in f32 drift by units).  As
// in hist.cu, a small tile gets one copy per warp group (`copies`), summed
// at the end.  blockIdx.x is the tile, blockIdx.y the row range.
//
// What bounds it on this card: the atomics, as for hist.cu.  The bytes
// are codes, leaf and stats once per tile (48 B a row at F = 8 with int32
// codes); low-cardinality features put every row of a leaf on a few
// words (day_of_week's seven codes fall in super-bin 0 at W = 16), and
// those atomics serialize.  f32 atomics make the last bits of a block's
// partial sum run-dependent; sums of integer-valued stats are exact in
// any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileInts = 8;   // fa, fb, qa, qn, l0, ln, use_smem, copies

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
fine_hist_kernel(const CodeT* __restrict__ codes, long long code_stride,
                 const int32_t* __restrict__ leaf,
                 const float* __restrict__ stats, long long stat_stride,
                 const int32_t* __restrict__ sel, int L, int F, int K,
                 int W, int nbins, const int32_t* __restrict__ tiles, int n,
                 int rows_per_block, double* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int32_t* t = tiles + (size_t)blockIdx.x * kTileInts;
  const int fa = t[0], fb = t[1], qa = t[2], qn = t[3];
  const int l0 = t[4], ln = t[5], use_smem = t[6], copies = t[7];
  const int nf = fb - fa;
  const int KW = K * W;
  // smem: the tile's sel [ln, nf, K] int32, then `copies` [qn, ln, 3]
  // tiles of sums
  int32_t* ssel = smem;
  const int nsel = ln * nf * K;
  float* sh = reinterpret_cast<float*>(smem + nsel);
  const int size = use_smem ? qn * ln * 3 : 0;
  float* mine = sh + ((threadIdx.x >> 5) % copies) * size;
  const long long sl = (long long)F * KW;      // output strides
  const long long ss = (long long)L * sl;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);

  for (int i = threadIdx.x; i < nsel; i += blockDim.x) {
    const int k = i % K;
    const int rest = i / K;
    const int fl = rest % nf;
    const int lf = rest / nf;
    ssel[i] = __ldg(sel + ((long long)(lf + l0) * F + fa + fl) * K + k);
  }
  for (int i = threadIdx.x; i < copies * size; i += blockDim.x)
    sh[i] = 0.0f;
  __syncthreads();

  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int lf = __ldg(leaf + r) - l0;
    if ((unsigned)lf >= (unsigned)ln) continue;
    const float g = __ldg(stats + r);
    const float h = __ldg(stats + stat_stride + r);
    const float w = __ldg(stats + 2 * stat_stride + r);
    const int32_t* srow = ssel + lf * nf * K;
    for (int f = fa; f < fb; ++f) {
      const int c = (int)__ldg(codes + (long long)f * code_stride + r);
      if ((unsigned)c >= (unsigned)nbins) continue;   // NA (and padding)
      const int sb = c / W;
      const int tb = c - sb * W;
      const int32_t* sk = srow + (f - fa) * K;
      for (int k = 0; k < K; ++k) {
        if (sk[k] != sb) continue;
        const int q = f * KW + k * W + tb;          // global packed slot
        if (use_smem) {
          float* p = mine + ((q - qa) * ln + lf) * 3;
          atomicAdd(p, g);
          atomicAdd(p + 1, h);
          atomicAdd(p + 2, w);
        } else {
          double* o = out + (long long)(lf + l0) * sl + q;
          atomicAdd(o, (double)g);
          atomicAdd(o + ss, (double)h);
          atomicAdd(o + 2 * ss, (double)w);
        }
      }
    }
  }
  if (!use_smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    double v = 0.0;
    for (int c = 0; c < copies; ++c) v += sh[c * size + i];
    if (v == 0.0) continue;         // the output starts at +0: adding 0 is a no-op
    const int s = i % 3;
    const int rest = i / 3;
    const int l = rest % ln + l0;
    const int q = rest / ln + qa;
    atomicAdd(out + s * ss + (long long)l * sl + q, (double)v);
  }
}

template <typename CodeT>
int launch(const void* codes, long long code_stride, const int32_t* leaf,
           const float* stats, long long stat_stride, const int32_t* sel,
           int L, int F, int K, int W, int nbins, const int32_t* tiles,
           int n_tiles, int n, int rows_per_block, int smem_bytes,
           double* out, cudaStream_t stream) {
  auto kern = fine_hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n + rows_per_block - 1) / rows_per_block);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      (const CodeT*)codes, code_stride, leaf, stats, stat_stride, sel, L, F,
      K, W, nbins, tiles, n, rows_per_block, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  The kernel
// adds into `out` [3, L, F, K, W] f64, which the caller zeroes.  codes:
// [F, code_stride] of int16 (code_bytes 2) or int32 (4); leaf: [n] int32;
// stats: [3, stat_stride] f32; sel: [L, F, K] int32; tiles: [n_tiles, 8]
// int32 over the packed axis of F segments of K*W slots; smem_bytes holds
// the largest tile's sel slice and sums.  Every pointer is a device
// pointer.
extern "C" int fine_hist_launch(const void* codes, int code_bytes,
                                long long code_stride, const int32_t* leaf,
                                const float* stats, long long stat_stride,
                                const int32_t* sel, int L, int F, int K,
                                int W, int nbins, const int32_t* tiles,
                                int n_tiles, int n, int rows_per_block,
                                int smem_bytes, double* out,
                                cudaStream_t stream) {
  if (n <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || K <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 2)
    return launch<int16_t>(codes, code_stride, leaf, stats, stat_stride, sel,
                           L, F, K, W, nbins, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, out, stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, code_stride, leaf, stats, stat_stride, sel,
                           L, F, K, W, nbins, tiles, n_tiles, n,
                           rows_per_block, smem_bytes, out, stream);
  return (int)cudaErrorInvalidValue;
}
