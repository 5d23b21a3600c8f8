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
// strides: hist_uniform's dense [3, L, F*B] and hist_varbin's packed
// [Q8, 3L] (row q, column 3 l + s) are two stride sets of one body.
//
// Design.  On the TPU the histogram was a one-hot matmul on the MXU,
// because a vector machine serializes scatters.  Hopper scatters well into
// shared memory, so this is the classic privatised histogram (gpu_hist,
// which the JAX package named as the design it replaced): each block takes
// a range of rows and one TILE of the output, accumulates f32 atomics into
// a zeroed copy of the tile in shared memory, and adds its non-zero
// entries to the global output at the end with f64 atomics: the output is
// an f64 buffer that the wrapper rounds to f32 once.  A slot of a
// low-cardinality feature can hold every row (all 1M rows of day_of_week
// in one super-bin of the hierarchical search's coarse pass); hundreds of
// f32 block partials added in f32 drift there by units, in another way
// each run, and parent - child subtractions carry the drift into the deep
// levels' small nodes.
//
// Tiling.  A whole level does not fit in shared memory: at depth 6 a
// level histograms up to L = 32 leaf slots (16 parent slots on the
// subtract path), 3 x 32 x 1,136 packed rows x 4 B = 436 KB for the bench
// frame (789 KB on the uniform axis), against 227 KB a block can use.  The wrapper (models/tree/hist.py::hist_tiles)
// cuts the output into tiles of a contiguous feature range x a leaf range,
// each at most `smem_budget` bytes: the leaf range is the largest even
// split of L that lets the widest feature segment fit, and features are
// packed greedily into ranges at that leaf width, so the packed layout's
// uneven segments fill tiles unevenly.  blockIdx.x is the tile and
// blockIdx.y the row range: the tiles of one row range run side by side,
// so the leaf and stat rows they all read come from L2 after the first.
// A tile whose single feature does not fit even at one leaf is marked
// use_smem = 0 and adds straight to global memory.  A tile far under the
// budget gets `copies` (up to one per warp of the block) side by side:
// warp w adds into copy w % copies, and the copies are summed at the end.
// That divides the collisions on a hot word, and the rows that round
// into one f32 partial, by the number of copies.
//
// What bounds it on this card: the atomics.  The bytes are small (codes
// 2 B, leaf 4 B and stats 12 B per row, read once per tile), but every
// (row, feature) does three shared-memory atomic adds, and rows of one
// leaf with the same low-cardinality code (day_of_week has 7 bins) collide
// on an address and serialize.  f32 atomics make the summation order, and
// so the last bits of a block's partial sum, vary from run to run (their
// f64 total seldom rounds to another f32): sums of integer-valued stats
// are exact whatever the order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileInts = 8;   // fa, fb, qa, qn, l0, ln, use_smem, copies

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const CodeT* __restrict__ codes, long long code_stride,
            const int32_t* __restrict__ leaf,
            const float* __restrict__ stats, long long stat_stride,
            const int32_t* __restrict__ fmeta, int F,
            const int32_t* __restrict__ tiles, int n, int rows_per_block,
            int planes, double* __restrict__ out, long long ss,
            long long sl, long long sq) {
  extern __shared__ float sh[];
  const int32_t* t = tiles + (size_t)blockIdx.x * kTileInts;
  const int fa = t[0], fb = t[1], qa = t[2], qn = t[3];
  const int l0 = t[4], ln = t[5], use_smem = t[6], copies = t[7];
  const int* code_off = fmeta;
  const int* qstart = fmeta + F;
  const int* qlen = fmeta + 2 * F;
  const int size = qn * ln * planes;
  float* mine = sh + ((threadIdx.x >> 5) % copies) * size;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);

  if (use_smem) {
    for (int i = threadIdx.x; i < copies * size; i += blockDim.x)
      sh[i] = 0.0f;
    __syncthreads();
  }
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int lf = __ldg(leaf + r) - l0;
    if ((unsigned)lf >= (unsigned)ln) continue;
    const float g = __ldg(stats + r);
    const float h = __ldg(stats + stat_stride + r);
    const float w = __ldg(stats + 2 * stat_stride + r);
    for (int f = fa; f < fb; ++f) {
      const int q = __ldg(code_off + f) +
                    (int)__ldg(codes + (long long)f * code_stride + r);
      const int s0 = __ldg(qstart + f);
      if (q < s0 || q >= s0 + __ldg(qlen + f)) continue;
      if (use_smem) {
        float* p = mine + ((q - qa) * ln + lf) * planes;
        atomicAdd(p, g);
        atomicAdd(p + 1, h);
        atomicAdd(p + 2, w);
        if (planes == 4) atomicAdd(p + 3, fabsf(g));
      } else {
        double* o = out + (long long)q * sq + (long long)(lf + l0) * sl;
        atomicAdd(o, (double)g);
        atomicAdd(o + ss, (double)h);
        atomicAdd(o + 2 * ss, (double)w);
        if (planes == 4) atomicAdd(o + 3 * ss, (double)fabsf(g));
      }
    }
  }
  if (!use_smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    double v = 0.0;
    for (int c = 0; c < copies; ++c) v += sh[c * size + i];
    if (v == 0.0) continue;         // the output starts at +0: adding 0 is a no-op
    const int s = i % planes;
    const int rest = i / planes;
    const int l = rest % ln + l0;
    const int q = rest / ln + qa;
    atomicAdd(out + (long long)q * sq + (long long)l * sl + s * ss,
              (double)v);
  }
}

template <typename CodeT>
int launch(const void* codes, long long code_stride, const int32_t* leaf,
           const float* stats, long long stat_stride, const int32_t* fmeta,
           int F, const int32_t* tiles, int n_tiles, int n,
           int rows_per_block, int smem_bytes, int planes, double* out,
           long long ss, long long sl, long long sq, cudaStream_t stream) {
  auto kern = hist_kernel<CodeT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (n + rows_per_block - 1) / rows_per_block);
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      (const CodeT*)codes, code_stride, leaf, stats, stat_stride, fmeta, F,
      tiles, n, rows_per_block, planes, out, ss, sl, sq);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  The kernel
// adds into `out` (f64), which the caller zeroes.  codes: [F, code_stride] of
// int16 (code_bytes 2) or int32 (4); leaf: [n] int32; stats: [3,
// stat_stride] f32; fmeta: [3, F] int32 (code_off, qstart, qlen); tiles:
// [n_tiles, 8] int32; planes: 3, or 4 to add the |g| plane at 3 * ss.
// Every pointer is a device pointer.
extern "C" int hist_launch(const void* codes, int code_bytes,
                           long long code_stride, const int32_t* leaf,
                           const float* stats, long long stat_stride,
                           const int32_t* fmeta, int F,
                           const int32_t* tiles, int n_tiles, int n,
                           int rows_per_block, int smem_bytes, int planes,
                           double* out, long long ss, long long sl,
                           long long sq, cudaStream_t stream) {
  if (n <= 0 || n_tiles <= 0) return (int)cudaSuccess;
  if (rows_per_block <= 0 || (planes != 3 && planes != 4))
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 2)
    return launch<int16_t>(codes, code_stride, leaf, stats, stat_stride,
                           fmeta, F, tiles, n_tiles, n, rows_per_block,
                           smem_bytes, planes, out, ss, sl, sq, stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, code_stride, leaf, stats, stat_stride,
                           fmeta, F, tiles, n_tiles, n, rows_per_block,
                           smem_bytes, planes, out, ss, sl, sq, stream);
  return (int)cudaErrorInvalidValue;
}
