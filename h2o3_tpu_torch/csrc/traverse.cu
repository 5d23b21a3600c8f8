// Packed-ensemble traversal for Hopper (sm_90a): the online scoring kernel.
//
// Replaces h2o3_tpu/serving/kernel.py::_make_pallas_traverse (the Pallas
// TPU kernel) and computes what it computes: for every (row, tree) of a
// request batch, a `depth`-step descent through the bitpacked ensemble of
// serving/pack.py, then the f32 value of the node reached.
//
// Node word (int32, read as uint32 so that >> 12 does not sign-extend):
//   bits 0..9 feature id | bit 10 NA-goes-left | bit 11 leaf |
//   bits 12..31 left-child delta (child = node + delta [+ 1 if right]).
// A row goes right when x[feat] >= thr; a NaN goes right when NA-left is 0.
// Leaves loop to themselves, so a thread may stop at the first leaf.
//
// What bounds it on this card: dependent gathers.  Each of the `depth`
// steps reads a node word and its threshold at an address that the
// previous step computed, so a thread's time is a chain of `depth` cache
// latencies, not bytes: a 300-tree depth-10 model packs into at most
// 4.9 MB of node planes (every heap slot split; 1.1 MB for the serving
// profile's 85%-split trees), which stay resident in the 50 MB L2
// across requests.  The design keeps everything else off that chain and keeps
// many chains in flight:
//   * one thread per (row, tree) — tens of thousands of independent
//     chains per batch hide each other's latency;
//   * the block's rows of X are staged once in shared memory, so the
//     feature read of each step is a shared-memory load, not a third
//     global gather (F <= 1023, pack.py's limit: 8 rows x 1023 x 4 B
//     = 32 KB of dynamic shared memory, under the 48 KB default);
//   * node words and thresholds go through the read-only path (__ldg),
//     and the threshold load is issued beside the word load (both
//     depend only on the node index);
//   * a thread stops at its leaf, so shallow paths of node-sparse
//     trees do not pay for `depth` steps;
//   * the output is row-major [B, R] and a warp spans 32 neighbouring
//     trees of one row, so each warp's store is one 128-byte line.
// The last row tile may be ragged: rows >= B are masked, so B need not
// be a multiple of the tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTreesPerBlock = 32;   // threadIdx.x: one warp of trees
constexpr int kRowsPerBlock = 8;     // threadIdx.y: rows staged in smem

constexpr uint32_t kFeatMask = 0x3FFu;
constexpr int kNaLeftBit = 10;
constexpr int kLeafBit = 11;
constexpr int kDeltaShift = 12;

__global__ void __launch_bounds__(kTreesPerBlock * kRowsPerBlock)
traverse_kernel(const int32_t* __restrict__ nodes_i32,
                const float* __restrict__ nodes_f32,
                const int32_t* __restrict__ roots,
                const float* __restrict__ X,
                float* __restrict__ out,
                int B, int F, int R, int depth) {
  extern __shared__ float xs[];      // [kRowsPerBlock, F]

  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, B - row0);
  const int tid = threadIdx.y * kTreesPerBlock + threadIdx.x;
  const float* xrow = X + (size_t)row0 * F;
  for (int i = tid; i < rows * F; i += kTreesPerBlock * kRowsPerBlock) {
    xs[i] = xrow[i];                 // the tile's rows are contiguous
  }
  __syncthreads();

  const int r = threadIdx.y;
  const int t = blockIdx.y * kTreesPerBlock + threadIdx.x;
  if (r >= rows || t >= R) return;

  const float* x = xs + r * F;
  int node = __ldg(roots + t);
  for (int d = 0; d < depth; ++d) {
    const uint32_t w = (uint32_t)__ldg(nodes_i32 + node);
    const float thr = __ldg(nodes_f32 + node);
    if (w & (1u << kLeafBit)) break;
    const float v = x[w & kFeatMask];
    const bool right = isnan(v) ? ((w >> kNaLeftBit) & 1u) == 0u
                                : v >= thr;
    node += (int)(w >> kDeltaShift) + (int)right;
  }
  out[(size_t)(row0 + r) * R + t] = __ldg(nodes_f32 + node);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// kernel does not synchronise.  Pointers are device pointers to
// contiguous arrays: nodes_i32[N], nodes_f32[N], roots[R], X[B, F],
// out[B, R].
extern "C" int traverse_launch(const int* nodes_i32, const float* nodes_f32,
                               const int* roots, const float* X, float* out,
                               int B, int F, int R, int depth,
                               cudaStream_t stream) {
  if (B <= 0 || R <= 0) return (int)cudaSuccess;
  const dim3 block(kTreesPerBlock, kRowsPerBlock);
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock,
                  (R + kTreesPerBlock - 1) / kTreesPerBlock);
  const size_t smem = (size_t)kRowsPerBlock * F * sizeof(float);
  traverse_kernel<<<grid, block, smem, stream>>>(
      nodes_i32, nodes_f32, roots, X, out, B, F, R, depth);
  return (int)cudaGetLastError();
}
