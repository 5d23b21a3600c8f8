// Packed-ensemble traversal for Hopper (sm_90a): the online scoring kernel.
//
// Replaces h2o3_tpu/serving/kernel.py::_make_pallas_traverse (the Pallas
// TPU kernel) and computes what it computes: for every (row, tree) of a
// request batch, a `depth`-step descent through the bitpacked ensemble of
// serving/pack.py, then the f32 value of the node reached.  The result is
// a copied leaf value, bitwise equal to serving/kernel.py::traverse_torch.
//
// Node record (int2, 8 bytes): .x the packed word, .y the threshold or
// leaf value's bits -- pack.py's two planes side by side, interleaved
// once when a model is published (serving/kernel.py::interleave), so a
// descent step reads one 8-byte record where it read a word and a
// threshold from two planes.  The word (read as uint32 so that >> 12
// does not sign-extend):
//   bits 0..9 feature id | bit 10 NA-goes-left | bit 11 leaf |
//   bits 12..31 left-child delta (child = node + delta [+ 1 if right]).
// A row goes right when x[feat] >= thr; a NaN goes right when NA-left is 0.
// Leaves loop to themselves, so a descent stops at its first leaf.
//
// What bounds it on this card: latency, not bytes and not sectors.  A
// batch needs well under a megabyte, and each step of a descent reads a
// record at an address that the step before computed, so a launch lasts
// about the launch itself plus its longest chain of dependent loads: on
// an NVIDIA H100 80GB HBM3 at 700 W, ~0.008 ms at 1 row and at 256 rows
// alike (PERF.md).  Halving the sectors of each step (one record, not two
// planes) took ~15% off; putting rows on a warp's lanes (one tree a warp,
// broadcast top nodes, a fraction of the sectors) ran slower, and copying
// the trees' top levels into shared memory first gained 3-5% at a few
// rows and nothing at 256, too little for a second path (PERF.md keeps
// both designs' times).  So the design keeps the chains short and many:
//   * trees on lanes, rows on warps: one thread per (row, tree), 32 trees
//     of 8 rows a block, tens of thousands of independent chains at a
//     full batch;
//   * the block's rows of X sit in shared memory, so the feature read of
//     a step is a shared-memory load, not a third global gather; the root
//     and its record are loaded before the block waits for X, so those
//     two dependent loads overlap the copy;
//   * one 8-byte record a step, through the read-only path; a thread
//     stops at its leaf;
//   * the output is row-major [B, R] and a warp spans 32 neighbouring
//     trees of one row, so each warp's store is one 128-byte line.
// The last row tile may be ragged: rows >= B are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFeatMask = 0x3FFu;
constexpr int kNaLeftBit = 10;
constexpr int kLeafBit = 11;
constexpr int kDeltaShift = 12;

constexpr int kTrees = 32;           // threadIdx.x: one warp of trees
constexpr int kRows = 8;             // threadIdx.y: rows of X in smem

__global__ void __launch_bounds__(kTrees * kRows)
traverse_kernel(const int2* __restrict__ nodes,
                const int32_t* __restrict__ roots,
                const float* __restrict__ X, float* __restrict__ out,
                int B, int F, int R, int depth) {
  extern __shared__ float xs[];                  // [kRows, F]
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int t = blockIdx.y * kTrees + threadIdx.x;

  int node = 0;
  int2 rec = make_int2(0, 0);
  if (t < R) {
    node = __ldg(roots + t);
    rec = __ldg(nodes + node);
  }
  const int tid = threadIdx.y * kTrees + threadIdx.x;
  const float* xrow = X + (size_t)row0 * F;
  for (int i = tid; i < rows * F; i += kTrees * kRows) {
    xs[i] = __ldg(xrow + i);                     // the rows are contiguous
  }
  __syncthreads();

  const int r = threadIdx.y;
  if (r >= rows || t >= R) return;
  const float* x = xs + r * F;
  for (int d = 0; d < depth; ++d) {
    const uint32_t w = (uint32_t)rec.x;
    if (w & (1u << kLeafBit)) break;
    const float v = x[w & kFeatMask];
    const bool right = isnan(v) ? ((w >> kNaLeftBit) & 1u) == 0u
                                : v >= __int_as_float(rec.y);
    node += (int)(w >> kDeltaShift) + (int)right;
    rec = __ldg(nodes + node);
  }
  out[(size_t)(row0 + r) * R + t] = __int_as_float(rec.y);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// kernel does not synchronise.  Device pointers to contiguous arrays:
// nodes[N] int2 records (serving/kernel.py::interleave), roots[R],
// X[B, F], out[B, R].
extern "C" int traverse_launch(const void* nodes, const int* roots,
                               const float* X, float* out, int B, int F,
                               int R, int depth, cudaStream_t stream) {
  if (B <= 0 || R <= 0) return (int)cudaSuccess;
  const dim3 block(kTrees, kRows);
  // row tiles on grid.x (up to 2^31 - 1), tree groups on grid.y (up to
  // 65,535: 2M trees), so a batch of any row count is one launch
  const dim3 grid((B + kRows - 1) / kRows, (R + kTrees - 1) / kTrees);
  const size_t smem = (size_t)kRows * F * sizeof(float);
  traverse_kernel<<<grid, block, smem, stream>>>(
      static_cast<const int2*>(nodes), roots, X, out, B, F, R, depth);
  return (int)cudaGetLastError();
}
