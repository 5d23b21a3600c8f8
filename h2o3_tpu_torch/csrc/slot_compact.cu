// The slot-ordered compaction of a node-sparse tree level, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: on the TPU this step is XLA
// (h2o3_tpu/models/tree/hist.py::_sparse_local_body, :988-1035, a cumsum
// scatter of the chosen rows in row order).  It was added because the
// level's histogram (csrc/hist.cu with row windows) needs each parent
// slot's rows side by side: a tile over a leaf range then reads only the
// rows of that range, where a prefix in row order made every tile walk
// the whole prefix.
//
// A level of K trees has, per tree k, each row's slot sleaf[k][r] in
// [0, A] (A: no slot; a value outside [0, A] counts as A) and a table
// dest[k][s] in [-1, A_prev): the parent slot of slot s where s is its
// parent's chosen (smaller) child, -1 for the other child and for A.  Two
// passes, with small torch ops on [K, A]-sized tensors between them
// (models/tree/hist.py::_slot_choice):
//
//   count    cnt[k][s] = the rows of tree k on slot s, int32, the sentinel
//            slot A included: shared-memory int32 atomics inside a block,
//            then one global add per (block, slot) that holds rows;
//   scatter  each chosen row r (dest[k][sleaf[k][r]] = p >= 0) goes to
//            position row_start[k][p] + its place among parent slot p's
//            rows, writing the prefix directly: ccodes [K, F, cap1]
//            (codes [F, n] shared by the trees), pleaf [K, cap1] int32
//            (= p) and st [K, 3, cap1] f32.  row_start [K, A_prev + 1] is
//            the exclusive scan of the chosen rows per parent slot, its
//            last column tree k's count; positions from that count up to
//            cap1 get leaf -1 (their codes and stats are left unwritten:
//            no reader looks past a row of leaf -1).  A block counts its
//            chosen rows per parent slot in shared memory (the shared
//            atomic's old value is each row's place in the block's run),
//            then reserves each run with one global atomicAdd on the
//            parent slot's cursor (a copy of row_start): one global atomic
//            per (block, parent slot), never one per row, which matters at
//            the first sparse levels, where millions of rows fall on 128-256
//            parent slots.
//
// Order.  The SET of rows in each parent slot's window is exact; their
// order inside the window is the order in which the shared and global
// atomics were served, and may differ from run to run.  The histograms
// built from the prefix cannot differ: they sum exact int64 fixed point,
// the same in any order (hist_common.cuh, "The arithmetic").  The plain
// version (hist.py::slot_compact_torch) writes the same windows in
// (parent slot, row) order.
//
// What bounds it: memory transactions.  The count pass reads sleaf (8 B a
// row), the scatter pass sleaf again, then each chosen row's F codes and
// 3 stats from their planes and writes them, with its parent slot, to a
// position that is contiguous only within a block's run of one parent
// slot: runs of a few rows at the first sparse levels, one or two at
// 4,096 slots, so each of a chosen row's F + 3 reads and F + 4 writes is
// a sector of its own.  Over the 12 sparse levels of a 10M-row DRF tree
// at its defaults, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// CUDA events), the compaction takes 5.76 ms against a 0.60 ms byte
// bound (sleaf once, the chosen rows read and written, the tail's leaf;
// the row-order torch compaction it replaced: 30.28 ms): the count pass
// 0.59, the [K, A] choice in torch 0.93, the scatter pass 4.28 (0.14 ms
// a level at 0.15M chosen rows, 0.55 at 2.45M).  Counts, folds and scans
// never use a float atomic (ROADMAP, "Determinism").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 8;                 // rows a thread holds
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;

__device__ __forceinline__ int slot_of(const int64_t* sleaf, int r, int A) {
  const long long v = __ldg(reinterpret_cast<const long long*>(sleaf) + r);
  return (v < 0 || v > A) ? A : (int)v;
}

// grid (row blocks, K); dynamic shared memory: A + 1 int32 counts
__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const int64_t* __restrict__ sleaf, long long sleaf_k,
                  int n, int A, int32_t* __restrict__ cnt) {
  extern __shared__ int32_t scnt[];
  const long long k = blockIdx.y;
  sleaf += k * sleaf_k;
  for (int i = threadIdx.x; i <= A; i += blockDim.x) scnt[i] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(n, r0 + kRowsPerBlock);
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    atomicAdd(scnt + slot_of(sleaf, r, A), 1);
  __syncthreads();
  int32_t* out = cnt + k * (A + 1);
  for (int i = threadIdx.x; i <= A; i += blockDim.x)
    if (scnt[i] != 0) atomicAdd(out + i, scnt[i]);
}

// grid (row blocks, K); dynamic shared memory: dest [A + 1], then the
// per-parent-slot counts, later bases [A_prev], all int32.  Thread t of
// block b holds rows b * kRowsPerBlock + j * kThreads + t, j <
// kRowsPerThread, with their parent slot and place in registers.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
slot_scatter_kernel(const CodeT* __restrict__ codes, long long code_stride,
                    int F, const int64_t* __restrict__ sleaf,
                    long long sleaf_k, const float* __restrict__ stats,
                    long long stat_stride, long long stat_k,
                    const int32_t* __restrict__ dest, int A,
                    int32_t* __restrict__ cursor, int A_prev, int n,
                    int cap1, CodeT* __restrict__ ccodes,
                    int32_t* __restrict__ pleaf, float* __restrict__ st) {
  extern __shared__ int32_t smem[];
  int32_t* sdest = smem;                 // [A + 1]
  int32_t* srun = smem + A + 1;          // [A_prev]
  const long long k = blockIdx.y;
  sleaf += k * sleaf_k;
  stats += k * stat_k;
  dest += k * (A + 1);
  cursor += k * (A_prev + 1);
  ccodes += k * F * (long long)cap1;
  pleaf += k * (long long)cap1;
  st += k * 3 * (long long)cap1;
  for (int i = threadIdx.x; i <= A; i += blockDim.x)
    sdest[i] = __ldg(dest + i);
  for (int i = threadIdx.x; i < A_prev; i += blockDim.x) srun[i] = 0;
  __syncthreads();

  const int r0 = blockIdx.x * kRowsPerBlock + threadIdx.x;
  int par[kRowsPerThread], place[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j * kThreads;
    par[j] = r < n ? sdest[slot_of(sleaf, r, A)] : -1;
    place[j] = par[j] >= 0 ? atomicAdd(srun + par[j], 1) : 0;
  }
  __syncthreads();
  // reserve each parent slot's run of this block: its base replaces its
  // count
  for (int i = threadIdx.x; i < A_prev; i += blockDim.x) {
    const int c = srun[i];
    if (c != 0) srun[i] = atomicAdd(cursor + i, c);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (par[j] < 0) continue;
    const int r = r0 + j * kThreads;
    const long long pos = srun[par[j]] + place[j];
    pleaf[pos] = par[j];
    for (int f = 0; f < F; ++f)
      ccodes[f * (long long)cap1 + pos] =
          __ldg(codes + f * code_stride + r);
#pragma unroll
    for (int s = 0; s < 3; ++s)
      st[s * (long long)cap1 + pos] = __ldg(stats + s * stat_stride + r);
  }
  // the tail past the tree's count takes leaf -1 and nothing else: its
  // codes and stats are never read (a windowed hist stops at the count,
  // any other reader drops a row of leaf -1 first).  The count is the
  // cursor's last column, which no row advances; the blocks cover at
  // least n >= cap1 positions between them
  const int total = cursor[A_prev];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const long long pos = (long long)total + r0 + j * kThreads;
    if (pos >= cap1) break;
    pleaf[pos] = -1;
  }
}

int set_smem(const void* kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename CodeT>
int scatter(const void* codes, long long code_stride, int F,
            const int64_t* sleaf, long long sleaf_k, const float* stats,
            long long stat_stride, long long stat_k, const int32_t* dest,
            int A, int32_t* cursor, int A_prev, int n, int cap1, void* ccodes,
            int32_t* pleaf, float* st, int K, cudaStream_t stream) {
  auto kern = slot_scatter_kernel<CodeT>;
  const int smem = (A + 1 + A_prev) * (int)sizeof(int32_t);
  const int err = set_smem((const void*)kern, smem);
  if (err != 0) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, K);
  kern<<<grid, kThreads, smem, stream>>>(
      (const CodeT*)codes, code_stride, F, sleaf, sleaf_k, stats,
      stat_stride, stat_k, dest, A, cursor, A_prev, n, cap1,
      (CodeT*)ccodes, pleaf, st);
  return (int)cudaGetLastError();
}

}  // namespace

// The count pass on `stream`; returns a CUDA error code (0 = launched).
// Adds into cnt [K, A + 1] int32, which the caller zeroes.  sleaf: tree
// k's [n] int64 slots at sleaf + k * sleaf_k (0: the trees share them).
// Every pointer is a device pointer.
extern "C" int slot_count_launch(const int64_t* sleaf, long long sleaf_k,
                                 int n, int A, int K, int32_t* cnt,
                                 cudaStream_t stream) {
  if (n <= 0 || K == 0) return (int)cudaSuccess;
  if (A < 0 || K < 0 || K > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (A + 1) * (int)sizeof(int32_t);
  const int err = set_smem((const void*)slot_count_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, K);
  slot_count_kernel<<<grid, kThreads, smem, stream>>>(sleaf, sleaf_k, n, A,
                                                      cnt);
  return (int)cudaGetLastError();
}

// The scatter pass on `stream`; returns a CUDA error code (0 = launched).
// codes: [F, code_stride] int16 (code_bytes 2) or int32 (4), shared by the
// K trees; sleaf as for the count; stats: tree k's [3, stat_stride] f32 at
// stats + k * stat_k; dest: [K, A + 1] int32; cursor: [K, A_prev + 1]
// int32, row_start on entry, advanced by the pass (its last column, each
// tree's count, is read and never changed); pleaf [K, cap1] int32 is
// written in full, ccodes [K, F, cap1] of the codes' type and st [K, 3,
// cap1] f32 up to each tree's count.  cap1 <= n.  Every pointer is a
// device pointer.
extern "C" int slot_scatter_launch(const void* codes, int code_bytes,
                                   long long code_stride, int F,
                                   const int64_t* sleaf, long long sleaf_k,
                                   const float* stats, long long stat_stride,
                                   long long stat_k, const int32_t* dest,
                                   int A, int32_t* cursor, int A_prev, int n,
                                   int cap1, void* ccodes, int32_t* pleaf,
                                   float* st, int K, cudaStream_t stream) {
  if (n <= 0 || K == 0) return (int)cudaSuccess;
  if (A < 0 || A_prev <= 0 || F <= 0 || cap1 <= 0 || cap1 > n || K < 0 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  if (code_bytes == 2)
    return scatter<int16_t>(codes, code_stride, F, sleaf, sleaf_k, stats,
                            stat_stride, stat_k, dest, A, cursor, A_prev, n,
                            cap1, ccodes, pleaf, st, K, stream);
  if (code_bytes == 4)
    return scatter<int32_t>(codes, code_stride, F, sleaf, sleaf_k, stats,
                            stat_stride, stat_k, dest, A, cursor, A_prev, n,
                            cap1, ccodes, pleaf, st, K, stream);
  return (int)cudaErrorInvalidValue;
}
