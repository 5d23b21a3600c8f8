// Split-search winner records of tree training for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// h2o3_tpu/models/tree/hist.py::_make_pallas_split_records (:1526) in
// both its forms, and computes what it computes: for every
// (leaf, feature) row of the level histogram H[3, L*F, B] (planes Σg, Σh,
// Σw; bins 0..B-2 regular, B-1 the NA bin, nbins = B - 1):
//   * prefix sums GL/HL/CL over the regular bins, and totals with NA;
//   * for every candidate split after bin b (b <= nbins - 2) the XGBoost
//     gain 1/2 (score(L) + score(R) - score(parent)) - gamma, with
//     score(G, H) = soft(G, alpha)^2 / (H + lambda), once with the NA bin
//     on the left and once on the right; a side with CL < min_rows or
//     HL < min_child_weight gives -inf;
//   * the better direction per bin (NA left on a tie), and the FIRST bin
//     of the highest gain (NaN counts as highest, as in argmax);
// and writes the 12-field record
//   gain, bin, na_left, GL, HL, CL (at the bin, NA excluded),
//   g_na, h_na, c_na, totG, totH, totC.
//
// Three entries, one body (a template on kRows and kMono):
//   * split_records_launch: lambda, alpha, gamma, min_rows and
//     min_child_weight are five scalars of the launch (the TPU kernel's
//     [1, 8] SMEM block);
//   * split_records_rows_launch: the per-row form (per_row=True, the
//     batched grid's per-member parameters repeated over their leaves).
//     The five come from a [nleaf, 8] f32 device array, lanes 0-4 lam,
//     alpha, gamma, min_rows, mcw; row r belongs to leaf r / F.  The TPU
//     kernel broadcasts an [RS, 8] VMEM block of them against its row
//     block; here a block owns one row, so each thread reads its leaf's
//     five values once (one broadcast load each) into registers, and the
//     rest is the scalar body.  The scalar instantiation compiles without
//     those loads: the form costs it nothing.
//   * split_records_mono_launch: the monotone form, the scalar parameters
//     and a per-feature constraint mono [F] f32 (1 increasing, -1
//     decreasing, 0 free).  It replaces no Pallas kernel: the JAX package
//     searches a monotone level in XLA (hist.py::best_splits(mono=),
//     :1331).  Row r's feature is r % F; each direction of a candidate is
//     rejected (-inf) when c > 0 and vl > vr or c < 0 and vl < vr, with
//     vl, vr the children's Newton values -soft(G, alpha) / ((H + lam) +
//     1e-12) in the plain version's operation order
//     (hist.py::newton_value).  Only a constrained row pays for it.
//
// The contract: bitwise equal to the plain torch version
// (hist.py::_split_records_torch) on any H.  Its prefix sums run in
// sequential f32 order (bin 0, + bin 1, ...), and every operation below
// is the same IEEE operation in the same order, written with
// round-to-nearest intrinsics so that no multiply-add is contracted.  A
// tree-shaped scan would reassociate the adds and change last bits, so
// the prefix stays a chain.  (The TPU kernel's matmul prefix sums summed
// in another order; the JAX package's records agree with these bitwise
// when H is integer-valued, where every partial sum is exact.)
//
// What bounds it on this card: latency, not bytes.  The bench's deepest
// level reads 3 x 256 rows x 257 bins x 4 B = 790 KB (0.24 us at
// 3.35 TB/s); a launch is the launch itself, one coalesced load of a row,
// its prefix chains of nbins - 1 dependent adds, and the gains, whose
// IEEE divisions are a long dependent sequence per candidate bin.  A
// first design gave each row to one thread, whose walks over its bins
// loaded three floats a step from rows 1,028 B apart: ~2 x 257 dependent
// global loads, ~0.22 ms a launch on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md); a warp per row, its lanes walking eight candidates each,
// still spent much of a launch in those divisions, one candidate after
// another.  Now:
//   * one 256-thread block per (leaf, feature) row, so every level, the
//     root's 8 rows too, spreads over blocks;
//   * the block stages its row's three planes into shared memory with
//     consecutive threads on consecutive addresses (one coalesced pass);
//   * threads 0, 1, 2 carry the G, H and C chains in parallel, loading
//     sixteen bins at once ahead of their adds and writing the inclusive
//     prefix in place; the regular total is the last prefix, so a
//     separate totals pass is not needed.  The chain is ~nbins f32 adds
//     at their latency, under a microsecond for 256 bins;
//   * thread j then evaluates the candidate bins b = j (mod 256) -- one
//     each at the bench's 256 bins -- from the staged prefixes, keeping
//     its own first best in ascending bin order;
//   * five xor shuffles pick each warp's winner under the sequential
//     scan's total order (a NaN gain above any number, else the larger
//     gain, and on a tie -- +0 and -0, or -inf and -inf included -- the
//     smaller bin), the eight warp winners meet in shared memory, and the
//     thread that owns the winning bin writes the record from it.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // one row a block
constexpr int kThreads = kWarps * 32;
constexpr int kRecFields = 12;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.maximum / torch.maximum: NaN propagates
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float score(float G, float H, float lam,
                                       float alpha) {
  // sign(G) * max(|G| - alpha, 0), squared, over (H + lambda)
  const float sgn = G > 0.0f ? 1.0f : (G < 0.0f ? -1.0f : (isnan(G) ? G : 0.0f));
  float m = __fsub_rn(fabsf(G), alpha);
  m = isnan(m) ? m : (m > 0.0f ? m : 0.0f);
  const float gt = __fmul_rn(sgn, m);
  return __fdiv_rn(__fmul_rn(gt, gt), __fadd_rn(H, lam));
}

__device__ __forceinline__ float gain_dir(float gl, float hl, float cl,
                                          float gr, float hr, float cr,
                                          float parent, float lam,
                                          float alpha, float gamma,
                                          float min_rows, float mcw) {
  const float s = __fsub_rn(__fadd_rn(score(gl, hl, lam, alpha),
                                      score(gr, hr, lam, alpha)), parent);
  const float g = __fsub_rn(__fmul_rn(0.5f, s), gamma);
  const bool ok = (cl >= min_rows) && (cr >= min_rows) && (hl >= mcw) &&
                  (hr >= mcw);
  return ok ? g : -INFINITY;
}

// (ga, ba) comes before (gb, bb) in the order the sequential scan takes:
// a NaN above any number, then the larger gain, then the smaller bin
__device__ __forceinline__ bool before(float ga, int ba, float gb, int bb) {
  const bool na = isnan(ga), nb = isnan(gb);
  if (na != nb) return na;
  if (!na && ga != gb) return ga > gb;
  return ba < bb;
}

// inclusive prefix of x[0 .. n-1] in place, in sequential f32 order (bin
// 0 kept as it is, NaN bits included); x is 16-byte aligned.  Sixteen
// bins are loaded at once ahead of their adds
__device__ __forceinline__ void prefix_chain(float* x, int n) {
  float acc = 0.0f;
  int b = 0;
  for (; b + 16 <= n; b += 16) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = *reinterpret_cast<const float4*>(x + b + 4 * k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = (k == 0 && b == 0) ? v[k].x : __fadd_rn(acc, v[k].x);
      v[k].x = acc;
      acc = __fadd_rn(acc, v[k].y); v[k].y = acc;
      acc = __fadd_rn(acc, v[k].z); v[k].z = acc;
      acc = __fadd_rn(acc, v[k].w); v[k].w = acc;
      *reinterpret_cast<float4*>(x + b + 4 * k) = v[k];
    }
  }
  for (; b < n; ++b) {
    acc = b == 0 ? x[0] : __fadd_rn(acc, x[b]);
    x[b] = acc;
  }
}

// the soft-thresholded Newton value -(sign(g) max(|g| - alpha, 0)) /
// ((h + lam) + 1e-12) of hist.py::newton_value, operation by operation
__device__ __forceinline__ float newton_value(float g, float h, float lam,
                                              float alpha) {
  const float sgn =
      g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : (isnan(g) ? g : 0.0f));
  float m = __fsub_rn(fabsf(g), alpha);
  m = isnan(m) ? m : (m > 0.0f ? m : 0.0f);
  const float num = __fmul_rn(sgn, m);
  return __fdiv_rn(-num, __fadd_rn(__fadd_rn(h, lam), 1e-12f));
}

// whether a candidate breaks the direction c of its feature (a NaN value
// breaks nothing, as the plain version's comparisons are false on it)
__device__ __forceinline__ bool breaks_mono(float c, float gl, float hl,
                                            float gr, float hr, float lam,
                                            float alpha) {
  const float vl = newton_value(gl, hl, lam, alpha);
  const float vr = newton_value(gr, hr, lam, alpha);
  return (c > 0.0f && vl > vr) || (c < 0.0f && vl < vr);
}

// lanes of a per-row parameter record: lam, alpha, gamma, min_rows, mcw
constexpr int kParamLanes = 8;

template <bool kRows, bool kMono>
__global__ void __launch_bounds__(kThreads)
split_records_kernel(const float* __restrict__ hist, int LF, int B, int Bp,
                     float lam, float alpha, float gamma, float min_rows,
                     float mcw, int F, const float* __restrict__ params,
                     const float* __restrict__ mono,
                     float* __restrict__ rec) {
  extern __shared__ __align__(16) float smem[];  // [3][Bp], warp winners
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  if (kRows) {
    const float* p = params + (size_t)(row / F) * kParamLanes;
    lam = __ldg(p);
    alpha = __ldg(p + 1);
    gamma = __ldg(p + 2);
    min_rows = __ldg(p + 3);
    mcw = __ldg(p + 4);
  }
  // the row's constraint (0 when unconstrained: nothing is rejected)
  const float cons = kMono ? __ldg(mono + row % F) : 0.0f;
  const int nbins = B - 1;
  const size_t plane = (size_t)LF * B;
  float* G = smem;
  float* Hh = G + Bp;
  float* C = Hh + Bp;
  float* win_g = C + Bp;                            // [kWarps]
  int* win_b = reinterpret_cast<int*>(win_g + kWarps);

  const float* src = hist + (size_t)row * B;
  for (int b = tid; b < B; b += kThreads) {
    G[b] = __ldg(src + b);
    Hh[b] = __ldg(src + plane + b);
    C[b] = __ldg(src + 2 * plane + b);
  }
  __syncthreads();
  if (tid < 3) prefix_chain(G + tid * Bp, nbins);
  __syncthreads();

  const float gna = G[nbins], hna = Hh[nbins], cna = C[nbins];
  const float totG = __fadd_rn(G[nbins - 1], gna);
  const float totH = __fadd_rn(Hh[nbins - 1], hna);
  const float totC = __fadd_rn(C[nbins - 1], cna);
  const float parent = score(totG, totH, lam, alpha);

  // this thread's first best over its bins; a thread without a candidate
  // keeps (-inf, INT_MAX), which loses every tie on the bin
  float best = -INFINITY, bnal = 0.0f;
  int bidx = INT_MAX;
  for (int b = tid; b <= nbins - 2; b += kThreads) {
    const float gl = G[b], hl = Hh[b], cl = C[b];
    const float gr = __fsub_rn(__fsub_rn(totG, gl), gna);
    const float hr = __fsub_rn(__fsub_rn(totH, hl), hna);
    const float cr = __fsub_rn(__fsub_rn(totC, cl), cna);
    const float glL = __fadd_rn(gl, gna), hlL = __fadd_rn(hl, hna);
    const float grR = __fadd_rn(gr, gna), hrR = __fadd_rn(hr, hna);
    float gL = gain_dir(glL, hlL, __fadd_rn(cl, cna), gr, hr, cr, parent,
                        lam, alpha, gamma, min_rows, mcw);
    float gR = gain_dir(gl, hl, cl, grR, hrR, __fadd_rn(cr, cna), parent,
                        lam, alpha, gamma, min_rows, mcw);
    if (kMono && cons != 0.0f) {
      if (breaks_mono(cons, glL, hlL, gr, hr, lam, alpha)) gL = -INFINITY;
      if (breaks_mono(cons, gl, hl, grR, hrR, lam, alpha)) gR = -INFINITY;
    }
    const float gain = nan_max(gL, gR);
    const bool take = bidx == INT_MAX || (isnan(gain) && !isnan(best)) ||
                      gain > best;
    if (take) {
      best = gain;
      bidx = b;
      bnal = (gL >= gR) ? 1.0f : 0.0f;
    }
  }
  // the winner of the warp, then of the block: every thread ends with
  // the same (gain, bin)
  float g = best;
  int bin = bidx;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, g, off);
    const int ob = __shfl_xor_sync(0xffffffffu, bin, off);
    if (before(og, ob, g, bin)) {
      g = og;
      bin = ob;
    }
  }
  if (lane == 0) {
    win_g[warp] = g;
    win_b[warp] = bin;
  }
  __syncthreads();
  g = win_g[0];
  bin = win_b[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (before(win_g[w], win_b[w], g, bin)) {
      g = win_g[w];
      bin = win_b[w];
    }
  }
  // the winning bin is its thread's own first best (the same order)
  if (bin == bidx) {
    float* o = rec + (size_t)row * kRecFields;
    o[0] = best; o[1] = (float)bidx; o[2] = bnal;
    o[3] = G[bidx]; o[4] = Hh[bidx]; o[5] = C[bidx];
    o[6] = gna; o[7] = hna; o[8] = cna;
    o[9] = totG; o[10] = totH; o[11] = totC;
  }
}

template <bool kRows, bool kMono>
int launch(const float* hist, int LF, int B, float lam, float alpha,
           float gamma, float min_rows, float mcw, int F,
           const float* params, const float* mono, float* rec,
           cudaStream_t stream) {
  if (LF <= 0) return (int)cudaSuccess;
  if (B < 3) return (int)cudaErrorInvalidValue;
  const int Bp = (B + 3) & ~3;         // 16-byte aligned planes
  const size_t smem = (size_t)3 * Bp * sizeof(float) + 2 * kWarps * 4;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_records_kernel<kRows, kMono>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  split_records_kernel<kRows, kMono><<<LF, kThreads, smem, stream>>>(
      hist, LF, B, Bp, lam, alpha, gamma, min_rows, mcw, F, params, mono,
      rec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  hist:
// [3, LF, B] f32 contiguous; rec: [LF, 12] f32.  Device pointers.
extern "C" int split_records_launch(const float* hist, int LF, int B,
                                    float lam, float alpha, float gamma,
                                    float min_rows, float mcw, float* rec,
                                    cudaStream_t stream) {
  return launch<false, false>(hist, LF, B, lam, alpha, gamma, min_rows, mcw,
                              1, nullptr, nullptr, rec, stream);
}

// The per-row form: the same records with each row's five parameters
// read from params [LF / F, 8] f32 (lanes 0-4 lam, alpha, gamma,
// min_rows, mcw of leaf r / F).  Device pointers; LF a multiple of F.
extern "C" int split_records_rows_launch(const float* hist, int LF, int B,
                                         int F, const float* params,
                                         float* rec, cudaStream_t stream) {
  if (F <= 0 || LF % F != 0) return (int)cudaErrorInvalidValue;
  return launch<true, false>(hist, LF, B, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, F,
                             params, nullptr, rec, stream);
}

// The monotone form: the scalar records with each candidate direction
// rejected where it breaks its feature's constraint mono[r % F] (f32, [F]:
// 1, -1 or 0).  Device pointers; LF a multiple of F.
extern "C" int split_records_mono_launch(const float* hist, int LF, int B,
                                         float lam, float alpha, float gamma,
                                         float min_rows, float mcw, int F,
                                         const float* mono, float* rec,
                                         cudaStream_t stream) {
  if (F <= 0 || LF % F != 0) return (int)cudaErrorInvalidValue;
  return launch<false, true>(hist, LF, B, lam, alpha, gamma, min_rows, mcw,
                             F, nullptr, mono, rec, stream);
}
