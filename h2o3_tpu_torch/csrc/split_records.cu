// Split-search winner records of tree training for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// h2o3_tpu/models/tree/hist.py::_make_pallas_split_records (:1526, the
// scalar-parameter form) and computes what it computes: for every
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
// Design.  One thread per (leaf, feature) row walks its bins in order:
// a first pass sums the regular bins for the totals, a second one carries
// the prefix sums and evaluates both gains per bin.  The sequential f32
// order is what the plain torch version (hist.py::_split_records_torch)
// takes, and every operation below is the same IEEE operation in the same
// order, written with round-to-nearest intrinsics so that no multiply-add
// is contracted: the kernel is bitwise equal to its plain version on any
// H.  (The TPU kernel's matmul prefix sums summed in another order; the
// JAX package's records agree with these bitwise when H is integer-valued,
// where every partial sum is exact.)
//
// What bounds it on this card: memory latency.  At the bench's deepest
// level it reads only 3 x 256 rows x 257 bins x 4 B = 790 KB, but each
// thread's walk is a chain of loop steps whose three loads land on a
// different cache line for every lane of the warp, so a launch takes
// ~0.2 ms where the bytes allow ~0.0002 ms.  A warp per row, loading the
// row coalesced into shared memory, is the known cure (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRecFields = 12;

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

__global__ void __launch_bounds__(kThreads)
split_records_kernel(const float* __restrict__ hist, int LF, int B,
                     float lam, float alpha, float gamma, float min_rows,
                     float mcw, float* __restrict__ rec) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= LF) return;
  const int nbins = B - 1;
  const size_t plane = (size_t)LF * B;
  const float* G = hist + (size_t)row * B;
  const float* Hh = G + plane;
  const float* C = G + 2 * plane;
  const float gna = G[nbins], hna = Hh[nbins], cna = C[nbins];

  float cg = G[0], ch = Hh[0], cc = C[0];
  for (int b = 1; b < nbins; ++b) {
    cg = __fadd_rn(cg, G[b]);
    ch = __fadd_rn(ch, Hh[b]);
    cc = __fadd_rn(cc, C[b]);
  }
  const float totG = __fadd_rn(cg, gna);
  const float totH = __fadd_rn(ch, hna);
  const float totC = __fadd_rn(cc, cna);
  const float parent = score(totG, totH, lam, alpha);

  float best = 0.0f, bGL = 0.0f, bHL = 0.0f, bCL = 0.0f, bnal = 0.0f;
  int bidx = 0;
  float gl = 0.0f, hl = 0.0f, cl = 0.0f;
  for (int b = 0; b <= nbins - 2; ++b) {
    if (b == 0) {
      gl = G[0]; hl = Hh[0]; cl = C[0];
    } else {
      gl = __fadd_rn(gl, G[b]);
      hl = __fadd_rn(hl, Hh[b]);
      cl = __fadd_rn(cl, C[b]);
    }
    const float gr = __fsub_rn(__fsub_rn(totG, gl), gna);
    const float hr = __fsub_rn(__fsub_rn(totH, hl), hna);
    const float cr = __fsub_rn(__fsub_rn(totC, cl), cna);
    const float gL = gain_dir(__fadd_rn(gl, gna), __fadd_rn(hl, hna),
                              __fadd_rn(cl, cna), gr, hr, cr, parent, lam,
                              alpha, gamma, min_rows, mcw);
    const float gR = gain_dir(gl, hl, cl, __fadd_rn(gr, gna),
                              __fadd_rn(hr, hna), __fadd_rn(cr, cna),
                              parent, lam, alpha, gamma, min_rows, mcw);
    const float gain = nan_max(gL, gR);
    const bool take = b == 0 || (isnan(gain) && !isnan(best)) ||
                      gain > best;
    if (take) {
      best = gain;
      bidx = b;
      bnal = (gL >= gR) ? 1.0f : 0.0f;
      bGL = gl; bHL = hl; bCL = cl;
    }
  }
  float* o = rec + (size_t)row * kRecFields;
  o[0] = best; o[1] = (float)bidx; o[2] = bnal;
  o[3] = bGL; o[4] = bHL; o[5] = bCL;
  o[6] = gna; o[7] = hna; o[8] = cna;
  o[9] = totG; o[10] = totH; o[11] = totC;
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 = launched).  hist:
// [3, LF, B] f32 contiguous; rec: [LF, 12] f32.  Device pointers.
extern "C" int split_records_launch(const float* hist, int LF, int B,
                                    float lam, float alpha, float gamma,
                                    float min_rows, float mcw, float* rec,
                                    cudaStream_t stream) {
  if (LF <= 0) return (int)cudaSuccess;
  if (B < 3) return (int)cudaErrorInvalidValue;
  const int grid = (LF + kThreads - 1) / kThreads;
  split_records_kernel<<<grid, kThreads, 0, stream>>>(
      hist, LF, B, lam, alpha, gamma, min_rows, mcw, rec);
  return (int)cudaGetLastError();
}
