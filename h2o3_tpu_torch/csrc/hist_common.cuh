// The privatised histogram tile that csrc/hist.cu and csrc/fine_hist.cu
// share, for Hopper (sm_90a): integer fixed-point sums.
//
// A block owns one TILE of the output (a contiguous range of the packed
// slot axis q x a leaf range, cut by models/tree/hist.py::hist_tiles, or
// ::slot_tiles at the node-sparse slot geometry) and a range of rows
// [r0, r1) that its kernel hands it: a fixed slice of the row axis, or on
// the slot geometry a chunk of the tile's own row window (hist.cu).  It
// zeroes the tile in shared memory, adds each row's stats into the slots
// its `Slots` policy names, and adds the tile's non-zero entries to the
// global output at the end.  The two
// kernels differ only in their slot function: hist.cu lands a row once
// per feature, at code_off[f] + code; fine_hist.cu lands it once per
// chosen super-bin k of its leaf and feature that holds its code, at
// f*K*W + k*W + code mod W.
//
// The arithmetic.  Stat plane p (g, h, w) has a power-of-two scale 2^s_p,
// chosen by the caller (models/tree/hist.py::stat_scale) so that
// sum_r |x_p,r| * 2^s_p < 2^62: no slot, partial or total can leave
// int64.  Each row's stat is quantised once, round-half-even(x * 2^s_p)
// through __double2ll_rn of the f64 product (exact: a power of two), and
// every sum after that is an int64 sum: exact, so the same in any order.
// The histogram is therefore bitwise the same run to run and bitwise its
// plain torch version (one int64 index_add_ of the same quantised
// values).  The |g| plane of planes = 4 adds |q_g| on g's scale.  The
// caller dequantises the int64 output once (-> f64 -> x 2^-s_p -> f32).
//
// What the adds compile to (cuobjdump -sass of nvcc 12.9's sm_90a code;
// chip_smoke.py prints the counts for the built kernels): a shared f32
// atomicAdd, which the earlier f32 tile used, is a compare-and-swap loop
// (ATOMS.CAST.SPIN with a branch back: one more trip per lane that
// collides on the word), and so is a shared 64-bit integer atomicAdd
// (ATOMS.CAST.SPIN.64); a 32-bit integer one is a single ATOMS.ADD, and a
// global 64-bit one a single REDG.E.ADD.64.  So a shared 64-bit add here
// is two 32-bit ATOMS.ADD, the low word, then the high word plus the
// carry out of the low one (gpu_hist's AtomicAdd64As32): the words may
// disagree while adds are in flight, but the final 64-bit value is the
// exact sum mod 2^64.  A word that would add 0 is skipped, so a w of 1.0
// (2^s_w, low word 0) costs one add.  The flush is native 64-bit global
// adds into an int64 buffer.
//
// A small tile keeps `copies` (a power of two, up to 32) side by side:
// lane l of each warp adds into copy l % copies, and the flush sums them.
// The lanes of one add that land on a hot word of a low-cardinality
// feature (every row of a leaf, on the coarse pass) then collide at most
// 32 / copies ways.  Copies striped by warp instead left all 32 lanes on
// the word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hist_common {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kTileInts = 8;   // fa, fb, qa, qn, l0, ln, use_smem, copies

struct Tile {
  int fa, fb, qa, qn, l0, ln, use_smem, copies;
  __device__ explicit Tile(const int32_t* t)
      : fa(t[0]), fb(t[1]), qa(t[2]), qn(t[3]), l0(t[4]), ln(t[5]),
        use_smem(t[6]), copies(t[7]) {}
};

// *p += v mod 2^64, in shared memory, as two native 32-bit adds
__device__ __forceinline__ void shared_add(u64* p, long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(p);     // little-endian: lo, hi
  const unsigned lo = (unsigned)v;
  unsigned hi = (unsigned)((u64)v >> 32);
  if (lo != 0u) hi += atomicAdd(w, lo) > 0xffffffffu - lo ? 1u : 0u;
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// The tile's body.  `sums` is the block's shared memory for `copies`
// tiles of [qn, ln, planes] u64 (each one u64 longer when copies > 1);
// `qscale` the planes' scales 2^s_p (f64, on the device); rows [r0, r1)
// the block's; `out` the int64 output, written through the strides (ss,
// sl, sq) of plane, leaf and packed slot.  slots.each(r, lf, emit) calls
// emit(q) once for each packed slot q row r lands on.
template <class Slots>
__device__ __forceinline__ void tile_body(
    const Slots& slots, const Tile& t, u64* sums,
    const int32_t* __restrict__ leaf, const float* __restrict__ stats,
    long long stat_stride, const double* __restrict__ qscale, int planes,
    int r0, int r1, u64* __restrict__ out, long long ss, long long sl,
    long long sq) {
  const int size = t.qn * t.ln * planes;
  // lane l of every warp adds into copy l % copies; an odd stride puts
  // one slot's copies on distinct banks
  const int stride = t.copies > 1 ? size + 1 : size;
  u64* mine = sums + (threadIdx.x % t.copies) * stride;
  const double sg = __ldg(qscale), sh = __ldg(qscale + 1),
               sw = __ldg(qscale + 2);

  if (t.use_smem)
    for (int i = threadIdx.x; i < t.copies * stride; i += blockDim.x)
      sums[i] = 0ull;
  __syncthreads();          // also orders what the caller staged before
  // Every row of [r0, r1) is read; a row whose leaf falls outside the
  // tile's range adds nothing.  Over a fixed slice that drops the rows of
  // the other tiles' leaves; inside a row window every row belongs to
  // the tile, and the check only guards it.
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int lf = __ldg(leaf + r) - t.l0;
    if ((unsigned)lf >= (unsigned)t.ln) continue;
    long long v[4];
    v[0] = __double2ll_rn((double)__ldg(stats + r) * sg);
    v[1] = __double2ll_rn((double)__ldg(stats + stat_stride + r) * sh);
    v[2] = __double2ll_rn((double)__ldg(stats + 2 * stat_stride + r) * sw);
    v[3] = v[0] < 0 ? -v[0] : v[0];
    slots.each(r, lf, [&](int q) {
      if (t.use_smem) {
        u64* p = mine + ((q - t.qa) * t.ln + lf) * planes;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (s < planes) shared_add(p + s, v[s]);
      } else {
        u64* o = out + (long long)q * sq + (long long)(lf + t.l0) * sl;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (s < planes && v[s] != 0) atomicAdd(o + s * ss, (u64)v[s]);
      }
    });
  }
  if (!t.use_smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    u64 v = 0ull;
    for (int c = 0; c < t.copies; ++c) v += sums[c * stride + i];
    if (v == 0ull) continue;          // adding 0 is a no-op
    const int s = i % planes;
    const int rest = i / planes;
    const int l = rest % t.ln + t.l0;
    const int q = rest / t.ln + t.qa;
    atomicAdd(out + (long long)q * sq + (long long)l * sl + s * ss, v);
  }
}

}  // namespace hist_common
