// In-block building blocks for Hopper (sm_90a): the counterparts of the
// helpers of csnappy_tpu/ops/kernel_lib.py.
//
// The JAX helpers run inside Pallas TPU kernels on (R, 128) int32 tiles.
// They gather and scatter through one-hot matrix products, shift through
// rolls or permutation products, and split values into 8-bit (or 7-bit)
// limbs because the TPU's matrix unit rounds its inputs to bf16.  Hopper
// loads and stores shared memory at any address, so here:
//   * a shift is index arithmetic: y[f] = x[f + off] inside a segment of
//     `span` elements (128 for a lane shift, the whole tile for a stream or
//     row shift), `fill` outside it, each element read where it lies;
//   * a scan is an inclusive row-major scan: one warp a row in registers
//     (warp shuffles along the row when the operation is associative and no
//     mask can bite, else the JAX helper's own 7 doubling lane rounds, with
//     the mask where the limbs put it), then the JAX helper's row rounds
//     over the row totals (kernel_lib.cu);
//   * a gather is a load by address, by flat index or by in-row index, from
//     a table kept in shared memory as uint8, uint16 or int32;
//   * a scatter is a shared atomicAdd, of the whole value or of each 8-bit
//     limb into its own histogram (the limb sums are OR-ed at the end).
// What the limbs do to a value is one AND mask here: the low 8 * limbs bits
// (7 * limbs for the 7-bit limbs of scatter_rows_multi).  The answers are
// the JAX helpers' answers, outside their contracts too (an index out of
// range, a value wider than its bits, a sum that passes the mask, duplicate
// scatter positions).
//
// shift and gather answer for one element, scan_row is called by a whole
// warp, scatter_finish by all threads of a block (after a barrier).  Sums
// wrap at 32 bits (uint32 arithmetic, cast back), as XLA's int32
// arithmetic does.

#pragma once

#include <climits>
#include <cstdint>

namespace kernel_lib {

constexpr int L = 128;                           // lanes of a row
constexpr int32_t kNeg = INT_MIN;                // kernel_lib.NEG
constexpr int32_t kSat = 1 << 23;                // kernel_lib.SAT

// ------------------------------------------------------------------ shift

// y[f] = x[f + off] & vmask where f + off lies in f's segment of `span`
// elements (span divides n), else `fill`: one output element, x read where
// it lies.
__device__ __forceinline__ int32_t shift(const int32_t* __restrict__ x, int f, int span, int off,
                                         int32_t fill, uint32_t vmask) {
  const int64_t src = static_cast<int64_t>(f) + off, seg = f - f % span;
  return src >= seg && src < seg + span
             ? static_cast<int32_t>(static_cast<uint32_t>(x[src]) & vmask)
             : fill;
}

// ------------------------------------------------------------------- scan

enum ScanOp { kMax = 0, kMin = 1, kAdd = 2, kAddSat = 3 };

__device__ __forceinline__ int32_t combine(int op, int32_t a, int32_t b) {
  switch (op) {
    case kMax: return max(a, b);
    case kMin: return min(a, b);
    case kAdd: return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
    default:   return min(static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b)),
                          kSat);
  }
}

struct ScanArgs {
  int rows;
  int op;               // ScanOp
  bool rounds;          // follow the JAX lane rounds (a mask or a non-identity fill can bite)
  uint32_t in_mask;     // applied to x first (scan2d_tril's limbs)
  uint32_t lane_mask;   // applied to each lane round's shifted operand (scan2d_mm's limbs)
  uint32_t tot_mask;    // applied to the row totals (lane_shift_up(s, 127, bits))
  int32_t fill;         // the shifted-in value of max / min lane rounds and of every row round
};

// The inclusive scan of one 128-lane row, by one warp in registers: lane
// `lane` holds v[0..3] = lanes 4 * lane .. 4 * lane + 3 of the row, already
// & in_mask.  Without rounds (an associative op no mask can bite): a
// sequential scan of four, a shuffle scan of the 32 partial totals, the
// exclusive prefix.  With rounds: kernel_lib.scan2d_mm's seven doubling
// lane rounds, s = op(s, shifted), where the shifted operand is
// (s[l - k] & lane_mask) for l >= k, and for l < k the fill (max, min) or 0
// (add, addsat: a zero-fill shift); each round reads the round before's
// values, as the JAX rounds do.  The row total is v[3] of lane 31.
__device__ __forceinline__ void scan_row(int32_t (&v)[4], int lane, const ScanArgs& a) {
  if (!a.rounds) {
#pragma unroll
    for (int j = 1; j < 4; ++j) v[j] = combine(a.op, v[j - 1], v[j]);
    int32_t inc = v[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t up = __shfl_up_sync(0xFFFFFFFFu, inc, o);
      if (lane >= o) inc = combine(a.op, up, inc);
    }
    const int32_t before = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
    if (lane > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = combine(a.op, before, v[j]);
    }
    return;
  }
  const int32_t low = a.op == kMax || a.op == kMin ? a.fill : 0;
#pragma unroll
  for (int round = 0; round < 7; ++round) {     // a constant trip count: v stays in registers
    const int k = 1 << round;
    int32_t sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // lane l = 4 * lane + j reads l - k: word (l - k) & 3 (the same for
      // every lane) of lane (l - k) >> 2
      const int src = 4 * lane + j - k;
      const int32_t got = __shfl_sync(0xFFFFFFFFu, v[(j - k) & 3], src >= 0 ? src >> 2 : 0);
      sh[j] = src >= 0 ? static_cast<int32_t>(static_cast<uint32_t>(got) & a.lane_mask) : low;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = combine(a.op, v[j], sh[j]);
  }
}

// ----------------------------------------------------------------- gather

enum GatherMode {
  kFlatZero = 0,      // gather_flat: idx outside [0, n) gives 0
  kFlatClip = 1,      // gather_rows_multi: idx clipped to [0, n - 1]
  kRowZero = 2,       // local_gather_rows: lane outside [0, 128) gives 0
  kRowTake = 3,       // lane_gather (take_along_axis): lane -128..-1 counts from
                      // the end, any other lane outside [0, 128) gives INT32_MIN
};

// The value at index `ix` of the element in row `row`: a table of n
// entries (global or shared memory), & vmask.
template <typename T>
__device__ __forceinline__ int32_t gather(const T* tab, int n, int mode, uint32_t vmask,
                                          int32_t ix, int row) {
  switch (mode) {
    case kFlatZero:
      if (ix < 0 || ix >= n) return 0;
      break;
    case kFlatClip:
      ix = min(max(ix, 0), n - 1);
      break;
    case kRowZero:
      if (ix < 0 || ix >= L) return 0;
      ix += row * L;
      break;
    default:
      if (ix < 0) ix += L;
      if (ix < 0 || ix >= L) return kNeg;
      ix += row * L;
  }
  return static_cast<int32_t>(static_cast<uint32_t>(tab[ix]) & vmask);
}

// ---------------------------------------------------------------- scatter

// H[pos] += val for pos in [0, n); elsewhere nowhere.  limbs == 0: the
// whole value into H (a sum); else each 8-bit limb k into H[k * n + pos],
// combined by scatter_finish.
__device__ __forceinline__ void scatter(int32_t* H, int n, int limbs, int32_t pos, uint32_t val) {
  if (pos < 0 || pos >= n) return;
  if (limbs == 0) {
    atomicAdd(&H[pos], static_cast<int32_t>(val));
    return;
  }
  for (int k = 0; k < limbs; ++k)
    atomicAdd(&H[k * n + pos], static_cast<int32_t>((val >> (8 * k)) & 0xFFu));
}

// out[p] = H[p] (limbs == 0), or the OR over limbs k of H[k * n + p] << 8k
// (scatter_sum_tile: each limb's sum, carries into the next limb's bits
// included).  Call after a barrier that follows the last scatter.
__device__ __forceinline__ void scatter_finish(const int32_t* H, int n, int limbs, int32_t* out) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    uint32_t v = static_cast<uint32_t>(H[p]);
    for (int k = 1; k < limbs; ++k) v |= static_cast<uint32_t>(H[k * n + p]) << (8 * k);
    out[p] = static_cast<int32_t>(v);
  }
}

// Floor modulus (jnp's %: the sign of the divisor), for m > 0.
__device__ __forceinline__ int32_t floor_mod(int32_t v, int32_t m) {
  const int32_t r = v % m;
  return r < 0 ? r + m : r;
}

}  // namespace kernel_lib
