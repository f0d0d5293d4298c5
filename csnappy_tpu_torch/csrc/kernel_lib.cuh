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
//     row shift), `fill` outside it;
//   * a scan is an inclusive row-major scan: warp shuffles along a row and
//     one pass over the row totals when the operation is associative and no
//     mask can bite, else the JAX helper's own rounds (7 doubling lane
//     rounds, then log2(R) row rounds), with the mask where the limbs put it;
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
// Every function is called by all threads of one block (blockDim.x a
// multiple of 32) and synchronises where it says so.  Sums wrap at 32 bits
// (uint32 arithmetic, cast back), as XLA's int32 arithmetic does.

#pragma once

#include <climits>
#include <cstdint>

namespace kernel_lib {

constexpr int L = 128;                           // lanes of a row
constexpr int32_t kNeg = INT_MIN;                // kernel_lib.NEG
constexpr int32_t kSat = 1 << 23;                // kernel_lib.SAT

// ------------------------------------------------------------------ shift

// y[f] = x[f + off] & vmask where f + off lies in f's segment of `span`
// elements (span divides n), else `fill`.  x is a tile in shared memory; y
// may be shared or global memory, but not x.
__device__ __forceinline__ void shift(const int32_t* x, int32_t* y, int n, int span, int off,
                                      int32_t fill, uint32_t vmask) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int src = f + off, seg = f - f % span;
    y[f] = src >= seg && src < seg + span
               ? static_cast<int32_t>(static_cast<uint32_t>(x[src]) & vmask)
               : fill;
  }
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
  int row_rounds;       // row-doubling rounds (round r runs while 2^r < rows)
};

// The inclusive row-major scan of the (rows, 128) tile `s` in shared
// memory, in place.  `buf` is scratch of rows * 128 words (rounds mode
// only), `tot` and `tbuf` scratch of `rows` words each.  Afterwards `s`
// holds the in-row scan, `tot` the row totals after the row rounds (t of
// fill_max_rows) and `out` (shared or global; may be s) the result.
// Starts and ends with a barrier.
__device__ void scan(int32_t* s, int32_t* buf, int32_t* tot, int32_t* tbuf, int32_t* out,
                     const ScanArgs& a) {
  const int n = a.rows * L, t = threadIdx.x;
  for (int f = t; f < n; f += blockDim.x)
    s[f] = static_cast<int32_t>(static_cast<uint32_t>(s[f]) & a.in_mask);
  __syncthreads();
  if (!a.rounds) {
    // one warp a row, four consecutive lanes a thread: a sequential scan of
    // four, a shuffle scan of the 32 partial totals, the exclusive prefix
    const int lane = t & 31, nwarps = blockDim.x >> 5;
    for (int r = t >> 5; r < a.rows; r += nwarps) {
      int32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s[r * L + lane * 4 + j];
#pragma unroll
      for (int j = 1; j < 4; ++j) v[j] = combine(a.op, v[j - 1], v[j]);
      int32_t inc = v[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t up = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (lane >= o) inc = combine(a.op, up, inc);
      }
      const int32_t before = __shfl_up_sync(0xFFFFFFFFu, inc, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[r * L + lane * 4 + j] = lane == 0 ? v[j] : combine(a.op, before, v[j]);
    }
  } else {
    // kernel_lib.scan2d_mm's lane rounds: s = op(s, shifted), where the
    // shifted operand is (s[l - k] & lane_mask) for l >= k, and for l < k
    // the fill (max, min) or 0 (add, addsat: a zero-fill shift)
    const int32_t low = a.op == kMax || a.op == kMin ? a.fill : 0;
    int32_t* cur = s;
    int32_t* nxt = buf;
    for (int k = 1; k < L; k <<= 1) {
      for (int f = t; f < n; f += blockDim.x) {
        const int32_t sh = (f & (L - 1)) >= k
            ? static_cast<int32_t>(static_cast<uint32_t>(cur[f - k]) & a.lane_mask) : low;
        nxt[f] = combine(a.op, cur[f], sh);
      }
      __syncthreads();
      int32_t* w = cur;
      cur = nxt;
      nxt = w;
    }
    if (cur != s)                                // seven rounds: the result is in buf
      for (int f = t; f < n; f += blockDim.x) s[f] = cur[f];
  }
  __syncthreads();
  for (int r = t; r < a.rows; r += blockDim.x)
    tot[r] = static_cast<int32_t>(static_cast<uint32_t>(s[r * L + L - 1]) & a.tot_mask);
  __syncthreads();
  for (int rd = 0; rd < a.row_rounds && (1 << rd) < a.rows; ++rd) {
    const int k = 1 << rd;
    for (int r = t; r < a.rows; r += blockDim.x)
      tbuf[r] = combine(a.op, tot[r], r >= k ? tot[r - k] : a.fill);
    __syncthreads();
    for (int r = t; r < a.rows; r += blockDim.x) tot[r] = tbuf[r];
    __syncthreads();
  }
  for (int f = t; f < n; f += blockDim.x) {
    const int r = f / L;
    out[f] = combine(a.op, s[f], r >= 1 ? tot[r - 1] : a.fill);
  }
  __syncthreads();
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
// entries in shared memory (uint8, uint16 or int32), & vmask.
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
