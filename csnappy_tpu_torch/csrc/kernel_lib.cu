// The kernel_lib harness for Hopper (sm_90a): each helper of
// csnappy_tpu/ops/kernel_lib.py on one tile, at any tile while int32
// indexing holds.
//
// Replaces the Pallas harness of tests/test_kernel_lib.py: `_run` (the
// pl.pallas_call at :16, one helper on (1..24, 128) int32 VMEM tiles a
// test) and the two-output call of test_gather_rows_multi (:137).  Each
// entry kernel_lib_<kind>_launch launches the kernels of one of the four
// device functions of kernel_lib.cuh (shift, scan, gather, scatter); the
// 19 helpers share these four entries.  The parameters that make a helper
// of a device function (the segment and offset of a shift, the masks, fill
// and rounds of a scan, the gather mode, the limb count of a scatter, a
// scatter block's slice) are computed by csnappy_tpu_torch/ops/kernel_lib.py.
//
// What bounds them on this card: the launch, at the JAX tests' tiles (a
// few thousand operations) and at the JAX fused kernels' too (tiles of
// 256-2,048 rows, csnappy_tpu/ops/decode_fused.py:200-272, :424, :494,
// decode_stream.py:116, :282, :330, encode_fused.py:394: under a
// microsecond of bytes); the bytes only on tiles far past those.  No tile
// may be refused for want of one block's shared memory.  So:
//   * the shift is one grid kernel that reads x in place: y[f] = x[f + off]
//     is a gather at a fixed offset and needs no staging (four elements a
//     thread, coalesced);
//   * the scan is two grid kernels, one warp a row in registers.  The lane
//     rounds never cross a row, only the R row totals do.  scan_totals
//     scans each row and writes its masked total; scan_finish scans each
//     row again (cheaper than writing and reading s back), runs the JAX
//     row rounds over the window of totals its rows depend on (rows
//     r0 - 2^rounds .. r1 - 1, in shared memory, every block for itself)
//     and combines.  Where that window passes kWindowMax rows (all rounds
//     on more than 6,144 rows), the rounds run first as grid passes over
//     the totals, one kernel a round, and scan_finish takes the last
//     pass's totals.  Never an associative scan of the totals: addsat is
//     not associative once operands are negative, and fill_max_rows runs 5
//     rounds, a 32-row window max;
//   * the gather stages nothing: its tables (at most 1.7 MB at the JAX
//     fused kernels' shapes, csnappy_tpu/ops/decode_fused.py:387,
//     decode_stream.py:255) sit in the 50 MB L2 and each entry it needs is
//     read about once, so a grid of threads, one an index of one table,
//     reads them in place;
//   * the scatter's grid is (slices, tables): the JAX fused kernels scatter
//     into 2-3 histograms of 32,768-38,912 entries (decode_fused.py:470,
//     decode_stream.py:315, encode_fused.py:375), more than one block
//     holds.  A block owns one slice of one table's output positions, reads
//     every position (a few thousand words, from L2), adds those in its
//     slice into shared memory and writes its slice once.  No global
//     atomic, no memset launch, one launch a call.
//
// The launch path is thin: no kernel asks for more than the default 48 KB
// of dynamic shared memory, so no cudaFuncSetAttribute is needed.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_lib.cuh"

namespace {

using namespace kernel_lib;

constexpr int kBlock = 1024;
constexpr int kGatherBlock = 128;              // a gather's threads a block: one an index
constexpr int kMaxTables = 8;                  // decode_fused.py:387 gathers from eight
constexpr int kSmemDefault = 48 * 1024;        // dynamic shared memory a launch takes unasked
constexpr int kShiftBlock = 256;               // a shift's threads a block
constexpr int kShiftPer = 4;                   // elements a shift thread writes
constexpr int kScanBlock = 256;                // a scan's threads a block: one warp a row
constexpr int kScanRows = kScanBlock / 32;     // rows a scan block owns
constexpr int kRoundBlock = 256;               // threads a block of a row-round pass
constexpr int kWindowMax = kSmemDefault / 8;   // totals scan_finish holds (two arrays of them)

__global__ void __launch_bounds__(kShiftBlock)
shift_kernel(const int32_t* __restrict__ x, int n, int span, int off, int32_t fill,
             uint32_t vmask, int32_t* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kShiftBlock * kShiftPer) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kShiftPer; ++j) {
    const int64_t f = base + j * kShiftBlock;
    if (f < n) out[f] = shift(x, static_cast<int>(f), span, off, fill, vmask);
  }
}

// Row r of x, & in_mask, scanned in place by the calling warp (scan_row):
// lane `lane` gets lanes 4 * lane .. 4 * lane + 3.
__device__ __forceinline__ void scan_of_row(const int32_t* __restrict__ x, int r, int lane,
                                            const ScanArgs& a, int32_t (&v)[4]) {
  const int32_t* xr = x + static_cast<size_t>(r) * L + 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = static_cast<int32_t>(static_cast<uint32_t>(__ldg(xr + j)) & a.in_mask);
  scan_row(v, lane, a);
}

// Phase 1: tot[r] = (the in-row scan's last lane) & tot_mask, a warp a row.
__global__ void __launch_bounds__(kScanBlock)
scan_totals(const int32_t* __restrict__ x, ScanArgs a, int32_t* __restrict__ tot) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * kScanRows + (threadIdx.x >> 5);
  if (r >= a.rows) return;
  int32_t v[4];
  scan_of_row(x, r, lane, a, v);
  if (lane == 31) tot[r] = static_cast<int32_t>(static_cast<uint32_t>(v[3]) & a.tot_mask);
}

// One row round as a grid pass (rounds past kWindowMax rows):
// u[r] = op(t[r], r >= k ? t[r - k] : fill).
__global__ void __launch_bounds__(kRoundBlock)
scan_round(const int32_t* __restrict__ t, int32_t* __restrict__ u, int rows, int k, int op,
           int32_t fill) {
  const int r = blockIdx.x * kRoundBlock + threadIdx.x;
  if (r < rows) u[r] = combine(op, t[r], r >= k ? t[r - k] : fill);
}

// Phase 2, block b owning rows [r0, r1): the totals of rows lo .. r1 - 1
// (lo = r0 - 2^rounds, at least 0) into shared memory, `rounds` row rounds
// over them (row lo + i reading row lo + i - k; above row 0 the fill, below
// the window a value no needed total depends on: a row's total after round
// j depends only on the 2^j rows up to it), then each row scanned again and
// combined with the total of the row before; s_out and t_out (each may be
// null) get the in-row scan and the row's total broadcast over the row.
__global__ void __launch_bounds__(kScanBlock)
scan_finish(const int32_t* __restrict__ x, ScanArgs a, const int32_t* __restrict__ tot,
            int rounds, int32_t* __restrict__ out, int32_t* __restrict__ s_out,
            int32_t* __restrict__ t_out) {
  extern __shared__ __align__(16) int32_t win[];
  const int r0 = blockIdx.x * kScanRows, r1 = min(a.rows, r0 + kScanRows);
  const int lo = max(0, r0 - (1 << rounds)), nw = r1 - lo;
  int32_t* cur = win;
  int32_t* nxt = win + nw;
  for (int i = threadIdx.x; i < nw; i += kScanBlock) cur[i] = tot[lo + i];
  __syncthreads();
  for (int rd = 0; rd < rounds; ++rd) {
    const int k = 1 << rd;
    for (int i = threadIdx.x; i < nw; i += kScanBlock)
      nxt[i] = combine(a.op, cur[i], i >= k ? cur[i - k] : a.fill);
    __syncthreads();
    int32_t* w = cur;
    cur = nxt;
    nxt = w;
  }
  const int lane = threadIdx.x & 31, r = r0 + (threadIdx.x >> 5);
  if (r >= r1) return;
  int32_t v[4];
  scan_of_row(x, r, lane, a, v);
  const int32_t before = r >= 1 ? cur[r - 1 - lo] : a.fill, t = cur[r - lo];
  const size_t f = static_cast<size_t>(r) * L + 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[f + j] = combine(a.op, v[j], before);
    if (s_out != nullptr) s_out[f + j] = v[j];
    if (t_out != nullptr) t_out[f + j] = t;
  }
}

// The tables of a gather and their masks.
struct Tables {
  const int32_t* tab[kMaxTables];
  uint32_t vmask[kMaxTables];
};

// Block (x, j): out[j * nidx + e] = gather(table_j, idx[e]) & vmask_j for
// the kGatherBlock indices e of block x, table j (n entries) read where it
// lies; idx == nullptr: idx[e] = n - 1 - e (flip2d).  Element e's row is
// e / width.  A block row a table spreads a gather of 8 tables over 8 times
// the SMs that one thread an index looping over the tables would use, for
// a faster kernel at every JAX shape (PERF.md, the gather's layout).
__global__ void __launch_bounds__(kGatherBlock)
gather_harness(Tables t, int n, const int32_t* __restrict__ idx, int nidx, int width, int mode,
               int32_t* __restrict__ out) {
  const int e = blockIdx.x * kGatherBlock + threadIdx.x, j = blockIdx.y;
  if (e >= nidx) return;
  const int32_t* __restrict__ tab = nullptr;
  uint32_t vmask = 0;
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k)            // a select, not a copy of t to the stack
    if (k == j) {
      tab = t.tab[k];
      vmask = t.vmask[k];
    }
  const int32_t ix = idx != nullptr ? idx[e] : n - 1 - e;
  out[static_cast<size_t>(j) * nidx + e] = gather(tab, n, mode, vmask, ix, e / width);
}


// The value tiles of a scatter and their masks.
struct Values {
  const int32_t* val[kMaxTables];
  uint32_t vmask[kMaxTables];
};

// Block (x, j): H[pos[e] - lo] += val_j[e] & vmask_j for the positions of
// table j's slice [lo, lo + n), lo = x * slice, whose mask (none, or
// mask_bytes 1 or 4 a position) is nonzero, into a shared histogram of n
// entries (limbs of them when limbs > 0); then out_j[lo, lo + n).  A
// position outside [0, n_out) lies in no slice: it scatters nowhere.
__global__ void __launch_bounds__(kBlock)
scatter_harness(Values v, const int32_t* __restrict__ pos, const void* __restrict__ mask,
                int mask_bytes, int npos, int limbs, int n_out, int slice,
                int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t hist[];
  const int j = blockIdx.y, lo = blockIdx.x * slice;
  const int n = min(slice, n_out - lo);
  for (int f = threadIdx.x; f < n * (limbs > 0 ? limbs : 1); f += kBlock) hist[f] = 0;
  __syncthreads();
  const int32_t* __restrict__ val = nullptr;
  uint32_t vmask = 0;
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k)            // a select, not a copy of v to the stack
    if (k == j) {
      val = v.val[k];
      vmask = v.vmask[k];
    }
#pragma unroll 4
  for (int e = threadIdx.x; e < npos; e += kBlock) {
    const int64_t p = static_cast<int64_t>(pos[e]) - lo;
    if (p < 0 || p >= n) continue;
    if (mask != nullptr && (mask_bytes == 1 ? static_cast<const uint8_t*>(mask)[e]
                                            : static_cast<const int32_t*>(mask)[e]) == 0)
      continue;
    scatter(hist, n, limbs, static_cast<int32_t>(p), static_cast<uint32_t>(val[e]) & vmask);
  }
  __syncthreads();
  scatter_finish(hist, n, limbs, out + static_cast<size_t>(j) * n_out + lo);
}

// Launch `kernel` on `grid` blocks of `threads` threads with `smem` bytes
// (at most the default 48 KB) of dynamic shared memory; returns the first
// CUDA error (cleared), or 0.
template <auto kernel, int threads = kBlock, typename... Args>
int run(dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > static_cast<size_t>(kSmemDefault)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The helpers of each kind (csnappy_tpu_torch/ops/kernel_lib.py HELPERS):
// shift: the stream, lane and row shifts (tests/test_kernel_lib.py :26, :40, :92);
// scan: scan2d (:54), scan2d_mm (:106), scan2d_tril, fill_max_rows;
// gather: gather_flat (:67), local_gather_rows (:79), gather_rows_multi (:120,
// the call at :137), lane_gather, flip2d;
// scatter: scatter_rows_multi (:149), scatter_sum_tile (:169).

int kernel_lib_shift_launch(const void* x, int n, int span, int off, int fill,
                            unsigned vmask, void* out, void* stream) {
  if (n <= 0 || span <= 0 || n % span) return static_cast<int>(cudaErrorInvalidValue);
  const int per = kShiftBlock * kShiftPer;
  return run<shift_kernel, kShiftBlock>(dim3((n - 1) / per + 1), 0, stream,
                                        static_cast<const int32_t*>(x), n, span, off,
                                        static_cast<int32_t>(fill), vmask,
                                        static_cast<int32_t*>(out));
}

// The scan of a (rows, 128) tile: scan_totals, then the row rounds (those
// that 2^r < rows leaves of row_rounds) in scan_finish's blocks, or, where
// their window passes kWindowMax rows, as one scan_round pass each before
// scan_finish.  `tot` is scratch of 2 x rows words; *kernels gets the
// kernels launched.
int kernel_lib_scan_launch(const void* x, int rows, int op, int rounds,
                           unsigned in_mask, unsigned lane_mask, unsigned tot_mask,
                           int fill, int row_rounds, void* out, void* s_out,
                           void* t_out, void* tot, int* kernels, void* stream) {
  *kernels = 0;
  if (rows <= 0 || rows > INT_MAX / L || op < kMax || op > kAddSat)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{rows, op, rounds != 0, in_mask, lane_mask, tot_mask,
                   static_cast<int32_t>(fill)};
  int rr = 0;
  while (rr < row_rounds && (1 << rr) < rows) ++rr;
  const bool passes = std::min(rows, kScanRows + (1 << rr)) > kWindowMax;
  const dim3 grid((rows - 1) / kScanRows + 1);
  const auto* xs = static_cast<const int32_t*>(x);
  int32_t* t = static_cast<int32_t*>(tot);
  int32_t* u = t + rows;
  int e = run<scan_totals, kScanBlock>(grid, 0, stream, xs, a, t);
  if (e != 0) return e;
  ++*kernels;
  for (int rd = 0; passes && rd < rr; ++rd) {
    e = run<scan_round, kRoundBlock>(dim3((rows - 1) / kRoundBlock + 1), 0, stream,
                                     static_cast<const int32_t*>(t), u, rows, 1 << rd, op,
                                     static_cast<int32_t>(fill));
    if (e != 0) return e;
    ++*kernels;
    int32_t* w = t;
    t = u;
    u = w;
  }
  const int in_block = passes ? 0 : rr;
  const size_t smem = 2 * static_cast<size_t>(std::min(rows, kScanRows + (1 << in_block))) * 4;
  e = run<scan_finish, kScanBlock>(grid, smem, stream, xs, a, static_cast<const int32_t*>(t),
                                   in_block, static_cast<int32_t*>(out),
                                   static_cast<int32_t*>(s_out), static_cast<int32_t*>(t_out));
  if (e == 0) ++*kernels;
  return e;
}

// The ntab outputs are one array of ntab x nidx words.
int kernel_lib_gather_launch(const void* const* tab, const unsigned* vmask, int ntab, int n,
                             const void* idx, int nidx, int width, int mode, void* out,
                             void* stream) {
  if (ntab < 1 || ntab > kMaxTables || n <= 0 || nidx <= 0 || width <= 0 ||
      mode < kFlatZero || mode > kRowTake)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t{};
  for (int j = 0; j < ntab; ++j) {
    t.tab[j] = static_cast<const int32_t*>(tab[j]);
    t.vmask[j] = vmask[j];
  }
  return run<gather_harness, kGatherBlock>(dim3((nidx - 1) / kGatherBlock + 1, ntab), 0, stream,
                                           t, n, static_cast<const int32_t*>(idx), nidx, width,
                                           mode, static_cast<int32_t*>(out));
}

// The ntab outputs are one array of ntab x n_out words; a block owns `slice`
// output positions of one table (ops/kernel_lib.py scatter_plan), its
// histograms within the default 48 KB of shared memory.
int kernel_lib_scatter_launch(const void* pos, const void* mask, int mask_bytes, int npos,
                              const void* const* val, const unsigned* vmask, int ntab,
                              int limbs, int n_out, int slice, void* out, void* stream) {
  if (ntab < 1 || ntab > kMaxTables || limbs < 0 || limbs > 4 || n_out <= 0 || npos < 0 ||
      slice <= 0 || (mask != nullptr && mask_bytes != 1 && mask_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(slice < n_out ? slice : n_out) * (limbs > 0 ? limbs : 1) * 4;
  if (smem > static_cast<size_t>(kSmemDefault)) return static_cast<int>(cudaErrorInvalidValue);
  Values v{};
  for (int j = 0; j < ntab; ++j) {
    v.val[j] = static_cast<const int32_t*>(val[j]);
    v.vmask[j] = vmask[j];
  }
  const dim3 grid((n_out - 1) / slice + 1, ntab);
  return run<scatter_harness>(grid, smem, stream, v, static_cast<const int32_t*>(pos), mask,
                              mask_bytes, npos, limbs, n_out, slice,
                              static_cast<int32_t*>(out));
}

const char* kernel_lib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
