// The kernel_lib harness for Hopper (sm_90a): each helper of
// csnappy_tpu/ops/kernel_lib.py run on one tile, as one kernel launch.
//
// Replaces the Pallas harness of tests/test_kernel_lib.py: `_run` (the
// pl.pallas_call at :16, one helper on (1..24, 128) int32 VMEM tiles a
// test) and the two-output call of test_gather_rows_multi (:137).  Each
// entry kernel_lib_<kind>_launch launches one harness kernel, which stages
// its operands in shared memory, calls that one of the four device
// functions of kernel_lib.cuh (shift, scan, gather, scatter) and writes the
// result; the 19 helpers share these four entries.  The parameters that make a
// helper of a device function (the segment and offset of a shift, the
// masks, fill and rounds of a scan, the gather mode, the limb count of a
// scatter, a scatter block's slice) are computed by
// csnappy_tpu_torch/ops/kernel_lib.py.
//
// What bounds them on this card: the launch.  A tile is a few thousand
// operations; one block of 1024 threads does the work in microseconds,
// against a launch cost of the same order.  The shift and scan are
// therefore the plain design: one block, every operand staged into shared
// memory once with coalesced loads (at most the 232,448 bytes a block
// has), results written straight to global memory.  The gather stages
// nothing: its tables (at most 1.7 MB at the JAX fused kernels' shapes,
// csnappy_tpu/ops/decode_fused.py:387, decode_stream.py:255) sit in the
// 50 MB L2 and each entry it needs is read about once, so a grid of
// threads, one an index of one table, reads them in place.  The scatter is not
// bound by a block: the JAX fused kernels scatter into 2-3 histograms of
// 32,768-38,912 entries (csnappy_tpu/ops/decode_fused.py:470,
// decode_stream.py:315, encode_fused.py:375), more than one block holds.
// Its grid is (slices, tables): a block owns one slice of one table's
// output positions, reads every position (a few thousand words, from L2),
// adds those in its slice into shared memory and writes its slice once.
// No global atomic, no memset launch, one launch a call.
//
// The launch path is thin: cudaFuncSetAttribute runs at most once per
// kernel and device, and only for a block above the default 48 KB of
// dynamic shared memory (a scatter slice stays below it).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_lib.cuh"

namespace {

using namespace kernel_lib;

constexpr int kBlock = 1024;
constexpr int kGatherBlock = 128;              // a gather's threads a block: one an index
constexpr int kMaxTables = 8;                  // decode_fused.py:387 gathers from eight
constexpr int kSmemMax = 232448;               // a block's shared memory on the H100 (measured)
constexpr int kSmemDefault = 48 * 1024;        // dynamic shared memory a launch takes unasked

__global__ void __launch_bounds__(kBlock)
shift_harness(const int32_t* __restrict__ x, int n, int span, int off, int32_t fill,
              uint32_t vmask, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t tile[];
  for (int f = threadIdx.x; f < n; f += kBlock) tile[f] = x[f];
  __syncthreads();
  shift(tile, out, n, span, off, fill, vmask);
}

__global__ void __launch_bounds__(kBlock)
scan_harness(const int32_t* __restrict__ x, ScanArgs a, int32_t* __restrict__ out,
             int32_t* __restrict__ s_out, int32_t* __restrict__ t_out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int n = a.rows * L;
  int32_t* s = smem;
  int32_t* tot = s + n;
  int32_t* tbuf = tot + a.rows;
  int32_t* buf = tbuf + a.rows;                  // rounds mode only
  for (int f = threadIdx.x; f < n; f += kBlock) s[f] = x[f];
  scan(s, buf, tot, tbuf, out, a);
  for (int f = threadIdx.x; f < n; f += kBlock) {
    if (s_out != nullptr) s_out[f] = s[f];
    if (t_out != nullptr) t_out[f] = tot[f / L];
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

// Launch `kernel` on `grid` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory; returns the first CUDA error (cleared), or 0.  Above
// the default 48 KB, the kernel's limit is raised to a block's maximum once
// per device (a bit a device), not on every launch.
template <auto kernel, int threads = kBlock, typename... Args>
int run(dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    static std::atomic<uint32_t> raised{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    const uint32_t bit = 1u << (dev & 31);
    if (e == cudaSuccess && !(raised.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
    }
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
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
  return run<shift_harness>(dim3(1), static_cast<size_t>(n) * 4, stream,
                            static_cast<const int32_t*>(x), n, span, off,
                            static_cast<int32_t>(fill), vmask, static_cast<int32_t*>(out));
}

int kernel_lib_scan_launch(const void* x, int rows, int op, int rounds,
                           unsigned in_mask, unsigned lane_mask, unsigned tot_mask,
                           int fill, int row_rounds, void* out, void* s_out,
                           void* t_out, void* stream) {
  if (rows <= 0 || op < kMax || op > kAddSat) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{rows, op, rounds != 0, in_mask, lane_mask, tot_mask,
                   static_cast<int32_t>(fill), row_rounds};
  const size_t smem = (static_cast<size_t>(rows) * L * (rounds ? 2 : 1) + 2 * rows) * 4;
  return run<scan_harness>(dim3(1), smem, stream, static_cast<const int32_t*>(x), a,
                           static_cast<int32_t*>(out), static_cast<int32_t*>(s_out),
                           static_cast<int32_t*>(t_out));
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
