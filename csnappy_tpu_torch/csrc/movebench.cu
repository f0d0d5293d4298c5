// The max-scan kernel of the movebench tool for Hopper (sm_90a).
//
// Replaces the permutation-matmul scan of csnappy_tpu/tools/movebench.py:92
// (kernel_lib.scan2d_mm, op "max"): the inclusive max-scan of an int32 array
// in row-major flat order.  The TPU kernel builds a scan out of permutation
// products because the TPU has no cross-lane shift; Hopper's warps shuffle.
// (The tool's other kernel, the one-hot gather of movebench.py:62, is
// lane_gather of primitives.cu with one row.)
//
// What bounds it on this card: bytes.  It reads and writes each element once
// (8 B an element) with a few operations a byte.
//
// Design: one pass, one launch (after one memset of its workspace).  Tiles
// of kTile elements are taken in stream order by an atomic ticket, one block
// of kScanThreads a tile.  A thread holds kItems elements as kItems / 4
// striped 16-byte vectors (vector c of thread t at tile offset
// (c * kScanThreads + t) * 4), so every load and store of a warp is 512
// contiguous bytes; each vector is scanned in registers, each vector index
// by warp shuffles, then warp 0 scans the (vector, warp) totals once: two
// barriers for the whole tile.  The tile then publishes its aggregate, and
// later its inclusive prefix, as one 64-bit word a tile: the status in the
// high 32 bits (1 = aggregate, 2 = inclusive prefix), the value in the low
// 32.  Warp 0 looks back over its predecessors 32 words at a time (one a
// lane), taking the maximum of their aggregates up to the nearest inclusive
// prefix (a decoupled look-back), so the output is written once, with
// nothing carried over in a second pass.  Because a tile's ticket is taken
// when its block starts, a block only ever waits on tiles whose blocks are
// already running, which publish their aggregates without waiting on
// anything: no deadlock.  A word is written with one relaxed 64-bit store
// and read with relaxed loads; the value and its status travel together, so
// no fence is needed.  The identity is INT32_MIN, so every int32 input
// scans exactly.  An input that is not 16-byte aligned is loaded four bytes
// at a time in the same order.
//
// The launch carves the workspace (the ticket, then a word a tile) from the
// end of the output's buffer and clears it with one cudaMemsetAsync.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kItems = 32;                        // elements a scan thread owns
constexpr int kVecs = kItems / 4;                 // its 16-byte vectors
constexpr int64_t kTile = kScanThreads * kItems;  // 8192 elements a tile
constexpr int kWarps = kScanThreads / 32;
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ int32_t warp_scan_max(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long word(unsigned long long status, int32_t v) {
  return status | static_cast<uint32_t>(v);
}

// ws[0]: the ticket (low 32 bits); ws[1 + t]: tile t's word; all zero at launch.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n,
            unsigned long long* ws, int vec) {
  __shared__ int32_t tot[kVecs][kWarps];          // then each (vector, warp)'s exclusive prefix
  __shared__ int32_t s_prefix;
  __shared__ unsigned int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(reinterpret_cast<unsigned int*>(ws), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tb = tile * kTile;
  const bool whole = tb + kTile <= n;
  int32_t v[kItems];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    const int64_t b = tb + (static_cast<int64_t>(c) * kScanThreads + t) * 4;
    if (vec && whole) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(x + b));
      v[4 * c] = a.x;
      v[4 * c + 1] = a.y;
      v[4 * c + 2] = a.z;
      v[4 * c + 3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * c + k] = b + k < n ? x[b + k] : INT_MIN;
    }
  }
  int32_t excl[kVecs];                            // within the warp, for each vector
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
#pragma unroll
    for (int k = 1; k < 4; ++k) v[4 * c + k] = max(v[4 * c + k], v[4 * c + k - 1]);
    const int32_t incl = warp_scan_max(v[4 * c + 3], lane);
    excl[c] = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl[c] = INT_MIN;
    if (lane == 31) tot[c][warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    int32_t agg = INT_MIN;                        // the maximum of the vectors before
    for (int c = 0; c < kVecs; ++c) {
      const int32_t w = warp_scan_max(lane < kWarps ? tot[c][lane] : INT_MIN, lane);
      const int32_t before = __shfl_up_sync(0xffffffffu, w, 1);
      if (lane < kWarps) tot[c][lane] = max(agg, lane == 0 ? INT_MIN : before);
      agg = max(agg, __shfl_sync(0xffffffffu, w, 31));
    }
    int32_t prefix = INT_MIN;
    if (tile == 0) {
      if (lane == 0) st_relaxed(&ws[1], word(kPrefix, agg));
    } else {
      if (lane == 0) st_relaxed(&ws[1 + tile], word(kAggregate, agg));
      for (int64_t j = tile - 1;; j -= 32) {     // lane k reads tile j - k
        const int64_t p = j - lane;
        unsigned long long w = word(kPrefix, INT_MIN);   // before tile 0: nothing
        if (p >= 0) {
          do {
            w = ld_relaxed(&ws[1 + p]);
          } while ((w >> 32) == 0);
        }
        const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
        const int last = done ? __ffs(done) - 1 : 31;   // the nearest inclusive prefix
        prefix = max(prefix, warp_max(lane <= last ? static_cast<int32_t>(w) : INT_MIN));
        if (done) break;
      }
      if (lane == 0) st_relaxed(&ws[1 + tile], word(kPrefix, max(prefix, agg)));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    const int32_t carry = max(s_prefix, max(excl[c], tot[c][warp]));
    const int64_t b = tb + (static_cast<int64_t>(c) * kScanThreads + t) * 4;
    const int4 r = make_int4(max(v[4 * c], carry), max(v[4 * c + 1], carry),
                             max(v[4 * c + 2], carry), max(v[4 * c + 3], carry));
    if (whole) {
      __stcs(reinterpret_cast<int4*>(out + b), r);
    } else {
      const int32_t q[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (b + k < n) out[b + k] = q[k];
    }
  }
}

int64_t tiles(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t out_words(int64_t n) { return (n + 3) & ~int64_t{3}; }   // the workspace starts 16-byte aligned

}  // namespace

extern "C" {

// Elements a scan tile holds.
long long movebench_scan_tile() { return kTile; }

// int32 elements of the buffer that movebench_scan_launch writes for n
// elements: the output, padded to 16 bytes, then the workspace.
long long movebench_scan_words(long long n) { return out_words(n) + 2 * (1 + tiles(n)); }

// Inclusive max-scan of x[0:n] into buf[0:n] on `stream`, where buf holds
// movebench_scan_words(n) int32 and is 16-byte aligned: one memset of the
// workspace behind the output, then one kernel.  Returns the first CUDA
// error, or 0.
int movebench_scan_launch(const void* x, void* buf, long long n, void* stream) {
  if (n <= 0) return 0;
  const int64_t nt = tiles(n);
  if (nt > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(buf);
  auto* ws = reinterpret_cast<unsigned long long*>(out + out_words(n));
  cudaError_t e = cudaMemsetAsync(ws, 0, 8 * (1 + nt), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  scan_kernel<<<static_cast<unsigned>(nt), kScanThreads, 0, st>>>(
      static_cast<const int32_t*>(x), out, n, ws, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* movebench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
