// Data-movement kernels of the movebench tool for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of csnappy_tpu/tools/movebench.py:
//   * movebench.py:62, the one-hot gather (kernel_lib.gather_rows_multi at
//     bits = 16): y[i] = tbl[clip(idx[i], 0, n_tbl - 1)], rebuilt from
//     8-bit limbs, so the result keeps the low 8 * ceil(bits / 8) bits;
//   * movebench.py:92, the permutation-matmul scan (kernel_lib.scan2d_mm,
//     op "max"): the inclusive max-scan of an int32 array in row-major flat
//     order.
// The TPU kernels build a gather out of one-hot matrix products and a scan
// out of permutation products because the TPU has neither a cheap gather
// nor a cross-lane shift.  Hopper has both: loads are byte-addressable and
// warps shuffle.
//
// What bounds them on this card: bytes.  The gather reads idx and one table
// element per output and writes the output (12 B an element); the scan reads
// and writes each element once (8 B an element).  Neither does more than a
// few operations a byte.
//
// Design, simple and right first:
//   * gather: one thread per output element: clip, load, mask;
//   * scan: one block of 1024 threads per 4096-element tile.  The tile is
//     staged in shared memory with coalesced loads; each thread scans its 4
//     contiguous elements, a warp scans the thread totals with shuffles, warp
//     0 scans the 32 warp totals, and the tile is written back coalesced with
//     its block maximum in a scratch array.  Above one tile, the block maxima
//     are scanned the same way (recursively) and a second pass raises each
//     tile by the scanned maximum of the tiles before it.  The identity is
//     INT32_MIN, so every int32 input scans exactly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kPer = 4;                           // elements a scan thread owns
constexpr int64_t kTile = kScanThreads * kPer;    // 4096 elements a tile

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int32_t* __restrict__ tbl, int64_t n_tbl, const int32_t* __restrict__ idx,
              int32_t* __restrict__ out, int64_t n, uint32_t mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= n) return;
  int64_t j = idx[i];
  j = j < 0 ? 0 : (j >= n_tbl ? n_tbl - 1 : j);
  out[i] = static_cast<int32_t>(static_cast<uint32_t>(tbl[j]) & mask);
}

__device__ __forceinline__ int32_t warp_scan_max(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// Inclusive max-scan of each kTile-element tile of in[0:n] into out
// (in == out allowed); the tile's maximum goes to tot[blockIdx.x] when tot
// is not null.
__global__ void __launch_bounds__(kScanThreads)
scan_tile_kernel(const int32_t* in, int32_t* out, int64_t n, int32_t* tot) {
  __shared__ int32_t tile[kTile];
  __shared__ int32_t warp_max[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = base + k * kScanThreads + t;
    tile[k * kScanThreads + t] = i < n ? in[i] : INT_MIN;
  }
  __syncthreads();
  int32_t v[kPer];
  v[0] = tile[t * kPer];
#pragma unroll
  for (int k = 1; k < kPer; ++k) v[k] = max(v[k - 1], tile[t * kPer + k]);
  const int32_t incl = warp_scan_max(v[kPer - 1], lane);
  int32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = INT_MIN;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_scan_max(warp_max[lane], lane);
    warp_max[lane] = w;
  }
  __syncthreads();
  if (warp > 0) excl = max(excl, warp_max[warp - 1]);
#pragma unroll
  for (int k = 0; k < kPer; ++k) tile[t * kPer + k] = max(v[k], excl);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = base + k * kScanThreads + t;
    if (i < n) out[i] = tile[k * kScanThreads + t];
  }
  if (tot != nullptr && t == 0) tot[blockIdx.x] = warp_max[31];
}

// out[i] = max(out[i], carry[tile(i) - 1]) for every tile but the first.
__global__ void __launch_bounds__(kScanThreads)
carry_kernel(int32_t* out, int64_t n, const int32_t* __restrict__ carry) {
  const int32_t c = carry[blockIdx.x];            // grid starts at tile 1
  const int64_t base = (static_cast<int64_t>(blockIdx.x) + 1) * kTile;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t i = base + k * kScanThreads + threadIdx.x;
    if (i < n) out[i] = max(out[i], c);
  }
}

int64_t tiles(int64_t n) { return (n + kTile - 1) / kTile; }

cudaError_t scan_level(const int32_t* in, int32_t* out, int64_t n, int32_t* scratch,
                       cudaStream_t stream) {
  const int64_t nb = tiles(n);
  scan_tile_kernel<<<static_cast<unsigned>(nb), kScanThreads, 0, stream>>>(
      in, out, n, nb > 1 ? scratch : nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nb == 1) return e;
  e = scan_level(scratch, scratch, nb, scratch + nb, stream);
  if (e != cudaSuccess) return e;
  carry_kernel<<<static_cast<unsigned>(nb - 1), kScanThreads, 0, stream>>>(out, n, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = tbl[clip(idx[i], 0, n_tbl - 1)] & mask for i < n, on `stream`.
// Returns cudaGetLastError().
int movebench_gather_launch(const void* tbl, long long n_tbl, const void* idx, void* out,
                            long long n, unsigned mask, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kGatherThreads - 1) / kGatherThreads;
  gather_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tbl), n_tbl, static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n, mask);
  return static_cast<int>(cudaGetLastError());
}

// int32 elements of scratch that movebench_scan_launch needs for n elements.
long long movebench_scan_scratch(long long n) {
  long long total = 0;
  for (int64_t nb = tiles(n); nb > 1; nb = tiles(nb)) total += nb;
  return total;
}

// Inclusive max-scan of x[0:n] into out[0:n] on `stream`; scratch holds
// movebench_scan_scratch(n) int32.  Returns the first CUDA error, or 0.
int movebench_scan_launch(const void* x, void* out, long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  return static_cast<int>(scan_level(static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
                                     n, static_cast<int32_t*>(scratch),
                                     static_cast<cudaStream_t>(stream)));
}

const char* movebench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
