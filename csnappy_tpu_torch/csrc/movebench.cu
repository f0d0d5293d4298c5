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
// Design, simple and right first: one block of 1024 threads per
// 4096-element tile.  The tile is staged in shared memory with coalesced
// loads; each thread scans its 4 contiguous elements, a warp scans the thread
// totals with shuffles, warp 0 scans the 32 warp totals, and the tile is
// written back coalesced with its block maximum in a scratch array.  Above one
// tile, the block maxima are scanned the same way (recursively) and a second
// pass raises each tile by the scanned maximum of the tiles before it.  The
// identity is INT32_MIN, so every int32 input scans exactly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kPer = 4;                           // elements a scan thread owns
constexpr int64_t kTile = kScanThreads * kPer;    // 4096 elements a tile

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
