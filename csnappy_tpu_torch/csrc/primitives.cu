// Data-movement primitives for Hopper (sm_90a).
//
// Replaces the six Pallas kernels of csnappy_tpu/ops/primitives.py (rows
// 6-11 of the kernel table in PERF.md) with four kernels:
//   * lane_gather   — local_gather (:94), table_gather (:283) and
//                     rowwise_gather (:328): G rows, each with a private
//                     table of width W and N indices a row,
//                     out[g, n] = tbl[g, clip(idx[g, n], 0, W - 1)] & mask;
//                     at G = 1 also the one-hot gather of
//                     csnappy_tpu/tools/movebench.py:62 (row 12);
//   * row_gather    — row_gather (:231): rows of 128 int32,
//                     out[m, :] = tbl[clip(rows[m], 0, CI - 1), :] & mask;
//   * scatter_or    — local_scatter_or (:132): out[c, q] =
//                     max(any_e(mask[c, e] > 0 && tgt[c, e] == q), mask[c, q]);
//   * compose_round — compose_round (:187): one round of in-chunk pointer
//                     jumping over (F, S, E).
// The TPU kernels gather by one-hot matrix products over (8, 128) tiles and
// split each table value into 8-bit limbs, because the matrix unit rounds
// to bf16; they need three gather layouts because those products have fixed
// shapes.  Hopper loads from any address, so each gather is one load, and a
// limb count is one AND mask: the low 8 * limbs bits that the limbs rebuild.
//
// What bounds them on this card: bytes.  Each reads every input once and
// writes every output once, with a few integer operations an element.
//
// Design, simple and right first:
//   * lane_gather: one thread per output element, 64-bit offset
//     g * W + clip(i);
//   * row_gather: one warp per output row, four coalesced 128-byte
//     transactions in and four out (512 bytes);
//   * scatter_or, compose_round: one 128-thread group per 128-lane row,
//     kRows rows a block, through shared memory.  compose_round is a Jacobi
//     round: every lane reads the old F, S and E from shared memory and
//     writes three separate outputs, so no lane reads a value that another
//     lane has already rewritten.  S + S[li] is added as uint32, because
//     signed overflow is undefined in C++ and the reference wraps.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;          // lane_gather and row_gather blocks
constexpr int kRows = 2;               // 128-lane rows a block of scatter_or and compose_round
constexpr int32_t kSCap = 1 << 23;     // compose_round's saturation of S

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const int32_t* __restrict__ tbl, int64_t width,
                   const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                   int64_t per_row, int64_t total, uint32_t mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  int64_t j = idx[i];
  j = j < 0 ? 0 : (j >= width ? width - 1 : j);
  out[i] = static_cast<int32_t>(static_cast<uint32_t>(tbl[(i / per_row) * width + j]) & mask);
}

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int32_t* __restrict__ tbl, int64_t n_rows,
                  const int32_t* __restrict__ rows, int32_t* __restrict__ out, int64_t m,
                  uint32_t mask) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= m) return;
  int64_t src = rows[r];
  src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
  const int32_t* from = tbl + src * kLanes;
  int32_t* to = out + r * kLanes;
#pragma unroll
  for (int k = 0; k < kLanes / 32; ++k)
    to[k * 32 + lane] = static_cast<int32_t>(static_cast<uint32_t>(from[k * 32 + lane]) & mask);
}

__global__ void __launch_bounds__(kLanes * kRows)
scatter_or_kernel(const int32_t* __restrict__ mask, const int32_t* __restrict__ tgt,
                  int32_t* __restrict__ out, int64_t n_rows) {
  __shared__ int32_t hit[kRows][kLanes];
  const int q = threadIdx.x, r = threadIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + r;
  const bool live = row < n_rows;
  const int64_t at = row * kLanes + q;
  hit[r][q] = 0;
  __syncthreads();
  int32_t m = 0;
  if (live) {
    m = mask[at];
    const int32_t t = tgt[at];
    if (m > 0 && t >= 0 && t < kLanes) hit[r][t] = 1;   // every writer stores 1
  }
  __syncthreads();
  if (live) out[at] = max(hit[r][q], m);
}

__global__ void __launch_bounds__(kLanes * kRows)
compose_round_kernel(const int32_t* __restrict__ F, const int32_t* __restrict__ S,
                     const int32_t* __restrict__ E, const int32_t* __restrict__ chunk_end,
                     int32_t* __restrict__ Fo, int32_t* __restrict__ So,
                     int32_t* __restrict__ Eo, int64_t n_rows) {
  __shared__ int32_t sF[kRows][kLanes], sS[kRows][kLanes], sE[kRows][kLanes];
  const int q = threadIdx.x, r = threadIdx.y;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + r;
  const bool live = row < n_rows;
  const int64_t at = row * kLanes + q;
  int32_t f = 0, s = 0, e = 0, ce = 0;
  if (live) {
    f = F[at];
    s = S[at];
    e = E[at];
    ce = chunk_end[at];
  }
  sF[r][q] = f;
  sS[r][q] = s;
  sE[r][q] = e;
  __syncthreads();
  if (!live) return;
  if (f < ce) {
    const int li = f & (kLanes - 1);
    const int32_t sum =
        static_cast<int32_t>(static_cast<uint32_t>(s) + static_cast<uint32_t>(sS[r][li]));
    Fo[at] = sF[r][li];
    So[at] = min(sum, kSCap);
    Eo[at] = e | sE[r][li];
  } else {
    Fo[at] = f;
    So[at] = s;
    Eo[at] = e;
  }
}

// Blocks for `work` items at `per_block` a block, or 0 when the grid would
// exceed gridDim.x's limit.
unsigned grid(int64_t work, int64_t per_block) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  return blocks > INT_MAX ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" {

// out[g * per_row + n] = tbl[g * width + clip(idx[g * per_row + n], 0, width - 1)] & mask
// for g < groups, n < per_row, on `stream`.  Returns cudaGetLastError().
int primitives_lane_gather_launch(const void* tbl, long long width, const void* idx, void* out,
                                  long long groups, long long per_row, unsigned mask,
                                  void* stream) {
  const int64_t total = static_cast<int64_t>(groups) * per_row;
  if (total <= 0) return 0;
  const unsigned blocks = grid(total, kThreads);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  lane_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tbl), width, static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), per_row, total, mask);
  return static_cast<int>(cudaGetLastError());
}

// out[r, :] = tbl[clip(rows[r], 0, n_rows - 1), :] & mask for r < m, rows of
// 128 int32, on `stream`.  Returns cudaGetLastError().
int primitives_row_gather_launch(const void* tbl, long long n_rows, const void* rows, void* out,
                                 long long m, unsigned mask, void* stream) {
  if (m <= 0) return 0;
  const unsigned blocks = grid(m, kThreads / 32);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  row_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tbl), n_rows, static_cast<const int32_t*>(rows),
      static_cast<int32_t*>(out), m, mask);
  return static_cast<int>(cudaGetLastError());
}

// The scatter-or of n_rows 128-lane rows of mask and tgt into out, on
// `stream`.  Returns cudaGetLastError().
int primitives_scatter_or_launch(const void* mask, const void* tgt, void* out, long long n_rows,
                                 void* stream) {
  if (n_rows <= 0) return 0;
  const unsigned blocks = grid(n_rows, kRows);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  scatter_or_kernel<<<blocks, dim3(kLanes, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mask), static_cast<const int32_t*>(tgt),
      static_cast<int32_t*>(out), n_rows);
  return static_cast<int>(cudaGetLastError());
}

// One compose round of n_rows 128-lane rows of (F, S, E, chunk_end) into
// (Fo, So, Eo), which must not alias the inputs, on `stream`.  Returns
// cudaGetLastError().
int primitives_compose_round_launch(const void* F, const void* S, const void* E,
                                    const void* chunk_end, void* Fo, void* So, void* Eo,
                                    long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  const unsigned blocks = grid(n_rows, kRows);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  compose_round_kernel<<<blocks, dim3(kLanes, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(F), static_cast<const int32_t*>(S),
      static_cast<const int32_t*>(E), static_cast<const int32_t*>(chunk_end),
      static_cast<int32_t*>(Fo), static_cast<int32_t*>(So), static_cast<int32_t*>(Eo), n_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* primitives_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
