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
// Design:
//   * lane_gather (redesigned for the card): two kernels, one launched a
//     call, chosen by the wrapper from (G, W, N, alignment) and passed as
//     `mode` (bit 0 staged, bit 1 vector indices, bit 2 vector table rows):
//       - lane_gather_kernel, the direct path: a warp takes 128 outputs of
//         one row at a time (one 64-bit division a warp-unit of 128
//         elements, none an element), each lane four: one 16-byte load of
//         its indices (streaming, evict-first), four independent table
//         loads through the read-only path (`__ldg`; the kernel asks for
//         the least shared memory, so L1 holds as much of a table as it
//         can), one 16-byte store (streaming).  Indices that are not
//         16-byte aligned, or rows whose length is not a multiple of 4,
//         take the scalar branch of the same kernel: four coalesced 4-byte
//         loads a lane, the same table loads, four stores;
//       - lane_gather_staged_kernel, for tables whose row fits a block's
//         shared memory: a block of 1,024 threads owns (row g, a span of
//         its indices); it stages the row's table into shared memory with
//         coalesced 16-byte loads (4-byte ones for an unaligned row), then
//         gathers from there, two index vectors a thread in flight.  No SM
//         then reads more than its block's one table, where the direct
//         path's L1 saw every row's table and missed into L2 at 32 bytes a
//         4-byte entry;
//   * row_gather: one warp per output row, four coalesced 128-byte
//     transactions in and four out (512 bytes);
//   * scatter_or, compose_round: one 128-thread group per 128-lane row,
//     kRows rows a block, through shared memory.  compose_round is a Jacobi
//     round: every lane reads the old F, S and E from shared memory and
//     writes three separate outputs, so no lane reads a value that another
//     lane has already rewritten.  S + S[li] is added as uint32, because
//     signed overflow is undefined in C++ and the reference wraps.
//
// The launch entries set each kernel's attributes once per device (the
// direct kernel's carve-out, the staged kernel's shared-memory limit) and
// read the SM count and the direct kernel's occupancy then, not on every
// call.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;          // lane_gather and row_gather blocks
constexpr int kRows = 2;               // 128-lane rows a block of scatter_or and compose_round
constexpr int32_t kSCap = 1 << 23;     // compose_round's saturation of S

constexpr int kUnit = 128;            // outputs a warp takes at a time in the direct path
constexpr int kStageThreads = 1024;   // a staged block
constexpr int kSmemMax = 232448;      // shared memory a block can have (H100)
constexpr int kSmemSm = 233472;       // shared memory of an SM
enum : int { kStaged = 1, kVecIdx = 2, kVecTbl = 4 };

__device__ __forceinline__ int64_t clip(int32_t j, int64_t width) {
  const int64_t k = j;
  return k < 0 ? 0 : (k >= width ? width - 1 : k);
}

__device__ __forceinline__ int32_t keep(int32_t v, uint32_t mask) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) & mask);
}

// out[g, n] = tbl[g * width + clip(idx[g, n])] & mask; a warp-unit is 128
// consecutive outputs of one row, units_per_row = ceil(per_row / 128).
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const int32_t* __restrict__ tbl, int64_t width,
                   const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                   int64_t per_row, int64_t units_per_row, int64_t units, uint32_t mask,
                   int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
       u < units; u += step) {
    const int64_t g = units_per_row == 1 ? u : u / units_per_row;   // one a warp-unit
    const int64_t at = (u - g * units_per_row) * kUnit;
    const int32_t* row = tbl + g * width;
    const int32_t* in = idx + g * per_row;
    int32_t* to = out + g * per_row;
    if (vec) {                                   // 16-byte aligned rows of a multiple of 4
      const int64_t j = at + 4 * lane;
      if (j < per_row) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(in + j));
        int4 r;
        r.x = keep(__ldg(row + clip(v.x, width)), mask);
        r.y = keep(__ldg(row + clip(v.y, width)), mask);
        r.z = keep(__ldg(row + clip(v.z, width)), mask);
        r.w = keep(__ldg(row + clip(v.w, width)), mask);
        __stcs(reinterpret_cast<int4*>(to + j), r);
      }
    } else {                                     // any alignment and length
      int32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = at + 32 * k + lane;
        v[k] = j < per_row ? __ldcs(in + j) : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = keep(__ldg(row + clip(v[k], width)), mask);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = at + 32 * k + lane;
        if (j < per_row) __stcs(to + j, v[k]);
      }
    }
  }
}

// The same function with each row's table staged in shared memory: block
// (x, y) takes indices [x * span, (x + 1) * span) of rows y, y + gridDim.y,
// ...; span is a multiple of 4.
__global__ void __launch_bounds__(kStageThreads)
lane_gather_staged_kernel(const int32_t* __restrict__ tbl, int width,
                          const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                          int64_t per_row, int64_t groups, int64_t span, uint32_t mask,
                          int mode) {
  extern __shared__ int4 s4[];
  const int32_t* s = reinterpret_cast<const int32_t*>(s4);
  const int t = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t hi = lo + span < per_row ? lo + span : per_row;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const int32_t* row = tbl + g * static_cast<int64_t>(width);
    if (g != blockIdx.y) __syncthreads();        // the last row's gathers are done
    if (mode & kVecTbl) {
      const int4* r4 = reinterpret_cast<const int4*>(row);
      for (int i = t; i < width / 4; i += kStageThreads) s4[i] = __ldg(r4 + i);
    } else {
      int32_t* sw = reinterpret_cast<int32_t*>(s4);
      for (int i = t; i < width; i += kStageThreads) sw[i] = __ldg(row + i);
    }
    __syncthreads();
    const int32_t* in = idx + g * per_row;
    int32_t* to = out + g * per_row;
    if (mode & kVecIdx) {
      for (int64_t j = lo + 4 * t; j < hi; j += 8 * kStageThreads) {
        const int64_t j2 = j + 4 * kStageThreads;
        const int4 a = __ldcs(reinterpret_cast<const int4*>(in + j));
        const int4 b = j2 < hi ? __ldcs(reinterpret_cast<const int4*>(in + j2))
                               : make_int4(0, 0, 0, 0);
        const int4 ra = make_int4(keep(s[clip(a.x, width)], mask), keep(s[clip(a.y, width)], mask),
                                  keep(s[clip(a.z, width)], mask), keep(s[clip(a.w, width)], mask));
        __stcs(reinterpret_cast<int4*>(to + j), ra);
        if (j2 < hi) {
          const int4 rb = make_int4(keep(s[clip(b.x, width)], mask),
                                    keep(s[clip(b.y, width)], mask),
                                    keep(s[clip(b.z, width)], mask),
                                    keep(s[clip(b.w, width)], mask));
          __stcs(reinterpret_cast<int4*>(to + j2), rb);
        }
      }
    } else {
      for (int64_t j = lo + t; j < hi; j += kStageThreads)
        __stcs(to + j, keep(s[clip(__ldcs(in + j), width)], mask));
    }
  }
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

// The device facts the lane_gather launch needs, read once per device: its
// SM count and how many direct blocks an SM holds; the kernels' attributes
// are set in the same pass.
struct Card {
  int sms = 0;
  int direct_per_sm = 0;
};

cudaError_t card(const Card** out) {
  static Card cards[64];
  static std::atomic<bool> ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    Card c;
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(lane_gather_kernel),
                               cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(lane_gather_staged_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.direct_per_sm, reinterpret_cast<const void*>(lane_gather_kernel), kThreads, 0);
    if (e != cudaSuccess) return e;
    cards[dev] = c;
    ready[dev].store(true, std::memory_order_release);
  }
  *out = &cards[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[g * per_row + n] = tbl[g * width + clip(idx[g * per_row + n], 0, width - 1)] & mask
// for g < groups, n < per_row, on `stream`, by the path `mode` names (bit 0:
// the staged kernel, which needs width * 4 <= 232,448; bit 1: idx and out
// 16-byte aligned and per_row % 4 == 0; bit 2: tbl 16-byte aligned and
// width % 4 == 0).  Returns the first CUDA error, or 0.
int primitives_lane_gather_launch(const void* tbl, long long width, const void* idx, void* out,
                                  long long groups, long long per_row, unsigned mask, int mode,
                                  void* stream) {
  if (groups <= 0 || per_row <= 0) return 0;
  const Card* c = nullptr;
  cudaError_t e = card(&c);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tbl);
  const int32_t* i = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  if (mode & kStaged) {
    if (width <= 0 || width * 4 > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>((width * 4 + 15) & ~15LL);
    const int per_sm = std::max(1, std::min(2048 / kStageThreads, kSmemSm / (smem + 1024)));
    const long long rows = std::min(groups, 65535LL);
    // spans of each row so that the grid fills the card once, each at least
    // one block-wide vector step
    const long long most = (per_row + 4 * kStageThreads - 1) / (4 * kStageThreads);
    const long long spans = std::max(1LL, std::min(most, 1LL * c->sms * per_sm / rows));
    const long long span = ((per_row + spans - 1) / spans + 3) & ~3LL;
    lane_gather_staged_kernel<<<dim3(static_cast<unsigned>(spans), static_cast<unsigned>(rows)),
                                kStageThreads, smem, st>>>(
        t, static_cast<int>(width), i, o, per_row, groups, span, mask, mode);
  } else {
    const long long units_per_row = (per_row + kUnit - 1) / kUnit;
    const long long units = groups * units_per_row;
    const long long most = 1LL * c->sms * std::max(1, c->direct_per_sm);
    const long long blocks = std::min(most, (units + kThreads / 32 - 1) / (kThreads / 32));
    lane_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        t, width, i, o, per_row, units_per_row, units, mask, (mode & kVecIdx) ? 1 : 0);
  }
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
