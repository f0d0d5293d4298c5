// Latency and capacity probes for Hopper (sm_90a).
//
// Replaces the Mosaic probes of the JAX package's tools: the twelve kernels
// of tools/mosaic_probe.py (pl.pallas_call at :45), the seven of
// tools/mosaic_probe2.py (:24), smem_cap of tools/mosaic_probe5.py (:39) and
// its interleaved walks (time_walk, :102).  Each kernel computes what its TPU
// kernel computes: the same int32 (8, 128) output for the same K and input,
// 32-bit sums wrapping (uint32 arithmetic, cast back).  Scratch that a TPU
// kernel reads before it writes holds INT32_MIN, the Pallas interpreter's
// fill of unwritten int32 scratch, so the answers are defined.
//
// What bounds them on this card: latency, by design.  A probe loops K times
// inside one launch of one block, each step depending on the last, so the
// slope of its time in K is the cost of one step.  The bytes (a 152 KiB
// input, a 4 KiB output) and the operations are trivial beside it.  Each
// kernel times its loop with clock64() on thread 0 and writes the cycles to
// `cycles` (mm_small also adds check words after them); the wrapper also
// takes the CUDA-event slope between two K.
//
// Design, per family (one block each):
// * walks — one thread walks a table, p = (p + f(v)) % M with M a
//   compile-time constant (a multiply-high, not a division), the table in
//   global memory read once by the whole block first (L1-resident; 576 rows
//   of time_walk exceed a block's shared memory and stay global), or staged
//   into shared memory; stores to shared scratch where the TPU kernel
//   stores; the windowed walk refills its 16-row shared window with one
//   cp.async.bulk (TMA) copy completed on an mbarrier, as the TPU kernel's
//   DMA and semaphore;
// * rows — 128 threads, one lane each (1024 for the aligned 8-row writes):
//   dynamic row reads from global memory, row writes into shared memory;
// * lanes — 1024 threads, one element of the (8, 128) tile each: dense
//   ALU chains; the rolls rotate the 128 lanes through shared memory (a warp
//   shuffle spans 32 lanes only, so a 128-lane rotate is a shared-memory
//   exchange with a barrier); the one-hot row product of the TPU becomes a
//   direct row read;
// * gather/scatter — the 256-row table in shared memory at 16 bits a value,
//   gathered by address (no limbs); the one-hot scatter-sum becomes a
//   shared-memory atomicAdd histogram whose row 0 is read, then cleared;
// * mma — a bf16 (128,128)@(128,128) product a step on Hopper's wgmma
//   (csrc/wgmma.cuh), float accumulation: two warpgroups of 64 rows, A from
//   registers, B resident in shared memory; the carry's (0, 0) element
//   feeds the next step's operand, so the bound is one SM's tensor-core
//   rate plus the chain's latency;
// * capacity — a kernel that writes the first and last int32 of a dynamic
//   shared buffer of `bytes`; the launch is refused above the block's opt-in
//   limit (cudaFuncSetAttribute), and the wrapper bisects for that limit.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int L = 128;
constexpr int kRows = 304;                       // mosaic_probe.py ROWS
constexpr int kOut = 8 * L;                      // the (8, 128) output
constexpr int32_t kUnwritten = INT_MIN;          // the interpreter's fill of scratch
constexpr int kWalkThreads = 256;                // stage or warm the table; thread 0 walks
constexpr int kMmThreads = 256;                  // 8 warps of 16 rows

__device__ __forceinline__ void fill_out(int32_t* out, int32_t v) {
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) out[i] = v;
}

// The whole block reads the n-entry table once, so a walk over global memory
// finds it in L1.  A thread stores its sum only when the sum hits one value,
// which keeps the loads; fill_out, later in the same thread, overwrites it.
__device__ __forceinline__ void warm_l1(const int32_t* __restrict__ d, int n, int32_t* out) {
  uint32_t s = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += static_cast<uint32_t>(d[i]);
  if (s == 0x9E3779B9u) out[threadIdx.x] = static_cast<int32_t>(s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ walks

enum Store { kNone, kFlat, kTile };

// mosaic_probe.py:58 k_walk_load, :68 k_walk_ldst, :79 k_walk_vst, :90
// k_walk_while: K dependent loads p = (p + (v & 63) + 1) % 38912 from the
// (304, 128) input in global memory, acc += v; with a store of v a step into
// a 2048-entry scratch (flat, or the (16, 128) tile: the same address).
template <bool kWhile, int kStore>
__global__ void __launch_bounds__(kWalkThreads)
walk_global_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  constexpr uint32_t kM = kRows * L;
  __shared__ int32_t scr[16][L];
  __shared__ int32_t result;
  warm_l1(d, kRows * L, out);
  if (kStore != kNone)
    for (int i = threadIdx.x; i < 16 * L; i += blockDim.x) scr[i >> 7][i & 127] = kUnwritten;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t p = 0, acc = 0;
    const long long t0 = clock64();
    int i = 0;
    if (kWhile) {
      while (i < k) {
        const uint32_t v = static_cast<uint32_t>(d[p]);
        p = (p + (v & 63u) + 1u) % kM;
        acc += v;
        ++i;
      }
    } else {
      for (; i < k; ++i) {
        const uint32_t v = static_cast<uint32_t>(d[p]);
        if (kStore == kFlat) (&scr[0][0])[i & 2047] = static_cast<int32_t>(v);
        if (kStore == kTile) scr[(i >> 7) & 15][i & 127] = static_cast<int32_t>(v);
        p = (p + (v & 63u) + 1u) % kM;
        acc += v;
      }
    }
    cycles[0] = clock64() - t0;
    result = static_cast<int32_t>(acc + p + (kStore != kNone ? static_cast<uint32_t>(scr[0][0]) : 0u));
  }
  __syncthreads();
  fill_out(out, result);
}

// mosaic_probe.py:104 k_walk_smem (16 rows, % 2048), mosaic_probe2.py:62
// k_walk_smem_big (128 rows, & 16383) and :46 k_walk_smem_st (16 rows, with
// tags[i & 1023] = p and tags[1024 + (i & 1023)] = acc a step): the rows
// staged into shared memory, then one thread walks them.
template <int kTabRows, bool kTags>
__global__ void __launch_bounds__(kWalkThreads)
walk_shared_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  constexpr uint32_t kMask = kTabRows * L - 1;   // a power of two
  extern __shared__ int32_t walk_smem[];
  int32_t* tab = walk_smem;
  int32_t* tags = walk_smem + kTabRows * L;
  __shared__ int32_t result;
  for (int i = threadIdx.x; i < kTabRows * L; i += blockDim.x) tab[i] = d[i];
  if (kTags)
    for (int i = threadIdx.x; i < 2048; i += blockDim.x) tags[i] = kUnwritten;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t p = 0, acc = 0;
    const long long t0 = clock64();
    for (int i = 0; i < k; ++i) {
      const uint32_t v = static_cast<uint32_t>(tab[p]);
      if (kTags) {
        tags[i & 1023] = static_cast<int32_t>(p);
        tags[1024 + (i & 1023)] = static_cast<int32_t>(acc);
      }
      p = (p + (v & 63u) + 1u) & kMask;
      acc += v;
    }
    cycles[0] = clock64() - t0;
    result = static_cast<int32_t>(acc + p + (kTags ? static_cast<uint32_t>(tags[0]) : 0u));
  }
  __syncthreads();
  fill_out(out, result);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
  (void)state;
}

// Waits for the phase of `bar` with `parity` to complete; a copy that never
// completes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The shared-memory address of `p`, computed in volatile PTX so that the
// compiler keeps it in a register instead of re-deriving it, inside a loop,
// from the block's shared-window base (S2UR SR_CgaCtaId) as it does for
// __cvta_generic_to_shared.
__device__ __forceinline__ uint32_t smem_addr_opaque(const void* p) {
  uint32_t addr;
  asm volatile("{\n\t.reg .u64 a;\n\tcvta.to.shared.u64 a, %1;\n\tcvt.u32.u64 %0, a;\n\t}"
               : "=r"(addr)
               : "l"(p));
  return addr;
}

// A 32-bit load from a shared-memory address held in a register.
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// mosaic_probe2.py:76 k_smem_window_dma: the 16-row walk over a shared
// window that is refilled from rows base + 16 (mod 288) of the input at every
// step i with i % 256 == 255; one cp.async.bulk copy a refill, waited on.
// The walk loads through the window's shared address kept in a register:
// indexing `win` directly made the compiler re-read the block's shared
// window base (S2UR SR_CgaCtaId) on every step, after the refill branch.
__global__ void __launch_bounds__(kWalkThreads)
smem_window_dma_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  constexpr uint32_t kWin = 16 * L;
  __shared__ __align__(128) int32_t win[kWin];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int32_t result;
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) win[i] = kUnwritten;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t win_at = smem_addr_opaque(win);
    uint32_t p = 0, acc = 0, base = 0, parity = 0;
    const long long t0 = clock64();
    for (int i = 0; i < k; ++i) {
      if ((i & 255) == 255) {
        base = (base + 16u) % (kRows - 16);
        fence_proxy_async();
        bulk_load(win, d + base * L, kWin * 4, &bar);
        mbar_wait(&bar, parity);
        parity ^= 1u;
      }
      const uint32_t v = lds_u32(win_at + 4 * p);
      p = (p + (v & 63u) + 1u) & (kWin - 1);
      acc += v;
    }
    cycles[0] = clock64() - t0;
    result = static_cast<int32_t>(acc + p);
  }
  __syncthreads();
  fill_out(out, result);
}

// mosaic_probe5.py:54 walk_kern: kChains interleaved walks
// p = (p + (v & 0x1FFFF)) % (kTabRows * 128) from 0, M/kChains, ...; the
// output is the sum of the values read.  The table in shared memory, or in
// global memory (read once first) where it exceeds a block's shared memory.
template <int kChains, int kTabRows, bool kShared>
__global__ void __launch_bounds__(kWalkThreads)
chain_walk_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  constexpr uint32_t kM = kTabRows * L;
  extern __shared__ int32_t chain_smem[];
  __shared__ int32_t result;
  if (kShared) {
    for (int i = threadIdx.x; i < static_cast<int>(kM); i += blockDim.x) chain_smem[i] = d[i];
  } else {
    warm_l1(d, kM, out);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t p[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) p[c] = c * (kM / kChains);
    uint32_t acc = 0;
    const long long t0 = clock64();
    for (int i = 0; i < k; ++i) {
      uint32_t v[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        v[c] = static_cast<uint32_t>(kShared ? chain_smem[p[c]] : d[p[c]]);
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        p[c] = (p[c] + (v[c] & 0x1FFFFu)) % kM;
        acc += v[c];
      }
    }
    cycles[0] = clock64() - t0;
    result = static_cast<int32_t>(acc);
  }
  __syncthreads();
  fill_out(out, result);
}

// ------------------------------------------------------------------- rows

// mosaic_probe.py:118 k_row_read: acc += d[r, :], r = (r + 7) % 304.
__global__ void __launch_bounds__(L)
row_read_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  const int lane = threadIdx.x;
  uint32_t acc = 0;
  int r = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    acc += static_cast<uint32_t>(d[r * L + lane]);
    r += 7;
    if (r >= kRows) r -= kRows;
  }
  if (lane == 0) cycles[0] = clock64() - t0;
  for (int j = 0; j < 8; ++j) out[j * L + lane] = static_cast<int32_t>(acc + r);
}

// mosaic_probe.py:128 k_row_write: scr[r % 64, :] = d[r, :] + i into a
// (64, 128) shared scratch; the output is scr[0] + r.  A lane touches only
// its own column, so no barrier is needed.
__global__ void __launch_bounds__(L)
row_write_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  __shared__ int32_t scr[64][L];
  const int lane = threadIdx.x;
  for (int j = 0; j < 64; ++j) scr[j][lane] = kUnwritten;
  int r = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    scr[r & 63][lane] = static_cast<int32_t>(static_cast<uint32_t>(d[r * L + lane]) + i);
    r += 7;
    if (r >= kRows) r -= kRows;
  }
  if (lane == 0) cycles[0] = clock64() - t0;
  const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(scr[0][lane]) + r);
  for (int j = 0; j < 8; ++j) out[j * L + lane] = v;
}

// mosaic_probe2.py:97 k_row_write_al: scr[r8:r8+8, :] = d[r8:r8+8, :] + i,
// r8 = (i % 8) * 8, by 8 x 128 threads; the output is scr[0:8] + K.
__global__ void __launch_bounds__(kOut)
row_write_al_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  __shared__ int32_t scr[64][L];
  const int j = threadIdx.x >> 7, lane = threadIdx.x & 127;
  for (int m = 0; m < 8; ++m) scr[m * 8 + j][lane] = kUnwritten;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const int row = (i & 7) * 8 + j;
    scr[row][lane] = static_cast<int32_t>(static_cast<uint32_t>(d[row * L + lane]) + i);
  }
  if (threadIdx.x == 0) cycles[0] = clock64() - t0;
  out[threadIdx.x] = static_cast<int32_t>(static_cast<uint32_t>(scr[j][lane]) + k);
}

// ------------------------------------------------------------------ lanes

// mosaic_probe.py:150 k_onehot_row: acc[r] += (d & 255)[((d[r, 0] & 255) + i) % 256]
// for rows r = 0-7; the one-hot product is a direct row read here.
__global__ void __launch_bounds__(kOut)
onehot_row_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  const int j = threadIdx.x >> 7, lane = threadIdx.x & 127;
  const uint32_t idx = static_cast<uint32_t>(d[j * L]) & 255u;
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i)
    acc += static_cast<uint32_t>(d[((idx + i) & 255u) * L + lane]) & 255u;
  if (threadIdx.x == 0) cycles[0] = clock64() - t0;
  out[threadIdx.x] = static_cast<int32_t>(acc);
}

// mosaic_probe.py:164 k_vpu_dense: acc = (acc + x) ^ (acc >> 1), x = d[0:8].
__global__ void __launch_bounds__(kOut)
vpu_dense_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  const uint32_t x = static_cast<uint32_t>(d[threadIdx.x]);
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i)
    acc = (acc + x) ^ static_cast<uint32_t>(static_cast<int32_t>(acc) >> 1);
  if (threadIdx.x == 0) cycles[0] = clock64() - t0;
  out[threadIdx.x] = static_cast<int32_t>(acc);
}

// Lane c of a row takes lane c - shift (mod 128): jnp.roll's direction.
__device__ __forceinline__ int rolled(int j, int lane, int shift) {
  return (j << 7) | ((lane - shift) & 127);
}

// mosaic_probe.py:173 k_roll_static: acc += roll(x + acc[0, 0], 5).
__global__ void __launch_bounds__(kOut)
roll_static_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  __shared__ uint32_t buf[kOut];
  __shared__ uint32_t corner;
  const int t = threadIdx.x, j = t >> 7, lane = t & 127;
  const uint32_t x = static_cast<uint32_t>(d[t]);
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    if (t == 0) corner = acc;
    __syncthreads();
    buf[t] = x + corner;
    __syncthreads();
    acc += buf[rolled(j, lane, 5)];
  }
  if (t == 0) cycles[0] = clock64() - t0;
  out[t] = static_cast<int32_t>(acc);
}

// mosaic_probe.py:182 k_roll_dyn: acc += roll(x, i & 127); x is read-only,
// so it sits in shared memory and each lane reads its rotated source.
__global__ void __launch_bounds__(kOut)
roll_dyn_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  __shared__ uint32_t xs[kOut];
  const int t = threadIdx.x, j = t >> 7, lane = t & 127;
  xs[t] = static_cast<uint32_t>(d[t]);
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) acc += xs[rolled(j, lane, i & 127)];
  if (t == 0) cycles[0] = clock64() - t0;
  out[t] = static_cast<int32_t>(acc);
}

// mosaic_probe2.py:37 k_roll_static_min: acc = roll(acc, 5) + x.
__global__ void __launch_bounds__(kOut)
roll_static_min_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  __shared__ uint32_t buf[kOut];
  const int t = threadIdx.x, j = t >> 7, lane = t & 127;
  const uint32_t x = static_cast<uint32_t>(d[t]);
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    buf[t] = acc;
    __syncthreads();
    acc = buf[rolled(j, lane, 5)] + x;
    __syncthreads();
  }
  if (t == 0) cycles[0] = clock64() - t0;
  out[t] = static_cast<int32_t>(acc);
}

// --------------------------------------------------------- gather/scatter

// mosaic_probe2.py:108 k_gather_loop: row i & 7 of the carry becomes
// table[d[i % 304] & 32767], table = d[0:256] & 0xFFFF staged in shared
// memory at 16 bits a value; the output is the carry + K.
__global__ void __launch_bounds__(L)
gather_loop_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  extern __shared__ uint16_t gather_smem[];
  uint16_t* table = gather_smem;                         // 256 * 128 values
  __shared__ int32_t acc[8][L];
  const int lane = threadIdx.x;
  for (int e = lane; e < 256 * L; e += L) table[e] = static_cast<uint16_t>(d[e] & 0xFFFF);
  for (int j = 0; j < 8; ++j) acc[j][lane] = 0;
  __syncthreads();
  int r = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    acc[i & 7][lane] = table[d[r * L + lane] & (256 * L - 1)];
    r = r + 1 == kRows ? 0 : r + 1;
  }
  if (lane == 0) cycles[0] = clock64() - t0;
  for (int j = 0; j < 8; ++j)
    out[j * L + lane] = static_cast<int32_t>(static_cast<uint32_t>(acc[j][lane]) + k);
}

// mosaic_probe2.py:136 k_scatter_loop: the scatter-sum of
// scatter_sum_tile at row 0: h[c] = sum over lanes with pos == c of
// (val & 255) + ((val >> 8) & 255), pos = d[i % 304] & 32767,
// val = d[(i + 1) % 304] & 0x7FFF.  A 32768-bin shared histogram takes
// atomicAdds, row 0 is read, and the bins written are cleared.
__global__ void __launch_bounds__(L)
scatter_loop_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  extern __shared__ int32_t hist[];                      // 256 * 128 bins
  const int lane = threadIdx.x;
  for (int e = lane; e < 256 * L; e += L) hist[e] = 0;
  __syncthreads();
  uint32_t acc = 0;
  int r = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const int r1 = r + 1 == kRows ? 0 : r + 1;
    const uint32_t pos = static_cast<uint32_t>(d[r * L + lane]) & (256 * L - 1);
    const uint32_t val = static_cast<uint32_t>(d[r1 * L + lane]) & 0x7FFFu;
    atomicAdd(&hist[pos], static_cast<int32_t>((val & 255u) + ((val >> 8) & 255u)));
    __syncthreads();
    acc += static_cast<uint32_t>(hist[lane]);
    __syncthreads();
    hist[pos] = 0;
    __syncthreads();
    r = r1;
  }
  if (lane == 0) cycles[0] = clock64() - t0;
  for (int j = 0; j < 8; ++j) out[j * L + lane] = static_cast<int32_t>(acc + k);
}

// -------------------------------------------------------------------- mma

// b, the B operand, K-major in shared memory (csrc/wgmma.cuh), then two
// words for acc[0, 0], written and read in turns.
constexpr int kMmSmem = L * L * 2 + 2 * 4;

// The bits of bf16(x), in the low half.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element of the carry after a product: acc + bf16(c * 1e-9), in bf16.
__device__ __forceinline__ float mm_step(float acc, float c) {
  return round_bf16(acc + round_bf16(c * 1e-9f));
}

// mosaic_probe.py:138 k_mm_small: c = (a + acc[0, 0]) @ b in float from bf16
// a = d[0:128] & 1 and b = d[0:128] & 3; acc += bf16(c[0:8] * 1e-9) in bf16;
// the output is acc cast to int32 (toward zero).  On wgmma: two warpgroups,
// each m64n128k16 x 8 steps with A from registers and B = b resident in
// shared memory.  Warp w holds its fragment of a's rows 16w..16w+15 as
// masks: a is 0 or 1, so a + s is bf16(0 + s) or bf16(1 + s), one select a
// bf16 pair each iteration, each sum rounded once as before.  Warp 0 holds
// acc's rows 0-7 (bf16 values in floats) beside its rows of c.  Only
// acc[0, 0] feeds the chain: thread 0 computes it first and hands it to
// every thread through a shared word and a barrier; warp 0 updates its
// rows after the barrier, while warpgroup 1's next product runs.
//
// The output is the int32 of values below 1, all zeros whatever the product,
// so after the loop the kernel adds three check words to cycles[1..3] (zeroed
// by the caller), each exact in any summation order, for the plain
// version's (tools/probe.py, mm_small_words): the sum over acc's 1,024
// values of (e + 1) times its float bits, e its row-major index; the sum
// over the last product c's 16,384 values of (e + 1) times c rounded to an
// integer (c is an integer plus a carry term below 0.01); and the sum over
// the 256 threads of the float bits of the acc[0, 0] each used last.
__global__ void __launch_bounds__(kMmThreads)
mm_small_kernel(const int32_t* __restrict__ d, int k, int32_t* out, long long* cycles) {
  extern __shared__ __align__(128) unsigned char mm_smem[];
  __nv_bfloat16* const b = reinterpret_cast<__nv_bfloat16*>(mm_smem);
  float* const carry = reinterpret_cast<float*>(b + L * L);        // acc[0, 0], two turns
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int e = t; e < L * L; e += kMmThreads) {
    const int r = e >> 7, c = e & 127;                              // b[r][c]: depth r, column c
    b[wg::core_offset(L, c, 2 * r) / 2] = __float2bfloat16_rn(static_cast<float>(d[e] & 3));
  }
  // a[row][col], a[row][col + 1] in mask[4 s + q]: rows 16 warp + lane / 4
  // (+ 8 for q odd), columns 16 s + 2 (lane % 4) (+ 8 for q >= 2)
  uint32_t mask[32];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = (16 * warp + (lane >> 2) + 8 * (q & 1)) * L + 16 * s + 2 * (lane & 3) +
                    8 * (q >> 1);
      mask[4 * s + q] = (d[e] & 1 ? 0xFFFFu : 0u) | (d[e + 1] & 1 ? 0xFFFF0000u : 0u);
    }
  }
  float acc[32];                                 // warp 0: acc[lane / 4][8 n + 2 (lane % 4) + j]
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  if (t == 0) carry[0] = 0.0f;
  wg::fence_shared();
  __syncthreads();
  const uint64_t db = wg::desc(wg::smem_addr(b), L);
  float c[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) c[j] = 0.0f;
  float s_last = 0.0f;
  const long long t0 = clock64();
  for (int it = 0; it < k; ++it) {
    const float s = carry[it & 1];
    s_last = s;
    const uint32_t one = bf16_bits(1.0f + s) * 0x10001u, zero = bf16_bits(0.0f + s) * 0x10001u;
    uint32_t a[8][4];
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j >> 2][j & 3] = (mask[j] & one) | (~mask[j] & zero);
#pragma unroll
    for (int j = 0; j < 8; ++j) wg::hold(a[j]);
    wg::hold(c);
    wg::fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) wg::mma_bf16_rs(c, a[j], db + j * wg::step(L), j > 0);
    wg::commit();
    wg::wait();
    wg::hold(c);
    if (t == 0) carry[(it + 1) & 1] = mm_step(acc[0], c[0]);
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[2 * n] = mm_step(acc[2 * n], c[4 * n]);
        acc[2 * n + 1] = mm_step(acc[2 * n + 1], c[4 * n + 1]);
      }
    }
  }
  if (t == 0) cycles[0] = clock64() - t0;
  unsigned long long* const check = reinterpret_cast<unsigned long long*>(cycles + 1);
  unsigned long long sum_c = 0;
#pragma unroll
  for (int j = 0; j < 64; ++j) {                 // c[16 warp + lane / 4 (+ 8)][8 n + 2 (lane % 4) (+ 1)]
    const int e = (16 * warp + (lane >> 2) + 8 * ((j >> 1) & 1)) * L + 8 * (j >> 2) +
                  2 * (lane & 3) + (j & 1);
    sum_c += static_cast<unsigned long long>(e + 1) * __float2ll_rn(c[j]);
  }
  atomicAdd(check + 1, sum_c);
  atomicAdd(check + 2, static_cast<unsigned long long>(__float_as_uint(s_last)));
  if (warp == 0) {
    unsigned long long sum_acc = 0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int e = (lane >> 2) * L + 8 * n + 2 * (lane & 3);
      out[e] = static_cast<int32_t>(acc[2 * n]);
      out[e + 1] = static_cast<int32_t>(acc[2 * n + 1]);
      sum_acc += static_cast<unsigned long long>(e + 1) * __float_as_uint(acc[2 * n]) +
                 static_cast<unsigned long long>(e + 2) * __float_as_uint(acc[2 * n + 1]);
    }
    atomicAdd(check, sum_acc);
  }
}

// --------------------------------------------------------------- capacity

// mosaic_probe5.py:39 smem_cap: s[0] = k[0], s[last] = k[0] + 1 in a dynamic
// shared buffer of `words` int32; the output is s[last].  No static shared
// memory, so the dynamic limit is the block's whole opt-in limit.
__global__ void __launch_bounds__(L)
smem_cap_kernel(const int32_t* __restrict__ kvec, long long words, int32_t* out) {
  extern __shared__ int32_t cap[];
  if (threadIdx.x == 0) {
    cap[0] = kvec[0];
    cap[words - 1] = static_cast<int32_t>(static_cast<uint32_t>(kvec[0]) + 1u);
  }
  __syncthreads();
  fill_out(out, cap[words - 1]);
}

// -------------------------------------------------------------- launching

using ProbeKernel = void (*)(const int32_t*, int, int32_t*, long long*);

// Launch one block of `threads` with `smem` bytes of dynamic shared memory;
// returns the first CUDA error (cleared from the thread's last error), or 0.
template <typename Kernel, typename... Args>
int run(Kernel kernel, int threads, int smem, bool max_l1, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && max_l1)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int run_probe(ProbeKernel kernel, int threads, int smem, bool max_l1, const void* d, int k,
              void* out, void* cycles, void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(kernel, threads, smem, max_l1, stream, static_cast<const int32_t*>(d), k,
             static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

}  // namespace

extern "C" {

#define PROBE_ENTRY(name, kernel, threads, smem, max_l1)                                  \
  int probe_##name##_launch(const void* d, int k, void* out, void* cycles, void* stream) { \
    return run_probe(kernel, threads, smem, max_l1, d, k, out, cycles, stream);           \
  }

// mosaic_probe.py (:45)
PROBE_ENTRY(walk_load, (walk_global_kernel<false, kNone>), kWalkThreads, 0, true)
PROBE_ENTRY(walk_ldst, (walk_global_kernel<false, kFlat>), kWalkThreads, 0, true)
PROBE_ENTRY(walk_vst, (walk_global_kernel<false, kTile>), kWalkThreads, 0, true)
PROBE_ENTRY(walk_while, (walk_global_kernel<true, kNone>), kWalkThreads, 0, true)
PROBE_ENTRY(walk_smem, (walk_shared_kernel<16, false>), kWalkThreads, 16 * L * 4, false)
PROBE_ENTRY(row_read, row_read_kernel, L, 0, true)
PROBE_ENTRY(row_write, row_write_kernel, L, 0, true)
PROBE_ENTRY(mm_small, mm_small_kernel, kMmThreads, kMmSmem, false)
PROBE_ENTRY(onehot_row, onehot_row_kernel, kOut, 0, true)
PROBE_ENTRY(vpu_dense, vpu_dense_kernel, kOut, 0, false)
PROBE_ENTRY(roll_static, roll_static_kernel, kOut, 0, false)
PROBE_ENTRY(roll_dyn, roll_dyn_kernel, kOut, 0, false)
// mosaic_probe2.py (:24)
PROBE_ENTRY(roll_static_min, roll_static_min_kernel, kOut, 0, false)
PROBE_ENTRY(walk_smem_st, (walk_shared_kernel<16, true>), kWalkThreads, (16 * L + 2048) * 4, false)
PROBE_ENTRY(walk_smem_big, (walk_shared_kernel<128, false>), kWalkThreads, 128 * L * 4, false)
PROBE_ENTRY(smem_window_dma, smem_window_dma_kernel, kWalkThreads, 0, false)
PROBE_ENTRY(row_write_al, row_write_al_kernel, kOut, 0, true)
PROBE_ENTRY(gather_loop, gather_loop_kernel, L, 256 * L * 2, false)
PROBE_ENTRY(scatter_loop, scatter_loop_kernel, L, 256 * L * 4, false)

#undef PROBE_ENTRY

// mosaic_probe5.py:102 time_walk: the five configurations of its main()
// (chains, rows) = (1, 144), (2, 144), (2, 288), (4, 144) in shared memory
// and (4, 576) in global memory (294,912 B exceed a block's shared memory).
int probe_walk_launch(const void* d, int rows, int chains, int k, void* out, void* cycles,
                      void* stream) {
  const int key = rows * 8 + chains;
  switch (key) {
    case 144 * 8 + 1:
      return run_probe(chain_walk_kernel<1, 144, true>, kWalkThreads, 144 * L * 4, false, d, k,
                       out, cycles, stream);
    case 144 * 8 + 2:
      return run_probe(chain_walk_kernel<2, 144, true>, kWalkThreads, 144 * L * 4, false, d, k,
                       out, cycles, stream);
    case 288 * 8 + 2:
      return run_probe(chain_walk_kernel<2, 288, true>, kWalkThreads, 288 * L * 4, false, d, k,
                       out, cycles, stream);
    case 144 * 8 + 4:
      return run_probe(chain_walk_kernel<4, 144, true>, kWalkThreads, 144 * L * 4, false, d, k,
                       out, cycles, stream);
    case 576 * 8 + 4:
      return run_probe(chain_walk_kernel<4, 576, false>, kWalkThreads, 0, true, d, k, out,
                       cycles, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mosaic_probe5.py:39 smem_cap: one launch with `bytes` of dynamic shared
// memory (a multiple of 4).  Returns cudaErrorInvalidValue when the card
// refuses that much for a block, another CUDA error, or 0.
int probe_smem_cap_launch(const void* kvec, long long bytes, void* out, void* stream) {
  if (bytes < 4 || bytes % 4 || bytes > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return run(smem_cap_kernel, L, static_cast<int>(bytes), false, stream,
             static_cast<const int32_t*>(kvec), bytes / 4, static_cast<int32_t*>(out));
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
