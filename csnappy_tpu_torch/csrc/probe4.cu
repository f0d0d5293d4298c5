// Resolve-phase probes for Hopper (sm_90a), built on kernel_lib.cuh.
//
// Replaces the Mosaic probes of two of the JAX package's tools: the sixteen
// of tools/mosaic_probe4.py (pl.pallas_call at :37: the 4,096-wide gather
// of kernel_lib.gather_rows_multi whose indices depend on the last gather,
// by table rows and limbs; a lane gather; pointer-jumping rounds with and
// without a convergence check; a window read at a dynamic base) and the
// four flat gathers of tools/mosaic_probe6.py (:37).  Each kernel computes
// what its TPU kernel computes: the same int32 (8, 128) output for the same
// K and inputs, 32-bit sums wrapping (uint32 arithmetic, cast back) and
// jnp's floor modulus (kernel_lib::floor_mod: CUDA's % truncates, and once
// acc wraps negative a truncating % would give a negative index).  The
// fifth entry of mosaic_probe6.py, taa_4096x128, fails to trace in JAX and
// has no kernel here.
//
// What bounds them on this card: latency, by design.  A probe loops K times
// inside one launch, each iteration depending on the last, so the slope of
// its time in K is the cost of one iteration.  Thread 0 times its loop with
// clock64() and writes the cycles to `cycles`.  Every gather of every
// iteration is done, though only element (0, 0)'s chain (or rows 0-7)
// reaches the output, as the TPU kernel computes it whole.
//
// Design: one block of 1024 threads; element e = t + 1024 j of the
// (32, 128) carry is thread t's, j < 4, in registers.
// * gather_r{R}_l{limbs} — the table d[0:R] & (2^(8 limbs) - 1) staged into
//   shared memory at its masked width (uint8 or uint16: 51,200 or 102,400 B
//   at R = 400, where int32 would take 204,800 of the 232,448), each index
//   gathered by address through kernel_lib::gather (clip mode); g[0, 0]
//   reaches every thread through one shared word and one barrier (double-
//   buffered, so one barrier an iteration), and that barrier is part of
//   what the probe measures, as the TPU kernel's scalar read of g[0, 0] is;
// * lane_gather_32x128 — x in shared memory; every element reads the old x
//   (kernel_lib::gather, take mode), a barrier, all write, a barrier;
// * conv_unrolled / conv_check — x in shared memory as the table of the
//   pointer-jumping round x = x.flat[x]: read, barrier, write, barrier, four
//   rounds an iteration; conv_check counts the changed elements with
//   __syncthreads_count, which is the read barrier too, and stops after the
//   first round that changed nothing (the TPU kernel's while_loop);
// * dynslice_32 — the TPU kernel reads a 32-row window at a dynamic base
//   (pl.ds), which is what it measures, so each iteration stages that
//   16 KiB window from global memory into shared memory (one 16-byte load a
//   thread) and takes [0, 0] from it;
// * flat_gather, for mosaic_probe6's base, base_i16, el_orient and el_i16 —
//   one function (the int8 bias and int16 row compare are TPU encodings),
//   so one kernel and one entry: the (424, 128)
//   table & 0xFF staged as uint8 (54,272 B; as int32 with the index it
//   would need 233,472 B, over a block's 232,448), the index in registers,
//   acc(32, 128) += T.flat[(idx + i) & 0xD3FF] (an AND mask, as in JAX).

#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_lib.cuh"

namespace {

using kernel_lib::floor_mod;
using kernel_lib::gather;
using kernel_lib::kFlatClip;
using kernel_lib::kRowTake;
using kernel_lib::L;

constexpr int kBlock = 1024;
constexpr int kOut = 8 * L;                      // the (8, 128) output
constexpr int kRg = 32;                          // rows of the carry
constexpr int kPer = kRg * L / kBlock;           // 4 elements a thread
constexpr int kR6 = 424;                         // mosaic_probe6.py R
constexpr uint32_t kMask6 = kR6 * L - 1;         // 0xD3FF

// The chains and sums that do not reach the output end here, where the TPU
// kernel's carry would be, so that the compiler keeps every gather.
__device__ int32_t g_state[kRg * L];

__device__ __forceinline__ void fill_out(int32_t* out, int32_t v) {
  for (int i = threadIdx.x; i < kOut; i += kBlock) out[i] = v;
}

// mosaic_probe4.py:64 gather_kern(R, limbs): T = d[0:R] & mask (type T),
// idx = d[0:32] % (R * 128); each iteration g = T.flat[clip(idx)], idx =
// (g + acc + i) % (R * 128) with the old acc, acc += g[0, 0].
template <int R, typename T>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ unused, int k,
              int32_t* out, long long* cycles) {
  constexpr int kN = R * L;
  constexpr uint32_t kVmask = sizeof(T) == 1 ? 0xFFu : 0xFFFFu;
  extern __shared__ __align__(16) unsigned char gsmem[];
  T* tab = reinterpret_cast<T*>(gsmem);
  __shared__ int32_t g00[2];
  const int t = threadIdx.x;
  for (int f = t; f < kN; f += kBlock)
    tab[f] = static_cast<T>(static_cast<uint32_t>(d[f]) & kVmask);
  int32_t idx[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) idx[j] = floor_mod(d[t + j * kBlock], kN);
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    int32_t g[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) g[j] = gather(tab, kN, kFlatClip, kVmask, idx[j], 0);
    if (t == 0) g00[i & 1] = g[0];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      idx[j] = floor_mod(static_cast<int32_t>(static_cast<uint32_t>(g[j]) + acc + i), kN);
    __syncthreads();
    acc += static_cast<uint32_t>(g00[i & 1]);
  }
  if (t == 0) cycles[0] = clock64() - t0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) g_state[t + j * kBlock] = idx[j];
  fill_out(out, static_cast<int32_t>(acc));
}

// mosaic_probe4.py:79 lane_gather_kern: x = d[0:32] % 128; g[r, c] =
// x[r, x[r, c] & 127], x = (g + i) % 128, acc += g[0, 0].
__global__ void __launch_bounds__(kBlock)
lane_gather_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ unused, int k,
                   int32_t* out, long long* cycles) {
  __shared__ int32_t x[kRg * L];
  __shared__ int32_t g00;
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[t + j * kBlock] = floor_mod(d[t + j * kBlock], L);
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    int32_t g[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = t + j * kBlock;
      g[j] = gather(x, kRg * L, kRowTake, 0xFFFFFFFFu, x[e] & (L - 1), e / L);
    }
    if (t == 0) g00 = g[0];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      x[t + j * kBlock] = floor_mod(static_cast<int32_t>(static_cast<uint32_t>(g[j]) + i), L);
    acc += static_cast<uint32_t>(g00);
    __syncthreads();
  }
  if (t == 0) cycles[0] = clock64() - t0;
  fill_out(out, static_cast<int32_t>(acc));
}

// mosaic_probe4.py:92 while_conv_kern(check): x = d[0:32] % 4096; each
// iteration up to 4 rounds x = (x & 0xFFFF).flat[clip(x)] % 4096 (every
// element reads the old x); with kCheck the rounds stop after the first
// that changed nothing; acc += x[0, 0].
template <bool kCheck>
__global__ void __launch_bounds__(kBlock)
conv_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ unused, int k,
            int32_t* out, long long* cycles) {
  constexpr int kN = kRg * L;
  __shared__ int32_t x[kN];
  __shared__ int32_t acc_out;
  const int t = threadIdx.x;
  int32_t mine[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[t + j * kBlock] = mine[j] = floor_mod(d[t + j * kBlock], kN);
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    int changed = 1;
    for (int round = 0; round < 4 && (!kCheck || changed > 0); ++round) {
      int32_t g[kPer];
      int diff = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        g[j] = gather(x, kN, kFlatClip, 0xFFFFu, mine[j], 0);
        diff |= g[j] != mine[j];
      }
      if (kCheck) {
        changed = __syncthreads_count(diff);
      } else {
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[t + j * kBlock] = mine[j] = floor_mod(g[j], kN);
      __syncthreads();
    }
    acc += static_cast<uint32_t>(mine[0]);        // thread 0's element 0 is x[0, 0]
  }
  if (t == 0) {
    cycles[0] = clock64() - t0;
    acc_out = static_cast<int32_t>(acc);
  }
  __syncthreads();
  fill_out(out, acc_out);
}

// mosaic_probe4.py:118 dynslice_kern: base = ((acc + i) % 40) * 8; the
// 32-row window d[base:base + 32] staged into shared memory; acc = (acc +
// window[0, 0]) % 251.
__global__ void __launch_bounds__(kBlock)
dynslice_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ unused, int k,
                int32_t* out, long long* cycles) {
  __shared__ __align__(16) int4 win[kRg * L / 4];                      // 16 KiB
  const int t = threadIdx.x;
  const int4* src = reinterpret_cast<const int4*>(d);
  int32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const int base = floor_mod(static_cast<int32_t>(static_cast<uint32_t>(acc) + i), 40) * 8;
    win[t] = src[base * (L / 4) + t];
    __syncthreads();
    acc = floor_mod(static_cast<int32_t>(static_cast<uint32_t>(acc) +
                                         static_cast<uint32_t>(win[0].x)), 251);
    __syncthreads();
  }
  if (t == 0) cycles[0] = clock64() - t0;
  fill_out(out, acc);
}

// mosaic_probe6.py:55 mk_base(i16) and :96 mk_el(i16): acc(32, 128) +=
// T.flat[(idx + i) & 0xD3FF] & 0xFF; the output is acc[0:8].  `idx` is the
// (32, 128) index.
__global__ void __launch_bounds__(kBlock)
flat_gather_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ idx, int k,
                   int32_t* out, long long* cycles) {
  constexpr int kN = kR6 * L;
  extern __shared__ __align__(16) uint8_t tab6[];                      // 54,272 B
  uint8_t* tab = tab6;
  const int t = threadIdx.x;
  for (int f = t; f < kN; f += kBlock) tab[f] = static_cast<uint8_t>(d[f]);
  uint32_t ix[kPer], acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    ix[j] = static_cast<uint32_t>(idx[t + j * kBlock]);
    acc[j] = 0;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      acc[j] += static_cast<uint32_t>(
          gather(tab, kN, kFlatClip, 0xFFu, static_cast<int32_t>((ix[j] + i) & kMask6), 0));
  }
  if (t == 0) cycles[0] = clock64() - t0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) g_state[t + j * kBlock] = static_cast<int32_t>(acc[j]);
  out[t] = static_cast<int32_t>(acc[0]);         // rows 0-7: elements 0-1023, j = 0
}

// -------------------------------------------------------------- launching

using Probe4Kernel = void (*)(const int32_t*, const int32_t*, int, int32_t*, long long*);

// Launch one block of kBlock threads with `smem` bytes of dynamic shared
// memory; returns the first CUDA error (cleared), or 0.  A kernel that
// reads an index refuses a null one.
int run(Probe4Kernel kernel, int smem, bool needs_index, const void* d, const void* index, int k,
        void* out, void* cycles, void* stream) {
  if (k < 0 || d == nullptr || (needs_index && index == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(d), static_cast<const int32_t*>(index), k,
      static_cast<int32_t*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define PROBE4_ENTRY(name, kernel, smem, needs_index)                                         \
  int probe4_##name##_launch(const void* d, const void* index, int k, void* out, void* cycles, \
                             void* stream) {                                                  \
    return run(kernel, smem, needs_index, d, index, k, out, cycles, stream);                  \
  }
#define GATHER_ENTRY(R, limbs, T) \
  PROBE4_ENTRY(gather_r##R##_l##limbs, (gather_kernel<R, T>), (R) * L * sizeof(T), false)

// mosaic_probe4.py (:37)
PROBE4_ENTRY(lane_gather_32x128, lane_gather_kernel, 0, false)
GATHER_ENTRY(32, 1, uint8_t)
GATHER_ENTRY(32, 2, uint16_t)
GATHER_ENTRY(64, 1, uint8_t)
GATHER_ENTRY(64, 2, uint16_t)
GATHER_ENTRY(128, 1, uint8_t)
GATHER_ENTRY(128, 2, uint16_t)
GATHER_ENTRY(160, 1, uint8_t)
GATHER_ENTRY(160, 2, uint16_t)
GATHER_ENTRY(288, 1, uint8_t)
GATHER_ENTRY(288, 2, uint16_t)
GATHER_ENTRY(400, 1, uint8_t)
GATHER_ENTRY(400, 2, uint16_t)
PROBE4_ENTRY(conv_unrolled, conv_kernel<false>, 0, false)
PROBE4_ENTRY(conv_check, conv_kernel<true>, 0, false)
PROBE4_ENTRY(dynslice_32, dynslice_kernel, 0, false)
// mosaic_probe6.py (:37): base, base_i16, el_orient and el_i16 compute one
// function, so one entry serves the four names
PROBE4_ENTRY(flat_gather, flat_gather_kernel, kR6 * L, true)

#undef GATHER_ENTRY
#undef PROBE4_ENTRY

const char* probe4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
