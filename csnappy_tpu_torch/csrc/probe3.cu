// Walk-form, tensor-core, wide-gather, scan and lane-gather probes for Hopper (sm_90a).
//
// Replaces the Mosaic probes of three of the JAX package's tools: the twenty
// of tools/mosaic_probe3.py (pl.pallas_call at :32), the eleven of
// tools/mosaic_probe3b.py (:35) and the eight of tools/mosaic_probe3c.py
// (:27).  Each kernel computes what its TPU kernel computes: the same int32
// (8, 128) output for the same K, input and walk table, 32-bit sums wrapping
// (uint32 arithmetic, cast back).  Scratch that a TPU kernel reads before it
// writes holds INT32_MIN, the Pallas interpreter's fill of unwritten int32
// scratch, so the answers are defined.
//
// What bounds them on this card: latency, by design.  A probe loops K times
// inside one launch, each iteration depending on the last, so the slope of
// its time in K is the cost of one iteration.  Its bytes (a 152 KiB input,
// a table of at most 144 KiB, a 4 KiB output) and operations are small
// beside that.  Thread 0 of block 0 times its loop with clock64() and writes
// the cycles to `cycles` (inrow_round, over 128 blocks: the slowest warp's
// span; its time is the CUDA-event slope).  Nothing of the work is left
// out because only part of it reaches the output: every product, gather,
// scan and chain is done every iteration and its result kept (in
// registers, shared memory or the global scratch `g_state`), as the TPU
// kernel computes it whole.
//
// Design, per family:
// * walks (mosaic_probe3.py :46-172, :206, :352; mosaic_probe3b.py :52-143)
//   — the walk table and the tag scratch staged into shared memory, one
//   thread walks: a dependent shared load a step, tag stores where the TPU
//   kernel stores.  Loads and stores go through a shared address computed
//   once in volatile PTX, so the compiler keeps the base in a register
//   instead of re-deriving the block's shared window in the loop.  The 2-D
//   (160, 128) tag stores of mosaic_probe3b.py are flat stores at
//   row * 128 + lane: the same address.  mosaic_probe3b.py's table and tags
//   take 229,376 of a block's 232,448 bytes.  The walk tables are drawn from
//   [1, 2^20) or [1, 2^22), so v > 0 always holds: the encoder walks always
//   take the match arm; walk_enc keeps its branch as a branch all the same,
//   because the branch is what it measures against walk_enc_nobr;
// * products (vec_only, vec_scal, dot_s8, dot_bf16_256) — tensor cores.
//   The (8, 128) @ (128, 128) bf16 chain computed transposed, y^T = m^T x^T,
//   so that x's 8 rows are the N = 8 of mma.sync m16n8k16: m^T held in
//   registers by four warps for the whole launch, the carry handed on as
//   bf16 y^T rows through 2 KiB of shared memory, read back as B fragments
//   by ldmatrix .trans, one barrier of the four warps a product; vec_scal
//   adds a fifth warp whose one thread walks the 256 steps while the four
//   run the products (warp-specialised; both meet at a barrier once an
//   iteration), over a table staged as next addresses, one shared load a
//   step.  The
//   (128, 256) @ (256, 128) products on Hopper's wgmma (csrc/wgmma.cuh):
//   two warpgroups of 64 rows each, both operands K-major in shared memory,
//   int8 with int32 sums (8 m64n128k32 steps) or bf16 with float sums (16
//   m64n128k16), the whole product issued every iteration though it does
//   not depend on i, one warpgroup's product running while the other's
//   rows are added; their bound is one SM's tensor-core rate, as a probe
//   is one block.  Float results convert to int32 as XLA does: toward zero,
//   saturating, NaN to 0;
// * wide gathers (15 probes, one template) — the one-hot products and limbs
//   are the TPU's way to gather; here the R x 128 table is staged into
//   shared memory and 1024 threads gather the E values by address every
//   iteration into a shared (1, E) vector, of which the first 128 are added
//   to the carry; the value keeps its low 8 * limbs (7 * limbs for int8)
//   bits, as the limbs do;
// * scatter-adds — a (256, 128) shared histogram takes the 2048 values with
//   shared atomicAdd, rows 0-7 are added to the carry, the bins written are
//   cleared; the limbs recombine exactly, so both probes are one kernel;
// * scans — one block-wide row-major inclusive scan of (256, 128) an
//   iteration: 32 elements a thread (a quarter row) in registers, a
//   shuffle scan over a row's four quarters, one warp's scan over the 256
//   row totals, the result stored to shared memory (padded off one bank)
//   and rows 0-7 added;
//   scan_tril carries its row totals mod 2^24 (its three 8-bit limbs) and
//   wraps at 32 bits, scan_mm_cur saturates every sum at 2^23 (the port's
//   own copy of scan2d_mm(op="addsat", bits=24));
// * lane gathers (take_along_axis) — one thread a chain, every element of
//   the carry its own dependent chain: (256, 128) over 32 blocks, each with
//   the whole base in shared memory; (128, 2048) over 256 blocks (all
//   resident at once on 132 SMs), each with d[:, 0], since
//   base[r, c] = d[r, 0] + c;
// * inrow_round — a row reads only itself, so one warp owns one row (four
//   values a lane in registers, a gather two shuffles and a byte permute)
//   and the 256 rows spread over 128 blocks of two warps: no barrier in the
//   round loop.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int L = 128;
constexpr int kOut = 8 * L;                      // the (8, 128) output
constexpr int32_t kUnwritten = INT_MIN;          // the interpreter's fill of scratch
constexpr uint32_t kN1d = 16384;                 // mosaic_probe3.py N1D
constexpr uint32_t kNBig = 36864;                // mosaic_probe3.py NBIG
constexpr uint32_t kNt = 36864;                  // mosaic_probe3b.py NT
constexpr int kWalkThreads = 256;                // stage the table; thread 0 walks
constexpr int kBlock = 1024;                     // gathers, scatters, scans, chains

// The chains of taa_ax0_128x2048 (and of the (256, 128) lane gathers) end
// here, where the TPU kernel's carry would be: only rows 0-7 of columns
// 0-127 reach the output.
__device__ int32_t g_state[L * 2048];

__device__ __forceinline__ void fill_out(int32_t* out, int32_t v) {
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) out[i] = v;
}

// The shared-memory address of `p`, computed in volatile PTX so that the
// compiler keeps it in a register (see csrc/probe.cu, smem_window_dma).
__device__ __forceinline__ uint32_t smem_addr_opaque(const void* p) {
  uint32_t addr;
  asm volatile("{\n\t.reg .u64 a;\n\tcvta.to.shared.u64 a, %1;\n\tcvt.u32.u64 %0, a;\n\t}"
               : "=r"(addr)
               : "l"(p));
  return addr;
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// XLA's float -> int32 convert: toward zero, saturating, NaN to 0.
__device__ __forceinline__ int32_t sat_int(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return static_cast<int32_t>(f);
}

// ------------------------------------------------------------------ walks
//
// A walk is a struct: kTable table entries and kTags tag entries of shared
// memory, and run(tab, tags, k), the walk itself on thread 0 from the two
// shared addresses, returning the kernel's scalar result.

// mosaic_probe3.py:46 k_walk_1d (kUnroll 1) and :60 k_walk_1d_u4 (4):
// v = t[p]; tags[tc] = p; p = (p + (v & 63) + 1) & 16383; tc += v != 0.
template <int kUnroll>
struct Walk1d {
  static constexpr int kTable = kN1d, kTags = 2048;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t v = lds(tab + 4 * p);
        sts(tags + 4 * tc, p);
        p = (p + (v & 63u) + 1u) & (kN1d - 1);
        tc = (tc + (v != 0u)) & 2047u;
      }
    }
    return p + tc + lds(tags);
  }
};

// mosaic_probe3.py:77 k_walk_il4: four chains from 0, 11, 217, 3001, their
// loads issued together, tags at tc .. tc + 3.
struct WalkIl4 {
  static constexpr int kTable = kN1d, kTags = 2052;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p0 = 0, p1 = 11, p2 = 217, p3 = 3001, tc = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v0 = lds(tab + 4 * p0), v1 = lds(tab + 4 * p1);
      const uint32_t v2 = lds(tab + 4 * p2), v3 = lds(tab + 4 * p3);
      sts(tags + 4 * tc, p0);
      sts(tags + 4 * (tc + 1), p1);
      sts(tags + 4 * (tc + 2), p2);
      sts(tags + 4 * (tc + 3), p3);
      p0 = (p0 + (v0 & 63u) + 1u) & (kN1d - 1);
      p1 = (p1 + (v1 & 63u) + 1u) & (kN1d - 1);
      p2 = (p2 + (v2 & 63u) + 1u) & (kN1d - 1);
      p3 = (p3 + (v3 & 63u) + 1u) & (kN1d - 1);
      tc = (tc + 4u) & 2047u;
    }
    return p0 + p1 + p2 + p3 + tc + lds(tags);
  }
};

// mosaic_probe3.py:101 k_walk_dec_real: the walk with its error and end
// checks as written; its `done & 0` leaves every step live, which the
// compiler may see as the TPU's could.
struct WalkDecReal {
  static constexpr int kTable = kN1d, kTags = 2048;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0, err = 0, done = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = lds(tab + 4 * p);
      const uint32_t live = done == 0u;
      const uint32_t take = (v != 0u) & (done == 0u);
      sts(tags + 4 * tc, p);
      err |= live - take;
      done |= 1u - take;
      p = (p + (v & 63u) + 1u) & (kN1d - 1);
      done &= (p != kN1d - 1) | 1u;
      tc = (tc + take) & 2047u;
      done &= 0u;
    }
    return p + tc + err + done + lds(tags);
  }
};

// mosaic_probe3.py:120 k_walk_enc (a branch: the data always takes the
// match arm) and :150 k_walk_enc_nobr (both tag slots stored every step);
// tb1 and tb2 are 2048 entries each.
struct WalkEnc {
  static constexpr int kTable = kN1d, kTags = 4096;
  __device__ static uint32_t run(uint32_t tab, uint32_t tb1, int k) {
    const uint32_t tb2 = tb1 + 4 * 2048;
    uint32_t p = 0, lits = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = lds(tab + 4 * p);
      if (static_cast<int32_t>(v) > 0) {
        const uint32_t ml = (v >> 15) & 63u;
        sts(tb1 + 4 * tc, lits | ((p - lits) << 15));
        sts(tb2 + 4 * tc, 0u);
        const uint32_t tc2 = (tc + (lits < p)) & 2047u;
        sts(tb1 + 4 * tc2, p | (ml << 15));
        sts(tb2 + 4 * tc2, v & 0x7FFFu);
        p = lits = p + ml + 4u;
        tc = (tc2 + 1u) & 2047u;
      } else {
        p = p + (v & 31u) + 1u;
      }
      p &= kN1d - 1;
      lits &= kN1d - 1;
    }
    return p + lits + tc + lds(tb1) + lds(tb2);
  }
};

struct WalkEncNobr {
  static constexpr int kTable = kN1d, kTags = 4096;
  __device__ static uint32_t run(uint32_t tab, uint32_t tb1, int k) {
    const uint32_t tb2 = tb1 + 4 * 2048;
    uint32_t p = 0, lits = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = lds(tab + 4 * p);
      const uint32_t m = static_cast<int32_t>(v) > 0;
      const uint32_t ml = ((v >> 15) & 63u) + 4u;
      sts(tb1 + 4 * tc, lits | ((p - lits) << 15));
      sts(tb2 + 4 * tc, 0u);
      const uint32_t tc2 = (tc + (m & (lits < p))) & 2047u;
      sts(tb1 + 4 * tc2, p | (ml << 15));
      sts(tb2 + 4 * tc2, v & 0x7FFFu);
      tc = (tc2 + m) & 2047u;
      const uint32_t p2 = (p + (m ? ml : (v & 31u) + 1u)) & (kN1d - 1);
      lits = (m ? p2 : lits) & (kN1d - 1);
      p = p2;
    }
    return p + lits + tc + lds(tb1) + lds(tb2);
  }
};

// mosaic_probe3.py:196 _scal_chunk over a table staged as next addresses
// (scal_stage): entry p holds the shared address of entry
// (p + (t[p] & 63) + 1) & 16383, so a step is one shared load whose result
// is the next address.  The tag store of p, its index recovered from the
// address, is issued after that load, so it stays off the chain.  256
// steps, tc advancing every step.
__device__ __forceinline__ void scal_stage(int32_t* tab, const int32_t* __restrict__ table) {
  const uint32_t at = smem_addr_opaque(tab);
  for (int i = threadIdx.x; i < static_cast<int>(kN1d); i += blockDim.x)
    tab[i] = static_cast<int32_t>(at + 4 * ((i + (table[i] & 63) + 1) & (kN1d - 1)));
}

__device__ __forceinline__ void scal_chunk(uint32_t tab, uint32_t tags, uint32_t& a,
                                           uint32_t& tc) {
  for (int j = 0; j < 256; ++j) {
    const uint32_t p = a;
    a = lds(p);
    sts(tags + 4 * tc, (p - tab) >> 2);
    tc = (tc + 1u) & 2047u;
  }
}

// mosaic_probe3.py:206 k_scal_only, over the staged table (walk_kernel
// stages it for this walk alone).
struct ScalOnly {
  static constexpr int kTable = kN1d, kTags = 2048;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t a = tab, tc = 0;
    for (int i = 0; i < k; ++i) scal_chunk(tab, tags, a, tc);
    return ((a - tab) >> 2) + tc + lds(tags);
  }
};

// mosaic_probe3.py:352 k_big_smem: 36,864 entries % 36864, 17,408 tags % 17408
// (compile-time moduli: a multiply-high each); tags[0] + tags[17407] out.
struct BigSmem {
  static constexpr int kTable = kNBig, kTags = 17408;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t v = lds(tab + 4 * p);
      sts(tags + 4 * tc, p);
      p = (p + (v & 63u) + 1u) % kNBig;
      tc = (tc + 1u) % 17408u;
    }
    return p + tc + lds(tags) + lds(tags + 4 * 17407);
  }
};

// mosaic_probe3b.py:52 k_walk_u8: 8 steps an iteration, p masked with
// 36863 = 0x8FFF (an AND, not a modulus), tags (160, 128) stored at tc.
struct WalkU8 {
  static constexpr int kTable = kNt, kTags = 160 * L;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint32_t v = lds(tab + 4 * p);
        sts(tags + 4 * tc, p);
        tc = (tc + (v != 0u)) & 8191u;
        p = (p + (v & 63u) + 2u) & (kNt - 1);
      }
    }
    return p + tc + lds(tags);
  }
};

// One pair-table step of mosaic_probe3b.py:69 and :91: tags p and p + a
// (a = bits 17-21 of v) at tc and tc + 1.
__device__ __forceinline__ void pair_step(uint32_t tab, uint32_t tags, uint32_t& p,
                                          uint32_t& tc) {
  const uint32_t v = lds(tab + 4 * p);
  const uint32_t a = (v >> 17) & 31u;
  sts(tags + 4 * tc, p);
  sts(tags + 4 * (tc + 1), p + a);
  tc = (tc + 1u + (a != 0u)) & 8191u;
  p = (p + (v & 63u) + 2u) & (kNt - 1);
}

// mosaic_probe3b.py:69 k_walk_pair_u4: 4 pair steps an iteration.
struct WalkPairU4 {
  static constexpr int kTable = kNt, kTags = 160 * L;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) pair_step(tab, tags, p, tc);
    }
    return p + tc + lds(tags);
  }
};

// mosaic_probe3b.py:91 k_walk_dec_full: rounds of 128 pair steps while the
// last round moved p and fewer than k rounds ran.
struct WalkDecFull {
  static constexpr int kTable = kNt, kTags = 160 * L;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, tc = 0;
    bool done = false;
    for (int rounds = 0; !done && rounds < k; ++rounds) {
      const uint32_t p0 = p;
      for (int j = 0; j < 128; ++j) pair_step(tab, tags, p, tc);
      done = p == p0;
    }
    return p + tc + lds(tags);
  }
};

// mosaic_probe3b.py:121 k_walk_enc_real: the branch-free encoder walk, 4
// steps an iteration, a literal tag and a copy tag stored a step.
struct WalkEncReal {
  static constexpr int kTable = kNt, kTags = 160 * L;
  __device__ static uint32_t run(uint32_t tab, uint32_t tags, int k) {
    uint32_t p = 0, lits = 0, tc = 0;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t v = lds(tab + 4 * p);
        const uint32_t m = static_cast<int32_t>(v) > 0;
        const uint32_t ml = ((v >> 15) & 63u) + 4u;
        sts(tags + 4 * tc, lits | ((p - lits) << 15));
        const uint32_t t2 = tc + (m & (lits < p));
        sts(tags + 4 * t2, p | (ml << 15) | (v & 0x7FFFu));
        tc = (t2 + m) & 8191u;
        p = (p + (m ? ml : (v & 31u) + 2u)) & (kNt - 1);
        lits = m ? p : lits;
      }
    }
    return p + lits + tc + lds(tags);
  }
};

template <class W>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k, int32_t* out,
            long long* cycles) {
  extern __shared__ __align__(16) int32_t walk_smem[];
  __shared__ int32_t result;
  if constexpr (std::is_same_v<W, ScalOnly>) {
    scal_stage(walk_smem, table);
  } else {
    for (int i = threadIdx.x; i < W::kTable; i += blockDim.x) walk_smem[i] = table[i];
  }
  for (int i = threadIdx.x; i < W::kTags; i += blockDim.x) walk_smem[W::kTable + i] = kUnwritten;
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t tab = smem_addr_opaque(walk_smem);
    const long long t0 = clock64();
    const uint32_t r = W::run(tab, tab + 4 * W::kTable, k);
    cycles[0] = clock64() - t0;
    result = static_cast<int32_t>(r);
  }
  __syncthreads();
  fill_out(out, result);
}

template <class W>
constexpr int walk_smem_bytes() {
  return (W::kTable + W::kTags) * 4;
}

// --------------------------------------------------------------- products

// The (8, 128) @ (128, 128) chain, transposed: y^T = m^T x^T puts x's 8 rows
// in the N = 8 of mma.sync m16n8k16 (bf16 operands, float sums).  Warp w
// computes y's columns 32w..32w+31 (m-tiles 2w, 2w + 1 of y^T): m^T's rows
// for them are its A fragments, held in 64 registers for the whole launch
// (m is 0 or 1, so a fragment is a mask of bf16 ones).  Lane l's sums of
// m-tile t are y^T rows 16 t + l / 4 (+ 8), columns 2 (l % 4) and + 1;
// rounded to bf16 pairs, they are handed on to every warp as the B
// fragments of k-step t of the next product (lane l: x[l / 4] at columns
// 16 s + 2 (l % 4), + 1, and + 8) through shared memory, two turns, one
// barrier of the four warps a product: each lane stores its two pairs as
// words of y^T row-major (128 rows of 16 bytes, 2 KiB), and the readers
// take their B-fragment registers with ldmatrix .x4 .trans.  Each warp
// also turns its own pairs into the B fragments of its own two k-steps
// (movmatrix .trans), issues their products before the barrier and loads
// only the other six k-steps.  A product is then 16 mma.sync a warp (two
// independent sums an m-tile, added after), its hand-off and the barrier.
constexpr int kVecWarps = 4;                     // one a sub-partition of the SM
constexpr int kVecThreads = kVecWarps * 32;
constexpr int kVecWords = 3;                     // check words: iteration 0's products 1-3

struct VecSmem {
  uint32_t carry[2][L * 4];                      // y^T = x^T, bf16 pairs, two turns
};

// Named barrier 1 over the four product warps only.
__device__ __forceinline__ void vec_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kVecThreads) : "memory");
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t bf16_one(int32_t v) { return v & 1 ? 0x3F80u : 0u; }

// An 8 x 8 bf16 tile's fragment (lane l: row l / 4, columns 2 (l % 4) and
// + 1) turned into its transpose's.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

// Four 8 x 8 bf16 tiles, transposed, from the shared rows of 16 bytes at
// `addr` (lane 8 j + i gives row i of tile j).
__device__ __forceinline__ void ldsm_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (+)= a b: m16n8k16, A row-major (4 registers), B column-major (2).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k-step a warp's slot s of A and B fragments holds: the warp's own two
// k-steps first, the others after in order.
__device__ __forceinline__ int vec_kstep(int warp, int s) {
  if (s < 2) return 2 * warp + s;
  const int j = (s - 2) >> 1;                    // the j-th other pair of k-steps
  return 2 * (j + (j >= warp)) + (s & 1);
}

// mosaic_probe3.py:175 _vec_chunk: 8 dependent products x = bf16(x @ m);
// warp w's part, from carry turn 0 back to turn 0, both m-tiles' products
// issued before either is added up; `own` holds the B fragments of the
// warp's own k-steps from the last product.  In iteration 0 (kWords; a
// chunk of its own, so that no branch splits the others) the carry's bf16
// bits after products 1..kVecWords are summed by position into `words`
// (this lane's values only).
template <bool kWords>
__device__ __forceinline__ void vec_chunk(VecSmem& s, const uint32_t (&a)[2][8][4],
                                          uint32_t (&own)[4], int warp, int lane,
                                          unsigned long long (&words)[kVecWords]) {
  const int g = lane >> 2, q = lane & 3;
  const uint32_t at = smem_addr_opaque(s.carry[0]) + 16 * lane;
#pragma unroll
  for (int prod = 0; prod < 8; ++prod) {
    const uint32_t turn = at + (prod & 1) * sizeof(s.carry[0]);
    uint32_t b[16];                              // slot s: b[2 s], b[2 s + 1]
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = own[j];
    float c[2][2][4] = {};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k == 2) {                              // the own k-steps issued: the others' turn
        vec_sync();
#pragma unroll
        for (int j = 0; j < 3; ++j) ldsm_trans(b + 4 + 4 * j, turn + 512 * (j + (j >= warp)));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma16816(c[mt][k & 1], a[mt][k], b[2 * k], b[2 * k + 1]);
    }
    uint32_t* const dst = s.carry[(prod + 1) & 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) c[mt][0][j] += c[mt][1][j];
      // y^T rows 16 t + g (+ 8), columns 2 q, + 1: x[2 q] and x[2 q + 1] at
      // columns 16 t + g (+ 8)
      const int t = 2 * warp + mt;
      const uint32_t lo = bf16_pair(c[mt][0][0], c[mt][0][1]);
      const uint32_t hi = bf16_pair(c[mt][0][2], c[mt][0][3]);
      dst[(16 * t + g) * 4 + q] = lo;
      dst[(16 * t + 8 + g) * 4 + q] = hi;
      own[2 * mt] = transpose8x8(lo);
      own[2 * mt + 1] = transpose8x8(hi);
      if (kWords && prod < kVecWords) {
        const int e = 2 * q * L + 16 * t + g;
        words[prod] += static_cast<unsigned long long>(e + 1) * (lo & 0xFFFFu) +
                       static_cast<unsigned long long>(e + L + 1) * (lo >> 16) +
                       static_cast<unsigned long long>(e + 9) * (hi & 0xFFFFu) +
                       static_cast<unsigned long long>(e + L + 9) * (hi >> 16);
      }
    }
  }
}

// mosaic_probe3.py:187 k_vec_only (kWalk false) and :214 k_vec_scal (true):
// warps 0-3 run the product chain; for vec_scal warp 4's thread 0 walks
// the 256 steps of _scal_chunk over the staged table in shared memory
// meanwhile, and all meet at a barrier once an iteration.  The output is
// int32(x), plus p + tc + tags[0] for vec_scal; the kVecWords check words
// follow the cycles.
template <bool kWalk>
__global__ void __launch_bounds__(kVecThreads + (kWalk ? 32 : 0))
vec_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k, int32_t* out,
           long long* cycles) {
  extern __shared__ __align__(128) unsigned char vec_smem[];
  VecSmem& s = *reinterpret_cast<VecSmem*>(vec_smem);
  uint16_t* const x0 = reinterpret_cast<uint16_t*>(s.carry[0]);
  const auto half = [](int e) { return (e & 127) * 8 + (e >> 7); };   // x[n][k] in y^T
  int32_t* tab = reinterpret_cast<int32_t*>(vec_smem + sizeof(VecSmem));
  __shared__ uint32_t walk_result;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int e = t; e < kOut; e += blockDim.x)
    x0[half(e)] = static_cast<uint16_t>(bf16_one(d[e]));
  if (kWalk) {
    scal_stage(tab, table);
    for (int i = t; i < 2048; i += blockDim.x) tab[kN1d + i] = kUnwritten;
  }
  // A fragments of m^T's rows 16 (2 warp + mt) .. + 15, slot s (vec_kstep):
  // register q holds rows l / 4 (+ 8 for q odd), columns 2 (l % 4), + 1 (+ 8
  // for q >= 2) of the slot's k-step
  uint32_t a[2][8][4], own[4] = {};
  if (warp < kVecWarps) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 16 * (2 * warp + mt) + (lane >> 2) + 8 * (q & 1);
          const int col = 16 * vec_kstep(warp, sl) + 2 * (lane & 3) + 8 * (q >> 1);
          a[mt][sl][q] = bf16_one(d[col * L + row]) | bf16_one(d[(col + 1) * L + row]) << 16;
        }
      }
    }
  }
  __syncthreads();
  if (warp < kVecWarps)                          // the warp's own k-steps of the first product
    ldsm_trans(own, smem_addr_opaque(s.carry[0]) + 16 * lane + 512 * warp);
  unsigned long long words[kVecWords] = {};
  const long long t0 = clock64();
  if (warp < kVecWarps) {
    for (int i = 0; i < k; ++i) {
      if (i == 0)
        vec_chunk<true>(s, a, own, warp, lane, words);
      else
        vec_chunk<false>(s, a, own, warp, lane, words);
      if (kWalk) __syncthreads();
    }
  } else if (kWalk) {                            // warp 4: its lane 0 walks
    const uint32_t at = smem_addr_opaque(tab);
    uint32_t p = at, tc = 0;
    for (int i = 0; i < k; ++i) {
      if (t == kVecThreads) scal_chunk(at, at + 4 * kN1d, p, tc);
      __syncwarp();
      __syncthreads();
    }
    if (t == kVecThreads) walk_result = ((p - at) >> 2) + tc + lds(at + 4 * kN1d);
  }
  if (t == 0) cycles[0] = clock64() - t0;
  if (warp < kVecWarps) {
#pragma unroll
    for (int j = 0; j < kVecWords; ++j)
      atomicAdd(reinterpret_cast<unsigned long long*>(cycles + 1) + j, words[j]);
  }
  __syncthreads();
  const uint32_t add = kWalk ? walk_result : 0u;
  for (int e = t; e < kOut; e += blockDim.x) {
    const float v = __uint_as_float(static_cast<uint32_t>(x0[half(e)]) << 16);
    out[e] = static_cast<int32_t>(static_cast<uint32_t>(sat_int(v)) + add);
  }
}

constexpr int kVecSmem = static_cast<int>(sizeof(VecSmem));
constexpr int kVecScalSmem = kVecSmem + (kN1d + 2048) * 4;

// The (128, 256) @ (256, 128) products on wgmma (csrc/wgmma.cuh): two
// warpgroups, each owning 64 rows of y.
constexpr int kDotThreads = 256;
constexpr int kDotRows = 64;                     // rows of y a warpgroup owns
template <typename T>
constexpr int kDotSmem = 2 * L * 256 * static_cast<int>(sizeof(T));   // A and B

template <typename T>
struct DotTraits;
template <>
struct DotTraits<signed char> {
  using Acc = int32_t;
  static constexpr int kSteps = 256 / 32;        // m64n128k32 steps over the depth of 256
  __device__ static signed char from(int v) { return static_cast<signed char>(v); }
  __device__ static void mma(int32_t (&y)[64], uint64_t a, uint64_t b, int accumulate) {
    wg::mma_s8(y, a, b, accumulate);
  }
};
template <>
struct DotTraits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kSteps = 256 / 16;        // m64n128k16 steps
  __device__ static __nv_bfloat16 from(int v) { return __float2bfloat16_rn(static_cast<float>(v)); }
  __device__ static void mma(float (&y)[64], uint64_t a, uint64_t b, int accumulate) {
    wg::mma_bf16(y, a, b, accumulate);
  }
};

// One whole product y = b^T a for this warpgroup's 64 rows, issued as one
// committed group: every k-step of the depth, the first overwriting y.
template <typename T>
__device__ __forceinline__ void dot_issue(typename DotTraits<T>::Acc (&y)[64], uint64_t a,
                                          uint64_t b) {
  wg::hold(y);
  wg::fence();
#pragma unroll
  for (int s = 0; s < DotTraits<T>::kSteps; ++s)
    DotTraits<T>::mma(y, a + s * wg::step(L), b + s * wg::step(L), s > 0);
  wg::commit();
}

// acc += y[0:8] + i on warp 0 of warpgroup 0, which holds rows 0-7 of y in
// accumulators 4n and 4n + 1; a float sum converts as XLA's convert does
// (cvt.rzi saturates and maps NaN to 0).
__device__ __forceinline__ int32_t dot_int(int32_t v) { return v; }
__device__ __forceinline__ int32_t dot_int(float v) { return __float2int_rz(v); }

template <typename Acc>
__device__ __forceinline__ void dot_fold(uint32_t (&acc)[32], const Acc (&y)[64], int i) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    acc[2 * n] += static_cast<uint32_t>(dot_int(y[4 * n])) + i;
    acc[2 * n + 1] += static_cast<uint32_t>(dot_int(y[4 * n + 1])) + i;
  }
}

// mosaic_probe3.py:229 k_dot_s8 (T = signed char) and :245 k_dot_bf16_256
// (bf16): y = b^T a with a = d[0:256] & 1, b = d[0:256] & 0x7F, acc +=
// y[0:8] + i.  A = b^T and B = a are staged once, K-major (A's row i is
// column i of b, B's row j column j of a), and every iteration each
// warpgroup issues the whole product of its 64 rows from shared memory,
// the sums in registers, and waits for it.  The tensor cores stay busy
// through a fold because the other warpgroup's product runs meanwhile (a
// second accumulator set, product i + 1 in flight during fold i, is what
// ptxas serializes: its warning C7514).  The product does
// not depend on i, but wgmma is volatile asm issued every iteration:
// nothing is hoisted.
template <typename T>
__global__ void __launch_bounds__(kDotThreads)
dot_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k, int32_t* out,
           long long* cycles) {
  extern __shared__ __align__(128) unsigned char dot_smem[];
  T* const at = reinterpret_cast<T*>(dot_smem);                     // A = b^T, (128, 256)
  T* const bt = at + L * 256;                                       // B = a, as (128, 256)
  const int t = threadIdx.x, lane = t & 31;
  for (int e = t; e < 256 * L; e += kDotThreads) {
    const int r = e >> 7, c = e & 127;                              // d[r][c]: depth r, row c
    const int x = wg::core_offset(L, c, r * static_cast<int>(sizeof(T))) / sizeof(T);
    at[x] = DotTraits<T>::from(d[e] & 0x7F);
    bt[x] = DotTraits<T>::from(d[e] & 1);
  }
  wg::fence_shared();
  __syncthreads();
  const uint64_t da = wg::desc(wg::smem_addr(at) + (t >> 7) * (kDotRows / 8) * 128, L);
  const uint64_t db = wg::desc(wg::smem_addr(bt), L);
  typename DotTraits<T>::Acc y[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) y[j] = 0;
  uint32_t acc[32] = {};
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    dot_issue<T>(y, da, db);
    wg::wait();
    wg::hold(y);
    if (t < 32) dot_fold(acc, y, i);
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - t0;
  if (t < 32) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int e = (lane >> 2) * L + 8 * n + 2 * (lane & 3);
      out[e] = static_cast<int32_t>(acc[2 * n]);
      out[e + 1] = static_cast<int32_t>(acc[2 * n + 1]);
    }
  }
}

// ------------------------------------------------------- gathers, scatters

// mosaic_probe3.py:260 _wide_gather (_mk_gather, :289), mosaic_probe3b.py
// :146 (:176) and mosaic_probe3c.py:65 _wide_gather_v2 (_mk_gv2, :82): the
// E indices idx = (d.flat[:E] + i) & (R * 128 - 1) pick d.flat[idx] & kVmask
// from the (R, 128) table in shared memory into the shared (1, E) vector;
// its first 128 values are added to every row of the carry.  Index e is
// thread e % 1024's, in registers.
template <int R, int E, uint32_t kVmask>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k,
              int32_t* out, long long* cycles) {
  constexpr int kPer = E / kBlock;
  constexpr uint32_t kMask = R * L - 1;          // 0x43FF, 0x87FF: masks, not moduli
  static_assert(E % kBlock == 0 && R * L <= 304 * L, "shape");
  extern __shared__ __align__(16) int32_t gather_smem[];
  int32_t* tab = gather_smem;                    // R * 128
  uint32_t* vals = reinterpret_cast<uint32_t*>(gather_smem + R * L);   // E
  const int t = threadIdx.x;
  for (int e = t; e < R * L; e += kBlock) tab[e] = d[e];
  uint32_t base[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) base[j] = static_cast<uint32_t>(d[t + j * kBlock]);
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      vals[t + j * kBlock] = static_cast<uint32_t>(tab[(base[j] + i) & kMask]) & kVmask;
    __syncthreads();
    if (t < L) acc += vals[t];
    __syncthreads();
  }
  if (t == 0) cycles[0] = clock64() - t0;
  if (t < L)
    for (int j = 0; j < 8; ++j) out[j * L + t] = static_cast<int32_t>(acc);
}

// mosaic_probe3b.py:188 _mk_scatter(256, 2048, limbs): h[pos] += val over a
// (256, 128) shared histogram, pos = (d.flat[:2048] + i) & 32767, val =
// d.flat[:2048] & 0x7FFF; rows 0-7 of h are added to the carry; the bins
// written are cleared for the next iteration.
__global__ void __launch_bounds__(kBlock)
scatter_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k,
               int32_t* out, long long* cycles) {
  constexpr int kE = 2048, kPer = kE / kBlock;
  extern __shared__ __align__(16) int32_t hist[];                      // 256 * 128 bins
  const int t = threadIdx.x;
  for (int e = t; e < 256 * L; e += kBlock) hist[e] = 0;
  uint32_t base[kPer], val[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    base[j] = static_cast<uint32_t>(d[t + j * kBlock]);
    val[j] = base[j] & 0x7FFFu;
  }
  __syncthreads();
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    uint32_t pos[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      pos[j] = (base[j] + i) & 32767u;
      atomicAdd(&hist[pos[j]], static_cast<int32_t>(val[j]));
    }
    __syncthreads();
    acc += static_cast<uint32_t>(hist[t]);       // rows 0-7: bins 0-1023
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) hist[pos[j]] = 0;
    __syncthreads();
  }
  if (t == 0) cycles[0] = clock64() - t0;
  out[t] = static_cast<int32_t>(acc);
}

// ------------------------------------------------------------------ scans

constexpr uint32_t kSat = 1u << 23;              // kernel_lib.SAT

template <bool kSaturate>
__device__ __forceinline__ uint32_t comb(uint32_t a, uint32_t b) {
  return kSaturate ? min(a + b, kSat) : a + b;
}

// mosaic_probe3.py:301 k_scan_tril (kSaturate false) and :337 k_scan_mm_cur
// (true): y = the row-major inclusive scan of (d[0:256] & 0x1FFFF) + (i & 1)
// over (256, 128), stored whole to shared memory, acc += y[0:8].  Thread t
// holds row t / 4, columns 32 (t % 4) .. + 31 in registers.  y's element e
// sits at e + e / 32: a warp's 32 threads store 32 elements apart, which
// unpadded would all fall in one bank.
constexpr int kScanSmem = (256 * L + 256 * L / 32) * 4;

__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

template <bool kSaturate>
__global__ void __launch_bounds__(kBlock)
scan_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k, int32_t* out,
            long long* cycles) {
  extern __shared__ __align__(16) uint32_t ybuf[];                     // (256, 128), padded
  __shared__ uint32_t rowtot[256], rowpre[256];
  const int t = threadIdx.x, lane = t & 31, q = t & 3, r = t >> 2;
  uint32_t x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = static_cast<uint32_t>(d[r * L + q * 32 + j]) & 0x1FFFFu;
  uint32_t acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const uint32_t inc = static_cast<uint32_t>(i) & 1u;
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) s = comb<kSaturate>(s, x[j] + inc);
    uint32_t g = s;                              // inclusive over the row's quarters
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, g, o, 4);
      if (q >= o) g = comb<kSaturate>(g, n);
    }
    const uint32_t before = __shfl_up_sync(0xFFFFFFFFu, g, 1, 4);
    if (q == 3) rowtot[r] = kSaturate ? g : (g & 0xFFFFFFu);   // scan_tril: 3 limbs of 8 bits
    __syncthreads();
    if (t < 32) {                                // one warp: exclusive scan of the row totals
      uint32_t v[8], run = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = rowtot[lane * 8 + j];
        run = comb<kSaturate>(run, v[j]);
      }
      uint32_t incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl = comb<kSaturate>(incl, n);
      }
      uint32_t ex = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
      if (lane == 0) ex = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rowpre[lane * 8 + j] = ex;
        ex = comb<kSaturate>(ex, v[j]);
      }
    }
    __syncthreads();
    uint32_t run = comb<kSaturate>(rowpre[r], q == 0 ? 0u : before);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      run = comb<kSaturate>(run, x[j] + inc);
      ybuf[padded(r * L + q * 32 + j)] = run;
    }
    __syncthreads();
    acc += ybuf[padded(t)];                      // rows 0-7
  }
  if (t == 0) cycles[0] = clock64() - t0;
  out[t] = static_cast<int32_t>(acc);
}

// ---------------------------------------------------------- lane gathers

// mosaic_probe3c.py:40 _mk_taa(256, 128, axis): chain (r, c) (thread
// blockIdx.x * 1024 + threadIdx.x = r * 128 + c) runs idx = (acc + i) % lim,
// acc = (base[idx, c] + 1) % lim (axis 0, lim 256) or (base[r, idx] + 1) %
// lim (axis 1, lim 128), from (r + c) % lim; base = d[0:256] in shared
// memory in each of the 32 blocks.  lim is a power of two, so % is & here
// (and for a wrapped negative sum too, as XLA's floor modulus).
template <int kAxis>
__global__ void __launch_bounds__(kBlock)
taa_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k, int32_t* out,
           long long* cycles) {
  constexpr uint32_t kLim = kAxis == 0 ? 256 : L;
  extern __shared__ __align__(16) int32_t base[];                      // (256, 128)
  const int g = blockIdx.x * kBlock + threadIdx.x, r = g >> 7, c = g & 127;
  for (int e = threadIdx.x; e < 256 * L; e += kBlock) base[e] = d[e];
  __syncthreads();
  uint32_t acc = static_cast<uint32_t>(r + c) & (kLim - 1);
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const uint32_t idx = (acc + i) & (kLim - 1);
    const int32_t y = kAxis == 0 ? base[idx * L + c] : base[r * L + idx];
    acc = static_cast<uint32_t>(y + 1) & (kLim - 1);
  }
  if (g == 0) cycles[0] = clock64() - t0;
  g_state[g] = static_cast<int32_t>(acc);
  if (r < 8) out[g] = static_cast<int32_t>(acc);
}

// mosaic_probe3c.py:40 _mk_taa(128, 2048, 0): 262,144 chains over 256
// blocks, block b holding columns 8b..8b+7 (thread = (c % 8) * 128 + r),
// base[r, c] = d[r, 0] + c from the 128 values d[:, 0] in shared memory,
// lim 128.
__global__ void __launch_bounds__(kBlock)
taa_wide_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k,
                int32_t* out, long long* cycles) {
  __shared__ int32_t col0[L];
  const int g = blockIdx.x * kBlock + threadIdx.x, r = g & 127, c = g >> 7;
  if (threadIdx.x < L) col0[threadIdx.x] = d[threadIdx.x * L];
  __syncthreads();
  uint32_t acc = static_cast<uint32_t>(r + c) & 127u;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const int32_t y = col0[(acc + i) & 127u] + c;
    acc = static_cast<uint32_t>(y + 1) & 127u;
  }
  if (g == 0) cycles[0] = clock64() - t0;
  g_state[r * 2048 + c] = static_cast<int32_t>(acc);
  if (r < 8 && c < L) out[r * L + c] = static_cast<int32_t>(acc);
}

// mosaic_probe3c.py:94 k_inrow_round: par = d[0:256] & 32767; a round:
// par[r, c] <- par[r, par[r, c] & 127] where par[r, c] >> 7 == r, every
// element read from the old par, then ^ (i & 1).  A row reads only itself,
// so one warp owns one row and no barrier wider than the warp is left: lane
// l holds columns l + 32 q in registers, two a register (par < 2^15, so
// columns l and l + 32 in one, l + 64 and l + 96 in the other), and a
// gather of column j is two shuffles from lane j % 32 and one byte permute
// that picks one of their four halves.  kWarps rows a block, 256 / kWarps
// blocks over the card.  Every row's final state goes to g_state and, as
// its check word sum_c (c + 1) par[r, c], to cycles[1 + r]; rows 0-7 to
// out.  cycles[0] is the slowest warp's clock64() span.
constexpr int kInrowWarps = 2;

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
inrow_round_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ table, int k,
                   int32_t* out, long long* cycles) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, r = blockIdx.x * kWarps + w;
  int32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = d[r * L + lane + 32 * q] & 32767;
  const long long t0 = clock64();
  for (int i = 0; i < k; ++i) {
    const uint32_t u0 = v[0] | v[1] << 16, u1 = v[2] | v[3] << 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int32_t p = v[q], j = p & 127;
      const uint32_t x0 = __shfl_sync(0xFFFFFFFFu, u0, j & 31);
      const uint32_t x1 = __shfl_sync(0xFFFFFFFFu, u1, j & 31);
      const uint32_t h2 = (j >> 4) & 6u;         // bytes 2 h, 2 h + 1 of {x1, x0}, h = j / 32
      const int32_t g = static_cast<int32_t>(__byte_perm(x0, x1, h2 | (h2 + 1) << 4) & 0xFFFFu);
      v[q] = ((p >> 7) == r ? g : p) ^ (i & 1);
    }
  }
  if (lane == 0)
    atomicMax(reinterpret_cast<unsigned long long*>(cycles),
              static_cast<unsigned long long>(clock64() - t0));
  unsigned long long word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    g_state[r * L + c] = v[q];
    if (r < 8) out[r * L + c] = v[q];
    word += static_cast<unsigned long long>(c + 1) * static_cast<uint32_t>(v[q]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) word += __shfl_xor_sync(0xFFFFFFFFu, word, o);
  if (lane == 0) cycles[1 + r] = static_cast<long long>(word);
}

// -------------------------------------------------------------- launching

using Probe3Kernel = void (*)(const int32_t*, const int32_t*, int, int32_t*, long long*);

// Launch `grid` blocks of `threads` with `smem` bytes of dynamic shared
// memory; returns the first CUDA error (cleared from the thread's last
// error), or 0.  A kernel that walks a table refuses a null one.
int run(Probe3Kernel kernel, int grid, int threads, int smem, bool needs_table, const void* d,
        const void* table, int k, void* out, void* cycles, void* stream) {
  if (k < 0 || d == nullptr || (needs_table && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(d), static_cast<const int32_t*>(table), k,
      static_cast<int32_t*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define PROBE3_ENTRY(name, kernel, grid, threads, smem, needs_table)                        \
  int probe3_##name##_launch(const void* d, const void* table, int k, void* out, void* cycles, \
                             void* stream) {                                                  \
    return run(kernel, grid, threads, smem, needs_table, d, table, k, out, cycles, stream);   \
  }
#define WALK_ENTRY(name, W) \
  PROBE3_ENTRY(name, walk_kernel<W>, 1, kWalkThreads, walk_smem_bytes<W>(), true)
#define GATHER_ENTRY(name, R, E, vmask) \
  PROBE3_ENTRY(name, (gather_kernel<R, E, vmask>), 1, kBlock, ((R) * L + (E)) * 4, false)

// mosaic_probe3.py (:32)
WALK_ENTRY(walk_1d, Walk1d<1>)
WALK_ENTRY(walk_1d_u4, Walk1d<4>)
WALK_ENTRY(walk_il4, WalkIl4)
WALK_ENTRY(walk_dec_real, WalkDecReal)
WALK_ENTRY(walk_enc, WalkEnc)
WALK_ENTRY(walk_enc_nobr, WalkEncNobr)
PROBE3_ENTRY(vec_only, vec_kernel<false>, 1, kVecThreads, kVecSmem, false)
WALK_ENTRY(scal_only, ScalOnly)
PROBE3_ENTRY(vec_scal, vec_kernel<true>, 1, kVecThreads + 32, kVecScalSmem, true)
PROBE3_ENTRY(dot_s8, dot_kernel<signed char>, 1, kDotThreads, kDotSmem<signed char>, false)
PROBE3_ENTRY(dot_bf16_256, dot_kernel<__nv_bfloat16>, 1, kDotThreads, kDotSmem<__nv_bfloat16>,
             false)
GATHER_ENTRY(gather_r136_e2048_l2, 136, 2048, 0xFFFFu)
GATHER_ENTRY(gather_r272_e2048_l2, 272, 2048, 0xFFFFu)
GATHER_ENTRY(gather_r64_e2048_l2, 64, 2048, 0xFFFFu)
GATHER_ENTRY(gather_r272_e2048_l4, 272, 2048, 0xFFFFFFFFu)
GATHER_ENTRY(gather_s8_r272_e2048_l2, 272, 2048, 0x3FFFu)
GATHER_ENTRY(gather_s8_r272_e2048_l3, 272, 2048, 0x1FFFFFu)
PROBE3_ENTRY(scan_tril, scan_kernel<false>, 1, kBlock, kScanSmem, false)
PROBE3_ENTRY(scan_mm_cur, scan_kernel<true>, 1, kBlock, kScanSmem, false)
WALK_ENTRY(big_smem, BigSmem)
// mosaic_probe3b.py (:35)
WALK_ENTRY(walk_u8, WalkU8)
WALK_ENTRY(walk_pair_u4, WalkPairU4)
WALK_ENTRY(walk_dec_full, WalkDecFull)
WALK_ENTRY(walk_enc_real, WalkEncReal)
GATHER_ENTRY(gather_r256_e8192_l2, 256, 8192, 0xFFFFu)
GATHER_ENTRY(gather_r256_e8192_l1, 256, 8192, 0xFFu)
GATHER_ENTRY(gather_r256_e4096_l2, 256, 4096, 0xFFFFu)
GATHER_ENTRY(gather_r136_e8192_l2, 136, 8192, 0xFFFFu)
GATHER_ENTRY(gather_s8_r256_e8192_l3, 256, 8192, 0x1FFFFFu)
PROBE3_ENTRY(scatter_oc256_e2048_l2, scatter_kernel, 1, kBlock, 256 * L * 4, false)
PROBE3_ENTRY(scatter_oc256_e2048_l4, scatter_kernel, 1, kBlock, 256 * L * 4, false)
// mosaic_probe3c.py (:27)
PROBE3_ENTRY(taa_ax0_256x128, taa_kernel<0>, 32, kBlock, 256 * L * 4, false)
PROBE3_ENTRY(taa_ax1_256x128, taa_kernel<1>, 32, kBlock, 256 * L * 4, false)
PROBE3_ENTRY(taa_ax0_128x2048, taa_wide_kernel, 256, kBlock, 0, false)
GATHER_ENTRY(gv2_r256_e2048_l2, 256, 2048, 0xFFFFu)
GATHER_ENTRY(gv2_r256_e4096_l2, 256, 4096, 0xFFFFu)
GATHER_ENTRY(gv2_r136_e2048_l2, 136, 2048, 0xFFFFu)
GATHER_ENTRY(gv2_r256_e2048_l1, 256, 2048, 0xFFu)
PROBE3_ENTRY(inrow_round, inrow_round_kernel<kInrowWarps>, 256 / kInrowWarps, kInrowWarps * 32,
             0, false)

#undef GATHER_ENTRY
#undef WALK_ENTRY
#undef PROBE3_ENTRY

const char* probe3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
