// Batched independent-block Snappy encode for Hopper (sm_90a): one thread
// block per Snappy block, from the raw bytes to the tag stream in one launch.
//
// Replaces csnappy_tpu/ops/encode_fused.py::_kernel (the pl.pallas_call at
// :602) AND the XLA preparation in front of it (:492-600: the 4-byte
// windows, the sort of (window, pos) keys, the LCP from carried windows,
// the un-sort, the staircase's segmented reverse cummax, lazy deferral and
// the reverse cummin of next candidates).  The JAX package kept that prep in
// XLA because sorts and scans were cheap on the TPU and gathers were not;
// on this card the opposite holds, and a 32 KiB block with every array its
// parse needs fits one SM's shared memory, where gathers are native.  So
// nothing intermediate leaves the block.  The stream is byte-identical to
// the JAX encoder at EXTRAS = 2 (354,567 B on urls.10K).
//
// Per block (bs = 1,024 .. 32,768 bytes, a multiple of 1,024; 1,024 threads):
//  0. stage the row in shared memory, zero past the caller's width and for
//     kTail bytes past bs (windows and LCP reads reach bs + 11);
//  1. most recent prior equal window: a stable LSD radix sort of the 16-bit
//     positions, four passes of 8 bits; pass k's digit of position p is the
//     byte d[p + k], so no key is stored and the sort is data-independent
//     (an all-zero page, one window 32,768 times, costs what any page
//     does).  Warp w owns the w-th 1/32 of the order; a pass scans the 256
//     x 32 (digit, warp) counts, then each warp places its elements 32 at a
//     time, ranking equal digits inside a round by __match_any_sync, and
//     counts each element's next digit into the next pass's counts under the
//     warp that will own its new slot.  Equal windows end up adjacent in
//     ascending position, so a position's sorted predecessor, when its
//     window is equal, is its cand;
//  2. LCP = 4 + the equal leading bytes of d[p + 4 ..] and d[cand + 4 ..],
//     at most 4 * EXTRAS = 8 (the JAX carried-window sum): each lane reads
//     its position's 12 bytes as aligned words and takes its predecessor's
//     from the lane before (a shuffle); has(p) = cand != NOCAND && p + 4 <=
//     blen;
//  3. the staircase: ml0(p) = min(max(segmax(p) - p, lcp(p)), min(blen - p,
//     64)) with segmax the max of j + lcp(j) over p's run of consecutive
//     candidates [p, e]: a segmented suffix max over a warp's 32 positions
//     (shuffles); where the run goes on past them, e is read from a bitmask
//     of run breaks and a per-word table of the next set bit (one block
//     suffix-min scan of 1,024 words), and since lcp <= 12 and has(j) gives
//     j + lcp(j) >= j + 4, the max past the 32 lies in [e - 8, e]: nine
//     reads replace the block-wide segmented scan;
//  4. lazy deferral (drop p when p + 1 has a match >= ml0(p) + 2 long), a
//     bitmask of the surviving matches and its next-set-bit table, which is
//     the reverse cummin nc; the successor table T[p] = nc[p + ml(p)];
//  5. the greedy commit walk p = T[p], in 32 segments of bs / 32 bytes: the
//     chain enters segment s at nc[s bs / 32 + x] for some x < 64 (the last
//     commit before it lands at most 63 bytes in, as ml <= 64), so warp s
//     walks all 64 entries to the segment's end at once (two a lane), one
//     thread chains the segments' answers (32 steps), and each warp walks
//     its chosen entry again to write its commits;
//  6. a block scan of the records' sizes; each thread writes its records'
//     tag bytes and short literals into the row staged in shared memory,
//     warps copy the long literals in pieces, and the row leaves in 16-byte
//     stores, zeros past the stream included.
//
// What bounds it on this card: the commit chain.  The bytes (32 KiB in,
// under 38 KiB out a block: 4,588,288 B for B = 64 x 32 KiB, 0.00137 ms at
// 3.35 TB/s) are nothing; the chain is one dependent shared-memory load a
// commit (2,501 commits in the longest urls.10K block x ~43 SM cycles,
// ~0.054 ms, walked by one thread).  The design walks 32 segments side by
// side, so the chain a block waits for is its longest segment's, twice,
// plus 32 steps; everything before the walk is block-parallel and
// data-independent; one block per Snappy block runs a batch's blocks side
// by side on the SMs.
//
// Shared memory at bs = 32,768: the data (32 KiB + 32), two uint16 arrays
// (the sort's ping-pong buffers; then ml0, T and the staged row in one, cand
// in the other), one 32 KiB array (the sort's two uint16 count tables, then
// the lcp and final ml bytes), the commit list, a bitmask, its next table
// and the segments' entry tables (then the long literals' pieces): 227,392 B
// of the 232,448 a block may have.
//
// Records: commit k carries the literal run before it and its copy; one last
// record carries the trailing literal up to blen.  A literal's header is 1,
// 2 or 3 bytes (len-1 < 60, < 256, else two bytes); a copy is COPY_1 iff
// len <= 11 and offset < 2048, else COPY_2 (encode_fused.py:303-471).
// The row is zero past the compressed length.  fail[b] = 1 (and length 0)
// if the walk finds more commits than `cap` or the stream would not fit the
// row, which a valid parse never gives (cap = bs / 4 + 1 bounds every one).
//
// With a non-null `stamps`, thread 0 of block b writes clock64() to
// stamps[b * kStamps + i] at the start (i = 0) and after each phase: the
// row staged (1), sorted (2), cand and lcp (3), run breaks (4), staircase
// (5), deferral, nc and T (6), entries walked (7), segments chained (8),
// commits written (9), record scan (10), records written (11), row zeroed
// (12): the phases' SM cycles.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBs = 32768;
constexpr int kRadix = 256;                    // 8-bit digits: a window's four bytes, four passes
constexpr int kCounts = kRadix * kWarps;       // a pass's counts: one per digit and warp
constexpr int kEntries = 64;                   // a segment's entries: ml <= 64
constexpr int kNoCand = 0x7FFF;
constexpr int kMaxLcp = 4 + 4 * 2;             // 4 + 4 * EXTRAS
constexpr int kMaxCopy = 64;
constexpr int kTail = 32;
constexpr int kShortLit = 32;                  // a thread copies a literal up to this long
constexpr int kPiece = 256;                    // a warp copies longer ones in pieces this long
constexpr int kStamps = 16;
constexpr int kSmemDefault = 48 * 1024;        // dynamic shared memory a launch takes unasked
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// Byte offsets of a block's shared arrays for blocks of bs bytes.
struct Layout {
  int a, b, x, commits, mask, next, entries, total;
};

__host__ __device__ constexpr Layout layout(int bs) {
  const int a = align16(bs + kTail);
  const int b = a + 2 * bs;
  const int x = b + 2 * bs;
  const int commits = x + align16(max_i(bs, 2 * 2 * kCounts));
  const int mask = commits + align16(2 * (bs / 4 + 1));
  const int next = mask + 4 * (bs / 32);
  const int entries = next + align16(2 * (bs / 32 + 1));
  return Layout{a, b, x, commits, mask, next, entries, entries + 2 * 2 * kWarps * kEntries};
}

static_assert(layout(kMaxBs).total <= 232448 - 1024, "a block's shared memory on the H100");

__device__ __forceinline__ int lit_size(int lit) {
  if (lit <= 0) return 0;
  const int rl = lit - 1;
  return 1 + (rl < 60 ? 0 : (rl < 256 ? 1 : 2)) + lit;
}

__device__ __forceinline__ int copy_size(int ml, int off) {
  return (ml <= 11 && off < 2048) ? 2 : 3;
}

// Exclusive prefix sum over the block of one value a thread; *total gets
// the block's sum.  s_warp: kWarps ints of scratch.
__device__ int block_excl_sum(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += n;
    }
    s_warp[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  const int r = s_warp[warp] + incl - v;
  __syncthreads();                               // s_warp is the next scan's
  return r;
}

// Inclusive suffix minimum over the block (thread order) of one value a thread.
__device__ int block_suffix_min(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v = min(v, n);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_down_sync(kFull, w, o);
      if (lane + o < 32) w = min(w, n);
    }
    const int later = __shfl_down_sync(kFull, w, 1);
    s_warp[lane] = lane == 31 ? INT_MAX : later;
  }
  __syncthreads();
  v = min(v, s_warp[warp]);
  __syncthreads();
  return v;
}

// next[w] = the first set bit of mask at or after bit 32 w (bs if none),
// next[bs / 32] = bs: with it, next_set reads the next set bit in O(1).
__device__ void build_next(const uint32_t* mask, uint16_t* next, int bs, int* s_warp) {
  const int nwords = bs >> 5, t = threadIdx.x;  // nwords <= kThreads
  int v = bs;
  if (t < nwords && mask[t] != 0) v = (t << 5) + __ffs(mask[t]) - 1;
  v = block_suffix_min(v, s_warp);
  if (t < nwords) next[t] = static_cast<uint16_t>(v);
  if (t == 0) next[nwords] = static_cast<uint16_t>(bs);
  __syncthreads();
}

// The first set bit of mask at or after q (bs if none; q >= bs gives bs).
__device__ __forceinline__ int next_set(const uint32_t* mask, const uint16_t* next, int q,
                                        int bs) {
  if (q >= bs) return bs;
  const uint32_t m = mask[q >> 5] >> (q & 31);
  return m ? q + __ffs(m) - 1 : next[(q >> 5) + 1];
}

// count[i] += 1 on a table of uint16 counts (no count reaches 2^16).
__device__ __forceinline__ void count_one(uint16_t* count, int i) {
  atomicAdd(reinterpret_cast<unsigned*>(count) + (i >> 1), 1u << ((i & 1) << 4));
}

// Stable LSD radix sort of the positions 0 .. bs - 1 by their windows, into
// A; C is the other buffer, count two tables of kCounts uint16.  Warp w owns
// elements [w * per, (w + 1) * per) of each pass's order; count[w * kRadix
// + digit] counts its elements of each digit, then holds where the next goes.
__device__ void sort_windows(const uint8_t* d, uint16_t* A, uint16_t* C, uint16_t* count,
                             int bs, int* s_warp, int* s_total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = bs / kWarps;                   // a multiple of 32
  const unsigned magic = 0xFFFFFFFFu / per + 1;  // __umulhi(i, magic) = i / per for i < 2^16
  for (int i = t; i < 2 * kCounts; i += kThreads) count[i] = 0;
  __syncthreads();
  for (int i = t; i < bs; i += kThreads) {       // the identity order's counts
    A[i] = static_cast<uint16_t>(i);
    count_one(count, __umulhi(i, magic) * kRadix + d[i]);
  }
  __syncthreads();
  constexpr int kPer = kCounts / kThreads;
  const unsigned below = (1u << lane) - 1;
  uint16_t* src = A;
  uint16_t* dst = C;
  for (int k = 0; k < 4; ++k) {
    uint16_t* cur = count + (k & 1) * kCounts;
    uint16_t* nxt = count + ((k + 1) & 1) * kCounts;
    // exclusive scan in (digit, warp) order: thread t owns digit t / 4 of
    // warps 8 (t % 4) .. 8 (t % 4) + 7
    const int dig = t >> 2, w0 = (t & 3) * kPer;
    int loc[kPer];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      loc[j] = cur[(w0 + j) * kRadix + dig];
      sum += loc[j];
    }
    int base = block_excl_sum(sum, s_warp, s_total);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      cur[(w0 + j) * kRadix + dig] = static_cast<uint16_t>(base);
      base += loc[j];
    }
    __syncthreads();
    const uint16_t* s = src + warp * per;
    uint16_t* own = cur + warp * kRadix;
    for (int r = lane; r < per; r += 32) {
      const int p = s[r];
      const int dg = d[p + k];
      const unsigned peers = __match_any_sync(kFull, dg);   // the lanes with this digit
      const int at = own[dg] + __popc(peers & below);
      dst[at] = static_cast<uint16_t>(p);
      if (k < 3) count_one(nxt, __umulhi(at, magic) * kRadix + d[p + k + 1]);
      __syncwarp();
      if (lane == __ffs(peers) - 1) own[dg] = static_cast<uint16_t>(at + __popc(peers & ~below));
      __syncwarp();
    }
    __syncthreads();
    for (int i = t; i < kCounts; i += kThreads) cur[i] = 0;   // pass k + 2 counts into it
    uint16_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();
}

__device__ __forceinline__ void stamp(int64_t* stamps, int i) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[blockIdx.x * kStamps + i] = clock64();
}

__global__ void __launch_bounds__(kThreads, 1)
encode_kernel(const uint8_t* __restrict__ data, int in_w, const int32_t* __restrict__ blens,
              int bs, int cap, uint8_t* __restrict__ comp, int ocap,
              int32_t* __restrict__ clen, int32_t* __restrict__ fail,
              int64_t* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout ly = layout(bs);
  uint8_t* d = smem;                                               // bs + kTail bytes
  uint16_t* A = reinterpret_cast<uint16_t*>(smem + ly.a);         // order; ml0; T
  uint16_t* C = reinterpret_cast<uint16_t*>(smem + ly.b);         // order; cand
  uint16_t* count = reinterpret_cast<uint16_t*>(smem + ly.x);     // the sort's counts
  uint8_t* X = smem + ly.x;                                        // then lcp; then ml
  uint16_t* commits = reinterpret_cast<uint16_t*>(smem + ly.commits);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + ly.mask);
  uint16_t* next = reinterpret_cast<uint16_t*>(smem + ly.next);
  uint32_t* entry = reinterpret_cast<uint32_t*>(smem + ly.entries);  // [kWarps][kEntries]
  uint8_t* st = reinterpret_cast<uint8_t*>(A);                     // the row, staged: after the walk
  uint2* pieces = reinterpret_cast<uint2*>(smem + ly.mask);        // long literals: after the walk
  __shared__ int s_warp[kWarps], s_base[kWarps], s_pick[kWarps];
  __shared__ int s_total, s_k, s_fail, s_pieces;

  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const uint8_t* g = data + static_cast<int64_t>(b) * in_w;
  uint8_t* o = comp + static_cast<int64_t>(b) * ocap;
  const int blen = blens[b];
  stamp(stamps, 0);

  // 0. the row, zero past in_w and past bs
  if (in_w % 16 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0) {
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (int i = t; i < bs / 16; i += kThreads)
      d4[i] = 16 * i < in_w ? g4[i] : make_uint4(0, 0, 0, 0);
  } else {
    for (int i = t; i < bs; i += kThreads) d[i] = i < in_w ? g[i] : 0;
  }
  if (t < kTail) d[bs + t] = 0;
  if (t == 0) s_pieces = 0;
  __syncthreads();
  stamp(stamps, 1);

  // 1. four stable passes, byte 0 first: equal windows adjacent, positions ascending
  sort_windows(d, A, C, count, bs, s_warp, &s_total);
  stamp(stamps, 2);

  // 2. cand by position (C) and lcp where has, else 0 (X): warp w takes
  //    sorted slots [w * per, (w + 1) * per), 32 consecutive ones a round, so
  //    a slot's predecessor is the lane before's (the last lane's of the
  //    round before, for lane 0)
  const uint32_t* dw = reinterpret_cast<const uint32_t*>(d);
  auto words = [&](int p, uint32_t& v0, uint32_t& v1, uint32_t& v2) {
    const int sh = (p & 3) * 8;
    const uint32_t* w = dw + (p >> 2);
    const uint32_t a0 = w[0], a1 = w[1], a2 = w[2], a3 = w[3];
    v0 = __funnelshift_r(a0, a1, sh);
    v1 = __funnelshift_r(a1, a2, sh);
    v2 = __funnelshift_r(a2, a3, sh);
  };
  {
    const int per = bs / kWarps;
    int q = 0;                                   // lane 31's slot of the round before
    uint32_t u0 = 0, u1 = 0, u2 = 0;
    if (warp > 0) {
      q = A[warp * per - 1];
      words(q, u0, u1, u2);
    }
    for (int r = lane; r < per; r += 32) {
      const int i = warp * per + r;
      const int p = A[i];
      uint32_t v0, v1, v2;
      words(p, v0, v1, v2);
      const int pq = __shfl_up_sync(kFull, p, 1);
      const uint32_t p0 = __shfl_up_sync(kFull, v0, 1), p1 = __shfl_up_sync(kFull, v1, 1),
                     p2 = __shfl_up_sync(kFull, v2, 1);
      if (lane > 0) {
        q = pq;
        u0 = p0;
        u1 = p1;
        u2 = p2;
      }
      int c = kNoCand, x = 0;
      if (i > 0 && u0 == v0) {
        c = q;
        if (p + 4 <= blen) {
          const uint32_t e1 = v1 ^ u1, e2 = v2 ^ u2;
          x = e1 ? 4 + ((__ffs(e1) - 1) >> 3) : (e2 ? 8 + ((__ffs(e2) - 1) >> 3) : kMaxLcp);
        }
      }
      C[p] = static_cast<uint16_t>(c);
      X[p] = static_cast<uint8_t>(x);
      q = __shfl_sync(kFull, p, 31);             // lane 0's predecessor next round
      u0 = __shfl_sync(kFull, v0, 31);
      u1 = __shfl_sync(kFull, v1, 31);
      u2 = __shfl_sync(kFull, v2, 31);
    }
  }
  __syncthreads();
  stamp(stamps, 3);

  // 3. run breaks: p ends its run of consecutive candidates unless p and
  //    p + 1 both match and cand(p + 1) = cand(p) + 1
  for (int p = t; p < bs; p += kThreads) {
    const bool consec = X[p] != 0 && p + 1 < bs && X[p + 1] != 0 && C[p + 1] == C[p] + 1;
    const unsigned bits = __ballot_sync(kFull, !consec);
    if (lane == 0) mask[p >> 5] = bits;
  }
  __syncthreads();
  build_next(mask, next, bs, s_warp);
  stamp(stamps, 4);
  //    the staircase, ml0 where has, else 0 (A): lanes hold 32 consecutive
  //    positions; a segmented suffix max over the lanes, then, where the run
  //    goes on past the 32, the max of the next run's end (at most 9 reads)
  for (int p = t; p < bs; p += kThreads) {
    const int lcp = X[p];
    // v | f << 16: the max so far and whether a run ends in the lanes taken
    int vf = (lcp != 0 ? p + lcp : 0) | ((mask[p >> 5] >> lane) & 1) << 16;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_down_sync(kFull, vf, o);
      if (lane + o < 32) vf = vf >> 16 ? vf : (max(vf, n & 0xFFFF) | (n & 0x10000));
    }
    int v = vf & 0xFFFF;
    const bool f = vf >> 16;
    if (__any_sync(kFull, !f)) {                 // the run goes on at q = the next 32's first
      const int q = (p | 31) + 1;
      const int e = next_set(mask, next, q, bs);
      const int j = max(q, e - (kMaxLcp - 4)) + lane;
      int h = 0;
      if (j <= e) {
        const int x = X[j];
        h = x != 0 ? j + x : 0;
      }
      for (int o = 16; o > 0; o >>= 1) h = max(h, __shfl_xor_sync(kFull, h, o));
      if (!f) v = max(v, h);
    }
    A[p] = static_cast<uint16_t>(lcp != 0 ? min(max(v - p, lcp), min(blen - p, kMaxCopy)) : 0);
  }
  __syncthreads();
  stamp(stamps, 5);

  // 4. lazy deferral; the surviving matches' ml (X) and bitmask: nc
  for (int p = t; p < bs; p += kThreads) {
    const int m0 = A[p];
    const int m1 = p + 1 < bs ? A[p + 1] : 0;
    const bool keep = m0 != 0 && !(m1 != 0 && m1 >= m0 + 2);
    X[p] = static_cast<uint8_t>(keep ? m0 : 0);
    const unsigned bits = __ballot_sync(kFull, keep);
    if (lane == 0) mask[p >> 5] = bits;
  }
  __syncthreads();
  build_next(mask, next, bs, s_warp);
  //    successors T[p] = nc[p + ml(p)] (A)
  for (int p = t; p < bs; p += kThreads) {
    const int m = X[p];
    if (m != 0) A[p] = static_cast<uint16_t>(next_set(mask, next, p + m, bs));
  }
  __syncthreads();
  stamp(stamps, 6);

  // 5. the walk: warp s walks entries nc[s0 + x], x < kEntries, two a lane,
  //    to the end of its segment [s0, s1), keeping each entry's commits and
  //    where its last copy lands (the entry point itself if it has none)
  const int seg = bs / kWarps, s0 = warp * seg, s1 = s0 + seg;
  {
    const int qa = s0 + lane, qb = qa + 32;
    int pa = next_set(mask, next, qa, bs), pb = next_set(mask, next, qb, bs);
    int ca = 0, cb = 0, la = qa, lb = qb;
    while ((pa < s1 && ca <= seg) || (pb < s1 && cb <= seg)) {
      if (pa < s1 && ca <= seg) { ++ca; la = pa + X[pa]; pa = A[pa]; }
      if (pb < s1 && cb <= seg) { ++cb; lb = pb + X[pb]; pb = A[pb]; }
    }
    entry[warp * kEntries + lane] = static_cast<uint32_t>(ca) | static_cast<uint32_t>(la) << 16;
    entry[warp * kEntries + lane + 32] = static_cast<uint32_t>(cb) | static_cast<uint32_t>(lb) << 16;
  }
  __syncthreads();
  stamp(stamps, 7);
  if (t == 0) {                                  // chain the segments from position 0
    int land = 0, k = 0, bad = 0;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) {
      const int x = min(max(land - s * seg, 0), kEntries - 1);
      const uint32_t e = entry[s * kEntries + x];
      const int c = e & 0xFFFF;
      bad |= c > seg;                            // a successor that does not advance
      s_base[s] = k;
      s_pick[s] = x;
      k += c;
      land = e >> 16;
    }
    s_k = k;
    s_fail = bad || k > cap;
  }
  __syncthreads();
  stamp(stamps, 8);
  if (!s_fail && lane == 0) {                    // each segment's commits, in order
    int p = next_set(mask, next, s0 + s_pick[warp], bs), k = s_base[warp];
    while (p < s1) {
      commits[k++] = static_cast<uint16_t>(p);
      p = A[p];
    }
  }
  __syncthreads();
  stamp(stamps, 9);

  const int K = s_k;
  const int nrec = K + 1;
  // record r: literal [prev_end, pos) then, for r < K, the copy at pos
  auto fields = [&](int r, int& prev_end, int& pos, int& ml, int& off) {
    prev_end = 0;
    if (r > 0) {
      const int pp = commits[r - 1];
      prev_end = pp + X[pp];
    }
    if (r < K) {
      pos = commits[r];
      ml = X[pos];
      off = pos - C[pos];
    } else {
      pos = blen;
      ml = 0;
      off = 0;
    }
  };

  // 6. block-wide exclusive scan of record sizes: each thread owns a run
  const int per = (nrec + kThreads - 1) / kThreads;
  const int r0 = min(nrec, t * per), r1 = min(nrec, r0 + per);
  int local = 0;
  if (!s_fail) {
    for (int r = r0; r < r1; ++r) {
      int prev_end, pos, ml, off;
      fields(r, prev_end, pos, ml, off);
      local += lit_size(pos - prev_end) + (ml > 0 ? copy_size(ml, off) : 0);
    }
  }
  int at = block_excl_sum(local, s_warp, &s_total);
  const int bad = s_fail || s_total > ocap;
  const int total = bad ? 0 : s_total;
  stamp(stamps, 10);
  if (!bad) {
    for (int r = r0; r < r1; ++r) {              // tags and short literals; long ones' pieces
      int prev_end, pos, ml, off;
      fields(r, prev_end, pos, ml, off);
      const int lit = pos - prev_end;
      if (lit > 0) {
        const int rl = lit - 1;
        const int ext = rl < 60 ? 0 : (rl < 256 ? 1 : 2);
        st[at] = static_cast<uint8_t>(ext == 0 ? rl << 2 : (59 + ext) << 2);
        if (ext >= 1) st[at + 1] = static_cast<uint8_t>(rl & 0xFF);
        if (ext == 2) st[at + 2] = static_cast<uint8_t>(rl >> 8);
        at += 1 + ext;
        if (lit <= kShortLit) {
          for (int j = 0; j < lit; ++j) st[at + j] = d[prev_end + j];
        } else {
          const int n = (lit + kPiece - 1) / kPiece;
          const int i0 = atomicAdd(&s_pieces, n);
          for (int j = 0; j < n; ++j)
            pieces[i0 + j] = make_uint2(prev_end + j * kPiece,
                                        (at + j * kPiece) | min(kPiece, lit - j * kPiece) << 16);
        }
        at += lit;
      }
      if (ml > 0) {
        if (ml <= 11 && off < 2048) {
          st[at] = static_cast<uint8_t>(1 | ((ml - 4) << 2) | ((off >> 8) << 5));
          st[at + 1] = static_cast<uint8_t>(off & 0xFF);
          at += 2;
        } else {
          st[at] = static_cast<uint8_t>(2 | ((ml - 1) << 2));
          st[at + 1] = static_cast<uint8_t>(off & 0xFF);
          st[at + 2] = static_cast<uint8_t>(off >> 8);
          at += 3;
        }
      }
    }
  }
  const int z16 = min(ocap, align16(total));     // the staged row is zero up to a 16-byte boundary
  if (t < z16 - total) st[total + t] = 0;
  __syncthreads();
  for (int i = warp; i < s_pieces; i += kWarps) {   // one warp a piece of a long literal
    const uint2 pc = pieces[i];
    const int dst = pc.y & 0xFFFF, n = pc.y >> 16;
    for (int j = lane; j < n; j += 32) st[dst + j] = d[pc.x + j];
  }
  __syncthreads();
  stamp(stamps, 11);
  // the row out: the stream, then zeros, 16 bytes a thread where aligned
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0 && ocap % 16 == 0) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    const uint4* s4 = reinterpret_cast<const uint4*>(st);
    for (int i = t; i < ocap / 16; i += kThreads) o4[i] = 16 * i < z16 ? s4[i] : make_uint4(0, 0, 0, 0);
  } else {
    for (int i = t; i < ocap; i += kThreads) o[i] = i < total ? st[i] : 0;
  }
  if (t == 0) {
    clen[b] = total;
    fail[b] = bad;
  }
  __syncthreads();
  stamp(stamps, 12);
}

}  // namespace

extern "C" {

// Launches nblocks blocks on `stream`: rows of in_w bytes (in_w <= bs),
// blocks of bs bytes (a multiple of 1024, at most 32768), at most cap
// commits a block (1 .. bs / 4 + 1); stamps: null, or kStamps int64 a
// block.  Returns the first CUDA error, or 0.  The kernel's shared-memory
// limit is raised once per device (a bit a device), not on every launch.
int encode_blocks_launch(const void* data, int in_w, const void* blens, int bs, int cap,
                         void* comp, int ocap, void* clen, void* fail, int nblocks, void* stamps,
                         void* stream) {
  if (bs < 1024 || bs > kMaxBs || bs % 1024 != 0 || in_w < 0 || in_w > bs || cap < 1 ||
      cap > bs / 4 + 1 || ocap < 0 || ocap > 2 * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0) return 0;
  const int smem = layout(bs).total;
  if (smem > kSmemDefault) {
    static std::atomic<uint32_t> raised{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    const uint32_t bit = 1u << (dev & 31);
    if (e == cudaSuccess && !(raised.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               layout(kMaxBs).total);
      if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
    }
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  encode_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), in_w, static_cast<const int32_t*>(blens), bs, cap,
      static_cast<uint8_t*>(comp), ocap, static_cast<int32_t*>(clen),
      static_cast<int32_t*>(fail), static_cast<int64_t*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block takes for blocks of bs bytes.
int encode_blocks_smem_bytes(int bs) { return layout(bs).total; }

const char* encode_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
