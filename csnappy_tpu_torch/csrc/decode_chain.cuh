// Device code shared by decode_stream.cu (one crossing stream) and
// decode_wide.cu (rows wider than 32 KiB), whose kernels cut the same two
// serial chains the same way: the workspace's heads, relaxed loads and
// stores, the tag parser, the whole chain pass over 8 KiB input chunks
// (chain_block), the segment pass's window walk (window_tables,
// window_list) and the block reductions, with the constants they share.
// Each source's comment says how its kernels use them.
//
// The two decoders differ in their envelope.  parse_tag's template flag
// kLit24 is decode_stream.cu's: a literal whose 4-byte length trailer has a
// nonzero top byte (more than 2^24 bytes) is no tag.  Without it the
// trailer keeps all 32 bits, as the oracle reads it.
//
// The checked build (-DCSNAPPY_CHECKED, a library of its own that only the
// hygiene harness loads) compiles in device asserts of what the design
// relies on: shared-memory indices in range, every word of a segment
// terminal after the resolve, external bytes before the segment and behind
// a flag that was waited on, a segment with no event covering all of its
// bytes while the chain runs past them, the window and round caps never
// binding, and every chain word, stop and flag published once, by a lower
// ticket.  It also perturbs the schedule: at each JITTER(site), thread 0 of
// a block sleeps 0-16 us half the time (a hash of the SM clock, the block
// and the site), so that chain entries, stops, flags and the reads that
// wait on them interleave in orders a quiet card never makes.  Without the
// macro CHECKED(...), WHEN_CHECKED(...) and JITTER(...) are empty and the
// timed build is unchanged.

#pragma once

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#ifdef CSNAPPY_CHECKED
#include <cassert>
#define CHECKED(cond) assert(cond)
#define WHEN_CHECKED(...) __VA_ARGS__
#define JITTER(site) jitter(site)
__device__ __forceinline__ void jitter(unsigned int site) {
  unsigned int h = static_cast<unsigned int>(clock64()) * 0x9E3779B1u ^
                   (blockIdx.x + 1) * 0x85EBCA77u ^ site * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  if (h & 1) __nanosleep(h % 16384);
}
#else
#define CHECKED(cond) ((void)0)
#define WHEN_CHECKED(...)
#define JITTER(site) ((void)0)
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kS = 32768;                   // output segment
constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ the workspace

struct Head {
  unsigned int ticket;        // chunks taken
  unsigned int seg_ticket;    // segments taken
  unsigned int done;          // segment blocks finished (decode_stream.cu)
  unsigned int pad[13];
};
static_assert(sizeof(Head) == 64, "the workspace's head");

// One input's chain and first event (decode_stream.cu has one, decode_wide.cu one a row).
struct RowHead {
  unsigned long long event;   // ~(os << 1 | overrun) of the first event; 0: none
  long long p_stop, os_stop;  // where the chain stops, and the output there
  unsigned int stop;          // the chunk holding the stop + 1; 0 until known
  unsigned int pad;
};
static_assert(sizeof(RowHead) == 32, "a row's head");

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned int ld_relaxed(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void st_relaxed(unsigned int* p, unsigned int v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// A word that only one block ever publishes: the checked build asserts that
// it held 0 before.
__device__ __forceinline__ void publish_once(unsigned long long* p, unsigned long long v) {
#ifdef CSNAPPY_CHECKED
  CHECKED(atomicExch(p, v) == 0ull);
#else
  st_relaxed(p, v);
#endif
}
__device__ __forceinline__ void publish_once(unsigned int* p, unsigned int v) {
#ifdef CSNAPPY_CHECKED
  CHECKED(atomicExch(p, v) == 0u);
#else
  st_relaxed(p, v);
#endif
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A tag at b[0] (b[1..4] readable; bytes past the input read as 0), with
// `avail` input bytes from it on.  bad: no tag of the envelope starts here
// (a header or a literal's body past the input; with kLit24, a literal
// longer than 2^24).
struct Tag {
  int64_t len;      // bytes it produces
  uint32_t off;     // a copy's offset (COPY_4's full 32 bits)
  int hdr;          // header bytes
  bool lit, bad;
};

template <bool kLit24>
__device__ __forceinline__ Tag parse_tag(const uint8_t* b, int64_t avail) {
  Tag t;
  const uint32_t c = b[0];
  const uint32_t u = c >> 2;
  t.off = 0;
  t.lit = (c & 3) == 0;
  if (t.lit) {
    uint32_t v = u;
    bool over = false;
    t.hdr = 1;
    if (u >= 60) {
      const int nb = static_cast<int>(u) - 59;
      v = b[1];
      if (nb > 1) v |= static_cast<uint32_t>(b[2]) << 8;
      if (nb > 2) v |= static_cast<uint32_t>(b[3]) << 16;
      if (nb > 3) {
        if (kLit24) over = b[4] != 0;
        else v |= static_cast<uint32_t>(b[4]) << 24;
      }
      t.hdr = 1 + nb;
    }
    t.len = static_cast<int64_t>(v) + 1;
    t.bad = over || t.hdr > avail || t.hdr + t.len > avail;
  } else if ((c & 3) == 1) {
    t.hdr = 2;
    t.len = (u & 7) + 4;
    t.off = ((u >> 3) << 8) | b[1];
    t.bad = avail < 2;
  } else {
    t.hdr = (c & 3) == 2 ? 3 : 5;
    t.len = u + 1;
    t.off = b[1] | (static_cast<uint32_t>(b[2]) << 8);
    if (t.hdr == 5) t.off |= (static_cast<uint32_t>(b[3]) << 16) | (static_cast<uint32_t>(b[4]) << 24);
    t.bad = avail < t.hdr;
  }
  return t;
}

// ============================================================ the chain pass

constexpr int kLog = 13;
constexpr int kChunk = 1 << kLog;            // input positions a block
constexpr int kPer = kChunk / kThreads;
constexpr int kSubLog = 8;                   // sub-chunks of 256 positions
constexpr int kPad = 16;                     // bytes staged past the chunk
constexpr uint32_t kStop = 0x80000000u;      // P: the chain stops at J
constexpr uint32_t kExitTag = 0x40000000u;   // P: J is the tag that leaves the chunk
constexpr uint32_t kFlags = kStop | kExitTag;
// word[c]: 0 until known; (os << 17) | (entry - c * kChunk) << 2 | 1 when the
// chain enters chunk c, or 2 when it skips it
constexpr unsigned long long kEntered = 1, kSkipped = 2;
// stamps a chunk: the cycles of staged (staging and parse), jumped, waited,
// covers; then visited (1 or 0), pointer-jumping rounds, cover searches and
// the %globaltimer ns at which the chunk published its exit
constexpr int kChainStamps = 8;
constexpr int kChainSmem = 13 * kChunk + kPad;      // P1, P, J1, J, the bytes

// One pointer-jumping round over the positions a thread owns: every position
// whose pointer is not terminal (flagged, or at or past the end of its span
// of 2^kSpanLog positions) takes its target's pointer and adds its target's
// output (and flags).  Returns whether any position of the block moved.
template <int kSpanLog>
__device__ __forceinline__ bool jump_round(uint16_t* Jt, uint32_t* Pt) {
  uint16_t nj[kPer];
  uint32_t np[kPer];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int j = Jt[i];
    const uint32_t p = Pt[i];
    const int end = ((i >> kSpanLog) + 1) << kSpanLog;
    const bool live = !(p & kFlags) && j < end;
    CHECKED(j >= 0 && j < kChunk);
    nj[k] = live ? Jt[j] : static_cast<uint16_t>(j);
    np[k] = live ? Pt[j] : 0;
    any |= live;
  }
  const bool go = __syncthreads_or(any);
  if (go) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      Jt[i] = nj[k];
      Pt[i] += np[k];
    }
    __syncthreads();
  }
  return go;
}

// The last chain tag at or after x (on the chain, output start px <= bound)
// whose output start is <= bound, in a chunk that owns `bound`: hops from
// sub-chunk to sub-chunk, then tags.  Returns its position; *pq its output.
template <bool kLit24>
__device__ int last_at_or_below(int x, int64_t px, int64_t bound, const uint16_t* J1,
                                const uint32_t* P1, const uint8_t* bytes, int64_t base,
                                int64_t slen, int64_t* pq) {
  while (true) {
    CHECKED(x >= 0 && x < kChunk);
    const uint32_t p1 = P1[x];
    const int64_t py = px + (p1 & ~kFlags);
    if (py > bound) break;                      // the answer lies before J1[x]
    x = J1[x];
    px = py;
    if (p1 & kFlags) {                          // the stop or the exit tag
      *pq = px;
      return x;
    }
  }
  while (true) {
    const Tag t = parse_tag<kLit24>(bytes + x, slen - base - x);
    const int64_t z = x + t.hdr + (t.lit ? t.len : 0);
    const int64_t pz = px + t.len;
    if (t.bad || pz > bound || z >= kChunk) break;
    x = static_cast<int>(z);
    px = pz;
  }
  *pq = px;
  return x;
}

// What a block of the chain pass works on: chunk c of one input,
// src[0:slen], whose output has nseg segments; the input's head, its
// chunks' words and its segments' covers; this block's kChainStamps int64,
// or null.
struct ChainJob {
  const uint8_t* src;
  int64_t slen;
  RowHead* row;
  unsigned long long* word;
  int64_t* cover_os;
  int32_t* cover_pos;
  int64_t* stamps;
  int c, nseg;
};

// One block of the chain pass.  Thread 0 calls take(), which takes the
// block's ticket and returns its ChainJob.  The block stages its chunk (plus a 16-byte
// halo), parses every position as if a tag started there and pointer-jumps
// in shared memory, first inside sub-chunks of 256 positions, then to the
// chunk's end; then waits for its entry, publishes the next (or the stop),
// marks the chunks a literal skips, and writes the covering tag (the last
// chain tag whose output start is <= k * 32768) of every segment k whose
// start falls in its output.  A chunk known to be skipped or past the stop
// builds no tables.
template <bool kLit24, typename Take>
__device__ __forceinline__ void chain_block(Take take) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* P1 = reinterpret_cast<uint32_t*>(smem);   // output to the sub-chunk's exit
  uint32_t* P = P1 + kChunk;                          // output to the chunk's stop or exit tag
  uint16_t* J1 = reinterpret_cast<uint16_t*>(P + kChunk);
  uint16_t* J = J1 + kChunk;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(J + kChunk);   // kChunk + kPad
  __shared__ ChainJob s_job;
  __shared__ int s_state, s_entry, s_stops;
  __shared__ long long s_pp, s_out, s_stop_at;
  __shared__ long long s_cyc[kChainStamps];
  const int tid = threadIdx.x;
  long long last = 0;

  if (tid == 0) {
    JITTER(1);                                // before the ticket
    const ChainJob j = take();
    s_job = j;
    // known not to be entered already (skipped, or past the stop): no tables
    const unsigned long long w = j.c == 0 ? kEntered : ld_relaxed(&j.word[j.c]);
    const unsigned int st = j.c == 0 ? 0 : ld_relaxed(&j.row->stop);
    s_state = (w == kSkipped || (st != 0 && static_cast<int>(st) - 1 < j.c)) ? 0 : 1;
    if (j.stamps != nullptr) {
      for (int i = 0; i < kChainStamps; ++i) s_cyc[i] = 0;
      last = clock64();
    }
  }
  __syncthreads();
  const uint8_t* __restrict__ src = s_job.src;
  const int64_t slen = s_job.slen;
  const int c = s_job.c;
  const bool stamp = s_job.stamps != nullptr && tid == 0;
  const int64_t base = static_cast<int64_t>(c) << kLog;
  int rounds = 0;
  auto lap = [&](int i) {
    if (!stamp) return;
    const long long now = clock64();
    s_cyc[i] = now - last;
    last = now;
  };

  if (s_state) {
    const uint8_t* s = src + base;
    const int64_t have = slen - base;
    if (have >= kChunk + kPad && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      for (int i = tid; i < (kChunk + kPad) / 16; i += kThreads)
        reinterpret_cast<uint4*>(bytes)[i] = reinterpret_cast<const uint4*>(s)[i];
    } else {
      for (int i = tid; i < kChunk + kPad; i += kThreads) bytes[i] = i < have ? s[i] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const Tag t = parse_tag<kLit24>(bytes + i, slen - base - i);
      const int64_t nxt = i + t.hdr + (t.lit ? t.len : 0);
      const bool stop = base + i >= slen || t.bad;
      J1[i] = static_cast<uint16_t>(stop || nxt >= kChunk ? i : nxt);
      P1[i] = stop ? kStop : nxt >= kChunk ? kExitTag : static_cast<uint32_t>(t.len);
    }
    __syncthreads();
    lap(0);
    for (int r = 0; r < kSubLog; ++r) {
      if (!jump_round<kSubLog>(J1, P1)) break;
      ++rounds;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      J[i] = J1[i];
      P[i] = P1[i];
    }
    __syncthreads();
    for (int r = 0; r <= kLog - kSubLog; ++r) {
      if (!jump_round<kLog>(J, P)) break;
      ++rounds;
    }
    lap(1);

    // the entry, then the exit published at once
    if (tid == 0) {
      JITTER(2);                              // before the entry is read
      unsigned long long w = kEntered;
      if (c > 0) {
        while (true) {
          w = ld_relaxed(&s_job.word[c]);
          if (w) break;
          const unsigned int st = ld_relaxed(&s_job.row->stop);
          if (st != 0 && static_cast<int>(st) - 1 < c) break;
        }
      }
      // a word is 0 (the stop lies before c), an entry or a skip mark
      CHECKED(w == 0 || w == kSkipped || (w & 3) == kEntered);
      s_state = (w & 3) == kEntered ? 1 : 0;
      if (s_state) {
        const int e = static_cast<int>((w >> 2) & 0x7FFF);
        CHECKED(e < kChunk);
        const int64_t pp = static_cast<int64_t>(w >> 17);
        const uint32_t pe = P[e];
        const int x = J[e];
        const int64_t at = pp + (pe & ~kFlags);          // output start of x
        s_entry = e;
        s_pp = pp;
        s_stops = (pe & kStop) != 0;
        if (pe & kStop) {                                // the chain stops in this chunk
          s_out = at;
          s_stop_at = base + x;
          RowHead* row = s_job.row;
          row->p_stop = base + x;
          row->os_stop = at;
          JITTER(3);
          publish_once(&row->stop, static_cast<unsigned int>(c + 1));
        } else {                                         // x leaves the chunk
          const Tag t = parse_tag<kLit24>(bytes + x, slen - base - x);
          const int64_t exit = base + x + t.hdr + (t.lit ? t.len : 0);   // <= slen
          const int64_t out = at + t.len;
          const int d = static_cast<int>(exit >> kLog);
          s_out = out;
          unsigned long long* word = s_job.word;
          // chunk d > c takes its entry from this block, a lower ticket
          CHECKED(d > c && exit <= slen);
          publish_once(&word[d], (static_cast<unsigned long long>(out) << 17) |
                                     (static_cast<unsigned long long>(exit - (static_cast<int64_t>(d) << kLog)) << 2) |
                                     kEntered);
          JITTER(4);                          // between the entry and the skip marks
          for (int t2 = c + 1; t2 < d; ++t2) publish_once(&word[t2], kSkipped);
        }
        if (stamp) s_cyc[7] = global_ns();
      }
    }
    __syncthreads();
    lap(2);

    // the covering tag of each segment whose start falls in this chunk's output
    if (s_state) {
      const int e = s_entry;
      const int64_t pp = s_pp, out = s_out;
      const bool stops = s_stops;
      const int nseg = s_job.nseg;
      int64_t* cover_os = s_job.cover_os;
      int32_t* cover_pos = s_job.cover_pos;
      const int64_t k0 = (pp + kS - 1) / kS;
      const int64_t k1 = stops ? nseg - 1 : ((out + kS - 1) / kS - 1 < nseg - 1 ? (out + kS - 1) / kS - 1 : nseg - 1);
      int searches = 0;
      for (int64_t k = k0 + tid; k <= k1; k += kThreads) {
        CHECKED(k >= 0 && k < nseg);
        const int64_t bound = k * kS;
        if (stops && bound >= out) {                     // past the stop: the stop covers it
          cover_pos[k] = static_cast<int32_t>(s_stop_at);
          cover_os[k] = out;
        } else {
          int64_t pq;
          const int q = last_at_or_below<kLit24>(e, pp, bound, J1, P1, bytes, base, slen, &pq);
          CHECKED(pq <= bound);
          cover_pos[k] = static_cast<int32_t>(base + q);
          cover_os[k] = pq;
          ++searches;
        }
      }
      searches = __syncthreads_count(searches > 0);
      if (stamp) s_cyc[6] = searches;
    }
    lap(3);
  }
  if (stamp) {
    s_cyc[4] = s_state;
    s_cyc[5] = rounds;
    for (int i = 0; i < kChainStamps; ++i) s_job.stamps[i] = s_cyc[i];
  }
}

// ========================================================= the segment pass

constexpr int kWin = 8192;              // input bytes a window
constexpr int kStage = kWin + 16;       // staged: a tag's header reaches 4 bytes past the window
constexpr int kTagsPerThread = kWin / 2 / kThreads;
constexpr int kLevels = 4;              // next-tag tables: 1, 2, 4 and 8 tags ahead
constexpr int kStep = 1 << (kLevels - 1);
constexpr uint16_t kExit = 0xFFFE;      // nx: the next tag starts past the window
constexpr uint16_t kBad = 0xFFFF;       // nx: no tag of the envelope starts here
constexpr int kMaxWindows = 6 * kS / kWin + 3;   // 6 input bytes an output byte, at most
constexpr int kPieces = kS / 16 / kThreads;      // 16-byte pieces of the output a thread
// stamps a segment: the cycles of entered (the covering tag), parsed (staging,
// parse and tables), walked, judged, covered, resolved, waited, written; then
// windows, tags walked, resolve rounds, externals (1 when it read bytes of
// earlier segments) and the %globaltimer ns at which it published its flag
constexpr int kSegStamps = 13;

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// A window's first half: stages kStage input bytes from in (`staged` of
// them real, the rest 0) into win, parses every position below lim into nx
// (the next tag's start, kExit past the window, kBad where no tag starts;
// avail0 input bytes from in on) and builds the tables 2, 4 and 8 tags
// ahead at nx + kWin, + 2 kWin, + 3 kWin.
template <bool kLit24>
__device__ __forceinline__ void window_tables(const uint8_t* __restrict__ in, int staged, int lim,
                                              int64_t avail0, uint8_t* win, uint16_t* nx) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kStage; i += kThreads) win[i] = i < staged ? in[i] : 0;
  __syncthreads();
  for (int p = tid; p < lim; p += kThreads) {
    const Tag t = parse_tag<kLit24>(win + p, avail0 - p);
    const int64_t nxt = p + t.hdr + (t.lit ? t.len : 0);
    nx[p] = t.bad ? kBad : (nxt < kWin ? static_cast<uint16_t>(nxt) : kExit);
  }
  __syncthreads();
  for (int lv = 1; lv < kLevels; ++lv) {
    const uint16_t* a = nx + (lv - 1) * kWin;
    uint16_t* d = nx + lv * kWin;
    for (int p = tid; p < lim; p += kThreads) {
      const int q = a[p];
      d[p] = q < lim ? a[q] : static_cast<uint16_t>(q);
    }
    __syncthreads();
  }
}

// A window's second half: one thread walks the 8-ahead table from position
// 0, keeping every eighth tag as a chain point in cp, then all threads list
// the tags between the points into tl, in order.  Returns (the tags listed,
// where the walk ended: >= lim, the input's end, kExit or kBad).
template <typename TL>
__device__ __forceinline__ int2 window_list(const uint16_t* nx, int lim, uint16_t* cp, TL* tl) {
  __shared__ int s_k, s_term, s_n;
  const uint16_t* nx2 = nx + kWin;
  const uint16_t* nx4 = nx + 2 * kWin;
  if (threadIdx.x == 0) {
    const uint16_t* nx8 = nx + 3 * kWin;
    int q = 0, c = 0;
    for (; c < kWin / 2 / kStep && q < lim; ++c) {
      cp[c] = static_cast<uint16_t>(q);
      q = nx8[q];
    }
    s_k = c;
    s_term = q;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < s_k; c += kThreads) {
    int e[kStep];
    const int q = cp[c];
    e[0] = q;
    e[1] = nx[q];
    e[2] = nx2[q];
    e[3] = e[2] < lim ? nx[e[2]] : e[2];
    e[4] = nx4[q];
    e[5] = e[4] < lim ? nx[e[4]] : e[4];
    e[6] = e[4] < lim ? nx2[e[4]] : e[4];
    e[7] = e[6] < lim ? nx[e[6]] : e[6];
    int v = 0;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if (e[j] < lim && v == j) {
        CHECKED(c * kStep + j < kWin / 2);
        tl[c * kStep + j] = static_cast<TL>(e[j]);
        ++v;
      }
    }
    if (c == s_k - 1) s_n = c * kStep + v;
  }
  __syncthreads();
  return make_int2(s_n, s_term);
}

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
  __syncthreads();
  return r;
}

// Minimum over the block of one value a thread; every thread gets it.  Two
// barriers: the next call's first one orders its write of *s_out after
// every thread's read of this one's, so *s_out is not written elsewhere.
__device__ unsigned block_min(unsigned v, unsigned* s_warp, unsigned* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const unsigned m = __reduce_min_sync(kFull, s_warp[lane]);
    if (lane == 0) *s_out = m;
  }
  __syncthreads();
  return *s_out;
}

// Raises `fn`'s dynamic shared-memory limit to `bytes` once per device
// (bit `slot` of a device's mask), not on every launch.
cudaError_t raise_smem_once(const void* fn, int bytes, int slot) {
  static std::atomic<uint32_t> raised[32];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<uint32_t>& mask = raised[dev & 31];
  const uint32_t bit = 1u << slot;
  if (mask.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) mask.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace
