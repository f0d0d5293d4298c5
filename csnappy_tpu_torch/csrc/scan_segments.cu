// Whole-stream boundary scan for Hopper (sm_90a).
//
// Replaces csnappy_tpu/ops/decode_ws.py::_scan_kernel (_scan_compiled, :268)
// and the dense parse in front of it (_entries, :65).  The tag chain of a
// headerless stream starts at position 0; each tag at p with output start pp
// writes seg[ceil(pp / 32768)] = p, the last writer of a slot wins, and slots
// at or past nslot - 1 share the last one.  The chain stops at the first
// position whose entry is 0 (past the stream, truncated, a literal above 32
// KiB, a tag producing more than 32768 bytes or advancing more than 32773),
// which includes the stream's end; that position writes its slot last, as
// the TPU walk's stalled steps do.  meta = {p, pp, 0, chunks visited} where
// it stopped; slots no one wrote hold the stream's length.
//
// What bounds it on this card: the chain.  A tag's start depends on the tag
// before it, and one thread walking it pays ~25 SM cycles a tag even out of
// shared memory, on one SM of 132: ~0.9 ms for the ~74k tags of
// urls.10K.snappy.  The stream is read once: its bytes bound nothing.
//
// What the design does: the chain is a functional graph, next(p) = p +
// adv(p), so it is cut into chunks of C stream positions, one thread block
// a chunk, taken in stream order by an atomic ticket.  Each block stages its
// chunk (plus a 16-byte halo), parses every position and pointer-jumps in
// shared memory: first inside sub-chunks of 256 positions (8 rounds), then,
// from those tables, to the chunk's end (log2(C / 256) rounds), so that for
// EVERY position it knows where its chain leaves the chunk (or stops) and
// the output produced on the way.  The real chain then costs one lookup a
// chunk it visits: the block waits for its entry (position and pp, one
// 64-bit word published by the chunk whose exit landed here), reads the
// exit of that entry from its table and publishes the next entry at once:
// a decoupled look-back with one word a chunk and no fence on its path.  A
// literal that skips whole chunks marks them skipped; the chunk that holds
// the stop publishes it in a word every later chunk polls too, so no block
// waits on a chunk that will never be entered, and blocks that start after
// the stop return at once.  The in-order ticket makes the wait safe: a
// block waits only on chunks that running blocks already hold.  The worst
// case is the same for any data (two chains that never merge included): one
// dependent global round trip a chunk.
//
// Slots, off the chaining's path: a visited chunk owns the boundaries k *
// 32768 in its output range [pp at entry, pp at exit) (from its entry on,
// for the chunk that holds the stop).  For each, one thread finds the last
// chain element with output start <= k * 32768 (sub-chunk hops, then tags)
// and writes it if its pp > (k - 1) * 32768, else the stream's length; pp
// grows along the chain (every valid tag produces a byte), so this is the
// last writer of the serial walk.  The block holding the stop writes meta
// and the slots from there on.  The last block to finish (an atomic count)
// writes meta[3] and, when asked, the segment table of decode_segments:
// int64 offsets clamped to [0, n], int32 lengths clamped to the widest
// segment, int32 limits clamp(dst_len - k * 32768, 1, 32768), and an int64
// check (meta[:3], then each segment's width).
//
// The workspace (a head and one word a chunk) is cleared by a memset on the
// stream before each launch.  With a non-null `stamps` (kStamps int64 a
// chunk, in chunk order), thread 0 writes the SM cycles of each phase, then
// counts: see kStamps.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPad = 16;                 // bytes staged past the chunk (a tag's header)
constexpr int kSubLog = 8;               // sub-chunks of 256 positions
constexpr int64_t kSeg = 32768;
constexpr uint32_t kStop = 0x80000000u;  // in a produced sum: the chain stops at its position
constexpr int kMinLog = 12, kMaxLog = 14;
// stamps a chunk: the cycles of staged (staging and parse), jumped, waited,
// slots, table; then visited (1 or 0), pointer-jumping rounds, slot
// searches, and the %globaltimer ns at which the chunk published its exit
constexpr int kStamps = 9;

struct Head {
  unsigned int ticket;                   // chunks taken
  unsigned int done;                     // blocks finished
  unsigned int visited;                  // chunks the chain entered
  unsigned int stop;                     // chunk holding the stop + 1; 0 until known
};
// word[c]: 0 until known; else (pp << 17) | (entry - c * C) << 2 | 1 when the
// chain enters chunk c, or 2 when it skips it
constexpr unsigned long long kEntered = 1, kSkipped = 2;

// The dense parse of decode_ws.py::_entries for the tag at b[0] (position
// pos of a stream of slen bytes; bytes past slen read as 0).
__device__ __forceinline__ uint32_t entry(const uint8_t* b, int64_t pos, int64_t slen) {
  const uint32_t b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3], b4 = b[4];
  const uint32_t kind = b0 & 3, u = b0 >> 2;
  const bool lit = kind == 0;
  const uint32_t extra = u < 59 ? 0 : (u - 59 > 4 ? 4 : u - 59);
  const uint32_t t2 = b1 | (b2 << 8), t3 = t2 | (b3 << 16);
  const uint32_t tr = extra == 0 ? 0 : extra == 1 ? b1 : extra == 2 ? t2 : t3;
  const uint32_t lit_len = u >= 60 ? tr + 1 : u + 1;
  const bool lit_bad = lit && u >= 60 && ((extra == 4 && b4 > 0) || tr + 1 > kSeg);
  const uint32_t hdr = lit ? 1 + extra : kind == 1 ? 2 : kind == 2 ? 3 : 5;
  const uint32_t copy_len = kind == 1 ? (u & 7) + 4 : u + 1;
  const uint32_t prod = lit ? lit_len : copy_len;
  const uint32_t adv = hdr + (lit ? lit_len : 0);
  const bool valid = pos < slen && pos + adv <= slen && !lit_bad && prod <= kSeg &&
                     adv <= kSeg + 5;
  return valid ? (adv | (prod << 16)) : 0;
}

// The chain's words carry all they say (no payload written beside them),
// so device-scope relaxed loads and stores order nothing else and need no
// fence: they bypass the SM's L1 and meet in L2.
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
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The segment table's outputs (all null for a bare scan).
struct Table {
  int64_t* offs;       // [nseg]
  int32_t* lens;       // [nseg]
  int32_t* dlims;      // [nseg]
  int64_t* check;      // [3 + nseg]: meta[:3], then the widths
  int64_t dst_len;
  int nseg;
  int max_width;
};

// One pointer-jumping round over the positions a thread owns, in place:
// every position whose pointer is not terminal (a stop, or at or past the end
// of its span of 2^kSpanLog positions) takes its target's pointer and adds
// its target's output.  Returns whether any position of the block was not
// terminal (then the round was made).
template <int kPer, int kSpanLog>
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
    const bool live = !(p & kStop) && j < end;
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

// The last chain element at or after position x (on the chain, output start
// px <= bound) whose output start is <= bound: hops from sub-chunk to
// sub-chunk, then tags.  Returns the position; *pq its output start.
template <int C>
__device__ int last_at_or_below(int x, int64_t px, int64_t bound, const uint16_t* J1,
                                const uint32_t* P1, const uint8_t* bytes, int64_t base,
                                int64_t slen, int64_t* pq) {
  while (true) {
    const uint32_t p1 = P1[x];
    const int j1 = J1[x];
    const int64_t py = px + (p1 & ~kStop);
    if (py > bound) break;                      // the answer lies before j1
    if (p1 & kStop) {                           // the stop, at or below the bound
      x = j1;
      px = py;
      break;
    }
    if (j1 >= C) break;                         // leaves the chunk: walk the rest
    x = j1;
    px = py;
  }
  while (true) {
    const uint32_t e = entry(bytes + x, base + x, slen);
    if (e == 0) break;                          // x is the stop
    const int z = x + static_cast<int>(e & 0xFFFF);
    const int64_t pz = px + (e >> 16);
    if (pz > bound || z >= C) break;
    x = z;
    px = pz;
  }
  *pq = px;
  return x;
}

template <int kLog>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint8_t* __restrict__ src, int64_t slen, int32_t* __restrict__ seg, int nslot,
            int64_t* __restrict__ meta, Head* __restrict__ head,
            unsigned long long* __restrict__ word, Table table, int64_t* __restrict__ stamps) {
  constexpr int C = 1 << kLog;
  constexpr int kPer = C / kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* P1 = reinterpret_cast<uint32_t*>(smem);   // output to the sub-chunk's exit
  uint32_t* P = P1 + C;                                // output to the chunk's exit
  uint16_t* J1 = reinterpret_cast<uint16_t*>(P + C);   // the sub-chunk's exit (or stop)
  uint16_t* J = J1 + C;                                // the chunk's exit (or stop)
  uint8_t* bytes = reinterpret_cast<uint8_t*>(J + C);  // C + kPad
  __shared__ int s_chunk, s_state, s_entry, s_stops, s_last;
  __shared__ long long s_pp, s_out, s_exit;
  __shared__ long long s_cyc[kStamps];
  const int tid = threadIdx.x;
  const int nchunks = gridDim.x;
  long long last = 0;
  const bool stamp = stamps != nullptr && tid == 0;

  if (tid == 0) {
    const int c = static_cast<int>(atomicAdd(&head->ticket, 1u));
    s_chunk = c;
    // known not to be entered already (skipped, or past the stop): no tables
    const unsigned long long w = c == 0 ? kEntered : ld_relaxed(&word[c]);
    const unsigned int st = c == 0 ? 0 : ld_relaxed(&head->stop);
    s_state = (w == kSkipped || (st != 0 && static_cast<int>(st) - 1 < c)) ? 0 : 1;
    if (stamp) {
      for (int i = 0; i < kStamps; ++i) s_cyc[i] = 0;
      last = clock64();
    }
  }
  __syncthreads();
  const int c = s_chunk;
  const int64_t base = static_cast<int64_t>(c) << kLog;
  int rounds = 0;
  auto lap = [&](int i) {
    if (!stamp) return;
    const long long now = clock64();
    s_cyc[i] = now - last;
    last = now;
  };

  if (s_state) {
    // stage and parse
    const uint8_t* s = src + base;
    const int64_t have = slen - base;
    if (have >= C + kPad && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      for (int i = tid; i < (C + kPad) / 16; i += kThreads)
        reinterpret_cast<uint4*>(bytes)[i] = reinterpret_cast<const uint4*>(s)[i];
    } else {
      for (int i = tid; i < C + kPad; i += kThreads) bytes[i] = i < have ? s[i] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const uint32_t e = entry(bytes + i, base + i, slen);
      J1[i] = static_cast<uint16_t>(e ? i + (e & 0xFFFF) : i);
      P1[i] = e ? e >> 16 : kStop;
    }
    __syncthreads();
    lap(0);
    // pointer jumping: to each sub-chunk's exit, then to the chunk's
    for (int r = 0; r < kSubLog; ++r) {
      if (!jump_round<kPer, kSubLog>(J1, P1)) break;
      ++rounds;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      J[i] = J1[i];
      P[i] = P1[i];
    }
    __syncthreads();
    for (int r = 0; r < kLog - kSubLog; ++r) {
      if (!jump_round<kPer, kLog>(J, P)) break;
      ++rounds;
    }
    lap(1);

    // the entry, then the exit published at once
    if (tid == 0) {
      unsigned long long w = kEntered;
      if (c > 0) {
        while (true) {
          w = ld_relaxed(&word[c]);
          if (w) break;
          const unsigned int st = ld_relaxed(&head->stop);
          if (st != 0 && static_cast<int>(st) - 1 < c) break;
        }
      }
      s_state = (w & 3) == kEntered ? 1 : 0;
      if (s_state) {
        const int e = static_cast<int>((w >> 2) & 0x7FFF);
        const int64_t pp = static_cast<int64_t>(w >> 17);
        const uint32_t pe = P[e];
        const int64_t out = pp + (pe & ~kStop);
        const int64_t exit = base + J[e];
        s_entry = e;
        s_pp = pp;
        s_out = out;
        s_exit = exit;
        s_stops = (pe & kStop) != 0;
        if (pe & kStop) {                       // the chain stops in this chunk
          meta[0] = exit;
          meta[1] = out;
          meta[2] = 0;
          st_relaxed(&head->stop, static_cast<unsigned int>(c + 1));
        } else {
          const int d = static_cast<int>(exit >> kLog);   // <= the last chunk: exit <= slen
          for (int t = c + 1; t < d; ++t) st_relaxed(&word[t], kSkipped);
          st_relaxed(&word[d], (static_cast<unsigned long long>(out) << 17) |
                                   (static_cast<unsigned long long>(exit - (static_cast<int64_t>(d) << kLog)) << 2) |
                                   kEntered);
        }
        atomicAdd(&head->visited, 1u);
        if (stamp) s_cyc[8] = global_ns();
      }
    }
    __syncthreads();
    lap(2);

    // the slots whose boundary falls in this chunk's output range
    if (s_state) {
      const int e = s_entry;
      const int64_t pp = s_pp, out = s_out;
      const bool stops = s_stops;
      const int64_t k0 = (pp + kSeg - 1) >> 15;
      const int64_t kout = (out + kSeg - 1) >> 15;    // the slot of the exit, or of the stop
      const int64_t klast = static_cast<int64_t>(nslot) - 2;
      // without the stop: the k with k * 32768 < out; with it: every slot
      // below nslot - 1, those past the stop's slot unwritten by the walk
      const int64_t k1 = stops ? klast : (kout - 1 < klast ? kout - 1 : klast);
      int searches = 0;
      for (int64_t k = k0 + tid; k <= k1; k += kThreads) {
        int32_t v = static_cast<int32_t>(slen);
        if (!stops || k <= kout) {
          int64_t pq;
          const int q = last_at_or_below<C>(e, pp, k * kSeg, J1, P1, bytes, base, slen, &pq);
          if (pq > (k - 1) * kSeg) v = static_cast<int32_t>(base + q);
          ++searches;
        }
        seg[k] = v;
      }
      if (stops && tid == 0)
        seg[nslot - 1] = static_cast<int32_t>(kout >= nslot - 1 ? s_exit : slen);
      searches = __syncthreads_count(searches > 0);
      if (stamp) s_cyc[7] = searches;
    }
    lap(3);
  }

  // the last block to finish: meta[3] and the segment table
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&head->done, 1u) == static_cast<unsigned int>(nchunks - 1);
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (tid == 0) meta[3] = ld_relaxed(&head->visited);
    if (table.offs != nullptr) {
      for (int k = tid; k < table.nseg; k += kThreads) {
        int64_t a = __ldcg(seg + k);
        a = a < 0 ? 0 : a > slen ? slen : a;
        int64_t b = k + 1 < table.nseg ? __ldcg(seg + k + 1) : slen;
        b = b > slen ? slen : b;
        const int64_t w = b > a ? b - a : 0;
        const int64_t lim = table.dst_len - static_cast<int64_t>(k) * kSeg;
        table.offs[k] = a;
        table.lens[k] = static_cast<int32_t>(w < table.max_width ? w : table.max_width);
        table.dlims[k] = static_cast<int32_t>(lim < 1 ? 1 : lim > kSeg ? kSeg : lim);
        table.check[3 + k] = w;
      }
      if (tid < 3) table.check[tid] = __ldcg(reinterpret_cast<const long long*>(meta) + tid);
    }
  }
  lap(4);
  if (stamp) {
    s_cyc[5] = s_state;
    s_cyc[6] = rounds;
    for (int i = 0; i < kStamps; ++i) stamps[static_cast<int64_t>(c) * kStamps + i] = s_cyc[i];
  }
}

constexpr int smem_bytes(int log) { return 13 * (1 << log) + kPad; }

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

template <int kLog>
cudaError_t launch(const uint8_t* src, long long slen, int32_t* seg, int nslot, int64_t* meta,
                   void* work, const Table& table, int64_t* stamps, cudaStream_t st) {
  const long long nchunks = (slen >> kLog) + 1;
  cudaError_t e = cudaMemsetAsync(work, 0, sizeof(Head) + 8 * nchunks, st);
  if (e == cudaSuccess)
    e = raise_smem_once(reinterpret_cast<const void*>(scan_kernel<kLog>), smem_bytes(kLog),
                        kLog - kMinLog);
  if (e != cudaSuccess) return e;
  Head* head = static_cast<Head*>(work);
  scan_kernel<kLog><<<static_cast<unsigned int>(nchunks), kThreads, smem_bytes(kLog), st>>>(
      src, slen, seg, nslot, meta, head, reinterpret_cast<unsigned long long*>(head + 1), table,
      stamps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a block takes at chunks of 2^chunk_log positions.
int scan_segments_smem_bytes(int chunk_log) { return smem_bytes(chunk_log); }

// Scans src[0:slen] into seg[0:nslot] and meta[0:4] (int64) on `stream`, in
// chunks of 2^chunk_log positions (12 to 14), with `work` (16 bytes, then 8
// a chunk: positions 0 to slen) cleared first.  With non-null offs, lens, dlims
// and check it also writes the segment table of nseg segments of dst_len
// bytes; stamps: null, or kStamps int64 a chunk.  Returns the first CUDA
// error, or 0.
int scan_segments_launch(const void* src, long long slen, void* seg, int nslot, void* meta,
                         void* work, void* offs, void* lens, void* dlims, void* check,
                         long long dst_len, int nseg, int max_width, int chunk_log, void* stamps,
                         void* stream) {
  if (slen < 0 || slen >= (1LL << 31) || nslot < 1 || chunk_log < kMinLog || chunk_log > kMaxLog ||
      nseg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Table table{static_cast<int64_t*>(offs), static_cast<int32_t*>(lens),
                    static_cast<int32_t*>(dlims), static_cast<int64_t*>(check), dst_len, nseg,
                    max_width};
  const auto* s = static_cast<const uint8_t*>(src);
  auto* sg = static_cast<int32_t*>(seg);
  auto* mt = static_cast<int64_t*>(meta);
  auto* sp = static_cast<int64_t*>(stamps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (chunk_log) {
    case 12: e = launch<12>(s, slen, sg, nslot, mt, work, table, sp, st); break;
    case 13: e = launch<13>(s, slen, sg, nslot, mt, work, table, sp, st); break;
    default: e = launch<14>(s, slen, sg, nslot, mt, work, table, sp, st); break;
  }
  return static_cast<int>(e);
}

const char* scan_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
