// Whole-stream Snappy decode for Hopper (sm_90a): the crossing-stream decoder.
//
// Replaces csnappy_tpu/ops/decode_stream.py::_kernel (_compiled, :531).  It
// decodes ONE headerless stream whose tags and copies may cross 32 KiB
// output boundaries, with copy offsets up to 32768 and literals up to 2^24
// bytes, under the JAX kernel's event rules (ops/decode_stream.py in this
// package states them: the first event in output order, a malformed tag
// before its own overrun, output exactly full at the limit with tags left
// malformed).
//
// What bounds it on this card: two serial chains, not bytes.  Tag N's start
// depends on tag N-1's length, and a copy may read bytes that copies before
// it wrote, up to 32768 back.  The TPU kernel ran a sequential grid over 32
// KiB output segments, carrying the walk, the straddling tag, a history
// ring and the error minima from step to step; on 132 SMs that is one SM
// doing all the work.  Here both chains are cut so that each link costs one
// word in device memory, and all the rest runs in parallel:
//
// chain_kernel, one thread block per chunk of C = 8,192 stream positions,
// taken in stream order by an atomic ticket (the design of
// scan_segments.cu under this kernel's envelope).  Each block stages its
// chunk (plus a 16-byte halo), parses every position as if a tag started
// there and pointer-jumps in shared memory, first inside sub-chunks of 256
// positions, then to the chunk's end, so that every position knows where
// its tag chain stops in the chunk (a stop: no tag of the envelope starts
// there, the stream's end included) or which tag leaves the chunk (the exit
// tag), and the output produced on the way.  The chain then costs one
// lookup a chunk: the block waits for its entry (position and output start,
// one 64-bit word published by the chunk whose exit landed in it), reads
// the exit from its tables and publishes the next entry.  A literal that
// skips whole chunks marks them skipped; the chunk holding the stop
// publishes it, so no block waits on a chunk that is never entered.  Then,
// off the chain's path, each visited chunk writes the covering tag (the
// last chain tag whose output start is <= k * 32768: its position and
// output start) of every output segment k whose start falls in its output
// range.
//
// segment_kernel, one thread block per 32 KiB output segment, taken in
// output order by a ticket.  Copy offsets are at most 32768 and a copy at
// most 64 bytes, so every copy byte of segment k reads a byte at or after
// (k - 1) * 32768: segment k needs only its own tags and segment k - 1's
// final bytes.  Each block:
//   1. enters its covering tag at byte k * 32768 - os (a straddling literal
//      or copy; a segment wholly inside one literal is a plain copy);
//   2. walks its tags in windows of 8 KiB of input as decode_blocks.cu's
//      decode_kernel does (stage, parse every position, tables 2, 4 and 8
//      tags ahead, one walking thread, tags listed in parallel);
//   3. judges each tag whose output start lies in the segment (truncated
//      header or body, a literal trailer above 2^24, offset 0, above 32768
//      or past the output start, a start at the limit: E_DATA_MALFORMED; an
//      end past the output: E_OUTPUT_OVERRUN) and lowers one device-wide
//      minimum of (output start, kind), so the first event in output order
//      wins, ties to E_DATA_MALFORMED;
//   4. covers its bytes: literal bytes, and for each copy byte its one-hop
//      parent os - off + j % off, counted from segment k - 1's start (16
//      bits: every parent lies in those 64 KiB);
//   5. pointer-jumps the parents inside the segment (at most 16 rounds); a
//      parent before the segment stays external;
//   6. writes every 16-byte piece with no external byte at once; only if
//      some byte is external, waits for segment k - 1's flag, stages that
//      segment's tail (final by then) in shared memory with 16-byte loads,
//      fills and writes the pieces it held, and publishes its flag.
// The flag wait is the only serial step of the bytes: one word a segment,
// however deep copies chain (an offset-1 run over the stream is the
// deepest), and none for a segment whose copies stay inside it.  The last
// block to finish writes {produced, status}: produced is 0 unless no event
// was found.  The output holds cap bytes and the overrun limit is cap (=
// min(dst_len, cap), as no stream of n bytes produces more than cap).
//
// Every header read is bounded by the stream's length (bytes past it stage
// as 0), every write by cap, so no input makes either kernel read or write
// out of bounds.  One call is one memset of the workspace (the heads, a word
// a chunk, 16 bytes a segment) and the two launches on one stream.  With a
// non-null `stamps`, thread 0 of each block writes its phases' SM cycles
// and counts (kChainStamps int64 a chunk, then kSegStamps a segment).
//
// The chain pass (chain_block), the window walk and the helpers live in
// decode_chain.cuh, shared with decode_wide.cu, which runs the same design
// on rows past 32 KiB with copies reaching any earlier byte of a row.

#include "decode_chain.cuh"

namespace {

constexpr uint32_t kMaxOffset = 32768;      // the envelope's farthest copy

// ========================================================= chain_kernel

__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint8_t* __restrict__ src, int64_t slen, Head* __restrict__ head,
             RowHead* __restrict__ row, unsigned long long* __restrict__ word,
             int64_t* __restrict__ cover_os, int32_t* __restrict__ cover_pos, int nseg,
             int64_t* __restrict__ stamps) {
  chain_block<true>([&] {
    const int c = static_cast<int>(atomicAdd(&head->ticket, 1u));
    return ChainJob{src, slen, row, word, cover_os, cover_pos,
                    stamps == nullptr ? nullptr : stamps + static_cast<int64_t>(c) * kChainStamps,
                    c, nseg};
  });
}

// ======================================================== segment_kernel

// Byte offsets of segment_kernel's shared arrays (decode_blocks.cu's layout
// at 32 KiB): the segment's bytes, its parents, the window, the four tables
// (after the walk, the room for segment k - 1's tail), the chain points, the
// tags' fields and their output starts.
struct Layout {
  int out, par, win, nx, cp, tl, tos, total;
};
__host__ __device__ constexpr Layout layout() {
  const int par = align16(kS);
  const int win = par + 2 * kS;
  const int nx = win + kStage;
  const int cp = nx + kLevels * 2 * kWin;
  const int tl = cp + 2 * (kWin / 2 / kStep);
  const int tos = tl + kWin;
  return Layout{0, par, win, nx, cp, tl, tos, tos + kWin};
}
static_assert(layout().total <= 232448 - 1024, "a block's shared memory on the H100");

// The parent of byte j of a copy at os (both counted from one origin) with
// offset off <= 32768, shifted by kS: always below the byte, and >= 0 when
// the origin is segment k - 1's start and the byte lies in segment k.
__device__ __forceinline__ uint16_t parent(int os, int j, int off) {
  return static_cast<uint16_t>(os - off + (j < off ? j : j % off) + kS);
}

__global__ void __launch_bounds__(kThreads, 1)
segment_kernel(const uint8_t* __restrict__ in, int64_t slen, uint8_t* __restrict__ gout,
               int64_t cap, int64_t limit, int64_t* __restrict__ meta, Head* __restrict__ head,
               RowHead* __restrict__ row,
               const int64_t* __restrict__ cover_os, const int32_t* __restrict__ cover_pos,
               unsigned int* __restrict__ flag, int nseg, int64_t* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr Layout ly = layout();
  uint8_t* out = smem + ly.out;                                 // the segment's bytes
  uint16_t* par = reinterpret_cast<uint16_t*>(smem + ly.par);   // cover, then parents + kS
  uint8_t* win = smem + ly.win;
  uint16_t* nx = reinterpret_cast<uint16_t*>(smem + ly.nx);
  uint16_t* cp = reinterpret_cast<uint16_t*>(smem + ly.cp);
  uint16_t* tl = reinterpret_cast<uint16_t*>(smem + ly.tl);     // tag starts, then fields
  uint16_t* tos = reinterpret_cast<uint16_t*>(smem + ly.tos);   // output starts in the segment
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_red;
  __shared__ int s_seg, s_total, s_skip, s_last;
  __shared__ long long s_next;
  __shared__ long long s_cyc[kSegStamps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stamp = stamps != nullptr && tid == 0;
  long long last = 0;

  if (tid == 0) {
    s_seg = static_cast<int>(atomicAdd(&head->seg_ticket, 1u));
    if (stamp) {
      for (int i = 0; i < kSegStamps; ++i) s_cyc[i] = 0;
      last = clock64();
    }
    // an event already found before this segment: its bytes are not needed
    const unsigned long long ev = ld_relaxed(&row->event);
    s_skip = ev != 0 && static_cast<int64_t>(~ev >> 1) < static_cast<int64_t>(s_seg) * kS;
  }
  __syncthreads();
  auto lap = [&](int i) {
    if (!stamp) return;
    const long long now = clock64();
    s_cyc[i] += now - last;
    last = now;
  };
  const int k = s_seg;
  const int64_t base = static_cast<int64_t>(k) * kS;
  const int hi = static_cast<int>(cap - base < kS ? cap - base : kS);           // bytes written
  const int jhi = static_cast<int>(cap + 1 - base < kS ? cap + 1 - base : kS);  // starts judged
  const int64_t p_stop = row->p_stop;
  const int64_t cpos = cover_pos[k], cos = cover_os[k];
  int state = s_skip;        // 0: ok; 1: nothing more to do; < 0: an event here
  int op0 = 0;               // the next tag's output start, from the segment's start
  int64_t ip0 = cpos;
  int windows = 0, tags = 0, rounds = 0;

  // 1. the covering tag, when it starts before the segment
  if (state == 0 && cos < base) {
    if (cpos == p_stop) {
      state = 1;                                 // the stream ended before this segment
    } else {
      uint8_t h[5];
      for (int i = 0; i < 5; ++i) h[i] = cpos + i < slen ? in[cpos + i] : 0;
      const Tag t = parse_tag<true>(h, slen - cpos);   // a chain tag: valid
      const int64_t end = cos + t.len - base;    // > 0
      const int m = static_cast<int>(end < hi ? end : hi);
      const int64_t j0 = base - cos;
      if (t.lit) {
        const uint8_t* s = in + cpos + t.hdr + j0;
        for (int i = tid; i < m; i += kThreads) {
          out[i] = s[i];
          par[i] = static_cast<uint16_t>(i + kS);
        }
      } else {
        const int off = static_cast<int>(t.off);
        const bool ok = t.off != 0 && t.off <= kMaxOffset && t.off <= static_cast<uint64_t>(cos);
        for (int i = tid; i < m; i += kThreads) {   // j0 + i < 64
          if (ok) {
            par[i] = parent(static_cast<int>(cos - base), static_cast<int>(j0) + i, off);
          } else {                                   // an event before this segment
            out[i] = 0;
            par[i] = static_cast<uint16_t>(i + kS);
          }
        }
      }
      op0 = static_cast<int>(end < kS ? end : kS);
      ip0 = cpos + t.hdr + (t.lit ? t.len : 0);
    }
  }
  __syncthreads();
  lap(0);

  // 2-4. the segment's own tags, a window of input at a time
  while (state == 0 && op0 < jhi && ip0 < slen && windows < kMaxWindows) {
    ++windows;
    const int64_t avail0 = slen - ip0;
    const int staged = avail0 < kStage ? static_cast<int>(avail0) : kStage;
    const int lim = avail0 < kWin ? static_cast<int>(avail0) : kWin;   // tags start below lim
    window_tables<true>(in + ip0, staged, lim, avail0, win, nx);
    lap(1);
    const int2 listed = window_list(nx, lim, cp, tl);
    lap(2);

    // judge: lengths, output starts, events; the first event wins
    const int n = listed.x, term = listed.y;
    tags += n;
    Tag tg[kTagsPerThread];
    int lc[kTagsPerThread], pj[kTagsPerThread];
    int mine = 0;
    const int t0 = tid * kTagsPerThread;
#pragma unroll
    for (int j = 0; j < kTagsPerThread; ++j) {
      lc[j] = 0;
      if (t0 + j < n) {
        const int p = pj[j] = tl[t0 + j];
        tg[j] = parse_tag<true>(win + p, avail0 - p);
        lc[j] = static_cast<int>(tg[j].len < kS + 1 ? tg[j].len : kS + 1);
        mine += lc[j];
      }
    }
    int os = op0 + block_excl_sum(mine, s_warp, &s_total);
    unsigned ev = UINT_MAX;                                     // os * 2 + overrun
#pragma unroll
    for (int j = 0; j < kTagsPerThread; ++j) {
      const int t = t0 + j;
      if (t < n) {
        const Tag& g = tg[j];
        if (os < jhi && ev == UINT_MAX) {
          const int64_t at = base + os;
          if (g.bad || at >= limit ||
              (!g.lit && (g.off == 0 || g.off > kMaxOffset || g.off > static_cast<uint64_t>(at))))
            ev = static_cast<unsigned>(os) * 2;                 // malformed
          else if (at + g.len > cap)
            ev = static_cast<unsigned>(os) * 2 + 1;             // overrun
        }
        tos[t] = static_cast<uint16_t>(os < 0xFFFF ? os : 0xFFFF);
        tl[t] = static_cast<uint16_t>(g.lit ? 0x8000 | (pj[j] + g.hdr) : (g.off - 1) & 0x7FFF);
        if (t == n - 1 && term == kExit)                        // the next window's first tag
          s_next = ip0 + pj[j] + g.hdr + (g.lit ? g.len : 0);
        os += lc[j];
      }
    }
    const unsigned first = block_min(ev, reinterpret_cast<unsigned*>(s_warp), &s_red);
    lap(3);
    if (first != UINT_MAX) {
      if (tid == 0)
        atomicMax(&row->event, ~((static_cast<unsigned long long>(base) << 1) + first));
      state = (first & 1) ? E_OUTPUT_OVERRUN : E_DATA_MALFORMED;
      break;
    }

    // cover: every byte of the window's tags below hi gets its tag, then
    // literals their bytes and copies their parents
    const int op_end = op0 + s_total;
    const int c_end = op_end < hi ? op_end : hi;
    if (op0 < c_end) {
      for (int i = op0 + tid; i < c_end; i += kThreads) par[i] = 0;
      __syncthreads();
      for (int t = tid; t < n; t += kThreads)
        if (tos[t] < c_end) par[tos[t]] = static_cast<uint16_t>(t);
      __syncthreads();
      const int m = c_end - op0;
      const int sg = ((m + kWarps - 1) / kWarps + 31) & ~31;   // a warp's bytes
      const int s0 = op0 + warp * sg;
      const int s1 = min(s0 + sg, c_end);
      unsigned wmax = 0;
      for (int i = s0 + lane; i < s1; i += 32) wmax = max(wmax, static_cast<unsigned>(par[i]));
      wmax = __reduce_max_sync(kFull, wmax);
      if (lane == 0) s_warp[warp] = static_cast<int>(wmax);
      __syncthreads();
      unsigned carry = __reduce_max_sync(kFull, lane < warp ? static_cast<unsigned>(s_warp[lane]) : 0u);
      for (int i0 = s0; i0 < s1; i0 += 32) {
        const int i = i0 + lane;
        unsigned v = i < s1 ? par[i] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v = max(v, u);
        }
        v = max(v, carry);
        carry = __shfl_sync(kFull, v, 31);
        if (i < s1) {
          const int os_t = tos[v];
          const int f = tl[v];
          const int j = i - os_t;
          if (f & 0x8000) {
            const int at = (f & 0x7FFF) + j;                     // window-relative input
            out[i] = at < staged ? win[at] : in[ip0 + at];
            par[i] = static_cast<uint16_t>(i + kS);
          } else {
            par[i] = parent(os_t, j, f + 1);
          }
        }
      }
      __syncthreads();
    }
    lap(4);
    op0 = op_end;
    if (term != kExit) break;                                    // the stream's end, or a bad tag
    ip0 = s_next;
  }

  // 5. resolve inside the segment; parents before it stay external
  const int covered = state == 0 ? (op0 < hi ? op0 : hi) : 0;
  int ext = 0;
  if (covered > 0) {
    const int rcap = 33 - __clz(covered);
    for (int r = 0; r < rcap; ++r) {
      ++rounds;
      int changed = 0;
      for (int i = tid; i < covered; i += kThreads) {
        const int p = par[i];
        if (p >= kS) {
          const int q = par[p - kS];
          if (q != p) {                             // p is a copy byte: take its parent
            par[i] = static_cast<uint16_t>(q);
            changed = 1;
          }
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
  }
  // each thread owns 16-byte pieces of the segment: it resolves a piece in
  // registers from 16-byte reads of its parents and bytes, and writes every
  // piece with no external byte at once
  uint8_t* dst = gout + base;
  const bool vec = (reinterpret_cast<uintptr_t>(gout) & 15) == 0;
  unsigned lo = UINT_MAX;                       // the first external byte read
  // piece c's bytes in v, but its external bytes; true if it has any
  auto piece = [&](int c, uint4& v) {
    const uint4 pa = reinterpret_cast<const uint4*>(par)[2 * c];
    const uint4 pb = reinterpret_cast<const uint4*>(par)[2 * c + 1];
    v = reinterpret_cast<const uint4*>(out)[c];
    const uint32_t pw[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    uint32_t vw[4] = {v.x, v.y, v.z, v.w};
    bool left = false;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int i = c * 16 + b;
      const int p = (pw[b >> 1] >> (16 * (b & 1))) & 0xFFFF;
      int byte = -1;
      if (i >= covered) {
      } else if (p >= kS) {
        if (p - kS != i) byte = out[p - kS];    // a literal byte: never changes
      } else {
        left = true;
        lo = min(lo, static_cast<unsigned>(p));
      }
      if (byte >= 0)
        vw[b >> 2] = (vw[b >> 2] & ~(0xFFu << (8 * (b & 3)))) | (static_cast<uint32_t>(byte) << (8 * (b & 3)));
    }
    v = make_uint4(vw[0], vw[1], vw[2], vw[3]);
    return left;
  };
  auto put = [&](int c, const uint4& v) {       // piece c to the output
    if (vec && c * 16 + 16 <= covered) {
      reinterpret_cast<uint4*>(dst)[c] = v;
    } else {
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(&v);
      for (int b = 0; b < 16 && c * 16 + b < covered; ++b) dst[c * 16 + b] = vb[b];
    }
  };
  uint32_t held = 0;                            // bit r: piece tid + r * kThreads waits
  for (int r = 0; r < kPieces; ++r) {
    const int c = tid + r * kThreads;
    if (c * 16 >= covered) break;
    uint4 v;
    if (piece(c, v)) {
      held |= 1u << r;                          // its resolved bytes back, for after the wait
      reinterpret_cast<uint4*>(out)[c] = v;     // (only copy bytes change: no reader sees them)
    } else {
      put(c, v);
    }
  }
  const unsigned lo_all = block_min(lo, reinterpret_cast<unsigned*>(s_warp), &s_red);
  if (lo_all != UINT_MAX) ext = 1;
  lap(5);

  // 6. external bytes from segment k - 1, final once its flag is up: its
  // tail from the first byte read staged in shared memory (the tables'
  // room) by 16-byte loads, gathered a byte a thread, then the held pieces
  if (ext > 0 && k > 0) {
    if (tid == 0) {
      while (ld_relaxed(&flag[k - 1]) == 0) {
      }
      __threadfence();                          // the flag before the bytes it covers
    }
    __syncthreads();
    uint8_t* tail = reinterpret_cast<uint8_t*>(nx);
    const uint8_t* prev = gout + base - kS;
    const int lo16 = static_cast<int>(lo_all) & ~15;
    if (vec) {
      for (int i = lo16 / 16 + tid; i < kS / 16; i += kThreads)
        reinterpret_cast<uint4*>(tail)[i] = __ldcg(reinterpret_cast<const uint4*>(prev) + i);
    } else {
      for (int i = lo16 + tid; i < kS; i += kThreads) tail[i] = __ldcg(prev + i);
    }
    __syncthreads();
    for (int i = 4 * tid; i < covered; i += 4 * kThreads) {   // 4 bytes a step
      const uint2 pp = *reinterpret_cast<const uint2*>(par + i);
      uint32_t w = *reinterpret_cast<const uint32_t*>(out + i);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = ((b < 2 ? pp.x : pp.y) >> (16 * (b & 1))) & 0xFFFF;
        if (p < kS && i + b < covered)
          w = (w & ~(0xFFu << (8 * b))) | (static_cast<uint32_t>(tail[p]) << (8 * b));
      }
      *reinterpret_cast<uint32_t*>(out + i) = w;
    }
    __syncthreads();
    for (int r = 0; r < kPieces; ++r)
      if (held >> r & 1) put(tid + r * kThreads, reinterpret_cast<const uint4*>(out)[tid + r * kThreads]);
  }
  lap(6);
  __syncthreads();
  if (tid == 0) {
    __threadfence();                            // the block's bytes (cumulative) before the flag
    st_relaxed(&flag[k], 1u);
    if (stamp) s_cyc[12] = global_ns();
    s_last = atomicAdd(&head->done, 1u) == static_cast<unsigned int>(nseg - 1);
  }
  __syncthreads();
  lap(7);
  if (s_last && tid == 0) {                      // every block has judged its tags
    __threadfence();
    const unsigned long long ev = ld_relaxed(&row->event);
    meta[0] = ev == 0 ? row->os_stop : 0;
    meta[1] = ev == 0 ? 0 : ((~ev & 1) ? E_OUTPUT_OVERRUN : E_DATA_MALFORMED);
  }
  if (stamp) {
    s_cyc[8] = windows;
    s_cyc[9] = tags;
    s_cyc[10] = rounds;
    s_cyc[11] = ext;
    for (int i = 0; i < kSegStamps; ++i) stamps[static_cast<int64_t>(k) * kSegStamps + i] = s_cyc[i];
  }
}

constexpr long long kWorkHead = sizeof(Head) + sizeof(RowHead);

long long chunks_of(long long slen) { return (slen >> kLog) + 1; }
long long segments_of(long long cap) { return cap / kS + 1; }

// Bytes of the workspace a stream of slen bytes and an output of cap bytes
// take: the heads, a word a chunk, then a cover (int64 os, int32 position)
// and an int32 flag a segment.
long long work_bytes(long long slen, long long cap) {
  return kWorkHead + 8 * chunks_of(slen) + 16 * segments_of(cap);
}

}  // namespace

extern "C" {

// work_bytes(slen, cap), for decode_stream._launch's allocation.
long long decode_stream_work_bytes(long long slen, long long cap) { return work_bytes(slen, cap); }

// Dynamic shared memory a block of kernel 0 (chain) or 1 (segment) takes.
int decode_stream_smem_bytes(int kernel) { return kernel == 0 ? kChainSmem : layout().total; }

// Decodes in[0:slen] into out[0:cap] on `stream`: cap = min(dst_len, (slen
// // 3 + 1) * 64) is also the overrun limit, limit = ceil(dst_len / 32768)
// * 32768 (at least 32768); meta = {produced, status} (int64); work:
// work_bytes(slen, cap) bytes, cleared here first; stamps:
// null, or kChainStamps int64 a chunk followed by kSegStamps a segment.
// Returns the first CUDA error, or 0.
int decode_stream_launch(const void* in, long long slen, void* out, long long cap,
                         long long limit, void* meta, void* work, void* stamps, void* stream) {
  if (slen < 0 || slen >= (1LL << 31) || cap < 0 || cap > (slen / 3 + 1) * 64 || limit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nchunks = chunks_of(slen), nseg = segments_of(cap);
  if (nseg >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(work, 0, work_bytes(slen, cap), st);
  if (e == cudaSuccess)
    e = raise_smem_once(reinterpret_cast<const void*>(chain_kernel), kChainSmem, 0);
  if (e == cudaSuccess)
    e = raise_smem_once(reinterpret_cast<const void*>(segment_kernel), layout().total, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  uint8_t* w = static_cast<uint8_t*>(work);
  Head* head = reinterpret_cast<Head*>(w);
  RowHead* row = reinterpret_cast<RowHead*>(w + sizeof(Head));
  auto* word = reinterpret_cast<unsigned long long*>(w + kWorkHead);
  auto* cover_os = reinterpret_cast<int64_t*>(w + kWorkHead + 8 * nchunks);
  auto* cover_pos = reinterpret_cast<int32_t*>(cover_os + nseg);
  auto* flag = reinterpret_cast<unsigned int*>(cover_pos + nseg);
  auto* sp = static_cast<int64_t*>(stamps);
  chain_kernel<<<static_cast<unsigned int>(nchunks), kThreads, kChainSmem, st>>>(
      static_cast<const uint8_t*>(in), slen, head, row, word, cover_os, cover_pos,
      static_cast<int>(nseg), sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  segment_kernel<<<static_cast<unsigned int>(nseg), kThreads, layout().total, st>>>(
      static_cast<const uint8_t*>(in), slen, static_cast<uint8_t*>(out), cap, limit,
      static_cast<int64_t*>(meta), head, row, cover_os, cover_pos, flag, static_cast<int>(nseg),
      sp == nullptr ? nullptr : sp + nchunks * kChainStamps);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"