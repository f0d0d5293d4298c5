// Batched independent-block Snappy decode for Hopper (sm_90a): rows wider
// than 32 KiB.
//
// Replaces csnappy_tpu/ops/decode_fused.py::_kernel, in both of its modes
// (block mode, _compiled, and stream mode, _compiled_streamed), for rows
// wider than kFastMax = 32,768 bytes; decode_blocks.cu's decode_kernel
// keeps the rows up to 32 KiB.  Row r reads its input at src + offs[r]
// (slens[r] bytes) and decodes it against its limit dlims[r] into a row of
// `width` bytes, under decode_kernel's contract: tags in order, the first
// error event in output order wins, within a tag the offset check before
// the space check, produced 0 unless the status is 0, the row zero past
// produced (all zero after an event), COPY_4 offsets with all 32 bits, so a
// copy may read any earlier byte of its row.  Widths are limited only by
// the int32 produced (below 2^31) and the card's memory.
//
// What bounds it on this card: two serial chains, not bytes.  Tag N's start
// depends on tag N-1's length, and a copy reads bytes that copies before it
// wrote, from anywhere earlier in the row.  One thread block a row, holding
// the row in shared memory (the port's first wide kernel), caps the row at
// what one block's shared memory holds and runs a whole row on one SM.
// Here both chains are cut so that each link costs one word of device
// memory, and everything else runs on many blocks a row, as
// decode_stream.cu does for one stream under its 32 KiB envelope (the chain
// pass, the window walk and the helpers are that decoder's, shared through
// decode_chain.cuh; the oracle's envelope here):
//
// wide_chain_kernel, one thread block per (row, chunk of C = 8,192 input
// positions), taken in (row, chunk) order by an atomic ticket.  Each block
// stages its chunk (plus a 16-byte halo), parses every position as if a tag
// started there and pointer-jumps in shared memory, first inside sub-chunks
// of 256 positions, then to the chunk's end, so that every position knows
// where its tag chain stops in the chunk (no tag starts there: a truncated
// header or literal, or the row's input end) or which tag leaves the chunk,
// and the output produced on the way.  The chain then costs one lookup a
// chunk: the block waits for its entry (position and output start, one
// 64-bit word published by the chunk whose exit landed in it), reads the
// exit from its tables and publishes the next entry.  A literal that skips
// whole chunks marks them skipped; the chunk holding the stop publishes it
// in the row's head.  Off the chain's path, each visited chunk writes the
// covering tag (the last chain tag whose output start is <= k * 32768) of
// every 32 KiB output segment k of its row whose start falls in its range.
//
// wide_segment_kernel, one thread block per (row, 32 KiB output segment),
// taken in (row, segment) order by a ticket; a row of limit dlim has
// dlim / 32768 + 1 segments, the last judging a tag that starts at dlim.
// Each block:
//   1. enters its covering tag at byte k * 32768 - os (a straddling literal
//      or copy; a segment wholly inside one literal is a plain copy);
//   2. walks its tags in windows of 8 KiB of input as decode_kernel does
//      (stage, parse every position, tables 2, 4 and 8 tags ahead, one
//      walking thread over the 8-ahead table, tags listed in parallel);
//   3. judges each tag that starts in the segment (truncated header or
//      body, offset 0 or past the output start: E_DATA_MALFORMED; an end
//      past dlim: E_OUTPUT_OVERRUN; the offset check first) and lowers the
//      row's 64-bit minimum of (output start, kind), so the first event in
//      output order wins;
//   4. covers its bytes in a 32-bit word each: a literal byte's value, or a
//      copy byte's one-hop parent os - off + j % off, inside the segment as
//      an index, before it as the row position;
//   5. pointer-jumps the indices inside the segment (at most 16 rounds), so
//      every byte ends at a value or at a position before the segment;
//   6. writes every 16-byte piece with no such position at once; only if
//      some byte reads an earlier segment, waits for the flags of the
//      segments it reads (segment-order tickets make every wait point
//      backwards, to a block already running or done, so none can
//      deadlock), reads those final bytes from device memory and writes the
//      held pieces; then publishes its own flag.
// The flag wait is the only serial step of the bytes: one word a segment,
// however deep copies chain (an offset-1 run over the row is the deepest),
// and none for a segment whose copies stay inside it.
//
// wide_finish_kernel, a grid over (row, 16 KiB tile): writes each row's
// produced and status from its head and zero-fills the row past produced
// (the whole row after an event).
//
// No thread walks all the tags of a row, and every loop is bounded by the
// row's sizes: chunks by slen, windows a segment by 6 * 32768 / 8192 + 3
// (each tag makes >= 1 byte a 6 input bytes), resolve rounds by 16.  Every
// input read is bounded by slens[r] (bytes past it stage as 0), every write
// by the row's limit.  One call is one memset of the workspace (a head, a
// head a row, a word a chunk, 16 bytes a segment) and the three launches on
// one stream.  With a non-null `stamps`, thread 0 of each block writes its
// phases' SM cycles (clock64()) and counts: kChainStamps int64 a chunk,
// then kSegStamps a segment, by ticket.

#include "decode_chain.cuh"

namespace {

constexpr int kFastMax = 32768;             // decode_kernel takes rows up to this width

// The row of ticket t: the last r with first[r] <= t (first: nrows + 1
// ascending prefix sums, first[0] = 0).
__device__ __forceinline__ int row_of(const int64_t* first, int nrows, int64_t t) {
  int lo = 0, hi = nrows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ====================================================== wide_chain_kernel

__global__ void __launch_bounds__(kThreads)
wide_chain_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ offs,
                  const int32_t* __restrict__ slens, const int64_t* __restrict__ chunk_first,
                  const int64_t* __restrict__ seg_first, int nrows, Head* __restrict__ head,
                  RowHead* __restrict__ rows, unsigned long long* __restrict__ word,
                  int64_t* __restrict__ cover_os, int32_t* __restrict__ cover_pos,
                  int64_t* __restrict__ stamps) {
  chain_block<false>([&] {
    const int g = static_cast<int>(atomicAdd(&head->ticket, 1u));
    const int r = row_of(chunk_first, nrows, g);
    const int64_t g0 = chunk_first[r], s0 = seg_first[r];
    return ChainJob{src + offs[r], slens[r], rows + r, word + g0, cover_os + s0, cover_pos + s0,
                    stamps == nullptr ? nullptr : stamps + static_cast<int64_t>(g) * kChainStamps,
                    g - static_cast<int>(g0), static_cast<int>(seg_first[r + 1] - s0)};
  });
}

// ==================================================== wide_segment_kernel

// a byte's word (par): an index < kS inside the segment until resolved, then
// kLit | its value, or kExt | the row position (< 2^31) of the byte before
// the segment it equals
constexpr uint32_t kExt = 0x80000000u;
constexpr uint32_t kLit = 0x40000000u;
// a listed tag's field (tl): a literal's window-relative input | kTlLit, or a copy's offset
constexpr uint32_t kTlLit = 0x80000000u;

// Byte offsets of wide_segment_kernel's shared arrays: the segment's words,
// the window, the four tables, the chain points, the tags' fields and their
// output starts.
struct Layout {
  int par, win, nx, cp, tl, tos, total;
};
__host__ __device__ constexpr Layout layout() {
  const int win = 4 * kS;
  const int nx = win + align16(kStage);
  const int cp = nx + kLevels * 2 * kWin;
  const int tl = cp + 2 * (kWin / 2 / kStep);
  const int tos = tl + 4 * (kWin / 2);
  return Layout{0, win, nx, cp, tl, tos, tos + 2 * (kWin / 2)};
}
static_assert(layout().total <= 232448 - 1024, "a block's shared memory on the H100");
static_assert(kTagsPerThread * kThreads * 2 == kWin, "four listed tags a thread");

// The word of byte j of a copy at segment-relative output start os (the
// segment at row position base) with offset off <= base + os.
__device__ __forceinline__ uint32_t parent(int64_t base, int os, int j, uint32_t off) {
  const int64_t p = static_cast<int64_t>(os) - off + (j < static_cast<int64_t>(off) ? j : j % off);
  return p >= 0 ? static_cast<uint32_t>(p) : kExt | static_cast<uint32_t>(base + p);
}

__global__ void __launch_bounds__(kThreads, 1)
wide_segment_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ offs,
                    const int32_t* __restrict__ slens, const int32_t* __restrict__ dlims,
                    const int64_t* __restrict__ seg_first, int nrows, uint8_t* __restrict__ gout,
                    int64_t width, Head* __restrict__ head, RowHead* __restrict__ rows,
                    const int64_t* __restrict__ cover_os, const int32_t* __restrict__ cover_pos,
                    unsigned int* __restrict__ flag, int64_t* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr Layout ly = layout();
  uint32_t* par = reinterpret_cast<uint32_t*>(smem + ly.par);   // cover, then words
  uint8_t* win = smem + ly.win;
  uint16_t* nx = reinterpret_cast<uint16_t*>(smem + ly.nx);
  uint16_t* cp = reinterpret_cast<uint16_t*>(smem + ly.cp);
  uint32_t* tl = reinterpret_cast<uint32_t*>(smem + ly.tl);     // tag starts, then fields
  uint16_t* tos = reinterpret_cast<uint16_t*>(smem + ly.tos);   // output starts in the segment
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_red;
  __shared__ int s_ticket, s_row, s_total, s_skip;
  __shared__ long long s_next;
  __shared__ long long s_cyc[kSegStamps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stamp = stamps != nullptr && tid == 0;
  long long last = 0;

  if (tid == 0) {
    const int g = static_cast<int>(atomicAdd(&head->seg_ticket, 1u));
    const int r = row_of(seg_first, nrows, g);
    s_ticket = g;
    s_row = r;
    if (stamp) {
      for (int i = 0; i < kSegStamps; ++i) s_cyc[i] = 0;
      last = clock64();
    }
    // an event of the row already found before this segment: no bytes needed
    const unsigned long long ev = ld_relaxed(&rows[r].event);
    const int64_t k = g - seg_first[r];
    s_skip = ev != 0 && static_cast<int64_t>(~ev >> 1) < k * kS;
  }
  __syncthreads();
  auto lap = [&](int i) {
    if (!stamp) return;
    const long long now = clock64();
    s_cyc[i] += now - last;
    last = now;
  };
  const int g = s_ticket, r = s_row;
  const int64_t s0 = seg_first[r];
  const int k = g - static_cast<int>(s0);
  const int64_t base = static_cast<int64_t>(k) * kS;
  const uint8_t* in = src + offs[r];
  const int64_t slen = slens[r];
  const int64_t dlim = dlims[r] < width ? dlims[r] : width;
  // base <= dlim: a row has dlim / kS + 1 segments
  const int hi = static_cast<int>(dlim - base < kS ? dlim - base : kS);           // bytes written
  const int jhi = static_cast<int>(dlim + 1 - base < kS ? dlim + 1 - base : kS);  // starts judged
  const int64_t p_stop = rows[r].p_stop;
  const int64_t cpos = cover_pos[g], cos = cover_os[g];
  int state = s_skip;        // 0: ok; 1: nothing more to do; < 0: an event here
  int op0 = 0;               // the next tag's output start, from the segment's start
  int64_t ip0 = cpos;
  int windows = 0, tags = 0, rounds = 0;

  // 1. the covering tag, when it starts before the segment
  if (state == 0 && cos < base) {
    if (cpos == p_stop) {
      state = 1;                                 // the row's stream ended before this segment
    } else {
      uint8_t h[5];
      for (int i = 0; i < 5; ++i) h[i] = cpos + i < slen ? in[cpos + i] : 0;
      const Tag t = parse_tag<false>(h, slen - cpos);   // a chain tag: not bad
      const int64_t end = cos + t.len - base;    // > 0
      const int m = static_cast<int>(end < hi ? end : hi);
      const int64_t j0 = base - cos;
      if (t.lit) {
        const uint8_t* s = in + cpos + t.hdr + j0;
        for (int i = tid; i < m; i += kThreads) par[i] = kLit | s[i];
      } else {
        // an offset past the bytes written is the event of an earlier segment
        const bool ok = t.off != 0 && t.off <= static_cast<uint64_t>(cos);
        for (int i = tid; i < m; i += kThreads)   // j0 + i < 64
          par[i] = ok ? parent(base, static_cast<int>(cos - base), static_cast<int>(j0) + i, t.off)
                      : kLit;
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
    window_tables<false>(in + ip0, staged, lim, avail0, win, nx);
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
        const int p = pj[j] = static_cast<int>(tl[t0 + j]);
        tg[j] = parse_tag<false>(win + p, avail0 - p);
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
        const Tag& gt = tg[j];
        if (os < jhi && ev == UINT_MAX) {
          const int64_t at = base + os;
          if (gt.bad || (!gt.lit && (gt.off == 0 || gt.off > static_cast<uint64_t>(at))))
            ev = static_cast<unsigned>(os) * 2;                 // malformed
          else if (at + gt.len > dlim)
            ev = static_cast<unsigned>(os) * 2 + 1;             // overrun
        }
        tos[t] = static_cast<uint16_t>(os < 0xFFFF ? os : 0xFFFF);
        tl[t] = gt.lit ? kTlLit | static_cast<uint32_t>(pj[j] + gt.hdr) : gt.off;
        if (t == n - 1 && term == kExit)                        // the next window's first tag
          s_next = ip0 + pj[j] + gt.hdr + (gt.lit ? gt.len : 0);
        os += lc[j];
      }
    }
    const unsigned first = block_min(ev, reinterpret_cast<unsigned*>(s_warp), &s_red);
    lap(3);
    if (first != UINT_MAX) {
      if (tid == 0)
        atomicMax(&rows[r].event, ~((static_cast<unsigned long long>(base) << 1) + first));
      state = (first & 1) ? E_OUTPUT_OVERRUN : E_DATA_MALFORMED;
      break;
    }

    // cover: every byte of the window's tags below hi gets its tag, then
    // literals their values and copies their parents
    const int op_end = op0 + s_total;
    const int c_end = op_end < hi ? op_end : hi;
    if (op0 < c_end) {
      for (int i = op0 + tid; i < c_end; i += kThreads) par[i] = 0;
      __syncthreads();
      for (int t = tid; t < n; t += kThreads)
        if (tos[t] < c_end) par[tos[t]] = static_cast<uint32_t>(t);
      __syncthreads();
      const int m = c_end - op0;
      const int sg = ((m + kWarps - 1) / kWarps + 31) & ~31;   // a warp's bytes
      const int w0 = op0 + warp * sg;
      const int w1 = min(w0 + sg, c_end);
      unsigned wmax = 0;
      for (int i = w0 + lane; i < w1; i += 32) wmax = max(wmax, par[i]);
      wmax = __reduce_max_sync(kFull, wmax);
      if (lane == 0) s_warp[warp] = static_cast<int>(wmax);
      __syncthreads();
      unsigned carry = __reduce_max_sync(kFull, lane < warp ? static_cast<unsigned>(s_warp[lane]) : 0u);
      for (int i0 = w0; i0 < w1; i0 += 32) {
        const int i = i0 + lane;
        unsigned v = i < w1 ? par[i] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v = max(v, u);
        }
        v = max(v, carry);
        carry = __shfl_sync(kFull, v, 31);
        if (i < w1) {
          const int os_t = tos[v];
          const uint32_t f = tl[v];
          const int j = i - os_t;
          if (f & kTlLit) {
            const int at = static_cast<int>(f & ~kTlLit) + j;      // window-relative input
            par[i] = kLit | (at < staged ? win[at] : in[ip0 + at]);
          } else {
            par[i] = parent(base, os_t, j, f);
          }
        }
      }
      __syncthreads();
    }
    lap(4);
    op0 = op_end;
    if (term != kExit) break;                                    // the row's end, or a bad tag
    ip0 = s_next;
  }

  // 5. resolve inside the segment; positions before it stay
  const int covered = state == 0 ? (op0 < hi ? op0 : hi) : 0;
  if (covered > 0) {
    const int rcap = 33 - __clz(covered);
    for (int rr = 0; rr < rcap; ++rr) {
      ++rounds;
      int changed = 0;
      for (int i = tid; i < covered; i += kThreads) {
        const uint32_t p = par[i];
        if (p < kS) {
          par[i] = par[p];
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
  }
  // each thread owns 16-byte pieces: it writes every piece with no byte
  // from before the segment at once and holds the others in registers
  uint8_t* row = gout + static_cast<int64_t>(r) * width;
  uint8_t* dst = row + base;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  unsigned lo = UINT_MAX, hi_seg = 0;           // the earlier segments read
  auto put = [&](int c, const uint4& v) {       // piece c to the output
    if (vec && c * 16 + 16 <= covered) {
      reinterpret_cast<uint4*>(dst)[c] = v;
    } else {
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(&v);
      for (int b = 0; b < 16 && c * 16 + b < covered; ++b) dst[c * 16 + b] = vb[b];
    }
  };
  // piece c's bytes into v, reading earlier segments' bytes only if `fetch`;
  // true if it has such a byte
  auto piece = [&](int c, uint4& v, bool fetch) {
    uint32_t vw[4] = {0, 0, 0, 0};
    bool left = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 pw = reinterpret_cast<const uint4*>(par)[4 * c + q];
      const uint32_t w4[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (c * 16 + q * 4 + b >= covered) continue;
        uint32_t byte = w4[b] & 0xFF;
        if (w4[b] & kExt) {
          const uint32_t x = w4[b] & ~kExt;
          left = true;
          lo = min(lo, x / kS);
          hi_seg = max(hi_seg, x / kS);
          byte = fetch ? __ldcg(row + x) : 0;
        }
        vw[q] |= byte << (8 * b);
      }
    }
    v = make_uint4(vw[0], vw[1], vw[2], vw[3]);
    return left;
  };
  uint32_t held = 0;                            // bit p: piece tid + p * kThreads waits
  for (int p = 0; p < kPieces; ++p) {
    const int c = tid + p * kThreads;
    if (c * 16 >= covered) break;
    uint4 v;
    if (piece(c, v, false)) held |= 1u << p;
    else put(c, v);
  }
  const unsigned lo_all = block_min(lo, reinterpret_cast<unsigned*>(s_warp), &s_red);
  const unsigned hi_all = ~block_min(~hi_seg, reinterpret_cast<unsigned*>(s_warp), &s_red);
  lap(5);

  // 6. bytes of earlier segments, final once their flags are up
  const int ext = lo_all != UINT_MAX;
  if (ext) {
    if (tid == 0) {
      for (unsigned s = lo_all; s <= hi_all; ++s)
        while (ld_relaxed(&flag[s0 + s]) == 0) {
        }
      __threadfence();                          // the flags before the bytes they cover
    }
    __syncthreads();
    for (int p = 0; p < kPieces; ++p) {
      if (held >> p & 1) {
        uint4 v;
        piece(tid + p * kThreads, v, true);
        put(tid + p * kThreads, v);
      }
    }
  }
  lap(6);
  __syncthreads();
  if (tid == 0) {
    __threadfence();                            // the block's bytes (cumulative) before the flag
    st_relaxed(&flag[g], 1u);
    if (stamp) s_cyc[12] = global_ns();
  }
  lap(7);
  if (stamp) {
    s_cyc[8] = windows;
    s_cyc[9] = tags;
    s_cyc[10] = rounds;
    s_cyc[11] = ext;
    for (int i = 0; i < kSegStamps; ++i) stamps[static_cast<int64_t>(g) * kSegStamps + i] = s_cyc[i];
  }
}

// ===================================================== wide_finish_kernel

constexpr int kFinishThreads = 256;
constexpr int kTile = 16384;                 // row bytes a block zero-fills

__global__ void __launch_bounds__(kFinishThreads)
wide_finish_kernel(const RowHead* __restrict__ rows, uint8_t* __restrict__ gout, int64_t width,
                   int32_t* __restrict__ produced, int32_t* __restrict__ status, int nrows,
                   int64_t tiles) {
  for (int64_t t = blockIdx.x; t < nrows * tiles; t += gridDim.x) {
    const int r = static_cast<int>(t / tiles);
    const int64_t j = t - static_cast<int64_t>(r) * tiles;
    const unsigned long long ev = rows[r].event;
    const int64_t prod = ev == 0 ? rows[r].os_stop : 0;
    if (j == 0 && threadIdx.x == 0) {
      produced[r] = static_cast<int32_t>(prod);
      status[r] = ev == 0 ? 0 : ((~ev & 1) ? E_OUTPUT_OVERRUN : E_DATA_MALFORMED);
    }
    const int64_t a = prod > j * kTile ? prod : j * kTile;
    const int64_t b = (j + 1) * kTile < width ? (j + 1) * kTile : width;
    if (a >= b) continue;
    uint8_t* row = gout + static_cast<int64_t>(r) * width;
    const int64_t head = ((16 - (reinterpret_cast<uintptr_t>(row + a) & 15)) & 15);
    const int64_t v0 = a + head < b ? a + head : b;          // first 16-byte aligned byte
    const int64_t nv = (b - v0) / 16;
    for (int64_t i = a + threadIdx.x; i < v0; i += kFinishThreads) row[i] = 0;
    for (int64_t i = threadIdx.x; i < nv; i += kFinishThreads)
      reinterpret_cast<uint4*>(row + v0)[i] = make_uint4(0, 0, 0, 0);
    for (int64_t i = v0 + nv * 16 + threadIdx.x; i < b; i += kFinishThreads) row[i] = 0;
  }
}

constexpr long long kWorkHead = sizeof(Head);

long long work_bytes(long long nrows, long long nchunks, long long nseg) {
  return kWorkHead + static_cast<long long>(sizeof(RowHead)) * nrows + 8 * nchunks + 16 * nseg;
}

}  // namespace

extern "C" {

// Bytes of the workspace of a call (decode_fused.wide_work_bytes reads it): the
// head, a head a row, a word a chunk, then a cover (int64 output start,
// int32 position) and an int32 flag a segment.
long long decode_wide_work_bytes(long long nrows, long long nchunks, long long nseg) {
  return work_bytes(nrows, nchunks, nseg);
}

// Dynamic shared memory a block of kernel 0 (chain) or 1 (segment) takes.
int decode_wide_smem_bytes(int kernel) { return kernel == 0 ? kChainSmem : layout().total; }

// Decodes nrows rows into out (nrows x width bytes, width > 32,768) on
// `stream`.  firsts: int64[2 (nrows + 1)] on the card, each row's first
// chunk (nchunks after the last), then its first segment (nseg after the
// last): row r has (slens[r] >> 13) + 1 chunks and min(dlims[r], width) /
// 32768 + 1 segments.  work: decode_wide_work_bytes(nrows, nchunks, nseg)
// bytes, cleared here first; stamps: null, or kChainStamps int64 a chunk
// followed by kSegStamps a segment.  Returns the first CUDA error, or 0.
int decode_wide_launch(const void* src, const void* offs, const void* slens, const void* dlims,
                       const void* firsts, void* out, long long width, void* produced,
                       void* status, int nrows, long long nchunks, long long nseg, void* work,
                       void* stamps, void* stream) {
  if (width <= kFastMax || width >= (1LL << 31) || nrows < 0 || nchunks < nrows || nseg < nrows ||
      nchunks >= (1LL << 31) || nseg >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(work, 0, work_bytes(nrows, nchunks, nseg), st);
  if (e == cudaSuccess)
    e = raise_smem_once(reinterpret_cast<const void*>(wide_chain_kernel), kChainSmem, 0);
  if (e == cudaSuccess)
    e = raise_smem_once(reinterpret_cast<const void*>(wide_segment_kernel), layout().total, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  uint8_t* w = static_cast<uint8_t*>(work);
  Head* head = reinterpret_cast<Head*>(w);
  RowHead* rows = reinterpret_cast<RowHead*>(w + kWorkHead);
  auto* word = reinterpret_cast<unsigned long long*>(rows + nrows);
  auto* cover_os = reinterpret_cast<int64_t*>(word + nchunks);
  auto* cover_pos = reinterpret_cast<int32_t*>(cover_os + nseg);
  auto* flag = reinterpret_cast<unsigned int*>(cover_pos + nseg);
  const auto* chunk_first = static_cast<const int64_t*>(firsts);
  const int64_t* seg_first = chunk_first + nrows + 1;
  auto* sp = static_cast<int64_t*>(stamps);
  const auto* in = static_cast<const uint8_t*>(src);
  const auto* of = static_cast<const int64_t*>(offs);
  const auto* sl = static_cast<const int32_t*>(slens);
  wide_chain_kernel<<<static_cast<unsigned int>(nchunks), kThreads, kChainSmem, st>>>(
      in, of, sl, chunk_first, seg_first, nrows, head, rows, word, cover_os, cover_pos, sp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_segment_kernel<<<static_cast<unsigned int>(nseg), kThreads, layout().total, st>>>(
      in, of, sl, static_cast<const int32_t*>(dlims), seg_first, nrows, static_cast<uint8_t*>(out),
      width, head, rows, cover_os, cover_pos, flag,
      sp == nullptr ? nullptr : sp + nchunks * kChainStamps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (width + kTile - 1) / kTile;
  const long long blocks = nrows * tiles < 8192 ? nrows * tiles : 8192;
  wide_finish_kernel<<<static_cast<unsigned int>(blocks), kFinishThreads, 0, st>>>(
      rows, static_cast<uint8_t*>(out), width, static_cast<int32_t*>(produced),
      static_cast<int32_t*>(status), nrows, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
