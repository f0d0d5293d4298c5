// Batched independent-block Snappy decode for Hopper (sm_90a).
//
// Replaces csnappy_tpu/ops/decode_fused.py::_kernel in both of its modes:
// block mode (_compiled) and stream mode (_compiled_streamed).  Here the two
// are one entry: block b reads its compressed input at src + offs[b], so
// block mode passes offs[b] = b * row_width and stream mode passes the
// segment offsets of one contiguous stream.
//
// What bounds it on this card: not bytes.  A 32 KiB block moves ~16 KiB in
// and 32 KiB out, microseconds of HBM time for a whole batch.  The bound is
// the tag chain: tag N's start depends on tag N-1's length
// (csnappy_decompress.c:345), and a copy reads bytes earlier copies wrote.
// A batch's blocks run side by side on the SMs, so a kernel takes one
// block's critical path, and the only lever is parallelism inside a block.
//
// decode_kernel, for rows of at most kFastMax = 32,768 bytes (every route of
// the API: fragments, segments and pages), one thread block of kThreads per
// Snappy block.  The block's output, a parent per output byte and a window
// of its input live in shared memory, where byte gathers are native; the
// phases are the JAX kernel's (decode_fused.py:1-53) without its TPU
// encodings.  In windows of kWin input bytes (a legal 32 KiB block can take
// 196,608 B of input: one-byte literals with 5-byte headers):
//   1. stage the window (and 16 bytes past it) in shared memory;
//   2. parse every position in parallel as if a tag started there: nx[p],
//      the next tag's start (kExit past the window, kBad when the header or
//      the literal's body runs past slen); then the tables 2, 4 and 8 tags
//      ahead by pointer doubling, nx2[p] = nx[nx[p]] and so on, a stop
//      (>= the window's limit) propagating;
//   3. one thread walks the real tag chain from the window's first tag over
//      the 8-ahead table, eight tags a dependent shared load, and lists a
//      chain point every eight tags; then each chain point's eight tags are
//      listed in parallel from the tables (at most kWin / 2 tags: every tag
//      advances >= 2 bytes);
//   4. each thread judges 4 listed tags: their lengths, a block scan of the
//      lengths for each tag's output start, then every event at once
//      (truncated header or body, offset 0 or past the output start ->
//      E_DATA_MALFORMED; end past dlim -> E_OUTPUT_OVERRUN; the offset check
//      first, as csnappy_decompress.c:295-317) and the first in tag order by
//      a block min-reduction.  An event ends the block: status set,
//      produced 0, the row all zero;
//   5. cover: each tag's index is scattered at its output start and a
//      segmented max-scan (a warp a segment, 32 bytes a step) gives every
//      output byte its tag; the same pass writes literal bytes and the
//      parent of each copy byte: byte j of a copy at os with offset off
//      reads os - off + j % off (decode_fused.py:530-547), always before os,
//      so self-overlap resolves in one step.
// After the last window:
//   6. resolve: parents collapse by pointer jumping in place (par[i] =
//      par[par[i]]) until every copy byte points at a literal byte: at
//      most ceil(log2(produced)) rounds (15 at 32 KiB) whatever the data,
//      since a chain of d hops halves each round; a round that changes
//      nothing ends it early;
//   7. gather: out[i] = out[par[i]] for every copy byte;
//   8. write the row: decoded bytes, zeros past produced, 16 bytes a store
//      where the row allows; then produced and status.
// No loop runs longer than the row's size allows: windows <= 6 (dlim + 1)
// / kWin + 2 (each valid tag makes >= 1 byte a 6 input bytes), the walk <=
// kWin / 16 steps, resolve <= ceil(log2 produced) rounds.
//
// Shared memory (layout(), width w): the output (w), the parents / cover
// (2 w), the staged window (kWin + 16), the four next-tag tables (2 kWin
// each), the chain points (kWin / 8), the tag list and the tags' output
// starts (kWin each): 189,456 B at w = 32,768, 103,440 B at 4,096 (two
// blocks an SM).
//
// Rows wider than kFastMax take csrc/decode_wide.cu's kernels, chosen by
// width before the launch (ops/decode_fused.py::kernel_for).
//
// With a non-null `stamps` (kStamps int64 a block), thread 0 writes the SM
// cycles each phase took, summed over the windows: staged, parsed, walked,
// judged, covered, resolved, gathered, written at 0..7; then at kStamps - 3
// .. kStamps - 1 the windows, the tags walked and the resolve rounds.
// COPY_4 offsets keep their 32-bit value.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kFastMax = 32768;         // widest row decode_kernel takes
constexpr int kWin = 8192;              // input bytes a window
constexpr int kStage = kWin + 16;       // staged: a tag's header reaches 4 bytes past the window
constexpr int kTagsPerThread = kWin / 2 / kThreads;
constexpr int kLevels = 4;              // next-tag tables: 1, 2, 4 and 8 tags ahead
constexpr int kStep = 1 << (kLevels - 1);   // tags a walk step
constexpr uint16_t kExit = 0xFFFE;      // nx: the next tag starts past the window
constexpr uint16_t kBad = 0xFFFF;       // nx: the tag's header or body runs past slen
constexpr int kStamps = 16;
constexpr int kSmemDefault = 48 * 1024;
constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Byte offsets of decode_kernel's shared arrays for rows of w bytes.
struct Layout {
  int out, par, win, nx, cp, tl, tos, total;
};

// nx holds kLevels tables of kWin uint16: nx, nx2, nx4, nx8 (the 2^k-th
// next tag); cp the walk's chain points, one every kStep tags.
__host__ __device__ constexpr Layout layout(int w) {
  const int par = align16(w);
  const int win = par + align16(2 * w);
  const int nx = win + kStage;
  const int cp = nx + kLevels * 2 * kWin;
  const int tl = cp + 2 * (kWin / 2 / kStep);
  const int tos = tl + kWin;
  return Layout{0, par, win, nx, cp, tl, tos, tos + kWin};
}

static_assert(layout(kFastMax).total <= 232448 - 1024, "a block's shared memory on the H100");
static_assert(kTagsPerThread * kThreads * 2 == kWin, "four listed tags a thread");

// A tag at window position p, with `avail` input bytes left from p to slen.
struct Tag {
  int64_t len;      // bytes it produces (a literal's may exceed the row)
  uint32_t off;     // a copy's offset
  int hdr;          // header bytes
  bool lit, bad;    // bad: the header or the literal's body runs past slen
};

__device__ __forceinline__ Tag parse_tag(const uint8_t* w, int p, int64_t avail) {
  Tag t;
  const uint32_t c = w[p];
  const uint32_t u = c >> 2;
  t.off = 0;
  t.lit = (c & 3) == 0;
  if (t.lit) {
    if (u < 60) {
      t.hdr = 1;
      t.len = u + 1;
    } else {
      const int nb = static_cast<int>(u) - 59;
      uint32_t v = 0;
      for (int k = 0; k < nb; ++k) v |= static_cast<uint32_t>(w[p + 1 + k]) << (8 * k);
      t.hdr = 1 + nb;
      t.len = static_cast<int64_t>(v) + 1;
    }
    t.bad = t.hdr > avail || t.hdr + t.len > avail;
  } else if ((c & 3) == 1) {
    t.hdr = 2;
    t.len = ((u & 7) + 4);
    t.off = ((u >> 3) << 8) | w[p + 1];
    t.bad = avail < 2;
  } else if ((c & 3) == 2) {
    t.hdr = 3;
    t.len = u + 1;
    t.off = w[p + 1] | (static_cast<uint32_t>(w[p + 2]) << 8);
    t.bad = avail < 3;
  } else {
    t.hdr = 5;
    t.len = u + 1;
    t.off = w[p + 1] | (static_cast<uint32_t>(w[p + 2]) << 8) |
            (static_cast<uint32_t>(w[p + 3]) << 16) | (static_cast<uint32_t>(w[p + 4]) << 24);
    t.bad = avail < 5;
  }
  return t;
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

// Minimum over the block of one value a thread, to *out (all threads see it
// after the call).
__device__ void block_min(unsigned v, unsigned* s_warp, unsigned* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const unsigned m = __reduce_min_sync(kFull, s_warp[lane]);
    if (lane == 0) *out = m;
  }
  __syncthreads();
}

// Phase cycles and counts of one block, summed in shared memory by thread 0
// and written to stamps[blockIdx.x * kStamps ..] at the end.
struct Clock {
  int64_t* stamps;
  long long* sum;   // kStamps in shared memory
  long long last;
  __device__ void start() {
    if (stamps == nullptr || threadIdx.x != 0) return;
    for (int i = 0; i < kStamps; ++i) sum[i] = 0;
    last = clock64();
  }
  __device__ void lap(int i) {
    if (stamps == nullptr || threadIdx.x != 0) return;
    const long long now = clock64();
    sum[i] += now - last;
    last = now;
  }
  __device__ void count(int i, long long n) {
    if (stamps != nullptr && threadIdx.x == 0) sum[i] = n;
  }
  __device__ void write() {
    if (stamps == nullptr || threadIdx.x != 0) return;
    for (int i = 0; i < kStamps; ++i) stamps[blockIdx.x * kStamps + i] = sum[i];
  }
};

// Writes a row of `width` bytes: out[0, prod), then zeros.
__device__ void write_row(const uint8_t* out, int prod, uint8_t* row, int64_t width) {
  if ((width & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (int64_t c = threadIdx.x; c < width / 16; c += blockDim.x) {
      const int64_t base = c * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (base + 16 <= prod) {
        v = reinterpret_cast<const uint4*>(out)[c];
      } else if (base < prod) {
        uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
        for (int k = 0; k < prod - base; ++k) vb[k] = out[base + k];
      }
      reinterpret_cast<uint4*>(row)[c] = v;
    }
  } else {
    for (int64_t i = threadIdx.x; i < width; i += blockDim.x) row[i] = i < prod ? out[i] : 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ offs,
              const int32_t* __restrict__ slens, const int32_t* __restrict__ dlims,
              uint8_t* __restrict__ out_rows, int width, int32_t* __restrict__ produced,
              int32_t* __restrict__ status, int64_t* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout ly = layout(width);
  uint8_t* out = smem + ly.out;
  uint16_t* par = reinterpret_cast<uint16_t*>(smem + ly.par);   // cover, then parents
  uint8_t* win = smem + ly.win;
  uint16_t* nx = reinterpret_cast<uint16_t*>(smem + ly.nx);     // kLevels tables
  uint16_t* cp = reinterpret_cast<uint16_t*>(smem + ly.cp);
  uint16_t* tl = reinterpret_cast<uint16_t*>(smem + ly.tl);     // tag starts, then fields
  uint16_t* tos = reinterpret_cast<uint16_t*>(smem + ly.tos);   // tags' output starts
  __shared__ int s_warp[kWarps];
  __shared__ unsigned s_first;
  __shared__ int s_n, s_k, s_term, s_total, s_next;
  __shared__ long long s_cyc[kStamps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* in = src + offs[b];
  const int slen = slens[b];
  const int dlim = min(dlims[b], width);                    // the row bounds the output
  Clock clk{stamps, s_cyc};
  clk.start();

  int ip0 = 0, op0 = 0, state = 0, windows = 0, tags = 0;   // state: 0 ok, < 0 an event
  const int max_windows = static_cast<int>((6LL * (dlim + 1) + 5) / kWin) + 2;
  while (ip0 < slen && state == 0 && windows < max_windows) {
    ++windows;
    // 1. stage
    const int avail0 = slen - ip0;
    const int staged = avail0 < kStage ? avail0 : kStage;
    for (int i = tid; i < kStage; i += kThreads) win[i] = i < staged ? in[ip0 + i] : 0;
    __syncthreads();
    clk.lap(0);

    // 2. parse every position, then the tables 2, 4 and 8 tags ahead (a
    // stop, >= lim, propagates: the table gives the first stop on the way)
    const int lim = avail0 < kWin ? avail0 : kWin;             // tags start below lim
    for (int p = tid; p < lim; p += kThreads) {
      const Tag t = parse_tag(win, p, avail0 - p);
      const int64_t nxt = p + t.hdr + t.len * t.lit;
      nx[p] = t.bad ? kBad : (nxt < kWin ? static_cast<uint16_t>(nxt) : kExit);
    }
    __syncthreads();
    for (int k = 1; k < kLevels; ++k) {
      const uint16_t* a = nx + (k - 1) * kWin;
      uint16_t* d = nx + k * kWin;
      for (int p = tid; p < lim; p += kThreads) {
        const int q = a[p];
        d[p] = q < lim ? a[q] : static_cast<uint16_t>(q);
      }
      __syncthreads();
    }
    clk.lap(1);

    // 3. the walk: one thread, kStep tags a dependent load, lists a chain
    // point every kStep tags; then every chain point lists its kStep tags
    const uint16_t* nx2 = nx + kWin;
    const uint16_t* nx4 = nx + 2 * kWin;
    if (tid == 0) {
      const uint16_t* nx8 = nx + 3 * kWin;
      int q = 0, k = 0;
      for (; k < kWin / 2 / kStep && q < lim; ++k) {
        cp[k] = static_cast<uint16_t>(q);
        q = nx8[q];
      }
      s_k = k;
      s_term = q;                       // >= lim: the end (q == avail0), kExit or kBad
    }
    __syncthreads();
    for (int c = tid; c < s_k; c += kThreads) {
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
          tl[c * kStep + j] = static_cast<uint16_t>(e[j]);
          ++v;
        }
      }
      if (c == s_k - 1) s_n = c * kStep + v;
    }
    __syncthreads();
    clk.lap(2);

    // 4. judge: lengths, output starts, events; the first event wins
    const int n = s_n, term = s_term;
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
        tg[j] = parse_tag(win, p, static_cast<int64_t>(avail0) - p);
        lc[j] = static_cast<int>(tg[j].len < kFastMax + 1 ? tg[j].len : kFastMax + 1);
        mine += lc[j];
      }
    }
    int os = op0 + block_excl_sum(mine, s_warp, &s_total);
    unsigned ev = UINT_MAX;                                     // tag * 4 + kind
#pragma unroll
    for (int j = 0; j < kTagsPerThread; ++j) {
      const int t = t0 + j;
      if (t < n) {
        const Tag& g = tg[j];
        unsigned kind = 0;
        if (g.bad || (!g.lit && (g.off == 0 || g.off > static_cast<uint32_t>(os))))
          kind = 1;                                             // malformed
        else if (os + g.len > dlim)
          kind = 2;                                             // overrun
        if (kind != 0 && ev == UINT_MAX) ev = static_cast<unsigned>(t) * 4 + kind;
        tos[t] = static_cast<uint16_t>(os < 0xFFFF ? os : 0xFFFF);
        tl[t] = static_cast<uint16_t>(g.lit ? 0x8000 | (pj[j] + g.hdr) : g.off);
        if (t == n - 1 && term == kExit)                        // the next window's first tag
          s_next = ip0 + pj[j] + g.hdr + static_cast<int>(g.lit ? g.len : 0);
        os += lc[j];
      }
    }
    block_min(ev, reinterpret_cast<unsigned*>(s_warp), &s_first);
    clk.lap(3);
    if (s_first != UINT_MAX) {
      state = (s_first & 3) == 1 ? E_DATA_MALFORMED : E_OUTPUT_OVERRUN;
      break;
    }

    // 5. cover: every output byte of the window's tags gets its tag, then
    // literals get their bytes and copies their parents
    const int op_end = op0 + s_total;
    for (int i = op0 + tid; i < op_end; i += kThreads) par[i] = 0;
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) par[tos[t]] = static_cast<uint16_t>(t);
    __syncthreads();
    const int m = op_end - op0;
    const int seg = ((m + kWarps - 1) / kWarps + 31) & ~31;    // a warp's bytes
    const int s0 = op0 + warp * seg;
    const int s1 = min(s0 + seg, op_end);
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
          const int at = (f & 0x7FFF) + j;                       // window-relative input
          out[i] = at < staged ? win[at] : in[ip0 + at];
          par[i] = static_cast<uint16_t>(i);
        } else {
          par[i] = static_cast<uint16_t>(os_t - f + (j < f ? j : j % f));
        }
      }
    }
    __syncthreads();
    clk.lap(4);
    op0 = op_end;
    if (term != kExit) break;                                    // the stream's end
    ip0 = s_next;
  }

  // 6. resolve: pointer jumping, at most ceil(log2(op0)) rounds
  int rounds = 0;
  if (state == 0) {
    const int cap = op0 > 1 ? 32 - __clz(op0 - 1) : 0;
    for (int r = 0; r < cap; ++r) {
      ++rounds;
      int changed = 0;
      for (int i = tid; i < op0; i += kThreads) {
        const int p = par[i];
        if (p != i) {
          const int q = par[p];
          if (q != p) {
            par[i] = static_cast<uint16_t>(q);
            changed = 1;
          }
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
  }
  clk.lap(5);
  // 7. gather copy bytes from their literal bytes
  if (state == 0) {
    for (int i = tid; i < op0; i += kThreads) {
      const int p = par[i];
      if (p != i) out[i] = out[p];
    }
  }
  __syncthreads();
  clk.lap(6);

  // 8. the row
  const int prod = state == 0 ? op0 : 0;
  write_row(out, prod, out_rows + static_cast<int64_t>(b) * width, width);
  if (tid == 0) {
    produced[b] = prod;
    status[b] = state;
  }
  clk.lap(7);
  clk.count(kStamps - 3, windows);
  clk.count(kStamps - 2, tags);
  clk.count(kStamps - 1, rounds);
  clk.write();
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

extern "C" {

// Launches decode_kernel, nblocks blocks, on `stream` (out_stride <=
// 32,768); stamps: null, or kStamps int64 a block.  Returns the first CUDA
// error, or 0.
int decode_blocks_launch(const void* src, const void* offs, const void* slens,
                         const void* dlims, void* out, long long out_stride,
                         void* produced, void* status, int nblocks, void* stamps, void* stream) {
  if (out_stride < 0 || out_stride > kFastMax) return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const int smem = layout(static_cast<int>(out_stride)).total;
  if (smem > kSmemDefault)
    e = raise_smem_once(reinterpret_cast<const void*>(decode_kernel), layout(kFastMax).total, 0);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  decode_kernel<<<nblocks, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(offs),
      static_cast<const int32_t*>(slens), static_cast<const int32_t*>(dlims),
      static_cast<uint8_t*>(out), static_cast<int>(out_stride),
      static_cast<int32_t*>(produced), static_cast<int32_t*>(status),
      static_cast<int64_t*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

// decode_kernel's shared arrays for rows of `width` bytes: the byte offsets
// of out, par, win, nx, cp, tl, tos and the total, into fields[0..7].
void decode_blocks_layout(int width, int* fields) {
  const Layout ly = layout(width);
  const int v[8] = {ly.out, ly.par, ly.win, ly.nx, ly.cp, ly.tl, ly.tos, ly.total};
  for (int i = 0; i < 8; ++i) fields[i] = v[i];
}

const char* decode_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
