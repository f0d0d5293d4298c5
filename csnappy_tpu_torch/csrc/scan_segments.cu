// Whole-stream boundary scan for Hopper (sm_90a).
//
// Replaces csnappy_tpu/ops/decode_ws.py::_scan_kernel (_scan_compiled) and the
// dense parse in front of it (_entries).  One walk of a headerless stream's
// tag chain records, for every 32 KiB output segment k, the compressed
// offset of the tag that covers output byte k * 32768: each tag at p with
// output start pp writes seg[ceil(pp / 32768)] = p, and the last writer of a
// slot wins.  Slots at or past nslot - 1 share the last one.  The walk
// starts at 0 and stops at the first position whose entry is 0 (past the
// stream, truncated, a literal above 32 KiB, a tag producing more than
// 32768 bytes or advancing more than 32773), which includes the stream's
// end; that position writes its slot last, as the TPU walk's stalled steps
// do.  meta = {p, pp, 0, steps} where it stopped; slots no one wrote keep
// the stream's length.
//
// What bounds it on this card: not bytes (the stream is read once).  The
// chain is: a tag's start depends on the tag before it, so one thread walks
// it, and one thread chasing ~77k tags (urls.10K.snappy) through device
// memory would pay a dependent L2/HBM load each, tens of ms.  So the walk
// runs out of shared memory.  One thread block stages a window of kWin
// stream positions; all threads compute the window's entries
// adv | prod << 16 in parallel, then fuse them kLevels times, as the TPU
// kernel pair- and quad-fuses its windows: a group of up to 2^kLevels small
// tags (adv, prod <= 255) that lie in the window is one entry of its total
// advance, total output and last tag's advance.  Thread 0 then walks the
// window, a group per dependent shared-memory load, or one tag where a
// group would cross a segment boundary, until it leaves the window or
// stops; the block stages the next window at the walk's position.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWin = 16384;              // stream positions per window
constexpr int kPad = 16;                 // bytes staged past the window (a tag's header)
constexpr int kLevels = 4;               // groups of up to 16 tags
constexpr int64_t kSeg = 32768;
constexpr uint32_t kSmall = 255;         // adv and prod of a tag that may join a group

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

// Group word: total advance (12 bits) | total output << 12 (12 bits) | the
// last tag's advance << 24.
__device__ __forceinline__ uint32_t g_adv(uint32_t g) { return g & 0xFFF; }
__device__ __forceinline__ uint32_t g_prod(uint32_t g) { return (g >> 12) & 0xFFF; }

__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint8_t* __restrict__ src, int64_t slen, int32_t* __restrict__ seg, int nslot,
            int64_t* __restrict__ meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* ent = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ga = ent + kWin;
  uint32_t* gb = ga + kWin;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(gb + kWin);   // kWin + kPad
  __shared__ int64_t s_p, s_pp, s_lastp, s_steps;
  __shared__ int s_cur, s_done;

  for (int k = threadIdx.x; k < nslot; k += kThreads) seg[k] = static_cast<int32_t>(slen);
  if (threadIdx.x == 0) { s_p = 0; s_pp = 0; s_lastp = 0; s_steps = 0; s_cur = -1; s_done = 0; }
  __syncthreads();

  while (!s_done) {
    const int64_t p0 = s_p;
    for (int i = threadIdx.x; i < kWin + kPad; i += kThreads)
      bytes[i] = (p0 + i < slen) ? src[p0 + i] : 0;
    __syncthreads();
    for (int i = threadIdx.x; i < kWin; i += kThreads) {
      const uint32_t e = entry(bytes + i, p0 + i, slen);
      ent[i] = e;
      const uint32_t adv = e & 0xFFFF, prod = e >> 16;
      ga[i] = (e != 0 && adv <= kSmall && prod <= kSmall) ? (adv | (prod << 12) | (adv << 24)) : 0;
    }
    __syncthreads();
    uint32_t* g = ga;
    uint32_t* h = gb;
    for (int level = 0; level < kLevels; ++level) {
      for (int i = threadIdx.x; i < kWin; i += kThreads) {
        const uint32_t x = g[i];
        const int j = i + static_cast<int>(g_adv(x));
        const uint32_t y = (x != 0 && j < kWin) ? g[j] : 0;
        h[i] = y ? ((g_adv(x) + g_adv(y)) | ((g_prod(x) + g_prod(y)) << 12) | (y & 0xFF000000u)) : x;
      }
      __syncthreads();
      uint32_t* t = g;
      g = h;
      h = t;
    }

    if (threadIdx.x == 0) {
      int64_t p = p0, pp = s_pp, lastp = s_lastp, steps = s_steps;
      int cur = s_cur, done = 0;
      while (true) {
        int64_t at = p;                               // the last tag of this step
        uint32_t a, q;
        if (p < slen && p - p0 >= kWin) break;        // stage the next window here
        const uint32_t x = p < slen ? g[p - p0] : 0;
        const int64_t slot0 = (pp + kSeg - 1) >> 15;
        if (x != 0 && slot0 == ((pp + g_prod(x) + kSeg - 2) >> 15)) {
          a = g_adv(x);                               // every tag of the group, one slot
          q = g_prod(x);
          at = p + a - (x >> 24);
        } else {
          const uint32_t e = p < slen ? ent[p - p0] : 0;
          done = e == 0;                              // the stop writes its slot too
          a = e & 0xFFFF;
          q = e >> 16;
        }
        const int slot = static_cast<int>(slot0 < nslot - 1 ? slot0 : nslot - 1);
        if (slot != cur) {
          if (cur >= 0) seg[cur] = static_cast<int32_t>(lastp);
          cur = slot;
        }
        lastp = at;
        if (done) break;
        p += a;
        pp += q;
        ++steps;
      }
      if (done) {
        seg[cur] = static_cast<int32_t>(lastp);
        meta[0] = p;
        meta[1] = pp;
        meta[2] = 0;
        meta[3] = steps;
      }
      s_p = p;
      s_pp = pp;
      s_lastp = lastp;
      s_steps = steps;
      s_cur = cur;
      s_done = done;
    }
    __syncthreads();
  }
}

constexpr size_t kSmem = 3 * 4 * kWin + kWin + kPad;

}  // namespace

extern "C" {

// Scans src[0:slen] into seg[0:nslot] and meta[0:4] (int64) on `stream`, in
// one thread block.  Returns cudaGetLastError().
int scan_segments_launch(const void* src, long long slen, void* seg, int nslot, void* meta,
                         void* stream) {
  cudaError_t e = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), slen, static_cast<int32_t*>(seg), nslot,
      static_cast<int64_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

const char* scan_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
