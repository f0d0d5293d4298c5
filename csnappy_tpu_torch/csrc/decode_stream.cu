// Whole-stream Snappy decode for Hopper (sm_90a): the crossing-stream decoder.
//
// Replaces csnappy_tpu/ops/decode_stream.py::_kernel (_compiled).  It decodes
// ONE headerless stream whose tags and copies may cross 32 KiB output
// boundaries, with copy offsets up to 32768, under the JAX kernel's event
// rules (ops/decode_stream.py in this package states them).
//
// What bounds it on this card: not bytes.  The stream is one chain: tag N's
// start depends on tag N-1's length, and a copy may read the bytes of the
// copy before it, so the whole stream is one serial walk and one ordered copy
// resolution, in one thread block (segment k's copies read segment k-1's
// bytes, so segments are not independent as in decode_blocks.cu).  The TPU
// kernel ran a sequential grid over 32 KiB output segments and carried walk
// state, the straddling tag, a 32 KiB history ring and error minima across
// grid steps; here a loop inside the block takes the place of the grid, the
// walk stops at the first event in output order (which gives the minima by
// construction), and the history ring lives in shared memory.
//
// Design: the round structure of decode_blocks.cu, over an output ring.
//   1. stage a window of kWin compressed bytes in shared memory;
//   2. thread 0 walks up to kTags tags through it, recording each tag's
//      output start, source and length, until the round holds kRound output
//      bytes or an event ends the stream;
//   3. every warp copies literals from the input into the ring (warp-strided
//      over tags, lanes over bytes);
//   4. warp 0 resolves copies in tag order inside the ring: byte j of a copy
//      at os with offset off reads os - off + j % off, always before os and
//      at most 32768 back;
//   5. all threads flush the round's bytes from the ring to the output.
// The ring holds kRing = 64 KiB: the 32 KiB of history a copy may reach and
// the round's at most 32 KiB, so a round never overwrites what it reads.  A
// literal longer than a round goes alone, straight from the input to the
// output, and leaves its last 32 KiB in the ring.  Every header read is
// checked against the stream's length first, every write against the
// output limit, so no input makes the kernel read or write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 8192;                 // compressed bytes staged per round
constexpr int kTags = 2048;                // tags recorded per round
constexpr int kHist = 32768;               // farthest copy offset served
constexpr int kRing = 2 * kHist;           // output ring: history + one round
constexpr int kRound = kRing - kHist;      // output bytes one round may add
constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;
constexpr int32_t kCopyBit = 1 << 30;      // literals are at most 2^24 bytes

__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint8_t* __restrict__ in, int64_t slen, uint8_t* __restrict__ out,
              int64_t dlim, int64_t limit, int64_t* __restrict__ meta) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* t_os = reinterpret_cast<int32_t*>(smem);   // output start, from the round's start
  int32_t* t_src = t_os + kTags;                      // literal: input pos; copy: offset
  int32_t* t_len = t_src + kTags;                     // length | kCopyBit for copies
  uint8_t* win = reinterpret_cast<uint8_t*>(t_len + kTags);
  uint8_t* ring = win + kWin;                         // output byte o at ring[o % kRing]
  __shared__ int64_t s_ip, s_op, s_o0;
  __shared__ int s_nt, s_state, s_solo;               // state: 0 more, 1 done, <0 error

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) { s_ip = 0; s_op = 0; s_state = 0; }
  __syncthreads();

  while (s_state == 0) {
    const int64_t ip0 = s_ip;
    const int64_t wlim = (slen - ip0 > kWin) ? ip0 + kWin : slen;
    for (int64_t i = threadIdx.x; i < wlim - ip0; i += kThreads) win[i] = in[ip0 + i];
    __syncthreads();

    if (threadIdx.x == 0) {
      const uint8_t* w = win - ip0;                   // w[ip] == in[ip] inside the window
      const bool last = (wlim == slen);
      const int64_t o0 = s_op;
      int64_t ip = ip0, op = o0;
      int nt = 0, state = 0, solo = 0;
      while (nt < kTags) {
        if (ip == slen) { state = 1; break; }                       // consumed
        if (op >= limit) { state = E_DATA_MALFORMED; break; }       // full, tags left
        if (!last && ip + 5 > wlim) break;            // tag may reach past the window
        const uint32_t tag = w[ip];
        int64_t len;
        int hdr;
        uint32_t off = 0;
        const bool lit = (tag & 3) == 0;
        if (lit) {
          const uint32_t u = tag >> 2;
          if (u < 60) {
            len = u + 1;
            hdr = 1;
          } else {
            const int nb = static_cast<int>(u) - 59;
            if (ip + 1 + nb > slen) { state = E_DATA_MALFORMED; break; }
            if (nb == 4 && w[ip + 4] != 0) { state = E_DATA_MALFORMED; break; }   // beyond 2^24
            uint32_t v = 0;
            for (int k = 0; k < nb && k < 3; ++k) v |= static_cast<uint32_t>(w[ip + 1 + k]) << (8 * k);
            len = static_cast<int64_t>(v) + 1;
            hdr = 1 + nb;
          }
          if (ip + hdr + len > slen) { state = E_DATA_MALFORMED; break; }
        } else {
          hdr = ((tag & 3) == 1) ? 2 : ((tag & 3) == 2) ? 3 : 5;
          if (ip + hdr > slen) { state = E_DATA_MALFORMED; break; }
          if ((tag & 3) == 1) {
            len = ((tag >> 2) & 7) + 4;
            off = ((tag >> 5) << 8) | w[ip + 1];
          } else {
            len = (tag >> 2) + 1;
            off = w[ip + 1] | (static_cast<uint32_t>(w[ip + 2]) << 8);
            if (hdr == 5 && (w[ip + 3] | w[ip + 4]) != 0) { state = E_DATA_MALFORMED; break; }
          }
          if (off == 0 || off > static_cast<uint32_t>(kHist) || off > op) {
            state = E_DATA_MALFORMED;
            break;
          }
        }
        if (op + len > dlim) { state = E_OUTPUT_OVERRUN; break; }
        if (nt > 0 && op + len - o0 > kRound) break;  // the round is full
        t_os[nt] = static_cast<int32_t>(op - o0);
        t_src[nt] = lit ? static_cast<int32_t>(ip + hdr) : static_cast<int32_t>(off);
        t_len[nt] = static_cast<int32_t>(len) | (lit ? 0 : kCopyBit);
        ++nt;
        op += len;
        ip += hdr + (lit ? len : 0);
        if (op - o0 > kRound) { solo = 1; break; }    // one literal longer than a round
      }
      s_ip = ip;
      s_o0 = o0;
      s_op = op;
      s_nt = nt;
      s_solo = solo;
      s_state = state;
    }
    __syncthreads();

    const int nt = s_nt;
    const int64_t o0 = s_o0;
    if (s_solo) {
      // one literal: straight to the output, and its last kHist bytes to the ring
      const int64_t n = t_len[0];
      const uint8_t* s = in + t_src[0];
      for (int64_t j = threadIdx.x; j < n; j += kThreads) out[o0 + j] = s[j];
      for (int64_t j = n - kHist + threadIdx.x; j < n; j += kThreads)
        ring[(o0 + j) & (kRing - 1)] = s[j];
    } else {
      for (int t = warp; t < nt; t += kWarps) {       // literals, in parallel
        const int32_t l = t_len[t];
        if (l & kCopyBit) continue;
        const uint8_t* s = in + t_src[t];
        const int64_t d = o0 + t_os[t];
        for (int j = lane; j < l; j += 32) ring[(d + j) & (kRing - 1)] = s[j];
      }
      __syncthreads();
      if (warp == 0) {                                // copies, in tag order
        for (int t = 0; t < nt; ++t) {
          const int32_t l = t_len[t];
          if (!(l & kCopyBit)) continue;
          const int n = l & ~kCopyBit;
          const int64_t os = o0 + t_os[t];
          const int off = t_src[t];
          for (int j = lane; j < n; j += 32)
            ring[(os + j) & (kRing - 1)] = ring[(os - off + (j < off ? j : j % off)) & (kRing - 1)];
          __syncwarp();
        }
      }
      __syncthreads();
      const int64_t end = s_op;
      for (int64_t o = o0 + threadIdx.x; o < end; o += kThreads) out[o] = ring[o & (kRing - 1)];
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    meta[0] = (s_state == 1) ? s_op : 0;
    meta[1] = (s_state == 1) ? 0 : s_state;
  }
}

constexpr size_t kSmem = 12 * kTags + kWin + kRing;

}  // namespace

extern "C" {

// Decodes in[0:slen] into out[0:dlim] on `stream` (one thread block);
// limit = ceil(dst_len / 32768) * 32768.  meta = {produced, status}.
// Returns cudaGetLastError().
int decode_stream_launch(const void* in, long long slen, void* out, long long dlim,
                         long long limit, void* meta, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), slen, static_cast<uint8_t*>(out), dlim, limit,
      static_cast<int64_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

const char* decode_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
