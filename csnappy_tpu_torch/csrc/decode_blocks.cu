// Batched independent-block Snappy decode for Hopper (sm_90a).
//
// Replaces csnappy_tpu/ops/decode_fused.py::_kernel in both of its modes:
// block mode (_compiled) and stream mode (_compiled_streamed).  Here the two
// are one kernel: block b reads its compressed input at src + offs[b], so
// block mode passes offs[b] = b * row_width and stream mode passes the
// segment offsets of one contiguous stream.
//
// What bounds it on this card: not bytes.  A 32 KiB block moves ~16 KiB in
// and 32 KiB out, microseconds of HBM time for a whole batch.  The bound is
// the tag chain: tag N's start depends on tag N-1's length
// (csnappy_decompress.c:345), so one thread walks it, one dependent
// shared-memory load per tag, and copies that read earlier copies resolve in
// tag order.  The TPU kernel spent most of its code working around the
// missing cheap gather (one-hot MXU gathers, permutation shifts, scalar
// walks over SMEM, pointer jumping); here the block's output lives in
// shared memory, where byte gathers are native, so none of that is carried
// over.
//
// Design: one thread block per Snappy block, in rounds.  Each round
//   1. stages a window of kWin compressed bytes in shared memory,
//   2. thread 0 walks up to kTags tags through it, recording each tag's
//      output start, source and length, and stops at the first error event
//      in tag order (offset check before space check, as
//      csnappy_decompress.c:295-317),
//   3. every warp copies literals (warp-strided over tags, lanes over bytes),
//   4. warp 0 resolves copies in tag order; byte j of a copy at t_os with
//      offset off reads t_os - off + j % off (decode_fused.py:539-547), which
//      is always before t_os, so lanes need no byte loop for runs.
// The tag table is bounded per round, so shared memory stays at
// kTags * 12 + kWin + out_stride bytes whatever the block holds.  At the end
// the block writes its row: decoded bytes, then zeros past `produced`.
// COPY_4 offsets keep their 32-bit value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 8192;    // compressed bytes staged per round
constexpr int kTags = 2048;   // tags recorded per round
constexpr int E_OUTPUT_OVERRUN = -3;
constexpr int E_DATA_MALFORMED = -5;
constexpr int32_t kCopyBit = 1 << 30;

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ offs,
              const int32_t* __restrict__ slens, const int32_t* __restrict__ dlims,
              uint8_t* __restrict__ out, int64_t out_stride,
              int32_t* __restrict__ produced, int32_t* __restrict__ status) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* t_os = reinterpret_cast<int32_t*>(smem);   // output start
  int32_t* t_src = t_os + kTags;                      // literal: input pos; copy: offset
  int32_t* t_len = t_src + kTags;                     // length | kCopyBit for copies
  uint8_t* win = reinterpret_cast<uint8_t*>(t_len + kTags);
  uint8_t* obuf = win + kWin;                         // out_stride bytes
  __shared__ int s_ip, s_op, s_nt, s_state;           // state: 0 more, 1 done, <0 error

  const int b = blockIdx.x;
  const uint8_t* in = src + offs[b];
  const int slen = slens[b];
  const int dlim = dlims[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) { s_ip = 0; s_op = 0; s_state = 0; }
  __syncthreads();

  while (s_state == 0) {
    const int ip0 = s_ip;
    const int wlim = (slen - ip0 > kWin) ? ip0 + kWin : slen;
    for (int i = threadIdx.x; i < wlim - ip0; i += kThreads) win[i] = in[ip0 + i];
    __syncthreads();

    if (threadIdx.x == 0) {
      const uint8_t* w = win - ip0;                   // w[ip] == in[ip] inside the window
      const bool last = (wlim == slen);
      int ip = ip0, op = s_op, nt = 0, state = 0;
      while (nt < kTags) {
        if (ip >= slen) { state = 1; break; }
        if (!last && ip + 5 > wlim) break;            // tag may reach past the window
        const uint32_t tag = w[ip];
        if ((tag & 3) == 0) {
          const uint32_t u = tag >> 2;
          int64_t len;
          int hdr;
          if (u < 60) {
            len = u + 1;
            hdr = 1;
          } else {
            const int nb = static_cast<int>(u) - 59;
            if (static_cast<int64_t>(ip) + 1 + nb > slen) { state = E_DATA_MALFORMED; break; }
            uint32_t v = 0;
            for (int k = 0; k < nb; ++k) v |= static_cast<uint32_t>(w[ip + 1 + k]) << (8 * k);
            len = static_cast<int64_t>(v) + 1;
            hdr = 1 + nb;
          }
          if (static_cast<int64_t>(ip) + hdr + len > slen) { state = E_DATA_MALFORMED; break; }
          if (static_cast<int64_t>(op) + len > dlim) { state = E_OUTPUT_OVERRUN; break; }
          t_os[nt] = op;
          t_src[nt] = ip + hdr;
          t_len[nt] = static_cast<int32_t>(len);
          ++nt;
          op += static_cast<int>(len);
          ip += hdr + static_cast<int>(len);
        } else {
          uint32_t len, off;
          int hdr;
          if ((tag & 3) == 1) {
            if (ip + 2 > slen) { state = E_DATA_MALFORMED; break; }
            len = ((tag >> 2) & 7) + 4;
            off = ((tag >> 5) << 8) | w[ip + 1];
            hdr = 2;
          } else if ((tag & 3) == 2) {
            if (ip + 3 > slen) { state = E_DATA_MALFORMED; break; }
            len = (tag >> 2) + 1;
            off = w[ip + 1] | (static_cast<uint32_t>(w[ip + 2]) << 8);
            hdr = 3;
          } else {
            if (static_cast<int64_t>(ip) + 5 > slen) { state = E_DATA_MALFORMED; break; }
            len = (tag >> 2) + 1;
            off = w[ip + 1] | (static_cast<uint32_t>(w[ip + 2]) << 8) |
                  (static_cast<uint32_t>(w[ip + 3]) << 16) |
                  (static_cast<uint32_t>(w[ip + 4]) << 24);
            hdr = 5;
          }
          if (off == 0 || off > static_cast<uint32_t>(op)) { state = E_DATA_MALFORMED; break; }
          if (static_cast<int64_t>(op) + len > dlim) { state = E_OUTPUT_OVERRUN; break; }
          t_os[nt] = op;
          t_src[nt] = static_cast<int32_t>(off);
          t_len[nt] = static_cast<int32_t>(len) | kCopyBit;
          ++nt;
          op += static_cast<int>(len);
          ip += hdr;
        }
      }
      s_ip = ip;
      s_op = op;
      s_nt = nt;
      s_state = state;
    }
    __syncthreads();

    const int nt = s_nt;
    for (int t = warp; t < nt; t += kWarps) {         // literals, in parallel
      const int32_t l = t_len[t];
      if (l & kCopyBit) continue;
      const uint8_t* s = in + t_src[t];
      uint8_t* d = obuf + t_os[t];
      for (int j = lane; j < l; j += 32) d[j] = s[j];
    }
    __syncthreads();

    if (warp == 0) {                                  // copies, in tag order
      for (int t = 0; t < nt; ++t) {
        const int32_t l = t_len[t];
        if (!(l & kCopyBit)) continue;
        const int n = l & ~kCopyBit;
        const int os = t_os[t];
        const int off = t_src[t];
        const uint8_t* s = obuf + (os - off);
        for (int j = lane; j < n; j += 32) obuf[os + j] = s[j < off ? j : j % off];
        __syncwarp();
      }
    }
    __syncthreads();
  }

  const int prod = (s_state == 1) ? s_op : 0;
  uint8_t* row = out + static_cast<int64_t>(b) * out_stride;
  for (int64_t i = threadIdx.x; i < out_stride; i += kThreads) row[i] = (i < prod) ? obuf[i] : 0;
  if (threadIdx.x == 0) {
    produced[b] = prod;
    status[b] = (s_state == 1) ? 0 : s_state;
  }
}

// Shared memory one block needs for rows of out_stride bytes.
long long smem_bytes(long long out_stride) {
  return 12LL * kTags + kWin + ((out_stride + 15) / 16) * 16;
}

}  // namespace

extern "C" {

// Launches nblocks blocks on `stream`; returns cudaGetLastError().
int decode_blocks_launch(const void* src, const void* offs, const void* slens,
                         const void* dlims, void* out, long long out_stride,
                         void* produced, void* status, int nblocks, void* stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(out_stride));
  cudaError_t e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nblocks > 0) {
    decode_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<const int64_t*>(offs),
        static_cast<const int32_t*>(slens), static_cast<const int32_t*>(dlims),
        static_cast<uint8_t*>(out), out_stride, static_cast<int32_t*>(produced),
        static_cast<int32_t*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* decode_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
