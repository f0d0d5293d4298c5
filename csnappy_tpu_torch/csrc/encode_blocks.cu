// Batched independent-block Snappy encode for Hopper (sm_90a): the greedy
// commit walk and the emission of the tag stream.
//
// Replaces csnappy_tpu/ops/encode_fused.py::_kernel (called from
// _compiled).  The dense preparation in front of it (windows, sort, LCP,
// staircase, lazy deferral, next-candidate) stays as PyTorch tensor ops, as
// it stayed XLA ops in front of the Pallas kernel; it hands over, per
// position p of the zero-padded block,
//   in1[p] = cand | ml << 15 | has << 22      (most recent match, its length)
//   nc[p]  = first position >= p with has, or bs
// and this kernel makes the same parse and the same bytes as the TPU kernel.
//
// What bounds it on this card: the commit chain.  Commit k+1 is
// nc[p_k + ml[p_k]], a dependent load per commit, so one thread walks it.
// The bytes (32 KiB of data plus 256 KiB of in1/nc in, under 38 KiB out per
// block) are microseconds of HBM time for a whole batch.  The design keeps
// the chain to ONE dependent shared-memory load per commit: all threads
// first fill a successor table T[p] = nc[p + ml[p]] (or nc[p] where p has no
// match) in shared memory, so the walk is p = T[p].  The TPU kernel's pair
// fusion, one-hot scatters and banded max fills existed to avoid serial
// scalar work and gathers on the TPU; here emission is a block-wide
// exclusive scan of record sizes, then one warp per record writes its tag
// bytes and copies its literal payload.
//
// Records: commit k carries the literal run before it and its copy; one last
// record carries the trailing literal up to blen.  A literal's header is 1,
// 2 or 3 bytes (len-1 < 60, < 256, else two bytes); a copy is COPY_1 iff
// len <= 11 and offset < 2048, else COPY_2 (encode_fused.py:303-471).
// The row is zero past the compressed length.  fail[b] = 1 (and length 0)
// if the walk finds more commits than a block can hold or the stream would
// not fit the row, which valid preparation never gives.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int lit_size(int lit) {
  if (lit <= 0) return 0;
  const int rl = lit - 1;
  return 1 + (rl < 60 ? 0 : (rl < 256 ? 1 : 2)) + lit;
}

__device__ __forceinline__ int copy_size(int ml, int off) {
  return (ml <= 11 && off < 2048) ? 2 : 3;
}

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ blens,
              const int32_t* __restrict__ in1, const int32_t* __restrict__ nc, int bs,
              uint8_t* __restrict__ comp, int ocap, int32_t* __restrict__ clen,
              int32_t* __restrict__ fail) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int cap = bs / 4 + 1;                       // commits: each covers >= 4 bytes
  int32_t* roff = reinterpret_cast<int32_t*>(smem); // cap + 1 record offsets
  uint16_t* T = reinterpret_cast<uint16_t*>(roff + cap + 1);   // bs successors
  uint16_t* commits = T + bs;                       // cap commit positions
  __shared__ int s_k, s_fail, s_total;
  __shared__ int warp_sums[kWarps];

  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * bs;
  const uint8_t* d = data + row;
  const int32_t* I = in1 + row;
  const int32_t* N = nc + row;
  uint8_t* o = comp + static_cast<int64_t>(b) * ocap;
  const int blen = blens[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int p = threadIdx.x; p < bs; p += kThreads) {
    const int32_t v = I[p];
    if ((v >> 22) & 1) {
      const int q = p + ((v >> 15) & 0x7F);
      T[p] = static_cast<uint16_t>(q < bs ? N[q] : bs);
    } else {
      T[p] = static_cast<uint16_t>(N[p]);
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {                           // the greedy commit walk
    int p = N[0], k = 0, bad = 0;
    while (p < bs) {
      if (k == cap) { bad = 1; break; }
      commits[k++] = static_cast<uint16_t>(p);
      p = T[p];
    }
    s_k = k;
    s_fail = bad;
  }
  __syncthreads();

  const int K = s_k;
  const int nrec = K + 1;
  // record r: literal [prev_end, pos) then, for r < K, the copy at pos
  auto fields = [&](int r, int& prev_end, int& pos, int& ml, int& off) {
    prev_end = 0;
    if (r > 0) {
      const int pp = commits[r - 1];
      prev_end = pp + ((I[pp] >> 15) & 0x7F);
    }
    if (r < K) {
      pos = commits[r];
      const int32_t v = I[pos];
      ml = (v >> 15) & 0x7F;
      off = pos - (v & 0x7FFF);
    } else {
      pos = blen;
      ml = 0;
      off = 0;
    }
  };
  auto rec_size = [&](int r) {
    int prev_end, pos, ml, off;
    fields(r, prev_end, pos, ml, off);
    return lit_size(pos - prev_end) + (ml > 0 ? copy_size(ml, off) : 0);
  };

  // block-wide exclusive scan of record sizes: each thread owns a run
  const int per = (nrec + kThreads - 1) / kThreads;
  const int r0 = min(nrec, static_cast<int>(threadIdx.x) * per), r1 = min(nrec, r0 + per);
  int local = 0;
  if (!s_fail) for (int r = r0; r < r1; ++r) local += rec_size(r);
  int incl = local;
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, dd);
    if (lane >= dd) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) { const int t = warp_sums[w]; warp_sums[w] = acc; acc += t; }
    s_total = acc;
    if (acc > ocap) s_fail = 1;
  }
  __syncthreads();
  int acc = warp_sums[warp] + incl - local;
  if (!s_fail) for (int r = r0; r < r1; ++r) { roff[r] = acc; acc += rec_size(r); }
  __syncthreads();

  const int bad = s_fail;
  const int total = bad ? 0 : s_total;
  if (!bad) {
    for (int r = warp; r < nrec; r += kWarps) {     // one warp per record
      int prev_end, pos, ml, off;
      fields(r, prev_end, pos, ml, off);
      const int lit = pos - prev_end;
      int at = roff[r];
      if (lit > 0) {
        const int rl = lit - 1;
        const int ext = rl < 60 ? 0 : (rl < 256 ? 1 : 2);
        if (lane == 0) {
          o[at] = static_cast<uint8_t>(ext == 0 ? rl << 2 : (59 + ext) << 2);
          if (ext >= 1) o[at + 1] = static_cast<uint8_t>(rl & 0xFF);
          if (ext == 2) o[at + 2] = static_cast<uint8_t>(rl >> 8);
        }
        at += 1 + ext;
        for (int j = lane; j < lit; j += 32) o[at + j] = d[prev_end + j];
        at += lit;
      }
      if (ml > 0 && lane == 0) {
        if (ml <= 11 && off < 2048) {
          o[at] = static_cast<uint8_t>(1 | ((ml - 4) << 2) | ((off >> 8) << 5));
          o[at + 1] = static_cast<uint8_t>(off & 0xFF);
        } else {
          o[at] = static_cast<uint8_t>(2 | ((ml - 1) << 2));
          o[at + 1] = static_cast<uint8_t>(off & 0xFF);
          o[at + 2] = static_cast<uint8_t>(off >> 8);
        }
      }
    }
  }
  for (int i = total + threadIdx.x; i < ocap; i += kThreads) o[i] = 0;
  if (threadIdx.x == 0) {
    clen[b] = total;
    fail[b] = bad;
  }
}

// Shared memory one block needs for blocks of bs bytes.
long long smem_bytes(int bs) {
  const long long cap = bs / 4 + 1;
  return 4 * (cap + 1) + 2LL * bs + 2 * cap;
}

}  // namespace

extern "C" {

// Launches nblocks blocks on `stream`; returns cudaGetLastError().
int encode_blocks_launch(const void* data, const void* blens, const void* in1, const void* nc,
                         int bs, void* comp, int ocap, void* clen, void* fail, int nblocks,
                         void* stream) {
  const size_t smem = static_cast<size_t>(smem_bytes(bs));
  cudaError_t e = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nblocks > 0) {
    encode_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const int32_t*>(blens),
        static_cast<const int32_t*>(in1), static_cast<const int32_t*>(nc), bs,
        static_cast<uint8_t*>(comp), ocap, static_cast<int32_t*>(clen),
        static_cast<int32_t*>(fail));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* encode_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
