// Memory hygiene and a perturbed schedule for the port's kernels, for the
// hygiene harness only (csnappy_tpu_torch/tools/hygiene.py).  Replaces no
// TPU kernel and is never loaded on the main path.
//
// 1. A poisoning, guarded allocator for torch.cuda.memory.CUDAPluggableAllocator
//    (hygiene_malloc, hygiene_free).  Each tensor gets its own block of an
//    arena (first fit over 8 GiB chunks, each one cudaMalloc, made once:
//    cudaMalloc on the call path would wait for the occupier below): kFront
//    guard bytes, the tensor, at least kBack guard bytes.  On the
//    allocation's stream the tensor is filled with the current poison byte
//    and the guards with the guard byte, so a byte that a kernel should
//    write but does not reads as poison, and a write outside the tensor
//    changes a guard.  A freed block stays quarantined (its memory is not
//    reused) until hygiene_check, which synchronises the card, counts the
//    guard bytes of every block that changed, then returns the quarantined
//    blocks to the arena.
// 2. hygiene_fill: cudaMemsetAsync of a range (poisons free blocks of
//    PyTorch's caching allocator, for checks that keep it).
// 3. The occupier (hygiene_occupy): on a second, higher-priority stream,
//    `nsm` blocks of 1,024 threads with all of a block's shared memory (one
//    an SM), each holding its SM for a time drawn from [lo_ns, hi_ns) by a
//    hash of the seed and its block; then a gate kernel on the caller's
//    stream that ends once they have all started (or after a timeout).  The
//    kernels queued behind the gate start on the SMs left and spread as the
//    occupier's blocks end, in staggered order.  hygiene_occupy_late queues
//    a second wave on a third stream behind a one-thread delay kernel: when
//    the delay ends, in the middle of the call, its blocks take SMs as the
//    call's blocks free them, ahead of the call's pending blocks (their
//    stream's priority), so later tickets start late and out of turn.
//    The occupier's blocks stamp their start and release (%globaltimer);
//    hygiene_released reads the first start and the first and last release
//    since the last hygiene_occupy, to set beside the call's own stamps.
//
// What bounds it: nothing of interest; the allocator's cudaMalloc, memsets
// and the check's copies cost microseconds a tensor, which the harness pays.

#include <cuda_runtime.h>
#include <sys/types.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <iterator>
#include <map>
#include <mutex>
#include <set>
#include <vector>

namespace {

constexpr size_t kFront = 512;    // guard bytes before a tensor (keeps 512-byte alignment)
constexpr size_t kBack = 4096;    // guard bytes after it, at least
constexpr size_t kArena = size_t(8) << 30;   // an arena chunk: one cudaMalloc

struct Block {
  char* base;                     // the arena block: front guard, tensor, back guard
  size_t size;                    // the tensor's bytes
  size_t span;                    // the block's bytes
  int device;
  unsigned char guard;            // the guard byte it was filled with
};

std::map<char*, size_t> g_free;   // the arena's free ranges by address
std::set<char*> g_chunk_starts;   // no free range is merged across a chunk's start

size_t span_of(size_t n) { return kFront + ((n + kBack + 511) & ~size_t(511)); }

// A free block of n bytes (a multiple of 512), first fit; a new chunk if none.
char* arena_take(size_t n) {
  for (auto it = g_free.begin(); it != g_free.end(); ++it) {
    if (it->second < n) continue;
    char* p = it->first;
    const size_t left = it->second - n;
    g_free.erase(it);
    if (left) g_free.emplace(p + n, left);
    return p;
  }
  const size_t c = n > kArena ? n : kArena;
  char* base = nullptr;
  if (cudaMalloc(&base, c) != cudaSuccess) return nullptr;
  g_chunk_starts.insert(base);
  if (c > n) g_free.emplace(base + n, c - n);
  return base;
}

void arena_give(char* p, size_t n) {
  auto it = g_free.emplace(p, n).first;
  auto nx = std::next(it);
  if (nx != g_free.end() && it->first + it->second == nx->first && !g_chunk_starts.count(nx->first)) {
    it->second += nx->second;
    g_free.erase(nx);
  }
  if (it != g_free.begin() && !g_chunk_starts.count(it->first)) {
    auto pv = std::prev(it);
    if (pv->first + pv->second == it->first) {
      pv->second += it->second;
      g_free.erase(it);
    }
  }
}

std::mutex g_mu;
std::vector<Block> g_live, g_quarantine;
unsigned char g_poison = 0xA5, g_guard = 0x3C;
long long g_allocs = 0, g_alloc_bytes = 0, g_failed = 0;
std::vector<long long> g_violations;   // the sizes of the blocks whose guards changed (last check)

int find(std::vector<Block>& v, const void* ptr) {
  for (size_t i = 0; i < v.size(); ++i)
    if (v[i].base + kFront == ptr) return static_cast<int>(i);
  return -1;
}

// guard bytes of b that differ from its guard byte (the card synchronised)
long long bad_guards(const Block& b, std::vector<unsigned char>& host) {
  const size_t back = b.span - kFront - b.size;
  host.resize(kFront + back);
  if (cudaMemcpy(host.data(), b.base, kFront, cudaMemcpyDeviceToHost) != cudaSuccess ||
      cudaMemcpy(host.data() + kFront, b.base + kFront + b.size, back, cudaMemcpyDeviceToHost) !=
          cudaSuccess)
    return -1;
  long long n = 0;
  for (unsigned char c : host) n += c != b.guard;
  return n;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ unsigned int g_arrived;          // occupier blocks started, over the process
// since the last hygiene_occupy: its blocks' first start, first and last release (ns)
__device__ unsigned long long g_occupied[3];

constexpr int kOccupyThreads = 1024;
constexpr int kOccupySmem = 232448;         // a block's whole shared memory on the H100

__global__ void __launch_bounds__(kOccupyThreads) occupy_kernel(unsigned int seed, long long lo_ns,
                                                                long long hi_ns) {
  extern __shared__ unsigned char smem[];
  if (threadIdx.x == 0) {
    atomicAdd(&g_arrived, 1u);
    unsigned int h = seed * 0x9E3779B1u ^ (blockIdx.x + 1) * 0x85EBCA77u;
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    const long long hold = lo_ns + static_cast<long long>(h % static_cast<unsigned int>(hi_ns - lo_ns));
    const long long t0 = global_ns();
    atomicMin(&g_occupied[0], static_cast<unsigned long long>(t0));
    long long t = t0;
    while (t - t0 < hold) t = global_ns();
    atomicMin(&g_occupied[1], static_cast<unsigned long long>(t));
    atomicMax(&g_occupied[2], static_cast<unsigned long long>(t));
    smem[0] = static_cast<unsigned char>(h);   // the shared memory is the block's, used
  }
  __syncthreads();
}

__global__ void delay_kernel(long long ns) {
  const long long t0 = global_ns();
  while (global_ns() - t0 < ns) {
  }
}

__global__ void gate_kernel(unsigned int target, long long timeout_ns) {
  const long long t0 = global_ns();
  while (*static_cast<volatile unsigned int*>(&g_arrived) - target > 0x80000000u &&
         global_ns() - t0 < timeout_ns) {
  }
}

unsigned int g_launched = 0;                // occupier blocks launched, over the process

cudaError_t raise_occupier_smem() {
  static bool raised = false;
  if (raised) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(occupy_kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kOccupySmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(occupy_kernel),
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  raised = e == cudaSuccess;
  return e;
}

bool bad_hold(int nsm, long long lo_ns, long long hi_ns) {
  return nsm < 1 || lo_ns < 0 || hi_ns <= lo_ns || hi_ns - lo_ns >= (1LL << 32);
}

}  // namespace

extern "C" {

// CUDAPluggableAllocator's allocation: a tensor of `size` bytes with its
// guards, poisoned on `stream`.
void* hygiene_malloc(ssize_t size, int device, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(g_mu);
  cudaSetDevice(device);
  const size_t n = size < 0 ? 0 : static_cast<size_t>(size);
  const size_t span = span_of(n);
  char* base = arena_take(span);
  if (base == nullptr) {
    ++g_failed;
    return nullptr;
  }
  cudaMemsetAsync(base, g_guard, kFront, stream);
  if (n) cudaMemsetAsync(base + kFront, g_poison, n, stream);
  cudaMemsetAsync(base + kFront + n, g_guard, span - kFront - n, stream);
  g_live.push_back(Block{base, n, span, device, g_guard});
  ++g_allocs;
  g_alloc_bytes += static_cast<long long>(n);
  return base + kFront;
}

// CUDAPluggableAllocator's release: the block goes to quarantine.
void hygiene_free(void* ptr, ssize_t, int, cudaStream_t) {
  std::lock_guard<std::mutex> lock(g_mu);
  const int i = find(g_live, ptr);
  if (i < 0) return;
  g_quarantine.push_back(g_live[i]);
  g_live.erase(g_live.begin() + i);
}

// The poison byte of later allocations and their guard byte.
void hygiene_set(int poison, int guard) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_poison = static_cast<unsigned char>(poison);
  g_guard = static_cast<unsigned char>(guard);
}

// Synchronises the card, counts the changed guard bytes of every live and
// quarantined block (-1 if a copy failed: the card is in error), records
// the sizes of the blocks with any, and returns the quarantined blocks to
// the arena.
long long hygiene_check() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (cudaDeviceSynchronize() != cudaSuccess) return -1;
  std::vector<unsigned char> host;
  long long total = 0;
  g_violations.clear();
  for (auto* v : {&g_live, &g_quarantine}) {
    for (const Block& b : *v) {
      const long long n = bad_guards(b, host);
      if (n < 0) return -1;
      if (n) {
        total += n;
        g_violations.push_back(static_cast<long long>(b.size));
      }
    }
  }
  for (const Block& b : g_quarantine) arena_give(b.base, b.span);
  g_quarantine.clear();
  return total;
}

// The sizes of the blocks the last check found with changed guards: up to
// `max` into out; returns how many there were.
int hygiene_violations(long long* out, int max) {
  std::lock_guard<std::mutex> lock(g_mu);
  const int n = static_cast<int>(g_violations.size());
  for (int i = 0; i < n && i < max; ++i) out[i] = g_violations[i];
  return n;
}

// stats[0..4]: allocations, bytes allocated, failed allocations, live
// blocks, quarantined blocks.
void hygiene_stats(long long* stats) {
  std::lock_guard<std::mutex> lock(g_mu);
  stats[0] = g_allocs;
  stats[1] = g_alloc_bytes;
  stats[2] = g_failed;
  stats[3] = static_cast<long long>(g_live.size());
  stats[4] = static_cast<long long>(g_quarantine.size());
}

// Fills n bytes at ptr with `byte` on `stream`.
int hygiene_fill(void* ptr, long long n, int byte, void* stream) {
  return static_cast<int>(cudaMemsetAsync(ptr, byte, static_cast<size_t>(n),
                                          static_cast<cudaStream_t>(stream)));
}

// Launches the occupier on `occ_stream` (nsm blocks, each holding an SM for
// [lo_ns, hi_ns) ns) and the gate on `stream`, which ends when they have
// all started or after timeout_ns.  Returns the first CUDA error, or 0.
int hygiene_occupy(int nsm, unsigned int seed, long long lo_ns, long long hi_ns,
                   long long timeout_ns, void* occ_stream, void* stream) {
  if (bad_hold(nsm, lo_ns, hi_ns)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = raise_occupier_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  static const unsigned long long kClear[3] = {~0ULL, ~0ULL, 0ULL};   // static: outlives the copy
  e = cudaMemcpyToSymbolAsync(g_occupied, kClear, sizeof(kClear), 0, cudaMemcpyHostToDevice,
                              static_cast<cudaStream_t>(occ_stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  g_launched += static_cast<unsigned int>(nsm);
  occupy_kernel<<<nsm, kOccupyThreads, kOccupySmem, static_cast<cudaStream_t>(occ_stream)>>>(
      seed, lo_ns, hi_ns);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(g_launched, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

// Queues a later wave on `occ_stream`: a one-thread kernel that waits
// delay_ns, then nsm occupier blocks (each holding an SM for [lo_ns, hi_ns)
// ns), which the gate does not wait for.  Returns the first CUDA error, or 0.
int hygiene_occupy_late(int nsm, long long delay_ns, unsigned int seed, long long lo_ns,
                        long long hi_ns, void* occ_stream) {
  if (bad_hold(nsm, lo_ns, hi_ns) || delay_ns < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = raise_occupier_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(occ_stream);
  delay_kernel<<<1, 1, 0, st>>>(delay_ns);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  g_launched += static_cast<unsigned int>(nsm);
  occupy_kernel<<<nsm, kOccupyThreads, kOccupySmem, st>>>(seed, lo_ns, hi_ns);
  return static_cast<int>(cudaGetLastError());
}

// out[0..2]: the first start and the first and last release (%globaltimer
// ns) of the occupier's blocks since the last hygiene_occupy, the late wave
// included; waits for the card.  Returns a CUDA error, or 0.
int hygiene_released(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_occupied, 3 * sizeof(long long)));
}

const char* hygiene_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
