// Hopper warpgroup products (wgmma) for the tensor-core probes of
// csrc/probe.cu (mm_small) and csrc/probe3.cu (dot_s8, dot_bf16_256).
//
// A warpgroup is four consecutive warps (threads 128g .. 128g + 127).  One
// wgmma.mma_async m64n128 takes A, 64 rows by 32 bytes of depth (16 bf16 or
// 32 int8), from shared memory by descriptor or from registers, B, 128 rows
// by 32 bytes, from shared memory by descriptor, and adds their product
// into 64 accumulators a thread.  Thread `lane` of warp w of the group
// holds rows 16w + lane / 4 (accumulators 4n and 4n + 1) and
// 16w + lane / 4 + 8 (4n + 2, 4n + 3) at columns 8n + 2 (lane % 4) and + 1.
//
// Shared-memory operands are K-major (8-bit wgmma takes no other) and not
// swizzled: an operand of R rows is cut into core matrices of 8 rows by 16
// bytes, each 128 contiguous bytes.  Core matrix (row group g, 16-byte
// chunk c) lies at byte (c * R / 8 + g) * 128: row groups 128 bytes apart
// (the descriptor's stride byte offset), chunks R * 16 bytes apart (its
// leading byte offset).  A k-step of 32 bytes is chunks 2s and 2s + 1, so
// it starts R * 32 bytes after the last.

#pragma once

#include <cstdint>

namespace wg {

// The byte of element (row, kbyte) of a K-major operand of `rows` rows.
__host__ __device__ constexpr int core_offset(int rows, int row, int kbyte) {
  return ((kbyte >> 4) * (rows >> 3) + (row >> 3)) * 128 + (row & 7) * 16 + (kbyte & 15);
}

// The descriptor of an operand of `rows` rows whose row group 0 starts at
// shared address `addr`: start, leading and stride byte offsets in 16-byte
// units (bits 0-13, 16-29, 32-45), no swizzle (bits 62-63 = 0).
__device__ __forceinline__ uint64_t desc(uint32_t addr, int rows) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((rows * 16) >> 4) << 16 | static_cast<uint64_t>(128 >> 4) << 32;
}

// What one k-step adds to a descriptor of an operand of `rows` rows.
__host__ __device__ constexpr uint64_t step(int rows) { return (rows * 32) >> 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory written by ordinary stores, made visible to wgmma's reads
// (the async proxy); a barrier follows.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Orders this thread's register writes before the wgmma issued next.
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until every committed group has finished.
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers at this point of the program: the compiler moves no read
// of them before a wait, and no write of them past a fence.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D64                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define WG_16(c, i) WG_4(c, i), WG_4(c, i + 4), WG_4(c, i + 8), WG_4(c, i + 12)
#define WG_64(c) WG_16(c, 0), WG_16(c, 16), WG_16(c, 32), WG_16(c, 48)

// d (+)= A B, bf16 operands from shared memory, float sums; d is
// overwritten when `accumulate` is 0.
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_64("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, int8 operands from shared memory, int32 sums.
__device__ __forceinline__ void mma_s8(int32_t (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64 ", %64, %65, p;\n}\n"
      : WG_64("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, A's bf16 fragment from registers (a[0..3]: rows lane / 4 and
// + 8 of the warp's 16, columns 2 (lane % 4) and + 8, two a register, the
// lower column in the low half), B from shared memory, float sums.
__device__ __forceinline__ void mma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef WG_64
#undef WG_16
#undef WG_4
#undef WG_D64

}  // namespace wg
