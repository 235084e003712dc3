// Hopper tensor-core helpers shared by the bf16 attention kernels
// (`flash_attention.cu`, `flash_attention_bwd.cu`): 128-byte-swizzled
// shared-memory tiles filled by 16-byte `cp.async` copies, their `wgmma`
// descriptors, and `wgmma` m64n64k16 (bf16 in, f32 accumulate) with both
// operands in shared memory or A in registers.
//
// A tile is 64 rows of D bf16 values, stored as D / 64 blocks of 64 rows
// x 128 bytes; 16-byte chunk c of row r lies at chunk c ^ (r % 8) of its
// row (the swizzle the descriptors name). A product that contracts over
// D reads such a tile K-major; one that contracts over its 64 rows reads
// it MN-major (the transpose flag), 16 rows (2048 bytes) a k-step.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr int kBlockBytes = 64 * 128;   // 64 rows x 64 bf16 columns

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (elements 8c .. 8c + 7) of row r in a
// 64-row tile: column block c / 8, then the 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Rows r0 .. r0 + 63 of a (S, D) bf16 matrix with row stride `ld` into a
// swizzled tile with 16-byte `cp.async` copies issued by NT threads (the
// caller commits and waits); rows at or past S are zero. Every row must
// start on 16 bytes.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int r0, int S,
                                          int tid) {
  constexpr int kChunks = 64 * D / 8;
  static_assert(kChunks % NT == 0, "the copies split evenly");
#pragma unroll
  for (int n = 0; n < kChunks / NT; ++n) {
    const int i = tid + n * NT, r = i / (D / 8), c = i % (D / 8);
    const bool in = r0 + r < S;
    const __nv_bfloat16* g = in ? src + (r0 + r) * ld + c * 8 : src;
    const uint32_t s = dst + swizzled(r, c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(g), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A 64 x 64 f32 accumulator fragment as the A operand of m64nNk16 (key
// step kk: registers 8 kk .. 8 kk + 7, packed to bf16 pairs), split into
// its bf16 rounding hi and the rounding of what that leaves, lo: hi + lo
// carries each value to about 2^-17 relative, where hi alone carries it
// to 2^-9.
__device__ __forceinline__ void split_bf16(const float (&x)[32],
                                           uint32_t (&hi)[16],
                                           uint32_t (&lo)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    const float2 back = __bfloat1622float2(h2);
    hi[j] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[j] = pack_bf16(x[2 * j] - back.x, x[2 * j + 1] - back.y);
  }
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64), A and B read from shared
// memory through descriptors, both K-major (k contiguous).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64),
// B read from shared memory in its natural (k, column) layout, which is
// MN-major for this product: hence the transpose flag.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A B over a k-extent of 64, A the 64 x 64 fragment in registers
// as hi + lo (two products), B a swizzled tile at `b` of NB column blocks
// read MN-major, column block c of B into d[c] (d may hold more blocks
// than NB, which stay as they are).
template <int NB, int N>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[N][32],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              uint32_t b) {
  static_assert(NB <= N, "column blocks of the accumulator");
#pragma unroll
  for (int c = 0; c < NB; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = descriptor(b + c * kBlockBytes + kk * 2048);
      wgmma_rs(d[c], hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
               hi[4 * kk + 3], db);
      wgmma_rs(d[c], lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
               lo[4 * kk + 3], db);
    }
  }
}

// d = A B^T over D, A and B swizzled tiles at `a` and `b` (64 rows of D
// each) read K-major: d[r][c] = sum_x A[r][x] B[c][x]. Issued, not waited.
template <int D>
__device__ __forceinline__ void wgmma_ss_tile(float (&d)[32], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint32_t off = (j >> 2) * kBlockBytes + (j & 3) * 32;
    wgmma_ss(d, descriptor(a + off), descriptor(b + off));
  }
}

}  // namespace wg
