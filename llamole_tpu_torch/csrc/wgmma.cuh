// Hopper warpgroup products (wgmma, sm_90a) on bf16 tiles that cp.async
// lands in shared memory, for kernel E (flash_attention.cu);
// written to be reused by the later redesigns of the other kernels.
//
// Layout. A [rows][D] bf16 tile is kept as D / 64 column blocks one after
// another, each [rows][64] with rows of 128 bytes, and the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8): the 128-byte swizzle that wgmma's
// shared-memory descriptor reads (and TMA's SWIZZLE_128B writes), so the
// tile's base must be 1024-byte aligned. One tile serves both ways a product
// reads it:
// * K-major (its rows are the product's M or N, its D the depth K): a
//   16-deep step kk starts at block kk / 4, byte (kk % 4) * 32 of the row;
//   8-row groups are 1024 bytes apart (the descriptor's stride offset).
// * MN-major (its rows are the depth K, its D the product's N): a 16-deep
//   step kk starts at row 16 kk (2048 bytes on); 64-wide column blocks are
//   rows * 128 bytes apart (the leading offset), 8-row groups 1024 (the
//   stride offset). The instruction's transpose bit for B says so.
// Accumulators follow mma.sync's C fragments: warp w of the warpgroup holds
// rows 16 w + lane / 4 (+ 8), and register 4 j + e column 8 j + 2 (lane % 4)
// + (e & 1), row + 8 for e >= 2. A register A operand is mma.sync's A
// fragment of the warp's 16 rows, so a product's P or dS goes from its
// accumulator to the next product's A by packing pairs to bf16.

#pragma once

#include "mma.cuh"

namespace {

__device__ __forceinline__ int sw128_byte(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ROWS rows of D bf16 (global row stride `stride` elements) into a swizzled
// tile, 16 bytes a thread
template <int ROWS, int D, int NT>
__device__ __forceinline__ void copy_tile_sw128(void* dst, const bf16* src, long long stride,
                                                int tid) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % NT == 0, "whole rounds of copies");
  char* base = static_cast<char*>(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    cp_async16(base + sw128_byte(ROWS, r, c), src + r * stride + c * 8);
  }
}

// a shared-memory matrix descriptor with the 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32) | (uint64_t{1} << 62);
}

// step kk of a K-major tile of `rows` rows, its 64 rows from row0
__device__ __forceinline__ uint64_t desc_k_major(const void* tile, int rows, int row0, int kk) {
  return gmma_desc(static_cast<const char*>(tile) + (kk >> 2) * rows * 128 + row0 * 128 +
                       (kk & 3) * 32,
                   16, 1024);
}

// step kk of an MN-major tile of `rows` depth rows
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, int rows, int kk) {
  return gmma_desc(static_cast<const char*>(tile) + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// what the generic proxy wrote (cp.async, st.shared) becomes visible to the
// async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads: one
// warpgroup arrives (its shared-memory writes before it are seen by the
// threads that wait) and goes on, another waits
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across an
// asynchronous product that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32 f32) (+)= A (64 x 16, K-major descriptor) . B (16 x 32, K-major
// descriptor); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_64x32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 f32) (+)= A (64 x 16, K-major descriptor) . B (16 x 64, K-major
// descriptor); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32) (+)= A (64 x 16, K-major descriptor) . B (16 x 128, K-major
// descriptor); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32) (+)= A (64 x 16 bf16, registers) . B (16 x 128, MN-major
// descriptor)
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace
