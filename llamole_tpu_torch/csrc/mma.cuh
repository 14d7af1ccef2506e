// Device helpers shared by the attention kernels (fused_attention.cu, A and
// D; flash_attention.cu, E): warp reductions, cp.async copies, ldmatrix and
// mma.sync m16n8k16 on bf16, the split-TF32 products (three mma.sync
// m16n8k8 TF32 passes), and the once-per-device shared-memory opt-in.
// They sit in an anonymous namespace: each source that includes the header
// compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr size_t kDefaultShared = 48 * 1024;   // more needs an opt-in

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8x8 bf16 matrices; lane l supplies the address of one row
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower index
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- split TF32: f32-accurate products on the TF32 tensor cores

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32 (11 significant bits each, rounded to
// nearest, ties away from zero): x - hi is exact in f32, so hi + lo keeps
// 22 of x's 24 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b as three TF32 products, the two small ones first: a.lo * b.hi
// + a.hi * b.lo + a.hi * b.hi; only a.lo * b.lo (~2^-22 relative) is dropped
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// mma_tf32x3 on N tiles d[off..off + N - 1] that share one A fragment, pass
// by pass (every tile's a.lo * b.hi, then every a.hi * b.lo, then every
// a.hi * b.hi): each tile sums in mma_tf32x3's order, and N independent
// products are in flight where one tile's three passes would wait on each
// other
template <int N, int M>
__device__ __forceinline__ void mma_tf32x3_n(float (&d)[M][4], int off, const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                             const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[off + n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[off + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[off + n], ah, bh[n][0], bh[n][1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A launch that asks for more than 48 KB of dynamic shared memory needs the
// kernel's cap raised first. cudaFuncSetAttribute cost about 0.01 ms of
// host time a call, as much as the launch itself, so the cap is raised
// once per device (bit d of `raised`) to the card's opt-in limit: each
// launch still asks only for what its shape needs, and one past the limit
// is refused at launch.
cudaError_t allow_shared(const void* kernel, size_t smem, std::atomic<uint64_t>& raised) {
  if (smem <= kDefaultShared) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace
