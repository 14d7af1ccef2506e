// GIN message aggregation over dense molecular graphs.
//
// Replaces: llamole_tpu/ops/pallas/gin_aggregate.py `_gin_kernel`
// (launched by `_gin_aggregate_pallas`, wrapper `gin_aggregate`), the
// aggregation of every GIN layer of the GraphCLIP encoder and of the
// retro template predictor:
//
//   out[b, i, h] = sum_j adj[b, i, j] * gelu(x[b, j, h] + table[edge[b, i, j], h])
//
// with the exact (erf) GELU, f32 accumulation and the output in x's type.
// Like the TPU kernel it never forms the [B, N, N, H] message tensor. The
// Pallas kernel reads row j of adj/edge in place of column j because
// molecular graphs are symmetric; this kernel computes the reference's
// adj[b, i, j] form, so it is right for directed graphs too and agrees
// with the TPU kernel on symmetric ones. Pallas spelled erf as a rational
// polynomial because Mosaic has no erf; here it is `erff`.
//
// What bounds it on an H100: the reads of x. Taken literally the sum reads
// N^2 * H values of x per graph (each destination i walks every source
// row j), against ~N^2 * H * 20 flops of GELU, so it is load-bound, and
// at the path shapes (N <= 56, H = 300, f32) one graph's x is 67 KB and
// those reads hit L1/L2, not device memory. The design cuts the reads
// themselves: pairs with adj == 0 contribute nothing and are skipped, and
// a molecule has ~2-3 bonds per atom, so a destination reads ~3 rows of x
// instead of N. The adj == 0 test is uniform across the block (every
// thread walks the same j), so the skip costs no divergence.
//
// Design: one block per (graph b, destination node i); its threads stride
// over H, so neighbouring threads read neighbouring addresses of row j
// (coalesced). The block stages its adj and edge rows in shared memory,
// each thread keeps the five table entries of its columns in registers,
// and the loop over j adds adj * gelu(x[b, j, h] + table[e, h]) in f32.
// No shared-memory tiling of x and no tensor cores: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) gin_aggregate_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ edge,
    const T* __restrict__ adj, const T* __restrict__ table,
    T* __restrict__ out, int N, int H) {
  extern __shared__ float smem[];
  float* a_row = smem;                                 // [N]
  int32_t* e_row = reinterpret_cast<int32_t*>(smem + N);  // [N]

  const int bi = blockIdx.x;  // b * N + i
  const int b = bi / N;
  const size_t pair = (size_t)bi * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    a_row[j] = to_f32<T>(adj[pair + j]);
    e_row[j] = edge[pair + j];
  }
  __syncthreads();

  const T* xb = x + (size_t)b * N * H;
  T* dst = out + (size_t)bi * H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float tab[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) tab[k] = to_f32<T>(table[k * H + h]);
    float acc = 0.f;
    for (int j = 0; j < N; ++j) {
      const float a = a_row[j];
      if (a == 0.f) continue;  // no edge: the term is zero
      const int e = e_row[j];
      float t = tab[0];
      t = e == 1 ? tab[1] : t;
      t = e == 2 ? tab[2] : t;
      t = e == 3 ? tab[3] : t;
      t = e == 4 ? tab[4] : t;
      acc = fmaf(a, gelu_exact(to_f32<T>(xb[(size_t)j * H + h]) + t), acc);
    }
    dst[h] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* edge, const void* adj, const void* table,
           void* out, int B, int N, int H, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaSuccess;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)N * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gin_aggregate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gin_aggregate_kernel<T><<<B * N, threads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int32_t*)edge, (const T*)adj, (const T*)table,
      (T*)out, N, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int llamole_gin_aggregate_f32(const void* x, const void* edge, const void* adj,
                              const void* table, void* out, int B, int N, int H,
                              void* stream) {
  return launch<float>(x, edge, adj, table, out, B, N, H, stream);
}

int llamole_gin_aggregate_bf16(const void* x, const void* edge, const void* adj,
                               const void* table, void* out, int B, int N, int H,
                               void* stream) {
  return launch<__nv_bfloat16>(x, edge, adj, table, out, B, N, H, stream);
}

}  // extern "C"
