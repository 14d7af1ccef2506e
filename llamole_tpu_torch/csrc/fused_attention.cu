// Fused qk-LayerNorm + masked multi-head attention over graph nodes.
//
// Replaces: llamole_tpu/ops/pallas/fused_attention.py `_kernel`
// (launched by `_fused_attention_pallas`, wrapper `fused_block_attention`),
// the attention of every GraphDiT denoiser block at every reverse step.
//
// What bounds it on an H100: at the main-path shape (B = 16 CFG rows,
// N = 50 nodes, H = 1024 = 16 heads x 64) one call reads 4.9 MB of qkv
// and writes 1.6 MB, against ~0.1 GFLOP. It is bound by memory traffic
// and, at this size, by launch latency -- never by arithmetic. The TPU
// kernel existed to keep the head reshape/transposes, the two LayerNorm
// round trips and the [B, heads, N, N] softmax out of device memory; this
// kernel keeps them out too: each byte of qkv is read once and each
// output byte written once.
//
// Design: one thread block per (graph, head). The block reads that
// head's q, k and v columns straight out of the [B, N, 3H] projection
// (row stride 3H, no transpose copies), LayerNorms q and k in f32 and
// rounds them to the input type (as the JAX code casts them to v's
// dtype), keeps q, k, v and the N x N f32 logits in shared memory, masks
// keys, takes the softmax per row (probabilities rounded to the input
// type, as JAX casts p before p.v), multiplies by v with f32 sums and
// writes out[b, i, h*dh:(h+1)*dh]. Plain FMA loops: wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_attention_kernel(
    const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
    const T* __restrict__ q_scale, const T* __restrict__ q_bias,
    const T* __restrict__ k_scale, const T* __restrict__ k_bias,
    T* __restrict__ out, int N, int H, int heads, float eps) {
  extern __shared__ float smem[];
  const int dh = H / heads;
  const int ld = dh + 1;  // padded rows: column walks hit distinct banks
  const int lp = N + 1;
  float* q = smem;        // [N][ld]
  float* k = q + N * ld;  // [N][ld]
  float* v = k + N * ld;  // [N][ld]
  float* p = v + N * ld;  // [N][lp] logits, then probabilities

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* src = qkv + (size_t)b * N * 3 * H + (size_t)h * dh;
  const uint8_t* m = mask + (size_t)b * N;

  for (int e = tid; e < N * dh; e += kThreads) {
    const int i = e / dh, d = e % dh;
    const T* row = src + (size_t)i * 3 * H + d;
    q[i * ld + d] = to_f32<T>(row[0]);
    k[i * ld + d] = to_f32<T>(row[H]);
    v[i * ld + d] = to_f32<T>(row[2 * H]);
  }
  __syncthreads();

  // LayerNorm over dh (two-pass mean/variance like jnp.var), one warp a row
  for (int r = warp; r < 2 * N; r += kWarps) {
    const bool is_q = r < N;
    float* x = (is_q ? q : k) + (is_q ? r : r - N) * ld;
    const T* sc = is_q ? q_scale : k_scale;
    const T* bi = is_q ? q_bias : k_bias;
    float s = 0.f;
    for (int d = lane; d < dh; d += 32) s += x[d];
    const float mean = warp_sum(s) / dh;
    float s2 = 0.f;
    for (int d = lane; d < dh; d += 32) {
      const float c = x[d] - mean;
      s2 += c * c;
    }
    const float rstd = rsqrtf(warp_sum(s2) / dh + eps);
    for (int d = lane; d < dh; d += 32)
      x[d] = round_to<T>((x[d] - mean) * rstd * to_f32<T>(sc[d]) + to_f32<T>(bi[d]));
  }
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)dh);
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N, j = e % N;
    const float* qi = q + i * ld;
    const float* kj = k + j * ld;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
    p[i * lp + j] = acc * scale + (m[j] ? 0.f : kNeg);
  }
  __syncthreads();

  for (int i = warp; i < N; i += kWarps) {
    float* row = p + i * lp;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < N; j += 32) row[j] = round_to<T>(row[j] / s);
  }
  __syncthreads();

  T* dst = out + (size_t)b * N * H + (size_t)h * dh;
  for (int e = tid; e < N * dh; e += kThreads) {
    const int i = e / dh, d = e % dh;
    const float* pi = p + i * lp;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(pi[j], v[j * ld + d], acc);
    dst[(size_t)i * H + d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* qkv, const void* mask, const void* q_scale,
           const void* q_bias, const void* k_scale, const void* k_bias,
           void* out, int B, int N, int H, int heads, void* stream) {
  const int dh = H / heads;
  const size_t smem = (size_t)(3 * N * (dh + 1) + N * (N + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_kernel<T><<<B * heads, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)qkv, (const uint8_t*)mask, (const T*)q_scale, (const T*)q_bias,
      (const T*)k_scale, (const T*)k_bias, (T*)out, N, H, heads, 1e-5f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int llamole_fused_attention_f32(const void* qkv, const void* mask,
                                const void* q_scale, const void* q_bias,
                                const void* k_scale, const void* k_bias,
                                void* out, int B, int N, int H, int heads,
                                void* stream) {
  return launch<float>(qkv, mask, q_scale, q_bias, k_scale, k_bias, out, B,
                       N, H, heads, stream);
}

int llamole_fused_attention_bf16(const void* qkv, const void* mask,
                                 const void* q_scale, const void* q_bias,
                                 const void* k_scale, const void* k_bias,
                                 void* out, int B, int N, int H, int heads,
                                 void* stream) {
  return launch<__nv_bfloat16>(qkv, mask, q_scale, q_bias, k_scale, k_bias,
                               out, B, N, H, heads, stream);
}

const char* llamole_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
