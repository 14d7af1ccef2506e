// Masked multi-head attention over graph nodes: kernels A and D.
//
// Kernel A replaces llamole_tpu/ops/pallas/fused_attention.py `_kernel`
// (launched by `_fused_attention_pallas`, wrapper `fused_block_attention`):
// fused qk-LayerNorm + masked MHA, the attention of every GraphDiT
// denoiser block at every reverse step.
//
// Kernel D replaces llamole_tpu/ops/pallas/graph_attention.py
// `_attn_kernel` (launched by `_graph_attention_pallas`, wrapper
// `graph_attention`): masked MHA over pre-split [B, heads, N, dh] heads,
// no LayerNorm. It is the same kernel bodies with the compile-time flag
// kQkNorm = false and another layout, not a second copy.
//
// What bounds them on an H100: at the denoiser's shape (B = 16 CFG rows,
// N = 50 nodes, H = 1024 = 16 heads x 64) one call reads 4.9 MB of q, k
// and v and writes 1.6 MB, against ~0.16 GFLOP: 1.96 us of memory
// traffic at 3.35 TB/s, 0.17 us of bf16 tensor-core work. Both kernels
// are bound by memory and by latency, never by arithmetic. The TPU
// kernels existed to keep the head reshape/transposes, the two LayerNorm
// round trips (A) and the [B, heads, N, N] softmax out of device memory;
// these keep them out too: each input byte is read once and each output
// byte written once.
//
// Three bodies, one block per (graph, head) in each:
//
// * attention_mma_kernel, bf16 with N <= 64 and dh in {16, 32, 64, 128}
//   (the denoiser's path). cp.async copies the head's q, k, v rows (16
//   bytes a thread; A reads them at row stride 3H straight out of the
//   [B, N, 3H] projection, D its contiguous [N, dh] rows) into bf16 tiles
//   whose rows are padded by 16 bytes, so ldmatrix reads them without
//   bank conflicts; q and k land first and A LayerNorms them (f32,
//   two-pass mean/variance, one 16-byte chunk a lane, rounded to bf16 in
//   place, as JAX casts them to v's dtype) while v is still in flight.
//   All eight warps copy and normalise; four of them then take 16 query
//   rows each: ldmatrix + mma.sync m16n8k16 (bf16 in, f32 sums) give the
//   logits in registers, scaled by 1/sqrt(dh), masked keys at -1e30 and
//   padded key columns (j >= N) at -inf so they add exactly 0; the row
//   softmax runs on the registers with quad shuffles (one reciprocal a
//   row), the probabilities are rounded to bf16 straight into the A
//   fragments of the second product (P never touches shared memory), and
//   P.V (keys padded to 16 with zero rows of v) sums in f32 registers
//   that are rounded to bf16 and stored; padded query rows are never
//   stored. ~28 KB of shared memory a block at dh = 64, so all 256 blocks
//   of the main shape are resident at once on 132 SMs: one block per
//   head keeps that parallelism, packing heads would only halve it.
//
// * attention_tf32x3_kernel, f32 within the same limits: the f32 GraphDiT
//   that every model loaded from a checkpoint builds (as JAX's
//   from_pretrained, dtype float32), and D's f32 calls. The same block
//   shape as the bf16 body: cp.async into f32 tiles of [N rounded up to
//   16, dh + 4] (the 4-float pad puts each fragment read on 32 distinct
//   banks), A's LayerNorm in f32 with no rounding while v lands, four
//   warps of 16 query rows, the softmax in registers. Tensor cores take
//   f32 only as TF32 (11 significant bits, ~3 decimal digits), and one
//   TF32 pass errs by ~1e-3 on these outputs, where the contract is 1e-4
//   (A) and 2e-5 (D at JAX's shapes). So every operand is split as hi =
//   cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and each product is three
//   mma.sync m16n8k8 TF32 products into f32 registers (lo.hi + hi.lo +
//   hi.hi): only lo.lo, ~2^-22 relative, is dropped, which is f32's own
//   order of error. P goes from the logits' accumulators to the A
//   fragments of P.V without shuffles by summing each 8-key step in a
//   permuted key order that v's rows are read in too; v is split as it
//   is read from shared memory. ~52 KB of shared memory at dh = 64 (the
//   opt-in above 48 KB; ~100 KB at dh = 128). Bound: at the main shape
//   the 13.1 MB of f32 q, k, v, out (3.9 us at 3.35 TB/s) bind, against
//   0.16 GFLOP of products (2.4 us at the f32 rate); the three passes
//   triple the tensor work but leave it under the bytes at TF32's rate.
//
// * attention_fma_kernel, f32 and bf16 shapes outside the limits above:
//   q, k, v and the N x N f32 logits in shared memory and plain FMA
//   loops, with the same rounding points. It was the f32 route at every
//   shape before the split-TF32 body.
//
// The wrappers (ops/fused_attention.py, ops/graph_attention.py) route a
// call by attention_body(N, dh, dtype) and count each body's launches.

#include <math.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;   // FMA body
constexpr int kWarps = kThreads / 32;
// tensor-core body: all eight warps copy and normalise, the first four
// take 16 query rows each
constexpr int kMmaThreads = 256;
constexpr int kMmaMaxNodes = 64;
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

// Block (b, h) reads row r of q at qs + b * in_graph + h * in_head +
// r * in_row (k and v at the same offsets from their own bases) and writes
// row r at out + b * out_graph + h * out_head + r * out_row.
struct Layout {
  long long in_graph, in_head, in_row, out_graph, out_head, out_row;
};

template <typename T, bool kQkNorm>
__global__ void __launch_bounds__(kThreads) attention_fma_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks,
    const T* __restrict__ vs, const uint8_t* __restrict__ mask,
    const T* __restrict__ q_scale, const T* __restrict__ q_bias,
    const T* __restrict__ k_scale, const T* __restrict__ k_bias,
    T* __restrict__ out, Layout lay, int N, int dh, int heads, float eps) {
  extern __shared__ float smem_f32[];
  float* smem = smem_f32;
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
  const long long in_off = b * lay.in_graph + h * lay.in_head;
  const uint8_t* m = mask + (size_t)b * N;

  for (int e = tid; e < N * dh; e += kThreads) {
    const int i = e / dh, d = e % dh;
    const long long at = in_off + i * lay.in_row + d;
    q[i * ld + d] = to_f32<T>(qs[at]);
    k[i * ld + d] = to_f32<T>(ks[at]);
    v[i * ld + d] = to_f32<T>(vs[at]);
  }
  __syncthreads();

  if constexpr (kQkNorm) {
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
  }

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

  T* dst = out + b * lay.out_graph + h * lay.out_head;
  for (int e = tid; e < N * dh; e += kThreads) {
    const int i = e / dh, d = e % dh;
    const float* pi = p + i * lp;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(pi[j], v[j * ld + d], acc);
    dst[i * lay.out_row + d] = from_f32<T>(acc);
  }
}

// ---- the bf16 tensor-core body -----------------------------------------

// sum over aligned groups of kLanes lanes
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: q, k, v as [np][DH + 8] bf16 tiles (np = N rounded up to
// 16; the 8-element pad staggers rows by 4 banks, so the 8 row addresses
// of each ldmatrix hit 32 distinct banks), then the [np] f32 additive key
// mask. Keep in step with ops/fused_attention.py shared_bytes.
template <int DH>
__host__ __device__ constexpr size_t mma_shared_bytes(int np) {
  return (size_t)3 * np * (DH + 8) * sizeof(bf16) + (size_t)np * sizeof(float);
}

template <int DH, bool kQkNorm>
__global__ void __launch_bounds__(kMmaThreads) attention_mma_kernel(
    const bf16* __restrict__ qs, const bf16* __restrict__ ks,
    const bf16* __restrict__ vs, const uint8_t* __restrict__ mask,
    const bf16* __restrict__ q_scale, const bf16* __restrict__ q_bias,
    const bf16* __restrict__ k_scale, const bf16* __restrict__ k_bias,
    bf16* __restrict__ out, Layout lay, int N, int heads, float eps) {
  static_assert(DH % 16 == 0 && DH <= 128, "head width");
  constexpr int LD = DH + 8;      // tile row stride, elements
  constexpr int CH = DH / 8;      // 16-byte chunks a row
  constexpr int KT = kMmaMaxNodes / 16;  // 16-key tiles at most
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int np = (N + 15) & ~15;
  bf16* q = reinterpret_cast<bf16*>(smem_bf16);
  bf16* k = q + np * LD;
  bf16* v = k + np * LD;
  float* key_add = reinterpret_cast<float*>(v + np * LD);

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long in_off = b * lay.in_graph + h * lay.in_head;

  // copy group 0: q and k rows; group 1: v rows (lands during the norm)
  for (int e = tid; e < 2 * N * CH; e += kMmaThreads) {
    const int is_k = e >= N * CH;
    const int rc = e - is_k * N * CH;
    const int r = rc / CH, c = rc % CH;
    cp_async16((is_k ? k : q) + r * LD + c * 8,
               (is_k ? ks : qs) + in_off + r * lay.in_row + c * 8);
  }
  cp_async_commit();
  for (int e = tid; e < N * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(v + r * LD + c * 8, vs + in_off + r * lay.in_row + c * 8);
  }
  cp_async_commit();
  // zero the padded rows (N <= r < np) of all three tiles: padded keys
  // then add 0 * 0, where uninitialised memory could hold NaN
  const int pad = np - N;
  for (int e = tid; e < 3 * pad * CH; e += kMmaThreads) {
    const int t = e / (pad * CH);
    const int rc = e - t * pad * CH;
    *reinterpret_cast<uint4*>(q + t * np * LD + (N + rc / CH) * LD + (rc % CH) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // masked real keys at -1e30 (as JAX), padded key columns at -inf: they
  // weigh exactly 0 even when every real key is masked
  for (int j = tid; j < np; j += kMmaThreads)
    key_add[j] = j < N ? (mask[(size_t)b * N + j] ? 0.f : kNeg) : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  if constexpr (kQkNorm) {
    // LayerNorm over dh of every q and k row: DH / 8 lanes a row, each
    // lane one 16-byte chunk of it; f32, two-pass mean/variance like
    // jnp.var, rounded to bf16 in place
    constexpr int L = DH / 8;
    constexpr int kGroups = kMmaThreads / L;
    const int part = lane % L;
    const int group = tid / L;
    float sq[8], bq[8], sk[8], bk[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sq[i] = __bfloat162float(q_scale[part * 8 + i]);
      bq[i] = __bfloat162float(q_bias[part * 8 + i]);
      sk[i] = __bfloat162float(k_scale[part * 8 + i]);
      bk[i] = __bfloat162float(k_bias[part * 8 + i]);
    }
    for (int r0 = 0; r0 < 2 * N; r0 += kGroups) {  // uniform trip count
      const int r = r0 + group;
      const bool live = r < 2 * N;
      const bool is_q = r < N;
      uint4* chunk = reinterpret_cast<uint4*>(
          (is_q ? q + r * LD : k + (r - N) * LD) + part * 8);
      uint4 raw = live ? *chunk : make_uint4(0u, 0u, 0u, 0u);
      __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
      float x[8];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pair[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
        s += f.x + f.y;
      }
      const float mean = group_sum<L>(s) / DH;
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = x[i] - mean;
        s2 += c * c;
      }
      const float rstd = rsqrtf(group_sum<L>(s2) / DH + eps);
      if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lo = 2 * i, hi = 2 * i + 1;
          pair[i] = __floats2bfloat162_rn(
              (x[lo] - mean) * rstd * (is_q ? sq[lo] : sk[lo]) + (is_q ? bq[lo] : bk[lo]),
              (x[hi] - mean) * rstd * (is_q ? sq[hi] : sk[hi]) + (is_q ? bq[hi] : bk[hi]));
        }
        *chunk = raw;
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2;   // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column pair
  const int m0 = warp * 16;  // this warp's query rows
  const int nkt = np / 16;   // 16-key tiles
  const bool active = m0 < N;  // warp-uniform; warps 4-7 never are
  uint32_t pa[KT][4];          // bf16 probabilities as A fragments

  if (active) {
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c)
      ldmatrix_x4(qa[c], q + (m0 + (lane & 15)) * LD + c * 16 + (lane >> 4) * 8);
    float s[2 * KT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) {
        uint32_t kb[DH / 16][4];  // keys kt*16 + [0, 8) and [8, 16), dims c*16 + [0, 16)
#pragma unroll
        for (int c = 0; c < DH / 16; ++c)  // every load before the products
          ldmatrix_x4(kb[c], k + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                 c * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) {
          mma_bf16(s[2 * kt], qa[c], kb[c][0], kb[c][1]);
          mma_bf16(s[2 * kt + 1], qa[c], kb[c][2], kb[c][3]);
        }
      }
    }
    const float scale = 1.0f / sqrtf((float)DH);
    float mx0 = -INFINITY, mx1 = -INFINITY;  // rows g and g + 8
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (nt < 2 * nkt) {
        const float a0 = key_add[nt * 8 + 2 * t4], a1 = key_add[nt * 8 + 2 * t4 + 1];
        s[nt][0] = s[nt][0] * scale + a0;
        s[nt][1] = s[nt][1] * scale + a1;
        s[nt][2] = s[nt][2] * scale + a0;
        s[nt][3] = s[nt][3] * scale + a1;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (nt < 2 * nkt) {
        s[nt][0] = expf(s[nt][0] - mx0);
        s[nt][1] = expf(s[nt][1] - mx0);
        s[nt][2] = expf(s[nt][2] - mx1);
        s[nt][3] = expf(s[nt][3] - mx1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
    }
    // one division a row, then products: a division per probability was
    // the costliest part of the body (p = e * (1 / sum) is within an f32
    // ulp of e / sum before its rounding to bf16)
    const float inv0 = 1.f / quad_sum(sum0);
    const float inv1 = 1.f / quad_sum(sum1);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nkt) {
        pa[kt][0] = pack_bf16(s[2 * kt][0] * inv0, s[2 * kt][1] * inv0);
        pa[kt][1] = pack_bf16(s[2 * kt][2] * inv1, s[2 * kt][3] * inv1);
        pa[kt][2] = pack_bf16(s[2 * kt + 1][0] * inv0, s[2 * kt + 1][1] * inv0);
        pa[kt][3] = pack_bf16(s[2 * kt + 1][2] * inv1, s[2 * kt + 1][3] * inv1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's v rows have landed
  if (!active) return;

  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
      uint32_t vb[DH / 16][4];  // keys kt*16 + [0, 16), dims c*16 + [0, 8) and [8, 16)
#pragma unroll
      for (int c = 0; c < DH / 16; ++c)
        ldmatrix_x4_trans(vb[c], v + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     c * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        mma_bf16(o[2 * c], pa[kt], vb[c][0], vb[c][1]);
        mma_bf16(o[2 * c + 1], pa[kt], vb[c][2], vb[c][3]);
      }
    }
  }
  bf16* dst = out + b * lay.out_graph + h * lay.out_head;
  const int r0 = m0 + g, r1 = m0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int d = nt * 8 + 2 * t4;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * lay.out_row + d) =
          __floats2bfloat162_rn(o[nt][0], o[nt][1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * lay.out_row + d) =
          __floats2bfloat162_rn(o[nt][2], o[nt][3]);
  }
}

// ---- the f32 split-TF32 tensor-core body -----------------------------

// tf32_rna, split_tf32, mma_tf32 and mma_tf32x3 are in mma.cuh.

// Shared memory: q, k, v as [np][DH + 4] f32 tiles (np = N rounded up to
// 16; the 4-float pad puts the 8 rows x 4 columns of every fragment read
// on 32 distinct banks), then the [np] f32 additive key mask. Keep in step
// with ops/fused_attention.py shared_bytes.
template <int DH>
__host__ __device__ constexpr size_t tf32_shared_bytes(int np) {
  return (size_t)3 * np * (DH + 4) * sizeof(float) + (size_t)np * sizeof(float);
}

template <int DH, bool kQkNorm>
__global__ void __launch_bounds__(kMmaThreads) attention_tf32x3_kernel(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, const uint8_t* __restrict__ mask,
    const float* __restrict__ q_scale, const float* __restrict__ q_bias,
    const float* __restrict__ k_scale, const float* __restrict__ k_bias,
    float* __restrict__ out, Layout lay, int N, int heads, float eps) {
  static_assert(DH % 16 == 0 && DH <= 128, "head width");
  constexpr int LD = DH + 4;            // tile row stride, floats
  constexpr int CH = DH / 4;            // 16-byte chunks a row
  constexpr int NT = kMmaMaxNodes / 8;  // 8-key tiles at most
  extern __shared__ __align__(16) unsigned char smem_tf32[];
  const int np = (N + 15) & ~15;
  float* q = reinterpret_cast<float*>(smem_tf32);
  float* k = q + np * LD;
  float* v = k + np * LD;
  float* key_add = v + np * LD;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long in_off = b * lay.in_graph + h * lay.in_head;

  // copy group 0: q and k rows; group 1: v rows (lands during the norm)
  for (int e = tid; e < 2 * N * CH; e += kMmaThreads) {
    const int is_k = e >= N * CH;
    const int rc = e - is_k * N * CH;
    const int r = rc / CH, c = rc % CH;
    cp_async16((is_k ? k : q) + r * LD + c * 4,
               (is_k ? ks : qs) + in_off + r * lay.in_row + c * 4);
  }
  cp_async_commit();
  for (int e = tid; e < N * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    cp_async16(v + r * LD + c * 4, vs + in_off + r * lay.in_row + c * 4);
  }
  cp_async_commit();
  // padded rows (N <= r < np) of all three tiles at 0, padded key columns
  // at -inf, masked real keys at -1e30: as in the bf16 body
  const int pad = np - N;
  for (int e = tid; e < 3 * pad * CH; e += kMmaThreads) {
    const int t = e / (pad * CH);
    const int rc = e - t * pad * CH;
    *reinterpret_cast<float4*>(q + t * np * LD + (N + rc / CH) * LD + (rc % CH) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = tid; j < np; j += kMmaThreads)
    key_add[j] = j < N ? (mask[(size_t)b * N + j] ? 0.f : kNeg) : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  if constexpr (kQkNorm) {
    // LayerNorm over dh of every q and k row in f32 (two-pass
    // mean/variance like jnp.var), DH / 4 lanes a row, each lane one
    // 16-byte chunk of it, in place with no rounding
    constexpr int L = DH / 4;
    constexpr int kGroups = kMmaThreads / L;
    const int part = lane % L;
    const int group = tid / L;
    const int d0 = part * 4;
    const float4 sq = make_float4(q_scale[d0], q_scale[d0 + 1], q_scale[d0 + 2], q_scale[d0 + 3]);
    const float4 bq = make_float4(q_bias[d0], q_bias[d0 + 1], q_bias[d0 + 2], q_bias[d0 + 3]);
    const float4 sk = make_float4(k_scale[d0], k_scale[d0 + 1], k_scale[d0 + 2], k_scale[d0 + 3]);
    const float4 bk = make_float4(k_bias[d0], k_bias[d0 + 1], k_bias[d0 + 2], k_bias[d0 + 3]);
    for (int r0 = 0; r0 < 2 * N; r0 += kGroups) {  // uniform trip count
      const int r = r0 + group;
      const bool live = r < 2 * N;
      const bool is_q = r < N;
      float4* chunk = reinterpret_cast<float4*>(
          (is_q ? q + r * LD : k + (r - N) * LD) + part * 4);
      const float4 x = live ? *chunk : make_float4(0.f, 0.f, 0.f, 0.f);
      const float mean = group_sum<L>(x.x + x.y + x.z + x.w) / DH;
      const float cx = x.x - mean, cy = x.y - mean, cz = x.z - mean, cw = x.w - mean;
      const float rstd =
          rsqrtf(group_sum<L>(cx * cx + cy * cy + cz * cz + cw * cw) / DH + eps);
      if (live) {
        const float4 s = is_q ? sq : sk;
        const float4 o = is_q ? bq : bk;
        *chunk = make_float4(cx * rstd * s.x + o.x, cy * rstd * s.y + o.y,
                             cz * rstd * s.z + o.z, cw * rstd * s.w + o.w);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2;   // fragment row (and row + 8)
  const int t4 = lane & 3;   // fragment column
  const int m0 = warp * 16;      // this warp's query rows
  const int nt8 = (N + 7) / 8;   // 8-key tiles over N rounded up to 8
  const bool active = m0 < N;    // warp-uniform; warps 4-7 never are
  float s[NT][4];                // logits, then probabilities

  if (active) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {  // 8 dims a step
      const float* qr = q + (m0 + g) * LD + c * 8 + t4;
      uint32_t ah[4], al[4];
      split_tf32(qr[0], ah[0], al[0]);
      split_tf32(qr[8 * LD], ah[1], al[1]);
      split_tf32(qr[4], ah[2], al[2]);
      split_tf32(qr[8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt8) {
          const float* kr = k + (nt * 8 + g) * LD + c * 8 + t4;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
          mma_tf32x3(s[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    const float scale = 1.0f / sqrtf((float)DH);
    float mx0 = -INFINITY, mx1 = -INFINITY;  // rows g and g + 8
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nt8) {
        const float a0 = key_add[nt * 8 + 2 * t4], a1 = key_add[nt * 8 + 2 * t4 + 1];
        s[nt][0] = s[nt][0] * scale + a0;
        s[nt][1] = s[nt][1] * scale + a1;
        s[nt][2] = s[nt][2] * scale + a0;
        s[nt][3] = s[nt][3] * scale + a1;
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nt8) {
        s[nt][0] = expf(s[nt][0] - mx0);
        s[nt][1] = expf(s[nt][1] - mx0);
        s[nt][2] = expf(s[nt][2] - mx1);
        s[nt][3] = expf(s[nt][3] - mx1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
    }
    const float inv0 = 1.f / quad_sum(sum0);
    const float inv1 = 1.f / quad_sum(sum1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] *= inv0;
      s[nt][1] *= inv0;
      s[nt][2] *= inv1;
      s[nt][3] *= inv1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's v rows have landed
  if (!active) return;

  // P.V, 8 keys a step. A thread holds the probabilities of keys 2 t4 and
  // 2 t4 + 1 of each tile (the logits' accumulator layout), where the A
  // fragment wants keys t4 and t4 + 4: the step's keys are summed in the
  // permuted order (position t4 <-> key 2 t4, t4 + 4 <-> 2 t4 + 1) and v's
  // rows are read in the same order, so P goes to the A fragments as it is
  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt < nt8) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kt][0], ph[0], pl[0]);  // row g, key 2 t4
      split_tf32(s[kt][2], ph[1], pl[1]);  // row g + 8, key 2 t4
      split_tf32(s[kt][1], ph[2], pl[2]);  // row g, key 2 t4 + 1
      split_tf32(s[kt][3], ph[3], pl[3]);  // row g + 8, key 2 t4 + 1
      const float* vr = v + (kt * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[dt * 8], bh0, bl0);
        split_tf32(vr[LD + dt * 8], bh1, bl1);
        mma_tf32x3(o[dt], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
  float* dst = out + b * lay.out_graph + h * lay.out_head;
  const int r0 = m0 + g, r1 = m0 + g + 8;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
    if (r0 < N)
      *reinterpret_cast<float2*>(dst + r0 * lay.out_row + d) = make_float2(o[dt][0], o[dt][1]);
    if (r1 < N)
      *reinterpret_cast<float2*>(dst + r1 * lay.out_row + d) = make_float2(o[dt][2], o[dt][3]);
  }
}

// ---- launchers -----------------------------------------------------------

template <typename T, bool kQkNorm>
int launch_fma(const T* q, const T* k, const T* v, const void* mask,
               const void* q_scale, const void* q_bias, const void* k_scale,
               const void* k_bias, void* out, Layout lay, int B, int N, int dh,
               int heads, void* stream) {
  if (B <= 0 || N <= 0 || dh <= 0 || heads <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(3 * N * (dh + 1) + N * (N + 1)) * sizeof(float);
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err =
      allow_shared((const void*)attention_fma_kernel<T, kQkNorm>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  attention_fma_kernel<T, kQkNorm><<<B * heads, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, (const uint8_t*)mask, (const T*)q_scale, (const T*)q_bias,
      (const T*)k_scale, (const T*)k_bias, (T*)out, lay, N, dh, heads, 1e-5f);
  return (int)cudaGetLastError();
}

template <int DH, bool kQkNorm>
int launch_mma_dh(const bf16* q, const bf16* k, const bf16* v, const void* mask,
                  const void* q_scale, const void* q_bias, const void* k_scale,
                  const void* k_bias, void* out, Layout lay, int B, int N,
                  int heads, void* stream) {
  const size_t smem = mma_shared_bytes<DH>((N + 15) & ~15);
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err =
      allow_shared((const void*)attention_mma_kernel<DH, kQkNorm>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  attention_mma_kernel<DH, kQkNorm><<<B * heads, kMmaThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, (const uint8_t*)mask, (const bf16*)q_scale, (const bf16*)q_bias,
      (const bf16*)k_scale, (const bf16*)k_bias, (bf16*)out, lay, N, heads, 1e-5f);
  return (int)cudaGetLastError();
}

// The tensor-core bodies (bf16 and split-TF32) take N <= 64 and dh in
// {16, 32, 64, 128}, with 16-byte aligned rows (the wrapper checks the
// base pointers); anything else is refused here as well as by the
// wrapper's routing. `launch` gets dh as std::integral_constant<int, dh>.
template <typename Launch>
int launch_tensor_core(int B, int N, int dh, int heads, Launch&& launch) {
  if (B <= 0 || heads <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > kMmaMaxNodes) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kQkNorm>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const void* mask,
               const void* q_scale, const void* q_bias, const void* k_scale,
               const void* k_bias, void* out, Layout lay, int B, int N, int dh,
               int heads, void* stream) {
  return launch_tensor_core(B, N, dh, heads, [&](auto d) {
    return launch_mma_dh<decltype(d)::value, kQkNorm>(
        q, k, v, mask, q_scale, q_bias, k_scale, k_bias, out, lay, B, N, heads, stream);
  });
}

template <int DH, bool kQkNorm>
int launch_tf32x3_dh(const float* q, const float* k, const float* v, const void* mask,
                     const void* q_scale, const void* q_bias, const void* k_scale,
                     const void* k_bias, void* out, Layout lay, int B, int N,
                     int heads, void* stream) {
  const size_t smem = tf32_shared_bytes<DH>((N + 15) & ~15);
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err =
      allow_shared((const void*)attention_tf32x3_kernel<DH, kQkNorm>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  attention_tf32x3_kernel<DH, kQkNorm><<<B * heads, kMmaThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, (const uint8_t*)mask, (const float*)q_scale, (const float*)q_bias,
      (const float*)k_scale, (const float*)k_bias, (float*)out, lay, N, heads, 1e-5f);
  return (int)cudaGetLastError();
}

template <bool kQkNorm>
int launch_tf32x3(const float* q, const float* k, const float* v, const void* mask,
                  const void* q_scale, const void* q_bias, const void* k_scale,
                  const void* k_bias, void* out, Layout lay, int B, int N, int dh,
                  int heads, void* stream) {
  return launch_tensor_core(B, N, dh, heads, [&](auto d) {
    return launch_tf32x3_dh<decltype(d)::value, kQkNorm>(
        q, k, v, mask, q_scale, q_bias, k_scale, k_bias, out, lay, B, N, heads, stream);
  });
}

// kernel A: raw [B, N, 3H] qkv -> head-concatenated [B, N, H]
Layout fused_layout(int N, int H, int heads) {
  const int dh = H / heads;
  return Layout{(long long)N * 3 * H, dh, 3LL * H, (long long)N * H, dh, H};
}

// kernel D: pre-split [B, heads, N, dh] q, k, v -> [B, heads, N, dh]
Layout split_layout(int N, int dh, int heads) {
  const long long head = (long long)N * dh;
  return Layout{head * heads, head, dh, head * heads, head, dh};
}

}  // namespace

extern "C" {

int llamole_fused_attention_fma_f32(const void* qkv, const void* mask,
                                    const void* q_scale, const void* q_bias,
                                    const void* k_scale, const void* k_bias,
                                    void* out, int B, int N, int H, int heads,
                                    void* stream) {
  const float* x = (const float*)qkv;
  return launch_fma<float, true>(x, x + H, x + 2 * H, mask, q_scale, q_bias,
                                 k_scale, k_bias, out, fused_layout(N, H, heads),
                                 B, N, H / heads, heads, stream);
}

int llamole_fused_attention_fma_bf16(const void* qkv, const void* mask,
                                     const void* q_scale, const void* q_bias,
                                     const void* k_scale, const void* k_bias,
                                     void* out, int B, int N, int H, int heads,
                                     void* stream) {
  const bf16* x = (const bf16*)qkv;
  return launch_fma<bf16, true>(x, x + H, x + 2 * H, mask, q_scale, q_bias,
                                k_scale, k_bias, out, fused_layout(N, H, heads),
                                B, N, H / heads, heads, stream);
}

int llamole_fused_attention_mma_bf16(const void* qkv, const void* mask,
                                     const void* q_scale, const void* q_bias,
                                     const void* k_scale, const void* k_bias,
                                     void* out, int B, int N, int H, int heads,
                                     void* stream) {
  const bf16* x = (const bf16*)qkv;
  return launch_mma<true>(x, x + H, x + 2 * H, mask, q_scale, q_bias, k_scale,
                          k_bias, out, fused_layout(N, H, heads), B, N,
                          H / heads, heads, stream);
}

int llamole_fused_attention_tf32x3_f32(const void* qkv, const void* mask,
                                       const void* q_scale, const void* q_bias,
                                       const void* k_scale, const void* k_bias,
                                       void* out, int B, int N, int H, int heads,
                                       void* stream) {
  const float* x = (const float*)qkv;
  return launch_tf32x3<true>(x, x + H, x + 2 * H, mask, q_scale, q_bias, k_scale,
                             k_bias, out, fused_layout(N, H, heads), B, N,
                             H / heads, heads, stream);
}

int llamole_graph_attention_fma_f32(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int heads,
                                    int N, int dh, void* stream) {
  return launch_fma<float, false>((const float*)q, (const float*)k,
                                  (const float*)v, mask, nullptr, nullptr,
                                  nullptr, nullptr, out, split_layout(N, dh, heads),
                                  B, N, dh, heads, stream);
}

int llamole_graph_attention_fma_bf16(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int heads,
                                     int N, int dh, void* stream) {
  return launch_fma<bf16, false>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                 mask, nullptr, nullptr, nullptr, nullptr, out,
                                 split_layout(N, dh, heads), B, N, dh, heads,
                                 stream);
}

int llamole_graph_attention_mma_bf16(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int heads,
                                     int N, int dh, void* stream) {
  return launch_mma<false>((const bf16*)q, (const bf16*)k, (const bf16*)v, mask,
                           nullptr, nullptr, nullptr, nullptr, out,
                           split_layout(N, dh, heads), B, N, dh, heads, stream);
}

int llamole_graph_attention_tf32x3_f32(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int B, int heads,
                                       int N, int dh, void* stream) {
  return launch_tf32x3<false>((const float*)q, (const float*)k, (const float*)v, mask,
                              nullptr, nullptr, nullptr, nullptr, out,
                              split_layout(N, dh, heads), B, N, dh, heads, stream);
}

const char* llamole_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
