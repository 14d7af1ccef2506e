// Causal, segment-masked, grouped-query flash attention for the LLM: kernel E.
//
// Kernel E replaces the three Pallas TPU kernels that the JAX LLM's flash
// route reaches (llamole_tpu/models/gllm/model.py `_flash_attention`, which
// calls jaxlib's jax/experimental/pallas/ops/tpu/flash_attention.py):
// the forward `_flash_attention_impl` (body `_flash_attention_kernel`), and
// the backward's `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`.
// The function: q [B, S, H, D], k / v [B, S, KV, D], segment ids [B, S]
// (the LLM's attention mask). Query i attends key j iff j <= i and
// seg[i] == seg[j]; logits q.k * (1 / sqrt(D)) in f32, masked ones at
// jaxlib's DEFAULT_MASK_VALUE (-0.7 * FLT_MAX); the probabilities are
// rounded to v's type before P.V; query head h reads KV head h / (H / KV)
// in place (no repeated copy of k and v). Outputs: [B, S, H * D] in the
// input type and the f32 log-sum-exp [B, H, S] that the backward reads.
//
// What bounds it on an H100: at the 8B's shape (1, 2048, 32, 8, 128) bf16
// the causal forward is ~34.4 GFLOP of tensor-core products (~35 us at 989
// TFLOP/s) against ~42 MB of q, k, v and out (~13 us at 3.35 TB/s), and the
// backward's five products are ~2.5 times the forward's two: operations
// bind both. What the design keeps out of device memory is what the TPU
// kernel kept out: the [B, H, S, S] logits and probabilities, which plain
// attention saves for its backward (~0.8 GB a layer at that shape).
//
// Bodies, one set per input type:
//
// * bf16 (the LLM's type), f32 sums, every body a warpgroup body on the
//   tensor cores (wgmma, wgmma.cuh), two warpgroups a block, tiles in the
//   128-byte swizzled layout through a 2-stage cp.async ring, nothing
//   global read inside a step, exponentials on ex2.approx:
//   - flash_fwd_wgmma: one block per (b, head, 128 query rows), the
//     longest first; per step of 128 keys (64 at D = 256) S = Q.K^T from
//     shared memory, an online softmax in the log2 domain with a finite
//     mask, O += P.V with P from registers and V transposed; a step whose
//     keys lie wholly outside the rows' one segment is skipped, one
//     wholly inside it and before every row runs without the mask.
//   The backward is two kernels, as jaxlib's: dq first, which also forms
//   delta = rowsum(dO * O) (f32, from the bf16 output) and writes it out,
//   then dkv. Both recompute P = exp(s - lse) and dP = dO.V^T and round
//   dS = P * (dP - delta) * scale to bf16 (jaxlib casts ds to k's type);
//   dV takes P in dO's type. At D = 128 (the Llama, Qwen, Mistral and
//   Mixtral families):
//   - flash_bwd_dq_wgmma: one block per (b, head, 128 query rows), the
//     longest first; delta by 16-byte loads of the rows' O and dO; per
//     64-key step S = Q.K^T and dP = dO.V^T read both operands from shared
//     memory, dQ += dS.K takes dS from registers and K transposed.
//   - flash_bwd_dkv_wgmma: jaxlib's dkv grid, one block per (b, query
//     head, 128 keys), the keys with the most queries first: 8x as many
//     blocks of 1/G the work as a block per KV head, so no SM draws a
//     group's whole diagonal. Per 64-query step S^T = K.Q^T and
//     dP^T = V.dO^T from shared memory, dV += P^T.dO and dK += dS^T.Q from
//     registers; each warpgroup keeps 64 keys x 128 dims of both in f32.
//     With G = H / KV > 1 a block writes its head's f32 partials to a
//     workspace [2, G, B, S, KV, D], and flash_group_sum adds the G
//     partials in head order and casts once: no float atomics, and two
//     runs give the same bits. With G = 1 the block writes bf16.
//   At D = 256 (gemma) 64-row blocks whose warpgroups split a step's work
//   (flash_bwd_dq_wide: the step's keys, each warpgroup a partial dQ over
//   D, added once at the end; flash_bwd_dkv_wide: warpgroup 0 forms P and
//   dV, warpgroup 1 dS and dK, P handed over in shared memory), the same
//   grids, workspace and group sum (the section "the backward at D = 256").
// * f32 (an LLM built with compute_dtype other than bfloat16, as fp16:
//   true gives it): every body on the tensor cores in split TF32, three
//   mma.sync m16n8k8 TF32 passes a product: the backward (flash_bwd_dq_tf32,
//   flash_bwd_dkv_tf32: the section "the f32 backward"), the dkv kernel per
//   query head with the same workspace and group sum, and the forward
//   (flash_fwd_tf32: the section "the f32 forward"), the bf16 forward's
//   online softmax on the backward's tiles.
//
// D is 128 or 256 and S a multiple of 128 (the 128-row and 128-key
// blocks at D = 128; the route sends S % 128 == 0); the wrapper
// (ops/flash_attention.py) refuses anything else, and so do the
// launchers. More than 48 KB of shared memory is asked for through
// allow_shared, once per device.

#include <math.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;
constexpr int kSeqMultiple = 128;  // the 128-row / 128-key blocks

struct Dims {
  int B, S, H, KV;
};

// The block's (b, head, query tile) with the longest rows first.
struct QueryBlock {
  int b, h, q0;
};

__device__ __forceinline__ QueryBlock query_block(const Dims& dm, int rows) {
  const int nq = dm.S / rows;
  const int bh = blockIdx.x % (dm.B * dm.H);
  return {bh / dm.H, bh % dm.H, (nq - 1 - (int)blockIdx.x / (dm.B * dm.H)) * rows};
}

// ---- the bf16 warpgroup bodies: the forward and the backward ---------------
//
// Two warpgroups a block (8 warps); every product is a wgmma on tiles in the
// 128-byte swizzled layout of wgmma.cuh, which cp.async fills through a ring
// of kStages stages: the copies of step i + 1 land while step i multiplies
// (on an H100, 2 stages timed 0-3% faster than 3 at the 8B's shape). A step
// waits for its own stage (per-stage cp.async groups), fences the
// generic-proxy writes for wgmma's async proxy and synchronises the block
// once; each warpgroup waits for its own products before that barrier comes
// round again, so the stage it read is free to be refilled.

constexpr int kWgThreads = 256;  // two warpgroups of 64 rows (or keys)
constexpr int kDkvKeys = 128;    // keys a dkv block
constexpr int kDkvRows = 64;     // queries a dkv step
constexpr int kDqRows = 128;     // query rows a dq block
constexpr int kDqKeys = 64;      // keys a dq step
constexpr int kStages = 2;       // the copy ring's depth
constexpr int kRowBytes = 128 * 2;  // one row of D = 128 bf16

__host__ __device__ constexpr size_t round_1k(size_t x) { return (x + 1023) / 1024 * 1024; }

// a dkv stage: Q and dO [64][128] swizzled, then the 64 queries' segment
// ids, log-sum-exps and deltas
constexpr size_t kDkvStageBytes = round_1k(2 * kDkvRows * kRowBytes + 3 * kDkvRows * 4);
constexpr size_t kDkvSharedBytes = 1024 + 2 * kDkvKeys * kRowBytes + kStages * kDkvStageBytes;
// a dq stage: K and V [64][128] swizzled, then the 64 keys' segment ids
constexpr size_t kDqStageBytes = round_1k(2 * kDqKeys * kRowBytes + kDqKeys * 4);
constexpr size_t kDqSharedBytes =
    1024 + 2 * kDqRows * kRowBytes + kStages * kDqStageBytes + kDqRows * 4;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx, ~2 ulp): the backward's
// P = exp(s * scale - lse) is taken as 2^(s * scale log2 e - lse log2 e),
// two instructions where expf takes about ten
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 1024-byte aligned start of dynamic shared memory (the swizzle's repeat)
__device__ __forceinline__ char* align_1k(unsigned char* p) {
  return reinterpret_cast<char*>(p) + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// A (64 rows) . B^T over depth D for one warpgroup: two K-major tiles, the
// A rows starting at row0 of a tile of a_rows rows, B's 2 R / 4 rows (32,
// 64 or 128 for a 16-, 32- or 64-register d) the product's columns, from
// b, a row of a tile of b_rows rows (a multiple of 8: the swizzle's repeat)
template <int D = 128, int R>
__device__ __forceinline__ void product_qk(float (&d)[R], const void* a, int a_rows, int row0,
                                           const void* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_k_major(a, a_rows, row0, kk), db = desc_k_major(b, b_rows, 0, kk);
    if constexpr (R == 16)
      wgmma_64x32_ss(d, da, db, kk);
    else if constexpr (R == 32)
      wgmma_64x64_ss(d, da, db, kk);
    else
      wgmma_64x128_ss(d, da, db, kk);
  }
}

// d += A (64 x 16 K, K k steps of register fragments) . B (16 K x 128, an
// MN-major tile of `rows` depth rows, its first 16 K from b; b is in the
// first of the two 64-wide blocks)
template <int K>
__device__ __forceinline__ void product_pv(float (&d)[64], const uint32_t (&a)[K][4],
                                           const void* b, int rows = 16 * K) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_64x128_rs(d, a[kk], desc_mn_major(b, rows, kk), 1);
}

// a 64 x 16 K accumulator's registers as K 16-deep A fragments, in bf16
template <int K>
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[K][4], const float (&x)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// N accumulator registers of each of a warpgroup's 128 threads into shared
// memory, register-major (thread t's register i at i * 128 + t): no bank
// conflicts, and thread t of the other warpgroup reads its own fragment
template <int N>
__device__ __forceinline__ void spill_regs(float* dst, const float (&x)[N], int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * 128 + t] = x[i];
}

// a 64 x 128 f32 accumulator of one warpgroup written as bf16 rows r0 / r1
// (row stride `row`) of dst, at dims 128 h0..128 h0 + 127
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long row, int r0, int r1, int t4,
                                                const float (&x)[64], int h0) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = h0 * 128 + i * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(dst + r0 * row + d) =
        __floats2bfloat162_rn(x[4 * i], x[4 * i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + r1 * row + d) =
        __floats2bfloat162_rn(x[4 * i + 2], x[4 * i + 3]);
  }
}

// the same in f32
__device__ __forceinline__ void store_rows_f32(float* dst, long long row, int r0, int r1, int t4,
                                               const float (&x)[64], int h0) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = h0 * 128 + i * 8 + 2 * t4;
    *reinterpret_cast<float2*>(dst + r0 * row + d) = make_float2(x[4 * i], x[4 * i + 1]);
    *reinterpret_cast<float2*>(dst + r1 * row + d) = make_float2(x[4 * i + 2], x[4 * i + 3]);
  }
}

// The forward for 128 query rows of one head (the longest rows first, the
// head fastest, so a KV group's G heads run side by side and share K / V in
// L2); warpgroup w owns rows 64 w..64 w + 63. Per step of BK keys (128 at
// D = 128; 64 at D = 256, where two stages of 128 would not fit): S = Q.K^T
// from shared memory, an online softmax in the log2 domain on ex2.approx,
// O += P.V with P from registers and V transposed. The logits are scaled by
// scale log2 e; a masked one is kMaskValue itself, finite, so a row whose
// keys so far are all masked keeps max kMaskValue and adds 2^0 per key, as
// jaxlib's body adds exp(0), and its first real key rescales that by
// 2^(kMaskValue - m) = 0 (kMaskValue x log2 e would be -inf, and
// -inf - -inf NaN). Each step reads the segment ids of its keys against
// the warpgroup's rows: where the rows lie in one segment and no key is in
// it, every pair is masked and the step changes no result (what it would
// add before the row's first real key, that key wipes), so the warpgroup
// skips it; where every key is in it and precedes every row, the step
// skips the mask and the scale folds into the exponent's FMA. lse goes out
// in natural log: (m + log2 l) ln 2.
constexpr int kFwdRows = 128;  // query rows a forward block
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D == 128 ? 128 : 64;
}

// a forward stage: K and V [BK][D] swizzled, then the BK keys' segment ids
template <int D>
__host__ __device__ constexpr size_t fwd_stage_bytes() {
  return round_1k(2 * fwd_keys<D>() * D * 2 + fwd_keys<D>() * 4);
}

template <int D>
constexpr size_t fwd_wgmma_shared_bytes() {
  return 1024 + kFwdRows * D * 2 + kStages * fwd_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, bf16* __restrict__ out, float* __restrict__ lse, Dims dm,
    float scale) {
  constexpr int BK = fwd_keys<D>();
  constexpr int kRow = D * 2;  // bytes of one row
  constexpr size_t kStage = fwd_stage_bytes<D>();
  constexpr int kHalves = D / 128;  // O's 128-wide column halves
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* qs = align_1k(smem_raw);          // [128][D]
  char* stages = qs + kFwdRows * kRow;    // kStages x (K, V, key segments)

  const QueryBlock blk = query_block(dm, kFwdRows);
  const int S = dm.S;
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const int kvh = blk.h / (dm.H / dm.KV);
  const long long q_off = (long long)blk.b * S * q_row + (long long)blk.h * D;
  const bf16* kg = k + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const bf16* vg = v + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const int* sg = seg + (long long)blk.b * S;
  const int tid = threadIdx.x, wg = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nkt = (blk.q0 + kFwdRows) / BK;  // key tiles at or left of the diagonal

  auto load_stage = [&](int kt) {
    char* st = stages + (kt % kStages) * kStage;
    const int j0 = kt * BK;
    copy_tile_sw128<BK, D, kWgThreads>(st, kg + j0 * kv_row, kv_row, tid);
    copy_tile_sw128<BK, D, kWgThreads>(st + BK * kRow, vg + j0 * kv_row, kv_row, tid);
    if (tid < BK / 4) cp_async16(st + 2 * BK * kRow + tid * 16, sg + j0 + tid * 4);
  };
  copy_tile_sw128<kFwdRows, D, kWgThreads>(qs, q + q_off + blk.q0 * q_row, q_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q joins the first group
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }

  const int r0 = blk.q0 + wg * 64 + wr * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int seg0 = sg[r0], seg1 = sg[r1];
  const int wg_first = blk.q0 + wg * 64, wg_last = wg_first + 63;
  // whether the warpgroup's 64 rows lie in one segment, wseg (each warp reads all 64)
  const int wseg = sg[wg_first];
  const bool rows_one =
      __all_sync(0xffffffffu, sg[wg_first + lane] == wseg && sg[wg_first + 32 + lane] == wseg);
  const float scale2 = scale * kLog2e;
  float o[kHalves][64];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
  // running max (log2 domain) and this thread's share of the row sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    fence_async_shared();
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);  // into the stage step kt - 1 read
    cp_async_commit();
    const int j0 = kt * BK;
    if (j0 > wg_last) continue;  // warpgroup-uniform: every key is above its rows
    const char* ks = stages + (kt % kStages) * kStage;
    const char* vs = ks + BK * kRow;
    const int* kseg = reinterpret_cast<const int*>(vs + BK * kRow);
    float s[BK / 2];
    wgmma_fence();
    product_qk<D>(s, qs, kFwdRows, wg * 64, ks, BK);  // S = Q.K^T
    wgmma_commit();
    // while it runs, warpgroup-uniform: the step's keys all in the rows'
    // one segment, or none (read before the product, they would delay it)
    bool keys_in = true, keys_out = true;
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int sj = kseg[lane + 32 * c];
      keys_in = keys_in && sj == wseg;
      keys_out = keys_out && sj != wseg;
    }
    keys_in = rows_one && __all_sync(0xffffffffu, keys_in);
    keys_out = rows_one && __all_sync(0xffffffffu, keys_out);
    const bool unmasked = keys_in && j0 + BK - 1 <= wg_first;
    wgmma_wait<0>();
    fence_regs(s);
    if (keys_out) continue;  // every pair masked
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (unmasked) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
      mx0 = quad_max(mx0) * scale2;
      mx1 = quad_max(mx1) * scale2;
    } else {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int jj = nt * 8 + 2 * t4;
        const int ja = j0 + jj;
        const int sa = kseg[jj], sb = kseg[jj + 1];
        s[4 * nt] = (ja <= r0 && sa == seg0) ? s[4 * nt] * scale2 : kMaskValue;
        s[4 * nt + 1] = (ja + 1 <= r0 && sb == seg0) ? s[4 * nt + 1] * scale2 : kMaskValue;
        s[4 * nt + 2] = (ja <= r1 && sa == seg1) ? s[4 * nt + 2] * scale2 : kMaskValue;
        s[4 * nt + 3] = (ja + 1 <= r1 && sb == seg1) ? s[4 * nt + 3] * scale2 : kMaskValue;
        mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = 2^(s - m): the scale folds into an FMA where the logits are unscaled
    const float f = unmasked ? scale2 : 1.f;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[4 * nt] = exp2_approx(fmaf(s[4 * nt], f, -mn0));
      s[4 * nt + 1] = exp2_approx(fmaf(s[4 * nt + 1], f, -mn0));
      s[4 * nt + 2] = exp2_approx(fmaf(s[4 * nt + 2], f, -mn1));
      s[4 * nt + 3] = exp2_approx(fmaf(s[4 * nt + 3], f, -mn1));
      ps0 += s[4 * nt] + s[4 * nt + 1];
      ps1 += s[4 * nt + 2] + s[4 * nt + 3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[h][4 * i] *= a0;
        o[h][4 * i + 1] *= a0;
        o[h][4 * i + 2] *= a1;
        o[h][4 * i + 3] *= a1;
      }
    uint32_t pa[BK / 16][4];
    to_a_fragments(pa, s);  // P in v's type
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) product_pv(o[h], pa, vs + h * 2 * BK * 128);  // O += P.V
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_regs(o[h]);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* og = out + q_off;
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = h * 128 + i * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(og + r0 * q_row + d) =
          __floats2bfloat162_rn(o[h][4 * i] * i0, o[h][4 * i + 1] * i0);
      *reinterpret_cast<__nv_bfloat162*>(og + r1 * q_row + d) =
          __floats2bfloat162_rn(o[h][4 * i + 2] * i1, o[h][4 * i + 3] * i1);
    }
  if (t4 == 0) {
    float* lg = lse + ((long long)blk.b * dm.H + blk.h) * S;
    lg[r0] = (m0 + log2f(l0)) * kLn2;
    lg[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

// dQ for 128 query rows of one head (the longest rows first); warpgroup w
// owns rows 64 w..64 w + 63. Delta = rowsum(dO * O) of the rows comes first,
// from 16-byte loads while the first copies land.
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq, Dims dm,
    float scale) {
  constexpr int D = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* base = align_1k(smem_raw);
  char* qs = base;                              // [128][D]
  char* dos = qs + kDqRows * kRowBytes;         // [128][D]
  char* stages = dos + kDqRows * kRowBytes;     // kStages x (K, V, key segments)
  float* rowd = reinterpret_cast<float*>(stages + kStages * kDqStageBytes);

  const QueryBlock blk = query_block(dm, kDqRows);
  const int S = dm.S;
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const int kvh = blk.h / (dm.H / dm.KV);
  const long long q_off = (long long)blk.b * S * q_row + (long long)blk.h * D;
  const bf16* kg = k + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const bf16* vg = v + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const int* sg = seg + (long long)blk.b * S;
  const long long head_rows = ((long long)blk.b * dm.H + blk.h) * S;
  const int tid = threadIdx.x, wg = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nkt = (blk.q0 + kDqRows) / kDqKeys;  // key tiles at or left of the diagonal

  auto load_stage = [&](int kt) {
    char* st = stages + (kt % kStages) * kDqStageBytes;
    const int j0 = kt * kDqKeys;
    copy_tile_sw128<kDqKeys, D, kWgThreads>(st, kg + j0 * kv_row, kv_row, tid);
    copy_tile_sw128<kDqKeys, D, kWgThreads>(st + kDqKeys * kRowBytes, vg + j0 * kv_row, kv_row,
                                            tid);
    if (tid < kDqKeys / 4) cp_async16(st + 2 * kDqKeys * kRowBytes + tid * 16, sg + j0 + tid * 4);
  };
  copy_tile_sw128<kDqRows, D, kWgThreads>(qs, q + q_off + blk.q0 * q_row, q_row, tid);
  copy_tile_sw128<kDqRows, D, kWgThreads>(dos, dout + q_off + blk.q0 * q_row, q_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q and dO join the first group
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }
  {  // delta, two threads a row
    const int r = tid >> 1, half = tid & 1;
    const long long at = q_off + (blk.q0 + r) * q_row + half * 64;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 o4 = *reinterpret_cast<const uint4*>(out + at + c * 8);
      const uint4 d4 = *reinterpret_cast<const uint4*>(dout + at + c * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
        acc += of.x * df.x;
        acc += of.y * df.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (!half) {
      rowd[r] = acc;
      delta[head_rows + blk.q0 + r] = acc;
    }
  }

  const int lr0 = wg * 64 + wr * 16 + g;  // this thread's rows in the block
  const int r0 = blk.q0 + lr0, r1 = r0 + 8;
  const int seg0 = sg[r0], seg1 = sg[r1];
  const float M0 = lse[head_rows + r0] * kLog2e, M1 = lse[head_rows + r1] * kLog2e;
  const float scale2 = scale * kLog2e;
  const int wg_last = blk.q0 + wg * 64 + 63;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    fence_async_shared();
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);  // into the stage step kt - 1 read
    cp_async_commit();
    const int j0 = kt * kDqKeys;
    if (j0 > wg_last) continue;  // warpgroup-uniform: every key is above its rows
    const char* ks = stages + (kt % kStages) * kDqStageBytes;
    const char* vs = ks + kDqKeys * kRowBytes;
    const int* kseg = reinterpret_cast<const int*>(vs + kDqKeys * kRowBytes);
    float s[32], dp[32];
    wgmma_fence();
    product_qk(s, qs, kDqRows, wg * 64, ks, kDqKeys);     // S = Q.K^T
    product_qk(dp, dos, kDqRows, wg * 64, vs, kDqKeys);   // dP = dO.V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float d0 = rowd[lr0], d1 = rowd[lr0 + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int jj = nt * 8 + 2 * t4;
      const int ja = j0 + jj;
      const int sa = kseg[jj], sb = kseg[jj + 1];
      const float p0 = (ja <= r0 && sa == seg0) ? exp2_approx(fmaf(s[4 * nt], scale2, -M0)) : 0.f;
      const float p1 =
          (ja + 1 <= r0 && sb == seg0) ? exp2_approx(fmaf(s[4 * nt + 1], scale2, -M0)) : 0.f;
      const float p2 =
          (ja <= r1 && sa == seg1) ? exp2_approx(fmaf(s[4 * nt + 2], scale2, -M1)) : 0.f;
      const float p3 =
          (ja + 1 <= r1 && sb == seg1) ? exp2_approx(fmaf(s[4 * nt + 3], scale2, -M1)) : 0.f;
      s[4 * nt] = p0 * (dp[4 * nt] - d0) * scale;
      s[4 * nt + 1] = p1 * (dp[4 * nt + 1] - d0) * scale;
      s[4 * nt + 2] = p2 * (dp[4 * nt + 2] - d1) * scale;
      s[4 * nt + 3] = p3 * (dp[4 * nt + 3] - d1) * scale;
    }
    uint32_t dsa[4][4];
    to_a_fragments(dsa, s);  // dS in bf16, as jaxlib casts ds to k's type
    wgmma_fence();
    product_pv(acc, dsa, ks);  // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  store_rows_bf16(dq + q_off, q_row, r0, r1, t4, acc, 0);
}

// dK and dV of 128 keys for ONE query head h (jaxlib's dkv grid, which runs
// per head on the repeated k / v): B * H * S / 128 blocks, the keys with the
// most queries first; warpgroup w owns keys 64 w..64 w + 63. With G = H / KV
// = 1 the block writes bf16 dK and dV; otherwise its f32 partials go to
// head h % G's slice of the workspace [2][G][B][S][KV][D], and
// flash_group_sum_kernel adds the G slices in head order and casts once.
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ work, Dims dm, float scale) {
  constexpr int D = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* base = align_1k(smem_raw);
  char* ks = base;                              // [128][D]
  char* vs = ks + kDkvKeys * kRowBytes;         // [128][D]
  char* stages = vs + kDkvKeys * kRowBytes;     // kStages x (Q, dO, seg, lse, delta)

  const int S = dm.S, G = dm.H / dm.KV;
  const int bh = blockIdx.x % (dm.B * dm.H);
  const int b = bh / dm.H, h = bh % dm.H, kvh = h / G;
  const int j0 = (int)(blockIdx.x / (dm.B * dm.H)) * kDkvKeys;  // the most queries first
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const long long kv_off = (long long)b * S * kv_row + (long long)kvh * D;
  const long long q_off = (long long)b * S * q_row + (long long)h * D;
  const long long head_rows = ((long long)b * dm.H + h) * S;
  const int* sg = seg + (long long)b * S;
  const int tid = threadIdx.x, wg = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nsteps = (S - j0) / kDkvRows;  // query tiles at or below the diagonal

  auto load_stage = [&](int it) {
    char* st = stages + (it % kStages) * kDkvStageBytes;
    const int i0 = j0 + it * kDkvRows;
    copy_tile_sw128<kDkvRows, D, kWgThreads>(st, q + q_off + i0 * q_row, q_row, tid);
    copy_tile_sw128<kDkvRows, D, kWgThreads>(st + kDkvRows * kRowBytes,
                                             dout + q_off + i0 * q_row, q_row, tid);
    if (tid < 3 * kDkvRows / 4) {  // 16 chunks each of seg, lse and delta
      const int which = tid / (kDkvRows / 4), c = tid % (kDkvRows / 4);
      const void* src = which == 0   ? static_cast<const void*>(sg + i0 + c * 4)
                        : which == 1 ? static_cast<const void*>(lse + head_rows + i0 + c * 4)
                                     : static_cast<const void*>(delta + head_rows + i0 + c * 4);
      cp_async16(st + 2 * kDkvRows * kRowBytes + which * kDkvRows * 4 + c * 16, src);
    }
  };
  copy_tile_sw128<kDkvKeys, D, kWgThreads>(ks, k + kv_off + j0 * kv_row, kv_row, tid);
  copy_tile_sw128<kDkvKeys, D, kWgThreads>(vs, v + kv_off + j0 * kv_row, kv_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // K and V join the first group
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  const int jr0 = j0 + wg * 64 + wr * 16 + g, jr1 = jr0 + 8;  // this thread's keys
  const int sj0 = sg[jr0], sj1 = sg[jr1];
  const float scale2 = scale * kLog2e;
  const int wg_first = j0 + wg * 64;
  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    fence_async_shared();
    __syncthreads();
    if (it + kStages - 1 < nsteps) load_stage(it + kStages - 1);  // into the stage step it - 1 read
    cp_async_commit();
    const int i0 = j0 + it * kDkvRows;
    if (i0 + kDkvRows - 1 < wg_first) continue;  // warpgroup-uniform: every query precedes its keys
    const char* qs = stages + (it % kStages) * kDkvStageBytes;
    const char* dos = qs + kDkvRows * kRowBytes;
    const int* qseg = reinterpret_cast<const int*>(dos + kDkvRows * kRowBytes);
    const float* qlse = reinterpret_cast<const float*>(qseg + kDkvRows);
    const float* qdel = qlse + kDkvRows;
    float s[32], dp[32];
    wgmma_fence();
    product_qk(s, ks, kDkvKeys, wg * 64, qs, kDkvRows);   // S^T = K.Q^T
    product_qk(dp, vs, kDkvKeys, wg * 64, dos, kDkvRows);  // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // [4 nt], [4 nt + 1]: key jr0, queries i0 + ic and + 1; [+ 2], [+ 3]: key jr1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int ic = nt * 8 + 2 * t4;
      const int ia = i0 + ic;
      const int sa = qseg[ic], sb = qseg[ic + 1];
      const float Ma = qlse[ic] * kLog2e, Mb = qlse[ic + 1] * kLog2e;
      const float Da = qdel[ic], Db = qdel[ic + 1];
      const float p0 = (jr0 <= ia && sj0 == sa) ? exp2_approx(fmaf(s[4 * nt], scale2, -Ma)) : 0.f;
      const float p1 =
          (jr0 <= ia + 1 && sj0 == sb) ? exp2_approx(fmaf(s[4 * nt + 1], scale2, -Mb)) : 0.f;
      const float p2 =
          (jr1 <= ia && sj1 == sa) ? exp2_approx(fmaf(s[4 * nt + 2], scale2, -Ma)) : 0.f;
      const float p3 =
          (jr1 <= ia + 1 && sj1 == sb) ? exp2_approx(fmaf(s[4 * nt + 3], scale2, -Mb)) : 0.f;
      s[4 * nt] = p0;
      s[4 * nt + 1] = p1;
      s[4 * nt + 2] = p2;
      s[4 * nt + 3] = p3;
      dp[4 * nt] = p0 * (dp[4 * nt] - Da) * scale;
      dp[4 * nt + 1] = p1 * (dp[4 * nt + 1] - Db) * scale;
      dp[4 * nt + 2] = p2 * (dp[4 * nt + 2] - Da) * scale;
      dp[4 * nt + 3] = p3 * (dp[4 * nt + 3] - Db) * scale;
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_fragments(pa, s);    // P^T in dO's type
    to_a_fragments(dsa, dp);  // dS^T in q's type
    wgmma_fence();
    product_pv(dva, pa, dos);  // dV += P^T.dO
    product_pv(dka, dsa, qs);  // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  if (G == 1) {
    store_rows_bf16(dk + kv_off, kv_row, jr0, jr1, t4, dka, 0);
    store_rows_bf16(dv + kv_off, kv_row, jr0, jr1, t4, dva, 0);
    return;
  }
  const long long part = (long long)dm.B * S * kv_row;  // one slice of the workspace
  store_rows_f32(work + (h % G) * part + kv_off, kv_row, jr0, jr1, t4, dka, 0);
  store_rows_f32(work + (G + h % G) * part + kv_off, kv_row, jr0, jr1, t4, dva, 0);
}

// ---- the backward at D = 256 ----------------------------------------------
//
// At D = 256 the D = 128 layouts do not fit: a 128-row dq block keeps 128
// KB of Q and dO beside 64 KB a 64-key K / V stage, and a 128-key dkv
// block would hold dK and dV as 128 x 512 f32, 256 registers a thread on
// two warpgroups. So both kernels take 64 rows (keys) a block, and the
// two warpgroups split each step's work instead of its rows; each keeps
// one 64 x 256 f32 accumulator (128 registers) and every product is a
// wgmma (S and dP 64 wide or 32, dQ / dK / dV in two 128-wide halves of D
// with the A operand from registers). At gemma-7b's shape (16 heads, S =
// 1024) that is 256 blocks, one an SM, the longest first: counted in
// steps, the busiest of 132 SMs draws 1.03 times the mean work, where
// 128 blocks of 128 rows (under one wave) would let the longest set the
// time at 1.9 times.
// * flash_bwd_dq_wide: one block per (b, head, 64 query rows). Warpgroup w
//   takes keys 32 w..32 w + 31 of each 64-key step for all 64 rows: S =
//   Q.K^T and dP = dO.V^T (m64n32k16 from shared memory), dS, dQ_w +=
//   dS.K. At the end the two partial dQ go through shared memory: each
//   warpgroup adds the other's half of D to its own and writes it (one f32
//   addition, the same bits either way round).
// * flash_bwd_dkv_wide: one block per (b, query head, 64 keys), the keys
//   with the most queries first. Per 64-query step warpgroup 0 forms S^T =
//   K.Q^T, P = exp(s - lse) (f32), hands P to warpgroup 1 through shared
//   memory on a named barrier and adds dV += P^T.dO; warpgroup 1 forms
//   dP^T = V.dO^T, waits for P, forms dS = P (dP - delta) scale and adds
//   dK += dS^T.Q: two of the five products each. G > 1 uses the D = 128
//   body's workspace and flash_group_sum_kernel.
constexpr int kWideRows = 64;                     // rows (keys) a block, keys (queries) a step
constexpr int kWideTile = kWideRows * 256 * 2;    // one [64][256] bf16 tile, 32 KB
// a dq stage: K and V, then the 64 keys' segment ids
constexpr size_t kDqWideStage = round_1k(2 * kWideTile + kWideRows * 4);
constexpr size_t kDqWideShared = 1024 + 2 * kWideTile + kStages * kDqWideStage + kWideRows * 4;
// a dkv stage: Q and dO, then the 64 queries' segment ids, lse and delta;
// after the stages, P in f32 in the accumulators' layout
constexpr size_t kDkvWideStage = round_1k(2 * kWideTile + 3 * kWideRows * 4);
constexpr size_t kDkvWideShared =
    1024 + 2 * kWideTile + kStages * kDkvWideStage + 32 * 128 * sizeof(float);

__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq, Dims dm,
    float scale) {
  constexpr int D = 256, R = kWideRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* qs = align_1k(smem_raw);               // [64][D]
  char* dos = qs + kWideTile;                   // [64][D]
  char* stages = dos + kWideTile;               // kStages x (K, V, key segments)
  float* rowd = reinterpret_cast<float*>(stages + kStages * kDqWideStage);

  const QueryBlock blk = query_block(dm, R);
  const int S = dm.S;
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const int kvh = blk.h / (dm.H / dm.KV);
  const long long q_off = (long long)blk.b * S * q_row + (long long)blk.h * D;
  const bf16* kg = k + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const bf16* vg = v + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const int* sg = seg + (long long)blk.b * S;
  const long long head_rows = ((long long)blk.b * dm.H + blk.h) * S;
  const int tid = threadIdx.x, wg = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, t = tid & 127;
  const int nkt = (blk.q0 + R) / R;  // 64-key steps at or left of the diagonal

  auto load_stage = [&](int kt) {
    char* st = stages + (kt % kStages) * kDqWideStage;
    const int j0 = kt * R;
    copy_tile_sw128<R, D, kWgThreads>(st, kg + j0 * kv_row, kv_row, tid);
    copy_tile_sw128<R, D, kWgThreads>(st + kWideTile, vg + j0 * kv_row, kv_row, tid);
    if (tid < R / 4) cp_async16(st + 2 * kWideTile + tid * 16, sg + j0 + tid * 4);
  };
  copy_tile_sw128<R, D, kWgThreads>(qs, q + q_off + blk.q0 * q_row, q_row, tid);
  copy_tile_sw128<R, D, kWgThreads>(dos, dout + q_off + blk.q0 * q_row, q_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q and dO join the first group
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }
  {  // delta, four threads a row of 64 dims each, added pairwise
    const int r = tid >> 2, quarter = tid & 3;
    const long long at = q_off + (blk.q0 + r) * q_row + quarter * 64;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 o4 = *reinterpret_cast<const uint4*>(out + at + c * 8);
      const uint4 d4 = *reinterpret_cast<const uint4*>(dout + at + c * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
        acc += of.x * df.x;
        acc += of.y * df.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (!quarter) {
      rowd[r] = acc;
      delta[head_rows + blk.q0 + r] = acc;
    }
  }

  const int lr0 = wr * 16 + g;  // this thread's rows in the block (both warpgroups')
  const int r0 = blk.q0 + lr0, r1 = r0 + 8;
  const int seg0 = sg[r0], seg1 = sg[r1];
  const float M0 = lse[head_rows + r0] * kLog2e, M1 = lse[head_rows + r1] * kLog2e;
  const float scale2 = scale * kLog2e;
  const int kw = wg * 32;  // this warpgroup's keys in a step
  float acc[2][64];        // its dQ over the block's rows, two 128-wide halves of D
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    fence_async_shared();
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);  // into the stage step kt - 1 read
    cp_async_commit();
    const int j0 = kt * R;
    const char* ks = stages + (kt % kStages) * kDqWideStage;
    const char* vs = ks + kWideTile;
    const int* kseg = reinterpret_cast<const int*>(vs + kWideTile);
    float s[16], dp[16];
    wgmma_fence();
    product_qk<D>(s, qs, R, 0, ks + kw * 128, R);    // S = Q.K^T, 32 keys
    product_qk<D>(dp, dos, R, 0, vs + kw * 128, R);  // dP = dO.V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const float d0 = rowd[lr0], d1 = rowd[lr0 + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int jj = kw + nt * 8 + 2 * t4;
      const int ja = j0 + jj;
      const int sa = kseg[jj], sb = kseg[jj + 1];
      const float p0 = (ja <= r0 && sa == seg0) ? exp2_approx(fmaf(s[4 * nt], scale2, -M0)) : 0.f;
      const float p1 =
          (ja + 1 <= r0 && sb == seg0) ? exp2_approx(fmaf(s[4 * nt + 1], scale2, -M0)) : 0.f;
      const float p2 =
          (ja <= r1 && sa == seg1) ? exp2_approx(fmaf(s[4 * nt + 2], scale2, -M1)) : 0.f;
      const float p3 =
          (ja + 1 <= r1 && sb == seg1) ? exp2_approx(fmaf(s[4 * nt + 3], scale2, -M1)) : 0.f;
      s[4 * nt] = p0 * (dp[4 * nt] - d0) * scale;
      s[4 * nt + 1] = p1 * (dp[4 * nt + 1] - d0) * scale;
      s[4 * nt + 2] = p2 * (dp[4 * nt + 2] - d1) * scale;
      s[4 * nt + 3] = p3 * (dp[4 * nt + 3] - d1) * scale;
    }
    uint32_t dsa[2][4];
    to_a_fragments(dsa, s);  // dS in bf16, as jaxlib casts ds to k's type
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)  // dQ_w += dS.K over each 128-wide half of D
      product_pv(acc[h], dsa, ks + kw * 128 + h * 2 * R * 128, R);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  // the two warpgroups' partials: each hands over the half of D it does
  // not write (the last step's products are done: the stages are free)
  __syncthreads();
  float* half0 = reinterpret_cast<float*>(stages);  // warpgroup 1's half 0
  float* half1 = half0 + 64 * 128;                   // warpgroup 0's half 1
  if (wg == 0)
    spill_regs(half1, acc[1], t);
  else
    spill_regs(half0, acc[0], t);
  __syncthreads();
  bf16* dg = dq + q_off;
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] += half0[i * 128 + t];
    store_rows_bf16(dg, q_row, r0, r1, t4, acc[0], 0);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[1][i] += half1[i * 128 + t];
    store_rows_bf16(dg, q_row, r0, r1, t4, acc[1], 1);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ work, Dims dm, float scale) {
  constexpr int D = 256, R = kWideRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* ks = align_1k(smem_raw);                // [64][D]
  char* vs = ks + kWideTile;                    // [64][D]
  char* stages = vs + kWideTile;                // kStages x (Q, dO, seg, lse, delta)
  float* pbuf = reinterpret_cast<float*>(stages + kStages * kDkvWideStage);  // P [32][128]

  const int S = dm.S, G = dm.H / dm.KV;
  const int bh = blockIdx.x % (dm.B * dm.H);
  const int b = bh / dm.H, h = bh % dm.H, kvh = h / G;
  const int j0 = (int)(blockIdx.x / (dm.B * dm.H)) * R;  // the most queries first
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const long long kv_off = (long long)b * S * kv_row + (long long)kvh * D;
  const long long q_off = (long long)b * S * q_row + (long long)h * D;
  const long long head_rows = ((long long)b * dm.H + h) * S;
  const int* sg = seg + (long long)b * S;
  const int tid = threadIdx.x, wg = tid >> 7, wr = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, t = tid & 127;
  const int nsteps = (S - j0) / R;  // query steps at or below the diagonal

  auto load_stage = [&](int it) {
    char* st = stages + (it % kStages) * kDkvWideStage;
    const int i0 = j0 + it * R;
    copy_tile_sw128<R, D, kWgThreads>(st, q + q_off + i0 * q_row, q_row, tid);
    copy_tile_sw128<R, D, kWgThreads>(st + kWideTile, dout + q_off + i0 * q_row, q_row, tid);
    if (tid < 3 * R / 4) {  // 16 chunks each of seg, lse and delta
      const int which = tid / (R / 4), c = tid % (R / 4);
      const void* src = which == 0   ? static_cast<const void*>(sg + i0 + c * 4)
                        : which == 1 ? static_cast<const void*>(lse + head_rows + i0 + c * 4)
                                     : static_cast<const void*>(delta + head_rows + i0 + c * 4);
      cp_async16(st + 2 * kWideTile + which * R * 4 + c * 16, src);
    }
  };
  copy_tile_sw128<R, D, kWgThreads>(ks, k + kv_off + j0 * kv_row, kv_row, tid);
  copy_tile_sw128<R, D, kWgThreads>(vs, v + kv_off + j0 * kv_row, kv_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // K and V join the first group
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  const int jr0 = j0 + wr * 16 + g, jr1 = jr0 + 8;  // this thread's keys
  const int sj0 = sg[jr0], sj1 = sg[jr1];
  const float scale2 = scale * kLog2e;
  // warpgroup 0 multiplies K by Q into P and adds dV; warpgroup 1 V by dO
  // into dS and adds dK
  const char* a_tile = wg ? vs : ks;
  float acc[2][64];  // dV (warpgroup 0) or dK (1) of the block's keys, two halves of D
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    fence_async_shared();
    __syncthreads();
    if (it + kStages - 1 < nsteps) load_stage(it + kStages - 1);  // into the stage step it - 1 read
    cp_async_commit();
    const int i0 = j0 + it * R;
    const char* qs = stages + (it % kStages) * kDkvWideStage;
    const char* dos = qs + kWideTile;
    const int* qseg = reinterpret_cast<const int*>(dos + kWideTile);
    const float* qlse = reinterpret_cast<const float*>(qseg + R);
    const float* qdel = qlse + R;
    float x[32];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (1)
    wgmma_fence();
    product_qk<D>(x, a_tile, R, 0, wg ? dos : qs, R);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    // [4 nt], [4 nt + 1]: key jr0, queries i0 + ic and + 1; [+ 2], [+ 3]: key jr1
    if (wg == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ic = nt * 8 + 2 * t4;
        const int ia = i0 + ic;
        const int sa = qseg[ic], sb = qseg[ic + 1];
        const float Ma = qlse[ic] * kLog2e, Mb = qlse[ic + 1] * kLog2e;
        x[4 * nt] = (jr0 <= ia && sj0 == sa) ? exp2_approx(fmaf(x[4 * nt], scale2, -Ma)) : 0.f;
        x[4 * nt + 1] =
            (jr0 <= ia + 1 && sj0 == sb) ? exp2_approx(fmaf(x[4 * nt + 1], scale2, -Mb)) : 0.f;
        x[4 * nt + 2] =
            (jr1 <= ia && sj1 == sa) ? exp2_approx(fmaf(x[4 * nt + 2], scale2, -Ma)) : 0.f;
        x[4 * nt + 3] =
            (jr1 <= ia + 1 && sj1 == sb) ? exp2_approx(fmaf(x[4 * nt + 3], scale2, -Mb)) : 0.f;
      }
      spill_regs(pbuf, x, t);
      named_arrive(1, kWgThreads);
    } else {
      named_sync(1, kWgThreads);  // P of this step is in pbuf
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ic = nt * 8 + 2 * t4;
        const float Da = qdel[ic], Db = qdel[ic + 1];
        x[4 * nt] = pbuf[(4 * nt) * 128 + t] * (x[4 * nt] - Da) * scale;
        x[4 * nt + 1] = pbuf[(4 * nt + 1) * 128 + t] * (x[4 * nt + 1] - Db) * scale;
        x[4 * nt + 2] = pbuf[(4 * nt + 2) * 128 + t] * (x[4 * nt + 2] - Da) * scale;
        x[4 * nt + 3] = pbuf[(4 * nt + 3) * 128 + t] * (x[4 * nt + 3] - Db) * scale;
      }
    }
    uint32_t xa[4][4];
    to_a_fragments(xa, x);  // P^T in dO's type, or dS^T in q's
    const char* b_tile = wg ? qs : dos;
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)  // dV += P^T.dO, or dK += dS^T.Q, by halves of D
      product_pv(acc[hh], xa, b_tile + hh * 2 * R * 128, R);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  if (G == 1) {
    bf16* dst = (wg ? dk : dv) + kv_off;
    store_rows_bf16(dst, kv_row, jr0, jr1, t4, acc[0], 0);
    store_rows_bf16(dst, kv_row, jr0, jr1, t4, acc[1], 1);
    return;
  }
  const long long part = (long long)dm.B * S * kv_row;  // one slice of the workspace
  float* dst = work + ((wg ? 0 : G) + h % G) * part + kv_off;
  store_rows_f32(dst, kv_row, jr0, jr1, t4, acc[0], 0);
  store_rows_f32(dst, kv_row, jr0, jr1, t4, acc[1], 1);
}

// dK (blockIdx.y 0) or dV (1) = the sum of the workspace's G slices of n
// elements, in head order in f32, cast once to T (bf16, or f32 as it is);
// four elements a thread
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

template <typename T>
__global__ void __launch_bounds__(256) flash_group_sum_kernel(const float* __restrict__ work,
                                                              T* __restrict__ dk,
                                                              T* __restrict__ dv, long long n,
                                                              int G) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = work + (long long)blockIdx.y * G * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int gi = 1; gi < G; ++gi) {
    const float4 x = *reinterpret_cast<const float4*>(src + gi * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4((blockIdx.y ? dv : dk) + i, acc);
}

// ---- the f32 backward: split TF32 on the tensor cores ----------------------
//
// Every product is three mma.sync m16n8k8 TF32 passes into f32 registers
// (mma.cuh: lo.hi + hi.lo + hi.hi with hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi)): f32-accurate (~2e-6 relative, where one TF32 pass
// errs ~1e-3) at a third of the TF32 rate, ~165 TFLOP/s of f32 work where
// the FMA units give 67. mma.sync and not wgmma: wgmma takes TF32 only with
// both shared-memory operands K-major, and dV, dK and dQ reduce over rows
// that lie D-contiguous in dO, Q and K (each would need a transposed tile),
// where mma.sync fragments are loaded by hand in either orientation; each
// element is split into hi and lo as its fragment is loaded. Tiles are f32
// rows of D + 4 floats (the pad puts the 8 rows x 4 columns of a fragment
// read, and the 4 x 2 rows x 8 columns of a transposed one, on 32 distinct
// banks), filled through the 2-stage cp.async ring; a warp owns 16 rows (or
// keys). The arithmetic is the bf16 bodies' in f32: P = 2^(s scale log2 e -
// lse log2 e) on ex2.approx, dS = P (dP - delta) scale, delta = rowsum(dO *
// O) formed by dq; a warp skips a step wholly above the diagonal, and one
// where its rows (keys) lie in one segment and no key (query) of the step
// is in it: such a step adds 0.
// * flash_bwd_dq_tf32<D>: one block of 8 warps per (b, head, kRows query
//   rows), the longest first; per step of kKeys keys S = Q.K^T and dP =
//   dO.V^T, dS, dQ += dS.K. At D = 128 128 rows, a warp per 16, 32-key
//   steps. At D = 256 Q and dO alone take 130 KB: 64 rows and 16-key
//   steps, and warps w and w + 4 share rows 16 w..16 w + 15, each over
//   one half of D: each adds the other's partial S and dP (shared memory,
//   named barrier 1 + w) and keeps a 16 x 128 dQ: 8 warps, where a warp
//   per 16 rows would leave 4 a block, one a scheduler, to wait on each
//   product's latency.
// * flash_bwd_dkv_tf32<D>: jaxlib's dkv grid as the bf16 bodies have it,
//   one block per (b, query head, 64 keys), the keys with the most queries
//   first; warps w and w + 4 own keys 16 w..16 w + 15: warp w forms S^T =
//   K.Q^T, P and dV += P^T.dO and hands P to warp w + 4 through shared
//   memory on named barrier 1 + w; warp w + 4 forms dP^T = V.dO^T, dS and
//   dK += dS^T.Q: two of the five products each, one 16 x D accumulator
//   each. Per step of kRows queries (64; 16 at D = 256, where K and V
//   alone take 130 KB). With G > 1 the f32 partials go to the workspace and
//   flash_group_sum_kernel<float> adds them in head order.

template <int D>
struct Tf32Dq {
  static constexpr int kRows = D == 128 ? 128 : 64;  // query rows a block
  static constexpr int kKeys = D == 128 ? 32 : 16;   // keys a step
  static constexpr int kThreads = 256;               // 8 warps
  static constexpr int kSplit = 8 * 16 / kRows;      // warps (parts of D) a row tile
  static constexpr int kSets = 2;                    // product_abt_tf32's sets of sums
  // floats of a stage: K and V [kKeys][D + 4], then the keys' segment ids
  static constexpr int kStage = 2 * kKeys * (D + 4) + kKeys;
  // floats of a warp's partial S and dP where warps split D: 2 x kKeys / 8
  // fragments of 4 floats for each of 32 lanes, register-major
  static constexpr int kPartial = kSplit > 1 ? kKeys * 32 : 0;
  // Q and dO [kRows][D + 4], the stages, the rows' delta, the partials
  static constexpr size_t kShared =
      ((size_t)2 * kRows * (D + 4) + kStages * kStage + kRows + 8 * kPartial) * sizeof(float);
};

template <int D>
struct Tf32Dkv {
  static constexpr int kKeys = 64;                   // keys a block
  static constexpr int kRows = D == 128 ? 64 : 16;   // queries a step
  static constexpr int kThreads = 256;               // two warps per 16 keys
  // S^T (dP^T) in two sets of sums where a step has 16 queries
  static constexpr int kSets = D == 128 ? 1 : 2;
  // floats of a stage: Q and dO [kRows][D + 4], then the queries' segment
  // ids, log-sum-exps and deltas
  static constexpr int kStage = 2 * kRows * (D + 4) + 3 * kRows;
  // K and V [64][D + 4], the stages, P of the four warp pairs
  static constexpr size_t kShared =
      ((size_t)2 * kKeys * (D + 4) + kStages * kStage + (size_t)kKeys * kRows) * sizeof(float);
};

// ROWS rows of D floats (global row stride `stride`) into a [ROWS][D + 4]
// tile, 16 bytes a cp.async
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src, long long stride,
                                              int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / kChunks, c = e % kChunks;
    cp_async16(dst + r * (D + 4) + c * 4, src + r * stride + c * 4);
  }
}

// d[c % SETS][nt] += A (16 rows of a tile from a) . B^T (rows 8 nt..8 nt + 7
// of a tile from b) over depth chunk c (8 wide) of the W columns from a and
// b (tiles of row stride LD), split TF32; with SETS = 2 the even and odd
// chunks sum apart (the caller adds the two), for twice the independent
// products where NT is small
template <int LD, int W, int NT, int SETS>
__device__ __forceinline__ void product_abt_tf32(float (&d)[SETS][NT][4], const float* a,
                                                 const float* b, int g, int t4) {
  const float* ar = a + g * LD + t4;
  const float* br = b + g * LD + t4;
#pragma unroll
  for (int c = 0; c < W / 8; ++c) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_tf32(ar[c * 8], ah[0], al[0]);               // row g, depth t4
    split_tf32(ar[8 * LD + c * 8], ah[1], al[1]);      // row g + 8
    split_tf32(ar[c * 8 + 4], ah[2], al[2]);           // row g, depth t4 + 4
    split_tf32(ar[8 * LD + c * 8 + 4], ah[3], al[3]);  // row g + 8
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32(br[nt * 8 * LD + c * 8], bh[nt][0], bl[nt][0]);
      split_tf32(br[nt * 8 * LD + c * 8 + 4], bh[nt][1], bl[nt][1]);
    }
    mma_tf32x3_n<NT>(d[c % SETS], 0, ah, al, bh, bl);
  }
}

// d[dt] (16 rows x W) += X . B, split TF32: X 16 rows x 8 KT columns in a
// score product's accumulator layout (x[kt]: rows g, g + 8 at columns 8 kt +
// 2 t4 and + 1), B rows 8 kt.. and W columns from b (a tile of row stride
// LD). The A fragment wants columns t4 and t4 + 4 of a chunk where a thread
// holds 2 t4 and 2 t4 + 1: the chunk is summed in the permuted order
// (position t4 <-> column 2 t4, t4 + 4 <-> 2 t4 + 1) and b's rows are read
// in the same order, so X goes to the fragments as it is. Four W tiles at
// a time.
template <int LD, int W, int KT>
__device__ __forceinline__ void product_xb_tf32(float (&d)[W / 8][4], const float (&x)[KT][4],
                                                const float* b, int g, int t4) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t ah[4], al[4];
    split_tf32(x[kt][0], ah[0], al[0]);  // row g, column 2 t4
    split_tf32(x[kt][2], ah[1], al[1]);  // row g + 8, column 2 t4
    split_tf32(x[kt][1], ah[2], al[2]);  // row g, column 2 t4 + 1
    split_tf32(x[kt][3], ah[3], al[3]);  // row g + 8, column 2 t4 + 1
    const float* br = b + (kt * 8 + 2 * t4) * LD + g;
#pragma unroll
    for (int d0 = 0; d0 < W / 8; d0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split_tf32(br[(d0 + n) * 8], bh[n][0], bl[n][0]);
        split_tf32(br[LD + (d0 + n) * 8], bh[n][1], bl[n][1]);
      }
      mma_tf32x3_n<4>(d, d0, ah, al, bh, bl);
    }
  }
}

// a warp's 16 x W f32 accumulator (rows r0 / r1 of row stride `row`) to dst
template <int W>
__device__ __forceinline__ void store_rows_tf32(float* dst, long long row, int r0, int r1, int t4,
                                                const float (&x)[W / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < W / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
    *reinterpret_cast<float2*>(dst + r0 * row + d) = make_float2(x[dt][0], x[dt][1]);
    *reinterpret_cast<float2*>(dst + r1 * row + d) = make_float2(x[dt][2], x[dt][3]);
  }
}

// the score product's two sets of sums added (SETS = 2), or its one set
template <int SETS, int NT>
__device__ __forceinline__ void sum_sets(float (&z)[4], const float (&y)[SETS][NT][4], int nt) {
#pragma unroll
  for (int e = 0; e < 4; ++e) z[e] = SETS > 1 ? y[0][nt][e] + y[SETS - 1][nt][e] : y[0][nt][e];
}

template <int D>
__global__ void __launch_bounds__(Tf32Dq<D>::kThreads, 1) flash_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seg, const float* __restrict__ out, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq, Dims dm,
    float scale) {
  using P = Tf32Dq<D>;
  constexpr int R = P::kRows, BK = P::kKeys, T = P::kThreads, LD = D + 4, NT = BK / 8;
  constexpr int SETS = P::kSets, RT = R / 16, DP = D / P::kSplit, TPR = T / R;
  extern __shared__ __align__(16) float smem_tf32[];
  float* qs = smem_tf32;                        // [R][LD]
  float* dos = qs + R * LD;                     // [R][LD]
  float* stages = dos + R * LD;                 // kStages x (K, V, key segments)
  float* rowd = stages + kStages * P::kStage;   // delta of the block's rows
  float* partials = rowd + R;                   // each warp's partial S and dP

  const QueryBlock blk = query_block(dm, R);
  const int S = dm.S;
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const int kvh = blk.h / (dm.H / dm.KV);
  const long long q_off = (long long)blk.b * S * q_row + (long long)blk.h * D;
  const float* kg = k + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const float* vg = v + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const int* sg = seg + (long long)blk.b * S;
  const long long head_rows = ((long long)blk.b * dm.H + blk.h) * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp % RT, d0 = warp / RT * DP;  // the warp's row tile and first dim
  const int nkt = (blk.q0 + R) / BK;  // key steps at or left of the diagonal

  auto load_stage = [&](int kt) {
    float* st = stages + (kt % kStages) * P::kStage;
    const int j0 = kt * BK;
    copy_rows_f32<BK, D, T>(st, kg + j0 * kv_row, kv_row, tid);
    copy_rows_f32<BK, D, T>(st + BK * LD, vg + j0 * kv_row, kv_row, tid);
    if (tid < BK / 4) cp_async16(st + 2 * BK * LD + tid * 4, sg + j0 + tid * 4);
  };
  copy_rows_f32<R, D, T>(qs, q + q_off + blk.q0 * q_row, q_row, tid);
  copy_rows_f32<R, D, T>(dos, dout + q_off + blk.q0 * q_row, q_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q and dO join the first group
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }
  {  // delta, TPR neighbouring threads a row of D / TPR dims each, from
     // 16-byte loads, added pairwise
    const int r = tid / TPR, sub = tid % TPR;
    const long long at = q_off + (blk.q0 + r) * q_row + sub * (D / TPR);
    const float4* o4 = reinterpret_cast<const float4*>(out + at);
    const float4* d4 = reinterpret_cast<const float4*>(dout + at);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / TPR / 4; ++c) {
      const float4 a = o4[c], b = d4[c];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (!sub) {
      rowd[r] = acc;
      delta[head_rows + blk.q0 + r] = acc;
    }
  }

  const int lr0 = rw * 16 + g;  // this thread's rows in the block
  const int r0 = blk.q0 + lr0, r1 = r0 + 8;
  const int seg0 = sg[r0], seg1 = sg[r1];
  const float M0 = lse[head_rows + r0] * kLog2e, M1 = lse[head_rows + r1] * kLog2e;
  const float scale2 = scale * kLog2e;
  const int w_first = blk.q0 + rw * 16, w_last = w_first + 15;
  // whether the warp's 16 rows lie in one segment, wseg
  const int wseg = sg[w_first];
  const bool rows_one = __all_sync(0xffffffffu, sg[w_first + (lane & 15)] == wseg);
  const float* qw = qs + rw * 16 * LD + d0;
  const float* dow = dos + rw * 16 * LD + d0;
  float* mine = partials + warp * P::kPartial;
  const float* theirs = partials + (warp + RT) % (T / 32) * P::kPartial;  // the other half's
  float acc[DP / 8][4];  // dQ of the warp's rows at dims d0..d0 + DP - 1
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);  // into the stage step kt - 1 read
    cp_async_commit();
    const int j0 = kt * BK;
    if (j0 > w_last) continue;  // warp-uniform (and row-tile-uniform): every key is above its rows
    const float* ks = stages + (kt % kStages) * P::kStage;
    const float* vs = ks + BK * LD;
    const int* kseg = reinterpret_cast<const int*>(vs + BK * LD);
    if (rows_one) {  // the same: no key of the step in the rows' segment
      bool none = true;
      for (int j = lane; j < BK; j += 32) none = none && kseg[j] != wseg;
      if (__all_sync(0xffffffffu, none)) continue;
    }
    float s[SETS][NT][4] = {}, dp[SETS][NT][4] = {};
    product_abt_tf32<LD, DP, NT, SETS>(s, qw, ks + d0, g, t4);    // S = Q.K^T
    product_abt_tf32<LD, DP, NT, SETS>(dp, dow, vs + d0, g, t4);  // dP = dO.V^T
    float x[NT][4], y[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sum_sets(x[nt], s, nt);
      sum_sets(y[nt], dp, nt);
    }
    if constexpr (P::kSplit > 1) {  // the row tile's two halves of D: add the other's sums
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {
        mine[i * 32 + lane] = x[i / 4][i % 4];
        mine[(NT * 4 + i) * 32 + lane] = y[i / 4][i % 4];
      }
      named_sync(1 + rw, 64);  // both warps' partials are in
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {  // a + b = b + a: both warps get the same bits
        x[i / 4][i % 4] += theirs[i * 32 + lane];
        y[i / 4][i % 4] += theirs[(NT * 4 + i) * 32 + lane];
      }
    }
    const float d0r = rowd[lr0], d1r = rowd[lr0 + 8];
    // ds[nt][0], [1]: row r0, keys j0 + jj and + 1; [2], [3]: row r1
    float ds[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int jj = nt * 8 + 2 * t4;
      const int ja = j0 + jj;
      const int sa = kseg[jj], sb = kseg[jj + 1];
      const float p0 = (ja <= r0 && sa == seg0) ? exp2_approx(fmaf(x[nt][0], scale2, -M0)) : 0.f;
      const float p1 =
          (ja + 1 <= r0 && sb == seg0) ? exp2_approx(fmaf(x[nt][1], scale2, -M0)) : 0.f;
      const float p2 = (ja <= r1 && sa == seg1) ? exp2_approx(fmaf(x[nt][2], scale2, -M1)) : 0.f;
      const float p3 =
          (ja + 1 <= r1 && sb == seg1) ? exp2_approx(fmaf(x[nt][3], scale2, -M1)) : 0.f;
      ds[nt][0] = p0 * (y[nt][0] - d0r) * scale;
      ds[nt][1] = p1 * (y[nt][1] - d0r) * scale;
      ds[nt][2] = p2 * (y[nt][2] - d1r) * scale;
      ds[nt][3] = p3 * (y[nt][3] - d1r) * scale;
    }
    product_xb_tf32<LD, DP, NT>(acc, ds, ks + d0, g, t4);  // dQ += dS.K
  }
  store_rows_tf32<DP>(dq + q_off + d0, q_row, r0, r1, t4, acc);
}

template <int D>
__global__ void __launch_bounds__(Tf32Dkv<D>::kThreads, 1) flash_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seg, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ work, Dims dm, float scale) {
  using P = Tf32Dkv<D>;
  constexpr int KB = P::kKeys, BQ = P::kRows, T = P::kThreads, LD = D + 4, NT = BQ / 8;
  constexpr int SETS = P::kSets;
  extern __shared__ __align__(16) float smem_tf32[];
  float* ks = smem_tf32;                        // [64][LD]
  float* vs = ks + KB * LD;                     // [64][LD]
  float* stages = vs + KB * LD;                 // kStages x (Q, dO, seg, lse, delta)
  float* pbuf = stages + kStages * P::kStage;   // each warp pair's P, register-major

  const int S = dm.S, G = dm.H / dm.KV;
  const int bh = blockIdx.x % (dm.B * dm.H);
  const int b = bh / dm.H, h = bh % dm.H, kvh = h / G;
  const int j0 = (int)(blockIdx.x / (dm.B * dm.H)) * KB;  // the most queries first
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const long long kv_off = (long long)b * S * kv_row + (long long)kvh * D;
  const long long q_off = (long long)b * S * q_row + (long long)h * D;
  const long long head_rows = ((long long)b * dm.H + h) * S;
  const int* sg = seg + (long long)b * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = warp & 3;         // keys 16 pair..16 pair + 15
  const bool makes_p = warp < 4;     // S^T, P and dV; the pair's other warp dP^T, dS and dK
  const int nsteps = (S - j0) / BQ;  // query steps at or below the diagonal

  auto load_stage = [&](int it) {
    float* st = stages + (it % kStages) * P::kStage;
    const int i0 = j0 + it * BQ;
    copy_rows_f32<BQ, D, T>(st, q + q_off + i0 * q_row, q_row, tid);
    copy_rows_f32<BQ, D, T>(st + BQ * LD, dout + q_off + i0 * q_row, q_row, tid);
    if (tid < 3 * BQ / 4) {  // BQ / 4 chunks each of seg, lse and delta
      const int which = tid / (BQ / 4), c = tid % (BQ / 4);
      const void* src = which == 0   ? static_cast<const void*>(sg + i0 + c * 4)
                        : which == 1 ? static_cast<const void*>(lse + head_rows + i0 + c * 4)
                                     : static_cast<const void*>(delta + head_rows + i0 + c * 4);
      cp_async16(st + 2 * BQ * LD + which * BQ + c * 4, src);
    }
  };
  copy_rows_f32<KB, D, T>(ks, k + kv_off + j0 * kv_row, kv_row, tid);
  copy_rows_f32<KB, D, T>(vs, v + kv_off + j0 * kv_row, kv_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // K and V join the first group
    if (s < nsteps) load_stage(s);
    cp_async_commit();
  }

  const int p_first = j0 + pair * 16;
  const int kr0 = p_first + g, kr1 = kr0 + 8;  // this thread's keys
  const int sk0 = sg[kr0], sk1 = sg[kr1];
  // whether the pair's 16 keys lie in one segment, pseg
  const int pseg = sg[p_first];
  const bool keys_one = __all_sync(0xffffffffu, sg[p_first + (lane & 15)] == pseg);
  const float scale2 = scale * kLog2e;
  const float* aw = (makes_p ? ks : vs) + pair * 16 * LD;  // the pair's K or V rows
  float* pw = pbuf + pair * (BQ / 2) * 32;  // the pair's P: register i of lane l at i * 32 + l
  float acc[D / 8][4];  // dV (makes_p) or dK of the pair's keys
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();
    if (it + kStages - 1 < nsteps) load_stage(it + kStages - 1);  // into the stage step it - 1 read
    cp_async_commit();
    const int i0 = j0 + it * BQ;
    if (i0 + BQ - 1 < p_first) continue;  // pair-uniform: every query precedes its keys
    const float* qst = stages + (it % kStages) * P::kStage;
    const float* dost = qst + BQ * LD;
    const int* qseg = reinterpret_cast<const int*>(dost + BQ * LD);
    const float* qlse = reinterpret_cast<const float*>(qseg + BQ);
    const float* qdel = qlse + BQ;
    if (keys_one) {  // pair-uniform: no query of the step in the keys' segment
      bool none = true;
      for (int i = lane; i < BQ; i += 32) none = none && qseg[i] != pseg;
      if (__all_sync(0xffffffffu, none)) continue;
    }
    float y[SETS][NT][4] = {};
    product_abt_tf32<LD, D, NT, SETS>(y, aw, makes_p ? qst : dost, g, t4);  // S^T or dP^T
    // x[nt][0], [1]: key kr0, queries i0 + ic and + 1; [2], [3]: key kr1
    float x[NT][4];
    if (makes_p) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ic = nt * 8 + 2 * t4;
        const int ia = i0 + ic;
        const int sa = qseg[ic], sb = qseg[ic + 1];
        const float Ma = qlse[ic] * kLog2e, Mb = qlse[ic + 1] * kLog2e;
        float z[4];
        sum_sets(z, y, nt);
        x[nt][0] = (kr0 <= ia && sk0 == sa) ? exp2_approx(fmaf(z[0], scale2, -Ma)) : 0.f;
        x[nt][1] = (kr0 <= ia + 1 && sk0 == sb) ? exp2_approx(fmaf(z[1], scale2, -Mb)) : 0.f;
        x[nt][2] = (kr1 <= ia && sk1 == sa) ? exp2_approx(fmaf(z[2], scale2, -Ma)) : 0.f;
        x[nt][3] = (kr1 <= ia + 1 && sk1 == sb) ? exp2_approx(fmaf(z[3], scale2, -Mb)) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) pw[(nt * 4 + e) * 32 + lane] = x[nt][e];
      }
      named_arrive(1 + pair, 64);
    } else {
      named_sync(1 + pair, 64);  // P of this step is in pw
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ic = nt * 8 + 2 * t4;
        const float Da = qdel[ic], Db = qdel[ic + 1];
        float z[4];
        sum_sets(z, y, nt);
        x[nt][0] = pw[(nt * 4) * 32 + lane] * (z[0] - Da) * scale;
        x[nt][1] = pw[(nt * 4 + 1) * 32 + lane] * (z[1] - Db) * scale;
        x[nt][2] = pw[(nt * 4 + 2) * 32 + lane] * (z[2] - Da) * scale;
        x[nt][3] = pw[(nt * 4 + 3) * 32 + lane] * (z[3] - Db) * scale;
      }
    }
    product_xb_tf32<LD, D, NT>(acc, x, makes_p ? dost : qst, g, t4);  // dV += P^T.dO or dK += dS^T.Q
  }
  if (G == 1) {
    store_rows_tf32<D>((makes_p ? dv : dk) + kv_off, kv_row, kr0, kr1, t4, acc);
    return;
  }
  const long long part = (long long)dm.B * S * kv_row;  // one slice of the workspace
  store_rows_tf32<D>(work + ((makes_p ? G : 0) + h % G) * part + kv_off, kv_row, kr0, kr1, t4,
                     acc);
}

// ---- the f32 forward: split TF32 on the tensor cores -----------------------
//
// flash_fwd_tf32<D>: the bf16 forward's arithmetic on the f32 backward's
// machinery. Tiles of D + 4 floats come through the 2-stage cp.async ring;
// every product is three mma.sync m16n8k8 TF32 passes (one pass errs ~1e-3,
// three ~2e-6). One block of 8 warps per (b, head, kRows query rows), the
// longest rows first with the head fastest, so a KV group's heads run side
// by side and share K / V in L2; a warp owns 16 rows. Per step of kKeys
// keys: S = Q.K^T (product_abt_tf32, Q read from shared memory), the online
// softmax in the log2 domain on ex2.approx with a masked logit at kMaskValue
// itself (finite: see the bf16 forward; kMaskValue x log2 e is -inf and
// would give NaN), then O += P.V with P taken from S's registers as they
// are (product_xb_tf32's permuted chunk order matches their layout: no
// shuffle, no trip through shared memory). lse goes out in natural log,
// (m + log2 l) ln 2, for the backward. mma.sync and not wgmma: wgmma takes
// TF32 only with both operands K-major, and P.V reduces over keys that lie
// D-contiguous in V (a transposed tile, two with the split). At D = 128 128
// rows, 64-key steps
// and a 16 x 128 O a warp. At D = 256 Q alone takes 65 KB: 64 rows, 32-key
// steps, and warps w and w + 4 share rows 16 w..16 w + 15, each over one
// half of D: each forms a partial S over its half, adds the other's
// (shared memory, named barrier 1 + w; a + b = b + a, so both warps form
// the same P bits) and keeps a 16 x 128 O of its half, where one warp per
// 16 x 256 O would leave no registers for the step's S. A warp skips a
// step wholly above its rows, and one where its rows lie in one segment
// and no key of the step does (what it would add before the row's first
// real key, that key rescales by 0); a step wholly inside that segment and
// before every row runs without the mask, its scale folded into the
// exponent's FMA. Both warps of a pair read the same rows and keys, so
// they skip alike and meet at every barrier.

template <int D>
struct Tf32Fwd {
  static constexpr int kRows = D == 128 ? 128 : 64;  // query rows a block
  static constexpr int kKeys = D == 128 ? 64 : 32;   // keys a step
  static constexpr int kThreads = 256;               // 8 warps
  static constexpr int kSplit = 8 * 16 / kRows;      // warps (parts of D) a row tile
  // product_abt_tf32's sets of sums: two where a step has 4 key tiles
  static constexpr int kSets = kKeys / 8 >= 8 ? 1 : 2;
  // floats of a stage: K and V [kKeys][D + 4], then the keys' segment ids
  static constexpr int kStage = 2 * kKeys * (D + 4) + kKeys;
  // floats of a warp's partial S where warps split D: kKeys / 8 fragments
  // of 4 floats for each of 32 lanes, register-major
  static constexpr int kPartial = kSplit > 1 ? kKeys * 16 : 0;
  // Q [kRows][D + 4], the stages, the partials
  static constexpr size_t kShared =
      ((size_t)kRows * (D + 4) + kStages * kStage + 8 * kPartial) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(Tf32Fwd<D>::kThreads, 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ seg, float* __restrict__ out, float* __restrict__ lse, Dims dm,
    float scale) {
  using P = Tf32Fwd<D>;
  constexpr int R = P::kRows, BK = P::kKeys, T = P::kThreads, LD = D + 4, NT = BK / 8;
  constexpr int SETS = P::kSets, RT = R / 16, DP = D / P::kSplit;
  extern __shared__ __align__(16) float smem_tf32[];
  float* qs = smem_tf32;                            // [R][LD]
  float* stages = qs + R * LD;                      // kStages x (K, V, key segments)
  float* partials = stages + kStages * P::kStage;   // each warp's partial S

  const QueryBlock blk = query_block(dm, R);
  const int S = dm.S;
  const long long q_row = (long long)dm.H * D, kv_row = (long long)dm.KV * D;
  const int kvh = blk.h / (dm.H / dm.KV);
  const long long q_off = (long long)blk.b * S * q_row + (long long)blk.h * D;
  const float* kg = k + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const float* vg = v + (long long)blk.b * S * kv_row + (long long)kvh * D;
  const int* sg = seg + (long long)blk.b * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp % RT, d0 = warp / RT * DP;  // the warp's row tile and first dim
  const int nkt = (blk.q0 + R) / BK;  // key steps at or left of the diagonal

  auto load_stage = [&](int kt) {
    float* st = stages + (kt % kStages) * P::kStage;
    const int j0 = kt * BK;
    copy_rows_f32<BK, D, T>(st, kg + j0 * kv_row, kv_row, tid);
    copy_rows_f32<BK, D, T>(st + BK * LD, vg + j0 * kv_row, kv_row, tid);
    if (tid < BK / 4) cp_async16(st + 2 * BK * LD + tid * 4, sg + j0 + tid * 4);
  };
  copy_rows_f32<R, D, T>(qs, q + q_off + blk.q0 * q_row, q_row, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // Q joins the first group
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }

  const int r0 = blk.q0 + rw * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int seg0 = sg[r0], seg1 = sg[r1];
  const float scale2 = scale * kLog2e;
  const int w_first = blk.q0 + rw * 16, w_last = w_first + 15;
  // whether the warp's 16 rows lie in one segment, wseg
  const int wseg = sg[w_first];
  const bool rows_one = __all_sync(0xffffffffu, sg[w_first + (lane & 15)] == wseg);
  const float* qw = qs + rw * 16 * LD + d0;
  float* mine = partials + warp * P::kPartial;
  const float* theirs = partials + (warp + RT) % (T / 32) * P::kPartial;  // the other half's
  float o[DP / 8][4];  // O of the warp's rows at dims d0..d0 + DP - 1
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // running max (log2 domain) and this thread's share of the row sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);  // into the stage step kt - 1 read
    cp_async_commit();
    const int j0 = kt * BK;
    if (j0 > w_last) continue;  // warp-uniform (and row-tile-uniform): every key is above its rows
    const float* ks = stages + (kt % kStages) * P::kStage;
    const float* vs = ks + BK * LD;
    const int* kseg = reinterpret_cast<const int*>(vs + BK * LD);
    // the same: the step's keys all in the rows' one segment, or none
    bool keys_in = true, keys_out = true;
#pragma unroll
    for (int j = lane; j < BK; j += 32) {
      keys_in = keys_in && kseg[j] == wseg;
      keys_out = keys_out && kseg[j] != wseg;
    }
    keys_in = rows_one && __all_sync(0xffffffffu, keys_in);
    if (rows_one && __all_sync(0xffffffffu, keys_out)) continue;  // every pair masked
    const bool unmasked = keys_in && j0 + BK - 1 <= w_first;
    float sc[SETS][NT][4] = {};
    product_abt_tf32<LD, DP, NT, SETS>(sc, qw, ks + d0, g, t4);  // S = Q.K^T
    // x[nt][0], [1]: row r0, keys j0 + 8 nt + 2 t4 and + 1; [2], [3]: row r1
    float x[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sum_sets(x[nt], sc, nt);
    if constexpr (P::kSplit > 1) {  // the row tile's two halves of D: add the other's sums
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) mine[i * 32 + lane] = x[i / 4][i % 4];
      named_sync(1 + rw, 64);  // both warps' partials are in
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) x[i / 4][i % 4] += theirs[i * 32 + lane];
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (unmasked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(x[nt][0], x[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(x[nt][2], x[nt][3]));
      }
      mx0 = quad_max(mx0) * scale2;
      mx1 = quad_max(mx1) * scale2;
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int jj = nt * 8 + 2 * t4;
        const int ja = j0 + jj;
        const int sa = kseg[jj], sb = kseg[jj + 1];
        x[nt][0] = (ja <= r0 && sa == seg0) ? x[nt][0] * scale2 : kMaskValue;
        x[nt][1] = (ja + 1 <= r0 && sb == seg0) ? x[nt][1] * scale2 : kMaskValue;
        x[nt][2] = (ja <= r1 && sa == seg1) ? x[nt][2] * scale2 : kMaskValue;
        x[nt][3] = (ja + 1 <= r1 && sb == seg1) ? x[nt][3] * scale2 : kMaskValue;
        mx0 = fmaxf(mx0, fmaxf(x[nt][0], x[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(x[nt][2], x[nt][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = 2^(s - m): the scale folds into the FMA where the logits are unscaled
    const float f = unmasked ? scale2 : 1.f;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      x[nt][0] = exp2_approx(fmaf(x[nt][0], f, -mn0));
      x[nt][1] = exp2_approx(fmaf(x[nt][1], f, -mn0));
      x[nt][2] = exp2_approx(fmaf(x[nt][2], f, -mn1));
      x[nt][3] = exp2_approx(fmaf(x[nt][3], f, -mn1));
      ps0 += x[nt][0] + x[nt][1];
      ps1 += x[nt][2] + x[nt][3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }
    product_xb_tf32<LD, DP, NT>(o, x, vs + d0, g, t4);  // O += P.V
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    o[i][0] *= i0;
    o[i][1] *= i0;
    o[i][2] *= i1;
    o[i][3] *= i1;
  }
  store_rows_tf32<DP>(out + q_off + d0, q_row, r0, r1, t4, o);
  if (d0 == 0 && t4 == 0) {
    float* lg = lse + ((long long)blk.b * dm.H + blk.h) * S;
    lg[r0] = (m0 + log2f(l0)) * kLn2;
    lg[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ---- launchers -----------------------------------------------------------

// 1 / sqrt(D) rounded once to f32, as jaxlib's sm_scale = 1 / np.sqrt(D)
float softmax_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

bool dims_ok(const Dims& dm, int D) {
  return dm.B > 0 && dm.S > 0 && dm.H > 0 && dm.KV > 0 && dm.H % dm.KV == 0 &&
         dm.S % kSeqMultiple == 0 && (D == 128 || D == 256);
}

// launch kernel<<<grid, threads, smem>>>(args...) after raising its shared
// memory cap where it needs more than 48 KB
template <typename... Params, typename... Args>
int launch_one(void (*kernel)(Params...), int grid, int threads, size_t smem,
               std::atomic<uint64_t>& raised, void* stream, Args... args) {
  const cudaError_t err = allow_shared((const void*)kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
             Dims dm, void* stream) {
  static std::atomic<uint64_t> raised{0};
  return launch_one(flash_fwd_wgmma_kernel<D>, dm.B * dm.H * (dm.S / kFwdRows), kWgThreads,
                    fwd_wgmma_shared_bytes<D>(), raised, stream, (const bf16*)q,
                    (const bf16*)k, (const bf16*)v, (const int*)seg, (bf16*)out, (float*)lse,
                    dm, softmax_scale(D));
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
            Dims dm, void* stream) {
  using P = Tf32Fwd<D>;
  static std::atomic<uint64_t> raised{0};
  return launch_one(flash_fwd_tf32_kernel<D>, dm.B * dm.H * (dm.S / P::kRows), P::kThreads,
                    P::kShared, raised, stream, (const float*)q, (const float*)k,
                    (const float*)v, (const int*)seg, (float*)out, (float*)lse, dm,
                    softmax_scale(D));
}

template <int D>
int dq_bf16(const void* q, const void* k, const void* v, const void* seg, const void* out,
            const void* dout, const void* lse, void* delta, void* dq, Dims dm, void* stream) {
  static std::atomic<uint64_t> raised{0};
  const auto kernel = D == 128 ? flash_bwd_dq_wgmma_kernel : flash_bwd_dq_wide_kernel;
  constexpr int rows = D == 128 ? kDqRows : kWideRows;
  constexpr size_t smem = D == 128 ? kDqSharedBytes : kDqWideShared;
  return launch_one(kernel, dm.B * dm.H * (dm.S / rows), kWgThreads, smem, raised, stream,
                    (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
                    (const bf16*)out, (const bf16*)dout, (const float*)lse, (float*)delta,
                    (bf16*)dq, dm, softmax_scale(D));
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* seg, const void* out,
           const void* dout, const void* lse, void* delta, void* dq, Dims dm, void* stream) {
  using P = Tf32Dq<D>;
  static std::atomic<uint64_t> raised{0};
  return launch_one(flash_bwd_dq_tf32_kernel<D>, dm.B * dm.H * (dm.S / P::kRows), P::kThreads,
                    P::kShared, raised, stream, (const float*)q, (const float*)k,
                    (const float*)v, (const int*)seg, (const float*)out, (const float*)dout,
                    (const float*)lse, (float*)delta, (float*)dq, dm, softmax_scale(D));
}

// the group sum of a dkv launch with G = H / KV > 1 into dk / dv of type T
template <typename T>
int group_sum(const void* work, void* dk, void* dv, Dims dm, int D, void* stream) {
  const long long n = (long long)dm.B * dm.S * dm.KV * D;
  flash_group_sum_kernel<T><<<dim3((unsigned)((n / 4 + 255) / 256), 2), 256, 0,
                              (cudaStream_t)stream>>>((const float*)work, (T*)dk, (T*)dv, n,
                                                      dm.H / dm.KV);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_bf16(const void* q, const void* k, const void* v, const void* seg, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, void* work, Dims dm,
             void* stream) {
  static std::atomic<uint64_t> raised{0};
  const auto kernel = D == 128 ? flash_bwd_dkv_wgmma_kernel : flash_bwd_dkv_wide_kernel;
  constexpr int keys = D == 128 ? kDkvKeys : kWideRows;
  constexpr size_t smem = D == 128 ? kDkvSharedBytes : kDkvWideShared;
  const int G = dm.H / dm.KV;
  if (G > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch_one(kernel, dm.B * dm.H * (dm.S / keys), kWgThreads, smem, raised,
                             stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                             (const int*)seg, (const bf16*)dout, (const float*)lse,
                             (const float*)delta, (bf16*)dk, (bf16*)dv, (float*)work, dm,
                             softmax_scale(D));
  if (err != 0 || G == 1) return err;
  return group_sum<bf16>(work, dk, dv, dm, D, stream);
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* seg, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, void* work, Dims dm,
            void* stream) {
  using P = Tf32Dkv<D>;
  static std::atomic<uint64_t> raised{0};
  const int G = dm.H / dm.KV;
  if (G > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch_one(flash_bwd_dkv_tf32_kernel<D>, dm.B * dm.H * (dm.S / P::kKeys),
                             P::kThreads, P::kShared, raised, stream, (const float*)q,
                             (const float*)k, (const float*)v, (const int*)seg,
                             (const float*)dout, (const float*)lse, (const float*)delta,
                             (float*)dk, (float*)dv, (float*)work, dm, softmax_scale(D));
  if (err != 0 || G == 1) return err;
  return group_sum<float>(work, dk, dv, dm, D, stream);
}

}  // namespace

extern "C" {

// q [B, S, H, D], k / v [B, S, KV, D], seg [B, S] int32 -> out [B, S, H * D],
// lse [B, H, S] f32
#define LLAMOLE_FLASH_FWD(suffix, impl)                                                     \
  int llamole_flash_attention_fwd_##suffix(const void* q, const void* k, const void* v,    \
                                           const void* seg, void* out, void* lse, int B,   \
                                           int S, int H, int KV, int D, void* stream) {    \
    const Dims dm{B, S, H, KV};                                                             \
    if (!dims_ok(dm, D)) return (int)cudaErrorInvalidValue;                                 \
    return D == 128 ? impl<128>(q, k, v, seg, out, lse, dm, stream)                         \
                    : impl<256>(q, k, v, seg, out, lse, dm, stream);                        \
  }

// + out, dout [B, S, H * D] and lse -> delta [B, H, S] f32 (read by the dkv
// kernel, launched after this one) and dq [B, S, H, D]; bf16 launches the
// wgmma bodies, f32 flash_bwd_dq_tf32_kernel<D>
#define LLAMOLE_FLASH_DQ(suffix, impl)                                                      \
  int llamole_flash_attention_bwd_dq_##suffix(                                              \
      const void* q, const void* k, const void* v, const void* seg, const void* out,        \
      const void* dout, const void* lse, void* delta, void* dq, int B, int S, int H, int KV, \
      int D, void* stream) {                                                                \
    const Dims dm{B, S, H, KV};                                                             \
    if (!dims_ok(dm, D)) return (int)cudaErrorInvalidValue;                                 \
    return D == 128 ? impl<128>(q, k, v, seg, out, dout, lse, delta, dq, dm, stream)        \
                    : impl<256>(q, k, v, seg, out, dout, lse, delta, dq, dm, stream);       \
  }

// + dout, lse and delta -> dk, dv [B, S, KV, D]; work: the f32 workspace
// [2, H / KV, B, S, KV, D] of every dkv body (bf16 and f32, D = 128 and
// 256) with H > KV, where each query head's partials wait for the group
// sum; unused (may be null) with H = KV. f32 launches the split-TF32
// bodies (flash_bwd_dq_tf32_kernel<D>, flash_bwd_dkv_tf32_kernel<D>)
#define LLAMOLE_FLASH_DKV(suffix, impl)                                                     \
  int llamole_flash_attention_bwd_dkv_##suffix(                                             \
      const void* q, const void* k, const void* v, const void* seg, const void* dout,       \
      const void* lse, const void* delta, void* dk, void* dv, void* work, int B, int S,     \
      int H, int KV, int D, void* stream) {                                                 \
    const Dims dm{B, S, H, KV};                                                             \
    if (!dims_ok(dm, D)) return (int)cudaErrorInvalidValue;                                 \
    return D == 128 ? impl<128>(q, k, v, seg, dout, lse, delta, dk, dv, work, dm, stream)   \
                    : impl<256>(q, k, v, seg, dout, lse, delta, dk, dv, work, dm, stream);  \
  }

LLAMOLE_FLASH_FWD(bf16, fwd_bf16)
LLAMOLE_FLASH_FWD(f32, fwd_f32)
LLAMOLE_FLASH_DQ(bf16, dq_bf16)
LLAMOLE_FLASH_DQ(f32, dq_f32)
LLAMOLE_FLASH_DKV(bf16, dkv_bf16)
LLAMOLE_FLASH_DKV(f32, dkv_f32)

}  // extern "C"
