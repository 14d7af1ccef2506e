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
// What bounds it on an H100: latency and wasted work, not bandwidth. The
// sum runs over the bonded pairs only (~2-3 a molecule's atom), so the
// rows of x and the classes it needs are few, and the one output, written
// once in full, sets the bound (4.8 MB on the training path's bank of 80
// graphs x 50 nodes x 300 channels; with adj, ~1.72 us at 3.35 TB/s). Most
// of that bank is padding: only ~8 of its 80 graphs hold a molecule, so
// 3600 of its 4000 destination rows have no bond and only store zeros.
// What the card pays is the launch, the round trips a row chains, the
// exact GELUs of the bonded rows, and the zero rows' stores. The design:
//
// - One warp per (destination row b N + i, slice of kSlice = 128
//   channels), four a lane; a row's slices in consecutive warps,
//   kFwdWarps = 4 warps a block. The warps share nothing: no shared
//   memory, no barrier. 12000 warps at (80, 50, 300), 1344 at
//   (8, 56, 300). Giving a warp the whole row of 300 channels (12 a lane)
//   measured slower at both shapes: the bonded rows' GELUs then run on a
//   third as many warps, and holding their x rows in flight took ~124
//   registers.
// - Warps go node-major: node i of every graph before node i + 1 of any.
//   A padded graph holds its atoms in its first nodes, so the bonded rows,
//   which take longest, start in the first wave whichever graphs of a
//   bank hold molecules (in row order, a bank with its molecules in the
//   last graphs started them in a second wave, 40% slower). The index
//   math is 32-bit: a warp's divisions come before its first load, and
//   64-bit ones cost every warp, the empty rows' too.
// - The row's pair list comes straight from its own row of adj and edge,
//   which is the memory layout: no staging, no shared memory that grows
//   with N, so N is free, and so is H. The warp reads the row 64 columns
//   a round trip, one coalesced adj and class value a lane per 32
//   columns; __ballot_sync(a != 0) turns them into a 64-bit mask of the
//   set columns, and a pair's adj value and class reach the warp by
//   __shfl_sync from the lane that loaded them.
// - A row without a bond (the mask stays 0) stores its zeros: one round
//   trip and one store.
// - A row with bonds walks the mask's set bits in column order,
//   kFwdPairs = 2 at a time: it starts the loads of both pairs' x rows and
//   table rows (the table's [5, H] stays in L1 and L2; a class outside 0-4
//   reads row 0) before it uses any, then adds a_ij * gelu(x[b, j] +
//   table[c_ij]) in f32 with fmaf, in j order, and stores the row once in
//   x's type. A lane's four channels are one float4 (f32) or 8-byte (bf16)
//   access where H % 4 == 0 and the rows are aligned, else four coalesced
//   scalar accesses 32 channels apart.
// - Deterministic: each output element is summed by one lane in j order,
//   with no atomics, so two runs give the same bits.
//
// The backward (kernel C) replaces `_gin_bwd_kernel` (launched by
// `_gin_bwd_pallas` from the custom_vjp's `_gin_bwd`), which runs in every
// training step once a GIN layer's input carries gradient (the retro
// predictor's layers 1-4, whose inputs the trainable connector modulates):
//
//   w[b, i, j, h] = g[b, i, h] * adj[b, i, j] * gelu'(x[b, j, h] + table[e_ij, h])
//   dx[b, j, h]   = sum_i w[b, i, j, h]
//   dtable[c, h]  = sum over (b, i, j) with e_ij = c of w[b, i, j, h]
//
// with the exact gelu' = Phi(v) + v * phi(v) (erff / expf), f32 sums, dx
// rounded once to x's type. It is a gather and sum over the bonded pairs
// (~242 of them x 300 channels on the training path's bank of 80 graphs,
// only 8 of which hold a molecule), with no matrix product in it, so what
// bounds it on an H100 is latency and wasted work, not bandwidth: the rows
// of x and g it needs are few and scattered, and most of the bank is
// padding. The design:
//
// - One block per (graph b, slice of kSlice = 128 channels), 8 warps. In
//   one round trip every thread starts its loads of the table's five rows
//   and of the graph's adj and classes (coalesced, 16 bytes where aligned);
//   it keeps each non-zero entry in shared memory at [i][j] and sets bit i
//   of column j's mask (an integer atomicOr: the same bits in any order).
//   The masks are the graph's pair list in CSC form, (j, i) order.
// - A graph without a bond (the bank's padding rows, found in the same
//   barrier) writes its zero dx rows and zero dtable partial and returns.
// - Warps take columns j in turn, lanes take channels: four a lane, one
//   float4 (f32) or 8-byte (bf16) access when H % 4 == 0 and the rows are
//   aligned, else four coalesced scalar accesses 32 channels apart. A warp
//   walks only column j's set bits, four pairs at a time with predication
//   so that four g rows are in flight together, reads x[b, j] once (only
//   for a column with a pair), and writes dx[b, j] once (zeros for a
//   column without one).
// - gelu' depends on the pair's class, not on i, so the walk sums
//   S[c] = sum of a_ij g[i] over the column's pairs of class c, and takes
//   gelu'(x[j] + table[c]) once per class the column has:
//   dx[j] = sum_c gelu'(.) S[c], and the same products go to dtable row c.
//   A molecule's column has ~3 pairs of 1-2 classes, so erff and expf run
//   about half as often as one per pair.
// - dtable: each warp keeps the five class rows of its channels in
//   registers; the block sums the warps' rows in a fixed warp order through
//   shared memory and writes one partial per graph, [B, 5, H] f32. The
//   wrapper sums the partials over B in a fixed order: no float atomics
//   anywhere, so two runs give the same bits.
//
// Limits: shared memory holds the kept entries (8 N^2 bytes), the masks
// (4 N ceil(N / 32) bytes) and the warps' 20 KB of dtable rows, whatever H
// is (H only adds channel slices to the grid). Within the 227 KB a block
// may opt into that allows N <= 161 (ops/gin_aggregate.py
// GIN_BWD_SMEM_MAX_NODES); the wrapper routes larger graphs to the second
// body below. Registers are held to 128 a thread, so that two blocks share
// an SM and the path bank's 240 blocks run in one wave.
//
// The second body (the kernel's kStaged = false instantiation) takes
// N > 161: a pretraining bank is as wide as its largest molecule, so one
// molecule of 162 atoms or more makes every graph of the bank that wide.
// It keeps no staged entries: shared memory holds only the column masks
// (4 N ceil(N / 32) bytes: 32 KB at N = 512) and the warps' dtable rows,
// and the walk reads each bonded pair's adj value and class from device
// memory (the mask pass has just read that block of adj, so it is in L2;
// the pairs are few, ~2-3 a molecule's atom). The masks keep it from
// taking every N: 4 N ceil(N / 32) + 20 KB <= 227 KB allows N <= 1292
// (GIN_BWD_MAX_NODES; kernel B's largest dense check is 512).
// The rest is the first body's: no float atomics, one f32 [5, H] dtable
// partial per graph summed by the wrapper in a fixed order, dx written
// once in x's type, padding graphs storing zeros and returning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float dgelu_exact(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  const float pdf = expf(-0.5f * v * v) * 0.39894228040143268f;
  return cdf + v * pdf;
}

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kSlice = 128;  // channels of a B warp, of a C block: 32 lanes x 4

// Channel h = s0 + slot of a lane's q-th value: slot = 4 * lane + q on the
// vector path (one 16- or 8-byte access), lane + 32 * q on the scalar one
// (four coalesced accesses).
template <bool kVec>
__device__ __forceinline__ int slot_of(int lane, int q) {
  return kVec ? 4 * lane + q : lane + 32 * q;
}

// Four consecutive elements from a 4 * sizeof(T)-byte aligned address.
template <typename T>
__device__ __forceinline__ void vec4_load(const T* __restrict__ p, float v[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ row, int s0,
                                      int lane, int H, float v[4]) {
  if constexpr (kVec) {
    const int h = s0 + 4 * lane;  // H % 4 == 0: all four in range or none
    if (h < H) {
      vec4_load<T>(row + h, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = s0 + lane + 32 * q;
      v[q] = h < H ? to_f32<T>(row[h]) : 0.f;
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store4(T* __restrict__ row, int s0, int lane,
                                       int H, const float v[4]) {
  if constexpr (kVec) {
    const int h = s0 + 4 * lane;
    if (h >= H) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + h) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(row + h) = u;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = s0 + lane + 32 * q;
      if (h < H) row[h] = from_f32<T>(v[q]);
    }
  }
}

constexpr int kFwdWarps = 4;                // warps a block
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdPairs = 2;                // pairs whose rows fly together

// One warp per (destination row b N + i, slice of kSlice channels).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFwdThreads) gin_aggregate_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ edge,
    const T* __restrict__ adj, const T* __restrict__ table,
    T* __restrict__ out, int B, int N, int H) {
  const int lane = threadIdx.x & 31;
  // warps node-major (rk = i B + b), a row's slices side by side; the
  // launch keeps the warp count within 32 bits
  const unsigned slices = (H + kSlice - 1) / kSlice;
  const unsigned w = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  const unsigned rk = w / slices;
  if (rk >= (unsigned)B * (unsigned)N) return;  // warps share nothing: no barrier
  const int s0 = (int)(w - rk * slices) * kSlice;
  const unsigned gb = rk % (unsigned)B;
  const size_t row = (size_t)gb * N + rk / (unsigned)B;
  const T* arow = adj + row * N;
  const int32_t* erow = edge + row * N;
  const T* xb = x + (size_t)gb * N * H;

  // The row's adj values and classes, 64 columns a round trip, two a lane.
  float a_lo, a_hi;
  int c_lo, c_hi;
  auto load_window = [&](int j0) {
    const int j = j0 + lane;
    a_lo = j < N ? to_f32<T>(arow[j]) : 0.f;
    c_lo = j < N ? erow[j] : 0;
    a_hi = j + 32 < N ? to_f32<T>(arow[j + 32]) : 0.f;
    c_hi = j + 32 < N ? erow[j + 32] : 0;
  };
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < N; j0 += 64) {
    load_window(j0);
    unsigned long long m = __ballot_sync(~0u, a_lo != 0.f) |
        (unsigned long long)__ballot_sync(~0u, a_hi != 0.f) << 32;
    // The set columns in order, kFwdPairs at a time: start the loads of
    // their x rows and table rows, then add a_ij * gelu(x[b, j] +
    // table[c_ij]). A row without a bond goes straight to its store.
    while (m) {  // m is the same in every lane: no divergence
      float av[kFwdPairs], xv[kFwdPairs][4], tv[kFwdPairs][4];
      int live = 0;
#pragma unroll
      for (int u = 0; u < kFwdPairs; ++u) {
        if (m) {
          const int k = __ffsll((long long)m) - 1;
          m &= m - 1;
          av[u] = __shfl_sync(~0u, k < 32 ? a_lo : a_hi, k & 31);
          const int c = __shfl_sync(~0u, k < 32 ? c_lo : c_hi, k & 31);
          load4<T, kVec>(xb + (size_t)(j0 + k) * H, s0, lane, H, xv[u]);
          load4<T, kVec>(table + (size_t)((unsigned)c < 5u ? c : 0) * H, s0,
                         lane, H, tv[u]);
          live = u + 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kFwdPairs; ++u) {
        if (u < live) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[q] = fmaf(av[u], gelu_exact(xv[u][q] + tv[u][q]), acc[q]);
        }
      }
    }
  }
  store4<T, kVec>(out + row * (size_t)H, s0, lane, H, acc);
}

template <typename T, bool kVec>
int launch_as(const void* x, const void* edge, const void* adj,
              const void* table, void* out, int B, int N, int H, void* stream) {
  const long long warps = (long long)B * N * ((H + kSlice - 1) / kSlice);
  const long long blocks = (warps + kFwdWarps - 1) / kFwdWarps;
  // the kernel counts warps in 32 bits; a bank past 2^32 warps would hold
  // over 80 GB of inputs at N >= 4
  if (blocks * kFwdWarps > 0xffffffffLL) return (int)cudaErrorInvalidConfiguration;
  gin_aggregate_kernel<T, kVec><<<(unsigned)blocks, kFwdThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int32_t*)edge, (const T*)adj, (const T*)table,
      (T*)out, B, N, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* edge, const void* adj, const void* table,
           void* out, int B, int N, int H, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaSuccess;
  // the vector path: four channels in one access, so H % 4 == 0 and the
  // rows of x, the table and out aligned to that access
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = H % 4 == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)table % align == 0 && (uintptr_t)out % align == 0;
  return vec ? launch_as<T, true>(x, edge, adj, table, out, B, N, H, stream)
             : launch_as<T, false>(x, edge, adj, table, out, B, N, H, stream);
}

// Dynamic shared memory of one block, in bytes (the wrapper's
// gin_backward_shared_bytes): in the staged body, adj's non-zero values
// and their classes at [i][j] (only those entries are written and read),
// 8 N^2 bytes; in both, a bitmask of each column's non-zero rows,
// ceil(N / 32) words a column, and the warps' [kBwdWarps][5][kSlice]
// dtable rows.
__host__ __device__ __forceinline__ int mask_words(int N) { return (N + 31) / 32; }

__host__ __device__ __forceinline__ size_t backward_smem_bytes(int N, bool staged) {
  return 4 * ((staged ? 2 * (size_t)N * N : 0) + (size_t)N * mask_words(N) +
              kBwdWarps * 5 * kSlice);
}

// kStaged: the pair values and classes kept in shared memory (N <= 161);
// otherwise only the masks are, and the walk reads each bonded pair's adj
// value and class from device memory. The bodies differ only there.
template <typename T, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kBwdThreads, 2) gin_backward_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ edge,
    const T* __restrict__ adj, const T* __restrict__ table,
    const T* __restrict__ g, T* __restrict__ dx,
    float* __restrict__ dtable_part, int N, int H) {
  extern __shared__ float smem[];
  const int NN = N * N, W = mask_words(N);
  const int kept = kStaged ? NN : 0;
  float* a_s = smem;                                            // [N][N]
  int32_t* c_s = reinterpret_cast<int32_t*>(smem + kept);       // [N][N]
  unsigned* mask = reinterpret_cast<unsigned*>(c_s + kept);     // [N][W]
  float* rows = reinterpret_cast<float*>(mask + N * W);         // [kBwdWarps][5][kSlice]

  const int b = blockIdx.x;
  const int s0 = blockIdx.y * kSlice;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* ab = adj + (size_t)b * NN;
  const int32_t* eb = edge + (size_t)b * NN;

  // 1. One round trip: every thread starts its loads of the table's five
  //    rows (its channels) and of adj and (staged) the classes (coalesced;
  //    16-byte ones when the graph's block of them is aligned), clears the
  //    column masks, and only then uses what arrived. Each non-zero entry
  //    sets bit i of column j's mask (an integer OR: the same bits in any
  //    order) and, staged, is kept at [i][j].
  float tab[5][4];
#pragma unroll
  for (int c = 0; c < 5; ++c) load4<T, kVec>(table + (size_t)c * H, s0, lane, H, tab[c]);
  bool bonded = false;
  auto keep = [&](int k, float a, int c) {
    if (a != 0.f) {
      const int i = k / N, j = k - i * N;
      if constexpr (kStaged) {
        a_s[k] = a;
        c_s[k] = c;
      }
      atomicOr(&mask[j * W + (i >> 5)], 1u << (i & 31));
      bonded = true;
    }
  };
  constexpr int kLoads = 4;  // loads of 4 entries in flight per thread
  const bool vec_stage = (NN & 3) == 0 && (uintptr_t)ab % (4 * sizeof(T)) == 0 &&
                         (!kStaged || (uintptr_t)eb % 16 == 0);
  for (int k0 = 0; k0 < NN; k0 += 4 * kLoads * kBwdThreads) {
    float a4[kLoads][4];
    int4 e4[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + 4 * (u * kBwdThreads + tid);
      a4[u][0] = a4[u][1] = a4[u][2] = a4[u][3] = 0.f;
      e4[u] = make_int4(0, 0, 0, 0);
      if (vec_stage) {
        if (k < NN) {
          vec4_load<T>(ab + k, a4[u]);
          if constexpr (kStaged) e4[u] = *reinterpret_cast<const int4*>(eb + k);
        }
      } else if constexpr (kStaged) {
        if (k < NN) a4[u][0] = to_f32<T>(ab[k]), e4[u].x = eb[k];
        if (k + 1 < NN) a4[u][1] = to_f32<T>(ab[k + 1]), e4[u].y = eb[k + 1];
        if (k + 2 < NN) a4[u][2] = to_f32<T>(ab[k + 2]), e4[u].z = eb[k + 2];
        if (k + 3 < NN) a4[u][3] = to_f32<T>(ab[k + 3]), e4[u].w = eb[k + 3];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < NN) a4[u][q] = to_f32<T>(ab[k + q]);
      }
    }
    if (k0 == 0) {
      for (int k = tid; k < N * W; k += kBwdThreads) mask[k] = 0u;
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + 4 * (u * kBwdThreads + tid);
      keep(k, a4[u][0], e4[u].x);
      keep(k + 1, a4[u][1], e4[u].y);
      keep(k + 2, a4[u][2], e4[u].z);
      keep(k + 3, a4[u][3], e4[u].w);
    }
  }

  T* dxb = dx + (size_t)b * N * H;
  float* part = dtable_part + (size_t)b * 5 * H;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  // 2. A graph without a bond (a padding row of the bank): zero dx rows
  //    and a zero partial, nothing else.
  if (!__syncthreads_or(bonded)) {
    for (int r = warp; r < N + 5; r += kBwdWarps) {
      if (r < N) {
        store4<T, kVec>(dxb + (size_t)r * H, s0, lane, H, zero);
      } else {
        float* prow = part + (size_t)(r - N) * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = s0 + slot_of<kVec>(lane, q);
          if (h < H) prow[h] = 0.f;
        }
      }
    }
    return;
  }

  // 3. Warps over columns, lanes over channels. Column j's pair list is
  //    its mask: the set bits, in row order, walked four at a time so that
  //    four g rows (and, unstaged, the pairs' adj values and classes) are
  //    in flight together. The term of pair (i, j) is
  //    g[i] a_ij gelu'(x[j] + table[c_ij]), and gelu' depends on the class
  //    and not on i, so the walk only sums S[c] = sum of a_ij g[i] over
  //    the column's pairs of class c, and gelu' is taken once per class the
  //    column has: dx[j] = sum_c gelu'(x[j] + table[c]) S[c], and the same
  //    products go to dtable row c. (Classes are 0-4: a pair of another
  //    class adds nothing.)
  const T* xb = x + (size_t)b * N * H;
  const T* gb = g + (size_t)b * N * H;
  float dt[5][4];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dt[c][q] = 0.f;
  }
  for (int j = warp; j < N; j += kBwdWarps) {
    float S[5][4], xj[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 5; ++c) {
#pragma unroll
      for (int q = 0; q < 4; ++q) S[c][q] = 0.f;
    }
    unsigned present = 0;  // classes the column has, as bits 0-4
    bool have_x = false;
    for (int w = 0; w < W; ++w) {
      unsigned m = mask[j * W + w];
      if (m && !have_x) {  // x[b, j] is read only for a column with a pair
        load4<T, kVec>(xb + (size_t)j * H, s0, lane, H, xj);
        have_x = true;
      }
      while (m) {
        float gv[4][4], av[4];
        int cv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // start every load before any use
          const bool live = m != 0;
          const int i = 32 * w + (live ? __ffs(m) - 1 : 0);
          m &= m - 1;
          if constexpr (kStaged) {
            av[u] = live ? a_s[i * N + j] : 0.f;  // a dead pair adds 0
            cv[u] = live ? c_s[i * N + j] : 0;
          } else {
            av[u] = live ? to_f32<T>(ab[i * N + j]) : 0.f;
            cv[u] = live ? eb[i * N + j] : 0;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) gv[u][q] = 0.f;
          if (live) load4<T, kVec>(gb + (size_t)i * H, s0, lane, H, gv[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          present |= av[u] != 0.f && (unsigned)cv[u] < 5u ? 1u << cv[u] : 0u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ag = av[u] * gv[u][q];
#pragma unroll
            for (int c = 0; c < 5; ++c) S[c][q] += cv[u] == c ? ag : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      if (!(present >> c & 1u)) continue;  // uniform across the warp
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = dgelu_exact(xj[q] + tab[c][q]) * S[c][q];
        acc[q] += w;
        dt[c][q] += w;
      }
    }
    store4<T, kVec>(dxb + (size_t)j * H, s0, lane, H, acc);
  }

  // 4. The warps' dtable rows summed in warp order: one partial per graph.
  float* mine = rows + warp * 5 * kSlice;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) mine[c * kSlice + slot_of<kVec>(lane, q)] = dt[c][q];
  }
  __syncthreads();
  for (int r = tid; r < 5 * kSlice; r += kBwdThreads) {
    const int c = r / kSlice, h = s0 + r % kSlice;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) sum += rows[w * 5 * kSlice + r];
    if (h < H) part[(size_t)c * H + h] = sum;
  }
}

template <typename T, bool kVec, bool kStaged>
int launch_backward_as(const void* x, const void* edge, const void* adj,
                       const void* table, const void* g, void* dx,
                       void* dtable_part, int B, int N, int H, void* stream) {
  const size_t smem = backward_smem_bytes(N, kStaged);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gin_backward_kernel<T, kVec, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, (H + kSlice - 1) / kSlice);
  gin_backward_kernel<T, kVec, kStaged><<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const int32_t*)edge, (const T*)adj, (const T*)table,
      (const T*)g, (T*)dx, (float*)dtable_part, N, H);
  return (int)cudaGetLastError();
}

// staged picks the body; the wrapper routes by N (gin_backward_body).
template <typename T>
int launch_backward(const void* x, const void* edge, const void* adj,
                    const void* table, const void* g, void* dx,
                    void* dtable_part, int B, int N, int H, bool staged,
                    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return (int)cudaSuccess;
  // the vector path: four channels in one access, so H % 4 == 0 and every
  // row it reads or writes aligned to that access
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = H % 4 == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)table % align == 0 && (uintptr_t)g % align == 0 &&
                   (uintptr_t)dx % align == 0;
  auto go = [&](auto fn) {
    return fn(x, edge, adj, table, g, dx, dtable_part, B, N, H, stream);
  };
  if (staged)
    return vec ? go(launch_backward_as<T, true, true>)
               : go(launch_backward_as<T, false, true>);
  return vec ? go(launch_backward_as<T, true, false>)
             : go(launch_backward_as<T, false, false>);
}

}  // namespace

extern "C" {

int llamole_gin_backward_f32(const void* x, const void* edge, const void* adj,
                             const void* table, const void* g, void* dx,
                             void* dtable_part, int B, int N, int H, int staged,
                             void* stream) {
  return launch_backward<float>(x, edge, adj, table, g, dx, dtable_part, B, N,
                                H, staged != 0, stream);
}

int llamole_gin_backward_bf16(const void* x, const void* edge, const void* adj,
                              const void* table, const void* g, void* dx,
                              void* dtable_part, int B, int N, int H, int staged,
                              void* stream) {
  return launch_backward<__nv_bfloat16>(x, edge, adj, table, g, dx, dtable_part,
                                        B, N, H, staged != 0, stream);
}

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
