// FlashAttention forward and backward, head-major, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//
//   flash_fwd   <- _fa_kernel    (:41, launched by _flash_forward :91)
//   flash_dq    <- _dq_kernel    (:160, launched by _flash_backward :252)
//   flash_dkv   <- _dkv_kernel   (:187, same)
//   flash_dqkv  <- _dqkv_kernel  (:228, same; the fused single-block route)
//
// The function is the reference's, not its grid. q [B,H,Lq,D], k/v
// [B,KV,Lk,D] with query head h reading kv head h / (H/KV); causal means
// key t is visible to query i iff t <= i (absolute indices, as in JAX
// whatever Lq and Lk are). The forward keeps f32 m, l and acc over an
// online softmax, casts p to v's type before P.V, and writes out (q's
// type) and lse = m + log(l) in f32; a row with l == 0 writes zeros and
// lse = NEG_INF. The backward recomputes p = exp(s - lse) and
// dS = p * (dP - Delta) * scale, cast to k's type (_recompute_p_ds :134).
// A masked s is NEG_INF and its p is 0, never exp(NEG_INF - m).
//
// Design. The Pallas kernels walk a sequential grid and carry scratch in
// VMEM; here a loop inside one CTA takes that place. Every CTA works on
// 64-row tiles of its own (the JAX block sizes only choose the route) with
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 score
// entries at rows ty + 16 i and columns tx + 16 j, and the 4 x D/16
// accumulator entries at rows ty + 16 i and columns tx + 16 j. Tiles sit in
// shared memory as f32 rows padded to an odd stride, so every operand read
// of the three micro-products below is conflict-free or a broadcast.
//
//   flash_fwd   one CTA per (q tile, head, batch); walks kv tiles up to
//               the causal edge.
//   flash_dq    one CTA per (q tile, head, batch); walks kv tiles, dQ in
//               f32 registers, cast once.
//   flash_dkv   one CTA per (kv tile, kv head, batch); walks every (q head
//               of the GQA group, q tile) pair, so the group sum lands in
//               its f32 dK/dV registers: no repeated K/V, no atomics.
//   flash_dqkv  one CTA per (kv tile, head, batch) when H == KV; one
//               recompute of s/p per tile pair feeds dK and dV (registers)
//               and dQ, which goes by f32 atomicAdd into a zeroed f32
//               scratch; the wrapper casts it once. The atomics make dQ's
//               summation order vary from run to run.
//
// What bounds it on an H100. At the training shape (L = 1024, D = 64) the
// work is 2 (fwd), 3 (dq), 4 (dkv) and 5 (dqkv) products of 2 * D
// operations per visible query/key pair. Over the tensor cores' rate that
// bounds the backward kernels; the forward's bytes (q, k, v read once,
// out and lse written once) bound it about as much. This first version
// computes the products with f32 FMAs from shared memory, not with tensor
// cores (mma/wgmma), and does not overlap the next tile's loads with the
// current tile's math: both are the next steps.
//
// Built by ray_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // rows of every q and kv tile
constexpr int kSP = kTile + 1;      // stride of the [64][64] p/dS tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to T and back: the reference's `.astype(dtype)` before a
// product whose other operand is of type T
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// 64 rows of D elements (row r at src + r * D) into shared memory as f32
// rows of stride D + 1; rows at or past `valid` are zeros. 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* out = dst + r * (D + 1) + c;
    if (r < valid) {
      alignas(16) T vals[kVec];
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + (long)r * D + c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// acc[i][j] += sum_k A[row_i][k] * B[col_j][k] over k < K, A and B
// row-major with strides SA and SB: S = Q K^T and dP = dO V^T
template <int K>
__device__ __forceinline__ void mm_abT(float (&acc)[4][4], const float* A,
                                       int SA, const float* B, int SB,
                                       int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * SA + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * SB + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[row_i][k] * B[k][col_j] over the 64 k of a tile:
// O += P V and dQ += dS K
template <int NJ>
__device__ __forceinline__ void mm_ab(float (&acc)[4][NJ], const float* P,
                                      const float* B, int SB, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kSP + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * SB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[k][row_i] * B[k][col_j] over the 64 k of a tile:
// dV += P^T dO and dK += dS^T Q
template <int NJ>
__device__ __forceinline__ void mm_aTb(float (&acc)[4][NJ], const float* P,
                                       const float* B, int SB, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[k * kSP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * SB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// reductions over the 16 lanes that share a row (tx = lane % 16)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int H, KV, Lq, Lk;
  float scale;
  int causal;
};

// kv tiles a q tile starting at q0 walks: up to the causal edge
__device__ __forceinline__ int kv_tiles(const Dims& d, int q0) {
  const int nk = (d.Lk + kTile - 1) / kTile;
  if (!d.causal) return nk;
  const int q_last = min(q0 + kTile, d.Lq) - 1;
  return min(nk, q_last / kTile + 1);
}

__device__ __forceinline__ bool visible(const Dims& d, int qpos, int kpos) {
  return qpos < d.Lq && kpos < d.Lk && (!d.causal || kpos <= qpos);
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Dims d) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (d.H / d.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sQ = smem;               // [64][SD]
  float* sK = sQ + kTile * SD;    // [64][SD]
  float* sV = sK + kTile * SD;    // [64][SD]
  float* sP = sV + kTile * SD;    // [64][kSP] p in v's precision

  const T* qb = q + ((long)(b * d.H + h) * d.Lq + q0) * D;
  const T* kb = k + (long)(b * d.KV + g) * d.Lk * D;
  const T* vb = v + (long)(b * d.KV + g) * d.Lk * D;
  load_tile<T, D>(sQ, qb, d.Lq - q0);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nt = kv_tiles(d, q0);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kb + (long)k0 * D, d.Lk - k0);
    load_tile<T, D>(sV, vb + (long)k0 * D, d.Lk - k0);
    __syncthreads();

    float s[4][4] = {};
    mm_abT<D>(s, sQ, SD, sK, SD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(d, qpos, k0 + tx + 16 * j) ? s[i][j] * d.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(d, qpos, k0 + tx + 16 * j) ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[(ty + 16 * i) * kSP + tx + 16 * j] = round_as(p, v);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<NJ>(acc, sP, sV, SD, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= d.Lq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + ((long)(b * d.H + h) * d.Lq + q0 + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(orow + tx + 16 * j, acc[i][j] / safe_l);
    if (tx == 0) lse[(long)(b * d.H + h) * d.Lq + q0 + row] = m[i] + logf(safe_l);
  }
}

// ------------------------------------------------------------ backward

// p and dS of one tile pair from s = Q K^T and dp = dO V^T (thread's
// entries), written to sP (p in dO's precision) and sS (dS in k's)
template <typename T>
__device__ __forceinline__ void p_and_ds(const Dims& d, float (&s)[4][4],
                                         float (&dp)[4][4], const float* lse,
                                         const float* delta, int q0, int k0,
                                         int ty, int tx, float* sP, float* sS,
                                         const T* type_tag) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const float p = visible(d, qpos, kpos) ? expf(s[i][j] * d.scale - lse[i]) : 0.f;
      const float ds = p * (dp[i][j] - delta[i]) * d.scale;
      const int at = (ty + 16 * i) * kSP + tx + 16 * j;
      if (sP != nullptr) sP[at] = round_as(p, type_tag);
      sS[at] = round_as(ds, type_tag);
    }
  }
}

// lse and Delta of the thread's four q rows (0 past Lq)
__device__ __forceinline__ void row_stats(const Dims& d, const float* lse_g,
                                          const float* delta_g, long row0,
                                          int q0, int ty, float (&lse)[4],
                                          float (&delta)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool ok = q0 + r < d.Lq;
    lse[i] = ok ? lse_g[row0 + r] : 0.f;
    delta[i] = ok ? delta_g[row0 + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_g,
                const float* __restrict__ delta_g, T* __restrict__ dq, Dims d) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (d.H / d.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile * SD;  // dO
  float* sK = sO + kTile * SD;
  float* sV = sK + kTile * SD;
  float* sS = sV + kTile * SD;  // [64][kSP] dS in k's precision

  const long row0 = (long)(b * d.H + h) * d.Lq + q0;
  load_tile<T, D>(sQ, q + row0 * D, d.Lq - q0);
  load_tile<T, D>(sO, dout + row0 * D, d.Lq - q0);
  float lse[4], delta[4];
  row_stats(d, lse_g, delta_g, row0, q0, ty, lse, delta);
  const T* kb = k + (long)(b * d.KV + g) * d.Lk * D;
  const T* vb = v + (long)(b * d.KV + g) * d.Lk * D;

  float acc[4][NJ] = {};
  const int nt = kv_tiles(d, q0);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(sK, kb + (long)k0 * D, d.Lk - k0);
    load_tile<T, D>(sV, vb + (long)k0 * D, d.Lk - k0);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_abT<D>(s, sQ, SD, sK, SD, ty, tx);
    mm_abT<D>(dp, sO, SD, sV, SD, ty, tx);
    p_and_ds(d, s, dp, lse, delta, q0, k0, ty, tx, (float*)nullptr, sS, k);
    __syncthreads();
    mm_ab<NJ>(acc, sS, sK, SD, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= d.Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(dq + (row0 + row) * D + tx + 16 * j, acc[i][j]);
  }
}

// dK/dV of one kv tile over q tiles [qt0, nq) of query heads
// [h_first, h_first + n_heads); with `dq_acc` it also adds dQ (f32
// atomics). Shared by flash_dkv (n_heads = the GQA group, no dQ) and
// flash_dqkv (one head, dQ).
template <typename T, int D>
__device__ __forceinline__ void dkv_walk(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse_g,
    const float* __restrict__ delta_g, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dq_acc, const Dims& d, int k0, int g, int b,
    int h_first, int n_heads) {
  constexpr int SD = D + 1;
  constexpr int NJ = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * SD;
  float* sQ = sV + kTile * SD;
  float* sO = sQ + kTile * SD;  // dO
  float* sP = sO + kTile * SD;  // [64 q][kSP] p in dO's precision
  float* sS = sP + kTile * kSP; // [64 q][kSP] dS in k's precision

  const long kv_row0 = (long)(b * d.KV + g) * d.Lk + k0;
  load_tile<T, D>(sK, k + kv_row0 * D, d.Lk - k0);
  load_tile<T, D>(sV, v + kv_row0 * D, d.Lk - k0);

  float dk_acc[4][NJ] = {}, dv_acc[4][NJ] = {};
  const int nq = (d.Lq + kTile - 1) / kTile;
  const int qt0 = d.causal ? k0 / kTile : 0;  // q tiles that see this tile
  for (int hh = h_first; hh < h_first + n_heads; ++hh) {
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      const long row0 = (long)(b * d.H + hh) * d.Lq + q0;
      __syncthreads();
      load_tile<T, D>(sQ, q + row0 * D, d.Lq - q0);
      load_tile<T, D>(sO, dout + row0 * D, d.Lq - q0);
      float lse[4], delta[4];
      row_stats(d, lse_g, delta_g, row0, q0, ty, lse, delta);
      __syncthreads();
      {
        float s[4][4] = {}, dp[4][4] = {};
        mm_abT<D>(s, sQ, SD, sK, SD, ty, tx);
        mm_abT<D>(dp, sO, SD, sV, SD, ty, tx);
        p_and_ds(d, s, dp, lse, delta, q0, k0, ty, tx, sP, sS, k);
      }
      __syncthreads();
      mm_aTb<NJ>(dv_acc, sP, sO, SD, ty, tx);
      mm_aTb<NJ>(dk_acc, sS, sQ, SD, ty, tx);
      if (dq_acc != nullptr) {
        float dqt[4][NJ] = {};
        mm_ab<NJ>(dqt, sS, sK, SD, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          if (q0 + row >= d.Lq) continue;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            atomicAdd(dq_acc + (row0 + row) * D + tx + 16 * j, dqt[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (k0 + row >= d.Lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(dk + (kv_row0 + row) * D + tx + 16 * j, dk_acc[i][j]);
      store(dv + (kv_row0 + row) * D + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse_g,
                 const float* __restrict__ delta_g, T* __restrict__ dk,
                 T* __restrict__ dv, Dims d) {
  const int n_rep = d.H / d.KV;
  const int g = blockIdx.y;
  dkv_walk<T, D>(q, k, v, dout, lse_g, delta_g, dk, dv, nullptr, d,
                 blockIdx.x * kTile, g, blockIdx.z, g * n_rep, n_rep);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dqkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse_g,
                  const float* __restrict__ delta_g, float* __restrict__ dq_acc,
                  T* __restrict__ dk, T* __restrict__ dv, Dims d) {
  const int h = blockIdx.y;  // H == KV
  dkv_walk<T, D>(q, k, v, dout, lse_g, delta_g, dk, dv, dq_acc, d,
                 blockIdx.x * kTile, h, blockIdx.z, h, 1);
}

// ------------------------------------------------------------- launchers

enum Which { kFwd, kDq, kDkv, kDqkv };

template <typename T, int D>
cudaError_t launch(Which which, const void* q, const void* k, const void* v,
                   const void* dout, void* out, void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, Dims d,
                   cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * kTile * (D + 1);
  constexpr size_t ptile = sizeof(float) * kTile * kSP;
  const int nq = (d.Lq + kTile - 1) / kTile;
  const int nk = (d.Lk + kTile - 1) / kTile;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  cudaError_t err;
  size_t smem;
  switch (which) {
    case kFwd: {
      smem = 3 * tile + ptile;
      auto kern = flash_fwd_kernel<T, D>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<dim3(nq, d.H, B), kThreads, smem, stream>>>(
          qt, kt, vt, static_cast<T*>(out), static_cast<float*>(lse), d);
      break;
    }
    case kDq: {
      smem = 4 * tile + ptile;
      auto kern = flash_dq_kernel<T, D>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<dim3(nq, d.H, B), kThreads, smem, stream>>>(
          qt, kt, vt, ot, lt, dt, static_cast<T*>(dq), d);
      break;
    }
    case kDkv: {
      smem = 4 * tile + 2 * ptile;
      auto kern = flash_dkv_kernel<T, D>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<dim3(nk, d.KV, B), kThreads, smem, stream>>>(
          qt, kt, vt, ot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), d);
      break;
    }
    case kDqkv: {
      if (d.H != d.KV) return cudaErrorInvalidValue;
      smem = 4 * tile + 2 * ptile;
      auto kern = flash_dqkv_kernel<T, D>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<dim3(nk, d.H, B), kThreads, smem, stream>>>(
          qt, kt, vt, ot, lt, dt, static_cast<float*>(dq), static_cast<T*>(dk),
          static_cast<T*>(dv), d);
      break;
    }
  }
  return cudaGetLastError();
}

int dispatch(Which which, const void* q, const void* k, const void* v,
             const void* dout, void* out, void* lse, const void* delta,
             void* dq, void* dk, void* dv, int B, int H, int KV, int Lq,
             int Lk, int D, float scale, int causal, int is_bf16,
             void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Lq <= 0 || Lk <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d{H, KV, Lq, Lk, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (D == 64)
      err = launch<__nv_bfloat16, 64>(which, q, k, v, dout, out, lse, delta, dq, dk, dv, B, d, st);
    else if (D == 128)
      err = launch<__nv_bfloat16, 128>(which, q, k, v, dout, out, lse, delta, dq, dk, dv, B, d, st);
    else
      err = cudaErrorInvalidValue;
  } else {
    if (D == 64)
      err = launch<float, 64>(which, q, k, v, dout, out, lse, delta, dq, dk, dv, B, d, st);
    else if (D == 128)
      err = launch<float, 128>(which, q, k, v, dout, out, lse, delta, dq, dk, dv, B, d, st);
    else
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// C entries bound by ctypes. q/dout/out/dq [B,H,Lq,D] and k/v/dk/dv
// [B,KV,Lk,D], contiguous, bf16 (is_bf16 = 1) or f32, D 64 or 128;
// lse and delta [B,H,Lq] f32. flash_dqkv needs H == KV and writes dQ into
// `dq_acc`, an f32 [B,H,Lq,D] the caller zeroed. Each returns a
// cudaError_t: 0 on a launch that was accepted.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int H, int KV,
                                int Lq, int Lk, int D, float scale, int causal,
                                int is_bf16, void* stream) {
  return dispatch(kFwd, q, k, v, nullptr, out, lse, nullptr, nullptr, nullptr,
                  nullptr, B, H, KV, Lq, Lk, D, scale, causal, is_bf16, stream);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int KV, int Lq, int Lk, int D, float scale,
                               int causal, int is_bf16, void* stream) {
  return dispatch(kDq, q, k, v, dout, nullptr, const_cast<void*>(lse), delta,
                  dq, nullptr, nullptr, B, H, KV, Lq, Lk, D, scale, causal,
                  is_bf16, stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int KV, int Lq, int Lk, int D,
                                float scale, int causal, int is_bf16,
                                void* stream) {
  return dispatch(kDkv, q, k, v, dout, nullptr, const_cast<void*>(lse), delta,
                  nullptr, dk, dv, B, H, KV, Lq, Lk, D, scale, causal, is_bf16,
                  stream);
}

extern "C" int flash_dqkv_launch(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq_acc, void* dk,
                                 void* dv, int B, int H, int Lq, int Lk, int D,
                                 float scale, int causal, int is_bf16,
                                 void* stream) {
  return dispatch(kDqkv, q, k, v, dout, nullptr, const_cast<void*>(lse), delta,
                  dq_acc, dk, dv, B, H, H, Lq, Lk, D, scale, causal, is_bf16,
                  stream);
}
