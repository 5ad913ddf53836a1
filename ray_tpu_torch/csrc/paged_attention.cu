// Multi-query paged attention over a block pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pa_kernel`
// (ray_tpu/ops/paged_attention.py:108, launched by
// `_paged_attention_pallas`). It computes the same function, not the
// Pallas grid block by block:
//
//   query i of slot b sits at global position positions[b] + i and sees
//   key t iff t <= positions[b] + i and t < kv_len[b]; table entries < 0
//   are dead. Online softmax in f32; GQA folded with the query tile.
//
// Design. One CTA per (kv head g, query tile, slot b). The CTA holds
// qb * n_rep rows: the query tile times the GQA group, row
// r = qi * n_rep + rep reading query head h = g * n_rep + rep (the fold of
// paged_attention.py:155-160). It walks the slot's block table in order,
// skips dead entries, and stops at the first block that starts past both
// the kv_len cap and the tile's last query (every later block is dead
// too). Each live block's K and V rows for head g are staged in shared
// memory as f32 (the pool's token stride is KV * D), scores and
// probabilities go through shared memory, and the f32 accumulator lives
// in registers: thread `tid` owns the (row, d) pairs tid + k * 256.
//
// What bounds it. Decode reads every live K/V byte of the slot once per
// layer: sum_b live_blocks(b) * bt * KV * D * 2 * itemsize over the
// card's memory bandwidth (3.35 TB/s on an H100 SXM). The operations,
// 4 * Q * H * D per live key, are far below the tensor cores' rate at
// decode. The design reads each live block exactly once per (slot, kv
// head, query tile), with 16-byte loads, and never materializes a
// gathered window or repeated KV heads. Not done yet: splitting one
// slot's block walk across CTAs (decode at small batch fills only
// B * KV CTAs of the 132 SMs), pipelining the next block's load under the
// current block's math, and tensor-core (wgmma) tiles for prefill.
//
// Built by ray_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // qb * n_rep; the wrapper picks qb to fit
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Copies `rows` rows of D elements (row r at src + r * src_stride) into
// shared memory as f32 rows of stride D + 1 (the pad keeps the score
// loop's per-lane row reads on distinct banks). 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int rows,
                                           long src_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* out = dst + r * (D + 1) + c;
    alignas(16) T vals[kVec];
    *reinterpret_cast<uint4*>(vals) =
        *reinterpret_cast<const uint4*>(src + r * src_stride + c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int Q, int H, int KV,
                       int bt, int nmax, int qb, int n_rep, float scale,
                       int partial) {
  constexpr int SD = D + 1;
  constexpr int kAcc = kMaxRows * D / kThreads;
  const int g = blockIdx.x;
  const int qt = blockIdx.y;
  const int b = blockIdx.z;
  const int R = qb * n_rep;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* sQ = smem;            // [R][SD]   q * scale
  float* sK = sQ + R * SD;     // [bt][SD]
  float* sV = sK + bt * SD;    // [bt][SD]
  float* sP = sV + bt * SD;    // [R][bt]   scores, then probabilities
  float* sM = sP + R * bt;     // [R]       running max
  float* sL = sM + R;          // [R]       running denominator
  float* sA = sL + R;          // [R]       this block's rescale factor

  const int pos = positions[b];
  const int kvl = kv_len[b];
  const int q0 = qt * qb;
  const int nq = min(qb, Q - q0);      // real queries in this tile
  const int qlast = pos + q0 + nq - 1;  // position of the tile's last one

  // q rows: row r = qi * n_rep + rep is q[b, q0 + qi, g * n_rep + rep, :];
  // rows of one qi are n_rep consecutive heads, D contiguous elements each
  {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = D / kVec;
    for (int i = tid; i < R * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * kVec;
      const int qi = r / n_rep;
      const int h = g * n_rep + r % n_rep;
      float* dst = sQ + r * SD + c;
      if (qi < nq) {
        alignas(16) T vals[kVec];
        const long off = ((long)(b * Q + q0 + qi) * H + h) * D + c;
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(q + off);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = to_f32(vals[e]) * scale;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
      }
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int* trow = tables + (long)b * nmax;
  const long tok_stride = (long)KV * D;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = 0; j < nmax; ++j) {
    const int kstart = j * bt;
    // blocks start further out as j grows: once one starts at or past
    // the kv_len cap, or past the last query, every later one does too
    if (kstart >= kvl || kstart > qlast) break;
    const int entry = trow[j];
    if (entry < 0) continue;
    const long base = ((long)entry * bt * KV + g) * D;
    stage_rows<T, D>(sK, k_pool + base, bt, tok_stride);
    stage_rows<T, D>(sV, v_pool + base, bt, tok_stride);
    __syncthreads();

    // scores; masked keys read NEG_INF (i == r * bt + t)
    for (int i = tid; i < R * bt; i += kThreads) {
      const int r = i / bt;
      const int t = i % bt;
      const float* qr = sQ + r * SD;
      const float* kr = sK + t * SD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int qpos = pos + q0 + r / n_rep;
      const int kpos = kstart + t;
      sP[i] = (kpos <= qpos && kpos < kvl) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row. A masked p is 0, never
    // exp(NEG_INF - m): a row whose keys in this block are all masked
    // keeps m at NEG_INF, and exp(0) = 1 would be garbage
    for (int r = warp; r < R; r += kWarps) {
      float* pr = sP + r * bt;
      const int qpos = pos + q0 + r / n_rep;
      float mx = kNegInf;
      for (int t = lane; t < bt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < bt; t += 32) {
        const int kpos = kstart + t;
        const float p = (kpos <= qpos && kpos < kvl) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < R * D) {
        const int r = idx / D;
        const int d = idx % D;
        const float* pr = sP + r * bt;
        float a = acc[k] * sA[r];
        for (int t = 0; t < bt; ++t) a = fmaf(pr[t], sV[t * SD + d], a);
        acc[k] = a;
      }
    }
    __syncthreads();  // sK/sV/sP are rewritten by the next block
  }

#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < R * D) {
      const int r = idx / D;
      const int d = idx % D;
      const int qi = r / n_rep;
      if (qi < nq) {
        const int h = g * n_rep + r % n_rep;
        const long o = ((long)(b * Q + q0 + qi) * H + h) * D + d;
        if (partial) {
          acc_out[o] = acc[k];
        } else {
          // a row with no live key has l == 0 and acc == 0: zeros out
          const float l = sL[r];
          store_from_f32(out + o, acc[k] / (l == 0.f ? 1.f : l));
        }
      }
    }
  }
  if (partial) {
    for (int r = tid; r < R; r += kThreads) {
      const int qi = r / n_rep;
      if (qi < nq) {
        const long o = (long)(b * Q + q0 + qi) * H + g * n_rep + r % n_rep;
        m_out[o] = sM[r];
        l_out[o] = sL[r];
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* positions, const int* kv_len,
                   void* out, float* acc_out, float* m_out, float* l_out,
                   int B, int Q, int H, int KV, int bt, int nmax, int qb,
                   float scale, int partial, cudaStream_t stream) {
  const int n_rep = H / KV;
  const int R = qb * n_rep;
  if (R > kMaxRows || R < 1) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(R + 2 * bt) * (D + 1) + (size_t)R * bt + 3 * R);
  auto kern = paged_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, (Q + qb - 1) / qb, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, positions, kv_len,
      static_cast<T*>(out), acc_out, m_out, l_out, Q, H, KV, bt, nmax, qb,
      n_rep, scale, partial);
  return cudaGetLastError();
}

}  // namespace

// C entry bound by ctypes. q [B,Q,H,D] and pools [N,bt,KV,D] contiguous,
// in bf16 (is_bf16 = 1) or f32; tables [B,nmax], positions and kv_len [B]
// int32 on the device. partial = 0 writes out [B,Q,H,D] in q's type;
// partial = 1 writes the f32 triple acc [B,Q,H,D], m and l [B,Q,H].
// Returns a cudaError_t: 0 on a launch that was accepted.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* positions, const void* kv_len, void* out, void* acc_out,
    void* m_out, void* l_out, int B, int Q, int H, int KV, int D, int bt,
    int nmax, int qb, float scale, int is_bf16, int partial, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* kl = static_cast<const int*>(kv_len);
  float* ao = static_cast<float*>(acc_out);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || B <= 0 || Q <= 0 || bt <= 0 || nmax <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (is_bf16) {
    if (D == 128)
      err = launch<__nv_bfloat16, 128>(q, k_pool, v_pool, tb, ps, kl, out, ao,
                                       mo, lo, B, Q, H, KV, bt, nmax, qb,
                                       scale, partial, st);
    else if (D == 64)
      err = launch<__nv_bfloat16, 64>(q, k_pool, v_pool, tb, ps, kl, out, ao,
                                      mo, lo, B, Q, H, KV, bt, nmax, qb, scale,
                                      partial, st);
    else
      err = cudaErrorInvalidValue;
  } else {
    if (D == 128)
      err = launch<float, 128>(q, k_pool, v_pool, tb, ps, kl, out, ao, mo, lo,
                               B, Q, H, KV, bt, nmax, qb, scale, partial, st);
    else if (D == 64)
      err = launch<float, 64>(q, k_pool, v_pool, tb, ps, kl, out, ao, mo, lo,
                              B, Q, H, KV, bt, nmax, qb, scale, partial, st);
    else
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
