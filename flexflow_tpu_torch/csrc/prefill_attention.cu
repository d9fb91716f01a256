// Q-tiled prefill attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `prefill_attention`
// (flexflow_tpu/ops/pallas/attention.py:444, body `_prefill_kernel` :357)
// on its fp, slot-contiguous path.  G tiles of Bq tokens of one request,
// positions contiguous from pstart[g]; each query row attends causally to
// its tile's cache row rows[g], which already holds this step's K/V.  The
// Bq*gq query rows of a (tile, kv head) are folded b-major as the reference
// folds them (row = b*gq + g'), query row r sits at position
// pstart + r/gq, and it sees the keys at positions <= that.  Online softmax
// in f32, denominator clamped at 1e-30, output in q's dtype.
//
// What bounds it on the H100: the work itself (4*D flops per query row and
// live key, the tile's K/V prefix read once) is memory-bound at the
// tensor-core rate in bf16, but this version computes with plain f32 FMAs
// (no tensor cores yet), so the CUDA cores' f32 rate caps it.  Its bytes
// are the prefix K/V read once per (tile, head, row chunk).  What the
// design does about that:
//   * one CTA per (tile, kv head, chunk of 64 folded query rows): the K/V
//     prefix streams once per chunk instead of once per token, and the
//     loop stops at the chunk's causal frontier;
//   * 64-key K/V blocks are staged in shared memory as f32 (rows padded by
//     one float so the score loop is free of bank conflicts), and each of
//     the 256 threads computes a 4x4 block of scores and a 4x(D/16) block
//     of the output in registers;
//   * the kernel masks its own ragged edges (row chunks past Bq*gq, keys
//     past pstart + b or past the cache length).
// Not yet done (later work): tensor-core mma/wgmma for bf16, TMA, int8 and
// paged variants.
//
// C interface for ctypes; the kernel allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // folded query rows per CTA
constexpr int BN = 64;   // keys per shared-memory block
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ void vec_to_float(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void vec_to_float<float>(const uint4& raw,
                                                    float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void vec_to_float<__nv_bfloat16>(const uint4& raw,
                                                            float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

static_assert(BM * 4 == kThreads, "the softmax pass gives each row 4 lanes");
static_assert(BN == 4 * 16, "each softmax lane covers 16 keys");

template <int D>
constexpr size_t smem_floats() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ss [BM][BN+1], m/l/alpha [BM]
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ rows,
               const int* __restrict__ pstart, T* __restrict__ out, int bq,
               int num_kv, int gq, int r1, int s_len, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;          // 16-byte vectors per key row
  static_assert(D % VEC == 0, "head dim must fill whole 16-byte vectors");
  constexpr int DP = D + 1;
  constexpr int SP = BN + 1;
  constexpr int DJ = (D + 15) / 16;     // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ss = Vs + BN * D;
  float* row_m = Ss + BM * SP;
  float* row_l = row_m + BM;
  float* row_a = row_l + BM;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int m_rows = bq * gq;
  const int qh = num_kv * gq;
  const int row = min(max(rows[tile], 0), r1 - 1);
  const int ps = pstart[tile];

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, d = i % D, mg = m0 + r;
    float val = 0.f;
    if (mg < m_rows) {
      const int b = mg / gq, g = mg % gq;
      val = to_float(q[(((size_t)tile * bq + b) * qh + h * gq + g) * D + d]);
    }
    Qs[r * DP + d] = val;
  }
  if (tid < BM) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // causal frontier of this chunk's last real row
  const int m_last = min(m0 + BM, m_rows) - 1;
  const int front = min(max(ps + m_last / gq, 0), s_len - 1);
  const int n_blocks = front / BN + 1;
  const size_t head_base = ((size_t)row * num_kv + h) * (size_t)s_len * D;

  const int tx = tid % 16, ty = tid / 16;
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  __syncthreads();

  for (int nb = 0; nb < n_blocks; ++nb) {
    const int n0 = nb * BN;
    for (int i = tid; i < BN * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR, n = n0 + r;
      float kf[VEC], vf[VEC];
      if (n < s_len) {
        const size_t off = head_base + (size_t)n * D + c * VEC;
        vec_to_float<T>(*reinterpret_cast<const uint4*>(k + off), kf);
        vec_to_float<T>(*reinterpret_cast<const uint4*>(v + off), vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * DP + c * VEC + e] = kf[e];
        Vs[r * D + c * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: rows ty + 16*i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, mg = m0 + r;
      const int qpos = ps + mg / gq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, n = n0 + c;
        const bool live = mg < m_rows && n <= qpos && n < s_len;
        Ss[r * SP + c] = live ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four lanes per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float mx = kNegInf;
      for (int c = part * 16; c < part * 16 + 16; ++c)
        mx = fmaxf(mx, Ss[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part * 16; c < part * 16 + 16; ++c) {
        const float sv = Ss[r * SP + c];
        // masked entries hold exactly kNegInf: re-mask after the exp as
        // the reference does (exp(NEG_INF - NEG_INF) would be 1)
        const float p = sv == kNegInf ? 0.f : expf(sv - m_new);
        Ss[r * SP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? Vs[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, mg = m0 + r;
    if (mg >= m_rows) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    const int b = mg / gq, g = mg % gq;
    T* op = out + (((size_t)tile * bq + b) * qh + h * gq + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) op[d] = from_float<T>(o[i][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* rows, const void* pstart, void* out,
                   int n_tiles, int bq, int num_kv, int gq, int r1, int s_len,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (bq * gq + BM - 1) / BM;
  dim3 grid(n_tiles, num_kv, chunks);
  prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(rows),
      static_cast<const int*>(pstart), static_cast<T*>(out), bq, num_kv, gq,
      r1, s_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* rows, const void* pstart, void* out,
                       int n_tiles, int bq, int num_kv, int gq, int r1,
                       int s_len, float scale, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len, scale, stream);
    case 16: return launch<T, 16>(q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len, scale, stream);
    case 32: return launch<T, 32>(q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len, scale, stream);
    case 64: return launch<T, 64>(q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len, scale, stream);
    case 128: return launch<T, 128>(q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [n_tiles, bq, num_kv*gq, D]; k, v [r1, num_kv, s_len, D]; rows, pstart
// int32[n_tiles]; out [n_tiles, bq, num_kv*gq, D].  dtype: 0 = float32,
// 1 = bfloat16.  All tensors contiguous.
extern "C" int ff_prefill_attention(const void* q, const void* k,
                                    const void* v, const void* rows,
                                    const void* pstart, void* out,
                                    int n_tiles, int bq, int num_kv, int gq,
                                    int r1, int s_len, int head_dim,
                                    float scale, int dtype, void* stream) {
  if (n_tiles == 0 || bq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(head_dim, q, k, v, rows, pstart, out, n_tiles, bq,
                            num_kv, gq, r1, s_len, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(head_dim, q, k, v, rows, pstart, out,
                                    n_tiles, bq, num_kv, gq, r1, s_len, scale,
                                    st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
