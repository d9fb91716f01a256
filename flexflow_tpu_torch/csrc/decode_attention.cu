// KV-cached decode attention over flat tokens, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention`
// (flexflow_tpu/ops/pallas/attention.py:209, body `_decode_kernel` :120) on
// its fp, slot-contiguous, no-ALiBi path.  For every flat token t and every
// KV head h it computes the GQA attention of the token's `gq` query heads of
// that group over cache row rows[t], keys at positions <= pos[t]:
// online softmax in f32, output cast to q's dtype, denominator clamped at
// 1e-30 as the reference does.
//
// What bounds it on the H100: the bytes of K and V it must read (each key
// row is used by gq query rows only: about gq FMAs per byte), so it is
// memory-bound.  What the design does about that:
//   * one CTA per (token, kv head); the causal clamp is the loop bound, so
//     no byte beyond pos[t] is fetched (pad tokens, pos 0 on the scratch
//     row, read one key);
//   * K and V are read as 16-byte vectors, neighbouring thread groups on
//     neighbouring keys, 4 keys in flight per group before any arithmetic;
//   * each group of D/VEC threads keeps its own online-softmax state for
//     the keys it streams, and the groups are merged once at the end, so
//     the key loop has no __syncthreads.
// Not yet done (later work): split-KV (flash-decoding) for long rows with
// few tokens, TMA, int8/paged/ALiBi variants.
//
// C interface for ctypes; the kernel allocates nothing and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
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

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T, int D, int GQ>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ rows,
              const int* __restrict__ pos, T* __restrict__ out, int num_kv,
              int r1, int s_len, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int TPK = D / VEC;          // threads per key row
  static_assert(D % VEC == 0, "head dim must fill whole 16-byte vectors");
  static_assert(TPK >= 1 && TPK <= 32 && 32 % TPK == 0,
                "a key row must be read by a power-of-two lane group");
  constexpr int GROUPS = kThreads / TPK;

  __shared__ float sm_m[GROUPS][GQ];
  __shared__ float sm_l[GROUPS][GQ];
  __shared__ float sm_acc[GROUPS][GQ][D];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int grp = tid / TPK;
  const int lane = tid % TPK;
  const int qh = num_kv * GQ;
  const int row = min(max(rows[t], 0), r1 - 1);
  const int n_keys = min(max(pos[t], 0), s_len - 1) + 1;

  float qv[GQ][VEC];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const T* qp = q + ((size_t)t * qh + h * GQ + g) * D + lane * VEC;
    vec_to_float<T>(load16(qp), qv[g]);
  }
  float m[GQ], l[GQ], acc[GQ][VEC];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t head_base = ((size_t)row * num_kv + h) * (size_t)s_len * D;
  const T* kb = k + head_base + lane * VEC;
  const T* vb = v + head_base + lane * VEC;
  const int per_iter = GROUPS * kUnroll;
  // the trip count is uniform across the CTA: every lane of a warp reaches
  // the shuffles below, whichever keys are valid for its group
  const int iters = (n_keys + per_iter - 1) / per_iter;
  for (int it = 0; it < iters; ++it) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (it * kUnroll + u) * GROUPS + grp;
      if (j < n_keys) {
        kr[u] = load16(kb + (size_t)j * D);
        vr[u] = load16(vb + (size_t)j * D);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (it * kUnroll + u) * GROUPS + grp;
      float kf[VEC];
      vec_to_float<T>(kr[u], kf);
      float s[GQ];
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qv[g][e], kf[e], part);
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[g] = part * scale;
      }
      if (j < n_keys) {
        float vf[VEC];
        vec_to_float<T>(vr[u], vf);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the groups' partial softmax states
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    if (lane == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[grp][g][lane * VEC + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < GQ * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
    for (int gr = 0; gr < GROUPS; ++gr) mx = fmaxf(mx, sm_m[gr][g]);
    float lsum = 0.f, o = 0.f;
    for (int gr = 0; gr < GROUPS; ++gr) {
      const float w = expf(sm_m[gr][g] - mx);
      lsum = fmaf(sm_l[gr][g], w, lsum);
      o = fmaf(sm_acc[gr][g][d], w, o);
    }
    out[((size_t)t * qh + h * GQ + g) * D + d] =
        from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int GQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* rows, const void* pos, void* out, int n_tokens,
                   int num_kv, int r1, int s_len, float scale,
                   cudaStream_t stream) {
  dim3 grid(n_tokens, num_kv);
  decode_kernel<T, D, GQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(rows),
      static_cast<const int*>(pos), static_cast<T*>(out), num_kv, r1, s_len,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_gq(int gq, const void* q, const void* k, const void* v,
                        const void* rows, const void* pos, void* out,
                        int n_tokens, int num_kv, int r1, int s_len,
                        float scale, cudaStream_t stream) {
  switch (gq) {
    case 1: return launch<T, D, 1>(q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 2: return launch<T, D, 2>(q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 4: return launch<T, D, 4>(q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 8: return launch<T, D, 8>(q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int d, int gq, const void* q, const void* k,
                       const void* v, const void* rows, const void* pos,
                       void* out, int n_tokens, int num_kv, int r1, int s_len,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 8: return dispatch_gq<T, 8>(gq, q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 16: return dispatch_gq<T, 16>(gq, q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 32: return dispatch_gq<T, 32>(gq, q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 64: return dispatch_gq<T, 64>(gq, q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    case 128: return dispatch_gq<T, 128>(gq, q, k, v, rows, pos, out, n_tokens, num_kv, r1, s_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len, D]; rows, pos
// int32[n_tokens]; out [n_tokens, num_kv*gq, D].  dtype: 0 = float32,
// 1 = bfloat16.  All tensors contiguous.
extern "C" int ff_decode_attention(const void* q, const void* k,
                                   const void* v, const void* rows,
                                   const void* pos, void* out, int n_tokens,
                                   int num_kv, int gq, int r1, int s_len,
                                   int head_dim, float scale, int dtype,
                                   void* stream) {
  if (n_tokens == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(head_dim, gq, q, k, v, rows, pos, out, n_tokens,
                            num_kv, r1, s_len, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(head_dim, gq, q, k, v, rows, pos, out,
                                    n_tokens, num_kv, r1, s_len, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
