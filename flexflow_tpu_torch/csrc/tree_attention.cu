// Two-segment tree attention (SpecInfer's tree verify), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tree_call`
// (flexflow_tpu/ops/pallas/attention.py:675, body `_tree_kernel` :567) on
// its fp, slot-contiguous path, in both of its layouts:
//   * `tree_attention` (:790), one grid row per flat token;
//   * `tree_attention_batched` (:836), one grid row per request whose P
//     tree tokens fold into the query-group dim (b-major: row b*gq + g).
// Each query row attends, in one f32 online softmax, to
//   (a) the committed keys of its cache row at positions < clens (strict),
//   (b) the spec-buffer keys j of the same row for which amask[.., j] holds
//       (no position test: only the tree mask gates them).
// Rows with no live key at all give zeros (denominator clamped at 1e-30,
// masked probabilities forced to 0), as the reference does; the output is
// cast to q's dtype.
//
// What bounds it on the H100: the bytes of the committed K/V prefix (a
// handful of query rows use each key), so it is memory-bound.  What the
// design does about that:
//   * per-token layout: K1's design (decode_attention.cu): one CTA per
//     (token, kv head), lane groups streaming 16-byte K/V vectors, each
//     group with its own softmax state, merged once; the committed clamp is
//     the loop bound, so a pad token (clens 0, empty mask) reads nothing.
//     Tokens of one request each re-stream that request's prefix: this
//     layout moves P times the bytes of the batched one.
//   * batched layout: K2's design (prefill_attention.cu): one CTA per
//     (request, kv head, chunk of folded query rows), 64-key K/V blocks
//     staged in shared memory as f32, so the prefix streams once per
//     request; the spec buffer follows as the last blocks under the mask.
//     The row chunk is 16 rows when the request has at most 16 folded rows
//     (a width-2 depth-3 tree with one query head per KV head has 7), else
//     64, so few rows do not pay for a 64-row tile.
// Not yet done (later work): tensor cores, TMA, int8 and paged committed
// caches.
//
// C interface for ctypes; the kernels allocate nothing and each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // per-token kernel
constexpr int kUnroll = 4;
constexpr int BN = 64;          // keys per shared-memory block (batched)
constexpr int kBThreads = 256;  // batched kernel
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

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// ---------------------------------------------------------------------------
// per-token layout
// ---------------------------------------------------------------------------

// One lane group's online softmax over keys j = grp, grp + GROUPS, ... of
// [0, n_keys) whose mask byte is set (mask == nullptr: all set).  kb/vb
// point at key 0 of the head, offset to this lane's 16-byte vector.  The
// trip count is uniform across the CTA, so every lane reaches the
// shuffles whichever keys are live for its group.
template <typename T, int D, int GQ>
__device__ __forceinline__ void attend_keys(
    const T* __restrict__ kb, const T* __restrict__ vb, int n_keys,
    const uint8_t* __restrict__ mask, int grp, const float (&qv)[GQ][16 / sizeof(T)],
    float scale, float (&m)[GQ], float (&l)[GQ],
    float (&acc)[GQ][16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TPK = D / VEC;
  constexpr int GROUPS = kThreads / TPK;
  const int per_iter = GROUPS * kUnroll;
  const int iters = (n_keys + per_iter - 1) / per_iter;
  for (int it = 0; it < iters; ++it) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (it * kUnroll + u) * GROUPS + grp;
      live[u] = j < n_keys && (mask == nullptr || mask[j] != 0);
      if (live[u]) {
        kr[u] = load16(kb + (size_t)j * D);
        vr[u] = load16(vb + (size_t)j * D);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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
      if (live[u]) {
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
}

template <typename T, int D, int GQ>
__global__ void __launch_bounds__(kThreads)
tree_token_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ sk,
                  const T* __restrict__ sv, const int* __restrict__ rows,
                  const int* __restrict__ clens,
                  const uint8_t* __restrict__ amask, T* __restrict__ out,
                  int num_kv, int r1, int s_len, int p_len, float scale) {
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
  const int n_committed = min(max(clens[t], 0), s_len);

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

  // (a) committed keys [0, clens)
  const size_t head = (size_t)row * num_kv + h;
  attend_keys<T, D, GQ>(k + head * s_len * D + lane * VEC,
                        v + head * s_len * D + lane * VEC, n_committed,
                        nullptr, grp, qv, scale, m, l, acc);
  // (b) spec keys under the token's ancestor mask
  attend_keys<T, D, GQ>(sk + head * p_len * D + lane * VEC,
                        sv + head * p_len * D + lane * VEC, p_len,
                        amask + (size_t)t * p_len, grp, qv, scale, m, l, acc);

  // merge the groups' partial softmax states (a group that saw no live key
  // holds m = kNegInf, l = 0 and weighs 0 unless no group saw one)
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
cudaError_t launch_token(const void* q, const void* k, const void* v,
                         const void* sk, const void* sv, const void* rows,
                         const void* clens, const void* amask, void* out,
                         int n_tokens, int num_kv, int r1, int s_len,
                         int p_len, float scale, cudaStream_t stream) {
  dim3 grid(n_tokens, num_kv);
  tree_token_kernel<T, D, GQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(sk),
      static_cast<const T*>(sv), static_cast<const int*>(rows),
      static_cast<const int*>(clens), static_cast<const uint8_t*>(amask),
      static_cast<T*>(out), num_kv, r1, s_len, p_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t token_gq(int gq, const void* q, const void* k, const void* v,
                     const void* sk, const void* sv, const void* rows,
                     const void* clens, const void* amask, void* out,
                     int n_tokens, int num_kv, int r1, int s_len, int p_len,
                     float scale, cudaStream_t st) {
  switch (gq) {
    case 1: return launch_token<T, D, 1>(q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 2: return launch_token<T, D, 2>(q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 4: return launch_token<T, D, 4>(q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 8: return launch_token<T, D, 8>(q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t token_d(int d, int gq, const void* q, const void* k,
                    const void* v, const void* sk, const void* sv,
                    const void* rows, const void* clens, const void* amask,
                    void* out, int n_tokens, int num_kv, int r1, int s_len,
                    int p_len, float scale, cudaStream_t st) {
  switch (d) {
    case 8: return token_gq<T, 8>(gq, q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 16: return token_gq<T, 16>(gq, q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 32: return token_gq<T, 32>(gq, q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 64: return token_gq<T, 64>(gq, q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    case 128: return token_gq<T, 128>(gq, q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// batched layout
// ---------------------------------------------------------------------------

template <int D, int BM>
constexpr size_t batched_smem_floats() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ss [BM][BN+1], m/l/alpha [BM]
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM;
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(kBThreads)
tree_batched_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ sk,
                    const T* __restrict__ sv, const int* __restrict__ rows,
                    const int* __restrict__ clens,
                    const uint8_t* __restrict__ amask, T* __restrict__ out,
                    int p_tok, int num_kv, int gq, int r1, int s_len,
                    int p_len, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;          // 16-byte vectors per key row
  static_assert(D % VEC == 0, "head dim must fill whole 16-byte vectors");
  constexpr int DP = D + 1;
  constexpr int SP = BN + 1;
  constexpr int DJ = (D + 15) / 16;     // output columns per thread
  constexpr int RM = BM / 16;           // query rows per thread
  constexpr int LPR = kBThreads / BM;   // softmax lanes per row
  constexpr int KPL = BN / LPR;         // keys per softmax lane
  static_assert(BM % 16 == 0 && LPR <= 32 && 32 % LPR == 0,
                "a row's softmax lanes must sit in one warp");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ss = Vs + BN * D;
  float* row_m = Ss + BM * SP;
  float* row_l = row_m + BM;
  float* row_a = row_l + BM;

  const int req = blockIdx.x;
  const int h = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int m_rows = p_tok * gq;
  const int qh = num_kv * gq;
  const int row = min(max(rows[req], 0), r1 - 1);
  const int clen = min(max(clens[req], 0), s_len);

  for (int i = tid; i < BM * D; i += kBThreads) {
    const int r = i / D, d = i % D, mg = m0 + r;
    float val = 0.f;
    if (mg < m_rows) {
      const int b = mg / gq, g = mg % gq;
      val = to_float(q[(((size_t)req * p_tok + b) * qh + h * gq + g) * D + d]);
    }
    Qs[r * DP + d] = val;
  }
  if (tid < BM) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  const int nb_c = (clen + BN - 1) / BN;     // committed blocks
  const int nb_s = (p_len + BN - 1) / BN;    // spec-buffer blocks
  const size_t head = (size_t)row * num_kv + h;
  const T* kc = k + head * s_len * D;
  const T* vc = v + head * s_len * D;
  const T* ks = sk + head * p_len * D;
  const T* vs = sv + head * p_len * D;
  const uint8_t* mrow = amask + (size_t)req * p_tok * p_len;

  const int tx = tid % 16, ty = tid / 16;
  float o[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  __syncthreads();

  for (int nb = 0; nb < nb_c + nb_s; ++nb) {
    const bool spec = nb >= nb_c;
    const int n0 = (spec ? nb - nb_c : nb) * BN;
    const int limit = spec ? p_len : clen;
    const T* kh = spec ? ks : kc;
    const T* vh = spec ? vs : vc;
    for (int i = tid; i < BN * VPR; i += kBThreads) {
      const int r = i / VPR, c = i % VPR, n = n0 + r;
      float kf[VEC], vf[VEC];
      if (n < limit) {
        const size_t off = (size_t)n * D + c * VEC;
        vec_to_float<T>(load16(kh + off), kf);
        vec_to_float<T>(load16(vh + off), vf);
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
    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], kb[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i, mg = m0 + r;
      const int b = mg / gq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, n = n0 + c;
        bool live = mg < m_rows && n < limit;
        if (live && spec) live = mrow[(size_t)b * p_len + n] != 0;
        Ss[r * SP + c] = live ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: LPR lanes per row, KPL keys each
    {
      const int r = tid / LPR, part = tid % LPR;
      float mx = kNegInf;
      for (int c = part * KPL; c < part * KPL + KPL; ++c)
        mx = fmaxf(mx, Ss[r * SP + c]);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part * KPL; c < part * KPL + KPL; ++c) {
        const float sv_ = Ss[r * SP + c];
        // masked entries hold exactly kNegInf: re-mask after the exp as
        // the reference does (exp(NEG_INF - NEG_INF) would be 1)
        const float p = sv_ == kNegInf ? 0.f : expf(sv_ - m_new);
        Ss[r * SP + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[RM], vv[DJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? Vs[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i, mg = m0 + r;
    if (mg >= m_rows) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    const int b = mg / gq, g = mg % gq;
    T* op = out + (((size_t)req * p_tok + b) * qh + h * gq + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) op[d] = from_float<T>(o[i][j] * inv);
    }
  }
}

template <typename T, int D, int BM>
cudaError_t launch_batched(const void* q, const void* k, const void* v,
                           const void* sk, const void* sv, const void* rows,
                           const void* clens, const void* amask, void* out,
                           int n_req, int p_tok, int num_kv, int gq, int r1,
                           int s_len, int p_len, float scale,
                           cudaStream_t stream) {
  const size_t smem = batched_smem_floats<D, BM>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tree_batched_kernel<T, D, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p_tok * gq + BM - 1) / BM;
  dim3 grid(n_req, num_kv, chunks);
  tree_batched_kernel<T, D, BM><<<grid, kBThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(sk),
      static_cast<const T*>(sv), static_cast<const int*>(rows),
      static_cast<const int*>(clens), static_cast<const uint8_t*>(amask),
      static_cast<T*>(out), p_tok, num_kv, gq, r1, s_len, p_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t batched_bm(const void* q, const void* k, const void* v,
                       const void* sk, const void* sv, const void* rows,
                       const void* clens, const void* amask, void* out,
                       int n_req, int p_tok, int num_kv, int gq, int r1,
                       int s_len, int p_len, float scale, cudaStream_t st) {
  if (p_tok * gq <= 16)
    return launch_batched<T, D, 16>(q, k, v, sk, sv, rows, clens, amask, out,
                                    n_req, p_tok, num_kv, gq, r1, s_len,
                                    p_len, scale, st);
  return launch_batched<T, D, 64>(q, k, v, sk, sv, rows, clens, amask, out,
                                  n_req, p_tok, num_kv, gq, r1, s_len, p_len,
                                  scale, st);
}

template <typename T>
cudaError_t batched_d(int d, const void* q, const void* k, const void* v,
                      const void* sk, const void* sv, const void* rows,
                      const void* clens, const void* amask, void* out,
                      int n_req, int p_tok, int num_kv, int gq, int r1,
                      int s_len, int p_len, float scale, cudaStream_t st) {
  switch (d) {
    case 8: return batched_bm<T, 8>(q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale, st);
    case 16: return batched_bm<T, 16>(q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale, st);
    case 32: return batched_bm<T, 32>(q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale, st);
    case 64: return batched_bm<T, 64>(q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale, st);
    case 128: return batched_bm<T, 128>(q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Per-token layout.  q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len, D];
// sk, sv [r1, num_kv, p_len, D]; rows, clens int32[n_tokens]; amask
// bool[n_tokens, p_len]; out like q.  dtype: 0 = float32, 1 = bfloat16.
// All tensors contiguous.
extern "C" int ff_tree_attention(const void* q, const void* k, const void* v,
                                 const void* sk, const void* sv,
                                 const void* rows, const void* clens,
                                 const void* amask, void* out, int n_tokens,
                                 int num_kv, int gq, int r1, int s_len,
                                 int p_len, int head_dim, float scale,
                                 int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = token_d<float>(head_dim, gq, q, k, v, sk, sv, rows, clens, amask,
                         out, n_tokens, num_kv, r1, s_len, p_len, scale, st);
  else if (dtype == 1)
    err = token_d<__nv_bfloat16>(head_dim, gq, q, k, v, sk, sv, rows, clens,
                                 amask, out, n_tokens, num_kv, r1, s_len,
                                 p_len, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Batched layout.  q [n_req, p_tok, num_kv*gq, D]; k, v, sk, sv as above;
// rows, clens int32[n_req]; amask bool[n_req, p_tok, p_len]; out like q.
extern "C" int ff_tree_attention_batched(
    const void* q, const void* k, const void* v, const void* sk,
    const void* sv, const void* rows, const void* clens, const void* amask,
    void* out, int n_req, int p_tok, int num_kv, int gq, int r1, int s_len,
    int p_len, int head_dim, float scale, int dtype, void* stream) {
  if (n_req == 0 || p_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = batched_d<float>(head_dim, q, k, v, sk, sv, rows, clens, amask, out,
                           n_req, p_tok, num_kv, gq, r1, s_len, p_len, scale,
                           st);
  else if (dtype == 1)
    err = batched_d<__nv_bfloat16>(head_dim, q, k, v, sk, sv, rows, clens,
                                   amask, out, n_req, p_tok, num_kv, gq, r1,
                                   s_len, p_len, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
