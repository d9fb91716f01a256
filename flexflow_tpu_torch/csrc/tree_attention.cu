// Two-segment tree attention (SpecInfer's tree verify), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tree_call`
// (flexflow_tpu/ops/pallas/attention.py:675, body `_tree_kernel` :567) in
// both of its layouts:
//   * `tree_attention` (:790), one grid row per flat token;
//   * `tree_attention_batched` (:836), one grid row per request whose P
//     tree tokens fold into the query-group dim (b-major: row b*gq + g).
// Each query row attends, in one f32 online softmax, to
//   (a) the committed keys of its cache row at positions < clens (strict),
//   (b) the spec-buffer keys j of the same row for which amask[.., j] holds
//       (no position test: only the tree mask gates them).
// Rows with no live key at all give zeros (denominator clamped at 1e-30,
// masked probabilities forced to 0), as the reference does; the output is
// cast to q's dtype.  The committed cache may be int8 (`k_scale/v_scale`,
// dequantized in the Pallas kernel's order: score = (q . k_i8) * scale *
// ks[key], the denominator takes the unscaled p, P.V takes p * vs[key])
// and may be paged (`page_table`, :699-711); the spec buffer stays in the
// compute dtype and slot-contiguous, as in the reference.
//
// What bounds it on the H100: the bytes of the committed K/V prefix (a
// handful of query rows use each key), so it is memory-bound.  What the
// design does about that:
//   * per-token layout: K1's design (decode_attention.cu): one CTA per
//     (token, kv head), lane groups streaming 16-byte K/V vectors, each
//     group with its own softmax state, merged once; the committed clamp is
//     the loop bound, so a pad token (clens 0, empty mask) reads nothing.
//     Tokens of one request each re-stream that request's prefix: this
//     layout moves P times the bytes of the batched one.  With an int8
//     cache a lane holds K1's int8 vector width, and the spec keys are read
//     at that width in the compute dtype (several 16-byte loads per key),
//     so both segments share one lane layout and one softmax state;
//   * batched layout: K2's design (prefill_attention.cu): one CTA per
//     (request, kv head, chunk of folded query rows), 64-key K/V blocks
//     staged in shared memory as f32 (an int8 block with its 64 scales),
//     so the prefix streams once per request; the spec buffer follows as
//     the last blocks under the mask.  The row chunk is 16 rows when the
//     request has at most 16 folded rows (a width-2 depth-3 tree with one
//     query head per KV head has 7), else 64, so few rows do not pay for a
//     64-row tile;
//   * paged: per-token threads translate a page once and reuse it; a
//     batched block sits inside one page (the wrapper requires pages of
//     whole 64-key blocks) and translates once.  Keys are visited in the
//     contiguous layout's order, so the two give identical bits.
// Not yet done (later work): tensor cores, TMA.
//
// C interface for ctypes; the kernels allocate nothing and each entry point
// returns cudaGetLastError() after its launch.

#include "kv_access.cuh"

namespace {

using namespace ffk;

constexpr int kThreads = 128;   // per-token kernel
constexpr int kUnroll = 4;
constexpr int BN = 64;          // keys per shared-memory block (batched)
constexpr int kBThreads = 256;  // batched kernel

// ---------------------------------------------------------------------------
// per-token layout
// ---------------------------------------------------------------------------

// One lane group's online softmax over keys j = grp, grp + GROUPS, ... of
// [0, n_keys) whose mask byte is set (mask == nullptr: all set).  kb/vb
// point at key row 0 of the rows `keys` addresses (offset to this lane's
// vector), ksb/vsb at its scale (int8 only).  The trip count is uniform
// across the CTA, so every lane reaches the shuffles whichever keys are
// live for its group.
template <typename KT, int VEC, int D, int GQ, int UNROLL, bool KVQ,
          bool PAGED>
__device__ __forceinline__ void attend_keys(
    const KT* __restrict__ kb, const KT* __restrict__ vb,
    const float* __restrict__ ksb, const float* __restrict__ vsb,
    KeyRows<PAGED>& keys, int n_keys, const uint8_t* __restrict__ mask,
    int grp, const float (&qv)[GQ][VEC], float scale, float (&m)[GQ],
    float (&l)[GQ], float (&acc)[GQ][VEC]) {
  constexpr int TPK = D / VEC;
  constexpr int GROUPS = kThreads / TPK;
  const int per_iter = GROUPS * UNROLL;
  const int iters = (n_keys + per_iter - 1) / per_iter;
  for (int it = 0; it < iters; ++it) {
    Vec<KT, VEC> kr[UNROLL], vr[UNROLL];
    float ksr[UNROLL], vsr[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = (it * UNROLL + u) * GROUPS + grp;
      live[u] = j < n_keys && (mask == nullptr || mask[j] != 0);
      if (live[u]) {
        const size_t key = keys.key(j);
        kr[u].load(kb + key * D);
        vr[u].load(vb + key * D);
        if constexpr (KVQ) {
          ksr[u] = ksb[key];
          vsr[u] = vsb[key];
        }
      } else {
        kr[u].zero();
        vr[u].zero();
        if constexpr (KVQ) ksr[u] = vsr[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[VEC];
      kr[u].to_float(kf);
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
        if constexpr (KVQ) s[g] *= ksr[u];
      }
      if (live[u]) {
        float vf[VEC];
        vr[u].to_float(vf);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
          const float pv = KVQ ? p * vsr[u] : p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(pv, vf[e], acc[g][e] * alpha);
          m[g] = m_new;
        }
      }
    }
  }
}

template <typename T, typename KT, int D, int GQ, bool PAGED>
__global__ void __launch_bounds__(kThreads)
tree_token_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const T* __restrict__ sk, const T* __restrict__ sv,
                  const int* __restrict__ rows,
                  const int* __restrict__ clens,
                  const uint8_t* __restrict__ amask, T* __restrict__ out,
                  int num_kv, int r1, int s_len, int p_len, int page,
                  float scale) {
  constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  constexpr int VEC = kv_vec<T, KT, D, GQ>();   // elements per lane
  constexpr int TPK = D / VEC;                  // threads per key row
  static_assert(D % VEC == 0, "head dim must fill whole vectors");
  static_assert(TPK >= 1 && TPK <= 32 && 32 % TPK == 0,
                "a key row must be read by a power-of-two lane group");
  constexpr int GROUPS = kThreads / TPK;
  // spec keys at the committed segment's lane width: several 16-byte
  // loads each when that is wider than one vector of T, one key in flight
  constexpr int SPEC_UNROLL = Vec<T, VEC>::WORDS > 1 ? 1 : kUnroll;

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
    Vec<T, VEC> qr;
    qr.load(q + ((size_t)t * qh + h * GQ + g) * D + lane * VEC);
    qr.to_float(qv[g]);
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
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  attend_keys<KT, VEC, D, GQ, kUnroll, KVQ, PAGED>(
      k + head_base * D + lane * VEC, v + head_base * D + lane * VEC,
      KVQ ? ks + head_base : nullptr, KVQ ? vs + head_base : nullptr, keys,
      n_committed, nullptr, grp, qv, scale, m, l, acc);
  // (b) spec keys under the token's ancestor mask (compute dtype,
  // slot-contiguous)
  const size_t head = (size_t)row * num_kv + h;
  KeyRows<false> spec_keys(nullptr, row, num_kv, h, p_len, 0);
  attend_keys<T, VEC, D, GQ, SPEC_UNROLL, false, false>(
      sk + head * p_len * D + lane * VEC, sv + head * p_len * D + lane * VEC,
      nullptr, nullptr, spec_keys, p_len, amask + (size_t)t * p_len, grp, qv,
      scale, m, l, acc);

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

// ---------------------------------------------------------------------------
// batched layout
// ---------------------------------------------------------------------------

template <int D, int BM, bool KVQ>
constexpr size_t batched_smem_floats() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ss [BM][BN+1], m/l/alpha [BM],
  // and for an int8 cache the block's K and V scales [BN] each
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM + (KVQ ? 2 * BN : 0);
}

// Stage keys [n0, n0 + BN) of one segment into Ks/Vs as f32, rows at and
// past `limit` as zeros; k_rows/v_rows point at key row 0 of the block.
template <typename E, int VEC, int D>
__device__ __forceinline__ void stage_block(const E* __restrict__ kbk,
                                            const E* __restrict__ vbk,
                                            int n0, int limit, int tid,
                                            float* Ks, float* Vs) {
  constexpr int VPR = D / VEC;
  constexpr int DP = D + 1;
  for (int i = tid; i < BN * VPR; i += kBThreads) {
    const int r = i / VPR, c = i % VPR, n = n0 + r;
    float kf[VEC], vf[VEC];
    if (n < limit) {
      const size_t off = (size_t)r * D + c * VEC;
      Vec<E, VEC> kr, vr;
      kr.load(kbk + off);
      vr.load(vbk + off);
      kr.to_float(kf);
      vr.to_float(vf);
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
}

template <typename T, typename KT, int D, int BM, bool PAGED>
__global__ void __launch_bounds__(kBThreads)
tree_batched_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table, const T* __restrict__ sk,
                    const T* __restrict__ sv, const int* __restrict__ rows,
                    const int* __restrict__ clens,
                    const uint8_t* __restrict__ amask, T* __restrict__ out,
                    int p_tok, int num_kv, int gq, int r1, int s_len,
                    int p_len, int page, float scale) {
  constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  // elements per staged vector: 16 bytes (an int8 row of D = 8: 8 bytes)
  constexpr int VEC_T = 16 / sizeof(T);
  constexpr int VEC_K = KVQ ? (D >= 16 ? 16 : 8) : VEC_T;
  static_assert(D % VEC_T == 0 && D % VEC_K == 0,
                "head dim must fill whole vectors");
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
  float* Ksc = row_a + BM;              // int8 only: [BN] K scales
  float* Vsc = Ksc + BN;                // int8 only: [BN] V scales

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
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  const size_t head = (size_t)row * num_kv + h;
  const T* ksp = sk + head * p_len * D;
  const T* vsp = sv + head * p_len * D;
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
    if (spec) {
      stage_block<T, VEC_T, D>(ksp + (size_t)n0 * D, vsp + (size_t)n0 * D,
                               n0, limit, tid, Ks, Vs);
      if constexpr (KVQ) {
        if (tid < BN) Ksc[tid] = Vsc[tid] = 1.f;
      }
    } else {
      // key rows of this block: contiguous from here (a block never
      // straddles a page)
      const size_t kb0 = head_base + keys.key(n0);
      stage_block<KT, VEC_K, D>(k + kb0 * D, v + kb0 * D, n0, limit, tid,
                                Ks, Vs);
      if constexpr (KVQ) {
        if (tid < BN) {
          const bool in = n0 + tid < limit;
          Ksc[tid] = in ? ks[kb0 + tid] : 0.f;
          Vsc[tid] = in ? vs[kb0 + tid] : 0.f;
        }
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
        float sc = s[i][j] * scale;
        if constexpr (KVQ) sc *= Ksc[c];
        Ss[r * SP + c] = live ? sc : kNegInf;
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
        // the denominator sums the unscaled p; P.V takes p * vs
        Ss[r * SP + c] = KVQ ? p * Vsc[c] : p;
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

template <typename T, typename KT, int D, int BM, bool PAGED>
cudaError_t launch_batched(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* table,
                           const void* sk, const void* sv, const void* rows,
                           const void* clens, const void* amask, void* out,
                           int n_req, int p_tok, int num_kv, int gq, int r1,
                           int s_len, int p_len, int page, float scale,
                           cudaStream_t stream) {
  constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  const size_t smem = batched_smem_floats<D, BM, KVQ>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tree_batched_kernel<T, KT, D, BM, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p_tok * gq + BM - 1) / BM;
  tree_batched_kernel<T, KT, D, BM, PAGED>
      <<<dim3(n_req, num_kv, chunks), kBThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const KT*>(k),
          static_cast<const KT*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const T*>(sk), static_cast<const T*>(sv),
          static_cast<const int*>(rows), static_cast<const int*>(clens),
          static_cast<const uint8_t*>(amask), static_cast<T*>(out), p_tok,
          num_kv, gq, r1, s_len, p_len, page, scale);
  return cudaGetLastError();
}

}  // namespace

// Per-token layout.  q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len,
// D] in q's dtype, or int8 with k_scale, v_scale f32 [r1, num_kv, s_len]
// (null: fp cache); table int32 [r1, s_len / page_size] (null:
// slot-contiguous); sk, sv [r1, num_kv, p_len, D] in q's dtype; rows, clens
// int32[n_tokens]; amask bool[n_tokens, p_len]; out like q.  dtype:
// 0 = float32, 1 = bfloat16.  All tensors contiguous.
extern "C" int ff_tree_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* sk, const void* sv,
    const void* rows, const void* clens, const void* amask, void* out,
    int n_tokens, int num_kv, int gq, int r1, int s_len, int p_len,
    int head_dim, int page_size, float scale, int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_head_dim(head_dim, [&](auto dd) {
      return with_group(gq, [&](auto gg) {
        return with_variant(k_scale != nullptr, table != nullptr,
                            [&](auto qq, auto pp) {
          constexpr int D = decltype(dd)::value;
          constexpr int GQ = decltype(gg)::value;
          constexpr bool PAGED = decltype(pp)::value;
          using KT = std::conditional_t<decltype(qq)::value, int8_t, T>;
          tree_token_kernel<T, KT, D, GQ, PAGED>
              <<<dim3(n_tokens, num_kv), kThreads, 0, st>>>(
                  static_cast<const T*>(q), static_cast<const KT*>(k),
                  static_cast<const KT*>(v),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(table), static_cast<const T*>(sk),
                  static_cast<const T*>(sv), static_cast<const int*>(rows),
                  static_cast<const int*>(clens),
                  static_cast<const uint8_t*>(amask), static_cast<T*>(out),
                  num_kv, r1, s_len, p_len, page_size, scale);
          return cudaGetLastError();
        });
      });
    });
  });
  return static_cast<int>(err);
}

// Batched layout.  q [n_req, p_tok, num_kv*gq, D]; k, v, k_scale, v_scale,
// table, sk, sv as above (a paged table: page_size a multiple of 64
// dividing s_len); rows, clens int32[n_req]; amask bool[n_req, p_tok,
// p_len]; out like q.
extern "C" int ff_tree_attention_batched(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* sk, const void* sv,
    const void* rows, const void* clens, const void* amask, void* out,
    int n_req, int p_tok, int num_kv, int gq, int r1, int s_len, int p_len,
    int head_dim, int page_size, float scale, int dtype, void* stream) {
  if (n_req == 0 || p_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_head_dim(head_dim, [&](auto dd) {
      return with_variant(k_scale != nullptr, table != nullptr,
                          [&](auto qq, auto pp) {
        constexpr int D = decltype(dd)::value;
        constexpr bool PAGED = decltype(pp)::value;
        using KT = std::conditional_t<decltype(qq)::value, int8_t, T>;
        if (p_tok * gq <= 16)
          return launch_batched<T, KT, D, 16, PAGED>(
              q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
              out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, page_size,
              scale, st);
        return launch_batched<T, KT, D, 64, PAGED>(
            q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
            out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, page_size,
            scale, st);
      });
    });
  });
  return static_cast<int>(err);
}
