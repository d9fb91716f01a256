// KV-cached decode attention over flat tokens, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention`
// (flexflow_tpu/ops/pallas/attention.py:209, body `_decode_kernel` :120)
// in all its variants: fp or int8 caches (`k_scale/v_scale`,
// `_scale_plumbing` :98), slot-contiguous or paged (`page_table`,
// `_page_coords` :88), with or without ALiBi (`slopes`, :171-173), and any
// number of query heads per KV head.  For every flat token t and every KV
// head h it computes the GQA attention of the token's `gq` query heads of
// that group over cache row rows[t], keys at positions <= pos[t]: online
// softmax in f32, output cast to q's dtype, denominator clamped at 1e-30 as
// the reference does.  An int8 cache is dequantized in the Pallas kernel's
// order (:164-193): score = (q . k_i8) * scale * ks[key]; the denominator
// takes the unscaled p; the accumulator takes p * vs[key] * v_i8.  ALiBi
// adds slope[h, g] * (key_pos - pos[t]) to that score in f32 before the
// causal mask, as :171-174 do; `slopes == nullptr` means no ALiBi (a
// branch uniform across the CTA, not a template flag, so the build does
// not double).
//
// What bounds it on the H100: the bytes of K and V it must read (each key
// row is used by the gq query rows of its group, and by every token of a
// row: a decode step's 8 requests each read their prefix once), so it is
// memory-bound.  What the design does about that:
//   * bfloat16 (row_tiles.cuh: decode_plan_kernel, decode_split_kernel):
//     the flat tokens are grouped by cache row on the device and each
//     row's folded (token, query head) rows cut into chunks of up to 64,
//     so one pass over a block of K/V serves every token and query head of
//     the chunk as a [rows, D] x [D, 64] tensor-core product (a group of
//     48 query heads reads its prefix once per split, 71 heads twice; an
//     ALiBi prefill of 512 tokens of one request reads it once per 64
//     tokens, each chunk only up to its last position).  Split-KV: the
//     prefix is cut into the splits of tree_split_plan(S), one CTA each,
//     so a deep row spreads over up to S / 256 CTAs; a row that stays in
//     one split is written by it, the others merged by the last split CTA
//     of their chunk to finish.  Q fragments come straight from global
//     memory, so with a two-stage cp.async ring three CTAs fit an SM (one
//     warp computes a decode chunk: resident CTAs bound the blocks in
//     flight).  Pad tokens (pos 0 on the scratch row) share one chunk
//     group reading one key;
//   * float32 (decode_kernel): f32 keeps the CUDA-core design (its
//     redesign as error-compensated TF32 on the tensor cores, as K2's, is
//     later work): one CTA per (token, kv head, chunk of
//     query heads); the causal clamp is the loop bound, so no byte beyond
//     pos[t] is fetched; the query heads of a group are processed GQ at a
//     time, GQ in {1, 2, 4, 8} a template parameter that sizes registers
//     and shared memory: a group of up to 8 heads is one chunk (GQ the next
//     power of two, the heads past gq masked), a larger group spreads over
//     ceil(gq / 8) chunks along the grid's z axis, each re-reading its KV
//     head's keys (from L2 under multi-query attention);
//     K and V are read as 16-byte vectors (an int8 cache: 16 values per
//     load, 8 with more than 2 query heads per chunk or D = 8),
//     neighbouring thread groups on neighbouring keys, 4 keys in flight per
//     group before any arithmetic, converted to f32 in registers; each
//     group of D/VEC threads keeps its own online-softmax state for the
//     keys it streams, and the groups are merged once at the end, so the
//     key loop has no __syncthreads;
//   * paged: a block (bf16) or a thread's run of keys (f32) translates its
//     page through the table once; keys are visited in the same order and
//     cut at the same split boundaries as in the contiguous layout, so the
//     two give identical bits.
// Not yet done (later work): TMA with mbarriers in place of cp.async; a
// persistent schedule that skips the empty (split, chunk) CTAs instead of
// launching them; reusing one step's row plan across its layers.
//
// C interface for ctypes; the kernels allocate nothing and the entry point
// returns the first launch error.

#include "kv_access.cuh"
#include "row_tiles.cuh"

namespace {

using namespace ffk;

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

// GQ query heads of one KV head per CTA: heads g0 .. g0 + GQ - 1 of the
// group, g0 = blockIdx.z * GQ, those at or past gq masked
template <typename T, typename KT, int D, int GQ, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ table,
              const float* __restrict__ slopes, const int* __restrict__ rows,
              const int* __restrict__ pos, T* __restrict__ out, int num_kv,
              int gq, int r1, int s_len, int page, float scale) {
  constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  constexpr int VEC = kv_vec<T, KT, D, GQ>();   // elements per lane
  constexpr int TPK = D / VEC;                  // threads per key row
  static_assert(D % VEC == 0, "head dim must fill whole vectors");
  static_assert(TPK >= 1 && TPK <= 32 && 32 % TPK == 0,
                "a key row must be read by a power-of-two lane group");
  constexpr int GROUPS = kThreads / TPK;

  __shared__ float sm_m[GROUPS][GQ];
  __shared__ float sm_l[GROUPS][GQ];
  __shared__ float sm_acc[GROUPS][GQ][D];

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * GQ;
  const int tid = threadIdx.x;
  const int grp = tid / TPK;
  const int lane = tid % TPK;
  const int qh = num_kv * gq;
  const int row = min(max(rows[t], 0), r1 - 1);
  const int p_t = pos[t];
  const int n_keys = min(max(p_t, 0), s_len - 1) + 1;
  const bool alibi = slopes != nullptr;   // uniform across the CTA

  float qv[GQ][VEC], sl[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const bool live = g0 + g < gq;
    if (live) {
      Vec<T, VEC> qr;
      qr.load(q + ((size_t)t * qh + h * gq + g0 + g) * D + lane * VEC);
      qr.to_float(qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] = 0.f;
    }
    sl[g] = alibi && live ? slopes[h * gq + g0 + g] : 0.f;
  }
  float m[GQ], l[GQ], acc[GQ][VEC];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  const KT* kb = k + head_base * D + lane * VEC;
  const KT* vb = v + head_base * D + lane * VEC;
  const float* ksb = KVQ ? ks + head_base : nullptr;
  const float* vsb = KVQ ? vs + head_base : nullptr;
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  const int per_iter = GROUPS * kUnroll;
  // the trip count is uniform across the CTA: every lane of a warp reaches
  // the shuffles below, whichever keys are valid for its group
  const int iters = (n_keys + per_iter - 1) / per_iter;
  for (int it = 0; it < iters; ++it) {
    Vec<KT, VEC> kr[kUnroll], vr[kUnroll];
    float ksr[kUnroll], vsr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (it * kUnroll + u) * GROUPS + grp;
      if (j < n_keys) {
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
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (it * kUnroll + u) * GROUPS + grp;
      float kf[VEC];
      kr[u].to_float(kf);
      const float rel = static_cast<float>(j - p_t);   // key_pos - pos
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
        if (alibi) s[g] += sl[g] * rel;
      }
      if (j < n_keys) {
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
  const int live = min(GQ, gq - g0);
  for (int idx = tid; idx < live * D; idx += kThreads) {
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
    out[((size_t)t * qh + h * gq + g0 + g) * D + d] =
        from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

// bfloat16: the row-grouped split-KV kernels (row_tiles.cuh)
__global__ void __launch_bounds__(32 * rt::kPlanWarps)
decode_plan_kernel(rt::Args a) {
  extern __shared__ int rt_counts[];
  rt::plan_body<false>(a, rt_counts);
}

template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(
    rt::kThreads, (rt::Tiles<KT, D, false>::kMinCtas))
decode_split_kernel(rt::Args a) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  rt::split_body<KT, D, PAGED, false>(a, rt_smem);
}

// the chunk width for a group of gq query heads: the next power of two up
// to 8; larger groups take chunks of 8
template <typename F>
cudaError_t with_chunk(int gq, F&& f) {
  if (gq <= 0) return cudaErrorInvalidValue;
  if (gq == 1) return f(Int<1>{});
  if (gq == 2) return f(Int<2>{});
  if (gq <= 4) return f(Int<4>{});
  return f(Int<8>{});
}

}  // namespace

// q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len, D] in q's dtype, or
// int8 with k_scale, v_scale f32 [r1, num_kv, s_len] (null: fp cache);
// table int32 [r1, s_len / page_size] (null: slot-contiguous); slopes f32
// [num_kv*gq] (null: no ALiBi); rows, pos int32[n_tokens]; out
// [n_tokens, num_kv*gq, D].  dtype: 0 = float32, 1 = bfloat16.  bfloat16
// also takes scratch f32 [n_split * n_tokens * num_kv*gq * (D + 2)], plan
// int32 [round_up(2 * n_tokens, 4) + (4 + num_kv) * cap] with cap =
// ceil(n_tokens * gq / 64) + r1, and the split plan (n_split splits of
// split_blocks 64-key blocks covering s_len); float32 ignores them.  All
// tensors contiguous.
extern "C" int ff_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* slopes,
    const void* rows, const void* pos, void* scratch, void* plan, void* out,
    int n_tokens, int num_kv, int gq, int r1, int s_len, int head_dim,
    int page_size, int n_split, int split_blocks, int cap, float scale,
    int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_head_dim(head_dim, [&](auto dd) {
      constexpr int D = decltype(dd)::value;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (scratch == nullptr || plan == nullptr || n_split < 1 ||
            split_blocks < 1 || cap < 1)
          return cudaErrorInvalidValue;
        const rt::Args a{
            static_cast<const T*>(q), k, v,
            static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(table),
            static_cast<const float*>(slopes), nullptr, nullptr, nullptr,
            static_cast<const int*>(rows), static_cast<const int*>(pos),
            static_cast<int*>(plan), static_cast<float*>(scratch),
            static_cast<T*>(out), n_tokens, num_kv, gq, r1, s_len, 0,
            page_size, n_split, split_blocks, cap, scale};
        return with_variant(k_scale != nullptr, table != nullptr,
                            [&](auto qq, auto pp) {
          constexpr bool PAGED = decltype(pp)::value;
          using KT = std::conditional_t<decltype(qq)::value, int8_t, T>;
          return rt::launch<decode_plan_kernel,
                            decode_split_kernel<KT, D, PAGED>, KT, D,
                            false>(a, st);
        });
      } else {
        return with_chunk(gq, [&](auto gg) {
          return with_variant(k_scale != nullptr, table != nullptr,
                              [&](auto qq, auto pp) {
            constexpr int GQ = decltype(gg)::value;
            constexpr bool PAGED = decltype(pp)::value;
            using KT = std::conditional_t<decltype(qq)::value, int8_t, T>;
            const int chunks = (gq + GQ - 1) / GQ;
            decode_kernel<T, KT, D, GQ, PAGED>
                <<<dim3(n_tokens, num_kv, chunks), kThreads, 0, st>>>(
                    static_cast<const T*>(q), static_cast<const KT*>(k),
                    static_cast<const KT*>(v),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(table),
                    static_cast<const float*>(slopes),
                    static_cast<const int*>(rows),
                    static_cast<const int*>(pos), static_cast<T*>(out),
                    num_kv, gq, r1, s_len, page_size, scale);
            return cudaGetLastError();
          });
        });
      }
    });
  });
  return static_cast<int>(err);
}
