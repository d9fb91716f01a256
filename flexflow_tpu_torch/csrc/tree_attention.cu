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
// handful of query rows use each key), so it is memory-bound.  At the
// Llama-2-7B verify shape (8 requests of a 7-token tree, committed lengths
// 256-1800, 32 heads, D 128) the batched layout must move 134.7 MB, 0.041
// ms at 3.35 TB/s.  What the design does about that:
//   * per-token layout (row_tiles.cuh: tree_token_plan_kernel, then
//     tree_token_split_kernel in bf16, tree_token_split_tf32_kernel in
//     float32): K1's design (decode_attention.cu).  The flat tokens are
//     grouped by cache row on the device, so a request's tree tokens (and
//     pads, on the scratch row) share chunks of folded rows (bf16 up to 64
//     on bf16 tiles; f32 16 on error-compensated TF32 tiles, four warps
//     each on one 8-key column tile of every 32-key block) and its
//     committed prefix streams once per split, as in the batched layout,
//     where each token once re-streamed it; any number of query heads per
//     KV head folds into the chunks; the plan's last split also takes the
//     spec segment under each token's mask; the last split CTA of a chunk
//     to finish merges its rows' partials; rows with no live key (pads:
//     clens 0, empty mask) give zeros;
//   * batched layout, bf16 (tree_split_kernel + tree_merge_kernel):
//     split-KV.  One request's committed prefix streams once, cut into
//     splits of `split_blocks` 64-key blocks (the wrapper's plan), one CTA
//     per (split, kv head, request, chunk of folded rows), so the 8 x 32
//     (request, head) pairs of the serve shape spread over ~1150 CTAs in
//     place of 256 CTAs that each walk up to 29 blocks in turn.  The plan's
//     last split also takes the spec segment under the mask.  A CTA runs
//     tc_attention.cuh's tiles: four warps, of which one holds the rows
//     when the request has at most 16 (as the 7 of the serve shape) and
//     all four up to 64, 16 each; all four issue the copies and widen an
//     int8 block (one warp alone made int8 1.9x fp).  mma.sync bf16
//     products with f32 accumulators, P rounded to bf16 in registers,
//     blocks in the cache's dtype in a two-stage cp.async ring (the spec
//     blocks, in the compute dtype, go through the same ring).
//     It writes its rows' f32 partial (m, l, acc[D]) to scratch the wrapper
//     allocates; a split with no block writes m = kNegInf, l = 0 and no acc.
//     The merge kernel combines each row's partials in split order, weighting
//     a partial by exp2(m_i - m) and skipping one with m_i = kNegInf, so a
//     row with no live key still gives zeros;
//   * batched layout, float32 (tree_split_tf32_kernel + the same merge):
//     the same split-KV plan and scratch, on the tensor cores as
//     error-compensated TF32 (tc_attention_f32.cuh: three mma.sync m16n8k8
//     passes on the operands' TF32 hi and lo parts, two for an int8
//     cache's exact values; P kept in f32 and split), 32-key blocks in a
//     three-stage cp.async ring.  A CTA holds one chunk of 16 folded rows
//     (the 7 of the serve shape; more rows, as under GQA, take more chunks,
//     which re-read the prefix from L2), and its four warps split each
//     block's keys, one 8-key column tile each, every warp with its own
//     softmax state over the same rows; the CTA merges the four states in
//     shared memory before it writes its split's partial.  The merge
//     kernel writes f32 without a bf16 rounding;
//   * paged: a key block (64 keys bf16, 32 keys f32) sits inside one page
//     (the wrapper requires pages of whole 64-key blocks) and translates
//     once.
//     Keys are visited in the contiguous layout's order, splits fall on the
//     same block boundaries and merge in a fixed order, so the two give
//     identical bits.
// Not yet done (later work): TMA with mbarriers in place of cp.async; a
// persistent schedule that skips the plan's empty splits instead of
// launching them.
//
// C interface for ctypes; the kernels allocate nothing and each entry point
// returns cudaGetLastError() after its launch.

#include "kv_access.cuh"
#include "row_tiles.cuh"
#include "tc_attention.cuh"
#include "tc_attention_f32.cuh"

namespace {

using namespace ffk;

constexpr int kTcThreads = 128; // split kernels: four warps
constexpr int kTfRows = rt::kTfRows;      // f32 split kernels: folded rows
constexpr int kTfStages = rt::kTfStages;  // f32 split kernels: ring depth
using tc::bf16;

// ---------------------------------------------------------------------------
// batched layout
// ---------------------------------------------------------------------------

// bfloat16, split-KV (see the header).  Grid (n_split, num_kv, n_req *
// chunks), four warps: the first NW hold 16 folded rows each, and all
// four issue the copies and widen int8 blocks.  Scratch: f32 (m, l) pairs
// [n_split, n_req, num_kv, m_rows], then acc [n_split, n_req, num_kv,
// m_rows, D]; m in base 2 (scores times log2 e).
template <typename KT, int D, int NW, bool PAGED>
__global__ void __launch_bounds__(kTcThreads)
tree_split_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const bf16* __restrict__ sk, const bf16* __restrict__ sv,
                  const int* __restrict__ rows, const int* __restrict__ clens,
                  const uint8_t* __restrict__ amask,
                  float* __restrict__ scratch, int n_req, int p_tok,
                  int num_kv, int gq, int r1, int s_len, int p_len, int page,
                  int n_split, int split_blocks, float scale) {
  using S = tc::Shape<D>;
  using R = tc::Ring<KT, D, true>;
  constexpr bool KVQ = R::KVQ;
  constexpr int BMR = 16 * NW;          // folded rows per CTA
  constexpr int NT = kTcThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qt = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* ring = tc_smem + BMR * S::LD * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_rows = p_tok * gq;
  const int chunks = (m_rows + BMR - 1) / BMR;
  const int split = blockIdx.x, h = blockIdx.y;
  const int req = blockIdx.z / chunks;
  const int m0 = (blockIdx.z % chunks) * BMR;
  const int qh = num_kv * gq;
  const int row = min(max(rows[req], 0), r1 - 1);
  const int clen = min(max(clens[req], 0), s_len);
  // this split's committed blocks [c_lo, c_hi), then the spec blocks
  const int nb_c = (clen + tc::BN - 1) / tc::BN;
  const int c_lo = min(split * split_blocks, nb_c);
  const int c_hi = min(c_lo + split_blocks, nb_c);
  const int n_c = c_hi - c_lo;
  const int n_s = split == n_split - 1 ? (p_len + tc::BN - 1) / tc::BN : 0;
  const int n_blocks = n_c + n_s;
  const size_t total = (size_t)n_req * num_kv * m_rows;
  float2* part_ml = reinterpret_cast<float2*>(scratch);
  float* part_acc = scratch + 2 * (size_t)n_split * total;
  const size_t part0 = split * total + ((size_t)req * num_kv + h) * m_rows;

  if (n_blocks == 0) {                  // nothing to see: weight 0
    for (int r = tid; r < BMR; r += NT)
      if (m0 + r < m_rows) part_ml[part0 + m0 + r] = make_float2(kNegInf, 0.f);
    return;
  }

  tc::copy_q<D>(Qt, BMR, q, [&](int r) -> long long {
    const int mg = m0 + r;
    if (mg >= m_rows) return -1;
    return (((long long)req * p_tok + mg / gq) * qh + h * gq + mg % gq) * D;
  }, tid, NT);
  cp_async_commit();
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  const size_t spec_base = ((size_t)row * num_kv + h) * p_len;
  auto issue = [&](int nb) {
    unsigned char* stg = R::stage(ring, nb);
    if (nb < n_c) {
      const int n0 = (c_lo + nb) * tc::BN;
      // a block never straddles a page
      const size_t kb0 = head_base + keys.key(n0);
      tc::copy_block<KT, D, true>(stg, k + kb0 * D, v + kb0 * D,
                                  KVQ ? ks + kb0 : nullptr,
                                  KVQ ? vs + kb0 : nullptr,
                                  min(tc::BN, clen - n0), tid, NT);
    } else {
      const int n0 = (nb - n_c) * tc::BN;
      bf16* Kt = reinterpret_cast<bf16*>(stg);
      tc::copy_tiles<D>(Kt, Kt + S::TILE, sk + (spec_base + n0) * D,
                        sv + (spec_base + n0) * D, min(tc::BN, p_len - n0),
                        tid, NT);
    }
  };
  issue(0);
  cp_async_commit();
  cp_async_wait<1>();                    // Q has landed
  __syncthreads();

  // warps past NW hold no rows
  const bool warp_live = warp < NW && m0 + warp * 16 < m_rows;
  tc::Rows<D> st;
  if (warp_live) st.init(Qt, warp, lane);
  const int mg0 = m0 + warp * 16 + (lane >> 2), mg1 = mg0 + 8;
  // the lane's two rows' ancestor-mask rows (null: a row past the tree)
  const uint8_t* mrow0 =
      mg0 < m_rows ? amask + ((size_t)req * p_tok + mg0 / gq) * p_len : nullptr;
  const uint8_t* mrow1 =
      mg1 < m_rows ? amask + ((size_t)req * p_tok + mg1 / gq) * p_len : nullptr;
  const float scale2 = scale * tc::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    if (nb + 1 < n_blocks) issue(nb + 1);
    cp_async_commit();
    cp_async_wait<1>();                  // block nb has landed
    __syncthreads();
    unsigned char* stg = R::stage(ring, nb);
    const bool spec = nb >= n_c;
    const bf16* Kt = reinterpret_cast<const bf16*>(stg);
    const float *ksc = nullptr, *vsc = nullptr;
    if constexpr (KVQ) {
      if (!spec) {
        bf16* wide = R::wide(ring);
        tc::widen_i8<D>(R::k8(stg), R::v8(stg), wide, wide + S::TILE, tid,
                        NT);
        __syncthreads();
        Kt = wide;
        ksc = R::kscale(stg);
        vsc = R::vscale(stg);
      }
    }
    if (warp_live) {
      if (spec) {
        const int n0 = (nb - n_c) * tc::BN;
        st.attend(Kt, Kt + S::TILE, ksc, vsc, scale2, lane,
                  [&](int i, int c) {
                    const uint8_t* mr = i ? mrow1 : mrow0;
                    const int n = n0 + c;
                    return mr != nullptr && n < p_len && mr[n] != 0;
                  });
      } else {
        const int n0 = (c_lo + nb) * tc::BN;
        st.attend(Kt, Kt + S::TILE, ksc, vsc, scale2, lane,
                  [&](int i, int c) {
                    return (i ? mg1 : mg0) < m_rows && n0 + c < clen;
                  });
      }
    }
    __syncthreads();                     // the stage may be refilled
  }
  if (!warp_live) return;
  st.finish();
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mg = i ? mg1 : mg0;
    if (mg >= m_rows) continue;
    const size_t pi = part0 + mg;
    if ((lane & 3) == 0) part_ml[pi] = make_float2(st.m[i], st.l[i]);
    float* ap = part_acc + pi * D;
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt)
      *reinterpret_cast<float2*>(ap + dt * 8 + t2) =
          make_float2(st.o[dt][2 * i], st.o[dt][2 * i + 1]);
  }
}

// Merge each folded row's split partials (in split order) into the output
// in T (bf16, or f32 without a rounding): merge_split_row (kv_access.cuh).
template <typename T>
__global__ void __launch_bounds__(kMergeRows * 32)
tree_merge_kernel(const float* __restrict__ scratch, T* __restrict__ out,
                  int n_req, int p_tok, int num_kv, int gq, int d_head,
                  int n_split) {
  merge_split_row<T>(scratch, out, n_req, p_tok, num_kv, gq, d_head, n_split);
}

// per-token layout: the row-grouped split-KV kernels (row_tiles.cuh); the
// plan's chunks hold TILE folded rows (bf16 rt::BMR, f32 rt::kTfRows)
template <int TILE>
__global__ void __launch_bounds__(32 * rt::kPlanWarps)
tree_token_plan_kernel(rt::Args a) {
  extern __shared__ int rt_counts[];
  rt::plan_body<true, TILE>(a, rt_counts);
}

template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(
    rt::kThreads, (rt::Tiles<KT, D, true>::kMinCtas))
tree_token_split_kernel(rt::Args a) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  rt::split_body<KT, D, PAGED, true>(a, rt_smem);
}

template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(rt::kThreads, 2)
tree_token_split_tf32_kernel(rt::Args a) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  rt::split_tf32_body<KT, D, PAGED, true>(a, rt_smem);
}

template <typename KT, int D>
using TfRing = tf32::Ring<KT, D, true, kTfStages>;

template <typename T>
cudaError_t launch_merge(const void* scratch, void* out, int n_req,
                         int p_tok, int num_kv, int gq, int d_head,
                         int n_split, cudaStream_t stream) {
  const long long total = (long long)n_req * num_kv * p_tok * gq;
  tree_merge_kernel<T><<<(unsigned)((total + kMergeRows - 1) / kMergeRows),
                         kMergeRows * 32, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(out), n_req, p_tok,
      num_kv, gq, d_head, n_split);
  return cudaGetLastError();
}

// float32, split-KV on the tensor cores (see the header).  Grid (n_split,
// num_kv, n_req * chunks of kTfRows folded rows), four warps on the same
// rows, warp w on column tile w of each 32-key block; scratch as the bf16
// split kernel's.
template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(kTcThreads, 2)
tree_split_tf32_kernel(const float* __restrict__ q, const KT* __restrict__ k,
                       const KT* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const float* __restrict__ sk,
                       const float* __restrict__ sv,
                       const int* __restrict__ rows,
                       const int* __restrict__ clens,
                       const uint8_t* __restrict__ amask,
                       float* __restrict__ scratch, int n_req, int p_tok,
                       int num_kv, int gq, int r1, int s_len, int p_len,
                       int page, int n_split, int split_blocks, float scale) {
  using R = TfRing<KT, D>;
  constexpr bool KVQ = R::KVQ;
  constexpr int NT = kTcThreads;
  constexpr int NS = kTfStages;
  constexpr int BN = tf32::BN;
  static_assert(BN == 8 * (kTcThreads / 32),
                "each warp takes one 8-key column tile of a block");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* ring = tc_smem;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_rows = p_tok * gq;
  const int chunks = (m_rows + kTfRows - 1) / kTfRows;
  const int split = blockIdx.x, h = blockIdx.y;
  const int req = blockIdx.z / chunks;
  const int m0 = (blockIdx.z % chunks) * kTfRows;
  const int qh = num_kv * gq;
  const int row = min(max(rows[req], 0), r1 - 1);
  const int clen = min(max(clens[req], 0), s_len);
  // this split's committed blocks [c_lo, c_hi) (the plan counts 64-key
  // blocks; these are BN-key ones, covering the same keys), then the spec
  // blocks
  const int per = split_blocks * (64 / BN);
  const int nb_c = (clen + BN - 1) / BN;
  const int c_lo = min(split * per, nb_c);
  const int c_hi = min(c_lo + per, nb_c);
  const int n_c = c_hi - c_lo;
  const int n_s = split == n_split - 1 ? (p_len + BN - 1) / BN : 0;
  const int n_blocks = n_c + n_s;
  const size_t total = (size_t)n_req * num_kv * m_rows;
  float2* part_ml = reinterpret_cast<float2*>(scratch);
  float* part_acc = scratch + 2 * (size_t)n_split * total;
  const size_t part0 = split * total + ((size_t)req * num_kv + h) * m_rows;

  if (n_blocks == 0) {                  // nothing to see: weight 0
    for (int r = tid; r < kTfRows; r += NT)
      if (m0 + r < m_rows) part_ml[part0 + m0 + r] = make_float2(kNegInf, 0.f);
    return;
  }

  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  const size_t spec_base = ((size_t)row * num_kv + h) * p_len;
  auto issue = [&](int nb) {
    unsigned char* stg = R::stage(ring, nb);
    if (nb < n_c) {
      const int n0 = (c_lo + nb) * BN;
      // a block never straddles a page
      const size_t kb0 = head_base + keys.key(n0);
      tf32::copy_block<R, KT, D>(stg, k + kb0 * D, v + kb0 * D,
                                 KVQ ? ks + kb0 : nullptr,
                                 KVQ ? vs + kb0 : nullptr,
                                 min(BN, clen - n0), tid, NT);
    } else {
      const int n0 = (nb - n_c) * BN;
      tf32::copy_tiles<D>(R::kt(stg), R::vt(stg), sk + (spec_base + n0) * D,
                          sv + (spec_base + n0) * D, min(BN, p_len - n0), tid,
                          NT);
    }
  };
#pragma unroll
  for (int nb = 0; nb < NS - 1; ++nb) {
    if (nb < n_blocks) issue(nb);
    cp_async_commit();
  }

  // every warp holds the chunk's rows; lane rows g and g + 8
  const int mg0 = m0 + (lane >> 2), mg1 = mg0 + 8;
  auto q_row = [&](int mg) -> const float* {
    if (mg >= m_rows) return nullptr;
    return q + (((size_t)req * p_tok + mg / gq) * qh + h * gq + mg % gq) * D;
  };
  tf32::Rows<D, tf32::QKeep::Split> st;
  st.init(q_row(mg0), q_row(mg1), lane);
  // the lane's two rows' ancestor-mask rows (null: a row past the tree)
  const uint8_t* mrow0 =
      mg0 < m_rows ? amask + ((size_t)req * p_tok + mg0 / gq) * p_len : nullptr;
  const uint8_t* mrow1 =
      mg1 < m_rows ? amask + ((size_t)req * p_tok + mg1 / gq) * p_len : nullptr;
  const float scale2 = scale * tf32::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    if (nb + NS - 1 < n_blocks) issue(nb + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();             // block nb has landed
    __syncthreads();
    unsigned char* stg = R::stage(ring, nb);
    if (nb >= n_c) {
      const int n0 = (nb - n_c) * BN;
      st.template attend<float, 1>(
          R::kt(stg), R::vt(stg), nullptr, nullptr, warp, scale2, lane,
          [&](int i, int c) {
            const uint8_t* mr = i ? mrow1 : mrow0;
            const int n = n0 + c;
            return mr != nullptr && n < p_len && mr[n] != 0;
          });
    } else {
      const int n0 = (c_lo + nb) * BN;
      auto live = [&](int i, int c) {
        return (i ? mg1 : mg0) < m_rows && n0 + c < clen;
      };
      if constexpr (KVQ)
        st.template attend<int8_t, 1>(R::k8(stg), R::v8(stg), R::kscale(stg),
                                      R::vscale(stg), warp, scale2, lane,
                                      live);
      else
        st.template attend<float, 1>(R::kt(stg), R::vt(stg), nullptr,
                                     nullptr, warp, scale2, lane, live);
    }
    __syncthreads();                     // the stage may be refilled
  }
  cp_async_wait<0>();
  st.finish();

  // merge the four warps' states of each row in shared memory (the ring
  // is free): weights exp2(m_w - m) (0 for a warp with no live key), then
  // the weighted sums in warp order
  float2* red_ml = reinterpret_cast<float2*>(tc_smem);     // [4][kTfRows]
  float* red_w = reinterpret_cast<float*>(red_ml + 4 * kTfRows);
  float* red_o = red_w + 4 * kTfRows;                       // [4][rows][D]
  if ((lane & 3) == 0) {
    red_ml[warp * kTfRows + (lane >> 2)] = make_float2(st.m[0], st.l[0]);
    red_ml[warp * kTfRows + (lane >> 2) + 8] = make_float2(st.m[1], st.l[1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    st.store_row(i, lane, red_o + (warp * kTfRows + (lane >> 2) + 8 * i) * D,
                 1.f);
  __syncthreads();
  if (tid < kTfRows) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red_ml[w * kTfRows + tid].x);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 ml = red_ml[w * kTfRows + tid];
      const float wt = ml.x == kNegInf ? 0.f : exp2f(ml.x - mx);
      red_w[w * kTfRows + tid] = wt;
      lsum = fmaf(ml.y, wt, lsum);
    }
    if (m0 + tid < m_rows) part_ml[part0 + m0 + tid] = make_float2(mx, lsum);
  }
  __syncthreads();
  for (int i = tid; i < kTfRows * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (m0 + r >= m_rows) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = red_w[w * kTfRows + r];
      const float4 x =
          *reinterpret_cast<const float4*>(red_o + (w * kTfRows + r) * D + c);
      acc.x = fmaf(x.x, wt, acc.x);
      acc.y = fmaf(x.y, wt, acc.y);
      acc.z = fmaf(x.z, wt, acc.z);
      acc.w = fmaf(x.w, wt, acc.w);
    }
    *reinterpret_cast<float4*>(part_acc + (part0 + m0 + r) * D + c) = acc;
  }
}

// shared memory of tree_split_tf32_kernel: the ring, or the warps' states
// in the merge, whichever is the larger
template <typename KT, int D>
constexpr size_t tf32_split_smem() {
  const size_t ring = TfRing<KT, D>::bytes();
  const size_t merge = 4 * kTfRows * (8 + 4 + 4 * (size_t)D);
  return ring > merge ? ring : merge;
}

template <typename KT, int D, bool PAGED>
cudaError_t launch_split_tf32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* sk, const void* sv,
    const void* rows, const void* clens, const void* amask, void* scratch,
    void* out, int n_req, int p_tok, int num_kv, int gq, int r1, int s_len,
    int p_len, int page, int n_split, int split_blocks, float scale,
    cudaStream_t stream) {
  const size_t smem = tf32_split_smem<KT, D>();
  cudaError_t err =
      tc::allow_smem<tree_split_tf32_kernel<KT, D, PAGED>>(smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p_tok * gq + kTfRows - 1) / kTfRows;
  tree_split_tf32_kernel<KT, D, PAGED>
      <<<dim3(n_split, num_kv, n_req * chunks), kTcThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const KT*>(k),
          static_cast<const KT*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const float*>(sk), static_cast<const float*>(sv),
          static_cast<const int*>(rows), static_cast<const int*>(clens),
          static_cast<const uint8_t*>(amask), static_cast<float*>(scratch),
          n_req, p_tok, num_kv, gq, r1, s_len, p_len, page, n_split,
          split_blocks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<float>(scratch, out, n_req, p_tok, num_kv, gq, D,
                             n_split, stream);
}

template <typename KT, int D, int NW, bool PAGED>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* table,
                         const void* sk, const void* sv, const void* rows,
                         const void* clens, const void* amask, void* scratch,
                         void* out, int n_req, int p_tok, int num_kv, int gq,
                         int r1, int s_len, int p_len, int page, int n_split,
                         int split_blocks, float scale, cudaStream_t stream) {
  const size_t smem = tc::Ring<KT, D, true>::bytes(16 * NW);
  cudaError_t err =
      tc::allow_smem<tree_split_kernel<KT, D, NW, PAGED>>(smem);
  if (err != cudaSuccess) return err;
  const int m_rows = p_tok * gq;
  const int chunks = (m_rows + 16 * NW - 1) / (16 * NW);
  tree_split_kernel<KT, D, NW, PAGED>
      <<<dim3(n_split, num_kv, n_req * chunks), kTcThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const KT*>(k),
          static_cast<const KT*>(v), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const bf16*>(sk), static_cast<const bf16*>(sv),
          static_cast<const int*>(rows), static_cast<const int*>(clens),
          static_cast<const uint8_t*>(amask), static_cast<float*>(scratch),
          n_req, p_tok, num_kv, gq, r1, s_len, p_len, page, n_split,
          split_blocks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<bf16>(scratch, out, n_req, p_tok, num_kv, gq, D,
                           n_split, stream);
}

}  // namespace

// Per-token layout.  q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len,
// D] in q's dtype, or int8 with k_scale, v_scale f32 [r1, num_kv, s_len]
// (null: fp cache); table int32 [r1, s_len / page_size] (null:
// slot-contiguous; else page_size a multiple of 64 dividing s_len); sk, sv
// [r1, num_kv, p_len, D] in q's dtype; rows, clens int32[n_tokens]; amask
// bool[n_tokens, p_len]; out like q; scratch f32 [n_split * n_tokens *
// num_kv*gq * (D + 2)]; plan int32 [round_up(2 * n_tokens, 4) + (4 +
// num_kv) * cap] with cap = ceil(n_tokens * gq / tile) + r1 (tile 64 for
// bfloat16, 16 for float32); the split plan.  dtype: 0 = float32, 1 =
// bfloat16.  All tensors contiguous.
extern "C" int ff_tree_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* sk, const void* sv,
    const void* rows, const void* clens, const void* amask, void* scratch,
    void* plan, void* out, int n_tokens, int num_kv, int gq, int r1,
    int s_len, int p_len, int head_dim, int page_size, int n_split,
    int split_blocks, int cap, float scale, int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  if (scratch == nullptr || plan == nullptr || n_split < 1 ||
      split_blocks < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::Args a{
      q, k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      nullptr, sk, sv, static_cast<const uint8_t*>(amask),
      static_cast<const int*>(rows), static_cast<const int*>(clens),
      static_cast<int*>(plan), static_cast<float*>(scratch), out, n_tokens,
      num_kv, gq, r1, s_len, p_len, page_size, n_split, split_blocks, cap,
      scale};
  const cudaError_t err = with_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_head_dim(head_dim, [&](auto dd) {
      constexpr int D = decltype(dd)::value;
      return with_variant(k_scale != nullptr, table != nullptr,
                          [&](auto qq, auto pp) {
        constexpr bool PAGED = decltype(pp)::value;
        using KT = std::conditional_t<decltype(qq)::value, int8_t, T>;
        if constexpr (std::is_same<T, float>::value)
          return rt::launch<tree_token_plan_kernel<rt::kTfRows>,
                            tree_token_split_tf32_kernel<KT, D, PAGED>>(
              a, rt::TfTiles<KT, D, true>::bytes, st);
        else
          return rt::launch<tree_token_plan_kernel<rt::BMR>,
                            tree_token_split_kernel<KT, D, PAGED>>(
              a, rt::Tiles<KT, D, true>::bytes, st);
      });
    });
  });
  return static_cast<int>(err);
}

// Batched layout.  q [n_req, p_tok, num_kv*gq, D]; k, v, k_scale, v_scale,
// table, sk, sv as above (a paged table: page_size a multiple of 64
// dividing s_len); rows, clens int32[n_req]; amask bool[n_req, p_tok,
// p_len]; out like q; scratch f32 [n_split * n_req * num_kv * p_tok * gq *
// (D + 2)] for the split partials, each split of split_blocks 64-key
// blocks of the committed prefix, n_split of them covering s_len.
extern "C" int ff_tree_attention_batched(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* sk, const void* sv,
    const void* rows, const void* clens, const void* amask, void* scratch,
    void* out, int n_req, int p_tok, int num_kv, int gq, int r1, int s_len,
    int p_len, int head_dim, int page_size, int n_split, int split_blocks,
    float scale, int dtype, void* stream) {
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
        if (scratch == nullptr || n_split < 1 || split_blocks < 1)
          return cudaErrorInvalidValue;
        if constexpr (std::is_same<T, float>::value) {
          return launch_split_tf32<KT, D, PAGED>(
              q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
              scratch, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len,
              page_size, n_split, split_blocks, scale, st);
        } else {
          if (p_tok * gq <= 16)
            return launch_split<KT, D, 1, PAGED>(
                q, k, v, k_scale, v_scale, table, sk, sv, rows, clens,
                amask, scratch, out, n_req, p_tok, num_kv, gq, r1, s_len,
                p_len, page_size, n_split, split_blocks, scale, st);
          return launch_split<KT, D, 4, PAGED>(
              q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
              scratch, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len,
              page_size, n_split, split_blocks, scale, st);
        }
      });
    });
  });
  return static_cast<int>(err);
}
