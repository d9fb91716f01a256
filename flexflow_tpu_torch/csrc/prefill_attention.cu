// Q-tiled prefill attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `prefill_attention`
// (flexflow_tpu/ops/pallas/attention.py:444, body `_prefill_kernel` :357)
// with fp or int8 caches (`k_scale/v_scale`), slot-contiguous or paged
// (`page_table`, maps :505-520).  G tiles of Bq tokens of one request,
// positions contiguous from pstart[g]; each query row attends causally to
// its tile's cache row rows[g], which already holds this step's K/V.  The
// Bq*gq query rows of a (tile, kv head) are folded b-major as the reference
// folds them (row = b*gq + g'), query row r sits at position
// pstart + r/gq, and it sees the keys at positions <= that.  Online softmax
// in f32, denominator clamped at 1e-30, output in q's dtype.  An int8
// cache is dequantized in the Pallas kernel's order: score =
// (q . k_i8) * scale * ks[key], the denominator takes the unscaled p, the
// P.V product takes p * vs[key].
//
// What bounds it on the H100: at the Llama-2-7B serve shape (4 tiles of
// 128 tokens at pstart 0, 640, 1280, 1920; 32 heads, D 128) the tiles' K/V
// prefixes are 79.7 MB in bf16 (159 MB in f32), 0.0238 ms (0.048) at 3.35
// TB/s; the 8.6 GFLOP of the two products take 0.0087 ms at the tensor
// cores' bf16 rate, 0.052 ms as three TF32 passes (f32), 0.13 ms at the
// CUDA cores' f32 rate.  So both dtypes run on the tensor cores, one CTA of
// four warps per (tile, kv head, chunk of 64 folded rows), 16 rows a warp:
//   * bf16 (prefill_tc_kernel; tc_attention.cuh): mma.sync m16n8k16 for
//     Q.K^T and P.V with f32 accumulators, P rounded to bf16 in registers
//     (one rounding the Pallas kernel, f32 throughout, does not make),
//     64-key K/V blocks kept in the cache's dtype in a two-stage cp.async
//     ring so block n+1 loads while block n computes (87 KB of shared
//     memory at D 128: two CTAs per SM);
//   * float32 (prefill_tf32_kernel; tc_attention_f32.cuh): error-
//     compensated TF32, each product as three mma.sync m16n8k8 passes on
//     the operands' TF32 hi and lo parts (two for an int8 cache, whose
//     values are exact in TF32), P kept in f32 and split like any operand,
//     so the f32 serve paths keep f32 accuracy; a 64-row Q tile in shared
//     memory, split at each use, and 32-key blocks in a two-stage cp.async
//     ring (105 KB at D 128: two CTAs per SM).  Split-KV: each (tile,
//     chunk, kv head) reads its keys in splits of 1024 (the wrapper's
//     plan), one CTA each, so the deepest tiles' walks (64 blocks at
//     pstart 1920) spread over the card; a merge kernel combines the
//     splits' f32 partials.  Its time then follows its count of mma (an
//     int8 cache's two passes take two thirds of three): mma.sync's TF32
//     rate bounds it, below the data sheet's, which wgmma reaches;
//   * in both, CTAs are issued deepest first: blockIdx ranks the tiles by
//     descending pstart, then the chunks from the last, so the longest
//     causal walks do not trail the wave.  A chunk stops at its causal
//     frontier, a warp skips the blocks past its own, and the kernel masks
//     its ragged edges (rows past Bq*gq, keys past pstart + b, keys past
//     the cache length);
//   * paged: a block sits inside one page (the wrapper requires pages of
//     whole 64-key blocks), so each block translates through the table once;
//     the blocks and their arithmetic are those of the contiguous layout, so
//     the two give identical bits.
// Not yet done (later work): wgmma on the 64-row tile and TMA with
// mbarriers in place of cp.async, a persistent schedule over (tile, head,
// chunk) work items, split-KV for the deepest bf16 tiles.
//
// C interface for ctypes; the kernel allocates nothing and returns
// cudaGetLastError() after the launch.

#include "kv_access.cuh"
#include "tc_attention.cuh"
#include "tc_attention_f32.cuh"

namespace {

using namespace ffk;

constexpr int BM = 64;   // folded query rows per CTA
constexpr int kTcThreads = 128;     // four warps of 16 rows
constexpr int kTfStages = 2;        // f32 ring depth, beside the Q tile
using tc::bf16;
template <typename KT, int D>
using TfRing = tf32::Ring<KT, D, false, kTfStages>;

// The CTA's tile, chunk and kv head: blockIdx.x ranks the tiles by
// descending pstart (ties by index), then the chunks from the last, then
// the kv heads.  Returns the tile (every thread; one barrier).
__device__ __forceinline__ int rank_tile(const int* __restrict__ pstart,
                                         int n_tiles, int rank, int* sh_tile) {
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int pt = pstart[t];
    int rk = 0;
    for (int u = 0; u < n_tiles; ++u) {
      const int pu = pstart[u];
      rk += pu > pt || (pu == pt && u < t);
    }
    if (rk == rank) *sh_tile = t;
  }
  __syncthreads();
  return *sh_tile;
}

// float32: error-compensated TF32 on the tensor cores, cp.async ring,
// split-KV (see the header).  A 1-D grid of n_tiles * chunks * num_kv *
// n_split CTAs, ranked as the bf16 kernel's (rank_tile) with the splits of
// each (tile, chunk, kv head) adjacent; split j reads keys [j split_keys,
// (j + 1) split_keys) up to the chunk's causal frontier.  One split writes
// the output; more write f32 partials to scratch (kv_access.cuh's layout,
// the tiles as requests) for prefill_merge_kernel.
template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(kTcThreads, 2)
prefill_tf32_kernel(const float* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ rows,
                    const int* __restrict__ pstart, float* __restrict__ out,
                    float* __restrict__ scratch, int n_tiles, int bq,
                    int num_kv, int gq, int r1, int s_len, int page,
                    int n_split, int split_keys, float scale) {
  using S = tf32::Shape<D>;
  using R = TfRing<KT, D>;
  constexpr bool KVQ = R::KVQ;
  constexpr int NS = kTfStages;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int sh_tile;
  float* Qt = reinterpret_cast<float*>(tc_smem);
  unsigned char* ring = tc_smem + BM * S::LDK * 4;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_rows = bq * gq;
  const int chunks = (m_rows + BM - 1) / BM;
  const int per_tile = chunks * num_kv * n_split;
  const int rem = blockIdx.x % per_tile;
  const int m0 = (chunks - 1 - rem / (num_kv * n_split)) * BM;
  const int h = (rem / n_split) % num_kv;
  const int split = rem % n_split;
  const int tile = rank_tile(pstart, n_tiles, blockIdx.x / per_tile,
                             &sh_tile);
  const int qh = num_kv * gq;
  const int row = min(max(rows[tile], 0), r1 - 1);
  const int ps = pstart[tile];
  // causal frontier of this chunk's last real row, and this split's keys
  // [k_lo, front]
  const int m_last = min(m0 + BM, m_rows) - 1;
  const int front = min(min(max(ps + m_last / gq, 0), s_len - 1),
                        (split + 1) * split_keys - 1);
  const int k_lo = split * split_keys;
  const int n_blocks = front < k_lo ? 0 : (front - k_lo) / tf32::BN + 1;
  const size_t total = (size_t)n_tiles * num_kv * m_rows;
  float2* part_ml = reinterpret_cast<float2*>(scratch);
  float* part_acc = scratch + 2 * (size_t)n_split * total;
  const size_t part0 = split * total + ((size_t)tile * num_kv + h) * m_rows;
  if (n_blocks == 0) {                  // nothing to see: weight 0
    for (int r = tid; r < BM; r += kTcThreads)
      if (m0 + r < m_rows) part_ml[part0 + m0 + r] = make_float2(kNegInf, 0.f);
    return;
  }

  tf32::copy_q<D>(Qt, BM, q, [&](int r) -> long long {
    const int mg = m0 + r;
    if (mg >= m_rows) return -1;
    return (((long long)tile * bq + mg / gq) * qh + h * gq + mg % gq) * D;
  }, tid, kTcThreads);
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  auto issue = [&](int nb) {
    const int n0 = k_lo + nb * tf32::BN;
    // key rows of this block: contiguous from here (a block never
    // straddles a page)
    const size_t kb0 = head_base + keys.key(n0);
    tf32::copy_block<R, KT, D>(
        R::stage(ring, nb), k + kb0 * D, v + kb0 * D,
        KVQ ? ks + kb0 : nullptr, KVQ ? vs + kb0 : nullptr,
        min(tf32::BN, front + 1 - n0), tid, kTcThreads);
  };
#pragma unroll
  for (int nb = 0; nb < NS - 1; ++nb) {    // the Q tile rides with block 0
    if (nb < n_blocks) issue(nb);
    cp_async_commit();
  }

  // the lane's two rows and the positions they see up to (-1: a pad row)
  const int mg0 = m0 + warp * 16 + (lane >> 2), mg1 = mg0 + 8;
  tf32::Rows<D, tf32::QKeep::Shared> st;
  st.init(Qt + (warp * 16 + (lane >> 2)) * S::LDK,
          Qt + (warp * 16 + (lane >> 2) + 8) * S::LDK, lane);
  const int qp0 = mg0 < m_rows ? ps + mg0 / gq : -1;
  const int qp1 = mg1 < m_rows ? ps + mg1 / gq : -1;
  const bool warp_live = m0 + warp * 16 < m_rows;
  const int warp_front = ps + (min(m0 + warp * 16 + 15, m_rows - 1)) / gq;
  const float scale2 = scale * tf32::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    if (nb + NS - 1 < n_blocks) issue(nb + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();             // block nb has landed
    __syncthreads();
    unsigned char* stg = R::stage(ring, nb);
    const int n0 = k_lo + nb * tf32::BN;
    auto live = [&](int i, int c) {
      const int n = n0 + c;
      return n <= (i ? qp1 : qp0) && n < s_len;
    };
    if (warp_live && n0 <= warp_front) {
      if constexpr (KVQ)
        st.template attend<int8_t, S::NT>(R::k8(stg), R::v8(stg),
                                          R::kscale(stg), R::vscale(stg), 0,
                                          scale2, lane, live);
      else
        st.template attend<float, S::NT>(R::kt(stg), R::vt(stg), nullptr,
                                         nullptr, 0, scale2, lane, live);
    }
    __syncthreads();                     // the stage may be refilled
  }
  if (!warp_live) return;
  st.finish();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mg = i ? mg1 : mg0;
    if (mg >= m_rows) continue;
    if (n_split == 1) {
      st.store_row(i, lane,
                   out + (((size_t)tile * bq + mg / gq) * qh + h * gq +
                          mg % gq) * D,
                   1.f / fmaxf(st.l[i], 1e-30f));
    } else {
      if ((lane & 3) == 0)
        part_ml[part0 + mg] = make_float2(st.m[i], st.l[i]);
      st.store_row(i, lane, part_acc + (part0 + mg) * D, 1.f);
    }
  }
}

// The f32 split partials merged into the output (merge_split_row).
__global__ void __launch_bounds__(kMergeRows * 32)
prefill_merge_kernel(const float* __restrict__ scratch,
                     float* __restrict__ out, int n_tiles, int bq,
                     int num_kv, int gq, int d_head, int n_split) {
  merge_split_row<float>(scratch, out, n_tiles, bq, num_kv, gq, d_head,
                         n_split);
}

// bfloat16: tensor cores, cp.async ring (see the header).  A 1-D grid of
// n_tiles * num_kv * chunks CTAs (rank_tile).
template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(kTcThreads)
prefill_tc_kernel(const bf16* __restrict__ q, const KT* __restrict__ k,
                  const KT* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const int* __restrict__ rows,
                  const int* __restrict__ pstart, bf16* __restrict__ out,
                  int n_tiles, int bq, int num_kv, int gq, int r1, int s_len,
                  int page, float scale) {
  using S = tc::Shape<D>;
  using R = tc::Ring<KT, D, false>;
  constexpr bool KVQ = R::KVQ;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int sh_tile;
  bf16* Qt = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* ring = tc_smem + BM * S::LD * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_rows = bq * gq;
  const int chunks = (m_rows + BM - 1) / BM;
  const int h = blockIdx.x % num_kv;
  const int m0 = (chunks - 1 - (blockIdx.x / num_kv) % chunks) * BM;
  const int tile = rank_tile(pstart, n_tiles, blockIdx.x / (num_kv * chunks),
                             &sh_tile);
  const int qh = num_kv * gq;
  const int row = min(max(rows[tile], 0), r1 - 1);
  const int ps = pstart[tile];
  // causal frontier of this chunk's last real row: the keys it loads
  const int m_last = min(m0 + BM, m_rows) - 1;
  const int front = min(max(ps + m_last / gq, 0), s_len - 1);
  const int n_blocks = front / tc::BN + 1;

  tc::copy_q<D>(Qt, BM, q, [&](int r) -> long long {
    const int mg = m0 + r;
    if (mg >= m_rows) return -1;
    return (((long long)tile * bq + mg / gq) * qh + h * gq + mg % gq) * D;
  }, tid, kTcThreads);
  cp_async_commit();
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);
  auto issue = [&](int nb) {
    const int n0 = nb * tc::BN;
    // key rows of this block: contiguous from here (a block never
    // straddles a page)
    const size_t kb0 = head_base + keys.key(n0);
    tc::copy_block<KT, D, false>(
        R::stage(ring, nb), k + kb0 * D, v + kb0 * D,
        KVQ ? ks + kb0 : nullptr, KVQ ? vs + kb0 : nullptr,
        min(tc::BN, front + 1 - n0), tid, kTcThreads);
  };
  issue(0);
  cp_async_commit();
  cp_async_wait<1>();                    // Q has landed
  __syncthreads();

  tc::Rows<D> st;
  st.init(Qt, warp, lane);
  // the lane's two rows and the positions they see up to (-1: a pad row)
  const int mg0 = m0 + warp * 16 + (lane >> 2), mg1 = mg0 + 8;
  const int qp0 = mg0 < m_rows ? ps + mg0 / gq : -1;
  const int qp1 = mg1 < m_rows ? ps + mg1 / gq : -1;
  const bool warp_live = m0 + warp * 16 < m_rows;
  const int warp_front = ps + (min(m0 + warp * 16 + 15, m_rows - 1)) / gq;
  const float scale2 = scale * tc::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    if (nb + 1 < n_blocks) issue(nb + 1);
    cp_async_commit();
    cp_async_wait<1>();                  // block nb has landed
    __syncthreads();
    unsigned char* stg = R::stage(ring, nb);
    const bf16* Kt = reinterpret_cast<const bf16*>(stg);
    const float *ksc = nullptr, *vsc = nullptr;
    if constexpr (KVQ) {
      bf16* wide = R::wide(ring);
      tc::widen_i8<D>(R::k8(stg), R::v8(stg), wide, wide + S::TILE, tid,
                      kTcThreads);
      __syncthreads();
      Kt = wide;
      ksc = R::kscale(stg);
      vsc = R::vscale(stg);
    }
    const int n0 = nb * tc::BN;
    if (warp_live && n0 <= warp_front)
      st.attend(Kt, Kt + S::TILE, ksc, vsc, scale2, lane, [&](int i, int c) {
        const int n = n0 + c;
        return n <= (i ? qp1 : qp0) && n < s_len;
      });
    __syncthreads();                     // the stage may be refilled
  }
  st.finish();
  if (!warp_live) return;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mg = i ? mg1 : mg0;
    if (mg >= m_rows) continue;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    bf16* op = out + (((size_t)tile * bq + mg / gq) * qh + h * gq + mg % gq) * D;
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8 + t2) =
          pack_bf16(st.o[dt][2 * i] * inv, st.o[dt][2 * i + 1] * inv);
  }
}

// The f32 engine's fragment layout and 3xTF32 products on one warp, for
// the card test that pins them with exact integer products:
//   mode 0: c[16][8] = a[16][D] . b[8][D]^T (Rows::scores on one key tile);
//   mode 1: c[16][D] = a[16][8] . b[8][D] (Rows::pv, P given in the score
//           tile's accumulator layout);
//   mode 2: c[4i .. 4i + 3] = the engine's TF32 hi and lo parts of a[i]
//           (lo as the product reads it), then cvt.rna.tf32.f32 of a[i]
//           and of a[i] - hi, i < n.
template <int D>
__global__ void __launch_bounds__(32)
tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int mode, int n) {
  using S = tf32::Shape<D>;
  constexpr int LD = S::LDK > S::LDV ? S::LDK : S::LDV;
  __shared__ __align__(16) float tile[tf32::BN * LD];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  if (mode == 2) {
    for (int i = lane; i < n; i += 32) {
      uint32_t hi, lo;
      tf32::split(a[i], hi, lo);
      c[4 * i] = __uint_as_float(hi);
      c[4 * i + 1] = __uint_as_float(lo & 0xffffe000u);   // as mma reads it
      c[4 * i + 2] = __uint_as_float(tf32_rna(a[i]));
      c[4 * i + 3] = __uint_as_float(tf32_rna(a[i] - __uint_as_float(hi)));
    }
    return;
  }
  const int ld = mode == 0 ? S::LDK : S::LDV;
  for (int i = lane; i < tf32::BN * ld; i += 32) {
    const int r = i / ld, d = i % ld;
    tile[i] = r < 8 && d < D ? b[r * D + d] : 0.f;
  }
  __syncwarp();
  tf32::Rows<D, tf32::QKeep::Split> st;
  if (mode == 0) {
    st.init(a + g * D, a + (g + 8) * D, lane);
    float s[1][4];
    st.template scores<float, 1>(tile, 0, lane, s);
    c[g * 8 + 2 * t] = s[0][0];
    c[g * 8 + 2 * t + 1] = s[0][1];
    c[(g + 8) * 8 + 2 * t] = s[0][2];
    c[(g + 8) * 8 + 2 * t + 1] = s[0][3];
  } else {
    st.init(nullptr, nullptr, lane);
    const float p[1][4] = {{a[g * 8 + 2 * t], a[g * 8 + 2 * t + 1],
                            a[(g + 8) * 8 + 2 * t],
                            a[(g + 8) * 8 + 2 * t + 1]}};
    st.template pv<float, 1>(tile, 0, lane, p);
    st.store_row(0, lane, c + g * D, 1.f);
    st.store_row(1, lane, c + (g + 8) * D, 1.f);
  }
}

}  // namespace

// a, b, c f32 as tf32_probe_kernel's mode takes them (contiguous), head_dim
// D; one warp.
extern "C" int ff_tf32x3_probe(const void* a, const void* b, void* c,
                               int mode, int head_dim, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_head_dim(head_dim, [&](auto dd) {
    constexpr int D = decltype(dd)::value;
    tf32_probe_kernel<D><<<1, 32, 0, st>>>(static_cast<const float*>(a),
                                           static_cast<const float*>(b),
                                           static_cast<float*>(c), mode, n);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// q [n_tiles, bq, num_kv*gq, D]; k, v [r1, num_kv, s_len, D] in q's dtype,
// or int8 with k_scale, v_scale f32 [r1, num_kv, s_len] (null: fp cache);
// table int32 [r1, s_len / page_size] (null: slot-contiguous; else
// page_size a multiple of 64 dividing s_len); rows, pstart
// int32[n_tiles]; out [n_tiles, bq, num_kv*gq, D].  dtype: 0 = float32,
// 1 = bfloat16.  float32 also takes its split plan: n_split splits of
// split_keys keys (a multiple of 32), and for n_split > 1 scratch f32
// [n_split * n_tiles * num_kv * bq * gq * (D + 2)]; bfloat16 ignores them.
// All tensors contiguous.
extern "C" int ff_prefill_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* rows,
    const void* pstart, void* scratch, void* out, int n_tiles, int bq,
    int num_kv, int gq, int r1, int s_len, int head_dim, int page_size,
    int n_split, int split_keys, float scale, int dtype, void* stream) {
  if (n_tiles == 0 || bq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_dtype(dtype, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_head_dim(head_dim, [&](auto dd) {
      return with_variant(k_scale != nullptr, table != nullptr,
                          [&](auto qq, auto pp) {
        constexpr int D = decltype(dd)::value;
        constexpr bool KVQ = decltype(qq)::value;
        constexpr bool PAGED = decltype(pp)::value;
        using KT = std::conditional_t<KVQ, int8_t, T>;
        const int chunks = (bq * gq + BM - 1) / BM;
        if constexpr (std::is_same<T, float>::value) {
          const size_t smem =
              BM * tf32::Shape<D>::LDK * 4 + TfRing<KT, D>::bytes();
          cudaError_t e =
              tc::allow_smem<prefill_tf32_kernel<KT, D, PAGED>>(smem);
          if (e != cudaSuccess) return e;
          if (n_split < 1 || split_keys < 1 || split_keys % tf32::BN ||
              (n_split > 1 && scratch == nullptr))
            return cudaErrorInvalidValue;
          prefill_tf32_kernel<KT, D, PAGED>
              <<<n_tiles * num_kv * chunks * n_split, kTcThreads, smem,
                 st>>>(
                  static_cast<const float*>(q), static_cast<const KT*>(k),
                  static_cast<const KT*>(v),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(table),
                  static_cast<const int*>(rows),
                  static_cast<const int*>(pstart), static_cast<float*>(out),
                  static_cast<float*>(scratch), n_tiles, bq, num_kv, gq, r1,
                  s_len, page_size, n_split, split_keys, scale);
          if (n_split > 1) {
            e = cudaGetLastError();
            if (e != cudaSuccess) return e;
            const long long rows_all = (long long)n_tiles * num_kv * bq * gq;
            prefill_merge_kernel<<<(unsigned)((rows_all + kMergeRows - 1) /
                                              kMergeRows),
                                   kMergeRows * 32, 0, st>>>(
                static_cast<const float*>(scratch), static_cast<float*>(out),
                n_tiles, bq, num_kv, gq, D, n_split);
          }
        } else {
          const size_t smem = tc::Ring<KT, D, false>::bytes(BM);
          cudaError_t e =
              tc::allow_smem<prefill_tc_kernel<KT, D, PAGED>>(smem);
          if (e != cudaSuccess) return e;
          prefill_tc_kernel<KT, D, PAGED>
              <<<n_tiles * num_kv * chunks, kTcThreads, smem, st>>>(
                  static_cast<const bf16*>(q), static_cast<const KT*>(k),
                  static_cast<const KT*>(v),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(table),
                  static_cast<const int*>(rows),
                  static_cast<const int*>(pstart), static_cast<bf16*>(out),
                  n_tiles, bq, num_kv, gq, r1, s_len, page_size, scale);
        }
        return cudaGetLastError();
      });
    });
  });
  return static_cast<int>(err);
}
