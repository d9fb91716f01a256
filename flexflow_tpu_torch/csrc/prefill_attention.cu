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
// What bounds it on the H100: the bytes.  At the Llama-2-7B serve shape
// (4 tiles of 128 tokens at pstart 0, 640, 1280, 1920; 32 heads, D 128) the
// tiles' K/V prefixes are 79.7 MB, 0.0238 ms at 3.35 TB/s; the 8.6 GFLOP
// of the two products take 0.0087 ms at the tensor cores' bf16 rate, but
// 0.13 ms at the CUDA cores' f32 rate.  So:
//   * bf16 (prefill_tc_kernel): one CTA of four warps per (tile, kv head,
//     chunk of 64 folded rows), on the tensor cores (tc_attention.cuh):
//     mma.sync m16n8k16 for Q.K^T and P.V with f32 accumulators, P rounded
//     to bf16 in registers (one rounding the Pallas kernel, f32 throughout,
//     does not make), 64-key K/V blocks kept in the cache's dtype in a
//     two-stage cp.async ring so block n+1 loads while block n computes
//     (87 KB of shared memory at D 128: two CTAs per SM).  CTAs are issued
//     deepest first: blockIdx ranks the tiles by descending pstart, then the
//     chunks from the last, so the longest causal walks do not trail the
//     wave.  A chunk stops at its causal frontier, a warp skips the blocks
//     past its own, and the kernel masks its ragged edges (rows past
//     Bq*gq, keys past pstart + b, keys past the cache length);
//   * float32 (prefill_kernel): the tensor cores have no f32 mode (TF32
//     would break the f32 parity of the serve paths), so f32 keeps the
//     CUDA-core kernel: 64-key blocks staged in shared memory as f32, each
//     of 256 threads computing a 4x4 block of scores and a 4x(D/16) block
//     of the output;
//   * paged: a block sits inside one page (the wrapper requires pages of
//     whole blocks), so each block translates through the table once; the
//     blocks and their arithmetic are those of the contiguous layout, so
//     the two give identical bits.
// Not yet done (later work): wgmma on the 64-row tile and TMA with
// mbarriers in place of cp.async, a persistent schedule over (tile, head,
// chunk) work items, split-KV for the deepest tiles.
//
// C interface for ctypes; the kernel allocates nothing and returns
// cudaGetLastError() after the launch.

#include "kv_access.cuh"
#include "tc_attention.cuh"

namespace {

using namespace ffk;

constexpr int BM = 64;   // folded query rows per CTA
constexpr int BN = 64;   // keys per shared-memory block
constexpr int kThreads = 256;       // f32 kernel
constexpr int kTcThreads = 128;     // bf16 kernel: four warps of 16 rows
using tc::bf16;

static_assert(BM * 4 == kThreads, "the softmax pass gives each row 4 lanes");
static_assert(BN == 4 * 16, "each softmax lane covers 16 keys");

template <int D, bool KVQ>
constexpr size_t smem_floats() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ss [BM][BN+1], m/l/alpha [BM],
  // and for an int8 cache the block's K and V scales [BN] each
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM + (KVQ ? 2 * BN : 0);
}

// float32: CUDA-core FMAs (see the header)
template <typename T, typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const KT* __restrict__ k,
               const KT* __restrict__ v, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ table,
               const int* __restrict__ rows, const int* __restrict__ pstart,
               T* __restrict__ out, int bq, int num_kv, int gq, int r1,
               int s_len, int page, float scale) {
  constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  // elements per staged vector: 16 bytes of the cache's dtype (an int8
  // row of D = 8 is one 8-byte vector)
  constexpr int VEC = KVQ ? (D >= 16 ? 16 : 8) : 16 / sizeof(T);
  constexpr int VPR = D / VEC;          // vectors per key row
  static_assert(D % VEC == 0, "head dim must fill whole vectors");
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
  float* Ksc = row_a + BM;              // int8 only: [BN] K scales
  float* Vsc = Ksc + BN;                // int8 only: [BN] V scales

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
  const size_t head_base = head_keys<PAGED>(row, num_kv, h, s_len);
  KeyRows<PAGED> keys(table, row, num_kv, h, s_len, page);

  const int tx = tid % 16, ty = tid / 16;
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  __syncthreads();

  for (int nb = 0; nb < n_blocks; ++nb) {
    const int n0 = nb * BN;
    // key rows of this block: contiguous from here (a block never
    // straddles a page)
    const size_t kb0 = head_base + keys.key(n0);
    for (int i = tid; i < BN * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR, n = n0 + r;
      float kf[VEC], vf[VEC];
      if (n < s_len) {
        const size_t off = (kb0 + r) * D + c * VEC;
        Vec<KT, VEC> kr, vr;
        kr.load(k + off);
        vr.load(v + off);
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
    if constexpr (KVQ) {
      if (tid < BN) {
        const bool in = n0 + tid < s_len;
        Ksc[tid] = in ? ks[kb0 + tid] : 0.f;
        Vsc[tid] = in ? vs[kb0 + tid] : 0.f;
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
        float sc = s[i][j] * scale;
        if constexpr (KVQ) sc *= Ksc[c];
        Ss[r * SP + c] = live ? sc : kNegInf;
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
        // the denominator sums the unscaled p; P.V takes p * vs
        Ss[r * SP + c] = KVQ ? p * Vsc[c] : p;
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

// bfloat16: tensor cores, cp.async ring (see the header).  A 1-D grid of
// n_tiles * num_kv * chunks CTAs: block b works on the tile ranked
// b / (num_kv * chunks) by descending pstart (ties by index), chunk
// chunks - 1 - (b / num_kv) % chunks, kv head b % num_kv.
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
  const int rank = blockIdx.x / (num_kv * chunks);
  const int h = blockIdx.x % num_kv;
  const int m0 = (chunks - 1 - (blockIdx.x / num_kv) % chunks) * BM;
  for (int t = tid; t < n_tiles; t += kTcThreads) {
    const int pt = pstart[t];
    int rk = 0;
    for (int u = 0; u < n_tiles; ++u) {
      const int pu = pstart[u];
      rk += pu > pt || (pu == pt && u < t);
    }
    if (rk == rank) sh_tile = t;
  }
  __syncthreads();
  const int tile = sh_tile;
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

}  // namespace

// q [n_tiles, bq, num_kv*gq, D]; k, v [r1, num_kv, s_len, D] in q's dtype,
// or int8 with k_scale, v_scale f32 [r1, num_kv, s_len] (null: fp cache);
// table int32 [r1, s_len / page_size] (null: slot-contiguous; else
// page_size a multiple of 64 dividing s_len); rows, pstart
// int32[n_tiles]; out [n_tiles, bq, num_kv*gq, D].  dtype: 0 = float32,
// 1 = bfloat16.  All tensors contiguous.
extern "C" int ff_prefill_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* rows,
    const void* pstart, void* out, int n_tiles, int bq, int num_kv, int gq,
    int r1, int s_len, int head_dim, int page_size, float scale, int dtype,
    void* stream) {
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
          const size_t smem = smem_floats<D, KVQ>() * sizeof(float);
          cudaError_t e = tc::allow_smem<prefill_kernel<T, KT, D, PAGED>>(
              smem);
          if (e != cudaSuccess) return e;
          prefill_kernel<T, KT, D, PAGED>
              <<<dim3(n_tiles, num_kv, chunks), kThreads, smem, st>>>(
                  static_cast<const T*>(q), static_cast<const KT*>(k),
                  static_cast<const KT*>(v),
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(table),
                  static_cast<const int*>(rows),
                  static_cast<const int*>(pstart), static_cast<T*>(out), bq,
                  num_kv, gq, r1, s_len, page_size, scale);
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
