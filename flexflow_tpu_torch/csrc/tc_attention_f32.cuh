// Tensor-core attention tiles in float32, shared by the f32 kernels of K2
// (prefill_attention.cu), of K3's batched layout (tree_attention.cu) and
// of K1 and K3's per-token layout (row_tiles.cuh): the float32 counterpart
// of tc_attention.cuh.
//
// Products are error-compensated TF32 ("3xTF32"): each f32 operand x splits
// into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and a . b is taken as
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, three mma.sync m16n8k8 .tf32
// products into f32 accumulators, the small terms first.  Each product
// then carries about 22 of f32's 24 significant bits (the dropped lo_a .
// lo_b is 2^-22 of a . b).  An int8 cache's K and V values are exact in
// TF32 (lo = 0), so their products take two passes: lo . v + hi . v.
//
//   * A warp holds 16 folded query rows: their Q values (K2: in a shared
//     Q tile, split at each use; K3: in registers, split once into hi and
//     lo), 16 x D output accumulators and the online softmax state of the
//     lane's two rows.
//     A block call covers NTW of a block's 8-key column tiles: all four
//     (K2: each warp its own rows), or one (K3, and K1 and K3 per-token:
//     four warps on the same rows, each on its own keys, merged at the
//     end).
//   * 32-key K/V blocks arrive in a ring of shared-memory stages (K2: two,
//     beside its Q tile; the others: three) through cp.async (16-byte
//     copies; 8 bytes for an int8 row of D = 8), kept in the cache's
//     dtype; an int8 block is widened to f32 in registers as its fragments
//     load (-128..127 are exact).
//   * Fragments come from ld.shared (ldmatrix is for 16-bit types).  The k
//     index of Q.K^T (a head dim d) and of P.V (a key) is permuted within
//     each product, the same way on both operands, so a lane's values are
//     adjacent in memory: in Q.K^T lane (g, t) takes d = 8 KG s + KW t + w
//     (w < KW = 2 KG, KG = 2 for D >= 16) of k-group s, w = 2j and 2j + 1
//     being its columns t and t + 4 of k-step j: one float4 (float2 at D =
//     8); in P.V, columns t and t + 4 of a k-step are keys 2t and 2t + 1,
//     so the score tile's accumulators are P's A fragments as they stand,
//     and output column tile j = NQ u + e, column c, is d = 8 NQ u + NQ c +
//     e (NQ = 4 for D >= 32), so a lane reads NQ adjacent values of a V
//     row.  Row strides pad D so those loads hit distinct banks: Q and K
//     rows D + 16 floats (48 at D = 16, 8 at D = 8), V rows D + 4, int8
//     rows D + 16 bytes.
//   * The softmax is online, in f32, in base 2 (scores times scale * log2
//     e, then times the key's K scale for int8: the Pallas order (q . k_i8)
//     * scale * ks; K1's ALiBi bias after that), masked entries exactly
//     kNegInf and their p forced to 0; the denominator sums the unscaled
//     p; P.V takes p (int8: p * vs[key]) split like any other operand (not
//     rounded, unlike bf16's P).

#pragma once

#include "kv_access.cuh"
#include "ptx.cuh"
#include "tc_attention.cuh"

namespace ffk {
namespace tf32 {

constexpr int BN = 32;                      // keys per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static_assert(D % 8 == 0, "head dims are multiples of 8");
  static constexpr int KG = D >= 16 ? 2 : 1;    // k-steps per lane load
  static constexpr int KW = 2 * KG;             // d values per lane load
  static constexpr int NKG = D / (8 * KG);      // k-groups of Q.K^T
  static constexpr int QW = NKG * KW;           // a row's values per lane
  static constexpr int DT = D / 8;              // 8-wide output column tiles
  static constexpr int NQ = D >= 32 ? 4 : D / 8;  // V values per lane load
  static constexpr int NVG = DT / NQ;           // V loads per key row
  static constexpr int LDK = D == 8 ? 8 : (D == 16 ? 48 : D + 16);
  static constexpr int LDV = D + 4;
  static constexpr int LD8 = D + 16;            // int8 rows, bytes
  static constexpr int NT = BN / 8;             // 8-key column tiles
};

// x = hi + lo, both TF32 rounded to nearest, ties away from zero: hi =
// rna(x), lo = rna(x - hi).  Done on the integer view (the magnitude's bits
// plus 0x1000, the low 13 bits cleared), four instructions where
// cvt.rna.tf32.f32 compiles to eight with its NaN and infinity guards
// (the operands here are finite); lo keeps its low 13 bits, which the
// product ignores.  tf32_probe_kernel holds it against cvt.rna.tf32.f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// Shared-memory ring of NS stages.  A stage holds an f32 K tile [BN]
// [LDK] and V tile [BN][LDV], or int8 K [BN][LD8], V [BN][LD8], K scales
// [BN] and V scales [BN]; with F32_TOO an int8 stage is sized to hold f32
// tiles as well (the tree kernel's spec blocks, in the compute dtype).
template <typename KT, int D, bool F32_TOO, int NS>
struct Ring {
  using S = Shape<D>;
  static constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  static constexpr int F32_BYTES = BN * (S::LDK + S::LDV) * 4;
  static constexpr int I8_BYTES = 2 * BN * S::LD8 + 2 * BN * 4;
  static constexpr int STAGE =
      !KVQ ? F32_BYTES
           : (F32_TOO && F32_BYTES > I8_BYTES ? F32_BYTES : I8_BYTES);
  static_assert(STAGE % 16 == 0, "stages must keep 16-byte alignment");

  __host__ __device__ static constexpr size_t bytes() {
    return (size_t)NS * STAGE;
  }
  __device__ static unsigned char* stage(unsigned char* ring, int nb) {
    return ring + (nb % NS) * STAGE;
  }
  __device__ static float* kt(unsigned char* st) {
    return reinterpret_cast<float*>(st);
  }
  __device__ static float* vt(unsigned char* st) {
    return kt(st) + BN * S::LDK;
  }
  __device__ static int8_t* k8(unsigned char* st) {
    return reinterpret_cast<int8_t*>(st);
  }
  __device__ static int8_t* v8(unsigned char* st) {
    return k8(st) + BN * S::LD8;
  }
  __device__ static float* kscale(unsigned char* st) {
    return reinterpret_cast<float*>(st + 2 * BN * S::LD8);
  }
  __device__ static float* vscale(unsigned char* st) {
    return kscale(st) + BN;
  }
};

// Queue the copies of rows [0, valid) of an f32 K/V block (key row r at
// k + r * D) into the tiles Kt, Vt; rows [valid, BN) are zero-filled (a V
// row of zeros keeps 0 * V finite where p is 0).
template <int D>
__device__ __forceinline__ void copy_tiles(float* Kt, float* Vt,
                                           const float* k, const float* v,
                                           int valid, int tid, int nthreads) {
  using S = Shape<D>;
  constexpr int CH = D / 4;                    // 16-byte chunks per row
  for (int i = tid; i < BN * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r < valid;
    const size_t off = (size_t)(in ? r : 0) * D + c * 4;
    cp_async16(Kt + r * S::LDK + c * 4, k + off, in ? 16 : 0);
    cp_async16(Vt + r * S::LDV + c * 4, v + off, in ? 16 : 0);
  }
}

// The same for an int8 block and its scales into an int8 stage.
template <int D>
__device__ __forceinline__ void copy_rows_i8(int8_t* K8, int8_t* V8,
                                             float* Ksc, float* Vsc,
                                             const int8_t* k, const int8_t* v,
                                             const float* ks, const float* vs,
                                             int valid, int tid,
                                             int nthreads) {
  constexpr int LD8 = Shape<D>::LD8;
  if constexpr (D >= 16) {
    constexpr int CH = D / 16;
    for (int i = tid; i < BN * CH; i += nthreads) {
      const int r = i / CH, c = i % CH;
      const bool in = r < valid;
      const size_t off = (size_t)(in ? r : 0) * D + c * 16;
      cp_async16(K8 + r * LD8 + c * 16, k + off, in ? 16 : 0);
      cp_async16(V8 + r * LD8 + c * 16, v + off, in ? 16 : 0);
    }
  } else {
    for (int r = tid; r < BN; r += nthreads) {
      const bool in = r < valid;
      const size_t off = (size_t)(in ? r : 0) * D;
      cp_async8(K8 + r * LD8, k + off, in ? 8 : 0);
      cp_async8(V8 + r * LD8, v + off, in ? 8 : 0);
    }
  }
  for (int r = tid; r < BN; r += nthreads) {
    const bool in = r < valid;
    cp_async4(Ksc + r, ks + (in ? r : 0), in ? 4 : 0);
    cp_async4(Vsc + r, vs + (in ? r : 0), in ? 4 : 0);
  }
}

// Queue the copies of a Q tile's rows (stride LDK): row r's D values at
// q + off(r), or zeros where off(r) < 0.
template <int D, typename Off>
__device__ __forceinline__ void copy_q(float* Qt, int n_rows, const float* q,
                                       Off off, int tid, int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < n_rows * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const long long o = off(r);
    cp_async16(Qt + r * Shape<D>::LDK + c * 4, q + (o < 0 ? 0 : o) + c * 4,
               o < 0 ? 0 : 16);
  }
}

// Queue one block of the cache (dtype KT) into a stage of ring R.
template <typename R, typename KT, int D>
__device__ __forceinline__ void copy_block(unsigned char* st, const KT* k,
                                           const KT* v, const float* ks,
                                           const float* vs, int valid,
                                           int tid, int nthreads) {
  if constexpr (R::KVQ) {
    copy_rows_i8<D>(R::k8(st), R::v8(st), R::kscale(st), R::vscale(st), k,
                    v, ks, vs, valid, tid, nthreads);
  } else {
    copy_tiles<D>(R::kt(st), R::vt(st), k, v, valid, tid, nthreads);
  }
}

// N adjacent values of an f32 or int8 row (N in {1, 2, 4}) as f32 bit
// patterns: f32 loaded as one vector; int8 as one 4-, 2- or 1-byte word,
// widened exactly (tc::bytes_to_floats).
template <typename E, int N>
__device__ __forceinline__ void load_vals(const E* p, float (&x)[N]) {
  if constexpr (std::is_same<E, float>::value) {
    if constexpr (N == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    } else if constexpr (N == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      x[0] = f.x; x[1] = f.y;
    } else {
      x[0] = *p;
    }
  } else {
    uint32_t w;
    if constexpr (N == 4) w = *reinterpret_cast<const uint32_t*>(p);
    else if constexpr (N == 2) w = *reinterpret_cast<const uint16_t*>(p);
    else w = *reinterpret_cast<const uint8_t*>(p);
    float f[4];
    tc::bytes_to_floats(w, f);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = f[i];
  }
}

// Lane (g, t)'s KW values of k-group s of a Q row (null: zeros): d = 8 KG
// s + KW t + w.
template <int D>
__device__ __forceinline__ void load_row_group(const float* row, int s,
                                               int lane,
                                               float (&x)[Shape<D>::KW]) {
  using S = Shape<D>;
  if (row != nullptr) {
    load_vals<float, S::KW>(row + 8 * S::KG * s + S::KW * (lane & 3), x);
  } else {
#pragma unroll
    for (int w = 0; w < S::KW; ++w) x[w] = 0.f;
  }
}

// Where a warp keeps its Q values: in registers, split once into TF32 hi
// and lo (Split: 2 x D / 2 registers, none of the per-block splitting); or
// in a shared-memory Q tile, read and split at each use (Shared: no
// registers).
enum class QKeep { Split, Shared };

template <int D, QKeep KEEP>
struct QFrags;

// rows(q0, q1, lane): the lane's rows g and g + 8 (D values each; null: a
// zero row); group(kg, ...): their TF32 hi and lo values of k-group kg.
template <int D>
struct QFrags<D, QKeep::Split> {
  using S = Shape<D>;
  uint32_t h[2][S::QW], l[2][S::QW];
  __device__ __forceinline__ void rows(const float* q0, const float* q1,
                                       int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int s = 0; s < S::NKG; ++s) {
        float x[S::KW];
        load_row_group<D>(i ? q1 : q0, s, lane, x);
#pragma unroll
        for (int w = 0; w < S::KW; ++w)
          split(x[w], h[i][s * S::KW + w], l[i][s * S::KW + w]);
      }
  }
  __device__ __forceinline__ void group(int kg, int,
                                        uint32_t (&ah)[2][S::KW],
                                        uint32_t (&al)[2][S::KW]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int w = 0; w < S::KW; ++w) {
        ah[i][w] = h[i][kg * S::KW + w];
        al[i][w] = l[i][kg * S::KW + w];
      }
  }
};
template <int D>
struct QFrags<D, QKeep::Shared> {
  using S = Shape<D>;
  const float* r[2];          // rows g and g + 8 of the Q tile (LDK apart)
  __device__ __forceinline__ void rows(const float* q0, const float* q1,
                                       int) {
    r[0] = q0;
    r[1] = q1;
  }
  __device__ __forceinline__ void group(int kg, int lane,
                                        uint32_t (&ah)[2][S::KW],
                                        uint32_t (&al)[2][S::KW]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[S::KW];
      load_row_group<D>(r[i], kg, lane, x);
#pragma unroll
      for (int w = 0; w < S::KW; ++w) split(x[w], ah[i][w], al[i][w]);
    }
  }
};

// One warp's 16 query rows: Q values, output accumulators and the online
// softmax state of the lane's two rows (g and g + 8).
template <int D, QKeep KEEP>
struct Rows {
  using S = Shape<D>;
  QFrags<D, KEEP> qf;
  float o[S::DT][4];
  float m[2], l[2];

  // q0, q1: the lane's rows g and g + 8 (D values each, in global memory,
  // or for QKeep::Shared rows of the Q tile; null: a zero row)
  __device__ __forceinline__ void init(const float* q0, const float* q1,
                                       int lane) {
    qf.rows(q0, q1, lane);
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // s[n] = Q . K^T over the block's key column tile nt0 + n: Kb the K tile
  // (f32, rows of LDK) or the int8 K rows (LD8 bytes each).
  template <typename KT, int NTW>
  __device__ __forceinline__ void scores(const KT* Kb, int nt0, int lane,
                                         float (&s)[NTW][4]) const {
    constexpr bool KVQ = std::is_same<KT, int8_t>::value;
    constexpr int LD = KVQ ? S::LD8 : S::LDK;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kg = 0; kg < S::NKG; ++kg) {
      uint32_t ah[2][S::KW], al[2][S::KW];
      qf.group(kg, lane, ah, al);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        float kx[S::KW];
        load_vals<KT, S::KW>(
            Kb + ((nt0 + n) * 8 + g) * LD + 8 * S::KG * kg + S::KW * t, kx);
        uint32_t bh[S::KW], bl[S::KW];
#pragma unroll
        for (int w = 0; w < S::KW; ++w) {
          if constexpr (KVQ) bh[w] = __float_as_uint(kx[w]);
          else split(kx[w], bh[w], bl[w]);
        }
#pragma unroll
        for (int j = 0; j < S::KG; ++j) {
          const uint32_t a_h[4] = {ah[0][2 * j], ah[1][2 * j],
                                   ah[0][2 * j + 1], ah[1][2 * j + 1]};
          const uint32_t a_l[4] = {al[0][2 * j], al[1][2 * j],
                                   al[0][2 * j + 1], al[1][2 * j + 1]};
          mma_tf32(s[n], a_l, bh[2 * j], bh[2 * j + 1]);
          if constexpr (!KVQ) mma_tf32(s[n], a_h, bl[2 * j], bl[2 * j + 1]);
          mma_tf32(s[n], a_h, bh[2 * j], bh[2 * j + 1]);
        }
      }
    }
  }

  // o += P . V over the block's key column tiles nt0 + n: p[n] holds P in
  // the score tile's accumulator layout (row g: keys 2t, 2t + 1; row g + 8:
  // the same keys), which is the A fragment under the key permutation.
  // Vb the V tile (f32, rows of LDV) or the int8 V rows.
  template <typename KT, int NTW>
  __device__ __forceinline__ void pv(const KT* Vb, int nt0, int lane,
                                     const float (&p)[NTW][4]) {
    constexpr bool KVQ = std::is_same<KT, int8_t>::value;
    constexpr int LD = KVQ ? S::LD8 : S::LDV;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      uint32_t ph[4], pl[4];
      split(p[n][0], ph[0], pl[0]);
      split(p[n][2], ph[1], pl[1]);
      split(p[n][1], ph[2], pl[2]);
      split(p[n][3], ph[3], pl[3]);
      const KT* v0 = Vb + ((nt0 + n) * 8 + 2 * t) * LD + S::NQ * g;
#pragma unroll
      for (int u = 0; u < S::NVG; ++u) {
        float x0[S::NQ], x1[S::NQ];
        load_vals<KT, S::NQ>(v0 + 8 * S::NQ * u, x0);
        load_vals<KT, S::NQ>(v0 + LD + 8 * S::NQ * u, x1);
#pragma unroll
        for (int e = 0; e < S::NQ; ++e) {
          float(&acc)[4] = o[S::NQ * u + e];
          if constexpr (KVQ) {
            const uint32_t b0 = __float_as_uint(x0[e]);
            const uint32_t b1 = __float_as_uint(x1[e]);
            mma_tf32(acc, pl, b0, b1);
            mma_tf32(acc, ph, b0, b1);
          } else {
            uint32_t b0h, b0l, b1h, b1l;
            split(x0[e], b0h, b0l);
            split(x1[e], b1h, b1l);
            mma_tf32(acc, pl, b0h, b1h);
            mma_tf32(acc, ph, b0l, b1l);
            mma_tf32(acc, ph, b0h, b1h);
          }
        }
      }
    }
  }

  // One block: Kb, Vb its K and V rows in the stage (dtype KT), column
  // tiles [nt0, nt0 + NTW).  live(i, c): whether the lane's row i (0: g,
  // 1: g + 8) sees the block's key c.  ksc/vsc: the block's int8 scales,
  // or null.  scale2 = scale * log2 e.  bias(i, c): added to the score in
  // base 2 after the scales, before the mask (K1's ALiBi term).
  template <typename KT, int NTW, typename Live, typename Bias = tc::NoBias>
  __device__ __forceinline__ void attend(const KT* Kb, const KT* Vb,
                                         const float* ksc, const float* vsc,
                                         int nt0, float scale2, int lane,
                                         Live live, Bias bias = Bias()) {
    float s[NTW][4];
    scores<KT, NTW>(Kb, nt0, lane, s);
    const int t2 = (lane & 3) * 2;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = (nt0 + n) * 8 + t2 + (e & 1);
        float x = s[n][e] * scale2;
        if (ksc != nullptr) x *= ksc[c];
        if constexpr (!std::is_same<Bias, tc::NoBias>::value) x += bias(i, c);
        x = live(i, c) ? x : kNegInf;
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = (nt0 + n) * 8 + t2 + (e & 1);
        // masked entries hold exactly kNegInf: their p is 0 even when the
        // whole row is masked so far (exp2(kNegInf - kNegInf) would be 1)
        const float p = s[n][e] == kNegInf ? 0.f : exp2f(s[n][e] - m[i]);
        rs[i] += p;
        s[n][e] = vsc != nullptr ? p * vsc[c] : p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    pv<KT, NTW>(Vb, nt0, lane, s);
  }

  // the row sums over the lane's quad (each lane summed its own columns)
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }

  // The lane's output values of its row i (0: g, 1: g + 8) times mul,
  // into the D-float row dst: for each NQ column tiles, 2 NQ adjacent
  // values from d = 8 NQ u + 2 NQ t.
  __device__ __forceinline__ void store_row(int i, int lane, float* dst,
                                            float mul) const {
    const int t = lane & 3;
#pragma unroll
    for (int u = 0; u < S::NVG; ++u) {
      float x[2 * S::NQ];
#pragma unroll
      for (int e = 0; e < S::NQ; ++e) {
        x[e] = o[S::NQ * u + e][2 * i] * mul;
        x[S::NQ + e] = o[S::NQ * u + e][2 * i + 1] * mul;
      }
      float* p = dst + 8 * S::NQ * u + 2 * S::NQ * t;
      if constexpr (S::NQ == 1) {
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
      } else {
#pragma unroll
        for (int h = 0; h < S::NQ / 2; ++h)
          *reinterpret_cast<float4*>(p + 4 * h) =
              make_float4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
      }
    }
  }
};

}  // namespace tf32
}  // namespace ffk
