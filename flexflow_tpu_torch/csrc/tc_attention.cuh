// Tensor-core attention tiles shared by the bf16 kernels: prefill
// (prefill_attention.cu), the batched tree layout (tree_attention.cu), and
// K1 and K3's per-token layout (row_tiles.cuh).
//
// A CTA holds up to 16 * NW folded query rows of one KV head, 16 rows per
// warp, and walks 64-key blocks of K/V:
//   * the blocks arrive in a ring of two shared-memory stages through
//     cp.async (16-byte copies; 8 bytes for an int8 row of D = 8), so block
//     n + 1 is in flight while block n computes; a stage holds the block in
//     the cache's dtype: a bf16 K tile and V tile, or int8 K and V rows with
//     their 64 K and 64 V scales, which the CTA widens to bf16 tiles after
//     they land (-128..127 are exact in bf16);
//   * tiles are rows of D bf16 padded by 16 bytes, so ldmatrix's eight row
//     addresses fall in eight distinct bank groups (D = 8: Q and K rows
//     carry 8 zero columns more, the k extent of one mma, written with
//     every block since an int8 stage may have held other bytes there);
//   * S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with f32
//     accumulators; each warp keeps its 16 rows' Q fragments, 16 x D output
//     accumulators and softmax state in registers;
//   * the softmax is online, in f32, in base 2 (scores times scale * log2 e,
//     then times the key's K scale for int8: the Pallas order (q . k_i8) *
//     scale * ks), masked entries exactly kNegInf and their p forced to 0;
//     the denominator sums the unscaled p, P.V takes p (int8: p * vs[key])
//     rounded to bf16, since it is the A operand of the second product. The
//     score tile's accumulator fragments are that operand's fragments, so P
//     never leaves registers.

#pragma once

#include "kv_access.cuh"
#include "ptx.cuh"

namespace ffk {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;                      // keys per block
constexpr int kStages = 2;                  // ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int DK = D < 16 ? 16 : D;   // k extent of Q.K^T
  static constexpr int LD = DK + 8;            // tile row stride, bf16
  static constexpr int KSTEPS = DK / 16;
  static constexpr int DT = D / 8;             // 8-wide output column tiles
  static constexpr int TILE = BN * LD;         // elements of a K or V tile
};

// Shared-memory layout of a CTA with Q rows: [Q tile][stage 0][stage 1]
// [int8 only: the widened K and V tiles].  A stage holds a bf16 K tile and
// V tile, or int8 K [BN][D], V [BN][D], K scales [BN] and V scales [BN];
// with BF16_TOO an int8 stage is sized to hold bf16 tiles as well (the
// tree kernels' spec blocks, which are in the compute dtype).
template <typename KT, int D, bool BF16_TOO>
struct Ring {
  using S = Shape<D>;
  static constexpr bool KVQ = std::is_same<KT, int8_t>::value;
  static constexpr int TILES_BYTES = 2 * S::TILE * 2;
  static constexpr int I8_BYTES = 2 * BN * D + 2 * BN * 4;
  static constexpr int STAGE =
      !KVQ ? TILES_BYTES
           : (BF16_TOO && TILES_BYTES > I8_BYTES ? TILES_BYTES : I8_BYTES);
  static_assert(STAGE % 16 == 0, "stages must keep 16-byte alignment");

  __host__ __device__ static constexpr size_t bytes(int q_rows) {
    return (size_t)q_rows * S::LD * 2 + (size_t)kStages * STAGE +
           (KVQ ? TILES_BYTES : 0);
  }
  __device__ static unsigned char* stage(unsigned char* ring, int nb) {
    return ring + (nb % kStages) * STAGE;
  }
  // the widened tiles, after the stages
  __device__ static bf16* wide(unsigned char* ring) {
    return reinterpret_cast<bf16*>(ring + kStages * STAGE);
  }
  __device__ static int8_t* k8(unsigned char* st) {
    return reinterpret_cast<int8_t*>(st);
  }
  __device__ static int8_t* v8(unsigned char* st) { return k8(st) + BN * D; }
  __device__ static float* kscale(unsigned char* st) {
    return reinterpret_cast<float*>(st + 2 * BN * D);
  }
  __device__ static float* vscale(unsigned char* st) {
    return kscale(st) + BN;
  }
};

// Queue the copies of rows [0, valid) of a bf16 K/V block (key row r at
// k + r * D) into the tiles Kt, Vt; rows [valid, BN) are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tiles(bf16* Kt, bf16* Vt, const bf16* k,
                                           const bf16* v, int valid, int tid,
                                           int nthreads) {
  constexpr int CH = D / 8;                    // 16-byte chunks per row
  constexpr int LD = Shape<D>::LD;
  for (int i = tid; i < BN * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r < valid;
    const size_t off = (size_t)(in ? r : 0) * D + c * 8;
    cp_async16(Kt + r * LD + c * 8, k + off, in ? 16 : 0);
    cp_async16(Vt + r * LD + c * 8, v + off, in ? 16 : 0);
    // D = 8: zero the padding columns 8..15, the k extent of one mma
    if constexpr (D < 16) cp_async16(Kt + r * LD + 8, k, 0);
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
  if constexpr (D >= 16) {
    constexpr int CH = D / 16;
    for (int i = tid; i < BN * CH; i += nthreads) {
      const int r = i / CH, c = i % CH;
      const bool in = r < valid;
      const size_t off = (size_t)(in ? r : 0) * D + c * 16;
      cp_async16(K8 + r * D + c * 16, k + off, in ? 16 : 0);
      cp_async16(V8 + r * D + c * 16, v + off, in ? 16 : 0);
    }
  } else {
    for (int r = tid; r < BN; r += nthreads) {
      const bool in = r < valid;
      const size_t off = (size_t)(in ? r : 0) * D;
      cp_async8(K8 + r * D, k + off, in ? 8 : 0);
      cp_async8(V8 + r * D, v + off, in ? 8 : 0);
    }
  }
  for (int r = tid; r < BN; r += nthreads) {
    const bool in = r < valid;
    cp_async4(Ksc + r, ks + (in ? r : 0), in ? 4 : 0);
    cp_async4(Vsc + r, vs + (in ? r : 0), in ? 4 : 0);
  }
}

// Queue one block of the cache (dtype KT) into a stage of the ring.
template <typename KT, int D, bool BF16_TOO>
__device__ __forceinline__ void copy_block(unsigned char* st, const KT* k,
                                           const KT* v, const float* ks,
                                           const float* vs, int valid,
                                           int tid, int nthreads) {
  using R = Ring<KT, D, BF16_TOO>;
  if constexpr (R::KVQ) {
    copy_rows_i8<D>(R::k8(st), R::v8(st), R::kscale(st), R::vscale(st), k,
                    v, ks, vs, valid, tid, nthreads);
  } else {
    bf16* Kt = reinterpret_cast<bf16*>(st);
    copy_tiles<D>(Kt, Kt + Shape<D>::TILE, k, v, valid, tid, nthreads);
  }
}

// Four signed bytes of w as floats, exactly: each byte biased to unsigned
// (xor 0x80) is spliced under the exponent of 2^23, and 2^23 + 128 taken
// off; a byte permute and an FADD in place of the slower int-to-float
// conversion.
__device__ __forceinline__ void bytes_to_floats(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Widen a landed int8 stage into the bf16 tiles Kt, Vt (exact).
template <int D>
__device__ __forceinline__ void widen_i8(const int8_t* K8, const int8_t* V8,
                                         bf16* Kt, bf16* Vt, int tid,
                                         int nthreads) {
  constexpr int CH = D / 8;                    // 8-value chunks per row
  constexpr int LD = Shape<D>::LD;
  for (int i = tid; i < 2 * BN * CH; i += nthreads) {
    const int t = i / (BN * CH), j = i % (BN * CH);
    const int r = j / CH, c = j % CH;
    const uint2 w = *reinterpret_cast<const uint2*>((t ? V8 : K8) + r * D +
                                                    c * 8);
    float lo[4], hi[4];
    bytes_to_floats(w.x, lo);
    bytes_to_floats(w.y, hi);
    uint4 o;
    o.x = pack_bf16(lo[0], lo[1]);
    o.y = pack_bf16(lo[2], lo[3]);
    o.z = pack_bf16(hi[0], hi[1]);
    o.w = pack_bf16(hi[2], hi[3]);
    *reinterpret_cast<uint4*>((t ? Vt : Kt) + r * LD + c * 8) = o;
    if constexpr (D < 16)    // the padding columns, as copy_tiles
      if (!t) *reinterpret_cast<uint4*>(Kt + r * LD + 8) = make_uint4(0, 0, 0, 0);
  }
}

// Queue the copies of a Q tile's rows: row r's D values at q + off(r), or
// zeros where off(r) < 0.
template <int D, typename Off>
__device__ __forceinline__ void copy_q(bf16* Qt, int n_rows, const bf16* q,
                                       Off off, int tid, int nthreads) {
  constexpr int CH = D / 8;
  constexpr int LD = Shape<D>::LD;
  for (int i = tid; i < n_rows * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const long long o = off(r);
    cp_async16(Qt + r * LD + c * 8, q + (o < 0 ? 0 : o) + c * 8,
               o < 0 ? 0 : 16);
    if constexpr (D < 16) cp_async16(Qt + r * LD + 8, q, 0);
  }
}

// The score bias of tiles without one (the compiler drops its addition).
struct NoBias {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// One warp's 16 query rows: Q fragments, output accumulators and the
// online softmax state of the lane's two rows (g and g + 8).
template <int D>
struct Rows {
  using S = Shape<D>;
  uint32_t qa[S::KSTEPS][4];
  float o[S::DT][4];
  float m[2], l[2];

  // rows [16 * warp, 16 * warp + 16) of the Q tile
  __device__ __forceinline__ void init(const bf16* Qt, int warp, int lane) {
    const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int ks = 0; ks < S::KSTEPS; ++ks)
      ldsm_x4(qa[ks], Qt + r * S::LD + ks * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // The same from global memory: q0, q1 the lane's rows g and g + 8 (D
  // values each, null: a zero row), read in the A fragment's layout.
  __device__ __forceinline__ void init_rows(const bf16* q0, const bf16* q1,
                                            int lane) {
    const int c = (lane & 3) * 2;
    auto pair = [&](const bf16* r, int col) -> uint32_t {
      return r != nullptr && col < D
                 ? *reinterpret_cast<const uint32_t*>(r + col)
                 : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < S::KSTEPS; ++ks) {
      qa[ks][0] = pair(q0, ks * 16 + c);
      qa[ks][1] = pair(q1, ks * 16 + c);
      qa[ks][2] = pair(q0, ks * 16 + 8 + c);
      qa[ks][3] = pair(q1, ks * 16 + 8 + c);
    }
#pragma unroll
    for (int dt = 0; dt < S::DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // One 64-key block from the bf16 tiles Kt, Vt.  live(i, c): whether the
  // lane's row i (0: g, 1: g + 8) sees the block's key c.  ksc/vsc: the
  // block's int8 scales, or null.  scale2 = scale * log2 e.  bias(i, c):
  // added to the score in base 2 after the scales, before the mask (K1's
  // ALiBi term).
  template <typename Live, typename Bias = NoBias>
  __device__ __forceinline__ void attend(const bf16* Kt, const bf16* Vt,
                                         const float* ksc, const float* vsc,
                                         float scale2, int lane, Live live,
                                         Bias bias = Bias()) {
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // S = Q . K^T: per k-step, four ldmatrix.x4 give the B fragments of two
    // 8-key column tiles each
#pragma unroll
    for (int ks = 0; ks < S::KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * S::LD
                       + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    const int t2 = (lane & 3) * 2;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + t2 + (e & 1);
        float x = s[nt][e] * scale2;
        if (ksc != nullptr) x *= ksc[c];
        if constexpr (!std::is_same<Bias, NoBias>::value) x += bias(i, c);
        x = live(i, c) ? x : kNegInf;
        s[nt][e] = x;
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
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + t2 + (e & 1);
        // masked entries hold exactly kNegInf: their p is 0 even when the
        // whole row is masked so far (exp2(kNegInf - kNegInf) would be 1)
        const float p = s[nt][e] == kNegInf ? 0.f : exp2f(s[nt][e] - m[i]);
        rs[i] += p;
        pv[e] = vsc != nullptr ? p * vsc[c] : p;
      }
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
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
    // O += P . V: per 16-key step, ldmatrix.trans gives the B fragments of
    // two 8-column output tiles (one for D = 8)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* vrow =
          Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LD;
      if constexpr (S::DT == 1) {
        uint32_t b[2];
        ldsm_x2_trans(b, vrow);
        mma_bf16(o[0], pa[kk], b[0], b[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < S::DT / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, vrow + dp * 16 + ((lane >> 4) & 1) * 8);
          mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
        }
      }
    }
  }

  // the row sums over the lane's quad (each lane summed its own columns)
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// Raise a kernel's dynamic shared-memory limit, once per kernel.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

}  // namespace tc
}  // namespace ffk
