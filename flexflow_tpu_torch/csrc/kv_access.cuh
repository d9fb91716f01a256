// Device helpers shared by the attention kernels (decode_attention.cu,
// prefill_attention.cu, tree_attention.cu): vector loads of cache rows in
// float, bfloat16 or int8 with their conversion to f32 in registers, the
// addressing of a head's key rows through an optional page table, the
// merge of split-KV partials, and the host-side dispatch from runtime
// arguments to template instantiations.
//
// Cache layout: K and V are [R+1, KV, S, D]; an int8 cache carries f32
// dequant scales [R+1, KV, S] beside it (one per key vector); a paged cache
// reinterprets each row's S positions as S/page pages, and logical key j of
// row r lives at physical row pid / ppr, position (pid % ppr) * page +
// j % page, where pid = table[r, j / page] and ppr = S / page (the Pallas
// kernels' _page_coords, flexflow_tpu/ops/pallas/attention.py:88).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ffk {

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

// the signed byte b of word w, as f32 (exact)
__device__ __forceinline__ float byte_to_float(uint32_t w, int b) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * b)) >> 24);
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

// VEC consecutive elements of type E held as raw words: 8 bytes, or a
// whole number of 16-byte vectors (one load instruction each).
template <typename E, int VEC>
struct Vec {
  static constexpr int BYTES = VEC * static_cast<int>(sizeof(E));
  static constexpr int WORDS = BYTES >= 16 ? BYTES / 16 : 1;
  static constexpr int PER_WORD = 16 / static_cast<int>(sizeof(E));
  static_assert(BYTES == 8 || BYTES % 16 == 0,
                "a vector is 8 bytes or whole 16-byte words");
  uint4 w[WORDS];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (BYTES == 8) {
      const uint2 h = *reinterpret_cast<const uint2*>(p);
      w[0] = make_uint4(h.x, h.y, 0u, 0u);
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) w[i] = load16(p + i * PER_WORD);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void to_float(float* out) const {
    if constexpr (std::is_same<E, int8_t>::value) {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const uint4& v = w[i / 4];
        const uint32_t word =
            (i % 4 == 0) ? v.x : (i % 4 == 1) ? v.y : (i % 4 == 2) ? v.z : v.w;
#pragma unroll
        for (int b = 0; b < 4; ++b) out[4 * i + b] = byte_to_float(word, b);
      }
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i)
        vec_to_float<E>(w[i], out + i * PER_WORD);
    }
  }
};

// Elements per lane for a key row read by a group of D / VEC lanes: one
// 16-byte vector of the compute dtype, or for int8 caches 16 values (a
// 16-byte load) where the group's registers allow it, else 8 (an 8-byte
// load): with more than 2 query heads per KV head, 16 values per lane
// would double the lane's q and accumulator registers.
template <typename T, typename KT, int D, int GQ>
__host__ __device__ constexpr int kv_vec() {
  return sizeof(KT) == 1 ? ((GQ <= 2 && D >= 16) ? 16 : 8)
                         : 16 / static_cast<int>(sizeof(T));
}

// The key rows of one (cache row, KV head): key(j) is the index, in key
// rows of the [R+1, KV, S] plane, of logical key j; the K/V element offset
// is key(j) * D and the scale's is key(j).  Contiguous: key(j) = j from a
// base at the head's row.  Paged: the page of j is translated through the
// table once and cached until a key past that page is asked for, so a
// caller that walks keys upward translates once per page.
template <bool PAGED>
struct KeyRows {
  const int* trow;   // this row's page table entries (paged only)
  int ppr, page, num_kv, h, s_len;
  long long delta;   // key(j) = delta + j within the cached page
  int pg_end;        // first logical key past the cached page

  __device__ __forceinline__ KeyRows(const int* table, int row, int num_kv_,
                                     int h_, int s_len_, int page_) {
    if constexpr (PAGED) {
      ppr = s_len_ / page_;
      trow = table + static_cast<size_t>(row) * ppr;
      page = page_;
      num_kv = num_kv_;
      h = h_;
      s_len = s_len_;
      delta = 0;
      pg_end = 0;
    }
  }
  __device__ __forceinline__ size_t key(int j) {
    if constexpr (!PAGED) {
      return static_cast<size_t>(j);
    } else {
      if (j >= pg_end) {
        const int pg = j / page;
        const int pid = trow[pg];
        delta = (static_cast<long long>(pid / ppr) * num_kv + h) * s_len +
                static_cast<long long>(pid % ppr) * page -
                static_cast<long long>(pg) * page;
        pg_end = (pg + 1) * page;
      }
      return static_cast<size_t>(delta + j);
    }
  }
};

// base offset (in key rows) that KeyRows<PAGED>::key is relative to: the
// head's row of the plane when contiguous, the plane's start when paged
template <bool PAGED>
__device__ __forceinline__ size_t head_keys(int row, int num_kv, int h,
                                            int s_len) {
  return PAGED ? 0 : (static_cast<size_t>(row) * num_kv + h) * s_len;
}

// ---------------------------------------------------------------------------
// split-KV partials
// ---------------------------------------------------------------------------
// scratch holds f32 (m, l) pairs [n_split][total], then acc [n_split]
// [total][D], total = n_req * num_kv * m_rows rows in (request or tile, kv
// head, folded row) order, m in base 2 (scores times log2 e).  One warp
// per row (kMergeRows rows a CTA, lanes over D <= 128) combines the row's
// partials in split order, weighting one by exp2(m_i - m) and skipping one
// with m_i = kNegInf (no live key), so a row with no live key gives zeros,
// into out [n_req][m_rows / gq][num_kv * gq][D] in T.
constexpr int kMergeRows = 4;

template <typename T>
__device__ __forceinline__ void merge_split_row(
    const float* __restrict__ scratch, T* __restrict__ out, int n_req,
    int p_tok, int num_kv, int gq, int d_head, int n_split) {
  const int m_rows = p_tok * gq;
  const size_t total = (size_t)n_req * num_kv * m_rows;
  const size_t r = (size_t)blockIdx.x * kMergeRows + threadIdx.x / 32;
  if (r >= total) return;
  const int lane = threadIdx.x & 31;
  const float2* part_ml = reinterpret_cast<const float2*>(scratch);
  const float* part_acc = scratch + 2 * (size_t)n_split * total;
  float mx = kNegInf;
  for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, part_ml[j * total + r].x);
  float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};   // d = lane + 32 * e
  for (int j = 0; j < n_split; ++j) {
    const float2 ml = part_ml[j * total + r];
    if (ml.x == kNegInf) continue;       // no live key in this split
    const float w = exp2f(ml.x - mx);
    lsum = fmaf(ml.y, w, lsum);
    const float* ap = part_acc + (j * total + r) * d_head;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (lane + 32 * e < d_head) o[e] = fmaf(ap[lane + 32 * e], w, o[e]);
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  const int mg = r % m_rows;
  const int h = (r / m_rows) % num_kv;
  const int req = r / ((size_t)m_rows * num_kv);
  T* op = out + (((size_t)req * p_tok + mg / gq) * num_kv * gq + h * gq +
                 mg % gq) * d_head;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (lane + 32 * e < d_head) op[lane + 32 * e] = from_float<T>(o[e] * inv);
}

// ---------------------------------------------------------------------------
// host-side dispatch: runtime arguments -> template arguments
// ---------------------------------------------------------------------------
template <typename X>
struct Type {
  using type = X;
};
template <int N>
using Int = std::integral_constant<int, N>;
template <bool B>
using Bool = std::integral_constant<bool, B>;

template <typename F>
cudaError_t with_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(Type<float>{});
  if (dtype == 1) return f(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_group(int gq, F&& f) {
  switch (gq) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 4: return f(Int<4>{});
    case 8: return f(Int<8>{});
    default: return cudaErrorInvalidValue;
  }
}

// (int8 cache?, paged cache?)
template <typename F>
cudaError_t with_variant(bool kvq, bool paged, F&& f) {
  if (kvq) return paged ? f(Bool<true>{}, Bool<true>{})
                        : f(Bool<true>{}, Bool<false>{});
  return paged ? f(Bool<false>{}, Bool<true>{})
               : f(Bool<false>{}, Bool<false>{});
}

}  // namespace ffk
