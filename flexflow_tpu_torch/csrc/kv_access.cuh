// Device helpers shared by the attention kernels (decode_attention.cu,
// prefill_attention.cu, tree_attention.cu): the addressing of a head's key
// rows through an optional page table, the merge of split-KV partials, and
// the host-side dispatch from runtime arguments to template instantiations.
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
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// (int8 cache?, paged cache?)
template <typename F>
cudaError_t with_variant(bool kvq, bool paged, F&& f) {
  if (kvq) return paged ? f(Bool<true>{}, Bool<true>{})
                        : f(Bool<true>{}, Bool<false>{});
  return paged ? f(Bool<false>{}, Bool<true>{})
               : f(Bool<false>{}, Bool<false>{});
}

}  // namespace ffk
