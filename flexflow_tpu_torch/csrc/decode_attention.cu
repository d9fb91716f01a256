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
//   * the flat tokens are grouped by cache row on the device
//     (row_tiles.cuh: decode_plan_kernel) and each row's folded (token,
//     query head) rows cut into chunks (bf16 64, f32 16), so one pass over
//     a block of K/V serves every token and query head of the chunk as a
//     tensor-core product (a group of 48 query heads reads its prefix
//     once per split in bf16, three times in f32, from L2 after the first;
//     an ALiBi prefill of 512 tokens of one request reads it once per
//     chunk, each chunk only up to its last position).  Split-KV: the
//     prefix is cut into the splits of tree_split_plan(S), one CTA each,
//     so a deep row spreads over up to S / 256 CTAs; a row that stays in
//     one split is written by it, the others merged by the last split CTA
//     of their chunk to finish.  Pad tokens (pos 0 on the scratch row)
//     share chunks reading one key;
//   * bfloat16 (decode_split_kernel): mma.sync bf16 products over 64-key
//     blocks, Q fragments straight from global memory, so with a two-stage
//     cp.async ring three CTAs fit an SM (one warp computes a decode chunk:
//     resident CTAs bound the blocks in flight);
//   * float32 (decode_split_tf32_kernel): error-compensated TF32 on the
//     tensor cores (tc_attention_f32.cuh: three mma.sync m16n8k8 passes on
//     the operands' TF32 hi and lo parts, two for an int8 cache's exact
//     values, P kept in f32), 32-key blocks in a three-stage cp.async ring;
//     the four warps of a CTA hold the same 16 rows, each on one 8-key
//     column tile of every block, merged in the CTA before it writes.  A
//     decode chunk holds one live row of the m16 tile, so the mma count is
//     16x the useful work; at the 7B shape that is ~6 GFLOP of passes,
//     under the bytes bound at mma.sync's TF32 rate;
//   * paged: a block translates its page through the table once (pages
//     hold whole 64-key blocks); keys are visited in the same order and
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

// the row-grouped split-KV kernels (row_tiles.cuh); the plan's chunks hold
// TILE folded rows (bf16 rt::BMR, f32 rt::kTfRows)
template <int TILE>
__global__ void __launch_bounds__(32 * rt::kPlanWarps)
decode_plan_kernel(rt::Args a) {
  extern __shared__ int rt_counts[];
  rt::plan_body<false, TILE>(a, rt_counts);
}

template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(
    rt::kThreads, (rt::Tiles<KT, D, false>::kMinCtas))
decode_split_kernel(rt::Args a) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  rt::split_body<KT, D, PAGED, false>(a, rt_smem);
}

template <typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(rt::kThreads, 2)
decode_split_tf32_kernel(rt::Args a) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  rt::split_tf32_body<KT, D, PAGED, false>(a, rt_smem);
}

}  // namespace

// q [n_tokens, num_kv*gq, D]; k, v [r1, num_kv, s_len, D] in q's dtype, or
// int8 with k_scale, v_scale f32 [r1, num_kv, s_len] (null: fp cache);
// table int32 [r1, s_len / page_size] (null: slot-contiguous); slopes f32
// [num_kv*gq] (null: no ALiBi); rows, pos int32[n_tokens]; out
// [n_tokens, num_kv*gq, D]; scratch f32 [n_split * n_tokens * num_kv*gq *
// (D + 2)]; plan int32 [round_up(2 * n_tokens, 4) + (4 + num_kv) * cap]
// with cap = ceil(n_tokens * gq / tile) + r1 (tile 64 for bfloat16, 16 for
// float32); the split plan (n_split splits of split_blocks 64-key blocks
// covering s_len; a paged table: page_size a multiple of 64 dividing
// s_len).  dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous.
extern "C" int ff_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* slopes,
    const void* rows, const void* pos, void* scratch, void* plan, void* out,
    int n_tokens, int num_kv, int gq, int r1, int s_len, int head_dim,
    int page_size, int n_split, int split_blocks, int cap, float scale,
    int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  if (scratch == nullptr || plan == nullptr || n_split < 1 ||
      split_blocks < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rt::Args a{
      q, k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const float*>(slopes), nullptr, nullptr, nullptr,
      static_cast<const int*>(rows), static_cast<const int*>(pos),
      static_cast<int*>(plan), static_cast<float*>(scratch), out, n_tokens,
      num_kv, gq, r1, s_len, 0, page_size, n_split, split_blocks, cap,
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
          return rt::launch<decode_plan_kernel<rt::kTfRows>,
                            decode_split_tf32_kernel<KT, D, PAGED>>(
              a, rt::TfTiles<KT, D, false>::bytes, st);
        else
          return rt::launch<decode_plan_kernel<rt::BMR>,
                            decode_split_kernel<KT, D, PAGED>>(
              a, rt::Tiles<KT, D, false>::bytes, st);
      });
    });
  });
  return static_cast<int>(err);
}
