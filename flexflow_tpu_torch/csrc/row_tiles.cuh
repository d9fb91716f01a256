// Split-KV tensor-core attention of flat tokens grouped by cache row: the
// kernels of K1 (decode_attention.cu) and of K3's per-token layout
// (tree_attention.cu), in bf16 and in float32.
//
// Flat tokens come in any order, each with its own cache row, key limit
// (K1: keys <= clamp(pos, 0, S - 1); K3: committed keys < clamp(clens, 0,
// S), then the spec segment under the token's ancestor mask) and, for K1
// with ALiBi, its own position.  Two kernels, launched back to back on one
// stream, with nothing read back to the host and grids fixed by shapes:
//
//   1. plan (one CTA): sorts the tokens by clamped cache row, stably
//      (token index ascending within a row), and cuts each row's folded
//      rows (token, query head of the group; folded index token * gq + g)
//      into chunks of at most TILE rows (bf16: BMR = 64; f32: kTfRows =
//      16).  It writes perm[T] (sorted slot -> token), each sorted slot's
//      key limit, a chunk table of `cap` entries (folded start, row count,
//      the rows' largest key limit, cache row; unused ones with count 0,
//      so a split CTA with no work exits after one 16-byte load) and zeroes
//      the split kernel's per-(chunk, KV head) arrival counters.  cap =
//      ceil(T * gq / TILE) + R1 bounds the chunks of any grouping: each of
//      at most R1 rows adds at most one part chunk.  The tokens' rows and
//      limits are staged in shared memory; each of eight warps ranks its
//      own run of tokens, 32 at a time with __match_any_sync (peers on one
//      row rank by lane), and the runs' counts are summed per row in warp
//      order, so the sort is stable;
//   2. split (grid n_split x KV x cap, four warps), in one of two bodies:
//      * bf16 (split_body): a CTA holds one chunk's rows, 16 per warp
//        (warps past the chunk's rows only copy), and walks 64-key blocks
//        of its cache row through tc_attention.cuh's tiles (mma.sync bf16
//        products, f32 online softmax in base 2, P rounded to bf16 before
//        P.V), its Q fragments loaded straight from global memory and its
//        first block requested before its rows are read, the blocks through
//        a two-stage cp.async ring in the cache's dtype; with no Q tile,
//        three CTAs fit an SM where the ring allows (all but K3 int8 at D
//        128, whose stages also hold bf16 spec tiles): one warp computes
//        per decode chunk, so resident CTAs, not stages, bound how many
//        blocks are in flight;
//      * float32 (split_tf32_body): a CTA holds one chunk of 16 rows, and
//        its four warps all hold them (Q split once into TF32 hi and lo in
//        registers), each warp on one 8-key column tile of every 32-key
//        block, through tc_attention_f32.cuh's error-compensated TF32
//        tiles (three mma.sync m16n8k8 passes, two for an int8 cache; P
//        kept in f32) fed by a three-stage cp.async ring (K3's f32 spec
//        tiles share it beside an int8 cache); the CTA merges the four
//        warps' states in shared memory (the ring, free by then), in warp
//        order, before it writes: 16 rows, not 64, since a decode chunk
//        holds one live row and the m16 tile is the smallest a TF32 mma
//        takes, and four warps on one chunk keep the copies of one split
//        in flight as the bf16 body's resident CTAs do.
//      The committed keys are cut into the splits of `split_blocks` 64-key
//      blocks that the wrapper's plan gives (tree_split_plan(S); f32's
//      32-key blocks nest in them); a CTA reads the blocks of its split
//      below its chunk's largest key limit, and none past it, so the causal
//      frontier bounds the bytes per chunk; K3's last split also takes the
//      spec blocks.  Each row sees only its own keys (K1's ALiBi bias slope
//      * (key - pos) joins the score in base 2, after the scale and the
//      int8 K scale, before the mask).  A row whose live keys all lie in
//      one split has that split's CTA write its output (bf16, or f32
//      without a rounding); any other row leaves an f32 partial (m, l,
//      acc[D]) per split holding one of its live keys (acc only where m is
//      finite), and the last CTA of its (chunk, KV head) to arrive (a
//      counter, after a fence) merges them in split order, weighting each
//      by exp2(m_j - m) and skipping m_j = kNegInf (a K3 row whose last
//      split saw no live key): first a thread per row finds the weights,
//      then a thread per (row, 4 columns) sums the partials, so a 64-row
//      chunk (48 or 71 query heads of one token) merges in a few memory
//      round trips.
//
// A row's result does not depend on the chunk it shares or on which CTA
// merges it: blocks past its own limit are masked for it (p = 0, the state
// unchanged), the split boundaries come from S alone and the merge orders
// (warps, splits) are fixed, so a paged cache (a block never straddles a
// page; pages hold whole 64-key blocks) gives the contiguous cache's bits.

#pragma once

#include "tc_attention.cuh"
#include "tc_attention_f32.cuh"

namespace ffk {
namespace rt {

using tc::bf16;
constexpr int BMR = 64;            // bf16: folded rows per chunk, 4 warps x 16
constexpr int kTfRows = 16;        // f32: folded rows per chunk
constexpr int kTfStages = 3;       // f32: ring depth
constexpr int kThreads = 128;      // split kernel
constexpr int kPlanWarps = 8;      // plan kernel

// q, sk, sv and out are in the compute dtype (bf16 or f32)
struct Args {
  const void* q;             // [T, QH, D]
  const void* k;             // [R1, KV, S, D] bf16 or int8
  const void* v;
  const float* ks;           // int8 scales [R1, KV, S] (null: fp cache)
  const float* vs;
  const int* table;          // page table [R1, S / page] (null: contiguous)
  const float* slopes;       // K1: ALiBi slopes [QH] (null: none)
  const void* sk;            // K3: spec buffers [R1, KV, P, D]
  const void* sv;
  const uint8_t* amask;      // K3: ancestor mask [T, P]
  const int* rows;           // [T]
  const int* lens;           // K1: positions; K3: committed lengths [T]
  int* plan;                 // see chunk_table
  float* scratch;            // (m, l) [n_split, T * QH], acc [.., D]
  void* out;                 // [T, QH, D]
  int n_tokens, num_kv, gq, r1, s_len, p_len, page;
  int n_split, split_blocks, cap;
  float scale;
};

// a row's key limit: K1 keys [0, clamp(pos) + 1), K3 committed [0, clens)
template <bool TREE>
__device__ __forceinline__ int key_limit(int len, int s_len) {
  return TREE ? min(max(len, 0), s_len) : min(max(len, 0), s_len - 1) + 1;
}

// the committed splits that hold a key below the limit lim
__device__ __forceinline__ int live_splits(int lim, const Args& a) {
  const int sbk = a.split_blocks * tc::BN;
  return min((lim + sbk - 1) / sbk, a.n_split);
}

// the jj-th split of a row whose committed keys span nsc splits: [0, nsc),
// then (K3) the last split
__device__ __forceinline__ int split_of(int jj, int nsc, const Args& a) {
  return jj < nsc ? jj : a.n_split - 1;
}

// whether all of a row's live keys lie in one split (K3: the last split
// also holds the spec keys)
template <bool TREE>
__device__ __forceinline__ bool one_split(int nsc, int n_split) {
  return TREE ? (nsc == 0 || n_split == 1) : nsc == 1;
}

// The plan buffer, in ints: perm [T], key limits [T] (both by sorted
// slot), then (16-byte aligned) the chunk table int4 [cap], then the
// arrival counters [cap * KV].
__host__ __device__ constexpr int chunk_table(int n_tokens) {
  return (2 * n_tokens + 3) / 4 * 4;
}

// the splits that run for a chunk (or row) whose committed keys span nsp
// splits: those, and (K3) the last, which takes the spec keys
template <bool TREE>
__device__ __forceinline__ int splits_run(int nsp, int n_split) {
  return TREE && nsp < n_split ? nsp + 1 : nsp;
}

// ---------------------------------------------------------------------------
// 1. plan: one CTA of kPlanWarps warps; sm: plan_smem_ints ints
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t plan_smem_ints(int n_tokens, int r1,
                                                    int cap) {
  return 3 * (size_t)n_tokens + (kPlanWarps + 3) * (size_t)r1 + cap;
}

template <bool TREE, int TILE>
__device__ __forceinline__ void plan_body(const Args& a, int* sm) {
  __shared__ int s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tok = a.n_tokens, r1 = a.r1, nt = blockDim.x;
  // each warp's run of tokens, a whole number of 32-token tiles
  const int run = (n_tok + 32 * kPlanWarps - 1) / (32 * kPlanWarps) * 32;
  int* srow = sm;                    // token -> clamped cache row
  int* slim = srow + n_tok;          // token -> key limit
  int* srank = slim + n_tok;         // token -> rank within its run and row
  int* wcnt = srank + n_tok;         // [warp][row]: tokens, then run base
  int* cnt = wcnt + kPlanWarps * r1; // tokens per row
  int* off = cnt + r1;               // first sorted slot of each row
  int* cst = off + r1;               // first chunk of each row
  int* clim = cst + r1;              // chunk -> largest key limit
  int* perm = a.plan;                // sorted slot -> token
  int* plim = perm + n_tok;          // sorted slot -> key limit
  int4* chunks = reinterpret_cast<int4*>(a.plan + chunk_table(n_tok));
  int* arrived = reinterpret_cast<int*>(chunks + a.cap);
  for (int t = tid; t < n_tok; t += nt) {
    srow[t] = min(max(a.rows[t], 0), r1 - 1);
    slim[t] = key_limit<TREE>(a.lens[t], a.s_len);
  }
  for (int i = tid; i < kPlanWarps * r1; i += nt) wcnt[i] = 0;
  for (int c = tid; c < a.cap; c += nt) clim[c] = 0;
  for (int c = tid; c < a.cap * a.num_kv; c += nt) arrived[c] = 0;
  __syncthreads();
  // ranks within each (warp's run, row), 32 tokens at a time in order
  int* my = wcnt + warp * r1;
  const int run_end = min(n_tok, (warp + 1) * run);
  for (int base = warp * run; base < run_end; base += 32) {
    const int t = base + lane;
    const bool in = t < run_end;
    // lanes past the end get distinct negative keys, matching no row
    const int row = in ? srow[t] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int c = in ? my[row] : 0;
    __syncwarp();
    if (in) {
      srank[t] = c + before;
      if (before == 0) my[row] = c + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // per row: the runs' counts -> each run's base, in warp order
  for (int i = tid; i < r1; i += nt) {
    int sum = 0;
    for (int w = 0; w < kPlanWarps; ++w) {
      const int c = wcnt[w * r1 + i];
      wcnt[w * r1 + i] = sum;
      sum += c;
    }
    cnt[i] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scans over the rows: sorted slots and chunks
    int carry_t = 0, carry_c = 0;
    for (int base = 0; base < r1; base += 32) {
      const int i = base + lane;
      const int c = i < r1 ? cnt[i] : 0;
      const int nc = (c * a.gq + TILE - 1) / TILE;
      int inc_t = c, inc_c = nc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc_t, o);
        const int y = __shfl_up_sync(0xffffffffu, inc_c, o);
        if (lane >= o) {
          inc_t += x;
          inc_c += y;
        }
      }
      if (i < r1) {
        off[i] = carry_t + inc_t - c;
        cst[i] = carry_c + inc_c - nc;
      }
      carry_t += __shfl_sync(0xffffffffu, inc_t, 31);
      carry_c += __shfl_sync(0xffffffffu, inc_c, 31);
    }
    if (lane == 0) s_total = carry_c;
  }
  __syncthreads();
  for (int t = tid; t < n_tok; t += nt) {
    const int row = srow[t];
    const int rank = wcnt[(t / run) * r1 + row] + srank[t];
    perm[off[row] + rank] = t;
    plim[off[row] + rank] = slim[t];
    // the chunks holding the token's query heads
    const int f0 = rank * a.gq;
    for (int c = cst[row] + f0 / TILE; c <= cst[row] + (f0 + a.gq - 1) / TILE;
         ++c)
      atomicMax(&clim[c], slim[t]);
  }
  __syncthreads();
  // the chunk table, a thread per chunk (one row may hold thousands: 512
  // tokens x 48 query heads in 16-row chunks): the chunk's row is the last
  // whose first chunk is at or before it, as rows without tokens hold none
  for (int c = tid; c < s_total; c += nt) {
    int i = 0, hi = r1 - 1;
    while (i < hi) {
      const int mid = (i + hi + 1) / 2;
      if (cst[mid] <= c) i = mid;
      else hi = mid - 1;
    }
    const int folded = cnt[i] * a.gq, f = (c - cst[i]) * TILE;
    chunks[c] = make_int4(off[i] * a.gq + f, min(TILE, folded - f), clim[c],
                          i);
  }
  for (int c = s_total + tid; c < a.cap; c += nt)
    chunks[c] = make_int4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// 2. split: grid (n_split, KV, cap), kThreads; smem: Tiles::bytes
// ---------------------------------------------------------------------------
// The key row (in the [R1, KV, S] plane) of logical key n0 of cache row
// `row`, KV head h: a block of 64 keys from n0 sits in one page, so it
// translates through the page table once (no state kept between blocks).
template <bool PAGED>
__device__ __forceinline__ size_t block_keys(const Args& a, int row, int h,
                                             int n0) {
  if constexpr (!PAGED) {
    return ((size_t)row * a.num_kv + h) * a.s_len + n0;
  } else {
    const int ppr = a.s_len / a.page;
    const int pid = a.table[(size_t)row * ppr + n0 / a.page];
    return ((size_t)(pid / ppr) * a.num_kv + h) * a.s_len +
           (size_t)(pid % ppr) * a.page + n0 % a.page;
  }
}

// The ring of two stages, with no Q tile (the Q fragments come straight
// from global memory), and the CTAs per SM its size allows at four warps:
// three where their rings fit 228 KB (a CTA's 1 KB of reserved and ~1 KB
// of static shared memory included), else two; the registers are capped
// to match (168 a thread for three, at the price of a few spills).
template <typename KT, int D, bool TREE>
struct Tiles {
  using R = tc::Ring<KT, D, TREE>;
  static constexpr size_t bytes = R::bytes(0);
  static constexpr int kMinCtas = 3 * (bytes + 2048) <= 228 * 1024 ? 3 : 2;
};

// The last split CTA of a chunk to finish: merge the chunk's rows that
// span several splits (n rows; their q/out rows and key limits in qrows,
// lims; s_inv: n floats of shared memory) into the output in T (bf16, or
// f32 without a rounding).
template <typename T, bool TREE, int D>
__device__ __forceinline__ void merge_rows(const Args& a, int n,
                                           const int* qrows, const int* lims,
                                           float* s_inv) {
  constexpr int NT = kThreads;
  const int tid = threadIdx.x;
  const size_t total = (size_t)a.n_tokens * a.num_kv * a.gq;
  float2* part_ml = reinterpret_cast<float2*>(a.scratch);
  const float* part_acc = a.scratch + 2 * (size_t)a.n_split * total;
  // 1. per row that spans several splits: the largest m, each split's
  //    weight exp2(m_j - m) written over its m (0 for m_j = kNegInf: a K3
  //    row whose last split saw no live key), and 1 / the weighted sum of
  //    l; -1 for a row written by its one split.  Loads go out four splits
  //    at a time, the sums still in split order.
  for (int r = tid; r < n; r += NT) {
    const int nsc = live_splits(lims[r], a);
    s_inv[r] = -1.f;
    if (one_split<TREE>(nsc, a.n_split)) continue;
    // the row's splits: [0, nsc), then K3's last split if not among them
    const int n_row = splits_run<TREE>(nsc, a.n_split);
    float2* ml = part_ml + qrows[r];
    float mx = kNegInf;
    for (int j0 = 0; j0 < n_row; j0 += 4) {
      float2 p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        p[u] = j0 + u < n_row ? __ldcg(&ml[split_of(j0 + u, nsc, a) * total])
                              : make_float2(kNegInf, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) mx = fmaxf(mx, p[u].x);
    }
    float lsum = 0.f;
    for (int j0 = 0; j0 < n_row; j0 += 4) {
      float2 p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        p[u] = j0 + u < n_row ? __ldcg(&ml[split_of(j0 + u, nsc, a) * total])
                              : make_float2(kNegInf, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u >= n_row) break;
        const float w = p[u].x == kNegInf ? 0.f : exp2f(p[u].x - mx);
        lsum = fmaf(p[u].y, w, lsum);
        ml[split_of(j0 + u, nsc, a) * total].x = w;
      }
    }
    s_inv[r] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // 2. per (row, 4 output columns): the weighted sum of the splits' acc, in
  //    split order, loads four splits at a time (a split of weight 0 left
  //    its acc unwritten, so it is read but not added)
  constexpr int C4 = D / 4;
  for (int i = tid; i < n * C4; i += NT) {
    const int r = i / C4, d = (i % C4) * 4;
    const float inv = s_inv[r];
    if (inv < 0.f) continue;
    const int nsc = live_splits(lims[r], a);
    const int n_row = splits_run<TREE>(nsc, a.n_split);
    const size_t qrow = qrows[r];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n_row; j0 += 4) {
      float w[4];
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t pj = split_of(j0 + u, nsc, a) * total + qrow;
        const bool in = j0 + u < n_row;
        w[u] = in ? __ldcg(&part_ml[pj]).x : 0.f;
        x[u] = in ? __ldcg(reinterpret_cast<const float4*>(
                        part_acc + pj * D + d))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (w[u] == 0.f) continue;
        o.x = fmaf(x[u].x, w[u], o.x);
        o.y = fmaf(x[u].y, w[u], o.y);
        o.z = fmaf(x[u].z, w[u], o.z);
        o.w = fmaf(x[u].w, w[u], o.w);
      }
    }
    T* op = static_cast<T*>(a.out) + qrow * D + d;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(op) =
          make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
    } else {
      uint2 packed;
      packed.x = pack_bf16(o.x * inv, o.y * inv);
      packed.y = pack_bf16(o.z * inv, o.w * inv);
      *reinterpret_cast<uint2*>(op) = packed;
    }
  }
}

// A split CTA's last step: with more than one split of its (chunk, KV
// head) running, the last of them to arrive (a counter, after a fence that
// makes this CTA's partials visible) merges the chunk's rows that span
// several splits into the output in T.
template <typename T, bool TREE, int D>
__device__ __forceinline__ void arrive_and_merge(const Args& a, int lim_max,
                                                 int n, const int* qrows,
                                                 const int* lims,
                                                 float* s_inv) {
  __shared__ bool s_last;
  const int n_live = splits_run<TREE>(live_splits(lim_max, a), a.n_split);
  if (n_live < 2) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* arrived = a.plan + chunk_table(a.n_tokens) + 4 * a.cap;
    s_last = atomicAdd(&arrived[blockIdx.z * a.num_kv + blockIdx.y], 1) ==
             n_live - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  merge_rows<T, TREE, D>(a, n, qrows, lims, s_inv);
}

template <typename KT, int D, bool PAGED, bool TREE>
__device__ __forceinline__ void split_body(const Args& a,
                                           unsigned char* ring) {
  using S = tc::Shape<D>;
  using R = typename Tiles<KT, D, TREE>::R;
  constexpr bool KVQ = R::KVQ;
  constexpr int NT = kThreads;
  constexpr int BN = tc::BN;
  __shared__ int s_qrow[BMR];   // folded row -> q/out row t * QH + head
  __shared__ int s_tok[BMR];    // folded row -> token
  __shared__ int s_lim[BMR];    // folded row -> key limit (0 past the chunk)
  __shared__ float s_inv[BMR];  // merge: folded row -> 1 / sum (-1: none)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y;
  const int qh = a.num_kv * a.gq;
  // (first folded row, rows, the rows' largest key limit, cache row)
  int4* chunks = reinterpret_cast<int4*>(a.plan + chunk_table(a.n_tokens));
  const int4 ch = chunks[blockIdx.z];
  const int n = ch.y, lim_max = ch.z, row = ch.w;
  // this split's committed blocks [c_lo, c_hi), then (K3, last split) the
  // spec blocks; an unused chunk slot, or a split past every row's keys,
  // exits here
  const int nb_c = (lim_max + BN - 1) / BN;
  const int c_lo = min(split * a.split_blocks, nb_c);
  const int c_hi = min(c_lo + a.split_blocks, nb_c);
  const int n_c = c_hi - c_lo;
  const int n_s =
      TREE && split == a.n_split - 1 ? (a.p_len + BN - 1) / BN : 0;
  const int n_blocks = n_c + n_s;
  if (n == 0 || n_blocks == 0) return;

  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);
  const size_t spec_base = ((size_t)row * a.num_kv + h) * a.p_len;
  auto issue = [&](int nb) {
    unsigned char* stg = R::stage(ring, nb);
    if (nb < n_c) {
      const int n0 = (c_lo + nb) * BN;
      const size_t kb0 = block_keys<PAGED>(a, row, h, n0);
      tc::copy_block<KT, D, TREE>(stg, k + kb0 * D, v + kb0 * D,
                                  KVQ ? a.ks + kb0 : nullptr,
                                  KVQ ? a.vs + kb0 : nullptr,
                                  min(BN, lim_max - n0), tid, NT);
    } else if constexpr (TREE) {
      const int n0 = (nb - n_c) * BN;
      bf16* Kt = reinterpret_cast<bf16*>(stg);
      tc::copy_tiles<D>(Kt, Kt + S::TILE,
                        static_cast<const bf16*>(a.sk) + (spec_base + n0) * D,
                        static_cast<const bf16*>(a.sv) + (spec_base + n0) * D,
                        min(BN, a.p_len - n0), tid, NT);
    }
  };
  issue(0);                               // before the rows are known
  cp_async_commit();
  if (warp == 0) {
    const int* perm = a.plan;
    const int* plim = perm + a.n_tokens;
    for (int r = lane; r < BMR; r += 32) {
      int qrow = -1, tok = 0, lim = 0;
      if (r < n) {
        const int f = ch.x + r, slot = f / a.gq;
        tok = perm[slot];
        lim = plim[slot];
        qrow = tok * qh + h * a.gq + f % a.gq;
      }
      s_qrow[r] = qrow;
      s_tok[r] = tok;
      s_lim[r] = lim;
    }
  }
  __syncthreads();

  const bool warp_live = warp * 16 < n;   // warps past the rows only copy
  // the lane's two rows (g and g + 8 of its warp's 16)
  const int mg0 = warp * 16 + (lane >> 2), mg1 = mg0 + 8;
  const bf16* q = static_cast<const bf16*>(a.q);
  tc::Rows<D> st;
  if (warp_live)
    st.init_rows(s_qrow[mg0] < 0 ? nullptr : q + (size_t)s_qrow[mg0] * D,
                 s_qrow[mg1] < 0 ? nullptr : q + (size_t)s_qrow[mg1] * D,
                 lane);
  const int lim0 = s_lim[mg0], lim1 = s_lim[mg1];
  // K1 ALiBi, base 2: slope * log2 e and the token's raw position (slope
  // 0 without ALiBi: the bias is then 0)
  float sl0 = 0.f, sl1 = 0.f, pos0 = 0.f, pos1 = 0.f;
  // K3: the rows' ancestor-mask rows (null past the chunk)
  const uint8_t *mrow0 = nullptr, *mrow1 = nullptr;
  if constexpr (TREE) {
    if (mg0 < n) mrow0 = a.amask + (size_t)s_tok[mg0] * a.p_len;
    if (mg1 < n) mrow1 = a.amask + (size_t)s_tok[mg1] * a.p_len;
  } else {
    if (a.slopes != nullptr) {
      if (mg0 < n) {
        sl0 = a.slopes[s_qrow[mg0] % qh] * tc::kLog2e;
        pos0 = static_cast<float>(a.lens[s_tok[mg0]]);
      }
      if (mg1 < n) {
        sl1 = a.slopes[s_qrow[mg1] % qh] * tc::kLog2e;
        pos1 = static_cast<float>(a.lens[s_tok[mg1]]);
      }
    }
  }
  const float scale2 = a.scale * tc::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    // into the stage of block nb - 1, released by the last iteration
    if (nb + 1 < n_blocks) issue(nb + 1);
    cp_async_commit();
    cp_async_wait<1>();                   // block nb has landed
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
      if constexpr (TREE) {
        if (spec) {
          const int n0 = (nb - n_c) * BN;
          st.attend(Kt, Kt + S::TILE, nullptr, nullptr, scale2, lane,
                    [&](int i, int c) {
                      const uint8_t* mr = i ? mrow1 : mrow0;
                      const int j = n0 + c;
                      return mr != nullptr && j < a.p_len && mr[j] != 0;
                    });
        } else {
          const int n0 = (c_lo + nb) * BN;
          st.attend(Kt, Kt + S::TILE, ksc, vsc, scale2, lane,
                    [&](int i, int c) { return n0 + c < (i ? lim1 : lim0); });
        }
      } else {
        const int n0 = (c_lo + nb) * BN;
        st.attend(Kt, Kt + S::TILE, ksc, vsc, scale2, lane,
                  [&](int i, int c) { return n0 + c < (i ? lim1 : lim0); },
                  [&](int i, int c) {
                    return (i ? sl1 : sl0) *
                           (static_cast<float>(n0 + c) - (i ? pos1 : pos0));
                  });
      }
    }
    __syncthreads();                      // the stage may be refilled
  }

  const size_t total = (size_t)a.n_tokens * qh;
  float2* part_ml = reinterpret_cast<float2*>(a.scratch);
  float* part_acc = a.scratch + 2 * (size_t)a.n_split * total;
  if (warp_live) {
    st.finish();
    const int t2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mg = i ? mg1 : mg0;
      if (mg >= n) continue;
      const int nsc = live_splits(i ? lim1 : lim0, a);
      if (split >= nsc && !(TREE && split == a.n_split - 1)) continue;
      const size_t qrow = s_qrow[mg];
      if (one_split<TREE>(nsc, a.n_split)) {  // the row's output, here
        const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
        bf16* op = static_cast<bf16*>(a.out) + qrow * D;
#pragma unroll
        for (int dt = 0; dt < S::DT; ++dt)
          *reinterpret_cast<uint32_t*>(op + dt * 8 + t2) =
              pack_bf16(st.o[dt][2 * i] * inv, st.o[dt][2 * i + 1] * inv);
        continue;
      }
      const size_t pi = (size_t)split * total + qrow;
      if ((lane & 3) == 0) part_ml[pi] = make_float2(st.m[i], st.l[i]);
      if (st.m[i] == kNegInf) continue;   // the merge skips it
      float* ap = part_acc + pi * D;
#pragma unroll
      for (int dt = 0; dt < S::DT; ++dt)
        *reinterpret_cast<float2*>(ap + dt * 8 + t2) =
            make_float2(st.o[dt][2 * i], st.o[dt][2 * i + 1]);
    }
  }

  arrive_and_merge<bf16, TREE, D>(a, lim_max, n, s_qrow, s_lim, s_inv);
}

// ---------------------------------------------------------------------------
// 2'. split, float32: grid (n_split, KV, cap), kThreads; smem: TfTiles::bytes
// ---------------------------------------------------------------------------
// The ring of kTfStages stages (F32_TOO for K3: its spec blocks, in f32,
// beside an int8 cache), or the four warps' states in the closing merge,
// whichever is larger.
template <typename KT, int D, bool TREE>
struct TfTiles {
  using R = tf32::Ring<KT, D, TREE, kTfStages>;
  static constexpr size_t merge = 4 * kTfRows * (8 + 4 + 4 * (size_t)D);
  static constexpr size_t bytes = R::bytes() > merge ? R::bytes() : merge;
};

template <typename KT, int D, bool PAGED, bool TREE>
__device__ __forceinline__ void split_tf32_body(const Args& a,
                                                unsigned char* smem) {
  using R = typename TfTiles<KT, D, TREE>::R;
  constexpr bool KVQ = R::KVQ;
  constexpr int NT = kThreads;
  constexpr int NS = kTfStages;
  constexpr int BN = tf32::BN;
  constexpr int ROWS = kTfRows;
  static_assert(BN == 8 * (kThreads / 32),
                "each warp takes one 8-key column tile of a block");
  __shared__ int s_qrow[ROWS];   // folded row -> q/out row t * QH + head
  __shared__ int s_tok[ROWS];    // folded row -> token
  __shared__ int s_lim[ROWS];    // folded row -> key limit (0 past the chunk)
  // folded row -> what this split writes of it: 1 / sum (its output),
  // 0 (a partial), -1 (nothing: not one of its splits, or no live key)
  __shared__ float s_mul[ROWS];
  __shared__ float s_inv[ROWS];  // merge: folded row -> 1 / sum (-1: none)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y;
  const int qh = a.num_kv * a.gq;
  // (first folded row, rows, the rows' largest key limit, cache row)
  int4* chunks = reinterpret_cast<int4*>(a.plan + chunk_table(a.n_tokens));
  const int4 ch = chunks[blockIdx.z];
  const int n = ch.y, lim_max = ch.z, row = ch.w;
  // this split's committed 32-key blocks [c_lo, c_hi) (the plan counts
  // 64-key blocks; these cover the same keys), then (K3, last split) the
  // spec blocks; an unused chunk slot, or a split past every row's keys,
  // exits here
  const int per = a.split_blocks * (tc::BN / BN);
  const int nb_c = (lim_max + BN - 1) / BN;
  const int c_lo = min(split * per, nb_c);
  const int c_hi = min(c_lo + per, nb_c);
  const int n_c = c_hi - c_lo;
  const int n_s =
      TREE && split == a.n_split - 1 ? (a.p_len + BN - 1) / BN : 0;
  const int n_blocks = n_c + n_s;
  if (n == 0 || n_blocks == 0) return;

  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);
  const size_t spec_base = ((size_t)row * a.num_kv + h) * a.p_len;
  auto issue = [&](int nb) {
    unsigned char* stg = R::stage(smem, nb);
    if (nb < n_c) {
      const int n0 = (c_lo + nb) * BN;
      const size_t kb0 = block_keys<PAGED>(a, row, h, n0);
      tf32::copy_block<R, KT, D>(stg, k + kb0 * D, v + kb0 * D,
                                 KVQ ? a.ks + kb0 : nullptr,
                                 KVQ ? a.vs + kb0 : nullptr,
                                 min(BN, lim_max - n0), tid, NT);
    } else if constexpr (TREE) {
      const int n0 = (nb - n_c) * BN;
      tf32::copy_tiles<D>(
          R::kt(stg), R::vt(stg),
          static_cast<const float*>(a.sk) + (spec_base + n0) * D,
          static_cast<const float*>(a.sv) + (spec_base + n0) * D,
          min(BN, a.p_len - n0), tid, NT);
    }
  };
  // the first blocks, requested before the rows are read
#pragma unroll
  for (int nb = 0; nb < NS - 1; ++nb) {
    if (nb < n_blocks) issue(nb);
    cp_async_commit();
  }
  if (tid < ROWS) {
    int qrow = -1, tok = 0, lim = 0;
    if (tid < n) {
      const int f = ch.x + tid, slot = f / a.gq;
      tok = a.plan[slot];
      lim = a.plan[a.n_tokens + slot];
      qrow = tok * qh + h * a.gq + f % a.gq;
    }
    s_qrow[tid] = qrow;
    s_tok[tid] = tok;
    s_lim[tid] = lim;
  }
  __syncthreads();

  // every warp holds the chunk's rows; the lane's rows g and g + 8
  const int mg0 = lane >> 2, mg1 = mg0 + 8;
  const float* q = static_cast<const float*>(a.q);
  tf32::Rows<D, tf32::QKeep::Split> st;
  st.init(s_qrow[mg0] < 0 ? nullptr : q + (size_t)s_qrow[mg0] * D,
          s_qrow[mg1] < 0 ? nullptr : q + (size_t)s_qrow[mg1] * D, lane);
  const int lim0 = s_lim[mg0], lim1 = s_lim[mg1];
  // K1 ALiBi, base 2: slope * log2 e and the token's raw position (slope
  // 0 without ALiBi: the bias is then 0)
  float sl0 = 0.f, sl1 = 0.f, pos0 = 0.f, pos1 = 0.f;
  // K3: the rows' ancestor-mask rows (null past the chunk)
  const uint8_t *mrow0 = nullptr, *mrow1 = nullptr;
  if constexpr (TREE) {
    if (mg0 < n) mrow0 = a.amask + (size_t)s_tok[mg0] * a.p_len;
    if (mg1 < n) mrow1 = a.amask + (size_t)s_tok[mg1] * a.p_len;
  } else {
    if (a.slopes != nullptr) {
      if (mg0 < n) {
        sl0 = a.slopes[s_qrow[mg0] % qh] * tf32::kLog2e;
        pos0 = static_cast<float>(a.lens[s_tok[mg0]]);
      }
      if (mg1 < n) {
        sl1 = a.slopes[s_qrow[mg1] % qh] * tf32::kLog2e;
        pos1 = static_cast<float>(a.lens[s_tok[mg1]]);
      }
    }
  }
  const float scale2 = a.scale * tf32::kLog2e;

  for (int nb = 0; nb < n_blocks; ++nb) {
    if (nb + NS - 1 < n_blocks) issue(nb + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();             // block nb has landed
    __syncthreads();
    unsigned char* stg = R::stage(smem, nb);
    const bool spec = TREE && nb >= n_c;
    const int n0 = spec ? (nb - n_c) * BN : (c_lo + nb) * BN;
    // a warp whose 8 keys all lie past the chunk's keys leaves its state
    // as a masked update would: it skips the block
    if (n0 + 8 * warp >= (spec ? a.p_len : lim_max)) {
    } else if (spec) {
      st.template attend<float, 1>(
          R::kt(stg), R::vt(stg), nullptr, nullptr, warp, scale2, lane,
          [&](int i, int c) {
            const uint8_t* mr = i ? mrow1 : mrow0;
            const int j = n0 + c;
            return mr != nullptr && j < a.p_len && mr[j] != 0;
          });
    } else {
      auto live = [&](int i, int c) { return n0 + c < (i ? lim1 : lim0); };
      // K1's ALiBi term (0 without slopes); K3 has none
      const auto bias = [&] {
        if constexpr (TREE) {
          return tc::NoBias();
        } else {
          return [&](int i, int c) {
            return (i ? sl1 : sl0) *
                   (static_cast<float>(n0 + c) - (i ? pos1 : pos0));
          };
        }
      }();
      if constexpr (KVQ)
        st.template attend<int8_t, 1>(R::k8(stg), R::v8(stg), R::kscale(stg),
                                      R::vscale(stg), warp, scale2, lane,
                                      live, bias);
      else
        st.template attend<float, 1>(R::kt(stg), R::vt(stg), nullptr,
                                     nullptr, warp, scale2, lane, live, bias);
    }
    __syncthreads();                     // the stage may be refilled
  }
  cp_async_wait<0>();
  st.finish();

  // merge the four warps' states of each row in shared memory (the ring
  // is free): weights exp2(m_w - m) (0 for a warp with no live key), then
  // the weighted sums in warp order
  float2* red_ml = reinterpret_cast<float2*>(smem);        // [4][ROWS]
  float* red_w = reinterpret_cast<float*>(red_ml + 4 * ROWS);
  float* red_o = red_w + 4 * ROWS;                         // [4][ROWS][D]
  if ((lane & 3) == 0) {
    red_ml[warp * ROWS + mg0] = make_float2(st.m[0], st.l[0]);
    red_ml[warp * ROWS + mg1] = make_float2(st.m[1], st.l[1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    st.store_row(i, lane, red_o + (warp * ROWS + (i ? mg1 : mg0)) * D, 1.f);
  __syncthreads();
  const size_t total = (size_t)a.n_tokens * qh;
  float2* part_ml = reinterpret_cast<float2*>(a.scratch);
  float* part_acc = a.scratch + 2 * (size_t)a.n_split * total;
  if (tid < ROWS) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red_ml[w * ROWS + tid].x);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 ml = red_ml[w * ROWS + tid];
      const float wt = ml.x == kNegInf ? 0.f : exp2f(ml.x - mx);
      red_w[w * ROWS + tid] = wt;
      lsum = fmaf(ml.y, wt, lsum);
    }
    float mul = -1.f;
    if (tid < n) {
      const int nsc = live_splits(s_lim[tid], a);
      if (split < nsc || (TREE && split == a.n_split - 1)) {
        if (one_split<TREE>(nsc, a.n_split)) {   // the row's output, here
          mul = 1.f / fmaxf(lsum, 1e-30f);
        } else {
          part_ml[(size_t)split * total + s_qrow[tid]] = make_float2(mx, lsum);
          if (mx != kNegInf) mul = 0.f;    // the merge skips it otherwise
        }
      }
    }
    s_mul[tid] = mul;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float mul = s_mul[r];
    if (mul < 0.f) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = red_w[w * ROWS + r];
      const float4 x =
          *reinterpret_cast<const float4*>(red_o + (w * ROWS + r) * D + c);
      acc.x = fmaf(x.x, wt, acc.x);
      acc.y = fmaf(x.y, wt, acc.y);
      acc.z = fmaf(x.z, wt, acc.z);
      acc.w = fmaf(x.w, wt, acc.w);
    }
    const size_t qrow = s_qrow[r];
    if (mul > 0.f) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + qrow * D + c) =
          make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul);
    } else {
      *reinterpret_cast<float4*>(part_acc +
                                 ((size_t)split * total + qrow) * D + c) = acc;
    }
  }

  arrive_and_merge<float, TREE, D>(a, lim_max, n, s_qrow, s_lim, s_inv);
}

// Launch the two kernels on one stream (each a thin __global__ wrapper of
// the bodies above, named after its caller so a profile tells K1 from K3),
// the split kernel with split_smem bytes of dynamic shared memory.
// Returns the first launch error.
template <auto Plan, auto Split>
cudaError_t launch(Args a, size_t split_smem, cudaStream_t stream) {
  void* args[] = {&a};
  const size_t plan_smem =
      plan_smem_ints(a.n_tokens, a.r1, a.cap) * sizeof(int);
  cudaError_t err = tc::allow_smem<Plan>(plan_smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(Plan), dim3(1),
                         dim3(32 * kPlanWarps), args, plan_smem, stream);
  if (err != cudaSuccess) return err;
  err = tc::allow_smem<Split>(split_smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(reinterpret_cast<const void*>(Split),
                          dim3(a.n_split, a.num_kv, a.cap), dim3(kThreads),
                          args, split_smem, stream);
}

}  // namespace rt
}  // namespace ffk
