"""The serve path's attention kernels: CUDA wrappers and their plain versions.

``decode_attention`` replaces the Pallas kernel of the same name
(``flexflow_tpu/ops/pallas/attention.py:209``), ``prefill_attention``
replaces ``prefill_attention`` (:444), and ``tree_attention`` /
``tree_attention_batched`` replace the two layouts of the tree kernel
(:790, :836, both through ``_tree_call`` :675), each in four variants: fp
or int8 caches (``k_scale``/``v_scale``,
f32 ``[R+1, KV, S]``: one dequant scale per key vector), slot-contiguous or
paged (``page_table`` int32 ``[R+1, S / page_size]``: logical page j of
cache row r is physical page ``table[r, j]``, which addresses row
``pid // (S / page_size)``, page slot ``pid % (S / page_size)``).  The tree
kernels' int8 and paging apply to the committed cache; the spec buffer
stays in the compute dtype and slot-contiguous.  ``decode_attention`` also
takes ALiBi slopes (``slopes`` f32 ``[QH]``, the Pallas kernel's
``use_alibi`` path, :171-173) in each variant; the tree kernels take none
(the reference has no ALiBi tree kernel, :816).  Every kernel takes any
number of query heads per KV head.  The kernels are hand-written CUDA C++
for sm_90a (``flexflow_tpu_torch/csrc/``), built by ``nvcc`` on first use
(:mod:`.build`) and called through a plain C interface.  Every kernel runs
on the tensor cores: in bfloat16 through ``csrc/tc_attention.cuh``
(``mma.sync`` products, P rounded to bfloat16 before P.V, K/V blocks in the
cache's dtype through a ``cp.async`` ring); in float32 through
``csrc/tc_attention_f32.cuh`` (error-compensated TF32, each product as
three ``mma.sync`` passes on the operands' TF32 high and low parts, two for
an int8 cache, P kept in float32; :func:`tf32x3_probe` exposes the fragment
layout to the card tests).  float32 ``prefill_attention`` reads each
tile's keys in splits (:func:`prefill_split_plan`) merged by a second
kernel.  ``decode_attention``, ``tree_attention`` and
``tree_attention_batched`` are split-KV: the committed prefix in splits of
:data:`SPLIT_BLOCKS` blocks (:func:`tree_split_plan`), one CTA each writing
f32 partials to scratch this wrapper allocates, then merged (plain
versions: :func:`decode_split_partials_plain`,
:func:`tree_token_split_partials_plain`, :func:`tree_split_partials_plain`,
:func:`merge_partials_plain`): by a merge kernel in the batched layout, by
the last split CTA of a chunk to finish in the two flat-token kernels.
Those first group their tokens by cache row on the device
(``csrc/row_tiles.cuh``; plain version :func:`row_plan_plain`), so the
tokens and query heads of one row share chunks of up to :func:`row_tile`
folded rows (bfloat16 :data:`ROW_TILE`, float32 :data:`TF32_ROW_TILE`)
that read each K/V block once.

Each wrapper launches its kernel for CUDA tensors, or raises: there is no
fall-back for them.  It takes the plain PyTorch version only when the
tensors it was given lie on the CPU.  The plain versions are the same
function written as a masked softmax over gathered cache rows in f32 (int8
rows times their scales, paged rows rebuilt through the table), the gather
path of ``flexflow_tpu/serve/ops.py:613-651`` with ``_gather_logical_rows``
(:69) and ``_dequant_rows`` (:499); the CPU tests hold them against the JAX
kernels, and the card holds the kernels against them.  Both paths check the
cache variant's arguments first (:func:`check_cache_variant`).

Each wrapper counts its kernel launches in its ``launches`` attribute, and
per variant in ``variant_launches`` (keys :data:`VARIANTS`; for
``decode_attention`` also :data:`ALIBI_VARIANTS`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)     # head dims the kernels are built for
# a page holds whole 64-key blocks: the prefill kernel and the tree
# kernel's batched layout stage 64-key blocks, and each block must sit in
# one page so it translates through the table once
PAGE_BLOCK = 64
# the split-KV kernels read the committed prefix in splits of this many
# blocks, one CTA per split (:func:`tree_split_plan`)
SPLIT_BLOCKS = 4
# the f32 split kernels (the batched tree layout, and the flat-token
# kernels' row chunks) hold this many folded rows per CTA
TF32_ROW_TILE = 16
# the f32 prefill kernel reads each tile's keys in splits of this many
# (:func:`prefill_split_plan`)
PREFILL_SPLIT_KEYS = 1024
# the bf16 flat-token kernels (decode, per-token tree) hold up to this many
# folded (token, query head) rows of one cache row per CTA
ROW_TILE = 64
# the row plan kernel stages 3 ints per token, 11 per cache row and one
# per chunk in shared memory (224 KB at most)
PLAN_SMEM_INTS = 56 * 1024
VARIANTS = ("fp", "int8", "paged", "int8+paged")
ALIBI_VARIANTS = tuple(f"{v}+alibi" for v in VARIANTS)   # decode only
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain decode version gathers at most this many cache elements at once
_GATHER_ELEMS = 1 << 27

_FNS: Dict[str, object] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, k_scale, v_scale, table, slopes, rows, pos, scratch, plan,
    # out, n_tokens, num_kv, gq, r1, s_len, head_dim, page_size, n_split,
    # split_blocks, cap, scale, dtype, stream
    "decode_attention": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, table, rows, pstart, scratch, out,
    # n_tiles, bq, num_kv, gq, r1, s_len, head_dim, page_size, n_split,
    # split_keys, scale, dtype, stream
    "prefill_attention": [_P] * 10 + [_I] * 10 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
    # scratch, plan, out, n_tokens, num_kv, gq, r1, s_len, p_len, head_dim,
    # page_size, n_split, split_blocks, cap, scale, dtype, stream
    "tree_attention": [_P] * 14 + [_I] * 11 + [_F, _I, _P],
    # q, k, v, k_scale, v_scale, table, sk, sv, rows, clens, amask,
    # scratch, out, n_req, p_tok, num_kv, gq, r1, s_len, p_len, head_dim,
    # page_size, n_split, split_blocks, scale, dtype, stream
    "tree_attention_batched": [_P] * 13 + [_I] * 11 + [_F, _I, _P],
    # a, b, c, mode, head_dim, n, stream
    "tf32x3_probe": [_P] * 3 + [_I] * 3 + [_P],
}
# the library (csrc/<source>.cu) each entry point lives in
_SOURCE = {"tree_attention_batched": "tree_attention",
           "tf32x3_probe": "prefill_attention"}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(_SOURCE.get(name, name)), f"ff_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _on_cpu(name, *tensors) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else raises.  None entries are skipped."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def variant(k_scale, page_table, slopes=None) -> str:
    """The variant's name in :data:`VARIANTS` (with ``slopes``, in
    :data:`ALIBI_VARIANTS`)."""
    kind = "fp" if k_scale is None else "int8"
    if page_table is not None:
        kind = "paged" if kind == "fp" else "int8+paged"
    return kind if slopes is None else f"{kind}+alibi"


def check_page_size(page_size: int, s_len: int) -> None:
    """Raises unless the kernels take pages of ``page_size`` keys over a
    cache of ``s_len`` positions: a positive multiple of
    :data:`PAGE_BLOCK` that divides ``s_len``."""
    if page_size <= 0 or page_size % PAGE_BLOCK or s_len % page_size:
        raise ValueError(
            f"page size {page_size} must be a positive multiple of "
            f"{PAGE_BLOCK} dividing the cache length {s_len}: a page holds "
            f"whole {PAGE_BLOCK}-key blocks of the prefill and batched tree "
            "kernels")


def check_cache_variant(name, k_cache, v_cache, k_scale, v_scale,
                        page_table, page_size) -> None:
    """Raises unless the caches, their scales and the page table form a
    variant the kernels take: int8 caches with contiguous f32
    ``[R+1, KV, S]`` scales (fp caches without), and a contiguous int32
    ``[R+1, S / page_size]`` table with a page size
    :func:`check_page_size` takes (or no table and page size 0)."""
    r1, kv, s = k_cache.shape[:3]
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale go together")
    int8 = k_cache.dtype == torch.int8 or v_cache.dtype == torch.int8
    if k_scale is None:
        if int8:
            raise TypeError(f"{name}: an int8 cache needs k_scale and "
                            "v_scale")
    else:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError(f"{name}: scales come with int8 caches")
        for t in (k_scale, v_scale):
            if (t.dtype != torch.float32 or tuple(t.shape) != (r1, kv, s)
                    or not t.is_contiguous()):
                raise ValueError(f"{name}: scales must be contiguous "
                                 f"float32[{r1}, {kv}, {s}]")
    if page_table is None:
        if page_size:
            raise ValueError(f"{name}: page size {page_size} without a "
                             "page table")
        return
    try:
        check_page_size(page_size, s)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if (page_table.dtype != torch.int32
            or tuple(page_table.shape) != (r1, s // page_size)
            or not page_table.is_contiguous()):
        raise ValueError(f"{name}: page table must be contiguous "
                         f"int32[{r1}, {s // page_size}]")


def _check_kernel_args(name, q, k_cache, v_cache, idx_a, idx_b, n):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k_cache.dtype != torch.int8 and (k_cache.dtype != q.dtype
                                        or v_cache.dtype != q.dtype):
        raise TypeError(f"{name}: q, k and v must share one dtype (or the "
                        "caches be int8)")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must both be [R+1, KV, S, D]")
    d = q.shape[-1]
    if k_cache.shape[-1] != d or d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported {HEAD_DIMS}")
    for t in (idx_a, idx_b):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name}: index arrays must be int32[{n}]")
    for t in (q, k_cache, v_cache, idx_a, idx_b):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    _check_aligned(name, q, k_cache, v_cache)
    if max(q.shape + k_cache.shape) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension does not fit the kernel's "
                         "32-bit sizes")


def _check_aligned(name, *tensors) -> None:
    """The kernels copy rows in 16-byte vectors."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: q, caches and spec buffers must start on "
                         "a 16-byte boundary")


def _launch(name, device, fn, *args):
    """Call a kernel's C launcher with ``device`` current: its stream
    argument is that device's, and a launch on another device's stream
    fails (a pipeline stage or a shard on a second card)."""
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(fn, k_scale, page_table, slopes=None) -> None:
    fn.launches += 1
    fn.variant_launches[variant(k_scale, page_table, slopes)] += 1


def _init_counts(fn, variants=VARIANTS) -> None:
    fn.launches = 0
    fn.variant_launches = dict.fromkeys(variants, 0)


def reset_counts() -> None:
    """Set every wrapper's launch counts to 0."""
    _init_counts(decode_attention, VARIANTS + ALIBI_VARIANTS)
    for fn in (prefill_attention, tree_attention, tree_attention_batched):
        _init_counts(fn)


def _pages(cache, page_table, page_size, rows):
    """``cache[rows]`` (``[t, KV, S(, D)]``) rebuilt through the page
    table from the physical pages of the same buffer."""
    r1, kv, s = cache.shape[:3]
    ppr = s // page_size
    pids = page_table.long()[rows]                        # [t, ppr]
    prow, pslot = pids // ppr, pids % ppr
    tail = tuple(cache.shape[3:])
    # advanced indices split by a slice lead: [t, ppr, KV, page(, D)]
    pg = cache.reshape(r1, kv, ppr, page_size, *tail)[prow, :, pslot]
    return pg.transpose(1, 2).reshape(rows.shape[0], kv, s, *tail)


def page_layout(cache, page_table, page_size):
    """The physical buffer of a paged cache whose logical rows are
    ``cache`` (``[R+1, KV, S(, D)]``): logical page j of row r moves to
    physical page ``page_table[r, j]``; the inverse of rebuilding rows
    through the table.  ``page_table`` holds each page id once."""
    r1, kv, s = cache.shape[:3]
    ppr = s // page_size
    tail = tuple(cache.shape[3:])
    logical = cache.reshape(r1, kv, ppr, page_size, *tail).transpose(1, 2)
    phys = cache.new_empty((r1 * ppr, kv, page_size) + tail)
    phys[page_table.reshape(-1).long()] = logical.reshape(phys.shape)
    return phys.reshape(r1, ppr, kv, page_size, *tail).transpose(
        1, 2).reshape(cache.shape)


def _rows_f32(cache, scale, page_table, page_size, rows):
    """The logical cache rows ``rows`` in f32: rebuilt through the page
    table when paged, int8 values times their scales when quantized."""
    if page_table is None:
        x = cache[rows].float()
        sc = scale[rows] if scale is not None else None
    else:
        x = _pages(cache, page_table, page_size, rows).float()
        sc = (_pages(scale, page_table, page_size, rows)
              if scale is not None else None)
    return x if sc is None else x * sc[..., None]


def _distinct_rows(rows, step):
    """The flat tokens ``rows`` in chunks of at most ``step``: for each
    chunk its slice, its distinct cache rows and each token's index into
    them.  The plain versions rebuild (page table, int8 scales) each
    distinct row once a chunk and index it per token, which gives every
    token the values a rebuild of its own row gives: a step's pads share
    the scratch row, a request's tokens its row."""
    for lo in range(0, rows.shape[0], step):
        sl = slice(lo, lo + step)
        uniq, inv = torch.unique(rows[sl], return_inverse=True)
        yield sl, uniq, inv


# ---------------------------------------------------------------------------
# The row plan and split partials of the flat-token kernels
# ---------------------------------------------------------------------------
def row_tile(dtype) -> int:
    """Folded rows per chunk of the flat-token kernels' row plan:
    :data:`TF32_ROW_TILE` in float32 (the smallest tile of a TF32
    ``mma``), :data:`ROW_TILE` in bfloat16."""
    return TF32_ROW_TILE if dtype == torch.float32 else ROW_TILE


def row_chunk_capacity(n_tokens: int, gq: int, r1: int,
                       tile: int = ROW_TILE) -> int:
    """Entries of the row plan's chunk table: ``ceil(T * gq / tile)`` full
    chunks, plus at most one part chunk for each of the ``r1`` cache
    rows."""
    return -(-n_tokens * gq // tile) + r1


def row_plan_plain(rows, r1: int, gq: int, tile: int = ROW_TILE):
    """Plain version of the row plan kernel (any device): the flat tokens
    sorted by their clamped cache row, stably, and each row's folded rows
    (sorted slot * gq + query head) cut into chunks of at most ``tile``.
    Returns ``perm`` int64 ``[T]`` (sorted slot -> token) and the chunk
    table int32 ``[cap, 2]`` of (first folded row, row count), ``cap =``
    :func:`row_chunk_capacity`, the unused entries ``(0, 0)``.  The kernel
    also stores each chunk's cache row and its rows' largest key limit."""
    r = rows.long().clamp(0, r1 - 1)
    perm = torch.sort(r, stable=True).indices
    counts = torch.bincount(r, minlength=r1).tolist()
    cap = row_chunk_capacity(r.shape[0], gq, r1, tile)
    chunks = torch.zeros(cap, 2, dtype=torch.int32, device=rows.device)
    off = c = 0
    for n in counts:
        for f in range(0, n * gq, tile):
            chunks[c, 0] = off * gq + f
            chunks[c, 1] = min(tile, n * gq - f)
            c += 1
        off += n
    return perm, chunks


def _row_split_buffers(name, q, r1, kv, s):
    """``(scratch, plan, n_split, split_blocks, cap)`` of a flat-token
    kernel: its split partials, its row plan (chunks of :func:`row_tile`
    rows) and their sizes."""
    t, qh, d = q.shape
    cap = row_chunk_capacity(t, qh // kv, r1, row_tile(q.dtype))
    if (3 * t + 11 * r1 + cap > PLAN_SMEM_INTS or kv > 65535
            or cap > 65535):
        raise ValueError(f"{name}: {t} tokens x {qh // kv} query heads on "
                         f"{r1} cache rows and {kv} KV heads exceed the "
                         "kernel's row plan or grid")
    n_split, per = tree_split_plan(s)
    scratch = torch.empty(n_split * t * qh * (d + 2), dtype=torch.float32,
                          device=q.device)
    # perm and key limits [T each], then int4 chunk entries (16-byte
    # aligned) and an arrival counter per (chunk, KV head)
    plan = torch.empty(-(-2 * t // 4) * 4 + (4 + kv) * cap,
                       dtype=torch.int32, device=q.device)
    return scratch, plan, n_split, per, cap


def _split_partials(scores, vals, live, split_id, n_split):
    """Softmax partials of flat rows per split, natural base: ``scores [T,
    KV, G, N]`` (unmasked), ``vals [T, KV, N, D]``, ``live bool[T, N]``,
    ``split_id [N]`` the split of each key.  Returns ``m, l [n_split, T,
    KV * G]`` and ``acc [n_split, T, KV * G, D]``; a split with no live key
    of a row gives ``m = NEG_INF``, ``l = 0``, ``acc = 0``."""
    t = scores.shape[0]
    ms, ls, accs = [], [], []
    for j in range(n_split):
        lv = (live & (split_id == j)[None, :])[:, None, None, :]
        sc = scores.masked_fill(~lv, NEG_INF)
        mj = sc.amax(-1)
        w = torch.exp(sc - mj[..., None]) * lv
        ms.append(mj.reshape(t, -1))
        ls.append(w.sum(-1).reshape(t, -1))
        accs.append(torch.einsum("tkgn,tknd->tkgd", w, vals).reshape(
            t, ms[-1].shape[1], -1))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------
def decode_attention_plain(q, k_cache, v_cache, rows, positions, scale,
                           k_scale=None, v_scale=None, page_table=None,
                           page_size=0, slopes=None):
    """Plain version of :func:`decode_attention` (any device)."""
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    gq = qh // kv
    rows = rows.long().clamp(0, r1 - 1)
    pos = positions.long()
    key_pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    step = max(1, _GATHER_ELEMS // (kv * s * d))
    for sl, uniq, inv in _distinct_rows(rows, step):
        k_tok = _rows_f32(k_cache, k_scale, page_table, page_size, uniq)[inv]
        v_tok = _rows_f32(v_cache, v_scale, page_table, page_size, uniq)[inv]
        qr = q[sl].float().reshape(-1, kv, gq, d)
        scores = torch.einsum("tkgd,tksd->tkgs", qr, k_tok) * scale
        if slopes is not None:   # ALiBi: slope * (key_pos - pos), in f32
            rel = (key_pos[None, :] - pos[sl, None]).float()   # [t', S]
            scores = scores + (slopes.float().reshape(kv, gq)[None, :, :, None]
                               * rel[:, None, None, :])
        mask = key_pos[None, :] <= pos[sl, None]        # [t', S]
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("tkgs,tksd->tkgd", w, v_tok)
        out[sl] = o.reshape(-1, qh, d).to(q.dtype)
    return out


def decode_split_partials_plain(q, k_cache, v_cache, rows, positions,
                                scale, k_scale=None, v_scale=None,
                                page_table=None, page_size=0, slopes=None):
    """Plain version of the decode kernel's split pass (any device):
    each token's ``(m, l, acc)`` per split of :func:`tree_split_plan` over
    its keys ``<= clamp(positions, 0, S - 1)``, f32, natural base (the
    kernel keeps m in base 2).  Returns ``m, l [n_split, T, QH]`` and
    ``acc [n_split, T, QH, D]``; :func:`merge_partials_plain` combines
    them."""
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    n_split, per = tree_split_plan(s)
    rows = rows.long().clamp(0, r1 - 1)
    pos = positions.long()
    key_pos = torch.arange(s, device=q.device)
    k_tok = _rows_f32(k_cache, k_scale, page_table, page_size, rows)
    v_tok = _rows_f32(v_cache, v_scale, page_table, page_size, rows)
    qr = q.float().reshape(t, kv, qh // kv, d)
    scores = torch.einsum("tkgd,tksd->tkgs", qr, k_tok) * scale
    if slopes is not None:
        rel = (key_pos[None, :] - pos[:, None]).float()
        scores = scores + (slopes.float().reshape(kv, -1)[None, :, :, None]
                           * rel[:, None, None, :])
    live = key_pos[None, :] <= pos.clamp(0, s - 1)[:, None]
    return _split_partials(scores, v_tok, live,
                           key_pos // (per * PAGE_BLOCK), n_split)


def _check_slopes(name, slopes, qh) -> None:
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (qh,)
                               or not slopes.is_contiguous()):
        raise ValueError(f"{name}: ALiBi slopes must be contiguous "
                         f"float32[{qh}]")


def decode_attention(q, k_cache, v_cache, rows, positions, scale: float,
                     k_scale=None, v_scale=None, page_table=None,
                     page_size: int = 0, slopes=None):
    """Attention of flat decode tokens over their cache rows.

    ``q [T, QH, D]`` (RoPE applied, if any); ``k_cache, v_cache [R+1, KV,
    S, D]`` holding this step's K/V already (int8 with ``k_scale,
    v_scale``); ``rows, positions int32[T]``; ``page_table``/``page_size``
    for a paged cache; ``slopes`` f32 ``[QH]`` for ALiBi (None: none).
    Token t attends with its query heads over cache row ``rows[t]`` at
    logical key positions ``<= positions[t]``; with slopes, head h's score
    of key j gains ``slopes[h] * (j - positions[t])`` before the mask.
    ``QH`` is any multiple of ``KV``.  Returns ``[T, QH, D]`` in q's dtype.
    """
    name = "decode_attention"
    check_cache_variant(name, k_cache, v_cache, k_scale, v_scale,
                        page_table, page_size)
    _check_slopes(name, slopes, q.shape[1])
    if _on_cpu(name, q, k_cache, v_cache, rows, positions, k_scale,
               v_scale, page_table, slopes):
        return decode_attention_plain(q, k_cache, v_cache, rows, positions,
                                      scale, k_scale, v_scale, page_table,
                                      page_size, slopes)
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, positions, t)
    split = _row_split_buffers(name, q, r1, kv, s)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, q.device, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            _ptr(page_table), _ptr(slopes), rows.data_ptr(),
            positions.data_ptr(), _ptr(split[0]), _ptr(split[1]),
            out.data_ptr(), t, kv, gq, r1, s, d, page_size, *split[2:],
            float(scale), _DTYPE_CODES[q.dtype], stream)
    _count(decode_attention, k_scale, page_table, slopes)
    return out


# ---------------------------------------------------------------------------
# K2: prefill attention
# ---------------------------------------------------------------------------
def prefill_attention_plain(q, k_cache, v_cache, rows, pstart, scale,
                            k_scale=None, v_scale=None, page_table=None,
                            page_size=0):
    """Plain version of :func:`prefill_attention` (any device)."""
    g, bq, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    gq = qh // kv
    rows = rows.long().clamp(0, r1 - 1)
    qpos = pstart.long()[:, None] + torch.arange(bq, device=q.device)
    key_pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for i in range(g):   # one tile at a time bounds the gathered rows
        row = rows[i:i + 1]
        k_t = _rows_f32(k_cache, k_scale, page_table, page_size, row)[0]
        v_t = _rows_f32(v_cache, v_scale, page_table, page_size, row)[0]
        qr = q[i].float().reshape(bq, kv, gq, d)
        scores = torch.einsum("bkgd,ksd->bkgs", qr, k_t) * scale
        mask = key_pos[None, :] <= qpos[i][:, None]      # [Bq, S]
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgs,ksd->bkgd", w, v_t)
        out[i] = o.reshape(bq, qh, d).to(q.dtype)
    return out


def prefill_attention(q, k_cache, v_cache, rows, pstart, scale: float,
                      k_scale=None, v_scale=None, page_table=None,
                      page_size: int = 0):
    """Causal attention of G prompt tiles over their cache rows.

    ``q [G, Bq, QH, D]``: tile g holds Bq tokens of one request at
    positions ``pstart[g] + b``; ``k_cache, v_cache [R+1, KV, S, D]``
    already hold this step's K/V (int8 with ``k_scale, v_scale``; paged
    with ``page_table``/``page_size``); ``rows, pstart int32[G]``.  Query
    b of tile g sees logical keys ``<= pstart[g] + b`` of row ``rows[g]``.
    Returns ``[G, Bq, QH, D]`` in q's dtype.
    """
    name = "prefill_attention"
    check_cache_variant(name, k_cache, v_cache, k_scale, v_scale,
                        page_table, page_size)
    if _on_cpu(name, q, k_cache, v_cache, rows, pstart, k_scale, v_scale,
               page_table):
        return prefill_attention_plain(q, k_cache, v_cache, rows, pstart,
                                       scale, k_scale, v_scale, page_table,
                                       page_size)
    g, bq, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, pstart, g)
    n_split, split_keys, scratch = 0, 0, None
    if q.dtype == torch.float32:
        # split-KV: the (m, l) pairs and accumulators of every split
        n_split, split_keys = prefill_split_plan(s)
        if g * kv * -(-bq * gq // 64) * n_split >= 2 ** 31:
            raise ValueError(f"{name}: {g} tiles x {kv} KV heads exceed the "
                             "kernel's grid")
        if n_split > 1:
            scratch = torch.empty(n_split * g * kv * bq * gq * (d + 2),
                                  dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, q.device, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            _ptr(page_table), rows.data_ptr(), pstart.data_ptr(),
            _ptr(scratch), out.data_ptr(), g, bq, kv, gq, r1, s, d,
            page_size, n_split, split_keys, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    _count(prefill_attention, k_scale, page_table)
    return out


def prefill_split_plan(s_len: int):
    """``(n_split, split_keys)``: the f32 prefill kernel reads each tile's
    keys in ``n_split`` splits of :data:`PREFILL_SPLIT_KEYS` keys (whole
    32-key blocks) covering a cache of ``s_len`` positions, one CTA each,
    so the deepest tiles' walks spread over the card; with more than one,
    a merge kernel combines the splits' f32 partials.  The plan depends on
    shapes only; a split past a chunk's causal frontier exits at once."""
    return max(1, -(-s_len // PREFILL_SPLIT_KEYS)), PREFILL_SPLIT_KEYS


# ---------------------------------------------------------------------------
# K3: tree attention (committed cache + speculation-tree buffer)
# ---------------------------------------------------------------------------
def tree_attention_plain(q, k_cache, v_cache, k_spec, v_spec, rows, clens,
                         amask, scale, k_scale=None, v_scale=None,
                         page_table=None, page_size=0):
    """Plain version of :func:`tree_attention` (any device).  It follows
    the Pallas kernel, not the JAX gather path: a row with no live key
    gives zeros (masked weights are 0, the denominator is clamped at
    1e-30), where one softmax over the concatenated scores would give a
    uniform average."""
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    p = k_spec.shape[2]
    gq = qh // kv
    rows = rows.long().clamp(0, r1 - 1)
    clens = clens.long().clamp(0, s)
    key_pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    step = max(1, _GATHER_ELEMS // (kv * (s + p) * d))
    for sl, uniq, inv in _distinct_rows(rows, step):
        k_tok = torch.cat([
            _rows_f32(k_cache, k_scale, page_table, page_size, uniq),
            k_spec[uniq].float()], dim=2)[inv]
        v_tok = torch.cat([
            _rows_f32(v_cache, v_scale, page_table, page_size, uniq),
            v_spec[uniq].float()], dim=2)[inv]
        live = torch.cat([key_pos[None, :] < clens[sl, None], amask[sl]],
                         dim=1)[:, None, None, :]           # [t', 1, 1, S+P]
        qr = q[sl].float().reshape(-1, kv, gq, d)
        scores = torch.einsum("tkgd,tksd->tkgs", qr, k_tok) * scale
        scores = scores.masked_fill(~live, NEG_INF)
        w = torch.exp(scores - scores.amax(-1, keepdim=True)) * live
        o = torch.einsum("tkgs,tksd->tkgd", w, v_tok) \
            / w.sum(-1, keepdim=True).clamp_min(1e-30)
        out[sl] = o.reshape(-1, qh, d).to(q.dtype)
    return out


def tree_attention_batched_plain(q, k_cache, v_cache, k_spec, v_spec, rows,
                                 clens, amask, scale, k_scale=None,
                                 v_scale=None, page_table=None, page_size=0):
    """Plain version of :func:`tree_attention_batched` (any device): the
    per-token function with each request's row, depth and mask rows
    repeated over its P tree tokens."""
    r, p, qh, d = q.shape
    out = tree_attention_plain(
        q.reshape(r * p, qh, d), k_cache, v_cache, k_spec, v_spec,
        rows.repeat_interleave(p), clens.repeat_interleave(p),
        amask.reshape(r * p, -1), scale, k_scale, v_scale, page_table,
        page_size)
    return out.reshape(r, p, qh, d)


def tree_split_plan(s_len: int):
    """``(n_split, split_blocks)``: the split-KV kernels (decode and both
    tree layouts, in both dtypes) cut each cache row's committed prefix
    into splits of
    ``split_blocks`` whole :data:`PAGE_BLOCK`-key blocks, ``n_split`` of
    them covering a cache of ``s_len`` positions.  The plan depends on
    shapes only, so the device path reads no positions or ``clens`` back;
    the splits past a row's keys are empty, except the tree kernels' last,
    which also takes the spec segment."""
    blocks = -(-s_len // PAGE_BLOCK)
    return max(1, -(-blocks // SPLIT_BLOCKS)), SPLIT_BLOCKS


def split_blocks(clen: int, s_len: int):
    """The committed blocks ``[lo, hi)`` that each split of
    :func:`tree_split_plan` reads for a request with ``clen`` committed
    keys, as the kernel computes them (the keys of a block at and past
    ``clen`` are masked)."""
    n_split, per = tree_split_plan(s_len)
    nb = -(-min(max(clen, 0), s_len) // PAGE_BLOCK)
    out = []
    for j in range(n_split):
        lo = min(j * per, nb)
        out.append((lo, min(lo + per, nb)))
    return out


def tree_token_split_partials_plain(q, k_cache, v_cache, k_spec, v_spec,
                                    rows, clens, amask, scale, k_scale=None,
                                    v_scale=None, page_table=None,
                                    page_size=0):
    """Plain version of the tree kernels' split pass (any device):
    each flat token's ``(m, l, acc)`` per split of :func:`tree_split_plan`
    over its committed keys ``< clens``, the last split also over the spec
    keys under its mask, f32, natural base (the kernels keep m in base 2).
    Returns ``m, l [n_split, T, QH]`` and ``acc [n_split, T, QH, D]``."""
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    p = k_spec.shape[2]
    n_split, per = tree_split_plan(s)
    rows = rows.long().clamp(0, r1 - 1)
    key_pos = torch.arange(s, device=q.device)
    k_tok = torch.cat([_rows_f32(k_cache, k_scale, page_table, page_size,
                                 rows), k_spec[rows].float()], dim=2)
    v_tok = torch.cat([_rows_f32(v_cache, v_scale, page_table, page_size,
                                 rows), v_spec[rows].float()], dim=2)
    qr = q.float().reshape(t, kv, qh // kv, d)
    scores = torch.einsum("tkgd,tksd->tkgs", qr, k_tok) * scale
    live = torch.cat([key_pos[None, :] < clens.long().clamp(0, s)[:, None],
                      amask], dim=1)
    split_id = torch.cat([key_pos // (per * PAGE_BLOCK),
                          torch.full((p,), n_split - 1, device=q.device)])
    return _split_partials(scores, v_tok, live, split_id, n_split)


def tree_split_partials_plain(q, k_cache, v_cache, k_spec, v_spec, rows,
                              clens, amask, scale, k_scale=None, v_scale=None,
                              page_table=None, page_size=0):
    """Plain version of the batched tree kernels' split pass (any
    device): :func:`tree_token_split_partials_plain` with each request's
    row, depth and mask rows repeated over its P tree tokens.  Returns
    ``m, l [n_split, R, P, QH]`` and ``acc [n_split, R, P, QH, D]``."""
    r, p, qh, d = q.shape
    m, l, acc = tree_token_split_partials_plain(
        q.reshape(r * p, qh, d), k_cache, v_cache, k_spec, v_spec,
        rows.repeat_interleave(p), clens.repeat_interleave(p),
        amask.reshape(r * p, -1), scale, k_scale, v_scale, page_table,
        page_size)
    n = m.shape[0]
    return (m.reshape(n, r, p, qh), l.reshape(n, r, p, qh),
            acc.reshape(n, r, p, qh, d))


def merge_partials_plain(m, l, acc):
    """Plain version of the split kernels' merge (any device): split partials
    ``m, l [n_split, ...]``, ``acc [n_split, ..., D]`` (natural base) ->
    the f32 output ``[..., D]``.  A partial with ``m = NEG_INF`` (no live
    key) weighs 0; a row with none gives zeros."""
    mx = m.amax(0)
    w = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp(m - mx))
    lsum = (l * w).sum(0)
    return (acc * w[..., None]).sum(0) / lsum.clamp_min(1e-30)[..., None]


def _check_spec_args(name, q, k_cache, k_spec, v_spec, amask, mask_shape):
    r1, kv, _, d = k_cache.shape
    if (k_spec.dim() != 4 or v_spec.shape != k_spec.shape
            or k_spec.shape[:2] != (r1, kv) or k_spec.shape[3] != d
            or k_spec.shape[2] < 1):
        raise ValueError(f"{name}: spec buffers must both be [R+1, KV, P, D]"
                         " beside caches [R+1, KV, S, D]")
    if k_spec.dtype != q.dtype or v_spec.dtype != q.dtype:
        raise TypeError(f"{name}: spec buffers must be in q's dtype")
    if amask.dtype != torch.bool or tuple(amask.shape) != mask_shape:
        raise ValueError(f"{name}: ancestor mask must be "
                         f"bool{list(mask_shape)}")
    for t in (k_spec, v_spec, amask):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    _check_aligned(name, k_spec, v_spec)


def tree_attention(q, k_cache, v_cache, k_spec, v_spec, rows, clens, amask,
                   scale: float, k_scale=None, v_scale=None, page_table=None,
                   page_size: int = 0):
    """Tree attention of flat tokens (one kernel row per token).

    ``q [T, QH, D]`` (RoPE applied); ``k_cache, v_cache [R+1, KV, S, D]``
    the committed caches (after this step's commit; int8 with ``k_scale,
    v_scale``; paged with ``page_table``/``page_size``); ``k_spec, v_spec
    [R+1, KV, P, D]`` the speculation-tree buffers in q's dtype holding
    this step's K/V; ``rows, clens int32[T]``; ``amask bool[T, P]``.
    Token t attends over row ``rows[t]``: committed keys at logical
    positions ``< clens[t]`` and spec keys j with ``amask[t, j]``.  Returns
    ``[T, QH, D]`` in q's dtype.
    """
    name = "tree_attention"
    check_cache_variant(name, k_cache, v_cache, k_scale, v_scale,
                        page_table, page_size)
    if _on_cpu(name, q, k_cache, v_cache, k_spec, v_spec, rows, clens,
               amask, k_scale, v_scale, page_table):
        return tree_attention_plain(q, k_cache, v_cache, k_spec, v_spec,
                                    rows, clens, amask, scale, k_scale,
                                    v_scale, page_table, page_size)
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    p = k_spec.shape[2]
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, clens, t)
    _check_spec_args(name, q, k_cache, k_spec, v_spec, amask, (t, p))
    split = _row_split_buffers(name, q, r1, kv, s)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, q.device, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            _ptr(page_table), k_spec.data_ptr(), v_spec.data_ptr(),
            rows.data_ptr(), clens.data_ptr(), amask.data_ptr(),
            _ptr(split[0]), _ptr(split[1]), out.data_ptr(), t, kv, gq, r1, s,
            p, d, page_size, *split[2:], float(scale),
            _DTYPE_CODES[q.dtype], stream)
    _count(tree_attention, k_scale, page_table)
    return out


def tree_attention_batched(q, k_cache, v_cache, k_spec, v_spec, rows, clens,
                           amask, scale: float, k_scale=None, v_scale=None,
                           page_table=None, page_size: int = 0):
    """Tree attention for a fixed ``[requests x tree slots]`` layout (one
    kernel row per request, so its committed prefix streams once).

    ``q [R, P, QH, D]``: the P tree tokens of request r; caches, scales,
    page table and spec buffers as :func:`tree_attention` (spec length
    ``Pb``); ``rows, clens int32[R]``; ``amask bool[R, P, Pb]``.  Returns
    ``[R, P, QH, D]``.
    """
    name = "tree_attention_batched"
    check_cache_variant(name, k_cache, v_cache, k_scale, v_scale,
                        page_table, page_size)
    if _on_cpu(name, q, k_cache, v_cache, k_spec, v_spec, rows, clens,
               amask, k_scale, v_scale, page_table):
        return tree_attention_batched_plain(
            q, k_cache, v_cache, k_spec, v_spec, rows, clens, amask, scale,
            k_scale, v_scale, page_table, page_size)
    r, p, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    pb = k_spec.shape[2]
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, clens, r)
    _check_spec_args(name, q, k_cache, k_spec, v_spec, amask, (r, p, pb))
    # split-KV: the (m, l) pairs and accumulators of every split
    n_split, per = tree_split_plan(s)
    if q.dtype == torch.float32:
        rows_per_cta = TF32_ROW_TILE
    else:
        rows_per_cta = 16 if p * gq <= 16 else 64
    if kv > 65535 or r * -(-p * gq // rows_per_cta) > 65535:
        raise ValueError(f"{name}: {r} requests x {kv} KV heads exceed the "
                         "kernel's grid")
    scratch = torch.empty(n_split * r * kv * p * gq * (d + 2),
                          dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, q.device, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            _ptr(page_table), k_spec.data_ptr(), v_spec.data_ptr(),
            rows.data_ptr(), clens.data_ptr(), amask.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), r, p, kv, gq, r1, s, pb, d,
            page_size, n_split, per, float(scale), _DTYPE_CODES[q.dtype],
            stream)
    _count(tree_attention_batched, k_scale, page_table)
    return out


# ---------------------------------------------------------------------------
# The f32 tile engine's fragment layout, for the card tests
# ---------------------------------------------------------------------------
def tf32x3_probe(mode: int, a, b=None):
    """One warp of the f32 tile engine (``csrc/tc_attention_f32.cuh``) on
    CUDA float32 tensors, through its fragment layout and 3xTF32 products:
    mode 0, ``a [16, D] . b [8, D]^T`` (``[16, 8]``); mode 1, ``a [16, 8]
    . b [8, D]`` (``[16, D]``); mode 2, the TF32 high and low parts of each
    value of ``a`` as the products read them, then ``cvt.rna.tf32.f32`` of
    the value and of the value minus its high part (``[n, 4]``).  Not on
    the serve path: the card tests hold it against exact integer products,
    which pins the layout, and the split against the hardware rounding."""
    name = "tf32x3_probe"
    a = a.contiguous()
    if a.dtype != torch.float32 or a.device.type != "cuda":
        raise ValueError(f"{name}: takes float32 CUDA tensors")
    if mode == 2:
        c = torch.empty(a.numel(), 4, dtype=torch.float32, device=a.device)
        d, n, bp = 8, a.numel(), None
    else:
        b = b.contiguous()
        d = b.shape[1]
        if b.dtype != torch.float32 or b.device != a.device:
            raise ValueError(f"{name}: takes float32 CUDA tensors")
        if (d not in HEAD_DIMS or b.shape[0] != 8
                or tuple(a.shape) != ((16, d) if mode == 0 else (16, 8))):
            raise ValueError(f"{name}: shapes {tuple(a.shape)}, "
                             f"{tuple(b.shape)} do not fit mode {mode}")
        c = torch.empty(16, 8 if mode == 0 else d, dtype=torch.float32,
                        device=a.device)
        n, bp = 0, b.data_ptr()
    _launch(name, a.device, _kernel(name), a.data_ptr(), bp, c.data_ptr(),
            mode, d, n, torch.cuda.current_stream(a.device).cuda_stream)
    return c


reset_counts()
