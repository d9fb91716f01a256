"""The serve path's attention kernels: CUDA wrappers and their plain versions.

``decode_attention`` replaces the Pallas kernel of the same name
(``flexflow_tpu/ops/pallas/attention.py:209``), ``prefill_attention``
replaces ``prefill_attention`` (:444), and ``tree_attention`` /
``tree_attention_batched`` replace the two layouts of the tree kernel
(:790, :836, both through ``_tree_call`` :675), all on their fp,
slot-contiguous, no-ALiBi paths.  The kernels are hand-written CUDA C++ for
sm_90a (``flexflow_tpu_torch/csrc/``), built by ``nvcc`` on first use
(:mod:`.build`) and called through a plain C interface.

Each wrapper launches its kernel for CUDA tensors, or raises: there is no
fall-back for them.  It takes the plain PyTorch version only when the
tensors it was given lie on the CPU.  The plain versions are the same
function written as a masked softmax over gathered cache rows in f32, the
gather path of ``flexflow_tpu/serve/ops.py:613-651``; the CPU tests hold
them against the JAX kernels, and the card holds the kernels against them.

Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)     # head dims the kernels are built for
DECODE_GROUPS = (1, 2, 4, 8)         # query heads per KV head (decode)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the plain decode version gathers at most this many cache elements at once
_GATHER_ELEMS = 1 << 27

_FNS: Dict[str, object] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, rows, pos, out, n_tokens, num_kv, gq, r1, s_len, head_dim,
    # scale, dtype, stream
    "decode_attention": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, rows, pstart, out, n_tiles, bq, num_kv, gq, r1, s_len,
    # head_dim, scale, dtype, stream
    "prefill_attention": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, sk, sv, rows, clens, amask, out, n_tokens, num_kv, gq, r1,
    # s_len, p_len, head_dim, scale, dtype, stream
    "tree_attention": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, sk, sv, rows, clens, amask, out, n_req, p_tok, num_kv, gq,
    # r1, s_len, p_len, head_dim, scale, dtype, stream
    "tree_attention_batched": [_P] * 9 + [_I] * 8 + [_F, _I, _P],
}
# the library (csrc/<source>.cu) each entry point lives in
_SOURCE = {"tree_attention_batched": "tree_attention"}


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
    CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def _check_kernel_args(name, q, k_cache, v_cache, idx_a, idx_b, n, gq,
                       groups=None):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must both be [R+1, KV, S, D]")
    d = q.shape[-1]
    if k_cache.shape[-1] != d or d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported {HEAD_DIMS}")
    if groups is not None and gq not in groups:
        raise ValueError(f"{name}: {gq} query heads per KV head not "
                         f"supported {groups}")
    for t in (idx_a, idx_b):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name}: index arrays must be int32[{n}]")
    for t in (q, k_cache, v_cache, idx_a, idx_b):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if max(q.shape + k_cache.shape) >= 2 ** 31:
        raise ValueError(f"{name}: a dimension does not fit the kernel's "
                         "32-bit sizes")


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# K1: decode attention
# ---------------------------------------------------------------------------
def decode_attention_plain(q, k_cache, v_cache, rows, positions, scale):
    """Plain version of :func:`decode_attention` (any device)."""
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    gq = qh // kv
    rows = rows.long().clamp(0, r1 - 1)
    pos = positions.long()
    key_pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    step = max(1, _GATHER_ELEMS // (kv * s * d))
    for lo in range(0, t, step):
        sl = slice(lo, lo + step)
        k_tok = k_cache[rows[sl]].float()               # [t', KV, S, D]
        v_tok = v_cache[rows[sl]].float()
        qr = q[sl].float().reshape(-1, kv, gq, d)
        scores = torch.einsum("tkgd,tksd->tkgs", qr, k_tok) * scale
        mask = key_pos[None, :] <= pos[sl, None]        # [t', S]
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("tkgs,tksd->tkgd", w, v_tok)
        out[sl] = o.reshape(-1, qh, d).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, rows, positions, scale: float):
    """Attention of flat decode tokens over their cache rows.

    ``q [T, QH, D]`` (RoPE applied); ``k_cache, v_cache [R+1, KV, S, D]``
    holding this step's K/V already; ``rows, positions int32[T]``.  Token
    t attends with its query heads over cache row ``rows[t]`` at key
    positions ``<= positions[t]``.  Returns ``[T, QH, D]`` in q's dtype.
    """
    name = "decode_attention"
    if _on_cpu(name, q, k_cache, v_cache, rows, positions):
        return decode_attention_plain(q, k_cache, v_cache, rows, positions,
                                      scale)
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, positions, t, gq,
                       DECODE_GROUPS)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), rows.data_ptr(), positions.data_ptr(),
            out.data_ptr(), t, kv, gq, r1, s, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: prefill attention
# ---------------------------------------------------------------------------
def prefill_attention_plain(q, k_cache, v_cache, rows, pstart, scale):
    """Plain version of :func:`prefill_attention` (any device)."""
    g, bq, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    gq = qh // kv
    rows = rows.long().clamp(0, r1 - 1)
    qpos = pstart.long()[:, None] + torch.arange(bq, device=q.device)
    key_pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for i in range(g):   # one tile at a time bounds the gathered rows
        k_t = k_cache.index_select(0, rows[i:i + 1])[0].float()  # [KV, S, D]
        v_t = v_cache.index_select(0, rows[i:i + 1])[0].float()
        qr = q[i].float().reshape(bq, kv, gq, d)
        scores = torch.einsum("bkgd,ksd->bkgs", qr, k_t) * scale
        mask = key_pos[None, :] <= qpos[i][:, None]      # [Bq, S]
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgs,ksd->bkgd", w, v_t)
        out[i] = o.reshape(bq, qh, d).to(q.dtype)
    return out


def prefill_attention(q, k_cache, v_cache, rows, pstart, scale: float):
    """Causal attention of G prompt tiles over their cache rows.

    ``q [G, Bq, QH, D]``: tile g holds Bq tokens of one request at
    positions ``pstart[g] + b``; ``k_cache, v_cache [R+1, KV, S, D]``
    already hold this step's K/V; ``rows, pstart int32[G]``.  Query b of
    tile g sees keys ``<= pstart[g] + b`` of row ``rows[g]``.  Returns
    ``[G, Bq, QH, D]`` in q's dtype.
    """
    name = "prefill_attention"
    if _on_cpu(name, q, k_cache, v_cache, rows, pstart):
        return prefill_attention_plain(q, k_cache, v_cache, rows, pstart,
                                       scale)
    g, bq, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, pstart, g, gq)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), rows.data_ptr(), pstart.data_ptr(),
            out.data_ptr(), g, bq, kv, gq, r1, s, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0


# ---------------------------------------------------------------------------
# K3: tree attention (committed cache + speculation-tree buffer)
# ---------------------------------------------------------------------------
def tree_attention_plain(q, k_cache, v_cache, k_spec, v_spec, rows, clens,
                         amask, scale):
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
    for lo in range(0, t, step):
        sl = slice(lo, lo + step)
        r = rows[sl]
        k_tok = torch.cat([k_cache[r], k_spec[r]], dim=2).float()
        v_tok = torch.cat([v_cache[r], v_spec[r]], dim=2).float()
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
                                 clens, amask, scale):
    """Plain version of :func:`tree_attention_batched` (any device): the
    per-token function with each request's row, depth and mask rows
    repeated over its P tree tokens."""
    r, p, qh, d = q.shape
    out = tree_attention_plain(
        q.reshape(r * p, qh, d), k_cache, v_cache, k_spec, v_spec,
        rows.repeat_interleave(p), clens.repeat_interleave(p),
        amask.reshape(r * p, -1), scale)
    return out.reshape(r, p, qh, d)


def _check_spec_args(name, k_cache, k_spec, v_spec, amask, mask_shape):
    r1, kv, _, d = k_cache.shape
    if (k_spec.dim() != 4 or v_spec.shape != k_spec.shape
            or k_spec.shape[:2] != (r1, kv) or k_spec.shape[3] != d
            or k_spec.shape[2] < 1):
        raise ValueError(f"{name}: spec buffers must both be [R+1, KV, P, D]"
                         " beside caches [R+1, KV, S, D]")
    if k_spec.dtype != k_cache.dtype or v_spec.dtype != k_cache.dtype:
        raise TypeError(f"{name}: spec buffers must share the caches' dtype")
    if amask.dtype != torch.bool or tuple(amask.shape) != mask_shape:
        raise ValueError(f"{name}: ancestor mask must be "
                         f"bool{list(mask_shape)}")
    for t in (k_spec, v_spec, amask):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def tree_attention(q, k_cache, v_cache, k_spec, v_spec, rows, clens, amask,
                   scale: float):
    """Tree attention of flat tokens (one kernel row per token).

    ``q [T, QH, D]`` (RoPE applied); ``k_cache, v_cache [R+1, KV, S, D]``
    the committed caches (after this step's commit); ``k_spec, v_spec
    [R+1, KV, P, D]`` the speculation-tree buffers holding this step's K/V;
    ``rows, clens int32[T]``; ``amask bool[T, P]``.  Token t attends over
    row ``rows[t]``: committed keys at positions ``< clens[t]`` and spec
    keys j with ``amask[t, j]``.  Returns ``[T, QH, D]`` in q's dtype.
    """
    name = "tree_attention"
    if _on_cpu(name, q, k_cache, v_cache, k_spec, v_spec, rows, clens,
               amask):
        return tree_attention_plain(q, k_cache, v_cache, k_spec, v_spec,
                                    rows, clens, amask, scale)
    t, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    p = k_spec.shape[2]
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, clens, t, gq,
                       DECODE_GROUPS)
    _check_spec_args(name, k_cache, k_spec, v_spec, amask, (t, p))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_spec.data_ptr(), v_spec.data_ptr(),
            rows.data_ptr(), clens.data_ptr(), amask.data_ptr(),
            out.data_ptr(), t, kv, gq, r1, s, p, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    tree_attention.launches += 1
    return out


tree_attention.launches = 0


def tree_attention_batched(q, k_cache, v_cache, k_spec, v_spec, rows, clens,
                           amask, scale: float):
    """Tree attention for a fixed ``[requests x tree slots]`` layout (one
    kernel row per request, so its committed prefix streams once).

    ``q [R, P, QH, D]``: the P tree tokens of request r; caches and spec
    buffers as :func:`tree_attention` (spec length ``Pb``); ``rows, clens
    int32[R]``; ``amask bool[R, P, Pb]``.  Returns ``[R, P, QH, D]``.
    """
    name = "tree_attention_batched"
    if _on_cpu(name, q, k_cache, v_cache, k_spec, v_spec, rows, clens,
               amask):
        return tree_attention_batched_plain(q, k_cache, v_cache, k_spec,
                                            v_spec, rows, clens, amask, scale)
    r, p, qh, d = q.shape
    r1, kv, s, _ = k_cache.shape
    pb = k_spec.shape[2]
    if qh % kv:
        raise ValueError(f"{name}: {qh} query heads not a multiple of {kv}")
    gq = qh // kv
    _check_kernel_args(name, q, k_cache, v_cache, rows, clens, r, gq)
    _check_spec_args(name, k_cache, k_spec, v_spec, amask, (r, p, pb))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(name, _kernel(name), q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), k_spec.data_ptr(), v_spec.data_ptr(),
            rows.data_ptr(), clens.data_ptr(), amask.data_ptr(),
            out.data_ptr(), r, p, kv, gq, r1, s, pb, d, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    tree_attention_batched.launches += 1
    return out


tree_attention_batched.launches = 0
