"""Ring attention: attention over a sequence split across a mesh axis.

Port of ``flexflow_tpu/parallel/ring_attention.py`` (:27-78).  Each shard
holds a block of the queries, keys and values; the key and value blocks
travel round the ring while a blockwise online softmax accumulates, so a
shard holds scores for one ``T/n x T/n`` block at a time, never ``T x
T``.  The reference runs inside ``shard_map`` and rotates the blocks
with ``lax.ppermute``; here :func:`ring_attention` is a shard-local
generator that ``parallel/comm.py:run_shards`` steps in lockstep: it
asks for its place on the axis (``("axis_index", 0, axes)``) and shifts
the blocks one place on (``("shift", t, axes, 1)``), whose backward is
the reverse shift, so autograd gives the ring's backward.

Numerics are the reference's: the products in float32 (``torch.matmul``,
no ``scaled_dot_product_attention``), masked scores ``NEG_INF``, a fully
masked row's probabilities kept exactly 0, the denominator clamped at
``1e-30``.  The reference's last rotation brings the blocks home and is
never read; the port skips it, so a call shifts each of ``k`` and ``v``
``n_shards - 1`` times.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, n_shards: int, causal: bool = False,
                   scale: Optional[float] = None):
    """This shard's attention output ``[B, T_loc, H, D]`` (before the
    output projection) of its query block ``q`` ``[B, T_loc, H, D]`` over
    every shard's ``k``/``v`` blocks, in ``q``'s dtype.  A generator of
    the ring's collectives over ``axis_name``."""
    b, t_loc, h, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    axes = (axis_name,)
    idx = yield ("axis_index", 0, axes)
    dev = q.device
    qpos = idx * t_loc + torch.arange(t_loc, device=dev)
    qf = q.float().transpose(1, 2)                       # [b, h, q, d]
    m = torch.full((b, h, t_loc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, t_loc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t_loc, d), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for step in range(n_shards):
        src = (idx - step) % n_shards   # the shard this block came from
        scores = torch.matmul(
            qf, k_blk.float().permute(0, 2, 3, 1)) * scale   # [b, h, q, k]
        if causal:
            kpos = src * t_loc + torch.arange(t_loc, device=dev)
            mask = kpos[None, :] <= qpos[:, None]
            scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        if causal:   # fully masked rows: keep p exactly zero
            p = torch.where(mask, p, 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v_blk.float().transpose(1, 2))
        m = m_new
        if step < n_shards - 1:
            k_blk = yield ("shift", k_blk, axes, 1)
            v_blk = yield ("shift", v_blk, axes, 1)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)
