"""Serving attention: fused QKV, RoPE, KV-cache write, attention, o_proj.

Port of ``flexflow_tpu/serve/ops.py``'s ``IncMultiHeadSelfAttention`` for
the incremental (``BatchConfig``), tiled-prefill (``PrefillBatchConfig``)
and speculation-tree (``TreeSearchBatchConfig``, ``TreeVerifyBatchConfig``)
modes on one device: no tensor parallelism, no int8 or paged KV, no
ALiBi.  Layouts are the reference's: the fused QKV
weight is ``[E, KV, gq + 2, D]`` (per KV head, its gq query heads, then K,
then V), ``o_proj`` is ``[QH*D, E]`` and the caches are kv-head-major
``[R+1, KV, S, D]`` with row ``R`` the pad tokens' scratch row.

The caches are updated IN PLACE (``index_put_``): the reference threads
them functionally through a jitted step with donated buffers, which is the
same memory behaviour; so are the spec buffers ``sk``/``sv``.  Attention
goes through the hand-written CUDA kernels of
:mod:`flexflow_tpu_torch.ops.cuda.attention`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.cuda.attention import (
    decode_attention,
    prefill_attention,
    tree_attention,
    tree_attention_batched,
)
from .batch_config import (
    BatchConfig,
    PrefillBatchConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding (reference :115); ``x [T, ..., D]``, positions
    ``[T]``.  Angles in float32, result cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions.float()[:, None] * freq                 # [T, half]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
    cos = torch.cos(angles).reshape(shape)
    sin = torch.sin(angles).reshape(shape)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class IncMultiHeadSelfAttention(nn.Module):
    """KV-cached GQA self-attention over flat token batches.

    ``forward(x [T, E], bc, state)`` with ``state = {"k", "v"}`` this
    layer's caches; returns ``[T, E]``.  ``name`` is the module's path in
    the model, the key of its caches in the allocator's state.
    """

    def __init__(self, embed_dim: int, num_q_heads: int,
                 num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None, rope_theta: float = 10000.0,
                 scaling_factor: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embed_dim = int(embed_dim)
        self.num_q_heads = int(num_q_heads)
        self.num_kv_heads = int(num_kv_heads or num_q_heads)
        self.head_dim = int(head_dim or embed_dim // num_q_heads)
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError("num_q_heads must be a multiple of num_kv_heads")
        self.q_per_kv = self.num_q_heads // self.num_kv_heads
        self.rope_theta = float(rope_theta)
        self.scaling_factor = (float(scaling_factor)
                               if scaling_factor is not None
                               else 1.0 / math.sqrt(self.head_dim))
        self.name = ""
        self.qkv = nn.Parameter(torch.empty(
            self.embed_dim, self.num_kv_heads, self.q_per_kv + 2,
            self.head_dim, dtype=dtype, device=device), requires_grad=False)
        self.o_proj = nn.Parameter(torch.empty(
            self.num_q_heads * self.head_dim, self.embed_dim, dtype=dtype,
            device=device), requires_grad=False)

    def forward(self, x: torch.Tensor, bc, state: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        q, k, v = self._project(x, bc)
        if isinstance(bc, TreeVerifyBatchConfig):
            # last macro-step's accepted K/V joins the committed cache
            # before this step's tree overwrites the spec buffer
            self._commit(state, bc)
            out = self._tree_attend(q, k, v, state, bc)
        elif isinstance(bc, TreeSearchBatchConfig):
            out = self._tree_attend(q, k, v, state, bc)
        elif isinstance(bc, PrefillBatchConfig):
            out = self._prefill_attend(q, k, v, state, bc)
        else:
            out = self._inc_attend(q, k, v, state, bc)
        t = out.shape[0]
        return torch.matmul(
            out.reshape(t, self.num_q_heads * self.head_dim), self.o_proj)

    def _project(self, x, bc) -> Tuple[torch.Tensor, ...]:
        """One GEMM for Q, K and V, then RoPE (reference :359-375)."""
        base = bc if isinstance(bc, BatchConfig) else bc.base
        t = x.shape[0]
        qkv = torch.matmul(x, self.qkv.reshape(self.embed_dim, -1)).reshape(
            t, self.num_kv_heads, self.q_per_kv + 2, self.head_dim)
        q = qkv[:, :, : self.q_per_kv, :]          # [T, KV, gq, D]
        k = qkv[:, :, self.q_per_kv, :]            # [T, KV, D]
        v = qkv[:, :, self.q_per_kv + 1, :]        # [T, KV, D]
        pos = base.token_position
        q = apply_rope(q, pos, self.rope_theta)
        k = apply_rope(k, pos, self.rope_theta)
        return q, k, v

    @staticmethod
    def _rows(bc: BatchConfig, max_requests: int) -> torch.Tensor:
        """Cache row per flat token; pad tokens land in the scratch row."""
        r = bc.request_index
        return torch.where(r >= 0, r, max_requests)

    @staticmethod
    def _write_kv(state, rows, pos, k, v) -> None:
        """``cache[rows[t], :, pos[t]] = k[t]`` (and v), in place; rows and
        positions are clipped into range as the reference clips them."""
        kc, vc = state["k"], state["v"]
        r = rows.long().clamp(0, kc.shape[0] - 1)
        p = pos.long().clamp(0, kc.shape[2] - 1)
        kc[r, :, p] = k.to(kc.dtype)
        vc[r, :, p] = v.to(vc.dtype)

    def _inc_attend(self, q, k, v, state, bc: BatchConfig):
        """Flat-token attention (reference :557-651)."""
        kc, vc = state["k"], state["v"]
        nreq = kc.shape[0] - 1
        rows = self._rows(bc, nreq)
        pos = bc.token_position
        self._write_kv(state, rows, pos, k, v)
        # pad tokens (scratch row) read one key, not a whole row: their
        # outputs are discarded (reference :577)
        pos = torch.where(rows == nreq, 0, pos)
        t = q.shape[0]
        return decode_attention(
            q.reshape(t, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, rows.to(torch.int32).contiguous(),
            pos.to(torch.int32).contiguous(), self.scaling_factor)

    def _prefill_attend(self, q, k, v, state, bc: PrefillBatchConfig):
        """Attention over request-homogeneous query tiles (reference
        :653-784).  Each tile's whole ``[KV, Bq, D]`` K/V block is written
        at the tile's row and start, tail pads as zeros (fresh caches are
        zeros, so the tiled and flat paths leave identical caches), in one
        ``index_put_`` covering every tile."""
        base = bc.base
        kc, vc = state["k"], state["v"]
        nreq = kc.shape[0] - 1
        rows = self._rows(base, nreq)
        pos = base.token_position
        t = q.shape[0]
        bq = bc.tile_size
        g = t // bq
        # real slots sit at the tile head and pads map to the scratch row
        # (the largest index), so the min recovers the tile's request
        tile_rows = rows.reshape(g, bq).amin(dim=1)
        pstart = pos.reshape(g, bq)[:, 0]
        valid = (base.request_index >= 0)[:, None, None]
        w_rows = tile_rows.repeat_interleave(bq)
        w_pos = (pstart[:, None] + torch.arange(bq, device=pos.device)
                 ).reshape(-1)
        self._write_kv(state, w_rows, w_pos, torch.where(valid, k, 0),
                       torch.where(valid, v, 0))
        out = prefill_attention(
            q.reshape(g, bq, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, tile_rows.to(torch.int32).contiguous(),
            pstart.to(torch.int32).contiguous(), self.scaling_factor)
        return out.reshape(t, self.num_q_heads, self.head_dim)

    def _commit(self, state, bc: TreeVerifyBatchConfig) -> None:
        """Copy accepted speculative K/V (spec buffer -> committed cache),
        in place (reference :786).  Pad entries read and write the scratch
        row."""
        kc, sk, sv = state["k"], state["sk"], state["sv"]
        nreq = kc.shape[0] - 1
        ri = bc.commit_request_index
        rows = torch.where(ri >= 0, ri, nreq).long()
        src = bc.commit_src_spec_index.long().clamp(0, sk.shape[2] - 1)
        self._write_kv(state, rows, bc.commit_dst_position,
                       sk[rows, :, src], sv[rows, :, src])

    def _tree_attend(self, q, k, v, state, bc):
        """Attention over the committed cache (positions below the
        request's committed depth) plus the spec buffer (ancestor mask),
        after this step's K/V lands in the spec buffer at ``spec_index``
        (reference :815).  Pad tokens use the scratch row with committed
        depth 0 and an empty mask, so they read no key."""
        base = bc.base
        kc, vc, sk, sv = state["k"], state["v"], state["sk"], state["sv"]
        nreq = kc.shape[0] - 1
        rows = self._rows(base, nreq).long()
        spec_idx = bc.spec_index.long().clamp(0, sk.shape[2] - 1)
        sk[rows, :, spec_idx] = k.to(sk.dtype)
        sv[rows, :, spec_idx] = v.to(sv.dtype)
        real = rows < nreq
        req = rows.clamp(max=nreq - 1)
        clens = torch.where(real, bc.committed_lens[req], 0).to(torch.int32)
        amask = bc.ancestor_mask[req, spec_idx] & real[:, None]
        t = q.shape[0]
        qf = q.reshape(t, self.num_q_heads, self.head_dim)
        layout = getattr(bc, "tree_layout", None)
        if layout is None:
            return tree_attention(
                qf.contiguous(), kc, vc, sk, sv,
                rows.to(torch.int32).contiguous(), clens.contiguous(),
                amask.contiguous(), self.scaling_factor)
        # fixed [R, P] layout of exactly R*P tokens: token r*P + j is node
        # j of slot r, so one kernel row per request streams its committed
        # prefix once
        r_t, p_t = layout
        return tree_attention_batched(
            qf.reshape(r_t, p_t, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, sk, sv, rows[::p_t].to(torch.int32).contiguous(),
            clens[::p_t].contiguous(),
            amask.reshape(r_t, p_t, -1).contiguous(),
            self.scaling_factor).reshape(t, self.num_q_heads, self.head_dim)
