"""MultiHeadAttention, the training path's attention.

Port of ``flexflow_tpu/ops/attention.py``: the reference's parameters and
layouts (``wq``/``wk``/``wv`` ``[e, h, hd]``, ``wo`` ``[h, hd, e]``, the
biases ``bq``/``bk``/``bv`` ``[h, hd]`` and ``bo`` ``[e]``, :55-71), and
its compute (:73-119): the projections, scores and values are
``torch.matmul`` products, the causal mask is ``-inf``, then a softmax
and, while training with a step stream (``OpContext.stream``), dropout
on the probabilities; autograd gives the backward.  No
``scaled_dot_product_attention``: the reference's XLA-lowered einsums
become ordinary products here.

The op IR (:121-192): ``head`` shards the four projections' head dims
(the output projection row-parallel, its output a partial sum whose
``bo`` is counted once, ``core/op.py:bias_once``), ``sample`` the batch;
a shard computes on the heads and rows it holds, as the plan executor
(``parallel/tp.py``) gives them.  ``sequence`` (one mesh axis) gives each
shard a block of the sequence, and the shard runs ring attention over
the axis (``parallel/ring_attention.py``): its key and value blocks
travel round the ring under an online softmax, so no shard holds more
than one block of scores.  The reference rings in its shard-local mode
(``"local"``) and runs GSPMD's global attention in its SPMD mode, the
same values; the port has one shard-local executor for both modes, so
both ring.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, bias_once, register_op
from ..core.sharding import TensorSharding
from ..parallel.ring_attention import ring_attention
from .elementwise import dropout


@register_op
class MultiHeadAttention(Op, nn.Module):
    type_name = "multihead_attention"
    uses_context = True

    def __init__(self, embed_dim: int, num_heads: int,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 dropout: float = 0.0, use_bias: bool = True,
                 causal: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.kdim = int(kdim or embed_dim)
        self.vdim = int(vdim or embed_dim)
        self.dropout = float(dropout)
        self.use_bias = bool(use_bias)
        self.causal = bool(causal)
        self.compute_dtype = dtype
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must divide num_heads")
        self.head_dim = self.embed_dim // self.num_heads
        for p in self.params():
            setattr(self, p.name, nn.Parameter(
                torch.empty(p.spec.shape, dtype=dtype, device=device),
                requires_grad=False))

    def infer_shapes(self, in_specs):
        q = in_specs[0]
        return [TensorSpec(tuple(q.shape[:-1]) + (self.embed_dim,),
                           self.compute_dtype)]

    def params(self):
        d = self.compute_dtype
        e, h, hd = self.embed_dim, self.num_heads, self.head_dim
        ps = [ParamSpec("wq", TensorSpec((e, h, hd), d)),
              ParamSpec("wk", TensorSpec((self.kdim, h, hd), d)),
              ParamSpec("wv", TensorSpec((self.vdim, h, hd), d)),
              ParamSpec("wo", TensorSpec((h, hd, e), d))]
        if self.use_bias:
            ps += [ParamSpec("bq", TensorSpec((h, hd), d)),
                   ParamSpec("bk", TensorSpec((h, hd), d)),
                   ParamSpec("bv", TensorSpec((h, hd), d)),
                   ParamSpec("bo", TensorSpec((e,), d))]
        return ps

    def _project(self, x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor]) -> torch.Tensor:
        """``einsum("bse,ehd->bhsd", x, w) (+ b)``: [b, h, s, hd]."""
        h, hd = w.shape[1], w.shape[2]
        y = torch.matmul(x, w.reshape(w.shape[0], h * hd))
        y = y.view(*x.shape[:-1], h, hd)
        if b is not None:
            y = y + b
        return y.transpose(1, 2)

    def forward(self, q_in, k_in, v_in, ctx):
        seq = tuple(ctx.config.get("sequence", ())) if ctx.config else ()
        if seq and ctx.mesh is not None:
            return self._sequence_forward(q_in, k_in, v_in, ctx, seq)
        return self._attend(q_in, k_in, v_in, ctx)

    def _sequence_forward(self, q_in, k_in, v_in, ctx, axes):
        """The ``sequence`` split: a generator running ring attention of
        this shard's query block over ``axes`` (reference :88-99)."""
        bias = self.use_bias
        q = self._project(q_in, self.wq, self.bq if bias else None)
        k = self._project(k_in, self.wk, self.bk if bias else None)
        v = self._project(v_in, self.wv, self.bv if bias else None)
        (axis,) = axes
        ctx_v = yield from ring_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), axis,
            ctx.mesh.shape[axis], causal=self.causal,
            scale=1.0 / math.sqrt(self.head_dim))
        return self._out_project(ctx_v, ctx)

    def _attend(self, q_in, k_in, v_in, ctx):
        """The attention of ``q_in``'s rows over ``k_in``/``v_in``."""
        bias = self.use_bias
        q = self._project(q_in, self.wq, self.bq if bias else None)
        k = self._project(k_in, self.wk, self.bk if bias else None)
        v = self._project(v_in, self.wv, self.bv if bias else None)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (
            1.0 / math.sqrt(self.head_dim))
        if self.causal:
            qlen, klen = scores.shape[-2], scores.shape[-1]
            mask = torch.ones(qlen, klen, dtype=torch.bool,
                              device=scores.device).tril()
            scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        gen = ctx.stream(probs.device) if ctx.training else None
        if self.dropout > 0 and gen is not None:
            probs = dropout(probs, self.dropout, gen)
        ctx_v = torch.matmul(probs.to(v.dtype), v)        # [b, h, q, hd]
        return self._out_project(ctx_v.transpose(1, 2), ctx)

    def _out_project(self, ctx_v, ctx):
        """The output projection of ``ctx_v`` ``[b, q, h, hd]``."""
        b_, s, h, hd = ctx_v.shape
        out = torch.matmul(ctx_v.reshape(b_, s, h * hd),
                           self.wo.reshape(h * hd, self.embed_dim))
        if self.use_bias:
            head = tuple(ctx.config.get("head", ())) if ctx.config else ()
            out = out + bias_once(self.bo, head, ctx)
        return out.to(self.compute_dtype)

    # ---- op IR (reference :121-192) -------------------------------------
    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0],
                "head": self.num_heads,
                "sequence": in_specs[0].shape[1]
                if in_specs[0].ndim > 2 else 1}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        q, k, v = in_specs
        sample = tuple(config.get("sample", ()))
        head = tuple(config.get("head", ()))
        seq = tuple(config.get("sequence", ()))
        if seq and len(seq) != 1:
            raise ValueError("sequence parallelism uses exactly one mesh "
                             "axis")
        if seq and (self.dropout or 0) > 0:
            raise ValueError("sequence parallelism + attention dropout "
                             "is not supported")
        if seq and q.shape[1] != k.shape[1]:
            raise ValueError(
                "sequence parallelism requires equal q/k sequence lengths "
                f"(got {q.shape[1]} vs {k.shape[1]}); ring attention "
                "rotates same-size blocks")

        def in_sh(spec):
            sh = TensorSharding.replicated(spec.ndim)
            if sample:
                sh = sh.with_dim(0, sample)
            if seq:
                sh = sh.with_dim(1, seq)
            return sh

        out = self.infer_shapes([q, k, v])[0]
        out_sh = TensorSharding.replicated(out.ndim)
        if sample:
            out_sh = out_sh.with_dim(0, sample)
        if seq:
            out_sh = out_sh.with_dim(1, seq)
        if head:
            out_sh = out_sh.with_partial(head)

        params = {}
        for w in ("wq", "wk", "wv"):
            sh = TensorSharding.replicated(3)
            params[w] = sh.with_dim(1, head) if head else sh
        wo_sh = TensorSharding.replicated(3)
        params["wo"] = wo_sh.with_dim(0, head) if head else wo_sh
        if self.use_bias:
            for b in ("bq", "bk", "bv"):
                sh = TensorSharding.replicated(2)
                params[b] = sh.with_dim(0, head) if head else sh
            params["bo"] = TensorSharding.replicated(1)
        return ShardingSolution(inputs=[in_sh(q), in_sh(k), in_sh(v)],
                                outputs=[out_sh], params=params)

    def flops(self, in_specs):
        q, k, v = in_specs
        b, sq = q.shape[0], q.shape[1]
        sk = k.shape[1]
        e, h, hd = self.embed_dim, self.num_heads, self.head_dim
        proj = 2 * b * sq * e * h * hd * 3 + 2 * b * sq * h * hd * e
        attn = 2 * b * h * sq * sk * hd * 2
        return proj + attn
