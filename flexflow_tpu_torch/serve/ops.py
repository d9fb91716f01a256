"""Serving attention: fused QKV, RoPE, KV-cache write, attention, o_proj.

Port of ``flexflow_tpu/serve/ops.py``'s ``IncMultiHeadSelfAttention`` for
the incremental (``BatchConfig``), tiled-prefill (``PrefillBatchConfig``)
and speculation-tree (``TreeSearchBatchConfig``, ``TreeVerifyBatchConfig``)
modes on one device, with int8 weights (``qkv``/``o_proj`` beside their
``_scale``, dequantized before each product, reference :330-333,
:353-356), int8 KV caches (quantize-on-write, reference :429-496) and
paged KV caches (writes translated through the page table, reference
:50), and the other families' options (reference :164-193): RoPE or none,
biased projections, ALiBi through the decode kernel's slopes.  A
speculative step of an ALiBi layer takes the reference's gather path
(:830-836, :908-958) as torch ops, as no Pallas kernel computes it there:
the spec slots' positions in a ``spec_pos`` buffer, ALiBi biases on the
committed and the spec keys (``_alibi_tree_attend``).  Under a plan
(:mod:`flexflow_tpu_torch.parallel.tp`) a layer whose config is ``head``
holds its shard's KV heads and their query heads and runs the kernels on
those local shapes, as the reference's ``_head_shard_map`` (:528-556) runs
the Pallas kernels under ``shard_map``; its output is the partial sum of
its ``o_proj`` rows, ``o_bias`` added on rank 0 only, and the plan's
reduction follows.  Any other config runs every head on every shard and
the output is whole: the op IR (reference :196-239, :962-995) ignores a
``sample`` config, its input and output are replicated, and so is what
the layer computes.  Layouts are the
reference's: the
fused QKV weight is ``[E, KV, gq + 2, D]`` (per KV head, its gq query
heads, then K, then V), ``o_proj`` is ``[QH*D, E]`` and the caches are
kv-head-major ``[R+1, KV, S, D]`` with row ``R`` the pad tokens' scratch
row (int8 caches: scale planes ``[R+1, KV, S]`` beside them).

The caches are updated IN PLACE (``index_put_``): the reference threads
them functionally through a jitted step with donated buffers, which is the
same memory behaviour; so are the spec buffers ``sk``/``sv``, which stay
in the compute dtype and slot-contiguous.  Attention goes through the
hand-written CUDA kernels of :mod:`flexflow_tpu_torch.ops.cuda.attention`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.cuda.attention import (
    NEG_INF,
    _rows_f32,
    decode_attention,
    prefill_attention,
    tree_attention,
    tree_attention_batched,
)
from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from ..ops.linear import add_bias, dequant
from .batch_config import (
    BatchConfig,
    PrefillBatchConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes, f32 ``[num_heads]`` (reference :102): the
    power-of-two recipe, with the heads past the largest power of two
    interleaved at half offsets."""
    n = 2 ** math.floor(math.log2(num_heads))
    base = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    slopes = 2.0 ** (-8.0 * base / n)
    if n < num_heads:
        extra = torch.arange(1, 2 * (num_heads - n) + 1, 2,
                             dtype=torch.float32, device=device)
        slopes = torch.cat([slopes, 2.0 ** (-4.0 * extra / n)])
    return slopes[:num_heads]


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


def _page_rows_pos(pages, rows: torch.Tensor, pos: torch.Tensor):
    """Logical cache coordinates (row, position) -> physical ones through
    the page table (reference :50); every write path runs unchanged on the
    translated coordinates, the int8 scale planes too."""
    ps, ppr = pages.page_size, pages.pages_per_row
    rows = rows.long().clamp(0, pages.table.shape[0] - 1)
    pos = pos.long()
    pid = pages.table[rows, (pos // ps).clamp(0, ppr - 1)].long()
    return pid // ppr, (pid % ppr) * ps + pos % ps


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8 quantization of fresh K/V (reference
    ``_kv_quant`` :429): ``x [T, KV, D]`` -> ``(q int8 [T, KV, D], scale
    f32 [T, KV])``, scale = absmax / 127, round half to even, clipped to
    +-127; a zero vector gives value 0 and scale 0.  The same bits as the
    reference (IEEE division, ``torch.round`` rounds half to even)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / denom[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


@register_op
class IncMultiHeadSelfAttention(Op, nn.Module):
    """KV-cached GQA self-attention over flat token batches.

    ``rotary_embedding`` applies RoPE to Q and K; ``use_bias`` adds the
    params ``qkv_bias [KV, gq + 2, D]`` (after the QKV product) and
    ``o_bias [E]`` (after the output product); ``use_alibi`` biases every
    score by its head's slope times the key's distance (MPT, Falcon-RW).
    ``forward(x [T, E], bc, state, pages)`` with ``state = {"k", "v"}``
    this layer's caches (int8: and ``"k_scale"``, ``"v_scale"``; spec
    steps: and ``"sk"``, ``"sv"``, ALiBi: and ``"spec_pos"``) and
    ``pages`` the page table of a paged
    cache (None: slot-contiguous); returns ``[T, E]``.  ``name`` is the
    module's path in the model, the key of its caches in the allocator's
    state; ``compute_dtype`` is the dtype of its activations and of fp
    caches, whatever its weights are stored in.

    Head-sharded (``head_sharded``, set by ``parallel.tp.shard_model``)
    over ``head_shards`` shards, ``num_q_heads`` and ``num_kv_heads`` are
    the shard's, its first query head is global head ``head_offset``, and
    its output is a partial sum (``o_bias`` on the rank-0 shard only,
    ``skip_bias`` elsewhere).
    """

    type_name = "inc_multihead_self_attention"
    head_sharded = False
    head_shards = 1
    head_offset = 0
    skip_bias = False
    # the serve capacities register_serve_capacities records (the cost
    # model's cache depth, rows and spec slots) and the KV dtype
    cost_seq_len: Optional[int] = None
    cost_max_requests: Optional[int] = None
    cost_max_spec: int = 0
    kv_dtype: Optional[str] = None

    def __init__(self, embed_dim: int, num_q_heads: int,
                 num_kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 rotary_embedding: bool = True, rope_theta: float = 10000.0,
                 use_bias: bool = False,
                 scaling_factor: Optional[float] = None,
                 use_alibi: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embed_dim = int(embed_dim)
        self.num_q_heads = int(num_q_heads)
        self.num_kv_heads = int(num_kv_heads or num_q_heads)
        self.head_dim = int(head_dim or embed_dim // num_q_heads)
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError("num_q_heads must be a multiple of num_kv_heads")
        self.q_per_kv = self.num_q_heads // self.num_kv_heads
        self.rotary_embedding = bool(rotary_embedding)
        self.rope_theta = float(rope_theta)
        self.use_bias = bool(use_bias)
        self.use_alibi = bool(use_alibi)
        self._slopes: Optional[torch.Tensor] = None
        self.scaling_factor = (float(scaling_factor)
                               if scaling_factor is not None
                               else 1.0 / math.sqrt(self.head_dim))
        self.name = ""
        self.compute_dtype = dtype
        self.qkv = nn.Parameter(torch.empty(
            self.embed_dim, self.num_kv_heads, self.q_per_kv + 2,
            self.head_dim, dtype=dtype, device=device), requires_grad=False)
        self.o_proj = nn.Parameter(torch.empty(
            self.num_q_heads * self.head_dim, self.embed_dim, dtype=dtype,
            device=device), requires_grad=False)
        if self.use_bias:
            self.qkv_bias = nn.Parameter(torch.empty(
                self.num_kv_heads, self.q_per_kv + 2, self.head_dim,
                dtype=dtype, device=device), requires_grad=False)
            self.o_bias = nn.Parameter(torch.empty(
                self.embed_dim, dtype=dtype, device=device),
                requires_grad=False)

    def forward(self, x: torch.Tensor, bc=None,
                state: Optional[Dict[str, torch.Tensor]] = None,
                pages=None) -> torch.Tensor:
        """``[T, E]``: this shard's heads' output (a head-sharded layer's
        is its partial sum).  Without a batch config and caches (a serve
        op in a training graph, ``FFModel.compile``/``fit``) it raises, as
        the reference's lowering does (reference :291-298)."""
        if bc is None or state is None:
            raise ValueError(
                f"{self.type_name} requires a batch_config and cache state "
                "(run it through the InferenceManager)")
        q, k, v = self._project(x, bc)
        if isinstance(bc, TreeVerifyBatchConfig):
            # last macro-step's accepted K/V joins the committed cache
            # before this step's tree overwrites the spec buffer
            self._commit(state, bc, pages)
            out = self._tree_attend(q, k, v, state, bc, pages)
        elif isinstance(bc, TreeSearchBatchConfig):
            out = self._tree_attend(q, k, v, state, bc, pages)
        elif isinstance(bc, PrefillBatchConfig):
            out = self._prefill_attend(q, k, v, state, bc, pages)
        else:
            out = self._inc_attend(q, k, v, state, bc, pages)
        t = out.shape[0]
        o_w = dequant(self.o_proj, getattr(self, "o_proj_scale", None),
                      out.dtype)
        y = torch.matmul(out.reshape(t, self.num_q_heads * self.head_dim),
                         o_w)
        if self.use_bias and not self.skip_bias:
            y = add_bias(y, self.o_bias)
        return y

    # ---- op IR (reference :196-239, :962-995) ---------------------------
    def signature_attrs(self):
        """The reference op's attributes: ``name`` (the caches' key) is
        the port's own."""
        out = super().signature_attrs()
        out.pop("name", None)
        return out

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        if x.shape[-1] != self.embed_dim:
            raise ValueError(f"expected embed_dim {self.embed_dim}, got {x}")
        return [TensorSpec(x.shape, self.compute_dtype)]

    def params(self):
        g, dt = self.q_per_kv + 2, self.compute_dtype
        ps = [ParamSpec("qkv", TensorSpec((self.embed_dim, self.num_kv_heads,
                                           g, self.head_dim), dt)),
              ParamSpec("o_proj", TensorSpec(
                  (self.num_q_heads * self.head_dim, self.embed_dim), dt))]
        if self.use_bias:
            ps.append(ParamSpec("qkv_bias", TensorSpec(
                (self.num_kv_heads, g, self.head_dim), dt)))
            ps.append(ParamSpec("o_bias", TensorSpec((self.embed_dim,), dt)))
        return ps

    def state_specs(self, max_requests: int, max_seq_len: int,
                    max_spec_tokens: int = 0, head_axes=()) -> Dict:
        """``{name: (shape, dtype, sharding)}`` of the layer's cache
        buffers (reference :241-287), kv-head-major, the head axis dim
        1."""
        kv_shape = (max_requests + 1, self.num_kv_heads, max_seq_len,
                    self.head_dim)
        sh = TensorSharding.from_axes(4, {1: head_axes} if head_axes else {})
        kv_dt = torch.int8 if self.kv_dtype == "int8" else self.compute_dtype
        out = {"k": (kv_shape, kv_dt, sh), "v": (kv_shape, kv_dt, sh)}
        if kv_dt == torch.int8:
            sc_sh = TensorSharding.from_axes(3, {1: head_axes}
                                             if head_axes else {})
            out["k_scale"] = (kv_shape[:3], torch.float32, sc_sh)
            out["v_scale"] = (kv_shape[:3], torch.float32, sc_sh)
        if max_spec_tokens:
            sp_shape = (max_requests + 1, self.num_kv_heads, max_spec_tokens,
                        self.head_dim)
            out["sk"] = (sp_shape, self.compute_dtype, sh)
            out["sv"] = (sp_shape, self.compute_dtype, sh)
            if self.use_alibi:
                out["spec_pos"] = ((sp_shape[0], sp_shape[2]), torch.int32,
                                   TensorSharding.replicated(2))
        return out

    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0], "head": self.num_kv_heads}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        head = tuple(config.get("head", ()))
        x_sh = TensorSharding.replicated(x.ndim)
        out_sh = TensorSharding.replicated(x.ndim)
        params = {"qkv": TensorSharding.from_axes(4, {1: head} if head
                                                  else {}),
                  "o_proj": TensorSharding.from_axes(2, {0: head} if head
                                                     else {})}
        if self.use_bias:
            params["qkv_bias"] = TensorSharding.from_axes(
                3, {0: head} if head else {})
        if head:
            out_sh = out_sh.with_partial(head)
        return ShardingSolution(inputs=[x_sh], outputs=[out_sh],
                                params=params)

    def flops(self, in_specs):
        t = in_specs[0].shape[0]
        e, qh, d = self.embed_dim, self.num_q_heads, self.head_dim
        s = self.cost_seq_len or 1024
        proj = (2 * t * e * (qh + 2 * self.num_kv_heads) * d
                + 2 * t * qh * d * e)
        return proj + 2 * t * qh * d * s * 2

    def _project(self, x, bc) -> Tuple[torch.Tensor, ...]:
        """One GEMM for Q, K and V, the bias, then RoPE (reference
        :344-375)."""
        base = bc if isinstance(bc, BatchConfig) else bc.base
        t = x.shape[0]
        w = dequant(self.qkv, getattr(self, "qkv_scale", None), x.dtype)
        qkv = torch.matmul(x, w.reshape(self.embed_dim, -1)).reshape(
            t, self.num_kv_heads, self.q_per_kv + 2, self.head_dim)
        if self.use_bias:   # added to the product cast to x's dtype (:367)
            qkv = qkv + self.qkv_bias.to(qkv.dtype)
        q = qkv[:, :, : self.q_per_kv, :]          # [T, KV, gq, D]
        k = qkv[:, :, self.q_per_kv, :]            # [T, KV, D]
        v = qkv[:, :, self.q_per_kv + 1, :]        # [T, KV, D]
        if self.rotary_embedding:
            pos = base.token_position
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        return q, k, v

    def slopes(self, device) -> Optional[torch.Tensor]:
        """The ALiBi slopes on ``device`` (None without ALiBi), made once:
        not a parameter, so state dicts carry none, as the reference's
        params do not.  A head-sharded layer takes its heads' slice of the
        global heads' slopes (slopes made for the local head count would
        be other numbers)."""
        if not self.use_alibi:
            return None
        if self._slopes is None or self._slopes.device != device:
            lo = self.head_offset
            self._slopes = alibi_slopes(
                self.num_q_heads * self.head_shards,
                device)[lo:lo + self.num_q_heads].contiguous()
        return self._slopes

    @staticmethod
    def _rows(bc: BatchConfig, max_requests: int) -> torch.Tensor:
        """Cache row per flat token; pad tokens land in the scratch row."""
        r = bc.request_index
        return torch.where(r >= 0, r, max_requests)

    @staticmethod
    def _write_kv(state, rows, pos, k, v, pages=None) -> None:
        """``cache[rows[t], :, pos[t]] = k[t]`` (and v), in place (reference
        :474): logical coordinates go through the page table first, rows
        and positions are clipped into range as the reference clips them,
        and an int8 cache takes :func:`kv_quant`'s values and scales (the
        scale planes ride the same coordinates)."""
        if pages is not None:
            rows, pos = _page_rows_pos(pages, rows, pos)
        kc, vc = state["k"], state["v"]
        r = rows.long().clamp(0, kc.shape[0] - 1)
        p = pos.long().clamp(0, kc.shape[2] - 1)
        if kc.dtype == torch.int8:
            kq, ks = kv_quant(k)
            vq, vs = kv_quant(v)
            kc[r, :, p] = kq
            vc[r, :, p] = vq
            state["k_scale"][r, :, p] = ks
            state["v_scale"][r, :, p] = vs
        else:
            kc[r, :, p] = k.to(kc.dtype)
            vc[r, :, p] = v.to(vc.dtype)

    @staticmethod
    def _cache_args(state, pages) -> Dict:
        """The cache-variant arguments of the attention kernels."""
        return dict(k_scale=state.get("k_scale"), v_scale=state.get("v_scale"),
                    page_table=None if pages is None else pages.table,
                    page_size=0 if pages is None else pages.page_size)

    def _inc_attend(self, q, k, v, state, bc: BatchConfig, pages=None):
        """Flat-token attention (reference :557-651), with the ALiBi slopes
        of an ALiBi layer (:578-598)."""
        kc, vc = state["k"], state["v"]
        nreq = kc.shape[0] - 1
        rows = self._rows(bc, nreq)
        pos = bc.token_position
        self._write_kv(state, rows, pos, k, v, pages)
        # pad tokens (scratch row) read one key, not a whole row: their
        # outputs are discarded (reference :577)
        pos = torch.where(rows == nreq, 0, pos)
        t = q.shape[0]
        return decode_attention(
            q.reshape(t, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, rows.to(torch.int32).contiguous(),
            pos.to(torch.int32).contiguous(), self.scaling_factor,
            slopes=self.slopes(q.device), **self._cache_args(state, pages))

    def _prefill_attend(self, q, k, v, state, bc: PrefillBatchConfig,
                        pages=None):
        """Attention over request-homogeneous query tiles (reference
        :653-784).  Each tile's whole ``[KV, Bq, D]`` K/V block is written
        at the tile's row and start, tail pads as zeros (fresh caches are
        zeros, so the tiled and flat paths leave identical caches; int8:
        value 0 and scale 0), in one ``index_put_`` covering every tile.
        An ALiBi layer takes the flat path instead, as the reference does
        (:664-670): the prefill kernel has no ALiBi variant."""
        base = bc.base
        if self.use_alibi:
            return self._inc_attend(q, k, v, state, base, pages)
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
                       torch.where(valid, v, 0), pages)
        out = prefill_attention(
            q.reshape(g, bq, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, tile_rows.to(torch.int32).contiguous(),
            pstart.to(torch.int32).contiguous(), self.scaling_factor,
            **self._cache_args(state, pages))
        return out.reshape(t, self.num_q_heads, self.head_dim)

    def _commit(self, state, bc: TreeVerifyBatchConfig, pages=None) -> None:
        """Copy accepted speculative K/V (spec buffer -> committed cache),
        in place (reference :786).  Pad entries read and write the scratch
        row.  The spec buffer is read slot-contiguously; the destination
        goes through the page table, and an int8 cache quantizes the
        accepted vectors with the incremental path's quantizer, so a
        token's cache entry is the same bits whichever path wrote it."""
        kc, sk, sv = state["k"], state["sk"], state["sv"]
        nreq = kc.shape[0] - 1
        ri = bc.commit_request_index
        rows = torch.where(ri >= 0, ri, nreq).long()
        src = bc.commit_src_spec_index.long().clamp(0, sk.shape[2] - 1)
        self._write_kv(state, rows, bc.commit_dst_position,
                       sk[rows, :, src], sv[rows, :, src], pages)

    def _tree_attend(self, q, k, v, state, bc, pages=None):
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
        if self.use_alibi:
            state["spec_pos"][rows, spec_idx] = base.token_position
            return self._alibi_tree_attend(q, state, bc, rows, spec_idx,
                                           pages)
        real = rows < nreq
        req = rows.clamp(max=nreq - 1)
        clens = torch.where(real, bc.committed_lens[req], 0).to(torch.int32)
        amask = bc.ancestor_mask[req, spec_idx] & real[:, None]
        t = q.shape[0]
        qf = q.reshape(t, self.num_q_heads, self.head_dim)
        variant = self._cache_args(state, pages)
        layout = getattr(bc, "tree_layout", None)
        if layout is None:
            return tree_attention(
                qf.contiguous(), kc, vc, sk, sv,
                rows.to(torch.int32).contiguous(), clens.contiguous(),
                amask.contiguous(), self.scaling_factor, **variant)
        # fixed [R, P] layout of exactly R*P tokens: token r*P + j is node
        # j of slot r, so one kernel row per request streams its committed
        # prefix once
        r_t, p_t = layout
        return tree_attention_batched(
            qf.reshape(r_t, p_t, self.num_q_heads, self.head_dim).contiguous(),
            kc, vc, sk, sv, rows[::p_t].to(torch.int32).contiguous(),
            clens[::p_t].contiguous(),
            amask.reshape(r_t, p_t, -1).contiguous(),
            self.scaling_factor, **variant).reshape(t, self.num_q_heads,
                                                    self.head_dim)

    def _alibi_tree_attend(self, q, state, bc, rows, spec_idx, pages=None):
        """The gather path of an ALiBi layer's tree step (reference
        :908-958) as torch ops: softmax over the committed keys below the
        row's committed depth and the spec keys under the ancestor mask,
        each score biased by its head's slope times (key position - query
        position), the spec keys' positions read from ``spec_pos``.

        The reference gathers each token's whole cache row (``[T, KV, S,
        D]``); here the queries go to their row instead: a row's tree
        tokens hold distinct spec slots (the spec buffer write above needs
        that too), so ``q`` scatters into ``[R+1, P]`` by (row, spec
        slot), every row's keys are read once (through the page table and
        the int8 scales as the kernels' plain versions read them; an f32
        contiguous cache is read in place), and each token reads its
        output back from its (row, slot).  A token with no live key (a
        pad, in the scratch row) gives zeros, as the tree kernels do.
        f32 throughout, cast to q's dtype at the end."""
        kc, vc, sk, sv = state["k"], state["v"], state["sk"], state["sv"]
        r1, _, s, _ = kc.shape
        nreq, p = r1 - 1, sk.shape[2]
        kv, gq, d = self.num_kv_heads, self.q_per_kv, self.head_dim
        dev = q.device
        # [R+1, P, KV, gq, D] queries and [R+1, P] positions by slot
        qr = q.new_zeros((r1, p, kv, gq, d), dtype=torch.float32)
        qr[rows, spec_idx] = q.float()
        qpos = torch.zeros((r1, p), dtype=torch.float32, device=dev)
        qpos[rows, spec_idx] = bc.base.token_position.float()

        def rows_f32(cache, scale):
            # every logical row in f32: a view of an f32 contiguous cache
            if pages is not None:
                return _rows_f32(cache, scale, pages.table, pages.page_size,
                                 torch.arange(r1, device=dev))
            x = cache.float()
            return x if scale is None else x * scale[..., None]

        kr = rows_f32(kc, state.get("k_scale"))
        vr = rows_f32(vc, state.get("v_scale"))
        slopes = self.slopes(dev).reshape(kv, gq)[None, :, :, None, None]
        key_pos = torch.arange(s, device=dev, dtype=torch.float32)
        sc_c = torch.einsum("rpkgd,rksd->rkgps", qr, kr) * self.scaling_factor
        sc_c = sc_c + slopes * (key_pos[None, None, :]
                                - qpos[:, :, None])[:, None, None]
        sc_p = torch.einsum("rpkgd,rkjd->rkgpj", qr, sk.float()
                            ) * self.scaling_factor
        sc_p = sc_p + slopes * (state["spec_pos"].float()[:, None, :]
                                - qpos[:, :, None])[:, None, None]
        clens = torch.zeros(r1, dtype=torch.long, device=dev)
        clens[:nreq] = bc.committed_lens.long()
        live_c = (key_pos[None, :] < clens[:, None])[:, None, None, None]
        amask = torch.zeros((r1, p, p), dtype=torch.bool, device=dev)
        amask[:nreq] = bc.ancestor_mask[:, :p, :p]
        live_p = amask[:, None, None]
        sc_c = sc_c.masked_fill(~live_c, NEG_INF)
        sc_p = sc_p.masked_fill(~live_p, NEG_INF)
        m = torch.maximum(sc_c.amax(-1), sc_p.amax(-1))[..., None]
        w_c = torch.exp(sc_c - m) * live_c
        w_p = torch.exp(sc_p - m) * live_p
        o = (torch.einsum("rkgps,rksd->rkgpd", w_c, vr)
             + torch.einsum("rkgpj,rkjd->rkgpd", w_p, sv.float()))
        o = o / (w_c.sum(-1) + w_p.sum(-1)).clamp_min(1e-30)[..., None]
        # each token's output from its (row, slot); pads give zeros
        out = o.permute(0, 3, 1, 2, 4)[rows, spec_idx]      # [T, KV, gq, D]
        out = torch.where((rows < nreq)[:, None, None, None], out, 0.0)
        return out.reshape(q.shape[0], self.num_q_heads,
                           self.head_dim).to(q.dtype)


@register_op
class SpecIncMultiHeadSelfAttention(IncMultiHeadSelfAttention):
    """The draft model's tree-expansion attention (reference :1051-1060,
    ``spec_inc_multihead_self_attention.cu``): the base class computes
    every mode, chosen by the batch config's type; the alias carries the
    reference's type name, so graphs read like the reference's and
    strategies can name it."""

    type_name = "spec_inc_multihead_self_attention"


@register_op
class TreeIncMultiHeadSelfAttention(IncMultiHeadSelfAttention):
    """The verifier's tree-mask attention (reference :1063-1071,
    ``tree_inc_multihead_self_attention.cu``), an alias as above."""

    type_name = "tree_inc_multihead_self_attention"
