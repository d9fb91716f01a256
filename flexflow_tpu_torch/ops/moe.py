"""Mixture-of-Experts ops: GroupBy, Experts, Aggregate, AggregateSpec.

Port of ``flexflow_tpu/ops/moe.py`` (``moe_capacity`` :38, ``GroupBy``
:44, ``Experts`` :122, ``Aggregate`` :208, ``AggregateSpec`` :248):
fixed-capacity dispatch, so every shape is static.

* :class:`GroupBy` routes each token to its top-``k`` experts by the
  gate probabilities and dispatches it into ``[E, C, d]`` (capacity ``C =
  ceil(k * N / E * capacity_factor)`` over the global ``N``); a choice
  ranked ``C`` or later within its expert (ranks counted over the
  ``[N*k, E]`` one-hot in token-major order) is dropped.  ``dispatched``
  keeps ``x``'s dtype, ``combine`` (``[N, E, C]``, the gate weights) is
  float32.
* :class:`Experts` runs one FFN an expert on ``[E, C, d]``: two batched
  products (``torch.bmm``) with ``[E, out]`` biases broadcast over the
  capacity dim, the activation between them (after the one product
  without ``hidden_dim``).
* :class:`Aggregate` weights the experts' outputs back into token order
  (one einsum, in float32).
* :class:`AggregateSpec` returns each token's ``k`` chosen experts'
  outputs unweighted, ``[N, k, d]``, re-deriving the choices from
  ``gates`` with GroupBy's selection; a dropped choice gives a zero row.

The products are torch ops, as the reference leaves them to XLA.  The
top-``k`` is :func:`~.reduction.stable_top_k`, which puts the lower index
first among equal values, as ``jax.lax.top_k`` does (``torch.topk``
promises no order among ties), so GroupBy and AggregateSpec pick the same
experts.  Gradients come from autograd: ``x``'s through the dispatch
mask, a gate's only where it was selected (through the top-``k``
values).  In bf16 the experts' products round to bf16 before their bias
(the port's rule for a bf16 GEMM, ``ops/linear.py``); float32 is the
reference's arithmetic.

Expert parallelism (the ``expert`` parallel dim over the mesh's ``ep``
axes, reference :103-112, :182-200, :231-240, :284-296): GroupBy's inputs
are whole and its outputs split over experts (``dispatched`` on dim 0,
``combine`` on dim 1), so each shard computes the global routing and
keeps its block of experts, which it reads from its ``OpContext`` (the
node's config, its rank on the mesh: :func:`expert_block`); Experts holds
its block of ``w1, b1, w2, b2`` on dim 0; Aggregate's output is a
partial sum over the expert axes (no bias to count once).  AggregateSpec
takes ``gates`` split over experts (the reference's sharding, which the
planner prices) and gathers them whole (``("all_gather", gates, 1,
axes)``) before it selects: a shard's block of ``gates`` alone would pick
the wrong experts.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import OpContext, Op, ShardingSolution, register_op
from ..core.sharding import DimSharding, TensorSharding, mesh_coords
from .elementwise import UNARY_FNS
from .reduction import stable_top_k


def moe_capacity(n_tokens: int, n_experts: int, k: int,
                 capacity_factor: float) -> int:
    return max(1, int(math.ceil(k * n_tokens / n_experts * capacity_factor)))


def expert_axes(ctx: Optional[OpContext]) -> Tuple[str, ...]:
    """The mesh axes (of a degree above 1) the node's config splits its
    experts over; () on one device."""
    if ctx is None or ctx.mesh is None or not ctx.config:
        return ()
    return tuple(a for a in ctx.config.get("expert", ())
                 if ctx.mesh.shape[a] > 1)


def expert_block(ctx: Optional[OpContext], n_experts: int
                 ) -> Tuple[int, int]:
    """``(first, count)``: the experts shard ``ctx.rank`` holds under the
    node's ``expert`` axes (all of them on one device)."""
    axes = expert_axes(ctx)
    if not axes:
        return 0, n_experts
    dim = DimSharding(axes)
    shape = dict(ctx.mesh.shape)
    count = n_experts // dim.degree(shape)
    return dim.index(mesh_coords(ctx.rank, ctx.mesh), shape) * count, count


def _expert_split(config, ndim: int, dims: Tuple[int, ...]
                  ) -> Tuple[TensorSharding, Tuple[str, ...]]:
    expert = tuple(config.get("expert", ()))
    sh = TensorSharding.replicated(ndim)
    if expert:
        for d in dims:
            sh = sh.with_dim(d, expert)
    return sh, expert


@register_op
class GroupBy(Op, nn.Module):
    """``(x [N, d], gates [N, E]) -> (dispatched [E, C, d], combine [N, E,
    C])``."""

    type_name = "group_by"
    uses_context = True

    def __init__(self, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts = int(num_experts)
        self.k = int(k)
        self.capacity_factor = float(capacity_factor)

    def _cap(self, n_tokens: int) -> int:
        return moe_capacity(n_tokens, self.num_experts, self.k,
                            self.capacity_factor)

    def infer_shapes(self, in_specs):
        x, gates = in_specs
        if gates.shape[-1] != self.num_experts:
            raise ValueError(f"gates last dim {gates.shape[-1]} != "
                             f"num_experts {self.num_experts}")
        n, d = x.shape
        c = self._cap(n)
        return [TensorSpec((self.num_experts, c, d), x.dtype),
                TensorSpec((n, self.num_experts, c), torch.float32)]

    def forward(self, x, gates, ctx: Optional[OpContext] = None):
        n = x.shape[0]
        e, k, c = self.num_experts, self.k, self._cap(n)
        topv, topi = stable_top_k(gates, k)                  # [N, k]
        onehot = F.one_hot(topi.long(), e)                   # [N, k, E]
        # each choice's place in its expert's capacity: the choices of
        # that expert before it, in token-major order
        flat = onehot.reshape(n * k, e)
        rank = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(n, k)
        keep = rank < c                                      # overflow dropped
        pos = F.one_hot(torch.where(keep, rank, c), c + 1)[..., :c]
        disp = torch.einsum("nke,nkc->nec", onehot.to(x.dtype),
                            pos.to(x.dtype))                 # [N, E, C]
        weight = torch.einsum("nke,nk->ne", onehot.float(),
                              topv.float() * keep.float())   # [N, E]
        first, count = expert_block(ctx, e)
        if count != e:
            disp = disp[:, first:first + count]
            weight = weight[:, first:first + count]
        dispatched = torch.einsum("nec,nd->ecd", disp, x)
        combine = disp.float() * weight[..., None]
        return dispatched, combine

    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0], "expert": self.num_experts}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        out0, _ = _expert_split(config, 3, (0,))
        out1, _ = _expert_split(config, 3, (1,))
        rep = TensorSharding.replicated(2)
        return ShardingSolution(inputs=[rep, rep], outputs=[out0, out1])

    def flops(self, in_specs):
        n, d = in_specs[0].shape
        return 2 * n * self.num_experts * self._cap(n) * (d + 1)


@register_op
class Experts(Op, nn.Module):
    """One FFN an expert: ``[E, C, d] -> [E, C, out]``.  ``num_experts``
    and ``in_dim`` are bound at the first ``infer_shapes`` (reference
    :143-145), which makes the parameters (on ``device``)."""

    type_name = "experts"

    def __init__(self, out_dim: int, hidden_dim: Optional[int] = None,
                 activation: Optional[str] = "relu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.hidden_dim = int(hidden_dim) if hidden_dim else None
        self.activation = activation
        self.compute_dtype = dtype
        self.num_experts = None
        self.in_dim = None
        self._device = device

    def infer_shapes(self, in_specs):
        e, c, d = in_specs[0].shape
        if self.num_experts is None:
            self.num_experts, self.in_dim = e, d
            for p in self.params():
                setattr(self, p.name, nn.Parameter(
                    torch.empty(p.spec.shape, dtype=p.spec.dtype,
                                device=self._device), requires_grad=False))
        return [TensorSpec((e, c, self.out_dim), self.compute_dtype)]

    def params(self) -> List[ParamSpec]:
        dt, e, din = self.compute_dtype, self.num_experts, self.in_dim
        if self.hidden_dim:
            h = self.hidden_dim
            return [ParamSpec("w1", TensorSpec((e, din, h), dt)),
                    ParamSpec("b1", TensorSpec((e, h), dt)),
                    ParamSpec("w2", TensorSpec((e, h, self.out_dim), dt)),
                    ParamSpec("b2", TensorSpec((e, self.out_dim), dt))]
        return [ParamSpec("w1", TensorSpec((e, din, self.out_dim), dt)),
                ParamSpec("b1", TensorSpec((e, self.out_dim), dt))]

    def _act(self, h):
        return UNARY_FNS[self.activation](h) if self.activation else h

    def forward(self, x):
        # the [E, out] biases take the capacity dim, so expert e's bias
        # adds to every row of its slot
        h = (torch.bmm(x, self.w1.to(x.dtype)).float()
             + self.b1.float()[:, None, :])
        if self.hidden_dim:
            h = self._act(h)
            h = (torch.bmm(h.to(x.dtype), self.w2.to(x.dtype)).float()
                 + self.b2.float()[:, None, :])
        else:
            h = self._act(h)
        return h.to(self.compute_dtype)

    def parallel_dims(self, in_specs):
        return {"expert": in_specs[0].shape[0]}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x_sh, expert = _expert_split(config, 3, (0,))
        params = {}
        for p in self.params():
            params[p.name], _ = _expert_split(config, p.spec.ndim, (0,))
        return ShardingSolution(inputs=[x_sh], outputs=[x_sh], params=params)

    def flops(self, in_specs):
        e, c, d = in_specs[0].shape
        if self.hidden_dim:
            return 2 * e * c * (d * self.hidden_dim
                                + self.hidden_dim * self.out_dim)
        return 2 * e * c * d * self.out_dim


@register_op
class Aggregate(Op, nn.Module):
    """``(expert_out [E, C, d], combine [N, E, C]) -> [N, d]``."""

    type_name = "aggregate"

    def infer_shapes(self, in_specs):
        eo, comb = in_specs
        return [TensorSpec((comb.shape[0], eo.shape[-1]), eo.dtype)]

    def forward(self, eo, comb):
        out = torch.einsum("ecd,nec->nd", eo.float(), comb.float())
        return out.to(eo.dtype)

    def parallel_dims(self, in_specs):
        return {"expert": in_specs[0].shape[0]}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        eo_sh, expert = _expert_split(config, 3, (0,))
        comb_sh, _ = _expert_split(config, 3, (1,))
        out_sh = TensorSharding.replicated(2)
        if expert:
            out_sh = out_sh.with_partial(expert)
        return ShardingSolution(inputs=[eo_sh, comb_sh], outputs=[out_sh])

    def flops(self, in_specs):
        eo, comb = in_specs
        return 2 * int(np.prod(comb.shape)) * eo.shape[-1]


@register_op
class AggregateSpec(Op, nn.Module):
    """``(expert_out [E, C, d], combine [N, E, C], gates [N, E]) -> [N, k,
    d]``: each token's ``k`` chosen experts' outputs, unweighted."""

    type_name = "aggregate_spec"
    uses_context = True

    def __init__(self, k: int = 1):
        super().__init__()
        self.k = int(k)

    def infer_shapes(self, in_specs):
        eo, comb, gates = in_specs
        return [TensorSpec((comb.shape[0], self.k, eo.shape[-1]), eo.dtype)]

    def forward(self, eo, comb, gates, ctx: Optional[OpContext] = None):
        axes = expert_axes(ctx)
        if axes:
            return self._gathered(eo, comb, gates, axes, ctx)
        return self._select(eo, comb, gates, 0)

    def _gathered(self, eo, comb, gates, axes, ctx):
        """The forward on a block of experts: a generator that gathers
        ``gates`` whole over ``axes`` first."""
        whole = yield ("all_gather", gates, 1, axes)
        first, _ = expert_block(ctx, whole.shape[-1])
        return self._select(eo, comb, whole, first)

    def _select(self, eo, comb, gates, first):
        _, topi = stable_top_k(gates, self.k)                # [N, k]
        sel = F.one_hot(topi.long(), gates.shape[-1]).float()
        sel = sel[..., first:first + eo.shape[0]]            # [N, k, E]
        disp = (comb > 0).float()                            # [N, E, C]
        out = torch.einsum("nke,nec,ecd->nkd", sel, disp, eo.float())
        return out.to(eo.dtype)

    def parallel_dims(self, in_specs):
        return {"expert": in_specs[0].shape[0]}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        eo_sh, expert = _expert_split(config, 3, (0,))
        comb_sh, _ = _expert_split(config, 3, (1,))
        g_sh, _ = _expert_split(config, 2, (1,))
        out_sh = TensorSharding.replicated(3)
        if expert:
            out_sh = out_sh.with_partial(expert)
        return ShardingSolution(inputs=[eo_sh, comb_sh, g_sh],
                                outputs=[out_sh])

    def flops(self, in_specs):
        eo, comb, _ = in_specs
        return 2 * int(np.prod(comb.shape)) * eo.shape[-1]
