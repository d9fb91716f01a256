"""Softmax, Reduce and the decode heads.

Port of ``flexflow_tpu/ops/reduction.py`` (``Softmax`` :28-49,
``Reduce`` :51-101: sum, mean, max and min over axes; the decode heads
``ArgMax`` :103, ``TopK`` :127, ``ArgTopK`` :153, ``Sampling`` :188 and
``BeamTopK`` :226).  ``max`` and ``min`` are ``torch.amax`` /
``torch.amin``, whose gradient is shared evenly between tied elements,
as ``jnp.max``'s is.

The heads' selections are exact and keep the reference's order among
ties: :func:`stable_top_k` (a stable descending sort, then the first
``k``) puts the lower index first among equal values, as
``jax.lax.top_k`` does, where ``torch.topk`` promises no order among
ties; ``torch.argmax`` returns the first maximum, as ``jnp.argmax``
does.  Indices come out ``int32``, as in the reference.  ``TopK``'s
values carry a gradient to the selected entries.  ``Sampling``'s nucleus
cut is :func:`nucleus_keep` (the reference's ``cutoff_idx = sum(cum <
top_p)``, logits strictly below the cutoff dropped); its draw is the
Gumbel-max form of ``jax.random.categorical``, from the step's stream
(``OpContext.stream``) or else a generator seeded by the op's ``seed``,
so its tokens match the reference's in distribution only.  Each head
wants its reduced dims whole: a vocabulary split is gathered before it
(``_reduce_last_local``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.graph import TensorSpec
from ..core.op import Op, OpContext, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import propagate


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices,
    largest first, the lower index first among equal values (the order
    of ``jax.lax.top_k``); the values are ``x``'s, with its gradient."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def _reduce_last_local(spec: TensorSpec, in_sh) -> TensorSharding:
    sh = propagate(in_sh, spec)
    sh = TensorSharding(sh.dims, frozenset())
    return sh.with_dim(spec.ndim - 1, ())


@register_op
class Softmax(Op, nn.Module):
    type_name = "softmax"

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = int(axis)

    def infer_shapes(self, in_specs):
        return [in_specs[0]]

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        sh = propagate(in_shardings[0] if in_shardings else None, x)
        sh = TensorSharding(sh.dims, frozenset()).with_dim(
            self.axis % x.ndim, ())
        return ShardingSolution(inputs=[sh], outputs=[sh])

    def flops(self, in_specs):
        return 5 * in_specs[0].size


@register_op
class Reduce(Op, nn.Module):
    """sum / mean / max / min over ``axes`` (``keepdims`` optional)."""

    type_name = "reduce"

    FNS = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax,
           "min": torch.amin}

    def __init__(self, fn: str, axes: Sequence[int], keepdims: bool = False):
        super().__init__()
        self.fn = fn
        self.axes = tuple(sorted(int(a) for a in axes))
        self.keepdims = bool(keepdims)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        shape = []
        for i, s in enumerate(x.shape):
            if i in self.axes:
                if self.keepdims:
                    shape.append(1)
            else:
                shape.append(s)
        return [TensorSpec(tuple(shape), x.dtype)]

    def forward(self, x):
        return self.FNS[self.fn](x, dim=self.axes, keepdim=self.keepdims)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        sh = propagate(in_shardings[0] if in_shardings else None, x)
        sh = TensorSharding(sh.dims, frozenset())
        for a in self.axes:
            sh = sh.with_dim(a % x.ndim, ())  # reduced dims stay whole
        out = self.infer_shapes([x])[0]
        out_dims = []
        for i in range(x.ndim):
            if i in self.axes:
                if self.keepdims:
                    out_dims.append(())
            else:
                out_dims.append(tuple(sh.dims[i].axes))
        out_sh = TensorSharding.from_axes(
            out.ndim, {i: d for i, d in enumerate(out_dims) if d})
        return ShardingSolution(inputs=[sh], outputs=[out_sh])


@register_op
class ArgMax(Op, nn.Module):
    """The greedy decode head: the first maximum over the last dim."""

    type_name = "argmax"

    def infer_shapes(self, in_specs):
        return [TensorSpec(in_specs[0].shape[:-1], torch.int32)]

    def forward(self, x):
        return torch.argmax(x, dim=-1).to(torch.int32)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _reduce_last_local(in_specs[0],
                                in_shardings[0] if in_shardings else None)
        return ShardingSolution(inputs=[sh], outputs=[
            TensorSharding(sh.dims[:-1], frozenset())])


@register_op
class TopK(Op, nn.Module):
    """The top-``k`` values and their indices over the last dim."""

    type_name = "topk"

    def __init__(self, k: int, sorted: bool = True):
        super().__init__()
        self.k = int(k)
        self.sorted = bool(sorted)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        shape = x.shape[:-1] + (self.k,)
        return [TensorSpec(shape, x.dtype), TensorSpec(shape, torch.int32)]

    def forward(self, x):
        v, i = stable_top_k(x, self.k)
        return v, i.to(torch.int32)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _reduce_last_local(in_specs[0],
                                in_shardings[0] if in_shardings else None)
        out = TensorSharding(sh.dims, frozenset())
        return ShardingSolution(inputs=[sh], outputs=[out, out])


@register_op
class ArgTopK(Op, nn.Module):
    """The top-``k`` indices (and, for speculative decoding, their softmax
    probabilities)."""

    type_name = "arg_topk"

    def __init__(self, k: int, speculative_decoding: bool = False):
        super().__init__()
        self.k = int(k)
        self.speculative_decoding = bool(speculative_decoding)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        shape = x.shape[:-1] + (self.k,)
        out = [TensorSpec(shape, torch.int32)]
        if self.speculative_decoding:
            out.append(TensorSpec(shape, x.dtype))
        return out

    def forward(self, x):
        _, i = stable_top_k(x, self.k)
        if not self.speculative_decoding:
            return i.to(torch.int32)
        probs = torch.softmax(x, dim=-1).gather(-1, i)
        return i.to(torch.int32), probs

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _reduce_last_local(in_specs[0],
                                in_shardings[0] if in_shardings else None)
        out = TensorSharding(sh.dims, frozenset())
        n = 2 if self.speculative_decoding else 1
        return ShardingSolution(inputs=[sh], outputs=[out] * n)


def nucleus_keep(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """The nucleus (top-``p``) mask of the reference's ``Sampling``
    (:207-214): over the logits sorted largest first, ``cutoff_idx`` is
    the count of cumulative probabilities below ``top_p`` and the logit
    there the cutoff; True where a logit is not below it (a cutoff past
    the last logit keeps them all)."""
    ordered = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.softmax(ordered, dim=-1).cumsum(dim=-1)
    idx = (cum < top_p).sum(dim=-1, keepdim=True)
    last = logits.shape[-1] - 1
    cutoff = ordered.gather(-1, idx.clamp(max=last))
    return (logits >= cutoff) | (idx > last)


@register_op
class Sampling(Op, nn.Module):
    """The nucleus (top-``p``) sampling head at ``temperature``."""

    type_name = "sampling"
    uses_context = True

    def __init__(self, top_p: float = 1.0, temperature: float = 1.0,
                 seed: int = 0):
        super().__init__()
        self.top_p = float(top_p)
        self.temperature = float(temperature)
        self.seed = int(seed)

    def infer_shapes(self, in_specs):
        return [TensorSpec(in_specs[0].shape[:-1], torch.int32)]

    def forward(self, logits, ctx: Optional[OpContext] = None):
        if self.temperature != 1.0:
            logits = logits / self.temperature
        if self.top_p < 1.0:
            logits = logits.masked_fill(~nucleus_keep(logits, self.top_p),
                                        float("-inf"))
        gen = None if ctx is None else ctx.stream(logits.device)
        if gen is None:
            gen = torch.Generator(logits.device).manual_seed(self.seed)
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _reduce_last_local(in_specs[0],
                                in_shardings[0] if in_shardings else None)
        return ShardingSolution(inputs=[sh], outputs=[
            TensorSharding(sh.dims[:-1], frozenset())])


@register_op
class BeamTopK(Op, nn.Module):
    """The beam expansion head: the top-``k`` over ``(beam, vocab)``
    flattened, as token ids, parent beam ids and scores."""

    type_name = "beam_topk"

    def __init__(self, max_beam_width: int):
        super().__init__()
        self.k = int(max_beam_width)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        shape = x.shape[:-2] + (self.k,)
        return [TensorSpec(shape, torch.int32), TensorSpec(shape, torch.int32),
                TensorSpec(shape, x.dtype)]

    def forward(self, x):
        vocab = x.shape[-1]
        v, i = stable_top_k(x.flatten(-2), self.k)
        return ((i % vocab).to(torch.int32),
                torch.div(i, vocab, rounding_mode="floor").to(torch.int32), v)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        sh = propagate(in_shardings[0] if in_shardings else None, x)
        sh = TensorSharding(sh.dims, frozenset())
        sh = sh.with_dim(x.ndim - 1, ()).with_dim(x.ndim - 2, ())
        out = TensorSharding(sh.dims[:-2] + sh.dims[-1:], frozenset())
        return ShardingSolution(inputs=[sh], outputs=[out, out, out])
