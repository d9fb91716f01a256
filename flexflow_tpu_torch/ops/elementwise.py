"""Elementwise operators: ElementUnary, ElementBinary, Cast, Dropout.

Port of ``flexflow_tpu/ops/elementwise.py``: ``UNARY_FNS`` (:27-48),
``propagate`` (:78), ``ElementUnary`` with the scalar ops (:55-90),
``ElementBinary`` (:104-232; also the serve graphs' module-free add
node, ``serve/models/base.py``, whose add itself is ``a + b``), ``Cast``
(:188) and ``Dropout`` (:206-236), each an ``nn.Module`` that computes in
``forward``.  ``relu``, ``max`` and ``min`` are ``torch.maximum`` /
``torch.minimum``, as ``jnp.maximum`` is: the gradient splits in half at
a tie (a pre-activation of exactly 0), where ``F.relu``'s is 0.  The
``gelu`` is the tanh approximation, ``gelu_exact`` the erf form.

Sharding: an elementwise op is parallel in every dimension, so it adopts
its producer's sharding; partial sums pass only where the op is linear
(two partial sums over the same axes add into a partial sum), anything
else wants the reduction first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.graph import TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_zeros(()))


UNARY_FNS = {
    "relu": _relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "sin": torch.sin,
    "cos": torch.cos,
    "abs": torch.abs,
    "negative": torch.negative,
    "silu": F.silu,
    "elu": F.elu,
    "identity": lambda x: x,
}

# f(sum_i x_i) == sum_i f(x_i): safe to apply to partial-sum shards
LINEAR_UNARY = {"identity", "negative", "scalar_multiply", "scalar_truediv"}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A torch dtype, its name as the JAX package spells it
    (``"float32"``, ``"int32"``...), or anything numpy reads as a dtype
    (``np.int32``, a bfloat16 dtype), as the reference's builder takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def propagate(sh: Optional[TensorSharding],
              spec: TensorSpec) -> TensorSharding:
    return sh if sh is not None else TensorSharding.replicated(spec.ndim)


class _Elementwise(Op, nn.Module):
    """One input; its producer's sharding propagates to the output."""

    def infer_shapes(self, in_specs):
        return [in_specs[0]]

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = propagate(in_shardings[0] if in_shardings else None,
                       in_specs[0])
        return ShardingSolution(inputs=[sh], outputs=[sh])


@register_op
class ElementUnary(_Elementwise):
    type_name = "element_unary"

    def __init__(self, fn: str, scalar: Optional[float] = None):
        super().__init__()
        if (fn not in UNARY_FNS and not fn.startswith("scalar_")
                and fn != "pow"):
            raise ValueError(f"unknown unary fn {fn!r}")
        self.fn = fn
        self.scalar = scalar

    def forward(self, x):
        if self.fn == "scalar_add":
            return x + self.scalar
        if self.fn == "scalar_sub":
            return x - self.scalar
        if self.fn == "scalar_multiply":
            return x * self.scalar
        if self.fn == "scalar_truediv":
            return x / self.scalar
        if self.fn == "pow":
            return x ** self.scalar
        return UNARY_FNS[self.fn](x)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = propagate(in_shardings[0] if in_shardings else None,
                       in_specs[0])
        if sh.partial_axes and self.fn not in LINEAR_UNARY:
            sh = TensorSharding(sh.dims, frozenset())  # reduce first
        return ShardingSolution(inputs=[sh], outputs=[sh])


@register_op
class ElementBinary(Op, nn.Module):
    type_name = "element_binary"
    FNS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "max": torch.maximum, "min": torch.minimum,
           "pow": torch.pow}

    def __init__(self, fn: str):
        super().__init__()
        if fn not in self.FNS:
            raise ValueError(f"unknown binary fn {fn!r}")
        self.fn = fn

    def forward(self, a, b):
        return self.FNS[self.fn](a, b)

    def infer_shapes(self, in_specs):
        a, b = in_specs
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return [TensorSpec(tuple(shape), a.dtype)]

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        a_spec, b_spec = in_specs
        a_sh = propagate(in_shardings[0] if in_shardings else None, a_spec)
        b_sh = propagate(in_shardings[1] if in_shardings else None, b_spec)
        # add/sub of identically-partial values is linear; anything else
        # needs whole values
        if self.fn in ("add", "sub") and a_sh.partial_axes == b_sh.partial_axes:
            partial = a_sh.partial_axes
        else:
            partial = frozenset()
            a_sh = TensorSharding(a_sh.dims, frozenset())
            b_sh = TensorSharding(b_sh.dims, frozenset())
        out_ndim = max(a_spec.ndim, b_spec.ndim)
        out_shape = tuple(torch.broadcast_shapes(a_spec.shape, b_spec.shape))

        def aligned(sh, spec):
            dims = [() for _ in range(out_ndim)]
            off = out_ndim - spec.ndim
            for i, d in enumerate(sh.dims):
                dims[off + i] = tuple(d.axes)
            return dims

        # per output dim, the sharding of the input not broadcast on it;
        # where both are real, a's, and b must match
        a_dims, b_dims = aligned(a_sh, a_spec), aligned(b_sh, b_spec)
        out_dims: List[Tuple[str, ...]] = []
        req_b = list(b_dims)
        for i in range(out_ndim):
            ai = i - (out_ndim - a_spec.ndim)
            bi = i - (out_ndim - b_spec.ndim)
            a_bcast = ai < 0 or a_spec.shape[ai] == 1 != out_shape[i]
            b_bcast = bi < 0 or b_spec.shape[bi] == 1 != out_shape[i]
            if a_bcast and not b_bcast:
                out_dims.append(tuple(b_dims[i]))
            elif b_bcast and not a_bcast:
                out_dims.append(tuple(a_dims[i]))
            else:
                out_dims.append(tuple(a_dims[i]))
                req_b[i] = a_dims[i]

        def rebuild(dims, spec, partial_axes):
            own = dims[out_ndim - spec.ndim:]
            sh = TensorSharding.replicated(spec.ndim)
            for i, axes in enumerate(own):
                if axes and spec.shape[i] != 1:   # never a broadcast dim
                    sh = sh.with_dim(i, tuple(axes))
            return TensorSharding(sh.dims, partial_axes)

        a_req = rebuild(a_dims, a_spec,
                        a_sh.partial_axes if partial else frozenset())
        b_req = rebuild(req_b, b_spec,
                        b_sh.partial_axes if partial else frozenset())
        out_sh = TensorSharding.from_axes(
            out_ndim, {i: d for i, d in enumerate(out_dims) if d}, partial)
        return ShardingSolution(inputs=[a_req, b_req], outputs=[out_sh])

    def flops(self, in_specs):
        return self.infer_shapes(list(in_specs))[0].size


@register_op
class Cast(_Elementwise):
    type_name = "cast"

    def __init__(self, dtype):
        super().__init__()
        self.dtype = as_dtype(dtype)

    def infer_shapes(self, in_specs):
        return [TensorSpec(in_specs[0].shape, self.dtype)]

    def forward(self, x):
        return x.to(self.dtype)


@register_op
class Dropout(_Elementwise):
    """Zeros each element with probability ``rate`` and scales the rest by
    ``1 / (1 - rate)`` while training, from the step's stream
    (``OpContext.stream``: a shard draws the mask of the block it holds;
    the op's own ``seed`` when the step has none); the identity
    otherwise."""

    type_name = "dropout"
    uses_context = True

    def __init__(self, rate: float, seed: int = 0):
        super().__init__()
        self.rate = float(rate)
        self.seed = int(seed)

    def forward(self, x, ctx):
        if not ctx.training or self.rate == 0.0:
            return x
        gen = ctx.stream(x.device)
        if gen is None:
            gen = torch.Generator(x.device).manual_seed(self.seed)
        return dropout(x, self.rate, gen)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = propagate(in_shardings[0] if in_shardings else None,
                       in_specs[0])
        sh = TensorSharding(sh.dims, frozenset())
        return ShardingSolution(inputs=[sh], outputs=[sh])


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` with ``keep`` drawn at ``1 -
    rate`` from ``generator`` (on x's device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))
