"""Softmax and Reduce.

Port of ``flexflow_tpu/ops/reduction.py`` (``Softmax`` :28-49,
``Reduce`` :51-101: sum, mean, max and min over axes).  ``max`` and
``min`` are ``torch.amax`` / ``torch.amin``, whose gradient is shared
evenly between tied elements, as ``jnp.max``'s is.  The decode heads
(``ArgMax``, ``TopK``, ``ArgTopK``, ``Sampling``, ``BeamTopK``) come with a
later slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.graph import TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import propagate


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
