"""The shape ops: Reshape, Transpose, Concat, Split, Gather, Reverse, Flat.

Port of ``flexflow_tpu/ops/shape.py`` (``Reshape`` :23, ``Transpose`` :75,
``Concat`` :97, ``Split`` :125, ``Gather`` :163, ``Reverse`` :195,
``Flat`` :215): data movement only, each an ``nn.Module`` over torch's
own view and copy ops, with the reference's ``infer_shapes``,
``apply_config`` and ``flops`` (one per output element).  Autograd gives
the backward.

Sharding (the reference's rules): a shape op adopts its producer's
sharding where the op keeps the dimension, and wants whole every
dimension it joins, cuts or reverses (concat's, split's and reverse's
axis).  Reshape and Flat keep only dim 0's split, and Reshape only where
dim 0's extent is kept; every other dimension arrives whole.  So a shard
computes on its block with the global op, except Reshape, whose target
is global: a shard that holds a block of dim 0 reshapes to the global
shape with dim 0 at its block's rows (the reference's shard-local branch
:42-51, which divides each split output dim by its degree: dim 0 is the
only one ``apply_config`` splits, :59-70).  Gather takes along its axis
with ``torch.gather``; a negative index counts from the end of the axis,
as ``jnp.take_along_axis`` wraps it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..core.graph import TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import propagate


def _whole_sums(sh, spec) -> TensorSharding:
    """The producer's sharding (replicated for a graph input), no partial
    sum."""
    sh = propagate(sh, spec)
    return TensorSharding(sh.dims, frozenset())


@register_op
class Reshape(Op, nn.Module):
    type_name = "reshape"

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        # (input rows, output shape) of the whole tensor: set by the
        # build's infer_shapes, kept through later calls at local shapes
        self._global = None

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        shape = list(self.shape)
        if -1 in shape:
            i = shape.index(-1)
            known = math.prod(s for s in shape if s != -1)
            shape[i] = x.size // known
        if math.prod(shape) != x.size:
            raise ValueError(f"reshape {x.shape} -> {shape}: size mismatch")
        if self._global is None:
            self._global = (x.shape[0] if x.ndim else None, tuple(shape))
        return [TensorSpec(tuple(shape), x.dtype)]

    def forward(self, x):
        rows, shape = self._global
        if x.ndim and x.shape[0] != rows:
            # a block of dim 0: the only split apply_config keeps
            shape = (x.shape[0],) + shape[1:]
        return x.reshape(shape)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        out = self.infer_shapes([x])[0]
        in_sh = _whole_sums(in_shardings[0] if in_shardings else None, x)
        keep0 = (x.ndim >= 1 and out.ndim >= 1
                 and x.shape[0] == out.shape[0] and in_sh.dims[0].axes)
        req = TensorSharding.replicated(x.ndim)
        out_sh = TensorSharding.replicated(out.ndim)
        if keep0:
            req = req.with_dim(0, in_sh.dims[0].axes)
            out_sh = out_sh.with_dim(0, in_sh.dims[0].axes)
        return ShardingSolution(inputs=[req], outputs=[out_sh])


@register_op
class Transpose(Op, nn.Module):
    type_name = "transpose"

    def __init__(self, perm: Sequence[int]):
        super().__init__()
        self.perm = tuple(int(p) for p in perm)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        return [TensorSpec(tuple(x.shape[p] for p in self.perm), x.dtype)]

    def forward(self, x):
        return x.permute(self.perm)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _whole_sums(in_shardings[0] if in_shardings else None,
                         in_specs[0])
        out_sh = TensorSharding(tuple(sh.dims[p] for p in self.perm),
                                frozenset())
        return ShardingSolution(inputs=[sh], outputs=[out_sh])


class _AxisOp(Op, nn.Module):
    """An op over one axis (``axis``), which must arrive whole; the
    other dimensions adopt the first input's producer's split."""

    def __init__(self, axis: int):
        super().__init__()
        self.axis = int(axis)

    def _sharding(self, in_specs, in_shardings) -> TensorSharding:
        x = in_specs[0]
        sh = _whole_sums(in_shardings[0] if in_shardings else None, x)
        return sh.with_dim(self.axis % x.ndim, ())


@register_op
class Concat(_AxisOp):
    type_name = "concat"

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        ax = self.axis % x.ndim
        shape = list(x.shape)
        shape[ax] = sum(s.shape[ax] for s in in_specs)
        return [TensorSpec(tuple(shape), x.dtype)]

    def forward(self, *xs):
        return torch.cat(xs, dim=self.axis)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = self._sharding(in_specs, in_shardings)
        return ShardingSolution(inputs=[sh] * len(in_specs), outputs=[sh])


@register_op
class Split(_AxisOp):
    type_name = "split"

    def __init__(self, sizes: Sequence[int], axis: int):
        super().__init__(axis)
        self.sizes = tuple(int(s) for s in sizes)

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        ax = self.axis % x.ndim
        if sum(self.sizes) != x.shape[ax]:
            raise ValueError(f"split sizes {self.sizes} != dim {x.shape[ax]}")
        out = []
        for s in self.sizes:
            shape = list(x.shape)
            shape[ax] = s
            out.append(TensorSpec(tuple(shape), x.dtype))
        return out

    def forward(self, x):
        outs = torch.split(x, self.sizes, dim=self.axis)
        return outs if len(outs) > 1 else outs[0]

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = self._sharding(in_specs, in_shardings)
        return ShardingSolution(inputs=[sh], outputs=[sh] * len(self.sizes))


@register_op
class Gather(Op, nn.Module):
    """``torch.gather`` along ``axis`` with an index tensor (reference
    ``take_along_axis``): out has the index's shape."""

    type_name = "gather"

    def __init__(self, axis: int):
        super().__init__()
        self.axis = int(axis)

    def infer_shapes(self, in_specs):
        x, idx = in_specs
        return [TensorSpec(idx.shape, x.dtype)]

    def forward(self, x, idx):
        idx = idx.long()
        idx = torch.where(idx < 0, idx + x.shape[self.axis], idx)
        return torch.gather(x, self.axis, idx)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x, idx = in_specs
        sh_x = TensorSharding.replicated(x.ndim)
        sh_i = TensorSharding.replicated(idx.ndim)
        sample = tuple(config.get("sample", ()))
        if sample and self.axis % x.ndim != 0:
            sh_x = sh_x.with_dim(0, sample)
            sh_i = sh_i.with_dim(0, sample)
        return ShardingSolution(inputs=[sh_x, sh_i], outputs=[sh_i])


@register_op
class Reverse(_AxisOp):
    type_name = "reverse"

    def infer_shapes(self, in_specs):
        return [in_specs[0]]

    def forward(self, x):
        return torch.flip(x, dims=(self.axis,))

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = self._sharding(in_specs, in_shardings)
        return ShardingSolution(inputs=[sh], outputs=[sh])


@register_op
class Flat(Op, nn.Module):
    """Every dimension after the batch's flattened into one (NCHW ->
    N, CHW)."""

    type_name = "flat"

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        return [TensorSpec((x.shape[0], math.prod(x.shape[1:])), x.dtype)]

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        in_sh = propagate(in_shardings[0] if in_shardings else None, x)
        axes0 = in_sh.dims[0].axes if in_sh.dims else ()
        req = TensorSharding.replicated(x.ndim)
        out_sh = TensorSharding.replicated(2)
        if axes0:
            req = req.with_dim(0, axes0)
            out_sh = out_sh.with_dim(0, axes0)
        return ShardingSolution(inputs=[req], outputs=[out_sh])
