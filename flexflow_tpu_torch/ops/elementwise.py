"""The elementwise add's op IR, and sharding propagation.

Port of ``flexflow_tpu/ops/elementwise.py``'s ``propagate`` (:78) and
``ElementBinary`` (:104-232) for the serve graphs' module-free add
node (``serve/models/base.py``; the add itself is ``a + b``).  An elementwise op is parallel in every dimension, so it adopts
its producer's sharding; two partial sums over the same axes add into a
partial sum, anything else wants the reduction first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core.graph import TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding


def propagate(sh: Optional[TensorSharding],
              spec: TensorSpec) -> TensorSharding:
    return sh if sh is not None else TensorSharding.replicated(spec.ndim)


@register_op
class ElementBinary(Op):
    type_name = "element_binary"
    FNS = ("add", "sub", "mul", "div", "max", "min", "pow")

    def __init__(self, fn: str):
        if fn not in self.FNS:
            raise ValueError(f"unknown binary fn {fn!r}")
        self.fn = fn

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
