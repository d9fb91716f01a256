"""The activation cache: Cache.

Port of ``flexflow_tpu/ops/misc.py:24`` (``Cache``, the reference's
``src/ops/cache.cc``): an identity that can replay the value it stored
on an earlier step, for inputs that repeat (static features).  The
stored value is state threaded through the step
(``core/interpreter.py:build_forward``'s ``state=``), not a field of the
module: in refresh mode (no ``extras["cache_use"]``) the op passes its
input through and publishes it as its new state, ``{"cached": x}``; in
use mode it returns the stored value and keeps the state.  Use mode
without a stored value raises ``ValueError``, as the reference does
(:43-50).  Outside a stateful step (``fit``, ``forward``) it is the
identity.  On a mesh each shard keeps the state of its own block.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from ..core.graph import TensorSpec
from ..core.op import Op, OpContext, ShardingSolution, register_op
from ..core.sharding import TensorSharding


@register_op
class Cache(Op, nn.Module):
    """Identity that can replay its previously stored input; state
    ``{"cached": <the last refreshed value>}``."""

    type_name = "cache"
    uses_context = True
    stateful = True

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        return [TensorSpec(x.shape, x.dtype)]

    def forward(self, x, ctx: Optional[OpContext] = None):
        extras = (ctx.extras if ctx is not None else None) or {}
        state = ctx.state if ctx is not None else None
        if extras.get("cache_use"):
            if not state or "cached" not in state:
                raise ValueError(
                    "cache op in use mode without a stored value: run a "
                    "refresh step (no cache_use flag) first")
            ctx.state_out = state
            return state["cached"].to(x.dtype)
        if ctx is not None:
            ctx.state_out = {"cached": x}
        return x

    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0]}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = TensorSharding.replicated(len(in_specs[0].shape))
        sample = tuple(config.get("sample", ()))
        if sample:
            sh = sh.with_dim(0, sample)
        return ShardingSolution(inputs=[sh], outputs=[sh])

    def flops(self, in_specs):
        return 0
