"""The op IR and the context an op computes in.

Port of ``flexflow_tpu/core/op.py``: the IR half (``ShardingSolution``
:58, ``Op`` :89-130 and its cost hints, the registry) is the
declarative description of which logical dimensions an op can be
parallelized over (``parallel_dims``) and, for a parallel config
``{parallel dim: (mesh axes)}``, which shardings its inputs, parameters
and outputs take (``apply_config``), as the SOAP dimensions of the
MLSys'19 paper.  The PCG (``core/pcg.py``) inserts the parallel ops
wherever a producer's sharding differs from a consumer's requirement.

The compute half (``OpContext`` :36-56, ``Op.lower`` :80-88,
``bias_once`` :151) takes PyTorch's idiom: an op is an ``nn.Module``
that computes in ``forward`` and holds its parameters, and autograd
gives the backward.  An op whose result depends on more than its inputs
(dropout, the training attention) sets ``uses_context`` and takes an
:class:`OpContext` as ``forward(*inputs, ctx=...)``: whether the step
trains, the random stream its draws come from, the node's parallel
config and the shard's place on its mesh.
The serve modules take :class:`Op` as a mixin beside ``nn.Module``
(``ops/linear.py``, ``ops/embedding.py``, ``ops/norm.py``,
``serve/ops.py``), and so do the training ops (``ops/elementwise.py``,
``ops/reduction.py``, ``ops/attention.py``); the serve path's plan
executor (``parallel/tp.py``) gives each module its shard, and
``core/interpreter.py:build_forward`` runs a training plan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .graph import ParamSpec, TensorSpec
from .sharding import TensorSharding, mesh_coords

Config = Dict[str, Tuple[str, ...]]


@dataclasses.dataclass
class OpContext:
    """What an op that ``uses_context`` reads besides its inputs
    (reference :36-56): ``training`` (dropout is the identity when
    False), the node's parallel ``config``, the shard's ``rank`` on its
    ``mesh`` (None: one device), and where random draws come from:
    ``generator``, or else a stream derived from the step's ``seed`` and
    the shard's ``block`` (:meth:`stream`).  A training plan
    (``core/interpreter.py:build_forward``) gives each op step a seed of
    its own and each shard the index of the block it holds of the step's
    tensors, so shards holding different blocks draw different masks and
    replicas of one block draw the same.

    A stateful step (``build_forward``'s ``state=``, reference :44-51)
    also gives ``extras`` (values every op sees, e.g. ``"cache_use"``),
    each op marked ``stateful`` its own ``state``, and takes what the op
    puts in ``state_out`` as its new state; ``states`` and ``new_states``
    are the shard's state by node, in and out."""

    training: bool = False
    generator: Optional[torch.Generator] = None
    config: Optional[Config] = None
    rank: int = 0
    mesh: Optional[object] = None
    seed: Optional[int] = None
    block: int = 0
    extras: Optional[Dict[str, Any]] = None
    states: Optional[Dict[str, Any]] = None
    new_states: Optional[Dict[str, Any]] = None
    state: Any = None
    state_out: Any = None

    def stream(self, device) -> Optional[torch.Generator]:
        """The generator an op draws from on ``device``: ``generator``,
        else one seeded from ``seed`` and ``block``, else None (the op
        falls back to its own seed, as the reference's
        ``PRNGKey(seed)``)."""
        if self.generator is not None:
            return self.generator
        if self.seed is None:
            return None
        return torch.Generator(device).manual_seed(
            mix_seed(self.seed, self.block))


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit seed from ``seed`` and ``salt`` (splitmix64's finalizer),
    so nearby salts give unrelated streams."""
    z = (seed + (salt + 1) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass
class ShardingSolution:
    """What ``Op.apply_config`` gives: the sharding each input must
    arrive in, the shardings the outputs come out in, and the parameters'
    (a parameter not listed is replicated)."""

    inputs: List[TensorSharding]
    outputs: List[TensorSharding]
    params: Dict[str, TensorSharding] = dataclasses.field(
        default_factory=dict)


class Op:
    """The IR of one operator.  Subclasses set ``type_name`` (the
    reference op's) and implement the hooks."""

    type_name: str = "op"
    # forward(*inputs, ctx=OpContext) rather than forward(*inputs)
    uses_context: bool = False
    # keeps state across steps (ops/misc.py:Cache; needs uses_context)
    stateful: bool = False

    def infer_shapes(self, in_specs: List[TensorSpec]) -> List[TensorSpec]:
        raise NotImplementedError

    def params(self) -> List[ParamSpec]:
        return []

    def parallel_dims(self, in_specs: List[TensorSpec]) -> Dict[str, int]:
        """Named shardable parallel dims -> global extent; by default the
        leading (sample) dim of the first input."""
        if in_specs and in_specs[0].ndim >= 1:
            return {"sample": in_specs[0].shape[0]}
        return {}

    def apply_config(self, config: Config, in_specs: List[TensorSpec], mesh,
                     in_shardings: Optional[List[Optional[TensorSharding]]]
                     = None) -> ShardingSolution:
        """Map a parallel config to tensor shardings.  ``in_shardings``
        carries the producers' shardings (None for graph inputs), so a
        propagating op can adopt them.  By default ``sample`` splits dim
        0 of every input and output; parameters are replicated."""
        sample_axes = tuple(config.get("sample", ()))
        out_specs = self.infer_shapes(list(in_specs))

        def sh(spec):
            s = TensorSharding.replicated(spec.ndim)
            if sample_axes and spec.ndim >= 1:
                s = s.with_dim(0, sample_axes)
            return s

        return ShardingSolution(inputs=[sh(s) for s in in_specs],
                                outputs=[sh(s) for s in out_specs])

    def flops(self, in_specs: List[TensorSpec]) -> int:
        """Approximate forward flops; by default one per output
        element."""
        return sum(s.size for s in self.infer_shapes(list(in_specs)))

    def is_parallel_op(self) -> bool:
        return False

    def signature_attrs(self) -> Dict[str, object]:
        """The attributes the reference op holds in its ``vars()``: this
        op's own (not ``nn.Module``'s ``training`` nor a private one),
        ``compute_dtype`` under the reference's name ``dtype``.  An op
        that keeps a reference field under another name or outside
        ``vars()`` (a property over its parameter's shape) adds it."""
        out = {k: v for k, v in vars(self).items()
               if not k.startswith("_") and k not in _MODULE_STATE}
        if "compute_dtype" in out:
            out["dtype"] = out.pop("compute_dtype")
        return out

    def attr_signature(self) -> Tuple:
        """A hashable signature of the op's scalar attributes, the
        reference's tuple for the same op (reference :139): the key of a
        measured cost (``search/measure.py:CostCache``), so a cost file
        serves both packages.  A dtype is its numpy name."""
        items = []
        for k, v in sorted(self.signature_attrs().items()):
            if isinstance(v, torch.dtype):
                v = dtype_name(v)
            if isinstance(v, (int, float, str, bool, tuple, type(None))):
                items.append((k, v))
        return (self.type_name, tuple(items))


# nn.Module's instance state that is no attribute of the op
_MODULE_STATE = frozenset({"training"})


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy names it (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def bias_once(bias: torch.Tensor, axes, ctx: OpContext) -> torch.Tensor:
    """A bias counted once by the sum of an output that is partial over
    ``axes`` (reference :151): whole on the shards at coordinate 0 of
    every axis in ``axes``, zeros on the others (a ``dp x tp`` mesh's
    rank 2 is ``dp=1, tp=0`` and adds it); the bias itself when the
    output is whole."""
    if axes and ctx.mesh is not None:
        coords = mesh_coords(ctx.rank, ctx.mesh)
        if any(coords.get(a, 0) for a in axes):
            return torch.zeros_like(bias)
    return bias


# op type name -> class, for strategy and serialisation round trips
OP_REGISTRY: Dict[str, type] = {}


def register_op(cls):
    OP_REGISTRY[cls.type_name] = cls
    return cls
