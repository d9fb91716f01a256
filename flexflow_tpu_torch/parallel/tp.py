"""Megatron tensor parallelism of a serve model: the placement rules and
the shard-local models they give.

:func:`tensor_parallel_strategy` is a copy of
``flexflow_tpu/serve/inference_manager.py:42-80`` over the port's module
paths, which are the reference's node names: an attention layer is
head-sharded when its KV heads divide by the degree (else replicated:
Falcon-7B's 71 query heads and StarCoder's 48 on one KV head), the MLP's
``gate_proj``/``up_proj``/``fc1``/``c_fc`` are column-sharded and
``down_proj``/``fc2``/``c_proj`` row-sharded, and any other Linear whose
output width divides (the LM head's vocabulary, Falcon's MLP, OPT's
projections) column-sharded; embeddings and norms are replicated, and a
dimension that does not divide stays whole.

The parameters' placement follows the ops' (reference ``ops/linear.py:
135-172``, ``serve/ops.py:964-980``): a column-sharded kernel ``[in, out]``
and its bias split on ``out``, a row-sharded kernel on ``in`` (its bias
whole, added after the reduce), an attention's fused ``qkv [E, KV, G, D]``
and ``qkv_bias [KV, G, D]`` on the KV heads, ``o_proj [QH*D, E]`` on its
rows (``o_bias`` whole, added after the reduce).  An int8 weight's
per-output-channel scale (its shape minus the first dim) goes with the
output dim (reference ``serve/quant.py:55``, ``_scale_sharding``): split
with a column-sharded kernel or ``qkv``, whole with a row-sharded kernel
or ``o_proj``.  Global parameters are quantized first and sliced after,
so a row-sharded int8 weight keeps the global scale on every shard.

:func:`shard_model` copies the global model (on ``meta``) into one shard's
model: the same modules at shard-local shapes, each marked with its
placement (``Linear.tp_mode``, the attention's ``head_shards`` and
``head_offset``), which the forwards read to place their collectives.

:func:`tp_collectives` lists the collectives a stage of the serve graph
needs under a plan, with the bytes each moves per device, as the
reference's PCG inserts its parallel ops (``core/pcg.py:plan``, the
resharding of ``parallel/parallel_ops.py:reshard_path``) and prices them
(``comm_bytes``): the serve planner's TP communication term.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops.linear import Linear
from ..serve.ops import IncMultiHeadSelfAttention

TP_AXES = ("tp",)
COL_NAMES = ("gate_proj", "up_proj", "fc1", "c_fc")
ROW_NAMES = ("down_proj", "fc2", "c_proj")


def tensor_parallel_strategy(model: nn.Module, degree: int
                             ) -> Dict[str, Dict]:
    """``{module path: {"head" | "channel_out" | "channel_in": ("tp",)}}``
    for every sharded attention layer and Linear of ``model`` (the global
    model), as the reference's strategy for a ``tp`` mesh of ``degree``
    devices (reference :42-80; a path the rules leave whole has no
    entry)."""
    strategy: Dict[str, Dict] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, IncMultiHeadSelfAttention):
            if mod.num_kv_heads % degree == 0:
                strategy[name] = {"head": TP_AXES}
        elif isinstance(mod, Linear):
            in_dim, out_dim = mod.kernel.shape
            if any(s in name for s in COL_NAMES):
                if out_dim % degree == 0:
                    strategy[name] = {"channel_out": TP_AXES}
            elif any(s in name for s in ROW_NAMES):
                if in_dim and in_dim % degree == 0:
                    strategy[name] = {"channel_in": TP_AXES}
            elif out_dim % degree == 0:
                strategy[name] = {"channel_out": TP_AXES}
    return strategy


class TPPlan:
    """The placement of one model over ``degree`` shards: the strategy,
    and for each sharded parameter (by state-dict name) the dim it is
    split on.  Parameters not listed are whole on every shard.  ``model``
    is the global model.  At degree 1 every slice is the whole parameter:
    a single device is the mesh of one shard."""

    def __init__(self, model: nn.Module, degree: int):
        self.degree = int(degree)
        self.strategy = tensor_parallel_strategy(model, self.degree)
        self.dims: Dict[str, int] = {}
        for path, spec in self.strategy.items():
            if "head" in spec:
                mod = model.get_submodule(path)
                self.dims[f"{path}.qkv"] = 1
                self.dims[f"{path}.o_proj"] = 0
                if mod.use_bias:
                    self.dims[f"{path}.qkv_bias"] = 0
            elif "channel_out" in spec:
                self.dims[f"{path}.kernel"] = 1
                if model.get_submodule(path).bias is not None:
                    self.dims[f"{path}.bias"] = 0
            else:
                self.dims[f"{path}.kernel"] = 0

    def dim(self, name: str) -> Optional[int]:
        """The dim parameter ``name`` is split on (None: whole).  An int8
        scale ``<w>_scale`` (``w``'s shape minus its first dim) follows
        its weight's output dims."""
        if name.endswith("_scale"):
            d = self.dims.get(name[:-len("_scale")])
            return None if d is None or d == 0 else d - 1
        return self.dims.get(name)

    def local(self, name: str, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Shard ``rank``'s part of the global parameter ``t``."""
        d = self.dim(name)
        if d is None or self.degree == 1:
            return t
        return t.chunk(self.degree, dim=d)[rank]

    def global_shape(self, name: str, shape) -> torch.Size:
        """The global shape of parameter ``name`` from a shard's
        ``shape``."""
        shape = list(shape)
        d = self.dim(name)
        if d is not None:
            shape[d] *= self.degree
        return torch.Size(shape)

    def whole(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        """The global parameter from the shards' parts (on the first
        part's device)."""
        d = self.dim(name)
        if d is None or len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(parts[0].device) for p in parts], dim=d)


def _param(p: nn.Parameter, shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=p.dtype, device=p.device),
                        requires_grad=False)


def shard_model(model: nn.Module, plan: TPPlan, rank: int) -> nn.Module:
    """Shard ``rank``'s model: a copy of the global ``model`` whose sharded
    parameters take their local shapes (still empty) and whose sharded
    modules carry their placement.  The copy keeps the module paths, so
    state-dict names are the global ones.  At degree 1 the shard is
    ``model`` itself, unmarked (its layers yield no collective), so a
    model whose parameters are already filled keeps them."""
    shard = model
    if plan.degree > 1:
        shard = _sliced_copy(model, plan, rank)
    shard.tp_plan = plan
    shard.tp_rank = rank
    return shard


def _sliced_copy(model: nn.Module, plan: TPPlan, rank: int) -> nn.Module:
    if any(not p.is_meta for p in model.parameters()):
        raise ValueError("shard_model takes a model on the meta device "
                         "(from build_model)")
    shard = copy.deepcopy(model)
    deg = plan.degree
    for path, spec in plan.strategy.items():
        mod = shard.get_submodule(path)
        if "head" in spec:
            mod.num_kv_heads //= deg
            mod.num_q_heads //= deg
            mod.head_sharded = True
            mod.head_shards = deg
            mod.head_offset = rank * mod.num_q_heads
        else:
            mod.tp_mode = "col" if "channel_out" in spec else "row"
        for pname, p in list(mod.named_parameters(recurse=False)):
            d = plan.dim(f"{path}.{pname}")
            if d is not None:
                shape = list(p.shape)
                shape[d] //= deg
                setattr(mod, pname, _param(p, shape))
    return shard


# how a value lies over the tp shards: whole on each (REP), its last dim
# split (SPLIT), or a partial sum on each (PARTIAL)
REP, SPLIT, PARTIAL = "rep", "split", "partial"


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a stage (the reference's parallel op): its kind
    (``allreduce``, ``combine`` = all-gather, ``reduction`` =
    reduce-scatter, ``repartition`` = a local slice), the tensor it
    moves, and the bytes it moves per device (reference
    ``ParallelOp.comm_bytes``, ``parallel_ops.py:177-248``)."""

    kind: str
    tid: int
    nbytes: int
    axes: tuple = TP_AXES


def _solution(kind: str, cfg: Dict, have: List[str]):
    """(the layout each input must arrive in, the outputs' layouts) of a
    node of ``kind`` under its strategy entry ``cfg``, given its
    producers' layouts (the reference ops' ``apply_config``: a Linear,
    ``ops/linear.py:135``; the attention, ``serve/ops.py:965``; the norms
    want whole rows, ``ops/norm.py:27``; the gate propagates its first
    input's split, :306; an add keeps a partial sum of two partial sums,
    else wants the second input laid out as the first,
    ``ops/elementwise.py:118``; the embeddings are replicated)."""
    if kind in ("dense", "lm_head"):
        if "channel_out" in cfg:
            return [REP], [SPLIT]
        if "channel_in" in cfg:
            return [SPLIT], [PARTIAL]
        return [REP], [REP]
    if kind == "attention":
        return [REP], [PARTIAL if "head" in cfg else REP]
    if kind == "sigmoid_silu_multi":
        sh = SPLIT if have[0] == SPLIT else REP
        return [sh, sh], [sh]
    if kind == "add":
        if have[0] == have[1] == PARTIAL:
            return [PARTIAL, PARTIAL], [PARTIAL]
        sh = SPLIT if have[0] == SPLIT else REP
        return [sh, sh], [sh]
    if kind in ("embedding", "position_embedding", "norm",
                "residual_rms_norm"):
        n_out = 2 if kind == "residual_rms_norm" else 1
        return [REP] * len(have), [REP] * n_out
    raise ValueError(f"no tensor-parallel layout rule for a {kind!r} node")


def _reshard(have: str, want: str, full: int, degree: int):
    """The collective turning layout ``have`` into ``want`` of a tensor of
    ``full`` bytes (reference ``reshard_path``), and its bytes per
    device: None when the layouts agree."""
    if have == want:
        return None
    if have == PARTIAL and want == SPLIT:
        return "reduction", int(full * (degree - 1) / degree)
    if have == PARTIAL and want == REP:
        return "allreduce", int(2 * full * (degree - 1) / degree)
    if have == SPLIT and want == REP:
        return "combine", int(full * (degree - 1) / degree)
    if have == REP and want == SPLIT:
        return "repartition", 0
    raise ValueError(f"cannot reshard {have} -> {want}")


def tp_collectives(graph, nodes: Sequence, exit_tids: Sequence[int],
                   plan: TPPlan, rows: int) -> List[Collective]:
    """The collectives one stage's ``nodes`` of ``graph`` need under
    ``plan``, in order, at a flat batch of ``rows`` tokens (the graph's
    token axis): each input is resharded to the layout its node wants,
    once per consuming node, as the reference's PCG does; a tensor
    entering the stage arrives in its first consumer's layout; a partial
    sum leaving the stage is all-reduced.  None at degree 1."""
    degree = plan.degree
    if degree <= 1:
        return []
    out: List[Collective] = []

    def move(tid, have, want):
        step = _reshard(have, want, graph.spec(tid).nbytes(rows), degree)
        if step is not None:
            out.append(Collective(step[0], tid, step[1]))

    layout: Dict[int, str] = {}
    for node in nodes:
        cfg = plan.strategy.get(node.module, {}) if node.module else {}
        have = [layout.get(t, REP) for t in node.inputs]
        wants, outs = _solution(node.kind, cfg, have)
        for t, want in zip(node.inputs, wants):
            if t in layout:
                move(t, layout[t], want)
            else:
                layout[t] = want
        layout.update(zip(node.outputs, outs))
    for t in exit_tids:
        if layout.get(t, REP) == PARTIAL:
            move(t, PARTIAL, REP)
    return out
