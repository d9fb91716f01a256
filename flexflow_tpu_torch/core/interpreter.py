"""Run graph nodes over a dict of tensors: the serve forward, and the
training forward of a plan with its parameters' initialisation.

Port of ``flexflow_tpu/core/interpreter.py``.  The reference lowers a
plan into one jitted program; eager PyTorch runs the nodes one by one.
:func:`run_nodes` is a generator: each node's collectives
(``parallel/comm.py``) pass through it, so a tensor-parallel manager
steps one generator per shard in lockstep exactly as it steps a whole
model, and pipeline stages run contiguous node ranges of one graph.  A
shard runs its plan's steps (``parallel/tp.py:PlanExecutor``) as such a
node range: each op step its graph node over value ids, each parallel
step a node that yields its collective.

Training (``FFModel``): a ``core/pcg.py`` plan of a builder graph runs
shard by shard on its mesh (reference :36-146, :160-208).
:class:`PlanShards` reads the plan (``parallel/tp.py:ShardPlan``) and
gives each rank its own copy of every op step's module (on one device,
the node's module itself), placed as the plan says
(``parallel/tp.py:place_module``).  :func:`build_forward` runs one
generator a shard through ``parallel/comm.py:run_shards``: each op step's
module on the shard's blocks under an ``OpContext`` holding the step's
config, the shard's rank and mesh and the step's random stream, each
parallel step's collective answered within its axes' groups, the exit
tensors gathered whole on shard 0; autograd differentiates the whole
lockstep run, collectives included.  :func:`init_params` draws every
global parameter from one ``torch.Generator`` over the graph's nodes in
order (:func:`draw_params`), exactly as on one device, and gives each
shard its block as a parameter of its own; :func:`place_inputs` gives
each shard its block of a batch.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.comm import run_local, run_shards
from ..training.initializer import default_initializer_for
from ..utils.platform import host_to_device
from .op import OpContext, mix_seed
from .sharding import mesh_coords, mesh_shape


@dataclasses.dataclass
class StepContext:
    """What a step's nodes read besides their inputs: the batch config,
    the stage's KV state (``{layer: {buffer: tensor}}``), the page
    table of a paged cache (None: slot-contiguous) and the shard's rank
    on its mesh."""

    bc: Any
    state: Dict[str, Dict[str, torch.Tensor]]
    pages: Optional[Any] = None
    rank: int = 0

    @property
    def base(self):
        """The plain ``BatchConfig`` (a tree batch's ``base``)."""
        return getattr(self.bc, "base", self.bc)


def dead_after(nodes: Sequence, keep: Iterable[int]) -> List[List[int]]:
    """For each node, the tensor ids no later node reads and ``keep``
    does not hold: dropped once it ran, so a step holds only its live
    activations.  Fixed for a node range: computed once, when the range
    is made (``serve/models/base.py:StageSpan``)."""
    keep = set(keep)
    last: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        for t in node.inputs:
            last[t] = i
        for t in node.outputs:
            last.setdefault(t, i)
    out: List[List[int]] = [[] for _ in nodes]
    for t, i in last.items():
        if t not in keep:
            out[i].append(t)
    return out


def run_nodes(nodes: Sequence, ops: Sequence, drops: Sequence[List[int]],
              env: Dict[int, torch.Tensor], ctx: StepContext):
    """Run ``nodes`` in order over ``env`` (tensor id -> tensor, holding
    every input the range reads from outside it), each with its module
    in ``ops`` (None: module-free), yielding each node's collectives and
    dropping each node's ``drops`` (:func:`dead_after`) once it ran;
    returns ``env``."""
    for node, op, dead in zip(nodes, ops, drops):
        out = node.run(op, ctx, *(env[t] for t in node.inputs))
        if inspect.isgenerator(out):
            out = yield from out
        if len(node.outputs) == 1:
            env[node.outputs[0]] = out
        else:
            env.update(zip(node.outputs, out))
        for t in dead:
            env.pop(t, None)
    return env


# ---- training: a plan's forward, its parameters, its inputs ----------------
def _block(rank: int, axes: Sequence[str], mesh) -> int:
    """The index of the block shard ``rank`` holds of a tensor split over
    ``axes`` (its coordinates on them, the first axis major)."""
    coords = mesh_coords(rank, mesh)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _op_run(st, index: int, mesh):
    """The ``run`` of op step ``st`` (the plan's ``index``-th step): its
    module under the step's config; a module that draws gets the step's
    stream (the step seed mixed with ``index``) and the block the shard
    holds of the step's tensors (their used axes), so replicas draw the
    same mask and blocks different ones."""
    used = set()
    for sh in list(st.in_shardings) + list(st.out_shardings):
        used |= sh.used_axes()
    axes = [a for a in mesh.shape if a in used and mesh.shape[a] > 1]

    def run(op, ctx, *xs):
        if not op.uses_context:
            return op(*xs)
        states = ctx.states if op.stateful else None
        sctx = dataclasses.replace(
            ctx, config=st.config,
            seed=None if ctx.seed is None else mix_seed(ctx.seed, index),
            block=_block(ctx.rank, axes, mesh),
            state=None if states is None else states.get(st.name))
        out = op(*xs, ctx=sctx)
        if op.stateful and ctx.new_states is not None \
                and sctx.state_out is not None:
            ctx.new_states[st.name] = sctx.state_out
        return out

    return run


def parallel_run(pop, mesh):
    """The ``run`` of a plan's parallel step: its op on the shard's block
    (a generator yielding the op's collective)."""
    def run(op, ctx, x):
        return pop.run(x, ctx.rank, mesh)

    return run


class PlanShards:
    """A training plan read shard by shard: the plan's
    ``parallel/tp.py:ShardPlan`` (``plan``), each rank's module of every
    op step (``ops[rank][node name]``: the node's own module on one
    device, a copy placed for the rank on a mesh, whose parameters
    :func:`init_params` sets) and the executor of the plan's steps."""

    def __init__(self, plan):
        from ..parallel.tp import PlanExecutor, ShardPlan, place_module

        self.plan = ShardPlan(plan)
        self.mesh = plan.mesh
        self.size = plan.mesh.size
        index = {id(st): i for i, st in enumerate(plan.steps)}
        self.executor = PlanExecutor(
            self.plan, 0, lambda st: _op_run(st, index[id(st)], plan.mesh))
        steps = [st for st in plan.steps if not st.is_parallel]
        self.ops: List[Dict[str, nn.Module]] = []
        for rank in range(self.size):
            ops = {}
            for st in steps:
                op = st.node.op
                if self.size > 1:
                    op = copy.deepcopy(op, {id(p): None
                                            for p in op.parameters()})
                    place_module(op, st, self.plan, rank)
                ops[st.name] = op
            self.ops.append(ops)
        self.step_ops = [[None if st.is_parallel else ops[st.name]
                          for st in plan.steps] for ops in self.ops]

    def run(self, rank: int, blocks: Dict[int, torch.Tensor],
            training: bool, seed: Optional[int],
            states: Optional[Dict[str, Any]] = None,
            new_states: Optional[Dict[str, Any]] = None,
            extras: Optional[Dict[str, Any]] = None):
        """Shard ``rank``'s forward over its ``blocks`` (``{graph input
        tid: block}``): a generator of the plan's collectives returning
        the exit tensors (whole on shard 0).  A stateful step gives the
        shard's ``states`` by node and a ``new_states`` dict its stateful
        ops fill."""
        ex = self.executor
        env = {vid: blocks[t] for t, vid in self.plan.plan.input_vids.items()}
        ctx = OpContext(training=training, rank=rank, seed=seed,
                        mesh=self.mesh if self.size > 1 else None,
                        extras=extras, states=states, new_states=new_states)
        env = yield from run_nodes(ex.nodes, self.step_ops[rank], ex.drops,
                                   env, ctx)
        return (yield from ex.leave(env))


def plan_shards(plan) -> PlanShards:
    """``plan``'s :class:`PlanShards`, made at the first call and kept on
    the plan, so its forward and its parameters share the modules."""
    shards = plan.__dict__.get("shards")
    if shards is None:
        shards = plan.shards = PlanShards(plan)
    return shards


def build_forward(plan, mode: str = "spmd") -> Callable:
    """``fn(inputs, training=False, seed=None, state=None, extras=None)
    -> [outputs]``: ``inputs`` ``{graph input tid: [each shard's
    block]}`` (:func:`place_inputs`), every shard's forward run in
    lockstep (``run_shards``; alone with identity collectives on one
    device), the outputs whole on shard 0; ``seed`` is the step's
    (dropout streams derive from it).  ``mode`` is the reference's
    lowering, ``"spmd"`` (GSPMD over global arrays) or ``"local"``
    (``shard_map`` over blocks); both lower here to the one shard-local
    executor, so they compute the same values.

    Stateful execution (reference :44-51, :82-97): given ``state``
    (``{node name: state}``, ``{}`` at first) and ``extras`` (values
    every op sees, ``{"cache_use": True}``), each op marked ``stateful``
    reads its node's state and publishes its new one, and ``fn`` returns
    ``(outputs, new_state)``.  On a mesh a node's state is a list of
    each shard's (its own block's)."""
    if mode not in ("spmd", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    shards = plan_shards(plan)
    n = shards.size

    def fn(inputs: Dict[int, List[torch.Tensor]], training: bool = False,
           seed: Optional[int] = None, state: Optional[Dict[str, Any]] = None,
           extras: Optional[Dict[str, Any]] = None):
        ins = [state if state is None or n == 1 else
               {k: v[r] for k, v in state.items()} for r in range(n)]
        outs = [None if state is None else {} for _ in range(n)]
        gens = [shards.run(r, {t: v[r] for t, v in inputs.items()},
                           training, seed, ins[r], outs[r], extras)
                for r in range(n)]
        if n == 1:
            result = run_local(gens[0])
        else:
            result = run_shards(gens, plan.mesh.comm)[0]
        if state is None:
            return result
        if n == 1:
            return result, outs[0]
        return result, {k: [o[k] for o in outs] for k in outs[0]}

    return fn


def draw_params(graph, generator: torch.Generator):
    """Each global parameter of ``graph``'s nodes drawn from
    ``generator`` in graph order (reference :160-194: its key index
    advances over every node alike), at its global shape with its
    ``ParamSpec``'s initializer (the op's default otherwise): yields
    ``(node, param spec, value)``."""
    for node in graph.nodes:
        for p in node.op.params():
            init = p.initializer or default_initializer_for(node.op, p)
            yield node, p, init(generator, p.spec.shape, p.spec.dtype)


def init_params(graph, plan, generator: torch.Generator
                ) -> List[Dict[str, Dict[str, nn.Parameter]]]:
    """Draw every parameter of ``graph``'s nodes (:func:`draw_params`,
    whatever the mesh), then give each shard its block
    (``TensorSharding.local_slice``) as a parameter of its own on its own
    device (even where shards share one), ``requires_grad`` as the spec
    is ``trainable``, set on the shard's module.  On a mesh the node's
    own module keeps an empty ``meta`` parameter at the global shape (the
    planner reads it).  Returns each shard's ``{node name: {param name:
    parameter}}``."""
    shards = plan_shards(plan)
    devices = plan.mesh.devices
    out: List[Dict[str, Dict[str, nn.Parameter]]] = [
        {} for _ in range(shards.size)]
    for node, p, value in draw_params(graph, generator):
        name = f"{node.name}.{p.name}"
        for r, dev in enumerate(devices):
            if shards.size == 1:
                block = value.to(dev)
            else:
                block = shards.plan.local(name, value, r).to(
                    dev, copy=True, memory_format=torch.contiguous_format)
            param = nn.Parameter(block, requires_grad=p.trainable)
            setattr(shards.ops[r][node.name], p.name, param)
            out[r].setdefault(node.name, {})[p.name] = param
        if shards.size > 1:
            setattr(node.op, p.name, nn.Parameter(
                torch.empty(p.spec.shape, dtype=p.spec.dtype,
                            device="meta"), requires_grad=False))
    return out


def place_inputs(plan, inputs: Dict[int, Any]
                 ) -> Dict[int, List[torch.Tensor]]:
    """A batch ``{graph input tid: host array}`` as each shard's block on
    its device, ``{tid: [block of shard 0, ...]}``, under the plan's
    input shardings, through :func:`~..utils.platform.host_to_device`
    (pinned, without a host wait on a CUDA device).  Shards that hold the
    same block on one device share it."""
    mesh = plan.mesh
    shape = mesh_shape(mesh)
    out: Dict[int, List[torch.Tensor]] = {}
    for t, x in inputs.items():
        sh = plan.input_shardings.get(t)
        whole = torch.as_tensor(np.ascontiguousarray(x)
                                if isinstance(x, np.ndarray) else x)
        placed: Dict[Any, torch.Tensor] = {}
        blocks = []
        for r, d in enumerate(mesh.devices):
            coords = mesh_coords(r, mesh)
            key = (d, None if sh is None else
                   tuple(dim.index(coords, shape) for dim in sh.dims))
            if key not in placed:
                placed[key] = host_to_device(
                    whole if sh is None or mesh.size == 1
                    else sh.local_slice(whole, r, mesh), d)
            blocks.append(placed[key])
        out[t] = blocks
    return out
