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

Training (``FFModel``): :func:`build_forward` (reference :36-146, its
one-device case) runs a ``core/pcg.py`` plan of a builder graph through
:func:`run_nodes`, each op step's module under an ``OpContext`` holding
the step's config; the modules hold the parameters, so autograd
differentiates the call.  :func:`init_params` (:160-194) draws every
parameter from one ``torch.Generator`` over the graph's nodes in order,
and :func:`place_inputs` (:197) puts a batch on the plan's device.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from ..parallel.comm import run_local
from ..training.initializer import default_initializer_for
from ..utils.platform import host_to_device
from .op import OpContext


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
def _op_run(config):
    """The ``run`` of an op step: its module, under ``config``."""
    def run(op, ctx, *xs):
        if not op.uses_context:
            return op(*xs)
        return op(*xs, ctx=dataclasses.replace(ctx, config=config))

    return run


def parallel_run(pop, mesh):
    """The ``run`` of a plan's parallel step: its op on the shard's block
    (a generator yielding the op's collective)."""
    def run(op, ctx, x):
        return pop.run(x, ctx.rank, mesh)

    return run


def _one_device(plan) -> torch.device:
    if plan.mesh.size != 1:
        raise NotImplementedError(
            f"a plan over {plan.mesh.size} devices: data- and tensor-"
            "parallel training comes with slice 11b (ROADMAP.md)")
    return plan.mesh.devices[0]


def build_forward(plan) -> Callable:
    """``fn(inputs, training=False, generator=None) -> [outputs]``:
    ``inputs`` ``{graph input tid: tensor}`` on the plan's device, each
    op step run by its node's module (``step.node.op``) under the step's
    config, each parallel step (the identity on one device) by its op;
    ``generator`` is the step's (dropout draws from it)."""
    _one_device(plan)
    nodes, ops = [], []
    for st in plan.steps:
        run = (parallel_run(st.node.op, plan.mesh) if st.is_parallel
               else _op_run(st.config))
        nodes.append(dataclasses.replace(
            st.node, inputs=list(st.in_vids), outputs=list(st.out_vids),
            run=run))
        ops.append(st.node.op)
    drops = dead_after(nodes, plan.output_vids)

    def fn(inputs: Dict[int, torch.Tensor], training: bool = False,
           generator: Optional[torch.Generator] = None
           ) -> List[torch.Tensor]:
        env = {vid: inputs[t] for t, vid in plan.input_vids.items()}
        ctx = OpContext(training=training, generator=generator)
        env = run_local(run_nodes(nodes, ops, drops, env, ctx))
        return [env[v] for v in plan.output_vids]

    return fn


def init_params(graph, plan, generator: torch.Generator
                ) -> Dict[str, Dict[str, nn.Parameter]]:
    """Draw every parameter of ``graph``'s nodes from ``generator``, in
    graph order (reference :160-194: its key index advances over every
    node alike), with each ``ParamSpec``'s initializer (the op's default
    otherwise), and set it on the node's module on the plan's device,
    ``requires_grad`` as the spec is ``trainable``.  Returns ``{node
    name: {param name: parameter}}``."""
    device = _one_device(plan)
    params: Dict[str, Dict[str, nn.Parameter]] = {}
    for node in graph.nodes:
        group = {}
        for p in node.op.params():
            init = p.initializer or default_initializer_for(node.op, p)
            value = init(generator, p.spec.shape, p.spec.dtype)
            group[p.name] = nn.Parameter(value.to(device),
                                         requires_grad=p.trainable)
            setattr(node.op, p.name, group[p.name])
        if group:
            params[node.name] = group
    return params


def place_inputs(plan, inputs: Dict[int, Any]) -> Dict[int, torch.Tensor]:
    """A batch ``{graph input tid: host array}`` on the plan's device,
    through :func:`~..utils.platform.host_to_device` (pinned, without a
    host wait on a CUDA device)."""
    device = _one_device(plan)
    return {t: host_to_device(x, device) for t, x in inputs.items()}
