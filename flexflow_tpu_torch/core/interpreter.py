"""Run a range of serve-graph nodes over a dict of tensors.

The port's counterpart of the serve forward of
``flexflow_tpu/core/interpreter.py`` (``build_forward``): the reference
lowers a plan into one jitted program per stage; eager PyTorch runs the
nodes one by one.  :func:`run_nodes` is a generator: each node's
collectives (``parallel/comm.py``) pass through it, so a tensor-parallel
manager steps one generator per shard in lockstep exactly as it steps a
whole model, and pipeline stages run contiguous node ranges of one graph.
A shard runs its plan's steps (``parallel/tp.py:PlanExecutor``) as such
a node range: each op step its graph node over value ids, each parallel
step a node that yields its collective.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch


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
