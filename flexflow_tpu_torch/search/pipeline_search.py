"""Pipeline-parallel strategy search: stage partitioning and its cost.

Port of ``flexflow_tpu/search/pipeline_search.py`` (:36-302), over the
port's planner (``core/pcg.py``, ``search/simulator.py``,
``search/search.py``) and machine model, at parity with the reference's
numbers:

* :func:`chain_partition`: the optimal contiguous partition of an op
  chain into K stages, minimising the largest stage's time (a dynamic
  programme over prefix sums);
* :func:`simulate_pipeline`: the GPipe bubble model, ``(M + K - 1) * t``
  for the slowest stage's microbatch time ``t``, plus the boundary
  activations shipped stage to stage each microbatch (twice while
  training: gradients flow back);
* :func:`propose_pipeline`: per-op microbatch times from the simulator
  the search scores with, per-cut boundary bytes from the graph's
  tensor specs; returns the stage map and the step time, comparable
  with ``simulate``'s totals;
* :func:`pipeline_or_gspmd`: searches both plans, the GSPMD one over
  every axis and the pipeline over the non-pp axes (behind a mesh view
  that hides the pp axis), and returns the cheaper.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import TensorSpec
from ..core.pcg import PCG
from .machine_model import MachineModel
from .simulator import _local_size, _step_compute_time, _step_param_bytes


def _microbatch_step(step, n_micro: int):
    """The step with its activations' batch (leading) dim scaled to one
    microbatch: weight-bound ops keep their cost, batch-bound ops shrink,
    priced through the same roofline and probes as whole steps."""
    def scale(spec):
        if not spec.shape:
            return spec
        b = max(spec.shape[0] // n_micro, 1)
        return TensorSpec((b,) + tuple(spec.shape[1:]), spec.dtype)

    return dataclasses.replace(
        step,
        in_specs=[scale(s) for s in step.in_specs],
        out_specs=[scale(s) for s in step.out_specs],
    )


def chain_partition(costs: Sequence[float], k: int) -> List[int]:
    """Split ``costs`` into ``k`` contiguous groups minimising the largest
    group sum; returns the group index of each element."""
    n = len(costs)
    k = min(k, n)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    inf = float("inf")
    best = np.full((n + 1, k + 1), inf)
    cut = np.zeros((n + 1, k + 1), np.int64)
    best[0, 0] = 0.0
    for j in range(1, k + 1):
        for end in range(1, n + 1):
            for start in range(j - 1, end):
                c = max(best[start, j - 1], prefix[end] - prefix[start])
                if c < best[end, j]:
                    best[end, j] = c
                    cut[end, j] = start
    bounds = [n]
    for j in range(k, 0, -1):
        bounds.append(int(cut[bounds[-1], j]))
    bounds = bounds[::-1]   # [0, c1, ..., n]
    out = []
    for stage, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        out += [stage] * (b - a)
    return out


def simulate_pipeline(stage_costs: Sequence[float],
                      boundary_bytes: Sequence[float], n_micro: int,
                      mm: MachineModel, axes: Tuple[str, ...], mesh,
                      training: bool = True) -> float:
    """The GPipe step time for per-microbatch ``stage_costs``;
    ``boundary_bytes`` the activation bytes crossing each cut a
    microbatch (doubled while training: gradients flow back)."""
    k = len(stage_costs)
    t = max(stage_costs) if stage_costs else 0.0
    comm = sum(mm.collective_time(b * (2.0 if training else 1.0), axes, mesh)
               for b in boundary_bytes)
    return (n_micro + k - 1) * t + n_micro * comm


def propose_pipeline(graph, mesh, pp_axis: str, n_micro: int = 8,
                     machine: Optional[MachineModel] = None,
                     measured: Optional[Dict] = None,
                     strategy: Optional[Dict] = None, training: bool = True,
                     memory_limit: Optional[float] = None,
                     groups: Optional[Dict[str, int]] = None
                     ) -> Tuple[Dict[str, int], float]:
    """The optimal stage map of the graph's op chain and its step time.

    Per-op times come from the PCG planned under ``strategy`` (non-pp
    axes only) at microbatch shapes, priced as the search prices;
    ``groups`` (node name -> group index, contiguous in op order) keeps
    each single-entry single-exit segment in one stage: the partition
    runs over the groups' summed costs.  Under ``memory_limit`` a stage
    whose parameters (four copies while training) and activations
    exceed it makes the cost infinite."""
    k = mesh.shape[pp_axis]
    mm = machine or MachineModel.for_mesh(mesh)
    plan = PCG(graph, mesh, strategy or {}, output_tids=None).plan()
    steps = [s for s in plan.steps if not s.is_parallel]
    # the simulator's weight-residency rule per stage: a stage holds
    # about 1/k of the weights
    param_total = sum(_step_param_bytes(s, plan, mesh) for s in steps)
    per_stage = param_total / max(k, 1)
    stream_frac = (max(0.0, 1.0 - mm.spec.vmem_resident_bytes / per_stage)
                   if per_stage > 0 else 0.0)
    times = [
        _step_compute_time(
            _microbatch_step(s, n_micro), mesh, mm, measured, training,
            param_bytes=_step_param_bytes(s, plan, mesh) * stream_frac)
        for s in steps
    ]
    if groups:
        gids = [groups.get(s.node.name, 0) for s in steps]
        order = sorted(set(gids))
        gsum = {g: 0.0 for g in order}
        for t, g in zip(times, gids):
            gsum[g] += t
        g_stage = chain_partition([gsum[g] for g in order], k)
        stage_by_gid = dict(zip(order, g_stage))
        stage_of_idx = [stage_by_gid[g] for g in gids]
    else:
        stage_of_idx = chain_partition(times, k)

    # boundary activation bytes a microbatch, per device (the producer
    # may be sharded over non-pp axes by the inner strategy)
    nid_stage = {s.node.nid: stg for s, stg in zip(steps, stage_of_idx)}
    out_sharding = {}
    for s in steps:
        for tid, spec, sh in zip(s.node.outputs, s.out_specs,
                                 s.out_shardings):
            out_sharding[tid] = (spec, sh)
    boundary = [0.0] * max(k - 1, 1)
    # a tensor read several stages on crosses every cut between its
    # producer and its furthest consumer, once each
    far_stage: Dict[int, int] = {}
    for s, stg in zip(steps, stage_of_idx):
        for tid in s.node.inputs:
            far_stage[tid] = max(far_stage.get(tid, 0), stg)
    for tid, stg in far_stage.items():
        prod = graph.producer.get(tid)
        if prod is None:
            continue
        src_stage = nid_stage.get(prod[0])
        if src_stage is None or src_stage >= stg:
            continue
        spec, sh = out_sharding.get(tid, (graph.spec(tid), None))
        if sh is not None:
            local = _local_size(spec, sh, mesh) * (
                spec.nbytes() // max(spec.size, 1))
        else:
            local = spec.nbytes()
        for c in range(src_stage, stg):
            boundary[c] += local / n_micro

    stage_costs = [0.0] * k
    for t, stg in zip(times, stage_of_idx):
        stage_costs[stg] += t
    cost = simulate_pipeline(stage_costs, boundary, n_micro, mm, (pp_axis,),
                             mesh, training=training)
    if memory_limit:
        stage_mem = [0.0] * k
        for s, stg in zip(steps, stage_of_idx):
            stage_mem[stg] += _step_param_bytes(s, plan, mesh) * (
                4.0 if training else 1.0)
            for spec in s.out_specs:
                stage_mem[stg] += spec.nbytes()
        if max(stage_mem) > memory_limit:
            cost = float("inf")
    return {s.node.name: stg for s, stg in zip(steps, stage_of_idx)}, cost


class _MaskedMesh:
    """A view of ``mesh`` whose ``hide`` axis has size 1, so the search
    enumerates no config over it; everything else is the mesh's own
    (reference :263-281: the planner reads ``shape`` and
    ``axis_names``, the machine model ``devices``)."""

    def __init__(self, mesh, hide: str):
        self._mesh = mesh
        self._hide = hide

    @property
    def axis_names(self):
        return self._mesh.axis_names

    @property
    def shape(self):
        d = dict(self._mesh.shape)
        d[self._hide] = 1
        return d

    def __getattr__(self, name):
        return getattr(self._mesh, name)


def pipeline_or_gspmd(graph, mesh, pp_axis: str = "pp", n_micro: int = 8,
                      machine: Optional[MachineModel] = None,
                      measured: Optional[Dict] = None, budget: int = 200,
                      seed: int = 0, training: bool = True,
                      memory_limit: Optional[float] = None,
                      groups: Optional[Dict[str, int]] = None,
                      candidates: Optional[Dict[str, float]] = None):
    """Search both plans and return the cheaper under the cost model:
    ``(kind, strategy, stage_of, cost)``, ``kind`` ``"gspmd"`` (the
    search over every axis, pp a sharding axis like any other; ``stage_of``
    None) or ``"pipeline"`` (the search over the non-pp axes, then the
    optimal partition over pp).  ``candidates``, a dict, receives both
    prices under ``"gspmd"`` and ``"pipeline"``."""
    from .search import graph_optimize
    from .simulator import simulate

    mm = machine or MachineModel.for_mesh(mesh)
    try:
        gspmd = graph_optimize(graph, mesh, budget=budget, machine=mm,
                               measured=measured, seed=seed,
                               training=training, memory_limit=memory_limit,
                               on_infeasible="raise")
        cost_gspmd = simulate(PCG(graph, mesh, gspmd).plan(), mm,
                              training=training, measured=measured).total
    except ValueError:   # no GSPMD strategy fits the memory limit
        gspmd, cost_gspmd = None, float("inf")
    # the inner search sees no pp axis, and no memory guard: the masked
    # view cannot see the pipeline divide the parameters over stages,
    # which propose_pipeline checks per stage
    inner = graph_optimize(graph, _MaskedMesh(mesh, pp_axis), budget=budget,
                           machine=mm, measured=measured, seed=seed,
                           training=training, memory_limit=0)
    stage_of, cost_pp = propose_pipeline(
        graph, mesh, pp_axis, n_micro=n_micro, machine=mm,
        measured=measured, strategy=inner, training=training,
        memory_limit=memory_limit, groups=groups)
    if candidates is not None:
        candidates.update(gspmd=cost_gspmd, pipeline=cost_pp)
    if cost_pp == float("inf") and cost_gspmd == float("inf"):
        raise ValueError("neither a GSPMD strategy nor a pipeline partition "
                         "fits the memory limit")
    if cost_pp < cost_gspmd:
        return "pipeline", inner, stage_of, cost_pp
    return "gspmd", gspmd, None, cost_gspmd
