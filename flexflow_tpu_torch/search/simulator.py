"""The simulator: the cost of a planned PCG, and the serve planner's half.

Port of ``flexflow_tpu/search/simulator.py``: ``CostBreakdown`` (:38),
``_local_size`` (:55), the fusion-aware step costs (:64-175),
``step_state_bytes`` (:177), ``plan_memory_bytes`` and
``plan_memory_parts`` (:206-287) and ``simulate`` (:305), over the
port's ``core/pcg.py:Plan``.  As in the reference, one compiled step is
a serial walk over the plan's steps: only the heavy ops (GEMMs,
attention, embedding gathers) pay their HBM traffic, the elementwise and
norm glue adds flops only, weights that fit the resident budget
(``vmem_resident_bytes``: the H100 spec puts its L2 there) stream
nothing, there is one step overhead a step, and the parallel steps cost
their ``comm_bytes`` over the machine's link.  A training step
(``training=True``, the default as in the reference) is the forward
times the spec's ``train_step_factor``, each parallel step twice (its
transpose runs in the backward), plus the gradient all-reduce of every
trainable parameter over the batch axes its sharding leaves unused
(``grad_comm``), the overlap folded into both communication parts; its
memory holds four copies of each trainable weight and every
activation.  ``measured`` (a ``search/measure.py:CostCache``, or any
mapping over the same keys) prices a heavy op by its measured time where
it holds the op's key (``_measure_key``: the op's ``attr_signature`` and
its local input shapes, the reference's key).  Here the machine is the
port's (``machine_model.py``), so the ``h100`` spec prices a CUDA mesh;
its constants are the reference's rules (the heavy ops at the bf16
tensor-core peak, whatever their dtype), copied at parity.

The serve half prices a pipeline stage's ``serve.pp.StageCost``
record, whose numbers ``serve/cost.py`` computes: ``serve_component_of``
(:76), and ``plan_memory_parts`` of such a record.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..serve.cost import compose_stage_parts, family_of
from .machine_model import MachineModel

__all__ = ["CostBreakdown", "compose_stage_parts", "plan_memory_bytes",
           "plan_memory_parts", "serve_component_of", "simulate",
           "step_state_bytes"]


def serve_component_of(mod) -> str:
    """The cost family of one serve module by its own marks: the
    ``lm_head`` when ``mark_gated_lm_head`` marked it
    (``cost_logit_rows``), else ``serve/cost.py:family_of``'s."""
    marked = getattr(mod, "cost_logit_rows", None) is not None
    return family_of(mod, mod if marked else None)


@dataclasses.dataclass
class CostBreakdown:
    compute: float = 0.0
    comm: float = 0.0
    grad_comm: float = 0.0

    @property
    def total(self) -> float:
        return self.compute + self.comm + self.grad_comm

    def __str__(self):
        return (f"total={self.total * 1e3:.3f}ms (compute="
                f"{self.compute * 1e3:.3f} comm={self.comm * 1e3:.3f} "
                f"grad={self.grad_comm * 1e3:.3f})")


def _local_size(spec, sh, mesh) -> int:
    try:
        shape = sh.local_shape(spec.shape, mesh)
    except ValueError:
        shape = spec.shape
    return int(np.prod(shape)) if shape else 1


# ops that run as their own kernels on the tensor cores or stream memory;
# everything else is glue that fuses into its neighbours (reference :64)
HEAVY_OPS = frozenset({
    "linear", "batch_matmul", "conv2d", "embedding", "experts",
    "multihead_attention", "inc_multihead_self_attention",
    "spec_inc_multihead_self_attention", "tree_inc_multihead_self_attention",
    "group_by", "aggregate", "aggregate_spec",
})


def _itemsize(spec) -> int:
    return spec.nbytes() // max(spec.size, 1)


def _step_flops(step, mesh) -> float:
    """Local flops: the global flops scaled by the output's shard
    fraction (and a partial output's contracted split)."""
    global_flops = step.node.op.flops(step.in_specs)
    shard_frac = 1.0
    if step.out_specs:
        g = int(np.prod(step.out_specs[0].shape)) or 1
        loc = _local_size(step.out_specs[0], step.out_shardings[0], mesh)
        shard_frac = loc / g
        for a in step.out_shardings[0].partial_axes:
            shard_frac /= mesh.shape[a]
    return global_flops * shard_frac


def _step_compute_time(step, mesh, mm: MachineModel,
                       measured: Optional[Dict] = None,
                       training: bool = True,
                       param_bytes: float = 0.0, fused: bool = True) -> float:
    """One op's share of the step's time (times ``train_step_factor``
    when ``training``); ``param_bytes`` its local weight bytes already
    scaled by the residency rule; a heavy op whose key ``measured``
    holds costs its measured time."""
    spec_hw = mm.spec
    op = step.node.op
    heavy = op.type_name in HEAVY_OPS
    tf = spec_hw.train_step_factor if training else 1.0
    if measured is not None and heavy:
        key = _measure_key(step, mesh)
        if key in measured:
            return measured[key] * tf
    flops = _step_flops(step, mesh)
    if not (fused and not heavy):
        bytes_accessed = param_bytes
        for spec, sh in zip(step.in_specs, step.in_shardings):
            bytes_accessed += _local_size(spec, sh, mesh) * _itemsize(spec)
        for spec, sh in zip(step.out_specs, step.out_shardings):
            bytes_accessed += _local_size(spec, sh, mesh) * _itemsize(spec)
    else:
        bytes_accessed = 0.0   # fused into a neighbour: flops only
    if heavy:
        peak = spec_hw.peak_flops_bf16 * spec_hw.mxu_efficiency
    else:
        dtype_bits = (8 * _itemsize(step.out_specs[0])
                      if step.out_specs else 32)
        peak = (spec_hw.peak_flops_bf16 if dtype_bits <= 16
                else spec_hw.peak_flops_f32)
        peak /= 8.0   # glue runs well below the matrix units' peak
    fwd = max(flops / peak, bytes_accessed / spec_hw.hbm_bandwidth)
    if not fused:
        fwd += spec_hw.kernel_overhead
    return fwd * tf


def _step_param_bytes(step, plan, mesh) -> float:
    """Local weight bytes the op streams a step."""
    pshs = plan.param_shardings.get(step.node.name, {})
    total = 0.0
    for p in step.node.op.params():
        sh = pshs.get(p.name)
        n = _local_size(p.spec, sh, mesh) if sh is not None else p.spec.size
        total += n * _itemsize(p.spec)
    return total


def _measure_key(step, mesh):
    """The measured-cost key of one op step (reference :169): the op's
    ``attr_signature`` and its inputs' local shapes."""
    local_in = tuple(sh.local_shape(spec.shape, mesh)
                     for spec, sh in zip(step.in_specs, step.in_shardings))
    return (step.node.op.attr_signature(), local_in)


def step_state_bytes(step, mesh, names=None) -> float:
    """Local bytes of one op's registered serve-state buffers (KV caches
    and spec buffers), sharded by the step's own ``head`` config;
    ``names`` restricts to those buffers.  0 for an op without
    registered capacities."""
    op = step.node.op
    if not (hasattr(op, "state_specs")
            and getattr(op, "cost_max_requests", None)):
        return 0.0
    head_axes = tuple((step.config or {}).get("head", ()))
    specs = op.state_specs(op.cost_max_requests,
                           getattr(op, "cost_seq_len", 512),
                           getattr(op, "cost_max_spec", 0), head_axes)
    total = 0.0
    for name, (shape, dt, sh) in specs.items():
        if names is not None and name not in names:
            continue
        try:
            local = sh.local_shape(shape, mesh)
        except ValueError:
            local = shape
        total += int(np.prod(local)) * _dtype_size(dt)
    return total


def _dtype_size(dt) -> int:
    import torch

    return torch.empty((), dtype=dt).element_size()


def plan_memory_bytes(plan, training: bool = True) -> float:
    """Per-device peak-HBM estimate of a planned PCG (reference :206):
    local weights (four times each trainable one when ``training``: the
    weight, its gradient and two optimizer slots), the serve-state
    buffers of the attention ops whose capacities were registered
    (sharded by each plan's own ``head`` config), and the activations
    (every op output when training, else the largest).  An upper bound:
    the search uses it to reject plans."""
    return plan_memory_parts(plan, training=training)["total"]


_INT8_PARAM_NAMES = ("kernel", "qkv", "o_proj")


def plan_memory_parts(plan, training: bool = True) -> Dict[str, float]:
    """The predicted HBM of one device, in bytes, by component
    (``weights``, ``kv_state``, ``transient``, ``total``; reference
    :228), of a planned PCG or of a pipeline stage's ``StageCost`` record
    (whose inference parts ``serve/cost.py`` computed)."""
    if not hasattr(plan, "steps"):
        if training:
            raise ValueError("a StageCost record holds inference memory; "
                             "pass training=False")
        return dict(plan.memory)
    mesh = plan.mesh
    params, state, acts = 0.0, 0.0, []
    for step in plan.steps:
        if step.is_parallel:
            continue
        pshs = plan.param_shardings.get(step.node.name, {})
        q8 = getattr(step.node.op, "quantization", None) == "int8"
        for p in step.node.op.params():
            sh = pshs.get(p.name)
            n = _local_size(p.spec, sh, mesh) if sh is not None else p.spec.size
            if q8 and p.name in _INT8_PARAM_NAMES and len(p.spec.shape) >= 2:
                # int8 values and the global f32 scale count (errs high)
                b = n + (p.spec.size // p.spec.shape[0]) * 4
            else:
                b = n * _itemsize(p.spec)
            params += b * (4.0 if training and p.trainable else 1.0)
        for spec, sh in zip(step.out_specs, step.out_shardings):
            acts.append(_local_size(spec, sh, mesh) * _itemsize(spec))
        state += step_state_bytes(step, mesh)
    act = sum(acts) if training else max(acts, default=0)
    return {"weights": params, "kv_state": state, "transient": act,
            "total": params + act + state}


def simulate(plan, machine: Optional[MachineModel] = None,
             training: bool = True, measured: Optional[Dict] = None,
             overlap: Optional[float] = None,
             fused: bool = True) -> CostBreakdown:
    """One step's predicted time for ``plan`` (reference :305): a
    training step by default; ``measured`` the op-cost cache;
    ``overlap`` the share of communication hidden behind compute
    (default the machine spec's), ``fused=False`` the per-op roofline."""
    mesh = plan.mesh
    mm = machine or MachineModel.for_mesh(mesh)
    if overlap is None:
        overlap = mm.spec.overlap
    cost = CostBreakdown()
    param_total = sum(_step_param_bytes(s, plan, mesh)
                      for s in plan.steps if not s.is_parallel)
    stream_frac = 1.0
    if fused and param_total > 0:
        stream_frac = max(0.0,
                          1.0 - mm.spec.vmem_resident_bytes / param_total)
    for step in plan.steps:
        if step.is_parallel:
            op = step.node.op
            b = op.comm_bytes(step.in_specs[0], step.in_shardings[0], mesh)
            t = mm.collective_time(b, getattr(op, "axes", ()), mesh)
            if training:
                t *= 2.0   # the reshard's transpose runs in the backward
            cost.comm += t
        else:
            cost.compute += _step_compute_time(
                step, mesh, mm, measured, training,
                param_bytes=_step_param_bytes(step, plan, mesh) * stream_frac,
                fused=fused)
    if fused:
        cost.compute += mm.spec.step_overhead   # one dispatch a step
    if training:
        cost.grad_comm = _grad_comm(plan, mesh, mm)
    # fold the hidden share into both parts, so they still sum to total
    hidden = min(cost.comm + cost.grad_comm, cost.compute) * overlap
    total_comm = cost.comm + cost.grad_comm - hidden
    if cost.comm + cost.grad_comm > 0:
        scale = total_comm / (cost.comm + cost.grad_comm)
        cost.comm *= scale
        cost.grad_comm *= scale
    return cost


def _grad_comm(plan, mesh, mm: MachineModel) -> float:
    """The gradient all-reduce (reference :362-388): each trainable
    parameter of an op whose config splits its batch (``sample``) is
    summed over those batch axes its own sharding leaves unused, a ring
    all-reduce of its local bytes."""
    total = 0.0
    for step in plan.steps:
        if step.is_parallel or not step.config:
            continue
        batch_axes = tuple(step.config.get("sample", ()))
        if not batch_axes:
            continue
        pshs = plan.param_shardings.get(step.node.name, {})
        ps = {p.name: p for p in step.node.op.params()}
        for pname, sh in pshs.items():
            if not ps.get(pname) or not ps[pname].trainable:
                continue
            axes = tuple(a for a in batch_axes if a not in sh.used_axes())
            if not axes:
                continue
            spec = ps[pname].spec
            deg = 1
            for a in axes:
                deg *= mesh.shape[a]
            local_bytes = _local_size(spec, sh, mesh) * _itemsize(spec)
            b = 2 * local_bytes * (deg - 1) / deg
            total += mm.collective_time(b, axes, mesh)
    return total
