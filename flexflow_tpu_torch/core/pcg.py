"""Parallel computation graph: a serve graph, a mesh and per-op configs.

Port of ``flexflow_tpu/core/pcg.py`` (``Step`` :36, ``Plan`` :55,
``PCG`` :82-266) over the port's ``Graph`` (``core/graph.py``), its
``parallel.Mesh`` and the op IR (``core/op.py``).  Each op gets a
parallel config ``{parallel dim: (mesh axes)}``, the searchable object;
:meth:`PCG.plan` propagates shardings through the graph and inserts the
parallel ops (``parallel/parallel_ops.py``) wherever a producer's sharding
differs from a consumer's requirement.  The :class:`Plan` is what the
simulator prices (``search/simulator.py``) and what the plan executor
runs (``parallel/tp.py``).

A model's serve graph names its modules by path and leaves its flat
token axis open (``-1``); :func:`serve_graph` binds each node to its
module's op IR and fixes the token axis at a row count (the reference's
graph is built at ``max_tokens``), over the whole graph or one pipeline
stage's node range (reference ``serve/pp.py:_StageView``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..parallel.parallel_ops import reshard_path
from .graph import Node, TensorSpec
from .op import ShardingSolution
from .sharding import TensorSharding

Config = Dict[str, Tuple[str, ...]]


class OpGraph:
    """A graph-protocol view of serve-graph nodes whose ``op`` is bound
    and whose tensor specs are concrete: the nodes of ``nodes`` (copies
    carrying ``ops``), ``input_tids`` as the graph inputs, the tensor ids
    and names of the ``parent`` graph."""

    def __init__(self, parent, nodes: Sequence[Node], ops: Sequence,
                 input_tids: Sequence[int], rows: int):
        self.nodes = [dataclasses.replace(n, op=op)
                      for n, op in zip(nodes, ops)]
        self.input_tids = list(input_tids)
        self.tensor_specs = [s.resolve(rows) for s in parent.tensor_specs]
        self.rows = int(rows)
        self._parent = parent

    def topo_order(self) -> List[Node]:
        return self.nodes

    def spec(self, tid: int) -> TensorSpec:
        return self.tensor_specs[tid]

    def unique_name(self, base: str) -> str:
        return self._parent.unique_name(base)


def serve_graph(model, rows: int, nodes: Optional[Sequence[Node]] = None,
                input_tids: Optional[Sequence[int]] = None) -> OpGraph:
    """``model.graph`` bound to ``model``'s modules at a flat batch of
    ``rows`` tokens: its span's nodes and entry tensors by default (the
    whole graph, or a stage model's range), or the given ``nodes`` and
    ``input_tids``.  A module-free node keeps its own op."""
    span = model.span
    nodes = span.nodes if nodes is None else nodes
    input_tids = span.entry_tids if input_tids is None else input_tids
    ops = [n.op if n.module is None else model.get_submodule(n.module)
           for n in nodes]
    return OpGraph(model.graph, nodes, ops, input_tids, rows)


@dataclasses.dataclass
class Step:
    """One executable step of a planned PCG (an op or a parallel op)."""

    node: Node                   # the graph's node, or a parallel op's
    in_vids: List[int]           # plan-local value ids consumed
    out_vids: List[int]          # plan-local value ids produced
    in_shardings: List[TensorSharding]
    out_shardings: List[TensorSharding]
    in_specs: List[TensorSpec]
    out_specs: List[TensorSpec]
    config: Config = dataclasses.field(default_factory=dict)
    is_parallel: bool = False

    @property
    def name(self) -> str:
        return self.node.name


@dataclasses.dataclass
class Plan:
    """A resolved plan: the steps and the boundary shardings."""

    mesh: object
    steps: List[Step]
    input_vids: Dict[int, int]                  # graph input tid -> vid
    output_vids: List[int]
    input_shardings: Dict[int, TensorSharding]  # graph input tid -> sh
    output_shardings: List[TensorSharding]
    param_shardings: Dict[str, Dict[str, TensorSharding]]
    value_specs: Dict[int, TensorSpec]
    value_shardings: Dict[int, TensorSharding]

    def pretty(self) -> str:
        lines = [f"Plan over mesh {dict(self.mesh.shape)}:"]
        for s in self.steps:
            tag = "comm" if s.is_parallel else "op  "
            ins = ", ".join(f"v{v}:{sh}"
                            for v, sh in zip(s.in_vids, s.in_shardings))
            outs = ", ".join(f"v{v}:{sh}"
                             for v, sh in zip(s.out_vids, s.out_shardings))
            cfg = f" cfg={s.config}" if s.config else ""
            lines.append(f"  [{tag}] {s.name}: ({ins}) -> ({outs}){cfg}")
        return "\n".join(lines)


class PCG:
    """A graph bound to a mesh with per-op parallel configs."""

    def __init__(self, graph, mesh, configs: Optional[Dict[str, Config]]
                 = None, input_shardings: Optional[Dict[int, TensorSharding]]
                 = None, output_tids: Optional[List[int]] = None):
        self.graph = graph
        self.mesh = mesh
        self.configs: Dict[str, Config] = dict(configs or {})
        self.input_shardings = dict(input_shardings or {})
        if output_tids is None:
            consumed = {t for n in graph.nodes for t in n.inputs}
            output_tids = [t for n in graph.nodes for t in n.outputs
                           if t not in consumed]
        self.output_tids = output_tids

    def with_configs(self, configs: Dict[str, Config]) -> "PCG":
        return PCG(self.graph, self.mesh, configs, self.input_shardings,
                   self.output_tids)

    def default_input_sharding(self, tid: int,
                               cons_req: TensorSharding) -> TensorSharding:
        """Graph inputs adopt their first consumer's requirement, so a
        batch arrives already sharded."""
        return self.input_shardings.get(tid, cons_req)

    def plan(self) -> Plan:
        g = self.graph
        mesh = self.mesh
        next_vid = [0]
        value_specs: Dict[int, TensorSpec] = {}
        value_shardings: Dict[int, TensorSharding] = {}
        tid_to_vid: Dict[int, int] = {}
        steps: List[Step] = []
        input_vids: Dict[int, int] = {}
        input_shardings: Dict[int, TensorSharding] = {}
        param_shardings: Dict[str, Dict[str, TensorSharding]] = {}
        pending_inputs: Dict[int, TensorSpec] = {
            tid: g.spec(tid) for tid in g.input_tids}

        def new_value(spec, sh) -> int:
            vid = next_vid[0]
            next_vid[0] += 1
            value_specs[vid] = spec
            value_shardings[vid] = sh
            return vid

        def materialize_input(tid: int, req: TensorSharding) -> int:
            sh = self.default_input_sharding(tid, req)
            vid = new_value(pending_inputs.pop(tid), sh)
            tid_to_vid[tid] = vid
            input_vids[tid] = vid
            input_shardings[tid] = sh
            return vid

        def reshard_to(vid: int, want: TensorSharding, base_name: str) -> int:
            have = value_shardings[vid]
            if (tuple(have.dims), have.partial_axes) == (tuple(want.dims),
                                                          want.partial_axes):
                return vid
            for pop in reshard_path(have, want, mesh):
                spec = value_specs[vid]
                out_sh = pop.transform_sharding(value_shardings[vid], mesh)
                nvid = new_value(spec, out_sh)
                synth = Node(-1, g.unique_name(f"{base_name}.{pop.type_name}"),
                             None, "parallel", [], [], None, pop)
                steps.append(Step(node=synth, in_vids=[vid], out_vids=[nvid],
                                  in_shardings=[value_shardings[vid]],
                                  out_shardings=[out_sh], in_specs=[spec],
                                  out_specs=[spec], is_parallel=True))
                vid = nvid
            return vid

        for node in g.topo_order():
            in_specs = [g.spec(t) for t in node.inputs]
            config = self.configs.get(node.name, {})
            producer_shs: List[Optional[TensorSharding]] = [
                value_shardings[tid_to_vid[t]] if t in tid_to_vid else None
                for t in node.inputs]
            sol: ShardingSolution = node.op.apply_config(
                config, in_specs, mesh, producer_shs)
            out_specs = [g.spec(t) for t in node.outputs]
            for sh, spec in zip(sol.inputs, in_specs):
                sh.validate(spec.shape, mesh)
            for sh, spec in zip(sol.outputs, out_specs):
                sh.validate(spec.shape, mesh)

            in_vids = []
            for t, req in zip(node.inputs, sol.inputs):
                vid = (materialize_input(t, req) if t in pending_inputs
                       else tid_to_vid[t])
                in_vids.append(reshard_to(vid, req, node.name))

            out_vids = []
            for t, sh, spec in zip(node.outputs, sol.outputs, out_specs):
                vid = new_value(spec, sh)
                tid_to_vid[t] = vid
                out_vids.append(vid)

            if sol.params:
                param_shardings[node.name] = dict(sol.params)
            else:
                ps = node.op.params()
                if ps:
                    param_shardings[node.name] = {
                        p.name: TensorSharding.replicated(p.spec.ndim)
                        for p in ps}

            steps.append(Step(node=node, in_vids=in_vids, out_vids=out_vids,
                              in_shardings=[value_shardings[v]
                                            for v in in_vids],
                              out_shardings=list(sol.outputs),
                              in_specs=in_specs, out_specs=out_specs,
                              config=config))

        # unconsumed graph inputs: replicated
        for tid in list(pending_inputs):
            materialize_input(tid, TensorSharding.replicated(
                g.spec(tid).ndim))

        # graph outputs: clear partial sums, so callers see whole values
        output_vids, output_shardings = [], []
        for t in self.output_tids:
            vid = tid_to_vid[t]
            sh = value_shardings[vid]
            if sh.partial_axes:
                vid = reshard_to(vid, TensorSharding(sh.dims, frozenset()),
                                 f"out_t{t}")
                sh = value_shardings[vid]
            output_vids.append(vid)
            output_shardings.append(sh)

        return Plan(mesh=mesh, steps=steps, input_vids=input_vids,
                    output_vids=output_vids, input_shardings=input_shardings,
                    output_shardings=output_shardings,
                    param_shardings=param_shardings, value_specs=value_specs,
                    value_shardings=value_shardings)
