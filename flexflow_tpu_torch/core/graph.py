"""The graph: nodes over tensor ids, and the live cuts between them.

Port of ``flexflow_tpu/core/graph.py`` (``TensorSpec`` :21, ``Tensor``
:53, ``Node`` :83, ``Graph`` :97, ``live_cuts`` :177).  Two kinds of node
share it.  The ``FFModel`` builder (training, ``model.py``) appends nodes
that hold their op (:meth:`Graph.add_op`, reference ``add_node``
:119-137): ``op`` is the node's ``nn.Module``, ``module`` its name, and
the output specs come from ``op.infer_shapes``.  A family's model
records its forward here as the reference's builder records it: the same
nodes, in the same order, with the same names and the same tensor ids.
A node names the ``nn.Module`` it calls by its path in the model that
runs it (``module``, None for a module-free op, an elementwise add), so
the graph holds no module and a copy or a stage of the model runs its
own; ``kind`` says what the node does (``"attention"``, ``"dense"``...)
and ``run`` how (``core/interpreter.py``).
A serve tensor's shape names its flat token axis ``-1``: one graph serves
every batch capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

TOKENS = -1   # the flat token axis of a TensorSpec's shape


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one logical (global) tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def size(self) -> int:
        """Elements of a concrete spec (no token axis left)."""
        n = 1
        for d in self.shape:
            n *= d
        return n

    def resolve(self, rows: int) -> "TensorSpec":
        """The concrete spec at a flat batch of ``rows`` tokens."""
        return TensorSpec(tuple(rows if d == TOKENS else d
                                for d in self.shape), self.dtype)

    def nbytes(self, rows: Optional[int] = None) -> int:
        """Bytes of the tensor at a flat batch of ``rows`` tokens (None: a
        concrete spec)."""
        spec = self if rows is None else self.resolve(rows)
        return spec.size * self.itemsize

    def __str__(self) -> str:
        return f"{str(self.dtype).replace('torch.', '')}{list(self.shape)}"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A weight owned by a node: its name and global spec (reference
    :42)."""

    name: str
    spec: TensorSpec
    initializer: object = None
    trainable: bool = True


@dataclasses.dataclass
class Node:
    """One operator instance: ``run(op, ctx, *inputs)``, with ``op`` the
    module at ``module`` in the model that runs the node, returns the
    outputs (a tuple when there are several), or is a generator that
    yields the op's collectives and returns them.  ``op`` is the node's
    op IR (``core/op.py``) where the graph carries it: a module-free
    node's own (the add's), or the module bound by ``core/pcg.py``'s
    view of a model; a plan's parallel step holds its parallel op.  A
    builder node (:meth:`Graph.add_op`) holds its module as ``op`` and
    has no ``run``: ``core/interpreter.py:build_forward`` runs it under
    its plan step's config."""

    nid: int
    name: str
    module: Optional[str]        # path of the module called, None if none
    kind: str                    # the builder call that made the node
    inputs: List[int]            # tensor ids
    outputs: List[int]           # tensor ids
    run: Optional[Callable] = None
    op: Any = None

    def __repr__(self) -> str:
        ins = ",".join(f"t{t}" for t in self.inputs)
        outs = ",".join(f"t{t}" for t in self.outputs)
        return f"{self.name}({ins})->({outs})"


class Tensor:
    """Handle to a tensor of a :class:`Graph` (what the ``FFModel``
    builder methods return, reference :53-76)."""

    __slots__ = ("graph", "tid")

    def __init__(self, graph: "Graph", tid: int):
        self.graph = graph
        self.tid = tid

    @property
    def spec(self) -> TensorSpec:
        return self.graph.tensor_specs[self.tid]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.spec.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.spec.dtype

    def __repr__(self) -> str:
        return f"Tensor(t{self.tid}: {self.spec})"


class Graph:
    """A DAG of Nodes over tensor ids, built incrementally (append-only,
    so the node list is a topological order)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.tensor_specs: List[TensorSpec] = []
        self.producer: Dict[int, Tuple[int, int]] = {}  # tid -> (nid, slot)
        self.input_tids: List[int] = []
        self._name_counts: Dict[str, int] = {}

    def add_input(self, spec: TensorSpec) -> int:
        tid = self._new_tensor(spec)
        self.input_tids.append(tid)
        return tid

    def _new_tensor(self, spec: TensorSpec) -> int:
        self.tensor_specs.append(spec)
        return len(self.tensor_specs) - 1

    def unique_name(self, base: str) -> str:
        n = self._name_counts.get(base, 0)
        self._name_counts[base] = n + 1
        return f"{base}_{n}" if n else base

    def add_node(self, module: Optional[str], kind: str,
                 inputs: Sequence[int], name: str,
                 out_specs: Sequence[TensorSpec],
                 run: Optional[Callable] = None, op=None) -> List[int]:
        """Append a node reading ``inputs`` and producing one tensor per
        entry of ``out_specs``; returns the new tensor ids."""
        for t in inputs:
            if not 0 <= t < len(self.tensor_specs):
                raise ValueError(f"unknown input tensor t{t}")
        nid = len(self.nodes)
        outs = [self._new_tensor(s) for s in out_specs]
        self.nodes.append(Node(nid, self.unique_name(name), module, kind,
                               list(inputs), outs, run, op))
        for i, tid in enumerate(outs):
            self.producer[tid] = (nid, i)
        return outs

    def add_op(self, op, inputs: Sequence[Tensor],
               name: Optional[str] = None) -> List[Tensor]:
        """Append a node holding ``op`` (an ``nn.Module`` with the op IR)
        and reading ``inputs``, named ``unique_name(name or
        op.type_name)``; returns its output tensors, whose specs come
        from ``op.infer_shapes`` (reference ``add_node`` :119-137).  The
        node's ``module`` is its name, dots included (``"layer1.0.conv1"``,
        as the reference names it)."""
        for t in inputs:
            if t.graph is not self:
                raise ValueError("input tensor from a different graph")
        name = self.unique_name(name or op.type_name)
        out_specs = op.infer_shapes([t.spec for t in inputs])
        nid = len(self.nodes)
        outs = [self._new_tensor(s) for s in out_specs]
        self.nodes.append(Node(nid, name, name, op.type_name,
                               [t.tid for t in inputs], outs, None, op))
        for i, tid in enumerate(outs):
            self.producer[tid] = (nid, i)
        return [Tensor(self, t) for t in outs]

    def topo_order(self) -> List[Node]:
        return self.nodes

    def consumers(self, tid: int) -> List[Tuple[Node, int]]:
        return [(node, slot) for node in self.nodes
                for slot, t in enumerate(node.inputs) if t == tid]

    def spec(self, tid: int) -> TensorSpec:
        return self.tensor_specs[tid]

    def param_specs(self) -> Dict[str, Dict[str, ParamSpec]]:
        """``{node name: {param name: ParamSpec}}`` of every node holding
        a weighted op (reference :155-163)."""
        out: Dict[str, Dict[str, ParamSpec]] = {}
        for node in self.nodes:
            ps = node.op.params() if node.op is not None else []
            if ps:
                out[node.name] = {p.name: p for p in ps}
        return out

    def __str__(self) -> str:
        lines = [f"  input t{t}: {self.tensor_specs[t]}"
                 for t in self.input_tids]
        for node in self.nodes:
            outs = ", ".join(f"t{t}:{self.tensor_specs[t]}"
                             for t in node.outputs)
            ins = ", ".join(f"t{t}" for t in node.inputs)
            lines.append(f"  {node.name}: ({ins}) -> {outs}")
        return "Graph(\n" + "\n".join(lines) + "\n)"


def live_cuts(graph: Graph, final_tids: Sequence[int]) -> List[frozenset]:
    """Per-boundary live tensor sets (reference :177-209).

    ``live_cuts(g, finals)[i]`` is the set of tensor ids produced at or
    before node ``i`` (graph inputs included) that are still needed
    strictly after it: consumed by a later node, or listed in
    ``final_tids``.  A boundary whose live set is small is a cheap
    pipeline cut: only those tensors cross between stages.  Serve graphs
    with fused residual norms carry ``{residual, hidden}`` between decoder
    layers, so their natural cuts are two tensors wide.
    """
    nodes = graph.nodes
    keep = set(final_tids)
    last_use: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        for t in node.inputs:
            last_use[t] = i
    live = {t for t in graph.input_tids if last_use.get(t) is not None}
    out: List[frozenset] = []
    for i, node in enumerate(nodes):
        for t in node.inputs:
            if last_use.get(t) == i and t not in keep:
                live.discard(t)
        for t in node.outputs:
            if last_use.get(t, -1) > i or t in keep:
                live.add(t)
        out.append(frozenset(live))
    return out
