"""GraphXfer-style algebraic substitutions: Unity's rewrite half.

Port of ``flexflow_tpu/search/substitution.py`` (the reference's
``src/runtime/substitution.cc``): a :class:`GraphXfer` rule finds
:class:`Match` es (the ids of the nodes it consumes) in a builder graph
(``FFModel.graph``) and :func:`apply_match` rebuilds the graph with the
rule's replacement, returning a :class:`RewriteResult`: the new graph,
the tensor-id map (for the outputs a caller holds), the node-name map
(the joint search migrates configs through it) and the parameter map
(:func:`remap_params` carries weights across it).  ``search/search.py:
graph_optimize(substitution=True)`` proposes one match a move inside its
Metropolis walk, so rewrites and placements are searched jointly.

The four rules of :func:`standard_rules` fuse a linear and its
activation, an add and the norm after it (``ops/norm.py``'s
``ResidualLayerNorm`` / ``ResidualRMSNorm``, which also emit the sum),
``silu(gate) * up`` (``SigmoidSiluMulti``), and remove identities.  A
rule's replacement op is built as the builder builds one: a fresh module
on ``meta`` whose parameters ``core/interpreter.py:init_params`` (or
:func:`remap_params`) fills, keyed by its node's name; an untouched node
keeps its module.  :func:`check_equivalence` runs a rewrite through
``build_forward`` on the mesh it is given, from the same weights and
seeded numpy inputs, and raises where the outputs differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Graph, Node, Tensor

# ---------------------------------------------------------------------------
# match and rewrite machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Match:
    rule: "GraphXfer"
    nids: Tuple[int, ...]   # the consumed source-node ids, in graph order

    def __repr__(self):
        return f"Match({self.rule.name}, nodes={list(self.nids)})"


@dataclasses.dataclass
class RewriteResult:
    graph: Graph
    tid_map: Dict[int, int]      # old tid -> new tid (surviving tensors)
    name_map: Dict[str, str]     # old node name -> new node name
    # {new node name: {new param name: (old node name, old param name)}}
    param_map: Dict[str, Dict[str, Tuple[str, str]]]


class GraphXfer:
    """One rewrite rule: find its matches, build the replacement."""

    name = "?"

    def find(self, graph: Graph, protected=frozenset()) -> List[Match]:
        raise NotImplementedError

    def build(self, new_graph: Graph, old: Graph, match: Match,
              tid_map: Dict[int, int]) -> RewriteResult:
        """Append the replacement node(s) to ``new_graph`` and map every
        output tid of the consumed nodes that other nodes may read in
        ``tid_map``; returns the name and parameter maps."""
        raise NotImplementedError

    @staticmethod
    def _sole_consumer(graph: Graph, tid: int, expect_nid: int) -> bool:
        cons = graph.consumers(tid)
        return len(cons) == 1 and cons[0][0].nid == expect_nid

    @staticmethod
    def _consumers_after(graph: Graph, tid: int, nid: int,
                         allowed=()) -> bool:
        """Every consumer of ``tid`` sits after node ``nid`` (or in
        ``allowed``), so a replacement at ``nid`` comes before them."""
        return all(n.nid > nid or n.nid in allowed
                   for n, _ in graph.consumers(tid))


def find_all_matches(graph: Graph, rules: Sequence[GraphXfer],
                     protected=frozenset()) -> List[Match]:
    """Every rule's matches, rule by rule.  Overlapping matches stay: the
    walk applies one a move, so they are alternatives."""
    out: List[Match] = []
    for rule in rules:
        out.extend(rule.find(graph, protected))
    return out


def apply_match(graph: Graph, match: Match) -> RewriteResult:
    """Rebuild ``graph`` with ``match`` replaced by its rule's
    substitute, at the place of the last consumed node (a rule's
    ``find`` makes sure no consumer of a replaced tensor comes before
    it)."""
    consumed = set(match.nids)
    last_nid = max(match.nids)
    g2 = Graph()
    tid_map: Dict[int, int] = {}
    for tid in graph.input_tids:
        tid_map[tid] = g2.add_input(graph.spec(tid))

    result: Optional[RewriteResult] = None
    for node in graph.nodes:
        if node.nid in consumed:
            if node.nid == last_nid:
                result = match.rule.build(g2, graph, match, tid_map)
            continue
        ins = [Tensor(g2, tid_map[t]) for t in node.inputs]
        outs = g2.add_op(node.op, ins, name=node.name)
        for old_tid, new_t in zip(node.outputs, outs):
            tid_map[old_tid] = new_t.tid
    assert result is not None
    result.graph = g2
    result.tid_map = tid_map
    return result


def remap_params(params: Dict[str, Dict], res: RewriteResult,
                 new_graph: Graph) -> Dict[str, Dict]:
    """Carry weights ``{node: {param: value}}`` across a rewrite: an
    untouched node keeps its own, a replacement takes what ``param_map``
    names."""
    out: Dict[str, Dict] = {}
    for node in new_graph.nodes:
        if not node.op.params():
            continue
        pm = res.param_map.get(node.name)
        if pm is None:
            if node.name in params:
                out[node.name] = params[node.name]
        else:
            out[node.name] = {new_p: params[old_n][old_p]
                              for new_p, (old_n, old_p) in pm.items()}
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


class FuseLinearActivation(GraphXfer):
    """linear (no activation) -> element_unary(act)  =>
    linear(activation=act) (reference :158)."""

    name = "fuse_linear_activation"
    FUSABLE = ("relu", "gelu", "gelu_exact", "sigmoid", "tanh", "silu", "elu")

    def find(self, graph, protected=frozenset()):
        out = []
        for b in graph.nodes:
            if b.op.type_name != "element_unary" or b.op.fn not in self.FUSABLE:
                continue
            prod = graph.producer.get(b.inputs[0])
            if prod is None:
                continue
            a = graph.nodes[prod[0]]
            if (a.op.type_name == "linear" and a.op.activation is None
                    and a.outputs[0] not in protected
                    and self._sole_consumer(graph, a.outputs[0], b.nid)):
                out.append(Match(self, (a.nid, b.nid)))
        return out

    def build(self, g2, old, match, tid_map):
        from ..ops.linear import Linear

        a, b = (old.nodes[i] for i in match.nids)
        op = Linear(a.op.in_dim, a.op.out_dim, a.op.compute_dtype,
                    device="meta", use_bias=a.op.use_bias,
                    activation=b.op.fn,
                    kernel_initializer=a.op.kernel_initializer,
                    bias_initializer=a.op.bias_initializer)
        (out,) = g2.add_op(op, [Tensor(g2, tid_map[a.inputs[0]])],
                           name=a.name)
        tid_map[b.outputs[0]] = out.tid
        pm = {"kernel": (a.name, "kernel")}
        if a.op.use_bias:
            pm["bias"] = (a.name, "bias")
        return RewriteResult(g2, tid_map, {a.name: a.name, b.name: a.name},
                             {a.name: pm})


class FuseAddNorm(GraphXfer):
    """add(x, r) -> layer_norm / rms_norm  =>  ResidualLayerNorm /
    ResidualRMSNorm (reference :204).  The fused op also emits the sum,
    so the add's other consumers read that output."""

    name = "fuse_add_norm"

    def find(self, graph, protected=frozenset()):
        out = []
        for b in graph.nodes:
            if b.op.type_name not in ("layer_norm", "rms_norm"):
                continue
            prod = graph.producer.get(b.inputs[0])
            if prod is None:
                continue
            a = graph.nodes[prod[0]]
            if a.op.type_name != "element_binary" or a.op.fn != "add":
                continue
            if old_specs_differ(graph, a):   # no broadcast in the fused op
                continue
            # the sum's other consumers read the fused op's first output,
            # so none may sit between the add and the norm
            if not self._consumers_after(graph, a.outputs[0], b.nid,
                                         allowed={b.nid}):
                continue
            out.append(Match(self, (a.nid, b.nid)))
        return out

    def build(self, g2, old, match, tid_map):
        from ..ops.norm import ResidualLayerNorm, ResidualRMSNorm

        a, b = (old.nodes[i] for i in match.nids)
        if b.op.type_name == "layer_norm":
            op = ResidualLayerNorm(
                b.op.dim, elementwise_affine=b.op.elementwise_affine,
                eps=b.op.eps, use_bias=b.op.use_bias,
                dtype=b.op.compute_dtype, device="meta")
            pm = {}
            if b.op.elementwise_affine:
                pm["gamma"] = (b.name, "gamma")
                if b.op.use_bias:
                    pm["beta"] = (b.name, "beta")
        else:
            op = ResidualRMSNorm(b.op.dim, eps=b.op.eps,
                                 dtype=b.op.compute_dtype, device="meta")
            pm = {"gamma": (b.name, "gamma")}
        ins = [Tensor(g2, tid_map[t]) for t in a.inputs]
        sum_out, normed = g2.add_op(op, ins, name=b.name)
        tid_map[a.outputs[0]] = sum_out.tid
        tid_map[b.outputs[0]] = normed.tid
        return RewriteResult(g2, tid_map, {a.name: b.name, b.name: b.name},
                             {b.name: pm} if pm else {})


class FuseSiluMul(GraphXfer):
    """silu(gate) * up  =>  SigmoidSiluMulti(gate, up), the SwiGLU
    junction (reference :262)."""

    name = "fuse_silu_mul"

    def find(self, graph, protected=frozenset()):
        out = []
        for b in graph.nodes:
            if b.op.type_name != "element_binary" or b.op.fn != "mul":
                continue
            for slot in (0, 1):
                prod = graph.producer.get(b.inputs[slot])
                if prod is None:
                    continue
                a = graph.nodes[prod[0]]
                if (a.op.type_name == "element_unary" and a.op.fn == "silu"
                        and a.outputs[0] not in protected
                        and self._sole_consumer(graph, a.outputs[0], b.nid)):
                    out.append(Match(self, (a.nid, b.nid)))
                    break
        return out

    def build(self, g2, old, match, tid_map):
        from ..ops.norm import SigmoidSiluMulti

        a, b = (old.nodes[i] for i in match.nids)
        gate = a.inputs[0]
        up = b.inputs[1] if b.inputs[0] == a.outputs[0] else b.inputs[0]
        (out,) = g2.add_op(
            SigmoidSiluMulti(),
            [Tensor(g2, tid_map[gate]), Tensor(g2, tid_map[up])],
            name=b.name)
        tid_map[b.outputs[0]] = out.tid
        return RewriteResult(g2, tid_map, {a.name: b.name, b.name: b.name}, {})


class EliminateIdentity(GraphXfer):
    """element_unary(identity) / scalar_multiply(1.0)  =>  removed
    (reference :302)."""

    name = "eliminate_identity"

    def find(self, graph, protected=frozenset()):
        out = []
        for a in graph.nodes:
            if a.op.type_name != "element_unary":
                continue
            if not (a.op.fn == "identity"
                    or (a.op.fn == "scalar_multiply" and a.op.scalar == 1.0)):
                continue
            if a.outputs[0] in protected:
                continue
            out.append(Match(self, (a.nid,)))
        return out

    def build(self, g2, old, match, tid_map):
        a = old.nodes[match.nids[0]]
        tid_map[a.outputs[0]] = tid_map[a.inputs[0]]
        return RewriteResult(g2, tid_map, {}, {})


def old_specs_differ(graph: Graph, node: Node) -> bool:
    s0 = graph.spec(node.inputs[0])
    return any(graph.spec(t).shape != s0.shape for t in node.inputs[1:])


def standard_rules() -> List[GraphXfer]:
    return [FuseLinearActivation(), FuseAddNorm(), FuseSiluMul(),
            EliminateIdentity()]


# ---------------------------------------------------------------------------
# the equivalence check
# ---------------------------------------------------------------------------


def check_equivalence(old_graph: Graph, res: RewriteResult,
                      out_tids: Sequence[int], mesh, seed: int = 0,
                      atol: float = 1e-4, rtol: float = 1e-4) -> None:
    """Check a rewrite numerically (reference :345): the same weights
    (drawn from a ``torch.Generator`` seeded by ``seed``, carried by
    :func:`remap_params`) and the same inputs (numpy, seeded) give the
    same outputs through both graphs' forwards, each planned under
    ``{}`` on ``mesh``; raises where they differ."""
    from ..core.interpreter import build_forward, init_params, place_inputs
    from ..core.pcg import PCG

    plan_a = PCG(old_graph, mesh, {}, output_tids=list(out_tids)).plan()
    new_out = [res.tid_map[t] for t in out_tids]
    plan_b = PCG(res.graph, mesh, {}, output_tids=new_out).plan()

    rng = np.random.RandomState(seed)
    feed_a, feed_b = {}, {}
    for tid in old_graph.input_tids:
        spec = old_graph.spec(tid)
        if spec.dtype.is_floating_point:
            arr = rng.randn(*spec.shape)
        else:
            arr = rng.randint(0, 2, size=spec.shape)
        feed_a[tid] = torch.as_tensor(arr).to(spec.dtype)
        feed_b[res.tid_map[tid]] = feed_a[tid]

    # the untouched nodes' modules are shared by both graphs: run the old
    # graph before the new one's parameters replace theirs
    shards_a = init_params(old_graph, plan_a,
                           torch.Generator().manual_seed(seed))
    params_a = {n: {p: w.detach().clone() for p, w in g.items()}
                for n, g in shards_a[0].items()}
    with torch.no_grad():
        outs_a = build_forward(plan_a)(place_inputs(plan_a, feed_a))
    params_b = remap_params(params_a, res, res.graph)
    shards_b = init_params(res.graph, plan_b, torch.Generator())
    with torch.no_grad():
        for shard in shards_b:
            for n, g in shard.items():
                for p, w in g.items():
                    w.copy_(params_b[n][p])
        outs_b = build_forward(plan_b)(place_inputs(plan_b, feed_b))
    for oa, ob in zip(outs_a, outs_b):
        np.testing.assert_allclose(oa.float().cpu().numpy(),
                                   ob.float().cpu().numpy(),
                                   atol=atol, rtol=rtol)
