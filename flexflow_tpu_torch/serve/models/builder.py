"""A serve model over a builder graph: ``InferenceManager(ff, ...)``.

The reference serves graphs recorded by its ``FFModel`` builder: each
family (``flexflow_tpu/serve/models/*.py``) is a list of builder calls,
and its ``InferenceManager`` takes "an FFModel whose graph was built by a
serve builder" (``flexflow_tpu/serve/inference_manager.py:252-290``).
:class:`BuilderModel` presents such an ``FFModel`` to the port's managers
as a family's model presents itself (``base.py:GatedLMHead``): the same
``graph``, ``span``, executor and KV-cache naming, run by the same plan
executor (``parallel/tp.py``) under any strategy dict keyed by the
reference's node names.

Each node's op module (``ff.layers[name]``, made on ``meta`` by the
builder) is registered in the model at the path that IS the node's name,
dots included (``"model.layers.0.self_attn"``): so the module lookups of
the managers (``get_submodule``, ``GatedLMHead.modules_of``) find a node's
module by its name, the state-dict names are the reference's
``<node>.<param>`` (a reference ``{node: {param: array}}`` loads through
``convert.params_from_jax``, as a family's does), and an attention
layer's caches are keyed by its node's name.  The ``FFModel``'s own
escaped ``NodeModules`` is not walked.  A node name that is a prefix path
of another (``"a"`` and ``"a.b"``), or whose first part names an
attribute of the model (``"graph"``), cannot be a module path and raises.

The nodes run as a family's do: the three attention types through
``_attention`` (the step's batch config, the layer's caches, the page
table), the learned positions through ``_position``, the Linear that
produces the single output through ``_lm_head`` (the LM head the
reference marks for gating, :167-181); every other node runs its op as
training does (an op that takes a context gets ``training=False``).  The
output leaves in float32, as the reference casts its logits.  The graph's
token axis (its one input's length, the builder's ``max_tokens``) is left
open, as a family's graph leaves it, so a manager serves it at its own
``max_tokens_per_batch``.

:func:`record_family` replays a family's ``build_graph`` (the port's
record of the reference builder's calls) onto an ``FFModel``, reading each
call's arguments from the family's modules: ``build_model(ff, config,
max_tokens)``, the reference's form, calls it.  Its ``attention`` picks
the builder method each layer's attention is recorded with (the
speculative draft's ``spec_inc_...`` or the verifier's ``tree_inc_...``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ...core.graph import TOKENS, Graph, TensorSpec
from ...core.op import OpContext
from ...ops.embedding import PositionEmbedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm, RMSNorm
from ..ops import IncMultiHeadSelfAttention
from .base import (GatedLMHead, StageSpan, _attention, _call, _lm_head,
                   _position, name_attention_layers)

INC = "inc_multihead_self_attention"


def _in_context(op, ctx, *xs):
    """A node whose op takes a context: an inference step's."""
    return op(*xs, ctx=OpContext(training=False, rank=ctx.rank))


def _open_tokens(spec: TensorSpec, rows: int) -> TensorSpec:
    """``spec`` with a leading axis of the builder's ``rows`` tokens left
    open (``TOKENS``)."""
    if spec.shape and spec.shape[0] == rows:
        return TensorSpec((TOKENS,) + tuple(spec.shape[1:]), spec.dtype)
    return spec


def _place(root: nn.Module, path: str, op: nn.Module) -> None:
    """Register ``op`` at module path ``path`` of ``root``, making empty
    parents on the way."""
    *parents, leaf = path.split(".")
    mod = root
    for i, key in enumerate(parents + [leaf]):
        held = mod._modules.get(key) if key else None
        last = i == len(parents)
        if held is not None and (last or held.__class__ is not nn.Module):
            raise ValueError(
                f"node {path!r} cannot be served: another node's module "
                f"holds the path {'.'.join((parents + [leaf])[:i + 1])!r}")
        if held is None:
            child = op if last else nn.Module()
            try:
                mod.add_module(key, child)
            except (KeyError, TypeError) as e:
                raise ValueError(f"node {path!r} cannot be served: its "
                                 f"name is no module path ({e})") from None
            held = child
        mod = held


class BuilderModel(GatedLMHead, nn.Module):
    """The serve model of an ``FFModel``'s builder graph (module doc).
    ``outputs``: the logits Tensor(s), by default the last node's last
    output (reference :270-272); with several, the managers read the
    first, and no LM head is gated (reference ``mark_gated_lm_head``)."""

    def __init__(self, ff, outputs=None):
        super().__init__()
        g = ff.graph
        if len(g.input_tids) != 1:
            raise ValueError(f"a serve graph reads one input, the token ids "
                             f"(this graph has {len(g.input_tids)})")
        if outputs is None:
            out_tids = [g.nodes[-1].outputs[-1]]
        else:
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            out_tids = [t.tid for t in outs]
        head = None
        if len(out_tids) == 1:
            nid = g.producer[out_tids[0]][0]
            if isinstance(g.nodes[nid].op, Linear):
                head = nid
        rows = g.tensor_specs[g.input_tids[0]].shape[0]
        self.graph = graph = Graph()
        self.span = None
        self.gates_lm_head = head is not None
        graph.tensor_specs = [_open_tokens(s, rows) for s in g.tensor_specs]
        graph.input_tids = list(g.input_tids)
        graph.producer = dict(g.producer)
        graph._name_counts = dict(g._name_counts)
        for node in g.nodes:
            _place(self, node.name, node.op)
            kind, run = self._runner(node.op, node.nid == head)
            graph.nodes.append(dataclasses.replace(
                node, module=node.name, kind=kind, run=run, op=None))
        name_attention_layers(self)
        self.set_span(StageSpan(graph.nodes, graph.input_tids, out_tids,
                                True))

    @staticmethod
    def _runner(op, is_head: bool):
        """(the node's kind, how it runs)."""
        if isinstance(op, IncMultiHeadSelfAttention):
            return "attention", _attention
        if isinstance(op, PositionEmbedding):
            return "position_embedding", _position
        if is_head:
            return "lm_head", _lm_head
        return op.type_name, (_in_context if op.uses_context else _call)

    def set_executor(self, executor) -> None:
        """As the families', refusing a plan that splits a node whose op
        reads its config from a context (the serve step gives none)."""
        from ...parallel.tp import _live_config

        plan = getattr(self, "tp_plan", None)
        for st in [] if plan is None else plan.plan.steps:
            if (not st.is_parallel and _live_config(st.config, plan.mesh)
                    and self.get_submodule(st.node.module).uses_context):
                raise NotImplementedError(
                    f"node {st.name!r}: a {st.node.op.type_name} node under "
                    f"config {st.config} is not served split")
        super().set_executor(executor)

    def forward_gen(self, bc, state, pages=None,
                    xs: Optional[Sequence[torch.Tensor]] = None):
        out = yield from super().forward_gen(bc, state, pages, xs)
        return out.float() if self.span.last else out


def serve_model(model, outputs=None):
    """What a manager serves: a family's model (or shard models) as it
    is, an ``FFModel`` as its :class:`BuilderModel` over ``outputs``."""
    from ...model import FFModel

    if isinstance(model, FFModel):
        return BuilderModel(model, outputs)
    if outputs is not None:
        raise ValueError("outputs= names tensors of a builder graph: pass "
                         "the FFModel that holds them")
    return model


class FFCalls:
    """``base.py:GraphBuilder``'s calls made on an ``FFModel``: a
    family's ``build_graph`` replayed as the reference builder's calls,
    each call's arguments read from the family's module.  ``logits`` is
    the LM head's output."""

    def __init__(self, ff, max_tokens: int, attention: str = INC):
        self.ff = ff
        self.max_tokens = int(max_tokens)
        self.attention_method = attention
        self.logits = None

    def create_tensor(self):
        return self.ff.create_tensor((self.max_tokens,), torch.int32)

    def embedding(self, x, op, name):
        n, dim = op.weight.shape
        return self.ff.embedding(x, n, dim, name=name, dtype=op.compute_dtype)

    def position_embedding(self, x, op, name):
        return self.ff.position_embedding(x, op.num_positions, op.offset,
                                          name=name)

    def dense(self, x, op, name):
        return self.ff.dense(x, op.kernel.shape[1], activation=op.activation,
                             use_bias=op.bias is not None, name=name)

    def norm(self, x, op, name):
        if isinstance(op, RMSNorm):
            return self.ff.rms_norm(x, eps=op.eps, name=name)
        if isinstance(op, LayerNorm):
            return self.ff.layer_norm(
                x, elementwise_affine=op.elementwise_affine, eps=op.eps,
                use_bias=op.use_bias, name=name)
        raise TypeError(f"node {name!r}: no builder call for a "
                        f"{type(op).__name__}")

    def residual_rms_norm(self, x, residual, op, name):
        return self.ff.residual_rms_norm(x, residual, eps=op.eps, name=name)

    def sigmoid_silu_multi(self, a, b, op, name):
        return self.ff.sigmoid_silu_multi(a, b, name=name)

    def attention(self, x, op, name):
        kw = dict(num_kv_heads=op.num_kv_heads, head_dim=op.head_dim,
                  rotary_embedding=op.rotary_embedding,
                  rope_theta=op.rope_theta, use_bias=op.use_bias, name=name)
        if op.use_alibi:
            if self.attention_method != INC:
                raise ValueError(f"node {name!r}: {self.attention_method} "
                                 "takes no ALiBi (reference model.py:335)")
            kw["use_alibi"] = True
        return getattr(self.ff, self.attention_method)(
            x, op.embed_dim, op.num_q_heads, **kw)

    def add(self, a, b, name):
        return self.ff.add(a, b, name=name)

    def lm_head(self, x, op, name):
        self.logits = self.dense(x, op, name)
        return self.logits


def record_family(ff, config, max_tokens: int, attention: str = INC):
    """Record ``config``'s family on the ``FFModel`` ``ff`` as the
    reference's builder does (``build_model(ff, config, max_tokens)``),
    each attention layer through the builder method ``attention``; returns
    the logits Tensor."""
    from .base import build_model

    calls = FFCalls(ff, max_tokens, attention)
    build_model(config).build_graph(calls)
    return calls.logits
