"""Serve model configuration and the model registry.

``ServeModelConfig`` is a copy of ``flexflow_tpu/serve/models/base.py``'s
(HF ``config.json`` field names), kept here because the port imports
nothing of the JAX package.  ``build_model`` returns an ``nn.Module`` whose
parameters sit on the ``meta`` device: they take no memory until the
:class:`~flexflow_tpu_torch.serve.inference_manager.InferenceManager`
materialises them on its device, as the reference's builder only describes
a graph.  The module also holds that graph (``model.graph``,
``core/graph.py``), recorded by its family's ``build_graph`` from its
modules, node for node the reference builder's; its forward runs the
graph (:class:`GatedLMHead`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from ...core.graph import TOKENS, Graph, TensorSpec
from ...core.interpreter import StepContext, dead_after, run_nodes
from ...ops.elementwise import ElementBinary
from ...parallel.comm import run_local

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(model_type: str):
    def deco(fn):
        MODEL_REGISTRY[model_type] = fn
        return fn

    return deco


@dataclasses.dataclass
class ServeModelConfig:
    """Architecture hyperparameters (HF config.json field names)."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    bos_token_id: int = 1
    eos_token_id: int = 2
    tie_word_embeddings: bool = False
    do_layer_norm_before: bool = True
    word_embed_proj_dim: Optional[int] = None
    parallel_attn: bool = False
    bias: bool = False
    use_alibi: bool = False
    new_decoder_architecture: bool = False
    # compute and cache dtype of the whole model
    dtype: str = "float32"

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @staticmethod
    def from_hf_config(hf) -> "ServeModelConfig":
        """Build from an HF config object or a plain dict of its fields
        (``flexflow_tpu/serve/models/base.py:66-123``), mapping Falcon's
        ``ffn_hidden_size`` too (4 x hidden when absent, as HF defaults
        it), which the reference leaves at the Llama default."""
        def get(k, d=None):
            return hf.get(k, d) if isinstance(hf, dict) else getattr(hf, k, d)

        kw = {}
        for f in dataclasses.fields(ServeModelConfig):
            v = get(f.name, None)
            if v is not None:
                kw[f.name] = v
        renames = (   # (HF field, ours), later entries win
            ("layer_norm_epsilon", "layer_norm_eps"),    # falcon/gpt_bigcode
            ("n_embd", "hidden_size"),                   # gpt_bigcode
            ("d_model", "hidden_size"),                  # mpt
            ("n_head", "num_attention_heads"),
            ("n_heads", "num_attention_heads"),
            ("n_layer", "num_hidden_layers"),
            ("n_layers", "num_hidden_layers"),
            ("ffn_dim", "intermediate_size"),            # opt
            ("ffn_hidden_size", "intermediate_size"),    # falcon
            ("n_positions", "max_position_embeddings"),  # gpt_bigcode
        )
        for theirs, ours in renames:
            if get(theirs) is not None:
                kw[ours] = get(theirs)
        if get("n_inner"):                               # gpt_bigcode
            kw["intermediate_size"] = get("n_inner")
        if get("expansion_ratio") is not None:           # mpt
            kw["intermediate_size"] = (get("expansion_ratio")
                                       * kw["hidden_size"])
        if get("num_kv_heads") is not None and get("new_decoder_architecture",
                                                   False):
            # falcon's new-decoder GQA only; the old one ignores num_kv_heads
            kw["num_key_value_heads"] = get("num_kv_heads")
        if get("multi_query", False):                    # falcon-7b, starcoder
            kw["num_key_value_heads"] = 1
        if get("alibi", None) is not None:
            kw["use_alibi"] = get("alibi")
        attn_cfg = get("attn_config", None)              # mpt nests these
        if attn_cfg is not None:
            def aget(k):
                return (attn_cfg.get(k) if isinstance(attn_cfg, dict)
                        else getattr(attn_cfg, k, None))

            if aget("kv_n_heads") is not None:
                kw["num_key_value_heads"] = aget("kv_n_heads")
            if aget("alibi") is not None:
                kw["use_alibi"] = aget("alibi")
        hidden = kw.get("hidden_size", ServeModelConfig.hidden_size)
        if "intermediate_size" not in kw and get("model_type") in (
                "gpt_bigcode", "falcon"):
            kw["intermediate_size"] = 4 * hidden
        kw.pop("dtype", None)
        td = get("torch_dtype", None) or get("dtype", None)
        if td is not None:
            td = str(td).replace("torch.", "")
            kw["dtype"] = "bfloat16" if td in ("float16", "bfloat16") else td
        return ServeModelConfig(**kw)


def _call(op, ctx, *xs):
    return op(*xs)


def _position(op, ctx, x):
    return op(x, ctx.base.token_position)


def _attention(op, ctx, x):
    return op(x, ctx.bc, ctx.state[op.name], ctx.pages)


def _add(op, ctx, a, b):
    return a + b


def _lm_head(op, ctx, x):
    """Float32 logits of the final hidden states ``x`` [T, E]: a gated
    prefill chunk's ``logit_slots`` gather their rows first (a slot of -1
    clamps to row 0, whose logits are never read).  A head whose rows are
    split over ``row_shards`` shards (``sample``) gathers the token rows,
    then computes its own block of the slots' rows."""
    slots = getattr(ctx.bc, "logit_slots", None)
    if slots is not None:
        if op.row_shards > 1:
            x = yield ("all_gather", x, 0)
            slots = torch.tensor_split(slots, op.row_shards)[ctx.rank]
        x = x.index_select(0, slots.clamp(0, x.shape[0] - 1).long())
    return op(x).float()


class GraphBuilder:
    """Records a family's forward as the reference builder's serve graph
    (its ``FFModel`` calls, one node each, ``flexflow_tpu/model.py:82-330``):
    each method appends one node that calls the given module of the
    model, named by that module's path, and returns the new tensor ids."""

    def __init__(self, model: torch.nn.Module):
        self.graph = Graph()
        self._paths = {id(m): p for p, m in model.named_modules()}

    def _node(self, op, kind, inputs, name, run, width=None, n_out=1):
        if op is not None and self._paths.get(id(op)) != name:
            raise ValueError(f"node {name!r} calls the module at "
                             f"{self._paths.get(id(op))!r}")
        spec = self.graph.spec(inputs[0])
        if width is not None:
            spec = TensorSpec((TOKENS, int(width)), getattr(
                op, "compute_dtype", spec.dtype))
        outs = self.graph.add_node(None if op is None else name, kind,
                                   inputs, name, [spec] * n_out, run)
        return outs[0] if n_out == 1 else outs

    def create_tensor(self) -> int:
        """The token ids, the graph's one input."""
        return self.graph.add_input(TensorSpec((TOKENS,), torch.int32))

    def embedding(self, x, op, name):
        return self._node(op, "embedding", [x], name, _call,
                          width=op.weight.shape[1])

    def position_embedding(self, x, op, name):
        return self._node(op, "position_embedding", [x], name, _position)

    def dense(self, x, op, name):
        return self._node(op, "dense", [x], name, _call,
                          width=op.kernel.shape[1])

    def norm(self, x, op, name):
        return self._node(op, "norm", [x], name, _call)

    def residual_rms_norm(self, x, residual, op, name):
        """``(x + residual, rms_norm(x + residual))``: two outputs."""
        return self._node(op, "residual_rms_norm", [x, residual], name,
                          _call, n_out=2)

    def sigmoid_silu_multi(self, a, b, op, name):
        return self._node(op, "sigmoid_silu_multi", [a, b], name, _call)

    def attention(self, x, op, name):
        return self._node(op, "attention", [x], name, _attention,
                          width=op.embed_dim)

    def add(self, a, b, name):
        """A module-free node carrying its own op IR."""
        outs = self.graph.add_node(None, "add", [a, b], name,
                                   [self.graph.spec(a)], _add,
                                   ElementBinary("add"))
        return outs[0]

    def lm_head(self, x, op, name):
        return self._node(op, "lm_head", [x], name, _lm_head,
                          width=op.kernel.shape[1])


class StageSpan:
    """The node range a model runs: the whole graph, or one pipeline
    stage's contiguous nodes with the tensors that enter and leave it
    (``serve/pp.py:serve_stage_split``); ``last`` ends at the logits.
    ``drops`` holds the tensors each node leaves dead (fixed with the
    range)."""

    def __init__(self, nodes, entry_tids, exit_tids, last: bool):
        self.nodes = list(nodes)
        self.entry_tids = list(entry_tids)
        self.exit_tids = list(exit_tids)
        self.last = bool(last)
        self.drops = dead_after(self.nodes, self.exit_tids)


class GatedLMHead:
    """The forward shared by every family: the model's serve ``graph``
    (recorded by the family's ``build_graph`` from its modules, whose
    LM head is gated, reference ``ops/linear.py:98-108``, marked by
    ``mark_gated_lm_head``, inference_manager.py:167: a batch with
    ``logit_slots`` computes ``[max_requests, vocab]`` logits instead of
    ``[max_tokens, vocab]``), run step by step as its plan says.

    The model runs its ``span`` of the graph (the whole graph, or a
    pipeline stage's nodes in a stage's model, ``serve/pp.py``) through
    the plan executor its shard was given (``parallel/tp.py:
    shard_model``, :meth:`set_executor`); a model given none runs the
    plan of its span on one device under the empty strategy, made at its
    first step.  ``forward_gen(bc, state, pages)`` is a generator that
    yields at the plan's collectives (``parallel/comm.py``); ``forward``
    runs it alone with identity collectives, and a tensor-parallel
    manager runs one per shard in lockstep.  Nodes name their modules by
    path; the model looks them up in itself, so a submodule swapped in
    later is the one that runs."""

    gates_lm_head = True
    tp_rank = 0
    # the plan executor of this model's span (parallel/tp.py)
    _executor = None
    # (every (parent, key, child) on the executor's module paths, the
    # modules in step order): the lookup, kept while those entries stand;
    # the model's own entries have parent None, so that no cycle keeps a
    # dropped model's weights alive until the collector runs
    _bound = None

    def finish_graph(self) -> None:
        """Name the attention layers and record the family's graph; the
        last line of each family's ``__init__``."""
        name_attention_layers(self)
        ff = GraphBuilder(self)
        self.build_graph(ff)
        self.graph = g = ff.graph
        self.set_span(StageSpan(g.nodes, g.input_tids,
                                [g.nodes[-1].outputs[-1]], True))

    def set_span(self, span: StageSpan) -> None:
        self.span = span
        self._executor = None
        self._bound = None

    def set_executor(self, executor) -> None:
        """Run the span as ``executor`` (``parallel/tp.py:PlanExecutor``)
        says."""
        self._executor = executor
        self._bound = None

    def executor(self):
        """This model's plan executor: the one it was given, or the plan
        of its span on one device under ``{}``, made once."""
        if self._executor is None:
            from ...parallel.mesh import Mesh
            from ...parallel.tp import PlanExecutor, TPPlan

            dev = next((p.device for p in self.parameters()), "cpu")
            plan = TPPlan(self, Mesh({"tp": 1}, [dev]), {})
            self.set_executor(PlanExecutor(plan, 0))
        return self._executor

    def modules_of(self, nodes, edges=None) -> list:
        """The module each of ``nodes`` calls (None: module-free), looked
        up by path in this model; ``edges`` collects each (parent, key,
        child) on the paths (the model's own with parent None)."""
        out = []
        for node in nodes:
            mod = None if node.module is None else self
            for key in () if mod is None else node.module.split("."):
                child = mod._modules.get(key)
                if child is None:
                    raise ValueError(f"node {node.name!r}: the model holds "
                                     f"no module at {node.module!r}")
                if edges is not None:
                    edges[(id(mod), key)] = (None if mod is self else mod,
                                             key, child)
                mod = child
            out.append(mod)
        return out

    def span_ops(self) -> list:
        """The module each step of the executor calls (None: module-free
        or a parallel step); the lookup is kept while every module on
        those paths is still the one registered there."""
        bound = self._bound
        if bound is not None and all(
                (self if p is None else p)._modules.get(k) is c
                for p, k, c in bound[0]):
            return bound[1]
        edges = {}
        ops = self.modules_of(self.executor().nodes, edges)
        self._bound = (list(edges.values()), ops)
        return ops

    def forward(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                pages=None) -> torch.Tensor:
        """Float32 logits ``[T, vocab]`` of one step (``[max_requests,
        vocab]`` for a gated prefill chunk); ``state`` holds each
        attention layer's caches, which are updated in place; ``pages`` is
        the page table of a paged cache (None: slot-contiguous)."""
        return run_local(self.forward_gen(bc, state, pages))

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None, xs: Optional[Sequence[torch.Tensor]] = None):
        """One step over the model's span, as a generator of its
        collectives.  The first span reads the batch's tokens; a later
        stage's reads ``xs``, the tensors entering it (whole).  Returns
        the logits (the last span) or the list of tensors leaving the
        span (shard 0's; None on the other shards)."""
        span = self.span
        ex = self.executor()
        ctx = StepContext(bc, state, pages, self.tp_rank)
        env = ex.enter(span.entry_tids,
                       [ctx.base.tokens] if xs is None else xs)
        env = yield from run_nodes(ex.nodes, self.span_ops(), ex.drops,
                                   env, ctx)
        outs = yield from ex.leave(env)
        return outs[0] if span.last else outs


def name_attention_layers(model: torch.nn.Module) -> None:
    """Give each attention module its path in ``model``: the key of its
    caches in the allocator's state."""
    from ..ops import IncMultiHeadSelfAttention

    for name, mod in model.named_modules():
        if isinstance(mod, IncMultiHeadSelfAttention):
            mod.name = name


def build_model(config_or_ff, config: Optional[ServeModelConfig] = None,
                max_tokens: Optional[int] = None, **kwargs):
    """``build_model(config)``: the registered family's serve model,
    parameters on ``meta``.  ``build_model(ff, config, max_tokens)``, the
    reference's form: the family recorded on the ``FFModel`` ``ff`` as
    the reference's builder calls (``builder.py:record_family``, which
    takes ``attention`` too); returns the logits Tensor, and
    ``InferenceManager(ff, ...)`` serves the graph."""
    if config is not None:
        from .builder import record_family

        return record_family(config_or_ff, config, max_tokens, **kwargs)
    config = config_or_ff
    if config.model_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model_type {config.model_type!r}; "
            f"known: {sorted(MODEL_REGISTRY)}")
    with torch.device("meta"):
        return MODEL_REGISTRY[config.model_type](config)
