"""The deployment's cost arithmetic: per-token flops, streamed weight
bytes, KV bytes, and the predicted memory parts.

The JAX package derives these from its compiled graph: the profiler's
``PlanCostCard`` (``flexflow_tpu/obs/profiler.py:141-203``) sums
``search/simulator.py``'s ``_step_flops`` and ``_step_param_bytes`` over
the plan's steps, classified by ``serve_component_of``, and its
``publish_memory`` reads ``plan_memory_parts(plan, training=False)``
(``simulator.py:228``).  Here the same numbers are computed, once, from
the serve model's (shard's) modules and the deployment's capacities
(the port's PCG plans, ``core/pcg.py``, price the search's candidates
through ``search/simulator.py`` instead); they equal the reference's field by field
for every family, fp and int8 weights, int8 KV and the spec buffers
(``tests/test_torch_profiler.py``).  Each function prices one model
(a pipeline stage's shard-0 model, or a whole model on one device) at
a deployment's :class:`Capacities`: the manager's own
(:func:`capacities_of`, which the profiler's wrappers :func:`plan_cost`
and :func:`plan_memory_parts` pass), or those recorded on a model's
modules by ``register_serve_capacities`` and ``mark_gated_lm_head``
(:func:`recorded_capacities`, which the planner reads before any
manager exists, ``serve/pp.py:build_stage_plans``).

The reference's arithmetic, op by op, at the compiled batch of
``T = max_tokens`` rows on one device, each op priced in its family
(``attention``, the marked LM head ``lm_head``, everything else
``mlp``: reference ``search/simulator.py:serve_component_of``):

* attention (``serve/ops.py:986``): ``2 T E (QH + 2 KV) D + 2 T QH D E``
  for the projections plus ``4 T QH D S`` with ``S = max_seq_len``;
* a Linear: ``2 T in out``; the LM head, when it was marked for gating
  at construction, ``2 min(T, R) in out`` (``ops/linear.py:174-189``) and
  priced per logit row; an unmarked LM head is an MLP linear;
* the token embedding: ``T`` times its width (its output's size); the
  position embedding, norms and elementwise ops add no flops;
* weight bytes: every parameter at the config dtype's width, whatever
  dtype it is stored in (``_step_param_bytes`` reads the parameter
  specs); the memory parts count an int8 ``kernel``/``qkv``/``o_proj``
  (quantized, or marked by ``annotate_int8``) as one byte an element
  plus a float32 scale per row of its first axis;
* KV state: each attention layer's ``k``/``v`` caches ``[R+1, KV, S, D]``
  in the KV dtype, their float32 scales ``[R+1, KV, S]`` when int8, the
  spec buffers ``[R+1, KV, P, D]`` in the config dtype, and ALiBi's
  int32 ``spec_pos [R+1, P]``;
* transient (inference): the largest single op output, ``T`` times the
  widest output (usually the vocabulary) at the config dtype's width.

Under tensor parallelism every number is one device's, as the
reference's ``_step_flops``, ``_step_param_bytes`` and ``_local_size``
price a sharded plan: ``im.model`` is shard 0's model, whose modules have
their local shapes (a row-sharded or head-sharded output is a partial
sum at the whole width); the one global term is an int8 weight's scale
count, which the reference takes from the global weight (errs high,
``simulator.py:263-266``).  The KV price per token is the allocator's,
over the global heads, as the reference's global arrays give it.

Pipeline parallelism (``serve/pp.py``): the reference prices each stage's
plan (``stage_plans``); here each stage's shard-0 model.  The cost card
sums the stages, the memory parts are one stage's, composed per device
by :func:`compose_stage_parts`.  The KV stream the planner charges a
macro step is :func:`kv_state_bytes` over ``KV_BUFFER_NAMES`` (the
committed caches and their scales, not the spec buffers; reference
``search/serve_search.py:_stage_kv_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..core.op import dtype_name
from ..ops.embedding import Embedding, PositionEmbedding
from ..ops.linear import Linear
from ..utils.platform import torch_dtype
from .ops import IncMultiHeadSelfAttention

# the weight matrices int8 quantization replaces (serve/quant.py)
INT8_PARAM_NAMES = ("kernel", "qkv", "o_proj")
FAMILIES = ("attention", "mlp", "lm_head")


@dataclasses.dataclass(frozen=True)
class Capacities:
    """What a deployment prices at: the flat token batch, the request
    rows and positions of its caches, its spec positions, its KV dtype
    (None: the model's), and the rows its LM head is priced at when it
    is marked for gating (None: unmarked, an MLP linear)."""

    max_tokens: int
    max_requests: int
    max_seq_len: int
    max_spec_tokens: int = 0
    kv_dtype: Optional[str] = None
    logit_rows: Optional[int] = None


def capacities_of(im) -> Capacities:
    """A manager's own capacities and LM-head mark."""
    return Capacities(im.max_tokens, im.max_requests, im.max_seq_len,
                      im.max_spec_tokens, im.kv_dtype,
                      im.max_requests if getattr(im, "lm_head_marked", False)
                      else None)


def recorded_capacities(model) -> Optional[Capacities]:
    """The capacities ``register_serve_capacities`` recorded on the
    attention modules of ``model`` and the rows ``mark_gated_lm_head``
    recorded on its LM head; None when nothing was registered."""
    attn = next((m for m in model.modules()
                 if isinstance(m, IncMultiHeadSelfAttention)), None)
    if attn is None or getattr(attn, "cost_max_requests", None) is None:
        return None
    head = lm_head_of(model)
    return Capacities(int(getattr(attn, "cost_max_tokens", 0) or 0),
                      attn.cost_max_requests, attn.cost_seq_len,
                      attn.cost_max_spec or 0, attn.kv_dtype,
                      getattr(head, "cost_logit_rows", None))


def lm_head_of(model) -> Optional[torch.nn.Module]:
    """The module that produces the logits, the node producing the serve
    graph's output in a model that gates it (None in a pipeline stage
    that does not hold it)."""
    span = getattr(model, "span", None)
    if (span is None or not span.last
            or not getattr(model, "gates_lm_head", False)):
        return None
    graph = model.graph
    path = graph.nodes[graph.producer[span.exit_tids[0]][0]].module
    return None if path is None else model.get_submodule(path)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _model_dtype(model) -> str:
    """The compute dtype: a family's config's, a builder model's first
    op's."""
    cfg = getattr(model, "config", None)
    if cfg is not None:
        return cfg.dtype
    op = next((m for m in model.modules() if hasattr(m, "compute_dtype")),
              None)
    return "float32" if op is None else dtype_name(op.compute_dtype)


def family_of(mod, marked_head=None) -> str:
    """The cost family of one module (reference
    ``search/simulator.py:serve_component_of``): ``attention`` (an
    attention layer), ``lm_head`` (``marked_head``: the LM head when it is
    marked for gating), else ``mlp`` (MLP linears, embeddings, norms'
    weights)."""
    if isinstance(mod, IncMultiHeadSelfAttention):
        return "attention"
    if mod is marked_head:
        return "lm_head"
    return "mlp"


def _marked_head(model, caps: Capacities):
    """The LM head ``model`` holds when ``caps`` prices it per logit row
    (None otherwise)."""
    return lm_head_of(model) if caps.logit_rows is not None else None


def heavy_flops(model, caps: Capacities) -> Dict[str, float]:
    """The flops of one step of ``model`` at ``caps.max_tokens`` rows by
    family (``attention``, ``mlp``, ``lm_head``), and the LM head's
    logit rows (0 when unmarked or not held)."""
    t, s = caps.max_tokens, caps.max_seq_len
    head = _marked_head(model, caps)
    fl = {f: 0.0 for f in FAMILIES}
    lm_rows = 0
    for mod in model.modules():
        if isinstance(mod, IncMultiHeadSelfAttention):
            e, qh, kv, d = (mod.embed_dim, mod.num_q_heads,
                            mod.num_kv_heads, mod.head_dim)
            proj = 2 * t * e * (qh + 2 * kv) * d + 2 * t * qh * d * e
            fl["attention"] += proj + 2 * t * qh * d * s * 2
        elif isinstance(mod, Linear):
            k_in, k_out = mod.kernel.shape
            if mod is head:
                r = caps.logit_rows
                fl["lm_head"] += 2 * min(t, r) * k_in * k_out
                lm_rows = min(t or 1, r) or 1
            else:
                fl["mlp"] += 2 * t * k_in * k_out
        elif (isinstance(mod, Embedding)
              and not isinstance(mod, PositionEmbedding)):
            fl["mlp"] += t * mod.weight.shape[1]
    return {**fl, "lm_rows": lm_rows}


def family_weight_bytes(model, caps: Capacities) -> Dict[str, float]:
    """The weight bytes one pass of ``model`` streams, by family: every
    parameter at the config dtype's width (an int8 weight's scale is not
    a parameter of the reference's graph)."""
    size = _itemsize(_model_dtype(model))
    head = _marked_head(model, caps)
    out = {f: 0.0 for f in FAMILIES}
    seen = set()
    for mod in model.modules():
        fam = family_of(mod, head)
        for name, p in mod.named_parameters(recurse=False):
            if name.endswith("_scale") or id(p) in seen:
                continue
            seen.add(id(p))
            out[fam] += p.numel() * size
    return out


def kv_state_bytes(model, caps: Capacities,
                   names: Optional[Sequence[str]] = None) -> float:
    """The registered serve-state buffers of every attention layer of
    ``model`` (``k``, ``v`` and, int8, ``k_scale``, ``v_scale``; the spec
    buffers ``sk``, ``sv`` and ALiBi's ``spec_pos``), or only those in
    ``names`` (``KV_BUFFER_NAMES``: the committed caches a macro step
    reads)."""
    r1, s, p = caps.max_requests + 1, caps.max_seq_len, caps.max_spec_tokens
    dt = _model_dtype(model)
    int8 = caps.kv_dtype == "int8"
    kv_size = 1 if int8 else _itemsize(dt)

    def want(name):
        return names is None or name in names

    total = 0.0
    for mod in model.modules():
        if not isinstance(mod, IncMultiHeadSelfAttention):
            continue
        kv, d = mod.num_kv_heads, mod.head_dim
        total += (want("k") + want("v")) * (r1 * kv * s * d * kv_size)
        if int8:
            total += (want("k_scale") + want("v_scale")) * (r1 * kv * s * 4)
        if p:
            total += (want("sk") + want("sv")) * (r1 * kv * p * d
                                                  * _itemsize(dt))
            if mod.use_alibi and want("spec_pos"):
                total += r1 * p * 4
    return total


def memory_parts(model, caps: Capacities) -> Dict[str, float]:
    """The predicted HBM of the one device that holds ``model``, in
    bytes, by component (reference ``simulator.py:plan_memory_parts(plan,
    training=False)``): ``weights`` (int8 weights, quantized or marked by
    ``annotate_int8``, at one byte plus their scales), ``kv_state``,
    ``transient`` (the largest single op output) and their ``total``."""
    size = _itemsize(_model_dtype(model))
    plan = getattr(model, "tp_plan", None)   # None: one device, whole
    degree = plan.degree if plan is not None else 1
    params = 0.0
    seen = set()
    for path, mod in model.named_modules():
        q8 = getattr(mod, "quantization", None) == "int8"
        for pname, p in mod.named_parameters(recurse=False):
            if pname.endswith("_scale") or id(p) in seen:
                continue
            seen.add(id(p))
            n = p.numel()
            if ((q8 or p.dtype == torch.int8) and pname in INT8_PARAM_NAMES
                    and p.dim() >= 2):
                # the global weight's scale count: split output dims
                # times the degree
                name = f"{path}.{pname}" if path else pname
                split = degree > 1 and plan.dim(name) not in (None, 0)
                params += n + (n // p.shape[0]) * 4 * (degree if split
                                                       else 1)
            else:
                params += n * size
    widths = [0]
    for mod in model.modules():
        if isinstance(mod, IncMultiHeadSelfAttention):
            widths.append(mod.embed_dim)
        elif isinstance(mod, Linear):
            widths.append(mod.kernel.shape[1])
        elif isinstance(mod, (Embedding, PositionEmbedding)):
            widths.append(mod.weight.shape[1])
    act = caps.max_tokens * max(widths) * size
    state = kv_state_bytes(model, caps)
    return {"weights": params, "kv_state": state, "transient": act,
            "total": params + act + state}


def compose_stage_parts(parts) -> Dict[str, float]:
    """Per-device composition of per-stage memory parts (reference
    ``simulator.py:290``): each component's maximum across stages, and
    ``static`` = weights + kv_state.  A one-device deployment passes one
    stage."""
    return {
        **{c: max(p[c] for p in parts)
           for c in ("weights", "kv_state", "transient", "total")},
        "static": max(p["weights"] + p["kv_state"] for p in parts),
    }


# ---- a manager's wrappers (the profiler's cost card, publish_memory) ----
def _stage_models(im):
    """Shard 0's model of each pipeline stage (one on a plain manager):
    the modules one device of each stage holds."""
    return [shards[0] for shards in im.shard_groups]


def plan_cost(im) -> Dict[str, float]:
    """The fields of the profiler's ``PlanCostCard`` for one deployment
    (reference ``obs/profiler.py:141``): per-token attention and MLP
    flops, flops per logit row, streamed weight bytes (summed over the
    stages), and the KV bytes a token costs (the allocator's price once
    the caches exist, else the state buffers over ``max_requests x
    max_seq_len``)."""
    caps = capacities_of(im)
    rows = int(im.max_tokens) or 1
    fl = {f: 0.0 for f in FAMILIES}
    lm_rows = 0
    w_bytes = 0.0
    kv = 0.0
    for model in _stage_models(im):
        f = heavy_flops(model, caps)
        for fam in FAMILIES:
            fl[fam] += f[fam]
        lm_rows = f["lm_rows"] or lm_rows
        w_bytes += sum(family_weight_bytes(model, caps).values())
        kv += kv_state_bytes(model, caps)
    kv_bpt = 0.0
    if im.kv.state:
        kv_bpt = im.kv.bytes_per_token() or 0.0
    if not kv_bpt:
        kv_bpt = kv / ((im.max_requests * im.max_seq_len) or 1)
    return {
        "attn_flops_per_token": fl["attention"] / rows,
        "mlp_flops_per_token": fl["mlp"] / rows,
        "lm_head_flops_per_row": (fl["lm_head"] / lm_rows
                                  if lm_rows else 0.0),
        "weight_bytes": w_bytes,
        "kv_bytes_per_token": kv_bpt,
    }


def plan_memory_parts(im, model=None) -> Dict[str, float]:
    """:func:`memory_parts` of one device of a manager's deployment at
    its own capacities; ``model``: a pipeline stage's shard model (its
    stage plan's parts; None: ``im.model``)."""
    return memory_parts(im.model if model is None else model,
                        capacities_of(im))
