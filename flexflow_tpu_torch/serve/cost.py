"""The deployment's cost arithmetic: per-token flops, streamed weight
bytes, KV bytes, and the predicted memory parts.

The JAX package derives these from its compiled graph: the profiler's
``PlanCostCard`` (``flexflow_tpu/obs/profiler.py:141-203``) sums
``search/simulator.py``'s ``_step_flops`` and ``_step_param_bytes`` over
the plan's steps, classified by ``serve_component_of``, and its
``publish_memory`` reads ``plan_memory_parts(plan, training=False)``
(``simulator.py:228``).  This port has no graph IR, so the same numbers
are computed here, once, from the serve model's modules and the
InferenceManager's capacities; they equal the reference's field by field
for every family, fp and int8 weights, int8 KV and the spec buffers
(``tests/test_torch_profiler.py``).

The reference's arithmetic, op by op, at the compiled batch of
``T = max_tokens`` rows on one device:

* attention (``serve/ops.py:986``): ``2 T E (QH + 2 KV) D + 2 T QH D E``
  for the projections plus ``4 T QH D S`` with ``S = max_seq_len``;
* a Linear: ``2 T in out``; the LM head, when it was marked for gating
  at construction, ``2 min(T, R) in out`` (``ops/linear.py:174-189``) and
  priced per logit row; an unmarked LM head is an MLP linear;
* the token embedding: ``T`` times its width (its output's size); the
  position embedding, norms and elementwise ops add no flops;
* weight bytes: every parameter at the config dtype's width, whatever
  dtype it is stored in (``_step_param_bytes`` reads the parameter
  specs); the memory parts count an int8 ``kernel``/``qkv``/``o_proj`` as
  one byte an element plus a float32 scale per row of its first axis;
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
by :func:`compose_stage_parts`.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.embedding import Embedding, PositionEmbedding
from ..ops.linear import Linear
from ..utils.platform import torch_dtype
from .ops import IncMultiHeadSelfAttention

# the weight matrices int8 quantization replaces (serve/quant.py)
INT8_PARAM_NAMES = ("kernel", "qkv", "o_proj")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _model_dtype(im) -> str:
    cfg = getattr(im.model, "config", None)
    return getattr(cfg, "dtype", "float32")


def _stage_models(im):
    """Shard 0's model of each pipeline stage (one on a plain manager):
    the modules one device of each stage holds."""
    return [shards[0] for shards in im.shard_groups]


def _heavy_flops(im) -> Dict[str, float]:
    """The flops of one step at ``max_tokens`` rows, summed by family
    (``attention``, ``mlp``, ``lm_head``) over every stage, and the LM
    head's logit rows."""
    t, r, s = im.max_tokens, im.max_requests, im.max_seq_len
    marked = getattr(im, "lm_head_marked", False)
    fl = {"attention": 0.0, "mlp": 0.0, "lm_head": 0.0}
    lm_rows = 0
    for model in _stage_models(im):
        lm_head = getattr(model, "lm_head", None)
        for mod in model.modules():
            if isinstance(mod, IncMultiHeadSelfAttention):
                e, qh, kv, d = (mod.embed_dim, mod.num_q_heads,
                                mod.num_kv_heads, mod.head_dim)
                proj = 2 * t * e * (qh + 2 * kv) * d + 2 * t * qh * d * e
                fl["attention"] += proj + 2 * t * qh * d * s * 2
            elif isinstance(mod, Linear):
                k_in, k_out = mod.kernel.shape
                if mod is lm_head and marked:
                    fl["lm_head"] += 2 * min(t, r) * k_in * k_out
                    lm_rows = min(t or 1, r) or 1
                else:
                    fl["mlp"] += 2 * t * k_in * k_out
            elif (isinstance(mod, Embedding)
                  and not isinstance(mod, PositionEmbedding)):
                fl["mlp"] += t * mod.weight.shape[1]
    return {**fl, "lm_rows": lm_rows}


def weight_bytes(im) -> float:
    """The weight bytes one model pass streams over every stage: every
    parameter at the config dtype's width (an int8 weight's scale is not
    a parameter of the reference's graph)."""
    size = _itemsize(_model_dtype(im))
    total = 0.0
    for model in _stage_models(im):
        for name, p in model.named_parameters():
            if name.endswith("_scale"):
                continue
            total += p.numel() * size
    return total


def kv_state_bytes(im, model=None) -> float:
    """The registered serve-state buffers of every attention layer of
    ``model`` (None: of every stage)."""
    if model is None:
        return sum(kv_state_bytes(im, m) for m in _stage_models(im))
    r1, s, p = im.max_requests + 1, im.max_seq_len, im.max_spec_tokens
    dt = _model_dtype(im)
    kv_size = 1 if im.kv_dtype == "int8" else _itemsize(dt)
    total = 0.0
    for mod in model.modules():
        if not isinstance(mod, IncMultiHeadSelfAttention):
            continue
        kv, d = mod.num_kv_heads, mod.head_dim
        total += 2 * (r1 * kv * s * d * kv_size)
        if im.kv_dtype == "int8":
            total += 2 * (r1 * kv * s * 4)
        if p:
            total += 2 * (r1 * kv * p * d * _itemsize(dt))
            if mod.use_alibi:
                total += r1 * p * 4
    return total


def plan_cost(im) -> Dict[str, float]:
    """The fields of the profiler's ``PlanCostCard`` for one deployment
    (reference ``obs/profiler.py:141``): per-token attention and MLP
    flops, flops per logit row, streamed weight bytes, and the KV bytes a
    token costs (the allocator's price once the caches exist, else the
    state buffers over ``max_requests x max_seq_len``)."""
    rows = int(im.max_tokens) or 1
    fl = _heavy_flops(im)
    kv_bpt = 0.0
    if im.kv.state:
        kv_bpt = im.kv.bytes_per_token() or 0.0
    if not kv_bpt:
        cap = (im.max_requests * im.max_seq_len) or 1
        kv_bpt = kv_state_bytes(im) / cap
    return {
        "attn_flops_per_token": fl["attention"] / rows,
        "mlp_flops_per_token": fl["mlp"] / rows,
        "lm_head_flops_per_row": (fl["lm_head"] / fl["lm_rows"]
                                  if fl["lm_rows"] else 0.0),
        "weight_bytes": weight_bytes(im),
        "kv_bytes_per_token": kv_bpt,
    }


def plan_memory_parts(im, model=None) -> Dict[str, float]:
    """The predicted HBM of one device of the deployment in bytes, by
    component (reference ``simulator.py:plan_memory_parts(plan,
    training=False)``): ``weights`` (int8 weights at one byte plus their
    scales), ``kv_state``, ``transient`` (the largest single op output)
    and their ``total``.  ``model``: a pipeline stage's shard model (its
    stage plan's parts; None: ``im.model``)."""
    model = im.model if model is None else model
    size = _itemsize(_model_dtype(im))
    plan = model.tp_plan
    params = 0.0
    for name, p in model.named_parameters():
        pname = name.rsplit(".", 1)[-1]
        if pname.endswith("_scale"):
            continue
        n = p.numel()
        if (p.dtype == torch.int8 and pname in INT8_PARAM_NAMES
                and p.dim() >= 2):
            # the global weight's scale count: split output dims times
            # the degree
            split = plan.dim(name) not in (None, 0)
            params += n + (n // p.shape[0]) * 4 * (plan.degree if split
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
    act = im.max_tokens * max(widths) * size
    state = kv_state_bytes(im, model)
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
