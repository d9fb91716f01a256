"""Weight-only int8 quantization of a serve model.

Port of ``flexflow_tpu/serve/quant.py``: weights are stored int8 with
per-out-channel f32 scales beside them (``<name>_scale``) and dequantized to
the compute dtype just before their product (``ops/linear.py``,
``serve/ops.py``); the dequantized copy is transient.  The planner's
``annotate_int8`` marks a model's weights as int8 without touching a
tensor, for pricing before allocation.  A tensor-parallel
manager's weights are quantized whole, as the reference quantizes its
global arrays, then sliced again (``parallel/tp.py``): the scale of a
row-sharded weight is the global one on every shard.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.linear import Linear, dequant  # noqa: F401  (re-exported)
from .ops import IncMultiHeadSelfAttention


def _quantize_array(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize ``w`` with per-out-channel scales (reference :28).

    Every weight here contracts over its first dim (Linear ``[in, out]``,
    fused QKV ``[E, KV, G, D]``, o_proj ``[QH*D, E]``), so the scale spans
    ``w.shape[1:]``.  Returns ``(q int8, scale f32)`` with ``q * scale ~=
    w``, the per-element error at most ``scale / 2``; the same bits as the
    reference's numpy (IEEE division, round half to even).
    """
    wf = w.float()
    scale = wf.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _weights(model: nn.Module, include: Optional[Sequence[str]],
             attention: bool) -> Iterator[Tuple[str, str]]:
    """(module path, parameter name) of every weight :func:`quantize_int8`
    covers: each Linear's ``kernel`` and, with ``attention``, each
    attention module's ``qkv`` and ``o_proj``; ``include`` keeps the
    modules whose path contains one of its strings."""
    for name, mod in model.named_modules():
        if include and not any(s in name for s in include):
            continue
        if isinstance(mod, Linear):
            yield name, "kernel"
        elif attention and isinstance(mod, IncMultiHeadSelfAttention):
            yield name, "qkv"
            yield name, "o_proj"


def _set_int8(mod: nn.Module, pname: str, q: torch.Tensor,
              scale: torch.Tensor) -> None:
    setattr(mod, pname, nn.Parameter(q, requires_grad=False))
    setattr(mod, f"{pname}_scale", nn.Parameter(scale, requires_grad=False))


@torch.no_grad()
def quantize_int8(im, include: Optional[Sequence[str]] = None,
                  attention: bool = True) -> int:
    """Quantize the serve model's weight matrices to int8 in place
    (reference :71): every Linear's kernel and, with ``attention``, each
    attention module's fused ``qkv`` and ``o_proj``; ``include`` restricts
    both to modules whose path contains one of its strings.  Call after
    ``init_operators_inference``; int8 weights are skipped, so
    re-quantizing is a no-op.  Returns the number of weights quantized."""
    n = 0
    for shards in im.shard_groups:   # one group per pipeline stage
        plan = shards[0].tp_plan
        for path, pname in list(_weights(shards[0], include, attention)):
            mods = [m.get_submodule(path) for m in shards]
            if getattr(mods[0], pname).dtype == torch.int8:
                continue
            key = f"{path}.{pname}" if path else pname
            parts = [getattr(m, pname) for m in mods]
            q, scale = _quantize_array(plan.whole(key, parts))
            for r, (m, w) in enumerate(zip(mods, parts)):
                _set_int8(m, pname,   # the compute-dtype weight goes
                          plan.local(key, q, r).contiguous().to(w.device),
                          plan.local(f"{key}_scale", scale, r).contiguous(
                          ).to(w.device))
            n += 1
    return n


def annotate_int8(model: nn.Module, include: Optional[Sequence[str]] = None,
                  attention: bool = True) -> int:
    """Mark the weight matrices of ``model`` (a serve model, on ``meta``
    or not) as int8 FOR CAPACITY PLANNING, touching no tensor (reference
    :121-150): each Linear with a 2-D kernel and, with ``attention``,
    each attention module gets ``quantization = "int8"``, which the
    planner's memory parts (``serve/cost.py``) count at one byte an
    element plus a float32 scale per output channel.  This is how a
    7B-shape int8 deployment is budgeted before anything is allocated:
    ``build_model``, ``annotate_int8``, ``register_serve_capacities(...,
    kv_dtype="int8")``, then ``search_serve_plan``.  Same ``include`` and
    ``attention`` rules as :func:`quantize_int8`; returns the number of
    modules marked."""
    n = 0
    for name, mod in model.named_modules():
        if include and not any(s in name for s in include):
            continue
        if isinstance(mod, Linear):
            if mod.kernel.dim() == 2:
                mod.quantization = "int8"
                n += 1
        elif attention and isinstance(mod, IncMultiHeadSelfAttention):
            mod.quantization = "int8"
            n += 1
    return n


def int8_layout(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Give the model int8 slots (empty) for every weight that ``params``
    holds as int8 beside its ``_scale``, so a quantized state dict (e.g.
    ``params_from_jax`` of a reference model after ``quantize_int8``)
    loads into it."""
    for mod_name, mod in model.named_modules():
        for pname in ("kernel", "qkv", "o_proj"):
            key = f"{mod_name}.{pname}" if mod_name else pname
            w = getattr(mod, pname, None)
            if (isinstance(w, nn.Parameter) and w.dtype != torch.int8
                    and key in params and params[key].dtype == torch.int8
                    and f"{key}_scale" in params):
                _set_int8(mod, pname,
                          torch.empty(w.shape, dtype=torch.int8,
                                      device=w.device),
                          torch.empty(w.shape[1:], dtype=torch.float32,
                                      device=w.device))
