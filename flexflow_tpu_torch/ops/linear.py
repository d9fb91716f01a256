"""Dense layer with optional bias and activation.

Port of ``flexflow_tpu/ops/linear.py:98-127`` for the serve path.
``kernel`` is ``[in, out]`` as in the reference, ``bias`` ``[out]``.  The
product stays a ``torch.matmul``, as the reference left it to XLA: for bf16
operands the GEMM accumulates in float32 and rounds its output once, which
is the reference's ``preferred_element_type=_acc_dtype(x.dtype)`` followed
by the cast back.  The reference adds the bias and applies the activation
to the f32 product and casts once; here the bias and the activation run in
f32 on the product as the GEMM returned it, so a bf16 layer with a bias or
an activation rounds once more than the reference (the product, before the
bias; float32 layers are the reference's arithmetic).  Activations follow
``flexflow_tpu/ops/elementwise.py:28-30``: ``"relu"``, ``"gelu"`` (the tanh
approximation) and ``"gelu_exact"`` (erf).  An int8 ``kernel``
(``serve/quant.py``) carries per-out-channel f32 scales in
``kernel_scale`` and is dequantized to x's dtype just before the product
(reference :110-118); the dequantized copy lives for that product only.
A floating kernel of another dtype than x (parameters loaded in another
dtype than the compute dtype, ``LLM.compile(dtype=...)``) is cast to x's
dtype at use, as the reference's product promotes it: a bf16 kernel
under f32 compute is an f32 product of the same values.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
}


def dequant(w: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight times its per-out-channel scales, in ``dtype``
    (``flexflow_tpu/serve/quant.py:153``); any other weight cast to
    ``dtype`` (a no-op when it has it)."""
    if w.dtype != torch.int8:
        return w.to(dtype)
    return (w * scale).to(dtype)   # int8 * f32 promotes to f32


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor],
             activation: Optional[str] = None) -> torch.Tensor:
    """``activation(y + bias)`` computed in f32 and cast to y's dtype."""
    out = y.float()
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = ACTIVATIONS[activation](out)
    return out.to(y.dtype)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 use_bias: bool = False,
                 activation: Optional[str] = None):
        super().__init__()
        if activation is not None and activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.activation = activation
        self.kernel = nn.Parameter(
            torch.empty(in_dim, out_dim, dtype=dtype, device=device),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_dim, dtype=dtype,
                                              device=device),
                                  requires_grad=False)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = dequant(self.kernel, getattr(self, "kernel_scale", None), x.dtype)
        y = torch.matmul(x, w)
        if self.bias is None and self.activation is None:
            return y
        return add_bias(y, self.bias, self.activation)
