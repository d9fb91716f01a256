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

Under tensor parallelism (``parallel/tp.py``) ``tp_mode`` places the
layer: ``"col"`` holds a slice of the output columns (and of the bias),
``"row"`` a slice of the input rows, whose product is a partial sum.
:meth:`Linear.gen` yields the collectives that placement needs (see
``parallel/comm.py``); ``forward`` is the layer alone.
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
    tp_mode = None   # "col" | "row": set by parallel.tp.shard_model

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

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ kernel``, the kernel dequantized to x's dtype."""
        return torch.matmul(x, dequant(
            self.kernel, getattr(self, "kernel_scale", None), x.dtype))

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The bias and activation on the whole product ``y``."""
        if self.bias is None and self.activation is None:
            return y
        return add_bias(y, self.bias, self.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.product(x))

    def gen(self, x: torch.Tensor, out: str = "full"):
        """The layer as a generator of its collectives.  Row-sharded: the
        partial product is all-reduced, then the bias and activation
        apply once.  Column-sharded: ``out`` says who needs the output
        whole: ``"full"`` every shard (all-gather), ``"first"`` shard 0
        only (the logits: the other shards get None), ``"local"`` nobody
        (the row-sharded layer it feeds takes the slice).  A layer that is
        not sharded yields nothing."""
        if self.tp_mode == "row":
            return self.finish((yield ("all_reduce", self.product(x))))
        y = self(x)
        if self.tp_mode == "col" and out != "local":
            y = yield ("all_gather" if out == "full" else "gather", y)
        return y
