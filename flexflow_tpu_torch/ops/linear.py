"""Bias-free dense layer.

Port of ``flexflow_tpu/ops/linear.py:98-126`` for the serve path.
``kernel`` is ``[in, out]`` as in the reference.  The product stays a
``torch.matmul``, as the reference left it to XLA: for bf16 operands the
GEMM accumulates in float32 and rounds its output once, which is the
reference's ``preferred_element_type=_acc_dtype(x.dtype)`` followed by the
cast back.  An int8 ``kernel`` (``serve/quant.py``) carries per-out-channel
f32 scales in ``kernel_scale`` and is dequantized to x's dtype just before
the product (reference :110-118); the dequantized copy lives for that
product only.
"""

from __future__ import annotations

import torch
from torch import nn


def dequant(w: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight times its per-out-channel scales, in ``dtype``
    (``flexflow_tpu/serve/quant.py:153``); any other weight as it is."""
    if w.dtype != torch.int8:
        return w
    return (w * scale).to(dtype)   # int8 * f32 promotes to f32


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(in_dim, out_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if w.dtype == torch.int8:
            w = dequant(w, self.kernel_scale, x.dtype)
        return torch.matmul(x, w)
