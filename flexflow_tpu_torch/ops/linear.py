"""Bias-free dense layer.

Port of ``flexflow_tpu/ops/linear.py:98-126`` for the serve path.
``kernel`` is ``[in, out]`` as in the reference.  The product stays a
``torch.matmul``, as the reference left it to XLA: for bf16 operands the
GEMM accumulates in float32 and rounds its output once, which is the
reference's ``preferred_element_type=_acc_dtype(x.dtype)`` followed by the
cast back.
"""

from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(in_dim, out_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel)
