"""RMSNorm, the fused residual RMSNorm, and the SwiGLU junction.

Port of ``flexflow_tpu/ops/norm.py`` (``_rms_norm`` :46, ``RMSNorm`` :93,
``ResidualRMSNorm`` :202, ``SigmoidSiluMulti`` :231).  The normalisation is
computed in float32 and cast back to the input's dtype at the same place
``_rms_norm`` casts, so bf16 models round where the reference rounds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def rms_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    if gamma is not None:
        y = y * gamma  # f32 * gamma's dtype -> f32, as in the reference
    return y.to(x.dtype)


def residual_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                      gamma: Optional[torch.Tensor], eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + residual, rms_norm(x + residual))``."""
    s = x + residual
    return s, rms_norm(s, gamma, eps)


def sigmoid_silu_multi(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` in the inputs' dtype."""
    return F.silu(x1) * x2


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = float(eps)
        self.gamma = nn.Parameter(
            torch.ones(dim, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x):
        return rms_norm(x, self.gamma, self.eps)


class ResidualRMSNorm(RMSNorm):
    """Returns ``(residual_sum, normed)`` like the reference op."""

    def forward(self, x, residual):
        return residual_rms_norm(x, residual, self.gamma, self.eps)


class SigmoidSiluMulti(nn.Module):
    def forward(self, x1, x2):
        return sigmoid_silu_multi(x1, x2)
