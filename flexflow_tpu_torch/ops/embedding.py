"""Token embedding lookup.

Port of ``flexflow_tpu/ops/embedding.py`` for the serve path: a plain
lookup (no aggregation, no vocabulary sharding).  ``weight`` is
``[vocab, embed]`` as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Embedding(nn.Module):
    def __init__(self, num_entries: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_entries, out_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
