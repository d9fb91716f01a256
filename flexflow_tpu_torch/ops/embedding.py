"""Token and learned position embeddings.

Port of ``flexflow_tpu/ops/embedding.py`` for the serve path (a plain
lookup: no aggregation, no vocabulary sharding) and of the serve graph's
``PositionEmbedding`` (``flexflow_tpu/serve/ops.py:997-1041``).  ``weight``
is ``[vocab, embed]``, or ``[num_positions + offset, embed]``, as in the
reference.  The lookup comes out in the compute dtype the module was built
with, whatever the dtype its weight was loaded in (reference
``ops/embedding.py:87``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Embedding(nn.Module):
    def __init__(self, num_entries: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(num_entries, out_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class PositionEmbedding(nn.Module):
    """Learned absolute positions: ``forward(x, positions)`` adds
    ``weight[clamp(positions + offset)]`` to ``x`` (OPT: offset 2,
    StarCoder: 0); a position past the table takes its last row, as the
    reference clips."""

    def __init__(self, num_positions: int, out_dim: int, offset: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_positions = int(num_positions)
        self.offset = int(offset)
        self.weight = nn.Parameter(
            torch.empty(self.num_positions + self.offset, out_dim,
                        dtype=dtype, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        idx = (positions.long() + self.offset).clamp(
            0, self.num_positions + self.offset - 1)
        return x + self.weight[idx].to(x.dtype)
