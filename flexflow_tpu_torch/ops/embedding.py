"""Token embeddings with aggregation, and learned position embeddings.

Port of ``flexflow_tpu/ops/embedding.py`` (``Embedding`` :30-120) and of
the serve graph's ``PositionEmbedding``
(``flexflow_tpu/serve/ops.py:997-1041``).  ``weight`` is ``[vocab,
embed]``, or ``[num_positions + offset, embed]``, as in the reference.
The lookup comes out in the compute dtype the module was built with,
whatever the dtype its weight was loaded in (reference :87).  ``aggr``
``"sum"`` or ``"avg"`` reduces the looked-up rows over axis -2 (a bag of
ids a sample, DLRM's sparse features, :83-86); the serve path's lookups
are ``"none"``.  The serve path builds the table frozen
(``requires_grad=False``); ``FFModel.embedding`` builds it trainable,
through ``core/interpreter.py:init_params``, with its
``kernel_initializer``.

Sharding (:88-120): ``sample`` splits the ids' batch, ``channel_out``
the table's columns and the output's last dim, ``entry`` the table's
rows: a shard answers the ids in its rows (``entry_offset``, set by
``parallel/tp.py:place_module``) and zeros elsewhere, so the output is a
partial sum over the ``entry`` axes, which the plan's parallel steps
reduce (under training, with the reduction's gradient).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding


@register_op
class Embedding(Op, nn.Module):
    type_name = "embedding"
    # vocabulary-sharded (``entry``): the first id of this shard's rows
    # (parallel/tp.py); None: the whole table
    entry_offset: Optional[int] = None

    def __init__(self, num_entries: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 aggr: str = "none", kernel_initializer=None):
        super().__init__()
        if aggr not in ("none", "sum", "avg"):
            raise ValueError(f"bad aggr {aggr!r}")
        self.aggr = aggr
        self.compute_dtype = dtype
        self.kernel_initializer = kernel_initializer
        self.weight = nn.Parameter(
            torch.empty(num_entries, out_dim, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.entry_offset is None:
            emb = F.embedding(ids, self.weight)
        else:
            rows = self.weight.shape[0]
            local = ids.long() - self.entry_offset
            hit = (local >= 0) & (local < rows)
            emb = F.embedding(local.clamp(0, rows - 1), self.weight)
            emb = torch.where(hit[..., None], emb, torch.zeros_like(emb))
        if self.aggr == "sum":
            emb = emb.sum(dim=-2)
        elif self.aggr == "avg":
            emb = emb.mean(dim=-2)
        return emb.to(self.compute_dtype)

    # ---- op IR (reference ops/embedding.py:51-120) -----------------------
    @property
    def num_entries(self) -> int:
        return self.weight.shape[0]

    @property
    def out_dim(self) -> int:
        return self.weight.shape[1]

    def signature_attrs(self):
        # the reference's fields: the table's shape beside ``aggr`` and
        # ``kernel_initializer``
        return {**super().signature_attrs(), "num_entries": self.num_entries,
                "out_dim": self.out_dim}

    def infer_shapes(self, in_specs):
        ids = in_specs[0]
        lead = ids.shape if self.aggr == "none" else ids.shape[:-1]
        return [TensorSpec(tuple(lead) + (self.out_dim,),
                           self.compute_dtype)]

    def params(self):
        return [ParamSpec("weight", TensorSpec(
            (self.num_entries, self.out_dim), self.compute_dtype),
            self.kernel_initializer)]

    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0],
                "channel_out": self.out_dim,
                "entry": self.num_entries}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        ids = in_specs[0]
        sample = tuple(config.get("sample", ()))
        c_out = tuple(config.get("channel_out", ()))
        entry = tuple(config.get("entry", ()))
        ids_sh = TensorSharding.replicated(ids.ndim)
        if sample:
            ids_sh = ids_sh.with_dim(0, sample)
        w_sh = TensorSharding.replicated(2)
        if entry:
            w_sh = w_sh.with_dim(0, entry)
        if c_out:
            w_sh = w_sh.with_dim(1, c_out)
        out = self.infer_shapes([ids])[0]
        out_sh = TensorSharding.replicated(out.ndim)
        if sample:
            out_sh = out_sh.with_dim(0, sample)
        if c_out:
            out_sh = out_sh.with_dim(out.ndim - 1, c_out)
        if entry:
            out_sh = out_sh.with_partial(entry)
        return ShardingSolution(inputs=[ids_sh], outputs=[out_sh],
                                params={"weight": w_sh})

    def flops(self, in_specs):
        return self.infer_shapes(list(in_specs))[0].size


@register_op
class PositionEmbedding(Op, nn.Module):
    """Learned absolute positions: ``forward(x, positions)`` adds
    ``weight[clamp(positions + offset)]`` to ``x`` (OPT: offset 2,
    StarCoder: 0); a position past the table takes its last row, as the
    reference clips."""

    type_name = "position_embedding"

    def __init__(self, num_positions: int, out_dim: int, offset: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_positions = int(num_positions)
        self.out_dim = int(out_dim)
        self.offset = int(offset)
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(self.num_positions + self.offset, out_dim,
                        dtype=dtype, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:   # outside a serve step (reference :1035)
            raise ValueError("position_embedding requires a batch_config")
        idx = (positions.long() + self.offset).clamp(
            0, self.num_positions + self.offset - 1)
        return x + self.weight[idx].to(x.dtype)

    # ---- op IR (reference serve/ops.py:1015-1043) ------------------------
    def infer_shapes(self, in_specs):
        x = in_specs[0]
        if x.shape[-1] != self.out_dim:
            raise ValueError(f"expected dim {self.out_dim}, got {x}")
        return [TensorSpec(x.shape, self.compute_dtype)]

    def params(self):
        return [ParamSpec("weight", TensorSpec(
            (self.num_positions + self.offset, self.out_dim),
            self.compute_dtype))]

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = TensorSharding.replicated(in_specs[0].ndim)
        return ShardingSolution(inputs=[sh], outputs=[sh],
                                params={"weight":
                                        TensorSharding.replicated(2)})
