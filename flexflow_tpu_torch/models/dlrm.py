"""DLRM, the deep learning recommendation model (BASELINE config #3).

Port of ``flexflow_tpu/models/dlrm.py:22-66`` (the reference's
``examples/cpp/DLRM``): dense features through a bottom MLP, each sparse
feature through its own table (``aggr="sum"``), the features
concatenated, and a top MLP to a sigmoid click-through logit, with the
reference's node names (``"bottom_mlp.0"``, ``"emb_table.0"``,
``"interaction_concat"``, ``"top_mlp.0"``).  The strategy it returns is
the reference's hybrid: each table split over its rows (``entry``) on the
``mp_axes``, so a lookup is a partial sum that one all-reduce resolves,
and the MLPs' batch over the ``dp_axes``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import FFConfig
from ..model import FFModel


def build_dlrm(config: Optional[FFConfig] = None, mesh=None,
               batch: int = 32, dense_dim: int = 13,
               table_sizes: Sequence[int] = (1000, 1000, 1000, 1000),
               embed_dim: int = 64,
               bottom_mlp: Sequence[int] = (512, 256, 64),
               top_mlp: Sequence[int] = (256, 64, 1), mp_axes=(),
               dp_axes=(), device=None):
    """Returns ``(model, dense input, [sparse inputs], output,
    strategy)``; each sparse input is ``[batch, 1]`` int32 ids."""
    if bottom_mlp[-1] != embed_dim:
        raise ValueError("the bottom MLP must end at embed_dim")
    ff = FFModel(config or FFConfig(batch_size=batch), mesh=mesh,
                 device=device)
    strategy = {}

    dense_in = ff.create_tensor((batch, dense_dim))
    x = dense_in
    for i, h in enumerate(bottom_mlp):
        name = f"bottom_mlp.{i}"
        x = ff.dense(x, h, activation="relu", name=name)
        if dp_axes:
            strategy[name] = {"sample": dp_axes}

    feats = [x]
    sparse_ins = []
    for t, size in enumerate(table_sizes):
        ids = ff.create_tensor((batch, 1), dtype=torch.int32)
        sparse_ins.append(ids)
        name = f"emb_table.{t}"
        feats.append(ff.embedding(ids, size, embed_dim, aggr="sum",
                                  name=name))
        if mp_axes:
            strategy[name] = {"entry": mp_axes}

    y = ff.concat(feats, axis=1, name="interaction_concat")
    for i, h in enumerate(top_mlp):
        name = f"top_mlp.{i}"
        act = "relu" if i < len(top_mlp) - 1 else "sigmoid"
        y = ff.dense(y, h, activation=act, name=name)
        if dp_axes:
            strategy[name] = {"sample": dp_axes}
    return ff, dense_in, sparse_ins, y, strategy
