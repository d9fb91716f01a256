"""Transformer encoder stack: the training Transformer example.

Port of ``flexflow_tpu/models/transformer.py`` (the reference's
``examples/cpp/Transformer``, BASELINE config #2): post-LN blocks of
multi-head attention and a feed-forward pair, then a mean-pool and a
softmax head, built through ``FFModel`` with the reference's node names.
"""

from __future__ import annotations

from ..model import FFModel


def create_transformer_encoder(model: FFModel, input_tensor,
                               num_layers: int = 2, hidden_dim: int = 512,
                               num_heads: int = 8, ff_dim: int = 2048,
                               dropout: float = 0.0, prefix: str = "enc"):
    """Post-LN encoder blocks: x = LN(x + MHA(x)); x = LN(x + FFN(x))."""
    x = input_tensor
    for i in range(num_layers):
        p = f"{prefix}{i}"
        attn = model.multihead_attention(
            x, x, x, hidden_dim, num_heads, dropout=dropout,
            name=f"{p}_attn")
        x = model.layer_norm(model.add(attn, x, name=f"{p}_attn_res"),
                             name=f"{p}_ln1")
        h = model.dense(x, ff_dim, activation="relu", name=f"{p}_ff1")
        if dropout:
            h = model.dropout(h, dropout, name=f"{p}_ffdrop")
        h = model.dense(h, hidden_dim, name=f"{p}_ff2")
        x = model.layer_norm(model.add(h, x, name=f"{p}_ff_res"),
                             name=f"{p}_ln2")
    return x


def build_transformer_classifier(config=None, mesh=None, batch: int = 8,
                                 seq: int = 64, num_layers: int = 2,
                                 hidden_dim: int = 256, num_heads: int = 8,
                                 ff_dim: int = 1024, num_classes: int = 16,
                                 dropout: float = 0.0, device=None):
    """Transformer encoder + mean-pool + softmax head (the training
    benchmark), on ``device`` (None: the CUDA card)."""
    from ..config import FFConfig

    model = FFModel(config or FFConfig(), mesh=mesh, device=device)
    x = model.create_tensor((batch, seq, hidden_dim))
    h = create_transformer_encoder(model, x, num_layers, hidden_dim,
                                   num_heads, ff_dim, dropout)
    pooled = model.reduce_mean(h, axes=(1,), name="pool")
    logits = model.dense(pooled, num_classes, name="head")
    model.softmax(logits)
    return model
