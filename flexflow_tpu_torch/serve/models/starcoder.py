"""StarCoder (gpt_bigcode) serve model.

Port of ``flexflow_tpu/serve/models/starcoder.py:15-38``: token embedding
plus learned positions (offset 0), pre-LN blocks with multi-query
attention (biased, no RoPE) and a biased tanh-GELU MLP, a final LayerNorm
and the LM head.  Module paths follow the reference's node names
(``transformer.h.{i}.mlp.c_fc`` ...).
"""

from __future__ import annotations

from torch import nn

from ...ops.embedding import Embedding, PositionEmbedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import GatedLMHead, ServeModelConfig, register_model


class StarCoderMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.c_fc = Linear(cfg.hidden_size, cfg.intermediate_size, dtype,
                           use_bias=True, activation="gelu")
        self.c_proj = Linear(cfg.intermediate_size, cfg.hidden_size, dtype,
                             use_bias=True)


class StarCoderBlock(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln_1 = LayerNorm(h, eps, dtype=dtype)
        self.attn = IncMultiHeadSelfAttention(
            h, cfg.num_attention_heads, cfg.kv_heads, cfg.hdim,
            rotary_embedding=False, use_bias=True, dtype=dtype)
        self.ln_2 = LayerNorm(h, eps, dtype=dtype)
        self.mlp = StarCoderMLP(cfg, dtype)


class StarCoderModel(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        self.wpe = PositionEmbedding(cfg.max_position_embeddings,
                                     cfg.hidden_size, offset=0, dtype=dtype)
        self.h = nn.ModuleList(StarCoderBlock(cfg, dtype)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              dtype=dtype)


class StarCoderForServe(GatedLMHead, nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.transformer = StarCoderModel(cfg, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype)
        self.finish_graph()

    def build_graph(self, ff):
        """The reference's serve graph (reference :15-38)."""
        tr = self.transformer
        x = ff.embedding(ff.create_tensor(), tr.wte, "transformer.wte")
        x = ff.position_embedding(x, tr.wpe, "transformer.wpe")
        for i, blk in enumerate(tr.h):
            p = f"transformer.h.{i}"
            h = ff.norm(x, blk.ln_1, f"{p}.ln_1")
            a = ff.attention(h, blk.attn, f"{p}.attn")
            x = ff.add(x, a, f"{p}.attn_residual")
            h = ff.norm(x, blk.ln_2, f"{p}.ln_2")
            h = ff.dense(h, blk.mlp.c_fc, f"{p}.mlp.c_fc")
            h = ff.dense(h, blk.mlp.c_proj, f"{p}.mlp.c_proj")
            x = ff.add(x, h, f"{p}.mlp_residual")
        x = ff.norm(x, tr.ln_f, "transformer.ln_f")
        ff.lm_head(x, self.lm_head, "lm_head")


@register_model("gpt_bigcode")
def build_starcoder(cfg: ServeModelConfig) -> StarCoderForServe:
    return StarCoderForServe(cfg)
