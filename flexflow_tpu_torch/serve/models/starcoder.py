"""StarCoder (gpt_bigcode) serve model.

Port of ``flexflow_tpu/serve/models/starcoder.py:15-38``: token embedding
plus learned positions (offset 0), pre-LN blocks with multi-query
attention (biased, no RoPE) and a biased tanh-GELU MLP, a final LayerNorm
and the LM head.  Module paths follow the reference's node names
(``transformer.h.{i}.mlp.c_fc`` ...).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops.embedding import Embedding, PositionEmbedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import (
    GatedLMHead,
    ServeModelConfig,
    name_attention_layers,
    register_model,
)


class StarCoderMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.c_fc = Linear(cfg.hidden_size, cfg.intermediate_size, dtype,
                           use_bias=True, activation="gelu")
        self.c_proj = Linear(cfg.intermediate_size, cfg.hidden_size, dtype,
                             use_bias=True)

    def forward(self, x):
        return self.c_proj(self.c_fc(x))


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

    def forward(self, x, bc, state, pages):
        x = x + self.attn(self.ln_1(x), bc, state[self.attn.name], pages)
        return x + self.mlp(self.ln_2(x))


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
        name_attention_layers(self)

    def forward(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                pages=None) -> torch.Tensor:
        """Float32 logits ``[T, vocab]`` of one step (caches updated in
        place, as :class:`~.llama.LlamaForServe`)."""
        base = getattr(bc, "base", bc)
        tr = self.transformer
        x = tr.wpe(tr.wte(base.tokens), base.token_position)
        for block in tr.h:
            x = block(x, bc, state, pages)
        return self.logits(tr.ln_f(x), bc)


@register_model("gpt_bigcode")
def build_starcoder(cfg: ServeModelConfig) -> StarCoderForServe:
    return StarCoderForServe(cfg)
