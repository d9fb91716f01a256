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

    def gen(self, x):
        h = yield from self.c_fc.gen(x, out="local")
        return (yield from self.c_proj.gen(h))


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

    def gen(self, x, bc, state, pages):
        a = yield from self.attn.gen(self.ln_1(x), bc, state[self.attn.name],
                                     pages)
        x = x + a
        return x + (yield from self.mlp.gen(self.ln_2(x)))


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

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None):
        """One step's logits (see ``GatedLMHead.forward``), yielding at
        the collectives as :class:`~.llama.LlamaForServe`; ``c_proj``'s
        bias is added after its reduce."""
        base = getattr(bc, "base", bc)
        tr = self.transformer
        x = tr.wpe(tr.wte(base.tokens), base.token_position)
        for block in tr.h:
            x = yield from block.gen(x, bc, state, pages)
        return (yield from self.logits(tr.ln_f(x), bc))


@register_model("gpt_bigcode")
def build_starcoder(cfg: ServeModelConfig) -> StarCoderForServe:
    return StarCoderForServe(cfg)
