"""MPT serve model.

Port of ``flexflow_tpu/serve/models/mpt.py:15-39``: pre-LN blocks whose
LayerNorms have no bias, attention with ALiBi (no RoPE, no position
embedding, no biases), an exact-GELU MLP without biases, a final norm and
the LM head.  Module paths follow the reference's node names
(``transformer.blocks.{i}.attn`` ...).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops.embedding import Embedding
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


class MPTFFN(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype,
                              activation="gelu_exact")
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size,
                                dtype)

    def gen(self, x):
        h = yield from self.up_proj.gen(x, out="local")
        return (yield from self.down_proj.gen(h))


class MPTBlock(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm_1 = LayerNorm(h, eps, use_bias=False, dtype=dtype)
        self.attn = IncMultiHeadSelfAttention(
            h, cfg.num_attention_heads, cfg.kv_heads, cfg.hdim,
            rotary_embedding=False, use_bias=False, use_alibi=True,
            dtype=dtype)
        self.norm_2 = LayerNorm(h, eps, use_bias=False, dtype=dtype)
        self.ffn = MPTFFN(cfg, dtype)

    def gen(self, x, bc, state, pages):
        a = yield from self.attn.gen(self.norm_1(x), bc,
                                     state[self.attn.name], pages)
        x = x + a
        return x + (yield from self.ffn.gen(self.norm_2(x)))


class MPTModel(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        self.blocks = nn.ModuleList(MPTBlock(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                use_bias=False, dtype=dtype)


class MPTForServe(GatedLMHead, nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.transformer = MPTModel(cfg, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype)
        name_attention_layers(self)

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None):
        """One step's logits (see ``GatedLMHead.forward``), yielding at
        the collectives as :class:`~.llama.LlamaForServe`."""
        base = getattr(bc, "base", bc)
        x = self.transformer.wte(base.tokens)
        for block in self.transformer.blocks:
            x = yield from block.gen(x, bc, state, pages)
        return (yield from self.logits(self.transformer.norm_f(x), bc))


@register_model("mpt")
def build_mpt(cfg: ServeModelConfig) -> MPTForServe:
    return MPTForServe(cfg)
