"""Falcon serve model.

Port of ``flexflow_tpu/serve/models/falcon.py:22-62``, its two decoder
shapes: Falcon-7B (``parallel_attn``: one LayerNorm feeds attention and
the MLP, residual ``x + (attn + mlp)``, multi-query, RoPE, no biases) and
Falcon-RW (sequential blocks with a ``post_attention_layernorm``, biased
linears, ALiBi in place of RoPE when ``use_alibi``).  The MLP is exact
GELU.  ``new_decoder_architecture`` (Falcon-40B/180B) is refused, as the
reference refuses it.  Module paths follow the reference's node names
(``transformer.h.{i}.self_attention`` ...).
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


class FalconMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.dense_h_to_4h = Linear(cfg.hidden_size, cfg.intermediate_size,
                                    dtype, use_bias=cfg.bias,
                                    activation="gelu_exact")
        self.dense_4h_to_h = Linear(cfg.intermediate_size, cfg.hidden_size,
                                    dtype, use_bias=cfg.bias)

    def gen(self, x):
        # both column-sharded (neither name is a row-parallel one): each
        # output is gathered whole
        h = yield from self.dense_h_to_4h.gen(x)
        return (yield from self.dense_4h_to_h.gen(h))


class FalconDecoderLayer(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.parallel = cfg.parallel_attn
        self.input_layernorm = LayerNorm(h, eps, dtype=dtype)
        self.self_attention = IncMultiHeadSelfAttention(
            h, cfg.num_attention_heads, cfg.kv_heads, cfg.hdim,
            rotary_embedding=not cfg.use_alibi, rope_theta=cfg.rope_theta,
            use_bias=cfg.bias, use_alibi=cfg.use_alibi, dtype=dtype)
        if not self.parallel:
            self.post_attention_layernorm = LayerNorm(h, eps, dtype=dtype)
        self.mlp = FalconMLP(cfg, dtype)

    def gen(self, x, bc, state, pages):
        h = self.input_layernorm(x)
        a = yield from self.self_attention.gen(
            h, bc, state[self.self_attention.name], pages)
        if self.parallel:   # Falcon-7B: both branches from the same LN
            return x + (a + (yield from self.mlp.gen(h)))
        x = x + a
        return x + (yield from self.mlp.gen(self.post_attention_layernorm(x)))


class FalconModel(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype)
        self.h = nn.ModuleList(FalconDecoderLayer(cfg, dtype)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              dtype=dtype)


class FalconForServe(GatedLMHead, nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        if cfg.new_decoder_architecture:
            raise NotImplementedError(
                "falcon new_decoder_architecture (40B/180B) is not supported: "
                "it needs ln_attn/ln_mlp and the per-kv-group interleaved QKV "
                "layout, which the reference rejects too")
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.transformer = FalconModel(cfg, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype)
        name_attention_layers(self)

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None):
        """One step's logits (see ``GatedLMHead.forward``), yielding at
        the collectives as :class:`~.llama.LlamaForServe`."""
        base = getattr(bc, "base", bc)
        x = self.transformer.word_embeddings(base.tokens)
        for layer in self.transformer.h:
            x = yield from layer.gen(x, bc, state, pages)
        return (yield from self.logits(self.transformer.ln_f(x), bc))


@register_model("falcon")
def build_falcon(cfg: ServeModelConfig) -> FalconForServe:
    return FalconForServe(cfg)
