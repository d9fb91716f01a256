"""OPT serve model.

Port of ``flexflow_tpu/serve/models/opt.py:19-61``: token embedding, then
opt-350m's ``project_in`` where ``word_embed_proj_dim`` differs from the
hidden size, learned positions at offset 2, per layer biased attention
(no RoPE) and a biased ReLU MLP, each behind its LayerNorm (pre-LN,
``do_layer_norm_before``) or followed by it (post-LN, opt-350m), a final
LayerNorm only when pre-LN, ``project_out``, the LM head.  Module paths
follow the reference's node names (``model.decoder.layers.{i}.fc1`` ...).
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


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pre = cfg.do_layer_norm_before
        self.self_attn_layer_norm = LayerNorm(h, eps, dtype=dtype)
        self.self_attn = IncMultiHeadSelfAttention(
            h, cfg.num_attention_heads, cfg.kv_heads, cfg.hdim,
            rotary_embedding=False, use_bias=True, dtype=dtype)
        self.final_layer_norm = LayerNorm(h, eps, dtype=dtype)
        self.fc1 = Linear(h, cfg.intermediate_size, dtype, use_bias=True,
                          activation="relu")
        self.fc2 = Linear(cfg.intermediate_size, h, dtype, use_bias=True)

    def gen(self, x, bc, state, pages):
        h = self.self_attn_layer_norm(x) if self.pre else x
        a = yield from self.self_attn.gen(h, bc, state[self.self_attn.name],
                                          pages)
        x = x + a
        if not self.pre:
            x = self.self_attn_layer_norm(x)
        h = self.final_layer_norm(x) if self.pre else x
        h = yield from self.fc1.gen(h, out="local")
        x = x + (yield from self.fc2.gen(h))
        return x if self.pre else self.final_layer_norm(x)


class OPTDecoder(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        h = cfg.hidden_size
        embed_dim = cfg.word_embed_proj_dim or h
        self.embed_tokens = Embedding(cfg.vocab_size, embed_dim, dtype)
        if embed_dim != h:
            self.project_in = Linear(embed_dim, h, dtype)
            self.project_out = Linear(h, embed_dim, dtype)
        self.embed_positions = PositionEmbedding(
            cfg.max_position_embeddings, h, offset=2, dtype=dtype)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        if cfg.do_layer_norm_before:
            self.final_layer_norm = LayerNorm(h, cfg.layer_norm_eps,
                                              dtype=dtype)


class OPTModel(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.decoder = OPTDecoder(cfg, dtype)


class OPTForServe(GatedLMHead, nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.model = OPTModel(cfg, dtype)
        self.lm_head = Linear(cfg.word_embed_proj_dim or cfg.hidden_size,
                              cfg.vocab_size, dtype)
        name_attention_layers(self)

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None):
        """One step's logits (see ``GatedLMHead.forward``), yielding at
        the collectives as :class:`~.llama.LlamaForServe`; ``fc2``'s bias
        is added after its reduce."""
        base = getattr(bc, "base", bc)
        dec = self.model.decoder
        x = dec.embed_tokens(base.tokens)
        if hasattr(dec, "project_in"):
            x = yield from dec.project_in.gen(x)
        x = dec.embed_positions(x, base.token_position)
        for layer in dec.layers:
            x = yield from layer.gen(x, bc, state, pages)
        if hasattr(dec, "final_layer_norm"):
            x = dec.final_layer_norm(x)
        if hasattr(dec, "project_out"):
            x = yield from dec.project_out.gen(x)
        return (yield from self.logits(x, bc))


@register_model("opt")
def build_opt(cfg: ServeModelConfig) -> OPTForServe:
    return OPTForServe(cfg)
