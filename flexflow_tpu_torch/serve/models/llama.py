"""LLaMA / Llama-2 serve model.

Port of ``flexflow_tpu/serve/models/llama.py``: token embedding, per layer
[RMSNorm (layer 0) or fused residual RMSNorm -> KV-cached GQA attention ->
fused residual RMSNorm -> SwiGLU MLP], final fused norm, LM head.  Module
paths follow the reference's node names (``model.embed_tokens``,
``model.layers.{i}.self_attn``, ``lm_head`` ...), so a state-dict key is
``<node name>.<param name>`` and the reference's params map one to one.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops.embedding import Embedding
from ...ops.linear import Linear
from ...ops.norm import ResidualRMSNorm, RMSNorm, SigmoidSiluMulti
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import ServeModelConfig, register_model


class LlamaMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.act = SigmoidSiluMulti()
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, dtype)

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: ServeModelConfig, index: int, dtype):
        super().__init__()
        eps = cfg.rms_norm_eps
        # layer 0 normalises the embedding alone; later layers fold the
        # previous MLP output into the residual first (reference :24-33)
        self.input_layernorm = (RMSNorm(cfg.hidden_size, eps, dtype)
                                if index == 0
                                else ResidualRMSNorm(cfg.hidden_size, eps,
                                                     dtype))
        self.self_attn = IncMultiHeadSelfAttention(
            cfg.hidden_size, cfg.num_attention_heads, cfg.kv_heads,
            cfg.hdim, rope_theta=cfg.rope_theta, dtype=dtype)
        self.post_attention_layernorm = ResidualRMSNorm(cfg.hidden_size, eps,
                                                        dtype)
        self.mlp = LlamaMLP(cfg, dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = ResidualRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)


class LlamaForServe(nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.model = LlamaModel(cfg, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype)
        for name, mod in self.named_modules():
            if isinstance(mod, IncMultiHeadSelfAttention):
                mod.name = name

    def forward(self, bc, state: Dict[str, Dict[str, torch.Tensor]]
                ) -> torch.Tensor:
        """Float32 logits ``[T, vocab]`` of one step; ``state`` holds each
        attention layer's caches, which are updated in place."""
        base = getattr(bc, "base", bc)
        residual = self.model.embed_tokens(base.tokens)
        mlp_out = None
        for i, layer in enumerate(self.model.layers):
            if i == 0:
                attn_in = layer.input_layernorm(residual)
            else:
                residual, attn_in = layer.input_layernorm(mlp_out, residual)
            attn = layer.self_attn(attn_in, bc, state[layer.self_attn.name])
            residual, mlp_in = layer.post_attention_layernorm(attn, residual)
            mlp_out = layer.mlp(mlp_in)
        _, normed = self.model.norm(mlp_out, residual)
        return self.lm_head(normed).float()


@register_model("llama")
def build_llama(cfg: ServeModelConfig) -> LlamaForServe:
    return LlamaForServe(cfg)
