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
from .base import (
    GatedLMHead,
    ServeModelConfig,
    name_attention_layers,
    register_model,
)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.act = SigmoidSiluMulti()
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, dtype)

    def gen(self, x):
        gate = yield from self.gate_proj.gen(x, out="local")
        up = yield from self.up_proj.gen(x, out="local")
        return (yield from self.down_proj.gen(self.act(gate, up)))


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


class LlamaForServe(GatedLMHead, nn.Module):
    def __init__(self, cfg: ServeModelConfig):
        super().__init__()
        self.config = cfg
        dtype = torch_dtype(cfg.dtype)
        self.model = LlamaModel(cfg, dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, dtype)
        name_attention_layers(self)

    def forward_gen(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                    pages=None):
        """One step's logits (see ``GatedLMHead.forward``), yielding at
        the collectives: after each attention's and MLP's row-sharded
        product, and at the LM head."""
        base = getattr(bc, "base", bc)
        residual = self.model.embed_tokens(base.tokens)
        mlp_out = None
        for i, layer in enumerate(self.model.layers):
            if i == 0:
                attn_in = layer.input_layernorm(residual)
            else:
                residual, attn_in = layer.input_layernorm(mlp_out, residual)
            attn = yield from layer.self_attn.gen(
                attn_in, bc, state[layer.self_attn.name], pages)
            residual, mlp_in = layer.post_attention_layernorm(attn, residual)
            mlp_out = yield from layer.mlp.gen(mlp_in)
        _, normed = self.model.norm(mlp_out, residual)
        return (yield from self.logits(normed, bc))


@register_model("llama")
def build_llama(cfg: ServeModelConfig) -> LlamaForServe:
    return LlamaForServe(cfg)
