"""LLaMA / Llama-2 serve model.

Port of ``flexflow_tpu/serve/models/llama.py``: token embedding, per layer
[RMSNorm (layer 0) or fused residual RMSNorm -> KV-cached GQA attention ->
fused residual RMSNorm -> SwiGLU MLP], final fused norm, LM head.  Module
paths follow the reference's node names (``model.embed_tokens``,
``model.layers.{i}.self_attn``, ``lm_head`` ...), so a state-dict key is
``<node name>.<param name>`` and the reference's params map one to one;
``build_graph`` records the reference builder's graph over them.
"""

from __future__ import annotations

from torch import nn

from ...ops.embedding import Embedding
from ...ops.linear import Linear
from ...ops.norm import ResidualRMSNorm, RMSNorm, SigmoidSiluMulti
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import GatedLMHead, ServeModelConfig, register_model


class LlamaMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.gate_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.act = SigmoidSiluMulti()
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size, dtype)


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
        self.finish_graph()

    def build_graph(self, ff):
        """The reference's serve graph (reference :17-66)."""
        m = self.model
        x = ff.embedding(ff.create_tensor(), m.embed_tokens,
                         "model.embed_tokens")
        residual, mlp_out = x, None
        for i, layer in enumerate(m.layers):
            p = f"model.layers.{i}"
            if i == 0:
                attn_in = ff.norm(residual, layer.input_layernorm,
                                  f"{p}.input_layernorm")
            else:
                residual, attn_in = ff.residual_rms_norm(
                    mlp_out, residual, layer.input_layernorm,
                    f"{p}.input_layernorm")
            attn = ff.attention(attn_in, layer.self_attn, f"{p}.self_attn")
            residual, mlp_in = ff.residual_rms_norm(
                attn, residual, layer.post_attention_layernorm,
                f"{p}.post_attention_layernorm")
            gate = ff.dense(mlp_in, layer.mlp.gate_proj,
                            f"{p}.mlp.gate_proj")
            up = ff.dense(mlp_in, layer.mlp.up_proj, f"{p}.mlp.up_proj")
            act = ff.sigmoid_silu_multi(gate, up, layer.mlp.act,
                                        f"{p}.mlp.act")
            mlp_out = ff.dense(act, layer.mlp.down_proj,
                               f"{p}.mlp.down_proj")
        _, normed = ff.residual_rms_norm(mlp_out, residual, m.norm,
                                         "model.norm")
        ff.lm_head(normed, self.lm_head, "lm_head")


@register_model("llama")
def build_llama(cfg: ServeModelConfig) -> LlamaForServe:
    return LlamaForServe(cfg)
