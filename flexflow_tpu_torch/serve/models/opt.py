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

from torch import nn

from ...ops.embedding import Embedding, PositionEmbedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import GatedLMHead, ServeModelConfig, register_model


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
        self.finish_graph()

    def build_graph(self, ff):
        """The reference's serve graph (reference :19-61): pre-LN or
        post-LN blocks."""
        dec = self.model.decoder
        x = ff.embedding(ff.create_tensor(), dec.embed_tokens,
                         "model.decoder.embed_tokens")
        if hasattr(dec, "project_in"):
            x = ff.dense(x, dec.project_in, "model.decoder.project_in")
        x = ff.position_embedding(x, dec.embed_positions,
                                  "model.decoder.embed_positions")
        for i, layer in enumerate(dec.layers):
            p = f"model.decoder.layers.{i}"
            pre = layer.pre
            h = ff.norm(x, layer.self_attn_layer_norm,
                        f"{p}.self_attn_layer_norm") if pre else x
            a = ff.attention(h, layer.self_attn, f"{p}.self_attn")
            x = ff.add(x, a, f"{p}.attn_residual")
            if not pre:
                x = ff.norm(x, layer.self_attn_layer_norm,
                            f"{p}.self_attn_layer_norm")
            h = ff.norm(x, layer.final_layer_norm,
                        f"{p}.final_layer_norm") if pre else x
            h = ff.dense(h, layer.fc1, f"{p}.fc1")
            h = ff.dense(h, layer.fc2, f"{p}.fc2")
            x = ff.add(x, h, f"{p}.mlp_residual")
            if not pre:
                x = ff.norm(x, layer.final_layer_norm,
                            f"{p}.final_layer_norm")
        if hasattr(dec, "final_layer_norm"):
            x = ff.norm(x, dec.final_layer_norm,
                        "model.decoder.final_layer_norm")
        if hasattr(dec, "project_out"):
            x = ff.dense(x, dec.project_out, "model.decoder.project_out")
        ff.lm_head(x, self.lm_head, "lm_head")


@register_model("opt")
def build_opt(cfg: ServeModelConfig) -> OPTForServe:
    return OPTForServe(cfg)
