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

from torch import nn

from ...ops.embedding import Embedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import GatedLMHead, ServeModelConfig, register_model


class FalconMLP(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.dense_h_to_4h = Linear(cfg.hidden_size, cfg.intermediate_size,
                                    dtype, use_bias=cfg.bias,
                                    activation="gelu_exact")
        self.dense_4h_to_h = Linear(cfg.intermediate_size, cfg.hidden_size,
                                    dtype, use_bias=cfg.bias)


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
        self.finish_graph()

    def build_graph(self, ff):
        """The reference builder's graph (reference :22-62): both MLP
        products are column-sharded (neither name is a row-parallel one),
        so each output is gathered whole."""
        tr = self.transformer
        x = ff.embedding(ff.create_tensor(), tr.word_embeddings,
                         "transformer.word_embeddings")
        for i, layer in enumerate(tr.h):
            p = f"transformer.h.{i}"
            h = ff.norm(x, layer.input_layernorm, f"{p}.input_layernorm")
            a = ff.attention(h, layer.self_attention, f"{p}.self_attention")
            if layer.parallel:   # Falcon-7B: both branches from one LN
                m = ff.dense(h, layer.mlp.dense_h_to_4h,
                             f"{p}.mlp.dense_h_to_4h")
                m = ff.dense(m, layer.mlp.dense_4h_to_h,
                             f"{p}.mlp.dense_4h_to_h")
                x = ff.add(x, ff.add(a, m, f"{p}.attn_mlp"), f"{p}.residual")
            else:
                x = ff.add(x, a, f"{p}.attn_residual")
                h2 = ff.norm(x, layer.post_attention_layernorm,
                             f"{p}.post_attention_layernorm")
                m = ff.dense(h2, layer.mlp.dense_h_to_4h,
                             f"{p}.mlp.dense_h_to_4h")
                m = ff.dense(m, layer.mlp.dense_4h_to_h,
                             f"{p}.mlp.dense_4h_to_h")
                x = ff.add(x, m, f"{p}.mlp_residual")
        x = ff.norm(x, tr.ln_f, "transformer.ln_f")
        ff.lm_head(x, self.lm_head, "lm_head")


@register_model("falcon")
def build_falcon(cfg: ServeModelConfig) -> FalconForServe:
    return FalconForServe(cfg)
