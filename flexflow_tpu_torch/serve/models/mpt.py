"""MPT serve model.

Port of ``flexflow_tpu/serve/models/mpt.py:15-39``: pre-LN blocks whose
LayerNorms have no bias, attention with ALiBi (no RoPE, no position
embedding, no biases), an exact-GELU MLP without biases, a final norm and
the LM head.  Module paths follow the reference's node names
(``transformer.blocks.{i}.attn`` ...).
"""

from __future__ import annotations

from torch import nn

from ...ops.embedding import Embedding
from ...ops.linear import Linear
from ...ops.norm import LayerNorm
from ...utils.platform import torch_dtype
from ..ops import IncMultiHeadSelfAttention
from .base import GatedLMHead, ServeModelConfig, register_model


class MPTFFN(nn.Module):
    def __init__(self, cfg: ServeModelConfig, dtype):
        super().__init__()
        self.up_proj = Linear(cfg.hidden_size, cfg.intermediate_size, dtype,
                              activation="gelu_exact")
        self.down_proj = Linear(cfg.intermediate_size, cfg.hidden_size,
                                dtype)


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
        self.finish_graph()

    def build_graph(self, ff):
        """The reference's serve graph (reference :15-39)."""
        tr = self.transformer
        x = ff.embedding(ff.create_tensor(), tr.wte, "transformer.wte")
        for i, blk in enumerate(tr.blocks):
            p = f"transformer.blocks.{i}"
            h = ff.norm(x, blk.norm_1, f"{p}.norm_1")
            a = ff.attention(h, blk.attn, f"{p}.attn")
            x = ff.add(x, a, f"{p}.attn_residual")
            h = ff.norm(x, blk.norm_2, f"{p}.norm_2")
            h = ff.dense(h, blk.ffn.up_proj, f"{p}.ffn.up_proj")
            h = ff.dense(h, blk.ffn.down_proj, f"{p}.ffn.down_proj")
            x = ff.add(x, h, f"{p}.mlp_residual")
        x = ff.norm(x, tr.norm_f, "transformer.norm_f")
        ff.lm_head(x, self.lm_head, "lm_head")


@register_model("mpt")
def build_mpt(cfg: ServeModelConfig) -> MPTForServe:
    return MPTForServe(cfg)
