"""Serve model configuration and the model registry.

``ServeModelConfig`` is a copy of ``flexflow_tpu/serve/models/base.py``'s
(HF ``config.json`` field names), kept here because the port imports
nothing of the JAX package.  ``build_model`` returns an ``nn.Module`` whose
parameters sit on the ``meta`` device: they take no memory until the
:class:`~flexflow_tpu_torch.serve.inference_manager.InferenceManager`
materialises them on its device, as the reference's builder only describes
a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(model_type: str):
    def deco(fn):
        MODEL_REGISTRY[model_type] = fn
        return fn

    return deco


@dataclasses.dataclass
class ServeModelConfig:
    """Architecture hyperparameters (HF config.json field names)."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    bos_token_id: int = 1
    eos_token_id: int = 2
    tie_word_embeddings: bool = False
    do_layer_norm_before: bool = True
    word_embed_proj_dim: Optional[int] = None
    parallel_attn: bool = False
    bias: bool = False
    use_alibi: bool = False
    new_decoder_architecture: bool = False
    # compute and cache dtype of the whole model
    dtype: str = "float32"

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def build_model(config: ServeModelConfig) -> torch.nn.Module:
    """The registered family's serve model, parameters on ``meta``."""
    if config.model_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model_type {config.model_type!r}; "
            f"known: {sorted(MODEL_REGISTRY)}")
    with torch.device("meta"):
        return MODEL_REGISTRY[config.model_type](config)
