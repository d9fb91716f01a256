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

from ...parallel.comm import run_local

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

    @staticmethod
    def from_hf_config(hf) -> "ServeModelConfig":
        """Build from an HF config object or a plain dict of its fields
        (``flexflow_tpu/serve/models/base.py:66-123``), mapping Falcon's
        ``ffn_hidden_size`` too (4 x hidden when absent, as HF defaults
        it), which the reference leaves at the Llama default."""
        def get(k, d=None):
            return hf.get(k, d) if isinstance(hf, dict) else getattr(hf, k, d)

        kw = {}
        for f in dataclasses.fields(ServeModelConfig):
            v = get(f.name, None)
            if v is not None:
                kw[f.name] = v
        renames = (   # (HF field, ours), later entries win
            ("layer_norm_epsilon", "layer_norm_eps"),    # falcon/gpt_bigcode
            ("n_embd", "hidden_size"),                   # gpt_bigcode
            ("d_model", "hidden_size"),                  # mpt
            ("n_head", "num_attention_heads"),
            ("n_heads", "num_attention_heads"),
            ("n_layer", "num_hidden_layers"),
            ("n_layers", "num_hidden_layers"),
            ("ffn_dim", "intermediate_size"),            # opt
            ("ffn_hidden_size", "intermediate_size"),    # falcon
            ("n_positions", "max_position_embeddings"),  # gpt_bigcode
        )
        for theirs, ours in renames:
            if get(theirs) is not None:
                kw[ours] = get(theirs)
        if get("n_inner"):                               # gpt_bigcode
            kw["intermediate_size"] = get("n_inner")
        if get("expansion_ratio") is not None:           # mpt
            kw["intermediate_size"] = (get("expansion_ratio")
                                       * kw["hidden_size"])
        if get("num_kv_heads") is not None and get("new_decoder_architecture",
                                                   False):
            # falcon's new-decoder GQA only; the old one ignores num_kv_heads
            kw["num_key_value_heads"] = get("num_kv_heads")
        if get("multi_query", False):                    # falcon-7b, starcoder
            kw["num_key_value_heads"] = 1
        if get("alibi", None) is not None:
            kw["use_alibi"] = get("alibi")
        attn_cfg = get("attn_config", None)              # mpt nests these
        if attn_cfg is not None:
            def aget(k):
                return (attn_cfg.get(k) if isinstance(attn_cfg, dict)
                        else getattr(attn_cfg, k, None))

            if aget("kv_n_heads") is not None:
                kw["num_key_value_heads"] = aget("kv_n_heads")
            if aget("alibi") is not None:
                kw["use_alibi"] = aget("alibi")
        hidden = kw.get("hidden_size", ServeModelConfig.hidden_size)
        if "intermediate_size" not in kw and get("model_type") in (
                "gpt_bigcode", "falcon"):
            kw["intermediate_size"] = 4 * hidden
        kw.pop("dtype", None)
        td = get("torch_dtype", None) or get("dtype", None)
        if td is not None:
            td = str(td).replace("torch.", "")
            kw["dtype"] = "bfloat16" if td in ("float16", "bfloat16") else td
        return ServeModelConfig(**kw)


class GatedLMHead:
    """The LM head of a serve model, gated (reference ``ops/linear.py:98-108``,
    marked by ``mark_gated_lm_head``, inference_manager.py:167): a batch
    with ``logit_slots`` (a gated prefill chunk) gathers those hidden rows
    before the product, a slot of -1 clamping to row 0 (its logits are
    never read), so the step computes ``[max_requests, vocab]`` logits
    instead of ``[max_tokens, vocab]``.  Every family mixes it in: the
    reference marks each one's LM head.

    The mixin also gives each family its ``forward``: the family writes
    ``forward_gen(bc, state, pages)``, a generator that yields at its
    tensor-parallel collectives (``parallel/comm.py``), and ``forward``
    runs it alone with identity collectives; a tensor-parallel manager
    runs one per shard in lockstep.  One forward serves both."""

    gates_lm_head = True

    def forward(self, bc, state: Dict[str, Dict[str, torch.Tensor]],
                pages=None) -> torch.Tensor:
        """Float32 logits ``[T, vocab]`` of one step (``[max_requests,
        vocab]`` for a gated prefill chunk); ``state`` holds each
        attention layer's caches, which are updated in place; ``pages`` is
        the page table of a paged cache (None: slot-contiguous)."""
        return run_local(self.forward_gen(bc, state, pages))

    def logits(self, x: torch.Tensor, bc):
        """Float32 logits of the final hidden states ``x`` [T, E], as a
        generator: a vocabulary-sharded head gathers them on shard 0 (the
        other shards return None)."""
        slots = getattr(bc, "logit_slots", None)
        if slots is not None:
            x = x.index_select(0, slots.clamp(0, x.shape[0] - 1).long())
        y = yield from self.lm_head.gen(x, out="first")
        return None if y is None else y.float()


def name_attention_layers(model: torch.nn.Module) -> None:
    """Give each attention module its path in ``model``: the key of its
    caches in the allocator's state."""
    from ..ops import IncMultiHeadSelfAttention

    for name, mod in model.named_modules():
        if isinstance(mod, IncMultiHeadSelfAttention):
            mod.name = name


def build_model(config: ServeModelConfig) -> torch.nn.Module:
    """The registered family's serve model, parameters on ``meta``."""
    if config.model_type not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model_type {config.model_type!r}; "
            f"known: {sorted(MODEL_REGISTRY)}")
    with torch.device("meta"):
        return MODEL_REGISTRY[config.model_type](config)
