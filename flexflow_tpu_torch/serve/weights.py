"""HF state dicts -> the serve models' parameters.

Port of the converters of ``flexflow_tpu/serve/weights.py:30-300``: a pure
name and layout map from a HuggingFace ``state_dict()`` (tensors or
arrays) to ``{node name: {param name: float32 np.ndarray}}``, the format
:func:`~flexflow_tpu_torch.serve.convert.params_from_jax` turns into a
state dict.  The port's module paths are the reference's node names, so
one map serves both packages.  torch's ``nn.Linear.weight`` is
``[out, in]`` and the serve ``Linear`` kernel ``[in, out]``, so every
projection transposes; Q, K and V fuse into the kv-head-major ``qkv [E,
KV, q_per_kv + 2, D]`` of the attention layer, their biases into
``qkv_bias [KV, q_per_kv + 2, D]``.  ``load_hf_model`` reads a local
checkpoint directory through ``transformers``, imported inside it only:
nothing else in the port needs that package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.base import ServeModelConfig

Params = Dict[str, Dict[str, np.ndarray]]


def _t(x) -> np.ndarray:
    """A tensor (any dtype or device) or array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def fuse_qkv(qw, kw, vw, cfg: ServeModelConfig) -> np.ndarray:
    """``[QH*D, E], [KV*D, E], [KV*D, E]`` (torch layout) -> ``[E, KV,
    q_per_kv + 2, D]``."""
    e, kv, d = cfg.hidden_size, cfg.kv_heads, cfg.hdim
    gq = cfg.num_attention_heads // kv
    q = _t(qw).T.reshape(e, kv, gq, d)
    k = _t(kw).T.reshape(e, kv, 1, d)
    v = _t(vw).T.reshape(e, kv, 1, d)
    return np.concatenate([q, k, v], axis=2)


def fuse_qkv_rows(w, cfg: ServeModelConfig) -> np.ndarray:
    """Row-stacked ``[QH*D + 2*KV*D, E]`` (q | k | v, the query heads in
    kv-major order: the HF mpt and gpt_bigcode layouts) -> ``[E, KV,
    q_per_kv + 2, D]``."""
    qh, kv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.hdim
    q, k, v = np.split(_t(w), [qh * d, qh * d + kv * d], axis=0)
    return fuse_qkv(q, k, v, cfg)


def fuse_qkv_bias(qb, kb, vb, cfg: ServeModelConfig) -> np.ndarray:
    """``[QH*D], [KV*D], [KV*D]`` -> ``[KV, q_per_kv + 2, D]``."""
    kv, d = cfg.kv_heads, cfg.hdim
    gq = cfg.num_attention_heads // kv
    return np.concatenate([_t(qb).reshape(kv, gq, d),
                           _t(kb).reshape(kv, 1, d),
                           _t(vb).reshape(kv, 1, d)], axis=1)


def fuse_qkv_rows_bias(b, cfg: ServeModelConfig) -> np.ndarray:
    """Row-stacked ``[QH*D + 2*KV*D]`` -> ``[KV, q_per_kv + 2, D]``."""
    qh, kv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.hdim
    return fuse_qkv_bias(*np.split(_t(b), [qh * d, qh * d + kv * d]), cfg)


class _Out:
    """Collects ``{node: {param: array}}`` from a state dict."""

    def __init__(self, sd):
        self.sd = sd
        self.params: Params = {}

    def put(self, node, pname, arr) -> None:
        self.params.setdefault(node, {})[pname] = _t(arr)

    def linear(self, node, key=None, bias=False) -> None:
        key = key or node
        self.put(node, "kernel", _t(self.sd[f"{key}.weight"]).T)
        if bias:
            self.put(node, "bias", self.sd[f"{key}.bias"])

    def norm(self, node, key=None, bias=True) -> None:
        key = key or node
        self.put(node, "gamma", self.sd[f"{key}.weight"])
        if bias:
            self.put(node, "beta", self.sd[f"{key}.bias"])

    def lm_head(self, embed_key) -> None:
        """The LM head, or the tied token embedding when there is none."""
        w = self.sd.get("lm_head.weight")
        self.put("lm_head", "kernel", _t(w if w is not None
                                         else self.sd[embed_key]).T)


def convert_llama_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """HF LLaMA ``state_dict()`` (reference :49)."""
    o = _Out(sd)
    o.put("model.embed_tokens", "weight", sd["model.embed_tokens.weight"])
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        o.norm(f"{p}.input_layernorm", bias=False)
        o.norm(f"{p}.post_attention_layernorm", bias=False)
        a = f"{p}.self_attn"
        o.put(a, "qkv", fuse_qkv(sd[f"{a}.q_proj.weight"],
                                 sd[f"{a}.k_proj.weight"],
                                 sd[f"{a}.v_proj.weight"], cfg))
        o.put(a, "o_proj", _t(sd[f"{a}.o_proj.weight"]).T)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            o.linear(f"{p}.mlp.{proj}")
    o.norm("model.norm", bias=False)
    o.lm_head("model.embed_tokens.weight")
    return o.params


def convert_opt_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """HF OPT (reference :130), pre- and post-LN, with opt-350m's
    ``project_in``/``project_out``."""
    o = _Out(sd)
    d = "model.decoder"
    o.put(f"{d}.embed_tokens", "weight", sd[f"{d}.embed_tokens.weight"])
    o.put(f"{d}.embed_positions", "weight",
          sd[f"{d}.embed_positions.weight"])
    for i in range(cfg.num_hidden_layers):
        p = f"{d}.layers.{i}"
        a = f"{p}.self_attn"
        o.norm(f"{p}.self_attn_layer_norm")
        o.put(a, "qkv", fuse_qkv(sd[f"{a}.q_proj.weight"],
                                 sd[f"{a}.k_proj.weight"],
                                 sd[f"{a}.v_proj.weight"], cfg))
        o.put(a, "qkv_bias", fuse_qkv_bias(sd[f"{a}.q_proj.bias"],
                                           sd[f"{a}.k_proj.bias"],
                                           sd[f"{a}.v_proj.bias"], cfg))
        o.put(a, "o_proj", _t(sd[f"{a}.out_proj.weight"]).T)
        o.put(a, "o_bias", sd[f"{a}.out_proj.bias"])
        o.norm(f"{p}.final_layer_norm")
        o.linear(f"{p}.fc1", bias=True)
        o.linear(f"{p}.fc2", bias=True)
    if f"{d}.final_layer_norm.weight" in sd:   # pre-LN variants only
        o.norm(f"{d}.final_layer_norm")
    for proj in ("project_in", "project_out"):   # opt-350m
        if f"{d}.{proj}.weight" in sd:
            o.linear(f"{d}.{proj}")
    o.lm_head(f"{d}.embed_tokens.weight")
    return o.params


def convert_falcon_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """HF Falcon (reference :185): Falcon-7B and Falcon-RW."""
    if cfg.new_decoder_architecture:
        raise NotImplementedError(
            "falcon new_decoder_architecture weight layout is not supported")
    o = _Out(sd)
    o.put("transformer.word_embeddings", "weight",
          sd["transformer.word_embeddings.weight"])
    g = cfg.num_attention_heads // cfg.kv_heads + 2
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        a = f"{p}.self_attention"
        o.norm(f"{p}.input_layernorm")
        if not cfg.parallel_attn:   # falcon-rw's sequential layout
            o.norm(f"{p}.post_attention_layernorm")
        # the fused weight is already kv-head-major (HF _split_heads), our
        # [E, KV, q_per_kv + 2, D] layout: a reshape
        o.put(a, "qkv", _t(sd[f"{a}.query_key_value.weight"]).T.reshape(
            cfg.hidden_size, cfg.kv_heads, g, cfg.hdim))
        o.put(a, "o_proj", _t(sd[f"{a}.dense.weight"]).T)
        o.linear(f"{p}.mlp.dense_h_to_4h", bias=cfg.bias)
        o.linear(f"{p}.mlp.dense_4h_to_h", bias=cfg.bias)
        if cfg.bias:
            o.put(a, "qkv_bias", _t(sd[f"{a}.query_key_value.bias"]).reshape(
                cfg.kv_heads, g, cfg.hdim))
            o.put(a, "o_bias", sd[f"{a}.dense.bias"])
    o.norm("transformer.ln_f")
    o.lm_head("transformer.word_embeddings.weight")
    return o.params


def convert_mpt_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """HF MPT (reference :238)."""
    o = _Out(sd)
    o.put("transformer.wte", "weight", sd["transformer.wte.weight"])
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.blocks.{i}"
        o.norm(f"{p}.norm_1", bias=False)
        o.norm(f"{p}.norm_2", bias=False)
        o.put(f"{p}.attn", "qkv", fuse_qkv_rows(sd[f"{p}.attn.Wqkv.weight"],
                                                cfg))
        o.put(f"{p}.attn", "o_proj", _t(sd[f"{p}.attn.out_proj.weight"]).T)
        o.linear(f"{p}.ffn.up_proj")
        o.linear(f"{p}.ffn.down_proj")
    o.norm("transformer.norm_f", bias=False)
    o.lm_head("transformer.wte.weight")
    return o.params


def convert_starcoder_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """HF gpt_bigcode (reference :261)."""
    o = _Out(sd)
    o.put("transformer.wte", "weight", sd["transformer.wte.weight"])
    o.put("transformer.wpe", "weight", sd["transformer.wpe.weight"])
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        a = f"{p}.attn"
        o.norm(f"{p}.ln_1")
        o.norm(f"{p}.ln_2")
        o.put(a, "qkv", fuse_qkv_rows(sd[f"{a}.c_attn.weight"], cfg))
        o.put(a, "qkv_bias", fuse_qkv_rows_bias(sd[f"{a}.c_attn.bias"], cfg))
        o.put(a, "o_proj", _t(sd[f"{a}.c_proj.weight"]).T)
        o.put(a, "o_bias", sd[f"{a}.c_proj.bias"])
        o.linear(f"{p}.mlp.c_fc", bias=True)
        o.linear(f"{p}.mlp.c_proj", bias=True)
    o.norm("transformer.ln_f")
    o.lm_head("transformer.wte.weight")
    return o.params


CONVERTERS = {
    "llama": convert_llama_state_dict,
    "opt": convert_opt_state_dict,
    "falcon": convert_falcon_state_dict,
    "mpt": convert_mpt_state_dict,
    "gpt_bigcode": convert_starcoder_state_dict,
}


def convert_state_dict(sd, cfg: ServeModelConfig) -> Params:
    """The converter of ``cfg.model_type`` applied to ``sd``."""
    if cfg.model_type not in CONVERTERS:
        raise ValueError(f"no weight converter for {cfg.model_type!r}; "
                         f"known: {sorted(CONVERTERS)}")
    return CONVERTERS[cfg.model_type](sd, cfg)


def load_hf_model(path: str):
    """A local HF checkpoint directory (reference :303-325): ``(state
    dict, ServeModelConfig, tokenizer or None)``, the weights in float32.
    Nothing is downloaded (``local_files_only=True``)."""
    import transformers

    hf_cfg = transformers.AutoConfig.from_pretrained(path,
                                                     local_files_only=True)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        path, local_files_only=True, torch_dtype=torch.float32)
    try:
        tok = transformers.AutoTokenizer.from_pretrained(
            path, local_files_only=True)
    except Exception:   # noqa: BLE001 -- as the reference: no tokenizer
        tok = None      # (transformers raises several kinds when none)
    return (model.state_dict(), ServeModelConfig.from_hf_config(hf_cfg),
            tok)
