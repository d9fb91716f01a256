"""Serving under a parallel strategy on the card: two shards on one card.

These tests need an NVIDIA GPU with nvcc; without one each skips.  This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_strategy.py

``chip_smoke.py`` phase 20(a)'s three dicts at TINY widths: a small Llama
(float32, TF32 off) served under ``strategy="search"``, the all-``sample``
dict and the mixed dict (``head``, ``channel_out``, ``channel_in``,
``entry``, and ``sample`` beside ``channel_out``: an all-to-all), two
shards on ``cuda:0`` (the local collectives), gives the greedy streams of
``tp=1`` on the card, each shard launching K1 and K2 (booked between its
collectives, ``test_torch_cuda_tp.py:_shard_launches``); the searched
target also serves through ``SpecInferManager`` (K3) with the streams of
its ``tp=1`` twin.
"""

import pytest
import torch

from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    SpecInferManager,
    build_model,
)

from test_torch_cuda_tp import _shard_launches

pytestmark = pytest.mark.cuda

CFG = ServeModelConfig(vocab_size=68, hidden_size=32, intermediate_size=48,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2)
DRAFT = ServeModelConfig(vocab_size=68, hidden_size=16, intermediate_size=32,
                         num_hidden_layers=1, num_attention_heads=2)
PROMPTS = [[5, 9, 2, 11, 3, 7, 1], [4, 4, 8]]
CAPS = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=64,
            max_spec_tokens=8)
TP = ("tp",)


def sample_dict():
    out = {"lm_head": {"sample": TP}}
    for i in range(CFG.num_hidden_layers):
        for n in ("self_attn", "post_attention_layernorm", "mlp.gate_proj",
                  "mlp.up_proj", "mlp.act", "mlp.down_proj"):
            out[f"model.layers.{i}.{n}"] = {"sample": TP}
    return out


def mixed_dict():
    return {"model.embed_tokens": {"entry": TP}, "lm_head": {"sample": TP},
            "model.layers.0.self_attn": {"head": TP},
            "model.layers.0.mlp.gate_proj": {"channel_out": TP},
            "model.layers.0.mlp.up_proj": {"channel_out": TP},
            "model.layers.0.mlp.down_proj": {"channel_in": TP},
            "model.layers.1.self_attn": {"sample": TP},
            "model.layers.1.mlp.gate_proj": {"sample": TP},
            "model.layers.1.mlp.up_proj": {"channel_out": TP},
            "model.layers.1.mlp.down_proj": {"sample": TP}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _deploy(where, strategy=None, cfg=CFG, seed=4, topk=0):
    im = InferenceManager(build_model(cfg), strategy=strategy, topk=topk,
                          **CAPS, **where)
    return im.init_operators_inference(seed=seed)


def _generate(im):
    im.reset()
    return RequestManager(im, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)


@pytest.mark.parametrize("which", ["search", "sample", "mixed"])
def test_strategy_on_two_shards_serves_like_one(dev, which):
    strategy = {"search": "search", "sample": sample_dict(),
                "mixed": mixed_dict()}[which]
    want = _generate(_deploy(dict(device=dev)))
    im = _deploy(dict(mesh=make_mesh({"tp": 2}, [dev, dev])), strategy)
    assert im.strategy
    per = _shard_launches(im)
    assert _generate(im) == want
    assert im.mesh.comm.kind == "local" and im.mesh.comm.calls["local"] > 0
    for counter in per:
        assert counter["decode"] > 0 and counter["prefill"] > 0


def test_searched_target_speculates_like_one(dev):
    gen = GenerationConfig(max_new_tokens=8)
    ssm = _deploy(dict(device=dev), cfg=DRAFT, seed=5, topk=2)
    one = _deploy(dict(device=dev))
    want = SpecInferManager(one, ssm, gen, width=2, depth=2).generate(
        PROMPTS)
    two = _deploy(dict(mesh=make_mesh({"tp": 2}, [dev, dev])), "search")
    ssm.reset()
    n0 = att.tree_attention.launches
    got = SpecInferManager(two, ssm, gen, width=2, depth=2).generate(PROMPTS)
    assert got == want
    assert att.tree_attention.launches > n0
