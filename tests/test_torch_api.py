"""The port's ``LLM`` / ``SSM`` entry point vs the JAX package's, on the
CPU (after ``tests/test_hf_import.py``).

* ``LLM(ServeModelConfig)`` with the JAX ``LLM``'s params: the same greedy
  streams through ``generate`` as the JAX ``LLM``, and as driving the
  port's ``RequestManager`` directly;
* ids in give ids out, strings in give strings out (through a tokenizer),
  one prompt gives one result;
* ``ssms=[SSM(...)]``: SpecInfer streams equal incremental ones, greedy
  and seeded;
* a tiny ``LlamaForCausalLM`` saved to a temporary directory and loaded by
  path (``load_hf_model``, nothing downloaded): streams equal HF
  ``generate`` and the JAX ``LLM`` on the same directory;
* ``tp > 1`` and a missing card raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu_torch.serve import (
    LLM,
    SSM,
    GenerationConfig,
    RequestManager,
    ServeModelConfig,
    params_from_jax,
)

from test_serve import TINY
from test_spec_scan import TINY_SSM
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

CFG = ServeModelConfig(**dataclasses.asdict(TINY))
SSM_CFG = ServeModelConfig(**dataclasses.asdict(TINY_SSM))
CAPS = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=64)
PROMPTS = [[5, 9, 13, 44, 2], [61, 3, 17]]
HF_CFG = dict(vocab_size=97, hidden_size=32, intermediate_size=56,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
              tie_word_embeddings=False)


@pytest.fixture(scope="module")
def pair():
    """A compiled JAX ``LLM`` (random weights) and a port ``LLM`` holding
    its params."""
    jllm = JaxLLM(TINY).compile(**CAPS)
    llm = LLM(CFG).compile(device="cpu", **CAPS)
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jllm.im.params.items()}
    llm.im.init_operators_inference(params_from_jax(params, CFG, "cpu"))
    return jllm, llm


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**HF_CFG)).eval()
    path = tmp_path_factory.mktemp("tiny_llama")
    model.save_pretrained(path)
    return model, str(path)


class WordTokenizer:
    """A tokenizer of space-separated integers."""

    def encode(self, text):
        return [int(w) for w in text.split()]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_llm_matches_jax_llm_and_the_request_manager(pair):
    jllm, llm = pair
    want = jllm.generate(PROMPTS, max_new_tokens=8)
    assert llm.generate(PROMPTS, max_new_tokens=8) == want
    assert llm.rm.gen.eos_token_id == CFG.eos_token_id   # from the config
    llm.im.reset()
    direct = RequestManager(llm.im, GenerationConfig(
        max_new_tokens=8, eos_token_id=CFG.eos_token_id)).generate(PROMPTS)
    assert direct == want


def test_generate_ids_and_strings_single_and_batched(pair):
    _, llm = pair
    batched = llm.generate(PROMPTS, max_new_tokens=6)
    assert llm.generate(PROMPTS[0], max_new_tokens=6) == batched[0]
    assert llm.generate([], max_new_tokens=6) == []
    llm.tokenizer = WordTokenizer()
    try:
        texts = [" ".join(map(str, p)) for p in PROMPTS]
        out = llm.generate(texts, max_new_tokens=6)
        assert out == [" ".join(map(str, s)) for s in batched]
        assert llm.generate(texts[1], max_new_tokens=6) == out[1]
    finally:
        llm.tokenizer = None
    with pytest.raises(ValueError, match="tokenizer"):
        llm.generate("5 9 13")


def test_memory_report(pair):
    """The reference's gauges under its key names, after a served run
    (their values tick by tick: ``test_torch_api_parity.py``): the
    watermark holds the most tokens the run had live at a tick."""
    jllm, llm = pair
    # the fixture's deployment served the earlier tests: this run's
    # watermark starts afresh
    llm.im.kv.reset_attribution()
    llm.generate(PROMPTS, max_new_tokens=4)
    kv = llm.memory_report()["kv"]
    jkv = jllm.memory_report()["kv"]
    assert set(kv) == set(jkv)
    assert kv["capacity_tokens"] == 2 * 64
    assert kv["capacity_bytes"] == jkv["capacity_bytes"] > 0
    # the decode stretch runs the 3 tokens left after the first at the
    # reference's power of two, 2 steps: its tick leaves both rows live at
    # their prompt and 3 tokens, and a one-step trailer finishes both
    assert kv["hwm_tokens"] == sum(len(p) + 3 for p in PROMPTS)
    assert kv["hwm_bytes"] == kv["hwm_tokens"] * llm.im.kv.bytes_per_token()
    assert kv["live_tokens"] == kv["bound_slots"] == 0
    assert LLM(CFG).memory_report() is None


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_ssm_spec_equals_incremental(pair, temperature):
    """``ssms=[SSM(...)]``: the draft compiles with the LLM's capacities
    and top-``spec_width``; greedy and seeded streams equal the
    incremental LLM's."""
    jllm, inc = pair
    gen = GenerationConfig(max_new_tokens=8, temperature=temperature,
                           seed=5)
    llm = LLM(CFG)
    draft = SSM(SSM_CFG)
    llm.compile(device="cpu", generation_config=gen, ssms=[draft],
                spec_width=2, spec_depth=2, **CAPS)
    assert draft.im.topk == 2 and draft.im.max_requests == 2
    assert llm.im.max_spec_tokens == 5
    llm.im.init_operators_inference(dict(inc.im.model.named_parameters()))
    got = llm.generate(PROMPTS)
    inc.im.reset()
    want = RequestManager(inc.im, dataclasses.replace(
        gen, eos_token_id=CFG.eos_token_id)).generate(PROMPTS)
    assert got == want
    if temperature == 0.0:
        assert got == jllm.generate(PROMPTS, max_new_tokens=8)


def test_hf_checkpoint_by_path_matches_hf_and_jax(hf_dir):
    """``LLM(path)`` reads the saved checkpoint (``load_hf_model``):
    greedy streams equal HF ``generate`` and the JAX ``LLM`` on the same
    directory; a state dict with its config gives the same."""
    model, path = hf_dir
    gen = GenerationConfig(stop_on_eos=False)
    llm = LLM(path).compile(device="cpu", generation_config=gen, **CAPS)
    assert llm.tokenizer is None and llm.config.vocab_size == 97
    got = llm.generate(PROMPTS, max_new_tokens=8)
    for prompt, g in zip(PROMPTS, got):
        with torch.no_grad():
            out = model.generate(torch.tensor([prompt]), max_new_tokens=8,
                                 do_sample=False, eos_token_id=None,
                                 pad_token_id=0)
        assert g == out[0, len(prompt):].tolist()
    jllm = JaxLLM(path).compile(
        generation_config=JaxGenerationConfig(stop_on_eos=False), **CAPS)
    assert jllm.generate(PROMPTS, max_new_tokens=8) == got
    with pytest.raises(ValueError, match="config"):
        LLM(model.state_dict())
    sd_llm = LLM(model.state_dict(), config=llm.config).compile(
        device="cpu", generation_config=gen, **CAPS)
    assert sd_llm.generate(PROMPTS, max_new_tokens=8) == got


def test_tp_and_a_missing_card_raise(monkeypatch):
    # tp > 1 places its shards on ``devices``; one ``device`` is refused
    # rather than silently holding every shard
    with pytest.raises(ValueError, match="devices"):
        LLM(CFG).compile(tp=2, device="cpu", **CAPS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # devices=None: cards
        LLM(CFG).compile(tp=2, **CAPS)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLM(CFG).compile(**CAPS)
    with pytest.raises(RuntimeError, match="compile"):
        LLM(CFG).generate(PROMPTS)
