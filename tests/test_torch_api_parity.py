"""The port's ``LLM`` dtype and KV gauges vs the JAX package's, on the CPU.

* ``LLM.compile(dtype=...)`` is the parameters' dtype, as in the
  reference: on ``tests/test_serve.py``'s TINY config, from one seeded HF
  state dict, (a) an f32 config compiled with ``dtype="bfloat16"`` and (b)
  a bf16 config compiled with ``dtype=None`` (f32 parameters) give the
  JAX ``LLM``'s parameter dtypes, KV dtype and bytes, and first-step
  logits: float32 compute ``atol=rtol=1e-5``; bfloat16 compute
  ``atol=rtol=5e-2`` (both sides round every activation to bfloat16, in
  different orders, through two layers and the LM head; one layer holds
  ``2e-2`` in ``tests/test_torch_layers.py``), and the same greedy token;
* the KV gauges (``KVAllocator.observe`` / ``snapshot``): the manager's
  ``kv_snapshot`` equals the JAX manager's key for key and value after
  every tick of a served run, on a contiguous cache, a paged cache and
  under ``SpecInferManager`` (target + draft combined).
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import LLM as JaxLLM
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu_torch.serve import (
    LLM,
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    SpecInferManager,
    build_model,
    params_from_jax,
)

from test_serve import TINY, make_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401
from test_torch_spec import CFG, JAX_SSM, SSM, port_im

CAPS = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=64)
PROMPT = [5, 9, 13, 44, 2, 7]


def _hf_state_dict(cfg, seed=0):
    """A seeded Llama state dict under HF's names (numpy, float32)."""
    rng = np.random.default_rng(seed)
    e, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd = cfg.num_attention_heads * (e // cfg.num_attention_heads)
    kd = cfg.num_key_value_heads * (e // cfg.num_attention_heads)

    def w(*shape):
        return rng.normal(0, shape[-1] ** -0.5, shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(v, e),
          "model.norm.weight": 1 + 0.1 * w(e), "lm_head.weight": w(v, e)}
    for n in range(cfg.num_hidden_layers):
        p = f"model.layers.{n}"
        sd.update({
            f"{p}.input_layernorm.weight": 1 + 0.1 * w(e),
            f"{p}.post_attention_layernorm.weight": 1 + 0.1 * w(e),
            f"{p}.self_attn.q_proj.weight": w(qd, e),
            f"{p}.self_attn.k_proj.weight": w(kd, e),
            f"{p}.self_attn.v_proj.weight": w(kd, e),
            f"{p}.self_attn.o_proj.weight": w(e, qd),
            f"{p}.mlp.gate_proj.weight": w(i, e),
            f"{p}.mlp.up_proj.weight": w(i, e),
            f"{p}.mlp.down_proj.weight": w(e, i)})
    return sd


@pytest.mark.parametrize("cfg_dtype,dtype,tol", [
    ("float32", "bfloat16", 1e-5), ("bfloat16", None, 5e-2)])
def test_compile_dtype_is_the_parameters_dtype(cfg_dtype, dtype, tol):
    jcfg = dataclasses.replace(TINY, dtype=cfg_dtype)
    cfg = ServeModelConfig(**dataclasses.asdict(jcfg))
    sd = _hf_state_dict(jcfg)
    jllm = JaxLLM(sd, config=jcfg).compile(dtype=dtype, **CAPS)
    llm = LLM(sd, config=cfg).compile(dtype=dtype, device="cpu", **CAPS)
    want = {f"{n}.{k}": str(a.dtype) for n, g in jllm.im.params.items()
            for k, a in g.items()}
    got = {k: str(p.dtype).removeprefix("torch.")
           for k, p in llm.im.model.named_parameters()}
    assert got == want
    assert set(got.values()) == {dtype or "float32"}
    for name, bufs in jllm.im.state.items():
        assert str(llm.im.state[name]["k"].dtype) == f"torch.{cfg_dtype}"
        assert str(bufs["k"].dtype) == cfg_dtype
    assert llm.im.kv.allocated_bytes() == jllm.im.kv.allocated_bytes()
    assert llm.im.kv.bytes_per_token() == jllm.im.kv.bytes_per_token()
    args = (PROMPT, [0] * len(PROMPT), list(range(len(PROMPT))),
            [len(PROMPT)])
    got = llm.im.forward(BatchConfig.build(*args, max_tokens=16,
                                           max_requests=2, device="cpu"))
    want = jax_logits(jllm.im, JaxBatchConfig.build(*args, max_tokens=16,
                                                    max_requests=2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:len(PROMPT)].numpy(),
                               want[:len(PROMPT)], atol=tol, rtol=tol)
    assert got[len(PROMPT) - 1].argmax() == want[len(PROMPT) - 1].argmax()


PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8], [33, 1, 60]]
BUDGETS = [6, 9, 4]


def _managers(kind):
    """(port manager, JAX manager) over the same params, with the three
    requests registered; one decode step a tick."""
    if kind == "spec":
        kw = dict(max_tokens=32, max_requests=2, max_seq=64, max_spec=8)
        jllm, jssm = make_im(**kw), make_im(cfg=JAX_SSM, topk=2, seed=123,
                                            **kw)
        pair = (SpecInferManager(port_im(jllm, max_spec=8),
                                 port_im(jssm, cfg=SSM, max_spec=8, topk=2),
                                 GenerationConfig()),
                JaxSpecInferManager(jllm, jssm, JaxGenerationConfig()))
    else:
        page = 64 if kind == "paged" else None
        jim = make_im(max_tokens=16, max_requests=2, max_seq=128,
                      kv_page_size=page)
        tim = InferenceManager(build_model(CFG), max_requests=2,
                               max_tokens_per_batch=16, max_seq_len=128,
                               device="cpu", kv_page_size=page)
        tim.init_operators_inference(params_from_jax(
            {n: {k: np.asarray(a) for k, a in g.items()}
             for n, g in jim.params.items()}, CFG, "cpu"))
        pair = (RequestManager(tim, GenerationConfig()),
                JaxRequestManager(jim, JaxGenerationConfig()))
    for m in pair:
        m.scan_chunk = 1
        for p, n in zip(PROMPTS, BUDGETS):
            m.register_new_request(p, n)
    return pair


@pytest.mark.parametrize("kind", ["contiguous", "paged", "spec"])
def test_kv_snapshot_equals_reference_every_tick(kind):
    sm, jsm = _managers(kind)
    ticks, hwm = 0, 0
    while sm.has_work() or jsm.has_work():
        for m in (sm, jsm):
            m._check_lifecycle()
            m._tick()
            m._sync_kv()
        snap = sm.kv_snapshot()
        assert snap == jsm.kv_snapshot(), f"tick {ticks}"
        hwm = max(hwm, snap["live_tokens"])
        ticks += 1
        assert ticks < 40
    assert [sm.requests[r].generated for r in range(3)] == \
        [jsm.requests[r].generated for r in range(3)]
    assert snap["hwm_tokens"] == hwm > 0 and snap["live_tokens"] == 0
    if kind == "paged":
        assert snap["pages_total"] == 5 and snap["page_size"] == 64
    assert sm.im.kv.attributed_rids() == []
