"""The port's int8 slice vs the JAX serve stack, on the CPU.

* the plain K1/K2/K3 (both layouts) versions with int8 caches, and with
  int8 caches behind a page table, against the Pallas kernels in interpret
  mode with ``k_scale/v_scale`` (and ``page_table``), as
  ``tests/test_kv_int8.py:58,74,97`` and ``tests/test_kv_paged.py:461``
  run them: float32 ``atol=rtol=1e-5`` (the same dequantized values; the
  kernels multiply the scale after the dot, the plain versions before it);
* ``_quantize_array`` and the KV quantizer bit for bit against JAX;
* ``params_from_jax`` of a reference model after ``quantize_int8``: int8
  arrays stay int8 and their scales float32, exactly;
* an int8-weight, int8-KV serve step's logits against the JAX
  ``InferenceManager(kv_dtype="int8")`` (float32 ``atol=rtol=1e-4``: the
  same quantized weights, and K/V quantized from projections that agree
  to float32 rounding, where a vector element sitting on a rounding tie
  may land one int8 step apart), and greedy ``RequestManager`` and
  ``SpecInferManager`` streams equal to JAX's.

The JAX side is ``test_serve.make_im`` (TINY Llama); its params reach the
port through ``params_from_jax``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu.serve import quantize_int8 as jax_quantize_int8
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
from flexflow_tpu.serve.ops import IncMultiHeadSelfAttention as JaxAttention
from flexflow_tpu.serve.quant import _quantize_array as jax_quantize_array
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    PrefillBatchConfig,
    RequestManager,
    SpecInferManager,
    build_model,
    params_from_jax,
)
from flexflow_tpu_torch.serve.ops import kv_quant
from flexflow_tpu_torch.serve.quant import _quantize_array

from test_serve import make_im
from test_torch_serve import jax_logits
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, JAX_SSM, SSM, _one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 64


# ---------------------------------------------------------------------------
# kernels: the plain versions vs Pallas (interpret), per cache variant
# ---------------------------------------------------------------------------
def _quantize(c):
    """Per-(row, head, position) int8 form of a float32 cache (numpy, the
    quantizer of tests/test_kv_int8.py)."""
    scale = np.abs(c).max(axis=-1) / 127.0
    denom = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.round(c / denom[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _to_pages(c, table):
    """The physical buffer holding logical cache ``c`` behind ``table``."""
    r1, kv, s = c.shape[:3]
    ppr = s // PAGE
    out = np.zeros_like(c)
    for row in range(r1):
        for j in range(ppr):
            pr, psl = divmod(int(table[row, j]), ppr)
            out[pr, :, psl * PAGE:(psl + 1) * PAGE] = \
                c[row, :, j * PAGE:(j + 1) * PAGE]
    return out


def kernel_case(name, variant, seed=0):
    """The Pallas kernel (interpret) and the port's wrapper on the same
    numpy inputs with the cache variant ``variant``; returns both
    outputs as float32 numpy."""
    rng = np.random.default_rng(seed)
    qh, kv, d, s, r = 4, 2, 8, 2 * PAGE, 3
    caches = [rng.normal(size=(r + 1, kv, s, d)).astype(np.float32)
              for _ in range(2)]
    kw = {}
    if variant.startswith("int8"):
        (kq, ks), (vq, vs) = (_quantize(c) for c in caches)
        caches = [kq, vq]
        kw = dict(k_scale=ks, v_scale=vs)
    if variant.endswith("paged"):
        table = np.random.RandomState(3).permutation(
            (r + 1) * (s // PAGE)).astype(np.int32).reshape(r + 1, -1)
        caches = [_to_pages(c, table) for c in caches]
        kw = {k: _to_pages(v, table) for k, v in kw.items()}
        kw.update(page_table=table)
    scale = 1.0 / np.sqrt(d)
    if name == "decode_attention":
        args = [rng.normal(size=(6, qh, d)).astype(np.float32), *caches,
                np.array([0, 1, 2, 1, 0, 3], np.int32),
                np.array([5, 70, 0, s - 1, PAGE, 0], np.int32)]
    elif name == "prefill_attention":
        args = [rng.normal(size=(3, 8, qh, d)).astype(np.float32), *caches,
                np.array([0, 3, 1], np.int32),
                np.array([8, 0, s - 8], np.int32)]
    else:
        p, spec = 8, [rng.normal(size=(r + 1, kv, 8, d)).astype(np.float32)
                      for _ in range(2)]
        if name == "tree_attention":
            t = 8
            q = rng.normal(size=(t, qh, d))
            rows = np.array([0, 0, 1, 2, 1, 0, 3, 2], np.int32)
            clens = np.array([5, 5, 0, s, PAGE, 17, 0, s - 1], np.int32)
            amask = rng.integers(0, 2, size=(t, p)).astype(bool)
            amask[:, 0] = True
            amask[6] = False              # the scratch-row pad
        else:
            q = rng.normal(size=(3, 4, qh, d))
            rows = np.array([0, 2, 3], np.int32)
            clens = np.array([7, s, 0], np.int32)
            amask = rng.integers(0, 2, size=(3, 4, p)).astype(bool)
            amask[:, :, 0] = True
            amask[2] = False
        args = [q.astype(np.float32), *caches, *spec, rows, clens, amask]
    want = getattr(jatt, name)(
        *map(jnp.asarray, args), scale, block_s=32, interpret=True,
        page_size=PAGE if "page_table" in kw else 0,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = getattr(att, name)(
        *map(torch.from_numpy, args), scale,
        page_size=PAGE if "page_table" in kw else 0,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    return got.numpy(), np.asarray(want)


KERNELS = ["decode_attention", "prefill_attention", "tree_attention",
           "tree_attention_batched"]


@pytest.mark.parametrize("variant", ["int8", "int8+paged"])
@pytest.mark.parametrize("name", KERNELS)
def test_int8_plain_versions_match_pallas(name, variant):
    got, want = kernel_case(name, variant)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# quantizers: bit for bit
# ---------------------------------------------------------------------------
def test_quantize_array_is_bit_exact():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(24, 5, 3)).astype(np.float32)
    w[:, 0, 0] = 0.0                           # an all-zero channel: scale 1
    w[:3, 1, 1] = [127.0, 2.5, -3.5]           # ties round half to even
    w[3:, 1, 1] = 0.0
    q, scale = _quantize_array(torch.from_numpy(w))
    jq, jscale = jax_quantize_array(w)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    assert q[1, 1, 1] == 2 and q[2, 1, 1] == -4


def test_kv_quant_is_bit_exact():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0                              # value 0, scale 0
    x[1, 1, :3] = [127.0, 0.5, -1.5]           # ties round half to even
    x[1, 1, 3:] = 0.0
    q, scale = kv_quant(torch.from_numpy(x))
    jq, jscale = JaxAttention._kv_quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert q[1, 1, 1] == 0 and q[1, 1, 2] == -2 and scale[0, 0] == 0


def _params(jim):
    return {n: {k: np.asarray(v) for k, v in g.items()}
            for n, g in jim.params.items()}


def test_params_from_jax_keeps_int8_weights_and_scales():
    jim = make_im()
    assert jax_quantize_int8(jim) > 0
    params = _params(jim)
    for cfg in (CFG, dataclasses.replace(CFG, dtype="bfloat16")):
        sd = params_from_jax(params, cfg, device="cpu")
        for node, group in params.items():
            for name, arr in group.items():
                t = sd[f"{node}.{name}"]
                if arr.dtype == np.int8 or name.endswith("_scale"):
                    assert t.dtype == (torch.int8 if arr.dtype == np.int8
                                       else torch.float32)
                    np.testing.assert_array_equal(t.numpy(), arr)
    assert sd["lm_head.kernel"].dtype == torch.int8
    assert sd["model.layers.0.self_attn.qkv_scale"].shape == \
        params["model.layers.0.self_attn"]["qkv"].shape[1:]


# ---------------------------------------------------------------------------
# serving: int8 weights + int8 KV, port vs JAX
# ---------------------------------------------------------------------------
def port_int8_im(jim, cfg=CFG, max_spec=0, topk=0, page=None):
    """A port InferenceManager (CPU, int8 KV) loaded with the JAX
    manager's quantized params."""
    im = InferenceManager(build_model(cfg), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu",
                          max_spec_tokens=max_spec, topk=topk,
                          kv_dtype="int8", kv_page_size=page)
    return im.init_operators_inference(
        params_from_jax(_params(jim), cfg, "cpu"))


def test_int8_serve_step_logits_match_reference():
    jim = make_im(max_tokens=8, max_requests=2, max_seq=32, use_pallas=True,
                  kv_dtype="int8")
    jax_quantize_int8(jim)
    tim = port_int8_im(jim)
    assert tim.model.lm_head.kernel.dtype == torch.int8
    assert tim.state["model.layers.0.self_attn"]["k"].dtype == torch.int8
    segs, lens = [(0, [5, 9, 2, 11, 3], 0)], [5]
    jbc, _ = JaxPrefillBatchConfig.build(segs, lens, jim.prefill_tile,
                                         max_tokens=8, max_requests=2)
    tbc, _ = PrefillBatchConfig.build(segs, lens, tim.prefill_tile,
                                      max_tokens=8, max_requests=2,
                                      device="cpu")
    args = ([7], [0], [5], [6])
    for jb, tb, real in ((jbc, tbc, 5), (
            JaxBatchConfig.build(*args, max_tokens=8, max_requests=2),
            BatchConfig.build(*args, max_tokens=8, max_requests=2,
                              device="cpu"), 1)):
        np.testing.assert_allclose(tim.forward(tb)[:real].numpy(),
                                   jax_logits(jim, jb)[:real],
                                   atol=1e-4, rtol=1e-4)
    for name, bufs in jim.state.items():
        np.testing.assert_allclose(
            tim.state[name]["k_scale"][:2, :, :6].numpy(),
            np.asarray(bufs["k_scale"])[:2, :, :6], atol=1e-6, rtol=1e-5)


PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8], [33, 1, 60]]


def test_int8_greedy_streams_match_reference():
    jim = make_im(max_tokens=8, max_requests=2, max_seq=32, use_pallas=True,
                  kv_dtype="int8")
    jax_quantize_int8(jim)
    gen = dict(max_new_tokens=8)
    want = JaxRequestManager(jim, JaxGenerationConfig(**gen)).generate(
        PROMPTS)
    got = RequestManager(port_int8_im(jim), GenerationConfig(**gen)).generate(
        PROMPTS)
    assert got == want


def test_int8_spec_infer_matches_reference():
    """The port's speculative and incremental streams each equal the
    reference's.  (With int8 weights and int8 KV the reference's own
    speculative stream parts from its incremental one here: the verify
    step's batch and the decode step's compute a token's K/V in GEMMs of
    other shapes, and a float32 rounding difference that lands on a
    quantization tie moves one int8 step; ROADMAP Queue 3.)"""
    kw = dict(max_tokens=32, max_requests=2, max_seq=64, max_spec=8,
              kv_dtype="int8")
    jllm = make_im(**kw)
    jssm = make_im(**kw, cfg=JAX_SSM, topk=2, seed=123)
    jax_quantize_int8(jllm)
    jax_quantize_int8(jssm)
    llm = port_int8_im(jllm, max_spec=8)
    ssm = port_int8_im(jssm, cfg=SSM, max_spec=8, topk=2)
    gen = dict(max_new_tokens=8)
    want = JaxSpecInferManager(jllm, jssm, JaxGenerationConfig(**gen),
                               width=2, depth=2).generate(PROMPTS[:2])
    got = SpecInferManager(llm, ssm, GenerationConfig(**gen), width=2,
                           depth=2).generate(PROMPTS[:2])
    assert got == want
    jllm.reset()
    llm.reset()
    assert RequestManager(llm, GenerationConfig(**gen)).generate(
        PROMPTS[:2]) == JaxRequestManager(
            jllm, JaxGenerationConfig(**gen)).generate(PROMPTS[:2])
