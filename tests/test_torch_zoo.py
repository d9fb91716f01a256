"""The port's other model families vs the JAX serve stack, on the CPU.

OPT (pre-LN, and opt-350m-style post-LN with ``project_in/out``),
Falcon-7B-style (parallel attention, multi-query, RoPE), Falcon-RW (biased,
ALiBi), MPT (ALiBi) and StarCoder (multi-query, learned positions), at the
TINY size of ``tests/test_serve.py`` (2 layers, hidden 32, 4 heads, vocab
67, ``max_seq_len`` 64), plus two multi-query configurations with 8 and 12
query heads on one KV head (hidden 64 and 96, head dim 8), which the
decode kernel serves in chunks of 8 heads.  The JAX side is
``test_serve.make_im`` with the Pallas kernels in interpret mode
(``use_pallas=True``: an ALiBi model's decode and prefill go through the
Pallas decode kernel with slopes); its params, with every norm gain, norm
shift and bias drawn at random (the JAX initializer sets them to 1 and 0),
reach the port through ``params_from_jax``.

* a prefill step's and a decode step's logits within ``atol=rtol=1e-5``
  (float32, the same math in another order);
* greedy ``RequestManager.generate`` streams (2 prompts of different
  lengths, 8 new tokens) identical to the JAX ``RequestManager``'s (the
  families; the two large-group configurations compare step logits);
* MPT on int8 KV with 64-position pages, and with int8 weights too:
  identical greedy streams, and the paged run equal to the contiguous one
  bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ServeModelConfig as JaxServeModelConfig
from flexflow_tpu.serve import quantize_int8 as jax_quantize_int8
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    PrefillBatchConfig,
    RequestManager,
    ServeModelConfig,
    build_model,
    params_from_jax,
)

from test_serve import make_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(vocab_size=67, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
FAMILIES = {
    "opt": dict(model_type="opt"),
    "opt_post_ln": dict(model_type="opt", do_layer_norm_before=False,
                        word_embed_proj_dim=16),
    "falcon_7b": dict(model_type="falcon", parallel_attn=True,
                      num_key_value_heads=1),
    "falcon_rw": dict(model_type="falcon", bias=True, use_alibi=True),
    "mpt": dict(model_type="mpt"),
    "starcoder": dict(model_type="gpt_bigcode", num_key_value_heads=1),
    # 8 and 12 query heads per KV head: one chunk, and a masked tail chunk
    "falcon_7b_gq8": dict(model_type="falcon", parallel_attn=True,
                          num_key_value_heads=1, hidden_size=64,
                          num_attention_heads=8),
    "mpt_gq12": dict(model_type="mpt", num_key_value_heads=1,
                     hidden_size=96, num_attention_heads=12),
}
# 2 prompts of different lengths, prefilled in one chunk (the MPT cache
# test's 66-token prompt spans nine)
PROMPTS = [[5, 9, 2, 11, 3], [4, 4, 8]]


def configs(family, **kw):
    fields = {**BASE, **FAMILIES[family], **kw}
    return JaxServeModelConfig(**fields), ServeModelConfig(**fields)


def randomize(jim, seed=0):
    """Draw the JAX manager's norm gains, shifts and biases at random (its
    initializer makes them 1 and 0, which would hide a misplaced one)."""
    rng = np.random.default_rng(seed)
    for group in jim.params.values():
        for name, arr in group.items():
            if name in ("gamma", "beta", "bias", "qkv_bias", "o_bias"):
                noise = 0.2 * rng.normal(size=arr.shape)
                group[name] = jnp.asarray(
                    noise + (1.0 if name == "gamma" else 0.0), arr.dtype)
    return jim


def jax_im(family, seed=0, **kw):
    jcfg, _ = configs(family)
    args = dict(max_tokens=8, max_requests=2, max_seq=64, use_pallas=True)
    args.update(kw)
    return randomize(make_im(cfg=jcfg, **args), seed)


def params_np(jim):
    return {n: {k: np.asarray(v) for k, v in g.items()}
            for n, g in jim.params.items()}


def port_im(jim, family, kv_dtype=None, page=None):
    """A port manager (CPU) with the JAX manager's params and capacities."""
    _, cfg = configs(family)
    im = InferenceManager(build_model(cfg), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu",
                          kv_dtype=kv_dtype, kv_page_size=page)
    return im.init_operators_inference(params_from_jax(params_np(jim), cfg,
                                                       "cpu"))


def _step_logits_match(jim, tim):
    """A tiled prefill step, then a decode step: the logits of the real
    tokens."""
    segs, lens = [(0, PROMPTS[0], 0)], [5]
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
                                   jax_logits(jim, jb)[:real], **TOL)


@pytest.mark.parametrize("family", [f for f in FAMILIES if "_gq" not in f])
def test_family_matches_reference(family):
    """Step logits and greedy streams of the port equal the JAX
    package's."""
    jim = jax_im(family)
    tim = port_im(jim, family)
    _step_logits_match(jim, tim)
    tim.reset()
    jim.allocate_kv_cache()
    gen = dict(max_new_tokens=8)
    want = JaxRequestManager(jim, JaxGenerationConfig(**gen)).generate(
        PROMPTS)
    got = RequestManager(tim, GenerationConfig(**gen)).generate(PROMPTS)
    assert got == want


@pytest.mark.parametrize("family", ["falcon_7b_gq8", "mpt_gq12"])
def test_large_group_step_logits_match_reference(family):
    """8 and 12 query heads on one KV head (the decode kernel's chunk of 8,
    and a chunk with a masked tail; RoPE and ALiBi)."""
    jim = jax_im(family)
    _step_logits_match(jim, port_im(jim, family))


@pytest.mark.parametrize("int8_weights", [False, True])
def test_mpt_int8_paged_kv_matches_reference(int8_weights):
    """MPT on int8 KV with 64-position pages: the port's stream equals the
    JAX manager's with the same settings, and the port's paged run equals
    its contiguous run bit for bit; ALiBi K1 launches in no other way on
    the CPU (the plain versions run)."""
    jim = jax_im("mpt", max_seq=128, kv_dtype="int8", kv_page_size=64)
    if int8_weights:
        assert jax_quantize_int8(jim) > 0
    gen = dict(max_new_tokens=8)
    prompts = [list(range(3, 66)) + [7, 9, 11], [4, 4, 8, 50]]  # 66: 2 pages
    want = JaxRequestManager(jim, JaxGenerationConfig(**gen)).generate(
        prompts)
    paged = port_im(jim, "mpt", kv_dtype="int8", page=64)
    if int8_weights:
        assert paged.model.lm_head.kernel.dtype == torch.int8
    assert paged.state["transformer.blocks.0.attn"]["k"].dtype == torch.int8
    n0 = att.decode_attention.launches
    got = RequestManager(paged, GenerationConfig(**gen)).generate(prompts)
    assert got == want
    assert att.decode_attention.launches == n0
    contiguous = port_im(jim, "mpt", kv_dtype="int8")
    assert RequestManager(contiguous, GenerationConfig(**gen)).generate(
        prompts) == got
    # step logits over a prompt crossing a page boundary: bit for bit
    logits = []
    for im in (paged, contiguous):
        im.reset()
        p = prompts[0]
        im.kv.bind(0, slot=0, tokens=p)
        im.kv.prepare_write(0, 0, len(p))
        for lo in range(0, len(p), im.max_tokens):
            chunk = p[lo: lo + im.max_tokens]
            out = im.forward(BatchConfig.build(
                chunk, [0] * len(chunk), list(range(lo, lo + len(chunk))),
                [lo + len(chunk), 0], max_tokens=im.max_tokens,
                max_requests=2, device="cpu"))
        logits.append(out)
    assert torch.equal(logits[0], logits[1])


def test_falcon_new_decoder_architecture_is_refused():
    _, cfg = configs("falcon_7b")
    with pytest.raises(NotImplementedError, match="new_decoder"):
        build_model(dataclasses.replace(cfg, new_decoder_architecture=True))


@pytest.mark.parametrize("family", ["opt", "starcoder"])
def test_quantize_int8_covers_what_the_reference_does(family):
    """Every Linear kernel and the attention ``qkv``/``o_proj`` go int8, as
    in the reference; biases, norms and the embedding tables stay float,
    and the port's int8 weights and scales are the reference's."""
    from flexflow_tpu_torch.serve import quantize_int8

    jim = jax_im(family)
    tim = port_im(jim, family)
    n = quantize_int8(tim)
    assert n == jax_quantize_int8(jim)
    want = params_from_jax(params_np(jim), configs(family)[1], "cpu")
    got = dict(tim.model.named_parameters())
    assert got.keys() == want.keys()
    for name, p in got.items():
        assert p.dtype == want[name].dtype, name
        torch.testing.assert_close(p, want[name], atol=0, rtol=0)
    assert {name.rsplit(".", 1)[1] for name, p in got.items()
            if p.dtype != torch.int8 and not name.endswith("_scale")} == \
        {"weight", "gamma", "beta", "bias", "qkv_bias", "o_bias"}
