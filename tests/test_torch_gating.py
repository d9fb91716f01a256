"""The port's LM-head gating vs its ungated path and the JAX serve stack,
on the CPU (after ``tests/test_prefill_gating.py``).

A gated prefill chunk gathers the completing prompts' last hidden rows
before the LM head and computes ``[max_requests, vocab]`` logits, indexed
by slot.  The gathered rows' logits come from a product of another row
count than the ungated ``[max_tokens, vocab]`` one, whose sums may round
in another order, so these tests do NOT require bit identity of the
logits: float32 ``atol=rtol=1e-6`` against the ungated step, token ids
equal, caches equal bit for bit (gating is after attention), and
``atol=rtol=1e-5`` against the JAX package's gated step (as
``test_torch_serve.py``).  Greedy streams are equal: gated == ungated ==
the JAX package's gated streams.

The JAX side is ``test_serve.make_im`` with its Pallas kernels in
interpret mode (the gated path there is the tiled one); its params reach
the port through ``params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ServeModelConfig as JaxServeModelConfig
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
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

from test_serve import TINY, make_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401

GATE_TOL = dict(atol=1e-6, rtol=1e-6)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)
CFG = ServeModelConfig(**dataclasses.asdict(TINY))
PROMPT = [5, 9, 2, 11, 3]
PROMPTS = [[5, 9, 2, 11, 3, 7, 1, 4, 9, 13], [4, 4, 8]]
FAMILY_CFG = dict(vocab_size=67, hidden_size=32, intermediate_size=48,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=64)


def jax_im(cfg=TINY, **kw):
    args = dict(max_tokens=8, max_requests=2, max_seq=64, use_pallas=True)
    args.update(kw)
    return make_im(cfg=cfg, **args)


def port_im(jim, cfg=CFG, **kw):
    """A port manager (CPU) with the JAX manager's params and
    capacities."""
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    im = InferenceManager(build_model(cfg), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu",
                          topk=jim.topk, **kw)
    return im.init_operators_inference(params_from_jax(params, cfg, "cpu"))


def chunk(im, gate, prompt=PROMPT):
    """One prefill chunk of ``prompt`` in slot 0, gated or not."""
    return PrefillBatchConfig.build(
        [(0, prompt, 0)], [len(prompt)], im.prefill_tile,
        max_tokens=im.max_tokens, max_requests=im.max_requests,
        device="cpu", gate_slots=[0] if gate else None)


def caches(im):
    return {n: {k: v.clone() for k, v in b.items()}
            for n, b in im.state.items()}


def gated_vs_ungated(im, prepare=lambda: None):
    """The ungated and the gated step of one chunk (``prepare`` runs
    before each: a paged cache maps its pages); the sample point's
    results must agree and the caches be equal."""
    prepare()
    pbc_u, last = chunk(im, False)
    r_u = im.step(pbc_u)
    cache_u = caches(im)
    im.reset()
    prepare()
    pbc_g, last_g = chunk(im, True)
    assert last_g == last
    assert pbc_g.logit_slots.tolist() == [last[0], -1]
    r_g = im.step(pbc_g)
    assert r_g.token_ids.shape[0] == im.max_requests   # indexed by slot
    fu = last[0]
    assert int(r_g.token_ids[0]) == int(r_u.token_ids[fu])
    torch.testing.assert_close(r_g.logits[0], r_u.logits[fu], **GATE_TOL)
    torch.testing.assert_close(r_g.logits_max[0], r_u.logits_max[fu],
                               **GATE_TOL)
    if im.topk:
        assert r_g.topk_ids[0].tolist() == r_u.topk_ids[fu].tolist()
        torch.testing.assert_close(r_g.topk_logprobs[0],
                                   r_u.topk_logprobs[fu], **GATE_TOL)
    for n, b in im.state.items():   # gating is after attention
        for k, v in b.items():
            assert torch.equal(v, cache_u[n][k]), (n, k)
    return r_g


def test_gated_step_matches_full_logits_and_jax():
    """A gated chunk vs the same chunk ungated (tolerance, not bit
    identity: see the module docstring), and vs the JAX package's gated
    step."""
    jim = jax_im(topk=4)
    tim = port_im(jim)
    assert tim.gate_lm_head
    r_g = gated_vs_ungated(tim)
    jim.allocate_kv_cache()
    jbc, _ = JaxPrefillBatchConfig.build(
        [(0, PROMPT, 0)], [len(PROMPT)], jim.prefill_tile, max_tokens=8,
        max_requests=2, gate_slots=[0])
    np.testing.assert_allclose(r_g.logits[0].numpy(),
                               jax_logits(jim, jbc)[0],
                               **JAX_TOL)


def test_gated_step_int8_kv():
    """int8 KV: gating is downstream of the quantize-on-write attention,
    so the int8 values and the f32 scales are equal too."""
    tim = port_im(jax_im(), kv_dtype="int8")
    gated_vs_ungated(tim)


def test_gated_step_paged():
    """A paged cache (64-position pages) gates the same way."""
    tim = port_im(jax_im(max_seq=128), kv_page_size=64)

    def prepare():
        tim.kv.bind(0, slot=0)
        tim.kv.prepare_write(0, 0, len(PROMPT))

    gated_vs_ungated(tim, prepare)


def serve(im, gate, gen, prompts=PROMPTS):
    im.reset()
    im.gate_lm_head = gate
    try:
        return RequestManager(im, gen).generate(prompts)
    finally:
        im.gate_lm_head = True


def test_gated_streams_match_ungated_and_jax():
    """Multi-chunk prefill stretches then decode: gated == ungated == the
    JAX package's gated streams (greedy)."""
    jim = jax_im()
    assert jim.gate_lm_head
    want = JaxRequestManager(jim, JaxGenerationConfig(
        max_new_tokens=4)).generate(PROMPTS)
    tim = port_im(jim)
    gen = GenerationConfig(max_new_tokens=4)
    assert serve(tim, True, gen) == serve(tim, False, gen) == want


def test_gated_seeded_streams_match_ungated():
    """Seeded sampling: a gated chunk's sample folds sit at the slot's
    row, an ungated one's at the flat token's; the draws are equal."""
    tim = port_im(jax_im())
    gen = GenerationConfig(max_new_tokens=5, temperature=0.9, top_p=0.9,
                           seed=4)
    assert serve(tim, True, gen) == serve(tim, False, gen)


def test_gated_streams_paged_and_int8():
    """int8 KV on 64-position pages: gated == ungated streams."""
    tim = port_im(jax_im(max_seq=128), kv_dtype="int8", kv_page_size=64)
    gen = GenerationConfig(max_new_tokens=4)
    assert serve(tim, True, gen) == serve(tim, False, gen)


def test_mixed_decode_prefill_step_is_never_gated():
    """A request arriving mid-decode forces mixed flat steps (never gated)
    between gated pure-prefill steps; the streams equal the ungated run
    and the JAX package's gated run."""
    late = [(i % 7) + 1 for i in range(19)]

    def run(rm, step, is_prefill, is_flat, gate):
        rm.register_new_request([3, 11, 25, 40])
        bc, pts = rm.prepare_next_batch()
        assert is_prefill(bc)
        assert (getattr(bc, "logit_slots", None) is not None) == gate
        rm.process_result(step(bc), pts)
        rid_b = rm.register_new_request(late)
        saw_mixed = False
        while rm.has_work():
            bc, pts = rm.prepare_next_batch()
            if is_flat(bc):
                saw_mixed = True
                assert getattr(bc, "logit_slots", None) is None
            rm.process_result(step(bc), pts)
        assert saw_mixed
        return [rm.requests[r].generated for r in (0, rid_b)]

    jim = jax_im()
    want = run(JaxRequestManager(jim, JaxGenerationConfig(max_new_tokens=6)),
               jim.step, lambda b: isinstance(b, JaxPrefillBatchConfig),
               lambda b: isinstance(b, JaxBatchConfig), True)
    tim = port_im(jim)
    got = {}
    for gate in (True, False):
        tim.reset()
        tim.gate_lm_head = gate
        got[gate] = run(RequestManager(tim, GenerationConfig(
            max_new_tokens=6)), tim.step,
            lambda b: isinstance(b, PrefillBatchConfig),
            lambda b: isinstance(b, BatchConfig), gate)
    tim.gate_lm_head = True
    assert got[True] == got[False] == want


def test_gated_build_contract():
    """``build(gate_slots=)`` and ``np_logit_slots`` as the reference's
    (``tests/test_prefill_gating.py::test_gated_build_contract``)."""
    segs = [(0, [1, 2, 3], 0), (1, [4, 5, 6, 7, 8], 12)]
    pbc, last = PrefillBatchConfig.build(
        segs, [3, 17], tile_size=4, max_tokens=16, max_requests=4,
        device="cpu", gate_slots=[1])
    jpbc, jlast = JaxPrefillBatchConfig.build(
        segs, [3, 17], tile_size=4, max_tokens=16, max_requests=4,
        gate_slots=[1])
    assert last == jlast
    assert pbc.logit_slots.tolist() == np.asarray(
        jpbc.logit_slots).tolist() == [-1, last[1], -1, -1]
    assert pbc.logit_slots.dtype == torch.int32
    assert PrefillBatchConfig.np_logit_slots([0, 1], last, 4).tolist() == [
        last[0], last[1], -1, -1]
    ungated, _ = PrefillBatchConfig.build(
        [(0, [1, 2, 3], 0)], [3], tile_size=4, max_tokens=16,
        max_requests=4, device="cpu")
    assert ungated.logit_slots is None


@pytest.mark.parametrize("model_type",
                         ["llama", "opt", "mpt", "gpt_bigcode", "falcon"])
def test_family_gates_where_the_reference_marks(model_type):
    """Each family's LM head is gated exactly where the JAX manager marks
    it (``mark_gated_lm_head``), and its gated chunk matches the
    ungated one."""
    fields = dict(FAMILY_CFG, model_type=model_type)
    jim = make_im(cfg=JaxServeModelConfig(**fields), max_tokens=8,
                  max_requests=2, max_seq=64, use_pallas=True)
    tim = port_im(jim, cfg=ServeModelConfig(**fields))
    assert tim.gate_lm_head == jim.gate_lm_head
    gated_vs_ungated(tim)


def test_gate_flag_toggles_and_prefill_overlap_is_a_no_op():
    """``gate_lm_head`` is read when a batch is built: off, the tiled
    chunks carry no ``logit_slots``; ``prefill_overlap`` True and False
    give identical streams and caches."""
    jim = jax_im()
    tim = port_im(jim)
    tim.gate_lm_head = False
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=2))
    rm.register_new_request(PROMPT)
    bc, _ = rm.prepare_next_batch()
    assert isinstance(bc, PrefillBatchConfig) and bc.logit_slots is None
    tim.gate_lm_head = True
    assert tim.gate_lm_head
    outs, cache = {}, {}
    for overlap in (True, False):
        im = port_im(jim, prefill_overlap=overlap)
        outs[overlap] = RequestManager(im, GenerationConfig(
            max_new_tokens=4)).generate(PROMPTS)
        cache[overlap] = caches(im)
    assert outs[True] == outs[False]
    for n, b in cache[True].items():
        for k, v in b.items():
            assert torch.equal(v, cache[False][n][k])
