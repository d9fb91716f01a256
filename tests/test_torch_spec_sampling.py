"""The port's seeded speculative sampling vs its greedy and incremental
paths and the JAX serve stack, on the CPU (after
``tests/test_spec_sampling.py``).

* Temperature 0 and a tiny temperature (1e-4: the draws are the argmax)
  give the greedy streams on both speculative paths, which equal the JAX
  package's greedy streams on the same params.
* Seeded runs repeat exactly and another seed changes them.
* The host path's sampled streams equal the port's sampled incremental
  streams in float32, token for token: a verify row at tree depth d of
  request rid draws with the key (seed, rid, ``len(generated) + d``) the
  incremental loop uses for that token.  With a perfect draft (the LLM's
  own weights) drafted tokens are accepted, so rows below the root draw
  too.
* The device path (``SpecDecodeScan``) folds its key per macro step
  (``macro_ctr`` in the carry): two windows equal one window of the same
  length; its sampled streams are seeded, not the incremental path's.
"""

import numpy as np
import pytest

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu.serve.spec_scan import SpecDecodeScan as JaxSpecDecodeScan
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    RequestManager,
    SpecDecodeScan,
    SpecInferManager,
)

from test_serve import make_im
from test_spec_scan import prefill as jax_prefill
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import JAX_SSM, SSM, _one_thread, port_im  # noqa: F401
from test_torch_spec_serve import _prefill

PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
N_MACRO = 6


@pytest.fixture(scope="module")
def rig():
    """The JAX LLM and SSM, their port twins, a perfect draft (the LLM's
    weights, top-2) and a port incremental manager."""
    jllm = make_im(max_tokens=32, max_requests=2, max_seq=96, max_spec=8)
    jssm = make_im(max_tokens=32, max_requests=2, max_seq=96, max_spec=8,
                   cfg=JAX_SSM, topk=2, seed=123)
    return dict(jllm=jllm, jssm=jssm, llm=port_im(jllm, max_spec=8),
                ssm=port_im(jssm, cfg=SSM, max_spec=8, topk=2),
                perfect=port_im(jllm, max_spec=8, topk=2),
                incr=port_im(jllm))


def scan_emitted(rig, sample, windows=(N_MACRO,)):
    """Emissions of ``SpecDecodeScan`` windows after a flat prefill."""
    llm, ssm = rig["llm"], rig["ssm"]
    llm.reset()
    ssm.reset()
    firsts = _prefill(llm, PROMPTS)
    _prefill(ssm, PROMPTS)
    sc = SpecDecodeScan(llm, ssm, width=2, depth=2)
    lens = [len(p) for p in PROMPTS]
    carry = sc.init_carry(firsts, lens, lens, [False] * len(PROMPTS))
    ems = []
    for n in windows:
        em, carry = sc.run(carry, n, sample=sample)
        ems.append(em.numpy())
    return np.concatenate(ems)


def jax_scan_greedy(rig):
    jllm, jssm = rig["jllm"], rig["jssm"]
    jllm.reset()
    jssm.reset()
    firsts = jax_prefill(jllm, PROMPTS)
    jax_prefill(jssm, PROMPTS)
    sc = JaxSpecDecodeScan(jllm, jssm, width=2, depth=2)
    lens = [len(p) for p in PROMPTS]
    em, _ = sc.run(sc.init_carry(firsts, lens, lens, [False] * 2), N_MACRO)
    return np.asarray(em)


def spec(rig, gen, draft="ssm"):
    rig["llm"].reset()
    rig[draft].reset()
    sm = SpecInferManager(rig["llm"], rig[draft], gen, width=2, depth=2)
    return sm.generate(PROMPTS), sm


def incremental(rig, gen):
    rig["incr"].reset()
    return RequestManager(rig["incr"], gen).generate(PROMPTS)


@pytest.mark.parametrize("temperature", [0.0, 1e-4])
def test_scan_low_temperature_equals_greedy(rig, temperature):
    greedy = scan_emitted(rig, None)
    np.testing.assert_array_equal(greedy, jax_scan_greedy(rig))
    np.testing.assert_array_equal(
        scan_emitted(rig, (5, temperature, 1.0)), greedy)


def test_scan_sampling_is_seeded(rig):
    a = scan_emitted(rig, (7, 2.0, 1.0))
    np.testing.assert_array_equal(a, scan_emitted(rig, (7, 2.0, 1.0)))
    assert (a != scan_emitted(rig, (8, 2.0, 1.0))).any()
    assert (a != scan_emitted(rig, None)).any()


def test_scan_windows_never_replay_a_key(rig):
    """The macro-step counter rides in the carry: windows of 2 and 4
    macro steps draw what one window of 6 draws."""
    np.testing.assert_array_equal(
        scan_emitted(rig, (3, 1.5, 0.9), windows=(2, 4)),
        scan_emitted(rig, (3, 1.5, 0.9)))


@pytest.mark.parametrize("temperature", [0.0, 1e-4])
def test_host_spec_low_temperature_equals_greedy(rig, temperature):
    rig["jllm"].reset()
    rig["jssm"].reset()
    want = JaxSpecInferManager(rig["jllm"], rig["jssm"], JaxGenerationConfig(
        max_new_tokens=8), width=2, depth=2).generate(PROMPTS)
    got, _ = spec(rig, GenerationConfig(max_new_tokens=8,
                                        temperature=temperature, seed=3))
    assert got == want


@pytest.mark.parametrize("draft,temperature,top_p,seed", [
    ("ssm", 0.8, 0.9, 11), ("perfect", 0.8, 0.9, 11),
    ("perfect", 2.0, 1.0, 4)])
def test_host_spec_sampled_equals_sampled_incremental(rig, draft,
                                                      temperature, top_p,
                                                      seed):
    """float32: every token equal to the incremental loop's draw."""
    gen = GenerationConfig(max_new_tokens=10, temperature=temperature,
                           top_p=top_p, seed=seed)
    got, sm = spec(rig, gen, draft)
    assert got == incremental(rig, gen)
    if draft == "perfect":   # drafted tokens were accepted
        assert sm.tokens_decoded - len(PROMPTS) > sm.llm_steps - 1


def test_host_spec_sampling_is_seeded(rig):
    gen = GenerationConfig(max_new_tokens=8, temperature=2.0, seed=11)
    a, _ = spec(rig, gen)
    b, _ = spec(rig, GenerationConfig(max_new_tokens=8, temperature=2.0,
                                      seed=11))
    assert a == b
    assert all(len(s) == 8 and all(0 <= t < 67 for t in s) for s in a)
    c, _ = spec(rig, GenerationConfig(max_new_tokens=8, temperature=2.0,
                                      seed=12))
    assert a != c


def test_greedy_path_unaffected(rig):
    """Greedy runs after sampled ones: the scan repeats itself and the
    host path equals incremental decoding."""
    scan_emitted(rig, (7, 2.0, 1.0))
    np.testing.assert_array_equal(scan_emitted(rig, None),
                                  scan_emitted(rig, None))
    gen = GenerationConfig(max_new_tokens=8)
    assert spec(rig, gen)[0] == incremental(rig, gen)
