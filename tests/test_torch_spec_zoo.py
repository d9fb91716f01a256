"""Speculative serving of the port's other model families vs the JAX
package and the port's incremental decoding, on the CPU.

For MPT (ALiBi: its tree steps take the gather path with ``spec_pos``),
OPT, Falcon-7B-style (multi-query, parallel attention) and StarCoder
(multi-query, learned positions), at ``tests/test_torch_zoo.py``'s TINY
size with its randomized norms and biases:

* ``SpecInferManager`` with a narrow draft of the same family and vocab
  (1 layer, hidden 16): greedy streams equal the JAX ``SpecInferManager``'s
  on the same params and the port's incremental streams; with a perfect
  draft (the LLM's own weights, top-1) too, committing several tokens a
  verify pass;
* ``SpecDecodeScan`` with the same two drafts: the incremental streams,
  the perfect draft filling every emit slot;
* MPT on int8 KV in 64-position pages: the host path's streams equal the
  JAX manager's and the incremental ones.

The JAX side runs its gather path (``use_pallas="auto"`` on the CPU).
"""

import pytest

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    InferenceManager,
    RequestManager,
    SpecDecodeScan,
    SpecInferManager,
    build_model,
    params_from_jax,
)

from test_serve import make_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401
from test_torch_spec_serve import _prefill
from test_torch_zoo import configs, params_np, randomize

FAMILIES = ["mpt", "opt", "falcon_7b", "starcoder"]
DRAFT = dict(hidden_size=16, num_attention_heads=2, num_hidden_layers=1,
             intermediate_size=32)
PROMPTS = [[5, 9, 2, 11, 3], [4, 4, 8]]
N_NEW = 10
CAPS = dict(max_tokens=32, max_requests=2, max_seq=64, use_pallas="auto")


def _port(jim, cfg, max_spec=0, topk=0):
    im = InferenceManager(build_model(cfg), max_requests=2,
                          max_tokens_per_batch=32, max_seq_len=64,
                          device="cpu", max_spec_tokens=max_spec, topk=topk)
    return im.init_operators_inference(params_from_jax(params_np(jim), cfg,
                                                       "cpu"))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's JAX LLM and narrow draft, their port twins, the
    perfect draft and the incremental streams."""
    fam = request.param
    jcfg, cfg = configs(fam)
    jdcfg, dcfg = configs(fam, **DRAFT)
    jllm = randomize(make_im(cfg=jcfg, max_spec=8, **CAPS))
    jssm = randomize(make_im(cfg=jdcfg, max_spec=8, topk=2, seed=3,
                             **CAPS), seed=1)
    want = RequestManager(_port(jllm, cfg), GenerationConfig(
        max_new_tokens=N_NEW)).generate(PROMPTS)
    return dict(name=fam, jllm=jllm, jssm=jssm, want=want,
                llm=_port(jllm, cfg, 8), ssm=_port(jssm, dcfg, 8, 2),
                perfect=_port(jllm, cfg, 8, 1))


def test_spec_infer_matches_reference_and_incremental(family):
    f = family
    for k in ("jllm", "jssm", "llm", "ssm"):
        f[k].reset()
    got = SpecInferManager(f["llm"], f["ssm"], GenerationConfig(
        max_new_tokens=N_NEW), width=2, depth=2).generate(PROMPTS)
    want_jax = JaxSpecInferManager(f["jllm"], f["jssm"], JaxGenerationConfig(
        max_new_tokens=N_NEW), width=2, depth=2).generate(PROMPTS)
    assert got == want_jax == f["want"]
    f["llm"].reset()
    sm = SpecInferManager(f["llm"], f["perfect"], GenerationConfig(
        max_new_tokens=N_NEW), width=1, depth=3)
    assert sm.generate(PROMPTS) == f["want"]
    assert (sm.tokens_decoded - len(PROMPTS)) / sm.llm_steps > 1


def test_spec_scan_matches_incremental(family):
    f = family
    lens = [len(p) for p in PROMPTS]
    for ssm, width, depth, n_macro in ((f["ssm"], 2, 2, N_NEW),
                                       (f["perfect"], 1, 3, 3)):
        f["llm"].reset()
        ssm.reset()
        firsts = _prefill(f["llm"], PROMPTS)
        _prefill(ssm, PROMPTS)
        sc = SpecDecodeScan(f["llm"], ssm, width=width, depth=depth)
        em, _ = sc.run(sc.init_carry(firsts, lens, lens, [False, False],
                                     budget=[N_NEW - 1] * 2), n_macro)
        em = em.numpy()
        got = [[firsts[r]] + [int(t) for t in em[:, r].reshape(-1) if t >= 0]
               for r in range(2)]
        assert got == f["want"], f["name"]
        if ssm is f["perfect"]:   # depth+1 a step until the budget cuts
            assert (em[:2] >= 0).all(), em


def test_mpt_spec_on_int8_paged_kv():
    """MPT's gather path reads int8 K/V through 64-position pages (a
    57-token prompt crosses one): the narrow-draft ``SpecInferManager``'s
    streams equal the JAX manager's on the same caches and the port's
    incremental ones."""
    jcfg, cfg = configs("mpt")
    jdcfg, dcfg = configs("mpt", **DRAFT)
    kw = dict(CAPS, max_seq=128, kv_dtype="int8", kv_page_size=64)
    jllm = randomize(make_im(cfg=jcfg, max_spec=8, **kw))
    jssm = randomize(make_im(cfg=jdcfg, max_spec=8, topk=2, seed=3, **kw),
                     seed=1)

    def port(jim, c, max_spec=0, topk=0):
        im = InferenceManager(build_model(c), max_requests=2,
                              max_tokens_per_batch=32, max_seq_len=128,
                              device="cpu", max_spec_tokens=max_spec,
                              topk=topk, kv_dtype="int8", kv_page_size=64)
        return im.init_operators_inference(params_from_jax(params_np(jim), c,
                                                           "cpu"))

    prompts = [list(range(3, 60)), PROMPTS[1]]
    gen = GenerationConfig(max_new_tokens=12)
    want = RequestManager(port(jllm, cfg), gen).generate(prompts)
    got = SpecInferManager(port(jllm, cfg, 8), port(jssm, dcfg, 8, 2), gen,
                           width=2, depth=2).generate(prompts)
    assert got == want
    assert got == JaxSpecInferManager(jllm, jssm, JaxGenerationConfig(
        max_new_tokens=12), width=2, depth=2).generate(prompts)
