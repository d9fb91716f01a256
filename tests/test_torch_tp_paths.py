"""The port's tensor-parallel serve paths vs the JAX package, on the CPU.

Two shards on ``["cpu", "cpu"]`` against the JAX package at ``tp=2`` and
the port at ``tp=1``, greedy, float32, TINY sizes:

* int8 weights (quantized on the global arrays, then sliced) with int8 KV:
  a mixed prefill step's and a decode step's logits within
  ``atol=rtol=1e-5`` of the JAX package's at ``tp=2``, and streams equal
  to the port's at ``tp=1`` (which ``test_torch_int8.py`` holds to the
  JAX package's);
* a paged cache with a shared system prefix: the second session maps the
  first one's pages on both shards, with the prefix index's counters of
  the port at ``tp=1``, and the streams of a contiguous cache;
* the host tier: a preempted request's pages spill with one checksum per
  shard and restore onto both shards, and a corrupt block on shard 1
  fails its shard's checksum and falls back to recompute; the streams are
  the reference's unpreempted ones either way;
* both speculative paths with a tensor-parallel target and a
  tensor-parallel draft, on the weights of ``tests/test_pallas_attention.
  py``'s ``test_tp_spec_infer_with_pallas_kernel`` (the JAX run there
  gives the JAX incremental stream, which the port's must equal);
* OPT (biases after the reduce), Falcon-7B and StarCoder (one KV head:
  replicated attention) and MPT (each shard's slice of the global ALiBi
  slopes): a prefill and a decode step's logits within ``atol=rtol=1e-5``
  of the JAX package's at ``tp=2`` (float32, partial sums added in
  another order) and streams equal to the port's at ``tp=1``, MPT's
  speculative (gather) path too.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu.serve as JS
import flexflow_tpu_torch.serve as PS
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)

from test_serve import TINY, make_im
from test_torch_lifecycle import LONG, reference_streams, tokens_of
from test_torch_spec_serve import _prefill
from test_torch_tiered import serve_spill_restore
from test_torch_tp import jax_int8_tp2, port_cfg, port_im
from test_torch_spec_zoo import DRAFT
from test_torch_zoo import configs, randomize
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
CFG = port_cfg(TINY)
PAGE = 64


def greedy(side=PS, n=8):
    return side.GenerationConfig(max_new_tokens=n)


def _step_logits_match(jim, tim, steps):
    """Each flat batch of ``steps`` through both, the real tokens'
    logits compared."""
    for args in steps:
        n = len(args[0])
        jbc = JaxBatchConfig.build(*args, max_tokens=jim.max_tokens,
                                   max_requests=2)
        tbc = PS.BatchConfig.build(*args, max_tokens=tim.max_tokens,
                                   max_requests=2, device="cpu")
        np.testing.assert_allclose(tim.forward(tbc)[:n].numpy(),
                                   jax_logits(jim, jbc)[:n], **TOL)


def test_int8_weights_and_int8_kv():
    jim = jax_int8_tp2()
    tim = port_im(jim, CFG)
    assert tim.kv.state["model.layers.0.self_attn"]["k"].dtype == torch.int8
    assert tim.model.model.layers[0].mlp.down_proj.kernel.dtype == torch.int8
    _step_logits_match(jim, tim, [
        (PROMPTS[0] + PROMPTS[1][:3], [0] * 5 + [1] * 3,
         list(range(5)) + [0, 1, 2], [5, 3]),
        ([7, 1], [0, 1], [5, 3], [6, 4])])
    tim.reset()
    want = PS.RequestManager(port_im(jim, CFG, tp=1), greedy()).generate(
        PROMPTS)
    assert PS.RequestManager(tim, greedy()).generate(PROMPTS) == want


def test_paged_shared_prefix_on_every_shard():
    jim = make_im(max_seq=128)
    system = LONG[:PAGE + 6]
    sessions = [[system + [5, 9]], [system + [7], system + [3, 4]]]
    want = [PS.RequestManager(port_im(jim, CFG, tp=1), greedy()).generate(s)
            for s in sessions]
    kvs = []
    for tp in (2, 1):
        im = port_im(jim, CFG, tp=tp, kv_page_size=PAGE)
        rm = PS.RequestManager(im, greedy())
        assert [rm.generate(s) for s in sessions] == want
        kvs.append(im.kv)
    two, one = kvs
    assert two.prefix_hits > 0 and two.prefix_tokens_reused >= PAGE
    for name in ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
                 "cow_copies", "pages_mapped"):
        assert getattr(two, name) == getattr(one, name), name
    # each shard's device took its own copy of the table
    assert two.page_view(torch.device("cpu")) is two.page_view()


@pytest.mark.parametrize("corrupt", [False, True], ids=["restore",
                                                          "corrupt"])
def test_host_tier_spill_and_restore_every_shard(corrupt):
    jim = make_im(max_seq=128)
    im = port_im(jim, CFG, kv_page_size=PAGE)
    kv = im.kv
    prompts = [LONG, [2, 4, 6]]
    checked = []

    def after(rm):
        page = kv.host_tier._spills[0].pages[0]
        assert len(page.crc) == 2     # one checksum per shard
        checked.append(page.verify())
        if corrupt:   # the last block is shard 1's
            page.blocks[-1].view(torch.uint8).view(-1)[0] ^= 0xFF
            checked.append(page.verify())

    rm, records = serve_spill_restore(im, greedy(n=10), prompts, after=after)
    assert tokens_of(records) == reference_streams(prompts, 10)
    assert kv.pages_spilled == 2
    assert checked == ([True, False] if corrupt else [True])
    assert (kv.pages_restored, kv.restore_failures) == (
        (0, 1) if corrupt else (1, 0))


@pytest.fixture(scope="module")
def spec_rig():
    """The target and draft of ``test_tp_spec_infer_with_pallas_kernel``
    (JAX, ``tp=2``), the JAX incremental stream its run equals, and the
    port's ``tp=2`` twins."""
    caps = dict(max_tokens=32, max_requests=2, max_seq=64)
    want = JS.RequestManager(make_im(**caps), greedy(JS)).generate(PROMPTS)
    tiny_ssm = JS.ServeModelConfig(
        model_type="llama", vocab_size=TINY.vocab_size, hidden_size=16,
        intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=2)
    jllm = make_im({"tp": 2}, max_spec=8, use_pallas=True, **caps)
    jssm = make_im({"tp": 2}, max_spec=8, cfg=tiny_ssm, topk=2, seed=123,
                   use_pallas=True, **caps)
    return dict(want=want, llm=port_im(jllm, CFG),
                ssm=port_im(jssm, port_cfg(tiny_ssm)))


def test_spec_infer_with_tp_target_and_tp_draft(spec_rig):
    r = spec_rig
    for im in (r["llm"], r["ssm"]):
        im.reset()
        assert im.plan_key == "tp2_pp1_m1"
    sm = PS.SpecInferManager(r["llm"], r["ssm"], greedy(), width=2, depth=2)
    assert sm.generate(PROMPTS) == r["want"]


def test_spec_scan_with_tp_target_and_tp_draft(spec_rig):
    r = spec_rig
    for im in (r["llm"], r["ssm"]):
        im.reset()
    lens = [len(p) for p in PROMPTS]
    firsts = _prefill(r["llm"], PROMPTS)
    _prefill(r["ssm"], PROMPTS)
    sc = PS.SpecDecodeScan(r["llm"], r["ssm"], width=2, depth=2)
    em, _ = sc.run(sc.init_carry(firsts, lens, lens, [False, False],
                                 budget=[7, 7]), 8)
    em = em.numpy()
    got = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1) if t >= 0]
           for i in range(2)]
    assert got == r["want"]


@pytest.mark.parametrize("family", ["opt", "falcon_7b", "starcoder", "mpt"])
def test_family_at_tp2(family):
    jcfg, cfg = configs(family)
    jim = randomize(make_im({"tp": 2}, cfg=jcfg, max_tokens=8,
                            max_requests=2, max_seq=64, use_pallas=False))
    tim = port_im(jim, cfg)
    attn = [m for m in tim.model.modules()
            if isinstance(m, PS.ops.IncMultiHeadSelfAttention)]
    assert all(m.head_sharded == (family not in ("falcon_7b", "starcoder"))
               for m in attn)
    if family == "mpt":   # shard 1 holds the global heads 2 and 3
        glob = PS.ops.alibi_slopes(4)
        s1 = tim.shards[1].transformer.blocks[0].attn.slopes(
            torch.device("cpu"))
        assert torch.equal(s1, glob[2:]) and not torch.equal(
            s1, PS.ops.alibi_slopes(2))
    segs, lens = [(0, PROMPTS[0], 0)], [5]
    jbc, _ = JaxPrefillBatchConfig.build(segs, lens, jim.prefill_tile,
                                         max_tokens=8, max_requests=2)
    tbc, _ = PS.PrefillBatchConfig.build(segs, lens, tim.prefill_tile,
                                         max_tokens=8, max_requests=2,
                                         device="cpu")
    np.testing.assert_allclose(tim.forward(tbc)[:5].numpy(),
                               jax_logits(jim, jbc)[:5], **TOL)
    args = ([7], [0], [5], [6])
    jbc = JaxBatchConfig.build(*args, max_tokens=8, max_requests=2)
    tbc = PS.BatchConfig.build(*args, max_tokens=8, max_requests=2,
                               device="cpu")
    np.testing.assert_allclose(tim.forward(tbc)[:1].numpy(),
                               jax_logits(jim, jbc)[:1], **TOL)
    tim.reset()
    want = PS.RequestManager(port_im(jim, cfg, tp=1), greedy(n=10)
                             ).generate(PROMPTS)
    assert PS.RequestManager(tim, greedy(n=10)).generate(PROMPTS) == want
    if family == "mpt":   # the ALiBi tree steps: the gather path per shard
        jdcfg, dcfg = configs(family, **DRAFT)
        jd = make_im({"tp": 2}, cfg=jdcfg, max_tokens=8, max_requests=2,
                     max_seq=64, seed=3, use_pallas=False)
        spec = dict(max_tokens_per_batch=32, max_spec_tokens=8)
        sm = PS.SpecInferManager(port_im(jim, cfg, **spec),
                                 port_im(jd, dcfg, topk=2, **spec),
                                 greedy(n=10), width=2, depth=2)
        assert sm.generate(PROMPTS) == want
