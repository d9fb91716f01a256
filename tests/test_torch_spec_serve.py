"""The port's SpecInfer serving loops vs the JAX serve stack and the
port's incremental decoding, on the CPU (kernel and tree steps:
``test_torch_spec.py``).

Greedy streams: the port's ``SpecInferManager`` == the JAX
``SpecInferManager`` == the port's ``RequestManager``, and the port's
``SpecDecodeScan`` == the port's ``RequestManager``, token for token, on
the TINY Llama of ``test_serve.make_im`` with params carried across by
``params_from_jax``.
"""

import pathlib
import sys

import numpy as np
import pytest

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    RequestManager,
    SpecDecodeScan,
    SpecInferManager,
)
from flexflow_tpu_torch.serve.spec_scan import EXIT_BUDGET, EXIT_EOS

from test_serve import make_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import JAX_SSM, SSM, _one_thread, port_im  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8], [33, 1, 60]]


# ---------------------------------------------------------------------------
# SpecInferManager: greedy streams
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rigs():
    """Module-scoped managers (caches reset per use): the JAX LLM + SSM,
    their port twins, and a port incremental manager."""
    jllm = make_im(max_tokens=32, max_requests=2, max_seq=64, max_spec=8)
    jssm = make_im(max_tokens=32, max_requests=2, max_seq=64, max_spec=8,
                   cfg=JAX_SSM, topk=2, seed=123)
    return dict(jllm=jllm, jssm=jssm,
                llm=port_im(jllm, max_spec=8),
                ssm=port_im(jssm, cfg=SSM, max_spec=8, topk=2),
                incr=port_im(jllm))


def _incr(rigs, n_new=10, prompts=PROMPTS, eos=None):
    rigs["incr"].reset()
    return RequestManager(rigs["incr"], GenerationConfig(
        max_new_tokens=n_new, eos_token_id=eos)).generate(prompts)


def _spec(rigs, width, depth, n_new=10, prompts=PROMPTS, eos=None):
    for k in ("jllm", "jssm", "llm", "ssm"):
        rigs[k].reset()
    jsm = JaxSpecInferManager(
        rigs["jllm"], rigs["jssm"],
        JaxGenerationConfig(max_new_tokens=n_new, eos_token_id=eos),
        width=width, depth=depth)
    sm = SpecInferManager(rigs["llm"], rigs["ssm"], GenerationConfig(
        max_new_tokens=n_new, eos_token_id=eos), width=width, depth=depth)
    return sm.generate(prompts), jsm.generate(prompts), sm


@pytest.mark.parametrize("width,depth", [(1, 1), (2, 2), (2, 3), (1, 5)])
def test_spec_infer_matches_reference_and_incremental(rigs, width, depth):
    got, want_jax, sm = _spec(rigs, width, depth)
    assert got == want_jax
    assert got == _incr(rigs)
    assert sm.macro_steps > 0 and sm.llm_steps >= sm.macro_steps
    assert sm.tokens_decoded == sum(len(g) for g in got)
    assert sm.llm.kv.attributed_rids() == [] == sm.ssm.kv.attributed_rids()


def test_spec_infer_with_eos(rigs):
    base = _incr(rigs)
    eos = base[0][2]   # the third token of request 0
    got, want_jax, _ = _spec(rigs, 2, 3, eos=eos)
    assert got == want_jax == _incr(rigs, eos=eos)
    assert got[0] == base[0][: base[0].index(eos) + 1]


def test_perfect_draft_commits_several_tokens_per_llm_pass(rigs):
    """SSM == LLM (same weights, top-1): every chain drafts the LLM's own
    argmax, so each verify pass commits depth+1 tokens."""
    n_new = 12
    llm = port_im(rigs["jllm"], max_spec=8)
    ssm = port_im(rigs["jllm"], max_spec=8, topk=1)
    sm = SpecInferManager(llm, ssm, GenerationConfig(max_new_tokens=n_new),
                          width=1, depth=3)
    got = sm.generate([PROMPTS[0]])
    assert got == _incr(rigs, n_new, [PROMPTS[0]])
    # the first token comes from the prefill, the other 11 from
    # ceil(11 / 4) = 3 verify passes
    assert sm.llm_steps == 3
    assert (sm.tokens_decoded - 1) / sm.llm_steps > 1


def test_capacity_validation_and_sampling_raise(rigs):
    llm, ssm = rigs["llm"], rigs["ssm"]
    with pytest.raises(ValueError, match="spec buffers too small"):
        SpecInferManager(llm, ssm, width=3, depth=3)    # tree 10 > 8 slots
    with pytest.raises(ValueError, match="topk"):
        SpecInferManager(llm, ssm, width=3, depth=2)    # SSM top-2 < width 3
    with pytest.raises(ValueError, match="spec buffers too small"):
        SpecDecodeScan(llm, ssm, width=2, depth=4)
    # seeded sampling is accepted on both paths (test_torch_spec_sampling)
    assert SpecInferManager(llm, ssm, GenerationConfig(
        temperature=0.7)).gen.temperature == 0.7
    sc = SpecDecodeScan(llm, ssm, width=2, depth=2)
    carry = sc.init_carry([1, 2], [5, 4], [5, 4], [False, False])
    with pytest.raises(ValueError, match="max_seq_len"):
        sc.run(carry, 20, sample=(0, 0.7, 1.0))   # checked before any work
    with pytest.raises(ValueError, match="max_seq_len"):
        sc.run(carry, 20)      # 5 + 20*3 + 2 > 64
    # a request that cannot fit depth+1 positions of headroom
    sm = SpecInferManager(llm, ssm, width=2, depth=3)
    with pytest.raises(ValueError, match="max_seq_len"):
        sm.register_new_request(list(range(1, 50)), 12)   # 49+12+4 > 64


# ---------------------------------------------------------------------------
# SpecDecodeScan: greedy streams
# ---------------------------------------------------------------------------
def _prefill(im, prompts):
    """A flat prompt prefill; the first generated token per slot."""
    toks, reqi, pos = [], [], []
    for r, p in enumerate(prompts):
        toks += p
        reqi += [r] * len(p)
        pos += list(range(len(p)))
    ids = im.step(BatchConfig.build(
        toks, reqi, pos, [len(p) for p in prompts], max_tokens=im.max_tokens,
        max_requests=im.max_requests, device="cpu")).token_ids
    ends = np.cumsum([len(p) for p in prompts]) - 1
    return [int(ids[e]) for e in ends]


def _scan(rigs, width, depth, n_macro, prompts, eos=None, budget=None,
          llm=None, ssm=None):
    llm = llm or rigs["llm"]
    ssm = ssm or rigs["ssm"]
    llm.reset()
    ssm.reset()
    firsts = _prefill(llm, prompts)
    _prefill(ssm, prompts)
    sc = SpecDecodeScan(llm, ssm, width=width, depth=depth, eos_token_id=eos)
    lens = [len(p) for p in prompts]
    carry = sc.init_carry(firsts, lens, lens, [False] * len(prompts),
                          budget=budget)
    n0 = att.tree_attention_batched.launches
    em, carry = sc.run(carry, n_macro)
    assert att.tree_attention_batched.launches == n0   # CPU: plain version
    em = em.numpy()
    streams = [[firsts[r]] + [int(t) for t in em[:, r].reshape(-1) if t >= 0]
               for r in range(len(prompts))]
    return streams, em, carry


@pytest.mark.parametrize("width,depth", [(1, 3), (2, 2)])
def test_spec_scan_matches_incremental(rigs, width, depth):
    want = _incr(rigs, 10, PROMPTS[:2])
    got, _, carry = _scan(rigs, width, depth, 10, PROMPTS[:2])
    assert [g[:10] for g in got] == want
    assert not carry["finished"].any()


def test_spec_scan_eos_and_unequal_budgets_freeze_slots(rigs):
    want = _incr(rigs, 10, PROMPTS[:2])
    eos = want[0][3]
    got, em, carry = _scan(rigs, 2, 2, 10, PROMPTS[:2], eos=eos)
    w1 = want[1][: want[1].index(eos) + 1] if eos in want[1] else want[1]
    assert got[0] == want[0][: want[0].index(eos) + 1]
    assert got[1][:10] == w1
    step = next(s for s in range(em.shape[0]) if eos in em[s, 0])
    assert (em[step + 1:, 0] == -1).all()
    assert int(carry["exit_code"][0]) == EXIT_EOS
    # budgets 4 and 2: the first token came from the prefill, so each
    # stream stops at 1 + its budget, the incremental run's prefix
    got, _, carry = _scan(rigs, 2, 2, 10, PROMPTS[:2], budget=[4, 2])
    assert got == [want[0][:5], want[1][:3]]
    assert carry["finished"].tolist() == [True, True]
    assert carry["exit_code"].tolist() == [EXIT_BUDGET, EXIT_BUDGET]
    assert carry["budget"].tolist() == [0, 0]


def test_spec_scan_perfect_draft_commits_depth_plus_one(rigs):
    llm = port_im(rigs["jllm"], max_spec=8)
    ssm = port_im(rigs["jllm"], max_spec=8, topk=1)
    got, em, _ = _scan(rigs, 1, 3, 3, PROMPTS[:2], llm=llm, ssm=ssm)
    assert (em >= 0).all(), f"a perfect draft fills every emit slot: {em}"
    assert got == _incr(rigs, 13, PROMPTS[:2])


def test_kv_allocator_holds_spec_buffers(rigs):
    state = rigs["ssm"].state["model.layers.0.self_attn"]
    assert tuple(state["sk"].shape) == (3, SSM.kv_heads, 8, SSM.hdim)
    assert state["sv"].dtype == state["k"].dtype
    kv = rigs["ssm"].kv
    assert kv.allocated_bytes() == SSM.num_hidden_layers * sum(
        t.numel() * 4 for t in state.values())


def test_spec_example_serves_on_cpu(capsys):
    sys.path.insert(0, str(REPO))
    from flexflow_tpu_torch.examples import spec_infer

    assert spec_infer.main(["--device", "cpu", "--layers", "1",
                            "--hidden", "32", "--heads", "4",
                            "--kv-heads", "2", "--vocab", "64",
                            "--max-new-tokens", "6"]) == 0
    out = capsys.readouterr().out
    assert "OK: speculative output == incremental output" in out
    assert "OK: on-device spec scan matches too" in out
