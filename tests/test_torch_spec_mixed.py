"""Mixed speculative and plain rows in the port's SpecInfer loops vs the
JAX package's, on the CPU (after ``tests/test_spec_infer.py:134-330`` and
``tests/test_spec_scan.py:160``).

* ``register_new_request(spec=...)``: a spec row and a plain row in one
  ``SpecInferManager`` give the JAX manager's streams and the incremental
  ones, greedy (and the committed caches) and seeded; an all-plain
  population never takes the macro path;
* ``set_spec_mode`` flips mid-serve: off flushes the pending commits
  through ``spec_commit_flush`` (under injected faults too: retried, and
  past the budget only the flushed rows are requeued or failed, as in the
  JAX package), on rebuilds the draft's feed;
* ``serve_with_arrivals`` takes the ``spec`` option; a queued spec
  arrival leaves the plain rows on the incremental path;
* int8 + paged caches: the flush maps the page its commits land on;
* ``SpecDecodeScan`` with ``spec_mask``: a spec row with a perfect draft
  commits depth+1 tokens a macro step, a plain row exactly 1.

The JAX side is ``test_serve.make_im`` (TINY Llama); its params reach the
port through ``params_from_jax``.  Caches ``atol=rtol=1e-5`` (float32),
port vs JAX and port mixed vs port incremental: a position's K/V of
layer 1 on depends on which attention (the tree kernel or the decode
kernel) produced the layer's input, and the two sum in different orders.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import FaultInjector as JaxFaultInjector
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import ResilienceConfig as JaxResilienceConfig
from flexflow_tpu.serve import RetryPolicy as JaxRetryPolicy
from flexflow_tpu.serve import SpecInferManager as JaxSpecInferManager
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    FaultInjector,
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ResilienceConfig,
    RetryPolicy,
    SpecDecodeScan,
    SpecInferManager,
    build_model,
    params_from_jax,
)
from flexflow_tpu_torch.serve.request_manager import parse_arrival_options

from test_serve import make_im
from test_serving_under_load import VirtualClock
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import _one_thread  # noqa: F401
from test_torch_spec import CFG, JAX_SSM, SSM, port_im
from test_torch_spec_serve import _prefill

PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8], [33, 1, 60]]
TOL = dict(atol=1e-5, rtol=1e-5)


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


def _incr(rigs, n_new=10, prompts=PROMPTS[:2], gen=None):
    rigs["incr"].reset()
    return RequestManager(rigs["incr"], gen or GenerationConfig(
        max_new_tokens=n_new)).generate(prompts)


def _managers(rigs, n_new=10, jax=True, port_kw=None, jax_kw=None):
    """A fresh port SpecInferManager (width 2, depth 3) and, with ``jax``,
    its JAX twin, over reset caches; ``*_kw``: more constructor
    arguments."""
    for k in ("jllm", "jssm", "llm", "ssm"):
        rigs[k].reset()
    sm = SpecInferManager(rigs["llm"], rigs["ssm"], GenerationConfig(
        max_new_tokens=n_new), width=2, depth=3, **(port_kw or {}))
    if not jax:
        return sm, None
    jsm = JaxSpecInferManager(rigs["jllm"], rigs["jssm"], JaxGenerationConfig(
        max_new_tokens=n_new), width=2, depth=3, **(jax_kw or {}))
    return sm, jsm


def _ticks(*managers, n=1):
    for _ in range(n):
        for m in managers:
            m._check_lifecycle()
            if m.has_work():
                m._tick()


def _cache_rows(im, slot, depth):
    """The committed K/V prefix of one slot in every layer (numpy)."""
    return {f"{layer}.{name}": np.asarray(bufs[name])[slot, :, :depth]
            for layer, bufs in im.state.items() for name in ("k", "v")}


def test_mixed_rows_greedy_match_reference_incremental_and_caches(rigs):
    """One mixed loop (a spec row and a plain row sharing the verify
    batch) gives the JAX mixed streams and the incremental ones; each
    row's committed cache equals the incremental run's and the JAX
    run's within f32 tolerance, over the prompt and the first
    five tokens (the last verify step's accepted nodes, at most depth+1
    of the ten, stay uncommitted when a row finishes).  An all-plain
    population never pays for the macro path."""
    want = _incr(rigs)
    depth = [len(p) + 5 for p in PROMPTS[:2]]
    want_cache = {r: _cache_rows(rigs["incr"], r, depth[r]) for r in (0, 1)}
    sm, jsm = _managers(rigs)
    rids = [sm.register_new_request(PROMPTS[0], 10, spec=True),
            sm.register_new_request(PROMPTS[1], 10, spec=False)]
    jrids = [jsm.register_new_request(PROMPTS[0], 10, spec=True),
             jsm.register_new_request(PROMPTS[1], 10, spec=False)]
    assert [sm.requests[r].spec for r in rids] == [True, False]
    out, jout = sm.serve_spec_infer(), jsm.serve_spec_infer()
    assert [out[r] for r in rids] == [jout[r] for r in jrids] == want
    assert sm.macro_steps == jsm.macro_steps > 0
    assert sm.llm_steps == jsm.llm_steps
    for r in (0, 1):
        got = _cache_rows(rigs["llm"], r, depth[r])
        for key, arr in got.items():
            np.testing.assert_allclose(arr, want_cache[r][key], **TOL,
                                       err_msg=key)
            layer, name = key.rsplit(".", 1)
            np.testing.assert_allclose(
                arr, np.asarray(rigs["jllm"].state[layer][name])[
                    r, :, :depth[r]], **TOL, err_msg=key)

    sm, _ = _managers(rigs, jax=False)
    rid = sm.register_new_request(PROMPTS[1], 10, spec=False)
    assert sm.serve_spec_infer()[rid] == want[1]
    assert sm.macro_steps == 0 and sm.scan_runs > 0


def test_mixed_rows_seeded_equal_seeded_incremental(rigs):
    """Seeded sampling: the (rid, token index) keys give the mixed loop
    the sampled incremental streams, and the all-spec loop too."""
    gen = GenerationConfig(max_new_tokens=10, temperature=2.0, seed=11)
    want = _incr(rigs, gen=gen)
    for modes in ((True, False), (True, True)):
        sm, _ = _managers(rigs, jax=False)
        sm.gen = gen
        rids = [sm.register_new_request(p, 10, spec=m)
                for p, m in zip(PROMPTS[:2], modes)]
        out = sm.serve_spec_infer()
        assert [out[r] for r in rids] == want
        assert sm.macro_steps > 0


def test_flip_off_mid_serve_flushes_the_pending_commits(rigs):
    """spec -> plain after three macro steps: the next tick feeds the
    pending commits back as one plain batch (``spec_commit_flush``), then
    serves incrementally; streams and LLM passes equal the JAX run's."""
    want = _incr(rigs)
    sm, jsm = _managers(rigs)
    rids = [m.register_new_request(p, 10) for m in (sm, jsm)
            for p in PROMPTS[:2]][:2]
    _ticks(sm, jsm, n=3)
    pending = [list(sm.requests[r].pending_commit) for r in rids]
    assert pending == [list(map(tuple, jsm.requests[r].pending_commit))
                       for r in rids]
    assert all(pending)
    for m in (sm, jsm):
        assert all(m.set_spec_mode(r, False) for r in rids)
    assert not sm.set_spec_mode(99, True)      # no such request
    steps = sm.llm_steps
    _ticks(sm, jsm)
    assert sm.flushes == 1 and sm.llm_steps == steps + 1
    assert not any(sm.requests[r].pending_commit for r in rids)
    out, jout = sm.serve_spec_infer(), jsm.serve_spec_infer()
    assert [out[r] for r in rids] == [jout[r] for r in rids] == want
    assert sm.llm_steps == jsm.llm_steps
    assert not sm._spec_live() and sm.flush_pending_commits()


def test_flip_on_mid_serve_rebuilds_the_draft_feed(rigs):
    """plain -> spec mid-decode: the draft's catch-up feed is rebuilt from
    scratch and the speculative tail equals the incremental stream."""
    want = _incr(rigs)
    sm, jsm = _managers(rigs)
    for m in (sm, jsm):
        m.scan_chunk = 1     # one decode step a tick: the flip lands mid-way
        for p in PROMPTS[:2]:
            m.register_new_request(p, 10, spec=False)
    _ticks(sm, jsm, n=4)
    assert all(0 < len(sm.requests[r].generated) < 10 for r in (0, 1))
    assert sm.macro_steps == 0
    for m in (sm, jsm):
        assert all(m.set_spec_mode(r, True) for r in (0, 1))
    req = sm.requests[0]
    assert req.ssm_committed == 0
    assert [p for _, p in req.ssm_backlog] == list(
        range(len(PROMPTS[0]), req.seq_len - 1))
    out, jout = sm.serve_spec_infer(), jsm.serve_spec_infer()
    assert [out[0], out[1]] == [jout[0], jout[1]] == want
    assert sm.macro_steps == jsm.macro_steps > 0


def test_queued_spec_arrival_keeps_the_plain_fast_path(rigs):
    """A spec request waiting behind two plain decoders leaves them on the
    incremental path while it queues (``_spec_live`` ignores the queue);
    once a slot frees it speculates, its draft feed rebuilt lazily."""
    want = _incr(rigs, 16, PROMPTS)
    sm, _ = _managers(rigs, 16, jax=False)
    sm.scan_chunk = 4    # short stretches: the rows outlive the next tick
    r0 = sm.register_new_request(PROMPTS[0], 16, spec=False)
    r1 = sm.register_new_request(PROMPTS[1], 16, spec=False)
    _ticks(sm, n=2)
    assert sm.macro_steps == 0 and sm.scan_runs > 0
    before = [len(sm.requests[r].generated) for r in (r0, r1)]
    r2 = sm.register_new_request(PROMPTS[2], 16, spec=True)
    _ticks(sm)
    assert sm.macro_steps == 0
    assert [len(sm.requests[r].generated) for r in (r0, r1)] > before
    out = sm.serve_spec_infer()
    assert [out[r0], out[r1], out[r2]] == want
    assert sm.macro_steps > 0


def test_serve_with_arrivals_takes_the_spec_option(rigs):
    """``{"spec": bool}`` arrival options register each request's mode;
    the records' streams equal the JAX loop's and the incremental ones,
    every outcome ``ok``."""
    assert parse_arrival_options([{"spec": 0, "priority": "2"}]) == (
        {"spec": False, "priority": 2}, None)
    assert parse_arrival_options([{"spek": True}])[1] is not None
    want = _incr(rigs, 8)
    sm, jsm = _managers(rigs, 8)
    arrivals = [(0.0, PROMPTS[0], 8, {"spec": True}),
                (0.02, PROMPTS[1], 8, {"spec": False})]
    rec = sm.serve_with_arrivals(arrivals, clock=VirtualClock())
    jrec = jsm.serve_with_arrivals(arrivals, clock=VirtualClock())
    assert [rec[r]["tokens"] for r in (0, 1)] == want
    assert [jrec[r]["tokens"] for r in (0, 1)] == want
    assert [sm.requests[r].spec for r in (0, 1)] == [True, False]
    assert all(r["outcome"] == "ok" for r in rec.values())
    assert sm.macro_steps > 0


@pytest.mark.parametrize("faults,mode", [(2, "requeue"), (3, "requeue"),
                                         (3, "fail")])
def test_flush_under_injected_faults(rigs, faults, mode):
    """Faults at the flush's dispatch (its LLM ``step`` site): within the
    retry budget (2 retries) the flush retries under ``spec_commit_flush``
    and the streams are unchanged; past it only the flushed rows are
    requeued (and recompute their streams) or failed, while a queued
    request serves on.  Streams, outcomes and retry counts equal the JAX
    manager's under the same seeded injector."""
    want = _incr(rigs, 10, PROMPTS)
    res = dict(on_dispatch_failure=mode)
    sm, jsm = _managers(rigs, port_kw=dict(resilience=ResilienceConfig(
        retry=RetryPolicy(max_retries=2, backoff_s=0.0), **res)),
        jax_kw=dict(resilience=JaxResilienceConfig(retry=JaxRetryPolicy(
            max_retries=2, backoff_s=0.0), **res)))
    for m in (sm, jsm):
        for p in PROMPTS:
            m.register_new_request(p, 10)
    _ticks(sm, jsm, n=2)
    injectors = (FaultInjector(seed=0, p_by_site={"step": 1.0},
                               max_faults=faults),
                 JaxFaultInjector(seed=0, p_by_site={"step": 1.0},
                                  max_faults=faults))
    for m, inj in zip((sm, jsm), injectors):
        m.injector = m.llm.fault_injector = inj
        for r in (0, 1):
            m.set_spec_mode(r, False)
    _ticks(sm, jsm)
    assert [inj.injected for inj in injectors] == [faults] * 2
    assert sm.retries["spec_commit_flush"] == 2
    assert sm.flushes == (faults <= 2)
    out, jout = sm.serve_spec_infer(), jsm.serve_spec_infer()
    outcomes = [sm.requests[r].outcome for r in range(3)]
    assert outcomes == [jsm.requests[r].outcome for r in range(3)]
    assert out == jout
    if mode == "fail" and faults > 2:
        assert outcomes == ["failed", "failed", "ok"]
        assert out[2] == want[2]
    else:
        assert outcomes == ["ok"] * 3 and [out[r] for r in range(3)] == want
        assert [sm.requests[r].preemptions for r in (0, 1)] == \
            [int(faults > 2)] * 2


def _paged_pair(jim, cfg, topk=0):
    im = InferenceManager(build_model(cfg), max_requests=2,
                          max_tokens_per_batch=32, max_seq_len=128,
                          device="cpu", max_spec_tokens=8, topk=topk,
                          kv_dtype="int8", kv_page_size=64)
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    return im.init_operators_inference(params_from_jax(params, cfg, "cpu"))


def test_mixed_rows_on_int8_paged_cache_flush_maps_pages():
    """int8 KV in 64-position pages: prompts end just below a page
    boundary, so the commits pending when the rows flip off land on an
    unmapped page, which the flush's prepare maps; the logical committed
    rows then equal the JAX run's, and the streams the JAX mixed run's
    and the incremental ones."""
    kw = dict(max_tokens=32, max_requests=2, max_seq=128, kv_dtype="int8",
              kv_page_size=64)
    jllm = make_im(max_spec=8, **kw)
    jssm = make_im(max_spec=8, cfg=JAX_SSM, topk=2, seed=123, **kw)
    llm, ssm = _paged_pair(jllm, CFG), _paged_pair(jssm, SSM, topk=2)
    prompts = [list(range(1, 62)), list(range(5, 64))]
    want = RequestManager(_paged_pair(jllm, CFG), GenerationConfig(
        max_new_tokens=10)).generate(prompts)
    sm = SpecInferManager(llm, ssm, GenerationConfig(max_new_tokens=10))
    jsm = JaxSpecInferManager(jllm, jssm, JaxGenerationConfig(
        max_new_tokens=10))
    for m in (sm, jsm):
        m.register_new_request(prompts[0], 10, spec=True)
        m.register_new_request(prompts[1], 10, spec=False)
    kv = llm.kv
    for _ in range(8):     # macro steps until a commit waits past 64
        _ticks(sm, jsm)
        dsts = {r: [d for _, d in sm.requests[r].pending_commit]
                for r in (0, 1)}
        if max(max(d, default=0) for d in dsts.values()) >= 64:
            break
    slot = next(r for r in (0, 1) if max(dsts[r], default=0) >= 64)
    assert kv._table[slot, 1] == kv.scratch_pid
    for m in (sm, jsm):
        m.set_spec_mode(0, False)
    mapped = kv.pages_mapped
    # the tick's first half: the flush alone, before the incremental
    # stretch finishes the rows and releases their pages
    assert sm._flush_commits() and jsm._flush_commits()
    assert sm.flushes == 1 and kv.pages_mapped > mapped
    assert kv._table[slot, 1] != kv.scratch_pid
    for slot in (0, 1):
        depth = sm.requests[slot].seq_len - 1
        rows = torch.tensor([slot])
        jstate = jllm.kv.logical_state(slot, depth)
        for layer, bufs in llm.state.items():
            for name in ("k", "v", "k_scale", "v_scale"):
                got = att._pages(bufs[name], kv.page_view().table, 64,
                                 rows)[0, :, :depth].numpy()
                want_j = jstate[layer][name]
                if name in ("k", "v"):   # int8: one quantization step
                    assert np.abs(got.astype(int) - want_j).max() <= 1
                else:
                    np.testing.assert_allclose(got, want_j, **TOL)
    out, jout = sm.serve_spec_infer(), jsm.serve_spec_infer()
    assert [out[0], out[1]] == [jout[0], jout[1]] == want


def test_spec_scan_spec_mask_commits_depth_plus_one_and_one(rigs):
    """``init_carry(spec_mask=[True, False])`` with a perfect draft (the
    SSM holds the LLM's weights): the spec slot commits depth+1 = 4 tokens
    a macro step, the plain slot in the same verify batch exactly 1, both
    the incremental streams; the carry keeps the mask."""
    jllm = rigs["jllm"]
    llm = port_im(jllm, max_spec=8)
    ssm = port_im(jllm, max_spec=8, topk=1)
    want = _incr(rigs, 13)
    firsts = _prefill(llm, PROMPTS[:2])
    _prefill(ssm, PROMPTS[:2])
    sc = SpecDecodeScan(llm, ssm, width=1, depth=3)
    lens = [len(p) for p in PROMPTS[:2]]
    carry = sc.init_carry(firsts, lens, lens, [False, False],
                          spec_mask=[True, False])
    n_macro = 3
    em, carry = sc.run(carry, n_macro)
    em = em.numpy()
    seq = [[firsts[r]] + [int(t) for t in em[:, r].reshape(-1) if t >= 0]
           for r in range(2)]
    assert ((em[:, 0] >= 0).sum(1) == 4).all()
    assert ((em[:, 1] >= 0).sum(1) == 1).all()
    assert seq[0] == want[0][: 1 + 4 * n_macro]
    assert seq[1] == want[1][: 1 + n_macro]
    assert carry["spec"].tolist() == [True, False]
    assert carry["llm_comm"].tolist() == [lens[0] + 4 * n_macro,
                                          lens[1] + n_macro]
