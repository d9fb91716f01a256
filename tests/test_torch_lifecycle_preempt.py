"""Preemption in the port vs the JAX serve stack, on the CPU.

Split from ``test_torch_lifecycle.py`` (whose helpers it uses):

* preempt-and-recompute, greedy on fp and int8 caches, contiguous and
  paged, gives the reference's unpreempted streams; seeded, the port's
  own unpreempted streams (the port draws from another counter-based
  generator, equal to the reference's in distribution only);
* page-pressure preemption evicts strictly lower priority only, and an
  exhausted pool with no such victim raises;
* ``SpecInferManager`` under preemption, priority, cancel, TTL and faults,
  at macro-step boundaries.
"""

import pytest

from flexflow_tpu_torch.serve import (
    FaultInjector,
    GenerationConfig,
    PagePoolExhausted,
    RequestManager,
    RequestStatus,
    ResilienceConfig,
    RetryPolicy,
    SpecInferManager,
)
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager

from test_resilience import TriggerClock
from test_serve import make_im
from test_serving_under_load import VirtualClock
from test_torch_lifecycle import (
    LONG,
    PROMPTS,
    jax_im,
    port_im,
    quiet,
    reference_streams,
    serve_with_midway_preempt,
    tokens_of,
)
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import JAX_SSM, SSM, _one_thread  # noqa: F401
from test_torch_spec import port_im as spec_port_im


# ---------------------------------------------------------------------------
# preemption and recompute
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [None, 64])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("seeded", [False, True])
def test_preempt_recompute_streams_unchanged(seeded, kv_dtype, page):
    prompts = [LONG, PROMPTS[1]]
    gen = GenerationConfig(max_new_tokens=10)
    tim = port_im(jax_im(kv_dtype), kv_dtype, page)
    if seeded:
        gen = GenerationConfig(max_new_tokens=10, temperature=0.8,
                               top_p=0.9, seed=11)
        want = RequestManager(tim, gen).generate(prompts)
        tim.reset()
    else:
        want = reference_streams(prompts, 10, kv_dtype)
    rm, records = serve_with_midway_preempt(tim, gen, prompts, rid=0)
    assert tokens_of(records) == want
    assert tim.kv.attributed_rids() == []
    if page:   # the readmission hit its own released pages
        assert tim.kv.prefix_hits > 0 and tim.kv.pages_held() == 0
    with pytest.raises(ValueError, match="cannot preempt"):
        rm.preempt(0)


@pytest.mark.parametrize("priorities", [(0, 5), (0, 0)])
def test_page_pressure_preempts_only_strictly_lower(priorities):
    """Two running requests on a drained pool (a third waits, so every
    tick is one mixed step): the first to need a page with none free
    evicts the other only if that one has a strictly lower priority, and
    the victim's token in the step's batch is dropped (it recomputes);
    otherwise the exhaustion propagates."""
    prompts = [LONG[:40], LONG[25:], [9, 1, 5]]   # the first two cross 64
    want = reference_streams(prompts, 30)
    tim = port_im(jax_im(), page=64)
    kv = tim.kv
    rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=30),
                              resilience=ResilienceConfig(preemption=True)))
    for prompt, pri in zip(prompts, priorities + (0,)):
        rm.register_new_request(prompt, priority=pri)
    # leave one page a running request: the first to cross position 64
    # finds none
    stolen = [kv._free.pop() for _ in range(len(kv._free) - 2)]
    preempt = rm.preempt

    def preempt_then_refill(rid):
        preempt(rid)
        kv._free.extend(stolen)   # the pressure was transient
        stolen.clear()

    rm.preempt = preempt_then_refill
    if priorities[0] == priorities[1]:
        with pytest.raises(PagePoolExhausted):
            rm.serve_incr_decoding()
        return
    out = rm.serve_incr_decoding()
    assert [out[r] for r in range(3)] == want
    assert [rm.requests[r].preemptions for r in range(3)] == [1, 0, 0]
    assert kv.pages_held() == 0


# ---------------------------------------------------------------------------
# SpecInferManager: the same lifecycle at macro-step boundaries
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spec_rig():
    jllm = make_im(max_tokens=32, max_requests=2, max_seq=64, max_spec=8)
    jssm = make_im(max_tokens=32, max_requests=2, max_seq=64, max_spec=8,
                   cfg=JAX_SSM, topk=2, seed=123)
    want = JaxRequestManager(jllm, JaxGenerationConfig(
        max_new_tokens=8)).generate(PROMPTS + [[33, 1, 60]])
    return (spec_port_im(jllm, max_spec=8),
            spec_port_im(jssm, cfg=SSM, max_spec=8, topk=2), want)


@pytest.mark.parametrize("case", ["preempt", "priority", "cancel", "ttl",
                                  "faults", "requeue"])
def test_spec_lifecycle(spec_rig, case):
    llm, ssm, want = spec_rig
    llm.reset()
    ssm.reset()
    inj = res = None
    if case == "faults":
        inj = FaultInjector(seed=3, p=0.3, max_faults=3)
        res = ResilienceConfig(retry=RetryPolicy(max_retries=5,
                                                 backoff_s=0.0))
    elif case == "requeue":
        inj = FaultInjector(seed=0, p=1.0, max_faults=2)
        res = ResilienceConfig(retry=RetryPolicy(max_retries=0))
    elif case == "priority":
        res = ResilienceConfig(preemption=True)
    sm = quiet(SpecInferManager(llm, ssm, GenerationConfig(max_new_tokens=8),
                                width=2, depth=3, resilience=res,
                                fault_injector=inj))
    arrivals = [(0.0, p, 8) for p in PROMPTS]
    clock = VirtualClock()
    if case == "preempt":
        clock = TriggerClock(
            ready=lambda: 0 in sm.requests
            and sm.requests[0].status is RequestStatus.DECODING
            and len(sm.requests[0].generated) >= 2,
            fn=lambda: sm.preempt(0))
    elif case == "cancel":
        clock = TriggerClock(
            ready=lambda: 1 in sm.requests
            and 1 <= len(sm.requests[1].generated) < 7,
            fn=lambda: sm.cancel(1))
    elif case == "ttl":
        arrivals.append((0.0, [33, 1, 60], 8, {"ttl_s": 0.05}))
    elif case == "priority":
        arrivals.append((0.05, [33, 1, 60], 8, {"priority": 5}))
    records = sm.serve_with_arrivals(arrivals, clock=clock)
    got = tokens_of(records)
    if case == "cancel":
        assert clock.fired and records[1]["outcome"] == "cancelled"
        assert 0 < len(got[1]) < 8 and got[1] == want[1][:len(got[1])]
        assert got[0] == want[0]
    elif case == "ttl":
        assert records[2]["outcome"] == "timeout" and got[2] == []
        assert got[:2] == want[:2]
    else:
        assert got == want[:len(got)]
        assert all(r["outcome"] == "ok" for r in records.values())
    if case in ("preempt", "priority"):
        assert any(r.preemptions for r in sm.requests.values())
    if inj is not None:
        assert inj.injected == (3 if case == "faults" else 2)
    if case == "requeue":
        assert any(r.requeues for r in sm.requests.values())
    assert llm.kv.attributed_rids() == [] and ssm.kv.attributed_rids() == []
