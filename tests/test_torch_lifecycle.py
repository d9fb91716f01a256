"""The port's request lifecycle vs the JAX serve stack, on the CPU.

Analogues of ``tests/test_resilience.py`` on the TINY Llama of
``test_serve.make_im``, its params carried across by ``params_from_jax``:

* registration: the same registrations give the reference's outcomes
  (bad shapes, ``max_new_tokens=0``, ``max_pending``, the KV gate);
* cancel and TTL land at step boundaries; the other requests stream what
  the reference streams uncancelled, and cut streams are prefixes of it;
* priority admission preempts the lowest priority, and the starvation
  bound orders admission as the reference does;
* the ``serve_with_arrivals`` records and their TTFT decomposition.

Preemption with recompute, page pressure and ``SpecInferManager`` are in
``test_torch_lifecycle_preempt.py``, retries and fault injection in
``test_torch_lifecycle_faults.py``; both use this file's helpers.  Each of
the three holds fewer tests than ``test_kv_allocator.py``, so xdist's
``--dist loadfile`` queue (larger files first) deals the files ahead of
it as it did before they existed.

Clocks: ``VirtualClock`` (``tests/test_serving_under_load.py``) and the
state-triggered ``TriggerClock`` (``tests/test_resilience.py``).  What
depends on when a deadline fires is held to the contract (a ``timeout``
outcome, a prefix of the stream); the port's schedule equals the
reference's tick for tick (``tests/test_torch_obs.py`` holds their
telemetry events equal).
"""

import numpy as np
import pytest

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import ResilienceConfig as JaxResilienceConfig
from flexflow_tpu.serve.resilience import (
    kv_bytes_per_token as jax_kv_bytes_per_token,
)
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    InferenceManager,
    RequestManager,
    RequestStatus,
    ResilienceConfig,
    build_model,
    params_from_jax,
)
from flexflow_tpu_torch.serve.resilience import kv_bytes_per_token

from test_resilience import TriggerClock
from test_serve import make_im
from test_serving_under_load import VirtualClock
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, _one_thread  # noqa: F401

PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
LONG = np.random.default_rng(0).integers(1, 67, size=70).tolist()
MAX_SEQ = 128   # room for a 64-position page (the kernels' smallest)


def jax_im(kv_dtype=None):
    return make_im(max_seq=MAX_SEQ, kv_dtype=kv_dtype)


def port_im(jim, kv_dtype=None, page=None):
    """A port InferenceManager (CPU) with the JAX manager's params and
    capacities, on an fp or int8, contiguous or paged cache."""
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    im = InferenceManager(build_model(CFG), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu",
                          kv_dtype=kv_dtype, kv_page_size=page)
    return im.init_operators_inference(params_from_jax(params, CFG, "cpu"))


_WANT = {}


def reference_streams(prompts, n_new, kv_dtype=None):
    """The reference's uninterrupted greedy streams (memoized)."""
    key = (tuple(map(tuple, prompts)), n_new, kv_dtype)
    if key not in _WANT:
        _WANT[key] = JaxRequestManager(
            jax_im(kv_dtype), JaxGenerationConfig(max_new_tokens=n_new)
        ).generate(prompts)
    return _WANT[key]


def quiet(rm):
    rm._sleep = lambda s: None
    return rm


def tokens_of(records):
    return [records[r]["tokens"] for r in sorted(records)]


# ---------------------------------------------------------------------------
# registration and admission control
# ---------------------------------------------------------------------------
def _register_all(rm, seq):
    for prompt, n_new in seq:
        rm.register_new_request(prompt, n_new, reject_invalid=True)
    return [(r.status.name, r.outcome, len(r.prompt))
            for _, r in sorted(rm.requests.items())]


@pytest.mark.parametrize("case", ["shapes", "max_pending", "kv_frac",
                                  "kv_bytes"])
def test_registration_outcomes_match_reference(case):
    jim = jax_im()
    tim = port_im(jim)
    assert kv_bytes_per_token(tim) == jax_kv_bytes_per_token(jim)
    res = {"shapes": {}, "max_pending": dict(max_pending=2),
           "kv_frac": dict(kv_gate=True, kv_headroom_frac=0.2),
           "kv_bytes": dict(kv_gate=True, kv_budget_bytes=(
               kv_bytes_per_token(tim) * 70))}[case]
    seq = [([3, 5, 7], 20), ([2, 4, 6, 8], 20), ([11, 13], 30),
           ([9, 8, 1], 0), (list(range(1, 131)), 4), ([], 4),
           ([3], -1), ([3, 5], 127), ([1, 2, 3, 4], 10)]
    gen = dict(max_new_tokens=4)
    want = _register_all(JaxRequestManager(
        jim, JaxGenerationConfig(**gen),
        resilience=JaxResilienceConfig(**res)), seq)
    got = _register_all(RequestManager(
        tim, GenerationConfig(**gen), resilience=ResilienceConfig(**res)),
        seq)
    assert got == want
    assert {s for s, _, _ in got} >= {"PENDING", "REJECTED"}
    assert case != "shapes" or ("COMPLETED", "ok", 3) in got
    assert all(n == 0 for s, _, n in got if s == "REJECTED")
    rm = RequestManager(tim, GenerationConfig(**gen))
    for prompt, n_new, match in ((list(range(1, 131)), 4, "prompt length"),
                                 ([3, 5], 127, "cache slots"),
                                 ([], 4, "empty prompt"),
                                 ([3], -1, "max_new_tokens -1")):
        with pytest.raises(ValueError, match=match):
            rm.register_new_request(prompt, n_new)
    assert not rm.has_work()


def test_byte_cap_needs_allocated_caches():
    tim = InferenceManager(build_model(CFG), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=MAX_SEQ,
                           device="cpu")
    with pytest.raises(ValueError, match="kv_budget_bytes"):
        RequestManager(tim, resilience=ResilienceConfig(
            kv_gate=True, kv_budget_bytes=1e6))


# ---------------------------------------------------------------------------
# cancel and deadlines at step boundaries
# ---------------------------------------------------------------------------
def test_cancel_mid_decode_stretch_keeps_the_other_stream():
    want = reference_streams(PROMPTS, 12)
    tim = port_im(jax_im())
    rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=12)))
    rm.scan_chunk = 2
    clock = TriggerClock(
        ready=lambda: 1 in rm.requests
        and 2 <= len(rm.requests[1].generated) < 11,
        fn=lambda: rm.cancel(1))
    records = rm.serve_with_arrivals([(0.0, p, 12) for p in PROMPTS],
                                     clock=clock)
    assert clock.fired
    cut = records[1]["tokens"]
    assert records[1]["outcome"] == "cancelled" and 0 < len(cut) < 12
    assert cut == want[1][:len(cut)]
    assert records[0]["outcome"] == "ok" and records[0]["tokens"] == want[0]
    assert tim.kv.attributed_rids() == []
    assert not rm.cancel(1), "a terminal request is not live"


def test_cancel_mid_prefill_next_occupant_streams_the_reference():
    tim = port_im(jax_im())
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=4))
    rid = rm.register_new_request(LONG[:40])
    bc, points = rm.prepare_next_batch()   # the first 16-token chunk
    rm.process_result(tim.step(bc), points)
    req = rm.requests[rid]
    assert req.status is RequestStatus.PREFILLING and req.prefill_offset == 16
    assert rm.cancel(rid)
    assert req.status is RequestStatus.PREFILLING, "waits for the boundary"
    rm.serve_incr_decoding()
    assert req.status is RequestStatus.CANCELLED and req.slot == -1
    assert req.generated == [] and req.outcome == "cancelled"
    # the next occupant of the slot writes over the stale partial prefill
    got = rm.generate([PROMPTS[0]], max_new_tokens=4)
    assert got == reference_streams([PROMPTS[0]], 4)


@pytest.mark.parametrize("case", ["in_queue", "armed_before_swap"])
def test_ttl_times_out(case):
    tim = port_im(jax_im())
    if case == "in_queue":
        # 3 arrivals into 2 slots: the third expires while it waits
        want = reference_streams(PROMPTS, 8)
        rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=8)))
        records = rm.serve_with_arrivals(
            [(0.0, PROMPTS[0], 8), (0.0, PROMPTS[1], 8),
             (0.0, [9, 1, 5], 8, {"ttl_s": 0.05})], clock=VirtualClock())
        assert records[2]["outcome"] == "timeout"
        assert records[2]["tokens"] == []   # it never left the queue
        assert tokens_of(records)[:2] == want
        assert all(records[r]["outcome"] == "ok" for r in (0, 1))
    else:
        # a TTL armed on perf_counter is rebased onto the loop's clock
        rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=8),
                                  resilience=ResilienceConfig(
                                      default_ttl_s=0.01)))
        rid = rm.register_new_request([3, 5, 7])
        rm.serve_with_arrivals([], clock=VirtualClock())
        assert rm.requests[rid].status is RequestStatus.TIMED_OUT
        assert rm.requests[rid].outcome == "timeout"
    assert tim.kv.attributed_rids() == []


# ---------------------------------------------------------------------------
# priority admission (and the preemption helper the split files share)
# ---------------------------------------------------------------------------
def serve_with_midway_preempt(im, gen, prompts, rid, res=None,
                              injector=None, after=None):
    """Serve ``prompts`` from t=0, preempting ``rid`` once it decodes with
    2 or more tokens (``after(rm)`` runs just after)."""
    rm = quiet(RequestManager(im, gen, resilience=res,
                              fault_injector=injector))
    rm.scan_chunk = 2

    def ready():
        req = rm.requests.get(rid)
        return (req is not None and req.status is RequestStatus.DECODING
                and 2 <= len(req.generated) < gen.max_new_tokens - 1)

    def fire():
        rm.preempt(rid)
        if after is not None:
            after(rm)

    clock = TriggerClock(ready, fire)
    records = rm.serve_with_arrivals(
        [(0.0, p, gen.max_new_tokens) for p in prompts], clock=clock)
    assert clock.fired, "the preempt trigger never armed"
    assert rm.requests[rid].preemptions == 1
    assert all(r["outcome"] == "ok" for r in records.values())
    return rm, records


def test_priority_admission_preempts_the_lowest():
    tim = port_im(jax_im())
    rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=8),
                              resilience=ResilienceConfig(preemption=True)))
    rm.scan_chunk = 2
    prompts = PROMPTS + [[9, 1, 5], [33, 1]]
    records = rm.serve_with_arrivals([
        (0.0, prompts[0], 8, {"priority": 1}), (0.0, prompts[1], 8),
        (0.02, prompts[2], 8, {"priority": 5}),   # under full slots
        (0.02, prompts[3], 8, {"priority": 1})], clock=VirtualClock())
    assert all(r["outcome"] == "ok" for r in records.values())
    # the priority-0 request was the victim; equals were never evicted
    assert [rm.requests[r].preemptions for r in range(4)] == [0, 1, 0, 0]
    for rid, prompt in enumerate(prompts):
        assert records[rid]["tokens"] == reference_streams([prompt], 8)[0]


def _admission_order(rm, bound):
    """Registrations at set serve steps, then pops at set steps: the order
    rids leave the pending queue under ``starvation_bound_ticks``."""
    rm.starvation_bound_ticks = bound
    order = []
    for step, event in [(0, 0), (2, 5), (3, 5), (3, "pop"), (4, 0),
                        (5, "pop"), (5, "pop"), (9, "pop")]:
        rm.steps = step
        if event == "pop":
            order.append(rm._pop_pending())
        else:
            rm.register_new_request([7, 7, 7], 2, priority=event)
    return order


@pytest.mark.parametrize("bound", [None, 4])
def test_starvation_bound_admission_order_matches_reference(bound):
    """Below the bound strict priority with FIFO; a request pending
    ``bound`` steps jumps every band, oldest first — as the reference's
    ``_pop_pending`` orders the same queue."""
    jim = jax_im()
    want = _admission_order(
        JaxRequestManager(jim, JaxGenerationConfig(max_new_tokens=2)), bound)
    got = _admission_order(
        RequestManager(port_im(jim), GenerationConfig(max_new_tokens=2)),
        bound)
    assert got == want
    assert want == ([1, 0, 2, 3] if bound else [1, 2, 0, 3])


# ---------------------------------------------------------------------------
# serve_with_arrivals records
# ---------------------------------------------------------------------------
def test_arrival_records_and_ttft_decomposition():
    want = reference_streams(PROMPTS + [[33, 1]], 6)
    tim = port_im(jax_im())
    rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=6)))
    records = rm.serve_with_arrivals([
        (0.0, PROMPTS[0], 6), (0.0, PROMPTS[1], None),
        (0.05, [33, 1], 6),                     # joins a running batch
        (0.01, list(range(1, 131)), 4),         # prompt > max_seq_len
        (0.01, [2, 4], 0),                      # ok, no tokens
        (0.02, [5, 6], 4, {"colour": "red"}),   # malformed options
    ], clock=VirtualClock())
    assert len(records) == 6
    by_arrival = sorted(records.values(), key=lambda r: r["arrival_s"])
    assert [r["outcome"] for r in by_arrival] == [
        "ok", "ok", "rejected", "ok", "rejected", "ok"]
    keys = {"arrival_s", "admitted_s", "prompt_len", "trace_id", "finish_s",
            "tokens", "outcome", "kv_bytes", "queue_wait_s", "prefill_s"}
    for rec in records.values():
        assert keys <= set(rec)
    served = [r for r in records.values() if r["tokens"]]
    assert sorted(r["tokens"] for r in served) == sorted(want)
    for rec in served:
        assert rec["kv_bytes"] > 0
        assert {"prefill_start_s", "first_token_s"} <= set(rec)
        assert rec["queue_wait_s"] + rec["prefill_s"] == pytest.approx(
            rec["first_token_s"] - rec["arrival_s"], abs=1e-12)
    assert tim.kv.attributed_rids() == []
