"""The port's SLO lanes and brownout vs the JAX serve stack, on the CPU.

``serve/slo.py`` is the reference's module, copied; what is held here is
the managers' use of it, against the JAX package on the same seeded
workload and clocks (``test_torch_obs.py``'s harness), exactly:

* lane admission: priority bands, the per-class bounded queue, an unknown
  class rejected like a bad shape, the reserved-KV gate;
* the brownout ladder under overload: its level changes, lane sheds,
  deferrals (``deferred_ticks``), output caps and the records, on a
  contiguous cache and on a paged one with a host tier (the SPILL rung);
* DEGRADE on the speculative manager: a batch row's speculation turned
  off (``spec_mode_changed``) and capped.

And the contract: what a degraded lane serves is a prefix of what it
serves unloaded.
"""

import pytest

import flexflow_tpu.serve as JS
import flexflow_tpu_torch.serve as PS

from test_torch_obs import (
    PROMPTS,
    SIDES,
    LoopClock,
    ManualClock,
    assert_same,
    deployment,
    handles,
    observed,
    spec_pair,
)
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import _one_thread  # noqa: F401

LC, BATCH = "latency_critical", "batch"
OVERLOAD = [[3, 5, 7, 9], [2, 4, 6], [11, 12, 13, 14, 15], [8, 1],
            [21, 22, 23], [30, 31, 32, 33], [6, 5, 4], [9, 9, 9]]


def policy(S, **kw):
    return S.SLOPolicy.default(**kw)


def test_lane_admission_matches_reference():
    """Bands, per-class queue bounds, reservations and unknown classes
    give the reference's outcomes, priorities and events."""
    seen = {}
    for side in ("jax", "port"):
        S, _ = SIDES[side]
        tel, prof = handles(side, ManualClock())
        rm = S.RequestManager(
            deployment(side), S.GenerationConfig(max_new_tokens=8),
            telemetry=tel, profiler=prof,
            resilience=S.ResilienceConfig(kv_gate=True,
                                          kv_headroom_frac=0.5),
            slo=policy(S, lc_reservation_frac=0.5, batch_max_pending=2))
        for cls, prompt in [(None, PROMPTS[0]), (BATCH, PROMPTS[1]),
                            (BATCH, [5, 6]), (LC, [7, 8, 9]),
                            ("bogus", [1, 2]), (LC, list(range(1, 40))),
                            ("", [4, 4]), (LC, [2, 3])]:
            rm.register_new_request(prompt, 8, slo_class=cls,
                                    reject_invalid=True)
        with pytest.raises(ValueError, match="unknown slo_class"):
            rm.register_new_request([1], 2, slo_class="bogus")
        seen[side] = ([(r.status.name, r.outcome, r.priority, r.slo_class,
                        r.max_new_tokens) for r in rm.requests.values()],
                      observed(tel, prof))
    assert seen["port"][0] == seen["jax"][0]
    assert_same(seen["jax"][1], seen["port"][1])
    outcomes = [o for _, o, _, _, _ in seen["port"][0]]
    assert outcomes.count("rejected") >= 2 and "" in outcomes
    assert {p for _, _, p, c, _ in seen["port"][0] if c == LC} == {1000}


def overload(side, paged=False, spec=False):
    """An overload of alternating latency-critical and batch arrivals
    against a ladder that escalates on any latency-critical queueing."""
    S, _ = SIDES[side]
    clock = LoopClock()
    tel, prof = handles(side, ManualClock(clock))
    slo = policy(S, lc_reservation_frac=0.0, degraded_max_new_tokens=3)
    bo = S.BrownoutController(
        slo, S.BrownoutConfig(check_every=1, queue_depth_high=0,
                              kv_pressure_frac=0.05,
                              escalate_after=1, deescalate_after=3),
        telemetry=tel, clock=clock)
    gen = S.GenerationConfig(max_new_tokens=16)
    res = S.ResilienceConfig(host_tier_bytes=64 << 20 if paged else 0)
    if spec:
        llm, ssm = spec_pair(side)
        rm = S.SpecInferManager(llm, ssm, gen, width=2, depth=3,
                                telemetry=tel, profiler=prof, slo=slo,
                                brownout=bo, resilience=res)
    else:
        rm = S.RequestManager(deployment(side, paged=paged), gen,
                              telemetry=tel, profiler=prof, slo=slo,
                              brownout=bo, resilience=res)
    rm._sleep = lambda s: None
    rm.scan_chunk = 2     # a tick every two decode steps: the ladder acts
    arrivals = [(0.01 * i, p, 8 if i % 2 else 16,
                 {"slo_class": LC if i % 2 else BATCH})
                for i, p in enumerate(OVERLOAD)]
    records = rm.serve_with_arrivals(arrivals, clock=clock)
    return records, observed(tel, prof), bo


@pytest.mark.parametrize("case", ["contiguous", "paged_spill", "spec"])
def test_brownout_ladder_matches_reference(case):
    """The ladder's walk, sheds, deferrals and caps, the records and every
    event equal the reference's (exact); at least one level change and one
    output cap happen."""
    kw = dict(paged=case == "paged_spill", spec=case == "spec")
    want_rec, want, _ = overload("jax", **kw)
    got_rec, got, bo = overload("port", **kw)
    assert got_rec == want_rec
    assert_same(want, got)
    m = got["metrics"]
    assert m["brownout_escalations"] >= 1 and bo.history
    names = {e[0] for e in got["events"]}
    assert "brownout_level_changed" in names
    if case == "paged_spill":
        # the SPILL rung moves the batch decoder's pages to the host
        # tier before DEGRADE could cap it
        assert "kv_spill" in names and m["kv_pages_spilled"] >= 1
    else:
        assert m["lane_degraded_total"] >= 1
    if case == "spec":
        assert "spec_mode_changed" in names


def test_degraded_lanes_serve_prefixes_of_the_unloaded_streams():
    """A capped or deferred batch request's tokens are a prefix of what
    it streams unloaded; latency-critical ones are whole."""
    records, _, _ = overload("port")
    rm = PS.RequestManager(deployment("port"),
                           PS.GenerationConfig(max_new_tokens=16))
    order = sorted(records)
    unloaded = [rm.generate([p], 8 if i % 2 else 16)[0]
                for i, p in enumerate(OVERLOAD)]
    for rid, want in zip(order, unloaded):
        rec = records[rid]
        assert rec["tokens"] == want[:len(rec["tokens"])], rid
        if rec["slo_class"] == LC:
            assert rec["outcome"] == "ok" and rec["tokens"] == want
    assert any(0 < len(records[r]["tokens"]) < 16 for r in order
               if records[r]["slo_class"] == BATCH)


def test_apply_output_cap_matches_reference():
    """``apply_output_cap`` on a live decoding request: it completes at
    once when already past the cap, and the events equal the
    reference's."""
    seen = {}
    for side in ("jax", "port"):
        S, _ = SIDES[side]
        tel, prof = handles(side, ManualClock())
        rm = S.RequestManager(deployment(side),
                              S.GenerationConfig(max_new_tokens=8),
                              telemetry=tel, profiler=prof)
        rids = [rm.register_new_request(p) for p in PROMPTS]
        rm._serve_tick()                  # both prefilled: one token each
        capped = [rm.apply_output_cap(rids[0], 1),
                  rm.apply_output_cap(rids[1], 5),
                  rm.apply_output_cap(rids[1], 6)]
        out = rm.serve_incr_decoding()
        seen[side] = (capped, {r: list(t) for r, t in out.items()},
                      observed(tel, prof))
    assert seen["port"][:2] == seen["jax"][:2]
    assert_same(seen["jax"][2], seen["port"][2])
    assert seen["port"][0] == [True, True, False]
    assert [len(t) for t in seen["port"][1].values()] == [1, 5]


def test_registration_under_degrade_caps_and_turns_speculation_off():
    """A batch request registered while DEGRADE holds is admitted capped,
    with speculation off (``lane_degraded``), as in the reference."""
    seen = {}
    for side in ("jax", "port"):
        S, _ = SIDES[side]
        tel, _ = handles(side, ManualClock())
        slo = policy(S, degraded_max_new_tokens=2)
        bo = S.BrownoutController(slo, telemetry=tel)
        bo.level = S.BrownoutLevel.DEGRADE_BATCH
        llm, ssm = spec_pair(side)
        rm = S.SpecInferManager(llm, ssm,
                                S.GenerationConfig(max_new_tokens=8),
                                width=2, depth=3, telemetry=tel, slo=slo,
                                brownout=bo)
        rids = [rm.register_new_request(PROMPTS[0], slo_class=BATCH),
                rm.register_new_request(PROMPTS[1], slo_class=LC)]
        seen[side] = [(rm.requests[r].spec, rm.requests[r].max_new_tokens)
                      for r in rids] + [
            tel.metrics.snapshot().get("lane_degraded_total")]
    assert seen["port"] == seen["jax"] == [(False, 2), (True, 8), 1]
    assert JS.BrownoutLevel.DEGRADE_BATCH == PS.BrownoutLevel.DEGRADE_BATCH
