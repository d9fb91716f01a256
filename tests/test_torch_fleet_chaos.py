"""The port's fleet router under chaos, on the CPU.

Analogues of the health, admission and lifecycle cases of
``tests/test_fleet.py``, on ``test_torch_fleet.py``'s shared seeded weights
and single-manager baselines (the failover cases against the JAX fleet
are in that file):

* the health state machine: ``fleet_dispatch:<replica>`` faults walk a
  replica HEALTHY → DEGRADED → QUARANTINED, a re-probe readmits it, and
  exhausted probes (``fleet_health:<replica>``) retire it DEAD with its KV
  torn down; an all-quarantined fleet holds its queue until a readmit;
* retry exhaustion inside a replica fails its batch over through the
  ``on_exhausted`` hook, never ``FAILED``;
* admission re-gates against the surviving capacity (shed load ends
  ``REJECTED``), a request no survivor can hold is rejected;
* cancel and TTL reach their outcomes through the fleet; a kill during a
  brownout composes with the ladder; a paged survivor adopts the dead
  replica's host-tier spills and restores them (``adopt_spills``);
* seeded chaos sweeps (dispatch, step and decode faults with kills): every
  rid reaches a terminal outcome, every ``ok`` stream is the baseline's,
  and no replica leaks attribution.
"""

import pytest

import flexflow_tpu_torch.serve as PS

from test_serving_under_load import VirtualClock
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_fleet import (  # noqa: F401
    MAX_SEQ,
    PROMPTS,
    _one_thread,
    baseline,
    greedy,
    kill_spy,
    port_fleet,
    port_weights,
    seeded,
)

COMPLETED = PS.RequestStatus.COMPLETED


def all_completed(fleet):
    return all(r.status is COMPLETED for r in fleet.requests.values())


def test_quarantine_reprobe_readmit():
    inj = PS.FaultInjector(seed=0, p_by_site={"fleet_dispatch:replica1": 1.0},
                           max_faults=3)
    fleet = port_fleet(2, greedy(), fault_injector=inj,
                       config=PS.FleetConfig(degraded_after=1,
                                             quarantine_after=3,
                                             probe_every=2))
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    events = [h["event"] for h in fleet.history]
    assert "replica_quarantined" in events and "replica_readmitted" in events
    assert fleet._by_name("replica1").state is PS.ReplicaState.HEALTHY
    assert all_completed(fleet)


def test_probe_exhaustion_marks_dead_and_tears_down():
    inj = PS.FaultInjector(seed=0, p_by_site={"fleet_dispatch:replica1": 1.0,
                                              "fleet_health:replica1": 1.0},
                           max_faults=16)
    fleet = port_fleet(2, greedy(), fault_injector=inj,
                       config=PS.FleetConfig(degraded_after=1,
                                             quarantine_after=2,
                                             probe_every=1,
                                             dead_after_probes=2))
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rep1 = fleet._by_name("replica1")
    assert rep1.state is PS.ReplicaState.DEAD and rep1.leaked == []
    assert rep1.rm.im.state is None
    assert all_completed(fleet)


def test_on_exhausted_hook_defaults_off():
    """A lone manager keeps its requeue-or-FAIL recovery: no hook, and an
    exhausted step requeues its batch, which then completes."""
    assert PS.RequestManager.on_exhausted is None
    rm = PS.RequestManager(
        port_weights().im(), greedy(),
        resilience=PS.ResilienceConfig(retry=PS.RetryPolicy(max_retries=0)),
        fault_injector=PS.FaultInjector(seed=0, p_by_site={"step": 1.0},
                                        max_faults=1))
    rm._sleep = lambda s: None
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    assert sum(r.requeues for r in rm.requests.values()) >= 1


def test_exhaustion_converts_to_failover_not_failed():
    inj = PS.FaultInjector(seed=0, p_by_site={"step": 1.0}, max_faults=1)
    res = PS.ResilienceConfig(retry=PS.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    fleet = port_fleet(2, greedy(), fault_injector=inj, resilience=res)
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    assert sum(fleet._failover_counts.values()) >= 1
    assert all_completed(fleet)
    assert not any(r.outcome == "failed" for r in fleet.requests.values())
    assert any(rep.state is PS.ReplicaState.DEGRADED
               for rep in fleet.replicas)


def test_admission_regates_against_surviving_capacity():
    # 0.25 x 2 replicas x (2 slots x 128) = 128 positions; 64 after one dies
    res = PS.ResilienceConfig(kv_gate=True, kv_headroom_frac=0.25)
    fleet = port_fleet(2, greedy(), resilience=res)
    rids = [fleet.register(p, 8) for p in PROMPTS]   # 13 + 11 + 11
    assert all(fleet.requests[r].status is not PS.RequestStatus.REJECTED
               for r in rids)
    fleet.kill_replica("replica0", reason="shrink")
    r4 = fleet.register([1, 2, 3, 4], 8)       # 35 + 12
    r5 = fleet.register([1, 2, 3, 4, 5], 8)    # 47 + 13
    r6 = fleet.register([1, 2, 3], 8)          # 60 + 11 > 64: shed
    assert fleet.requests[r4].status is not PS.RequestStatus.REJECTED
    assert fleet.requests[r5].status is not PS.RequestStatus.REJECTED
    assert fleet.requests[r6].outcome == "rejected"
    out = fleet.serve_all()
    assert PS.RequestStatus.FAILED not in {r.status for r in
                                           fleet.requests.values()}
    assert all(fleet.requests[r].status is COMPLETED
               for r in rids + [r4, r5])
    assert [out[r] for r in rids] == baseline(greedy, PROMPTS)


def test_request_no_survivor_can_hold_is_rejected():
    w = port_weights()
    fleet = PS.FleetRouter([w.im(max_seq=MAX_SEQ), w.im(max_seq=32)],
                           gen=greedy())
    long_prompt = list(range(1, 41))   # 48 positions: the big one only
    rid = fleet.register(long_prompt, 8)
    fleet._dispatch_queue()
    assert fleet.placement.get(rid) == "replica0"
    fleet.kill_replica("replica0", reason="shrink")
    assert fleet.requests[rid].outcome == "rejected"
    with pytest.raises(ValueError):
        fleet.register(long_prompt, 8)
    rid2 = fleet.register(long_prompt, 8, reject_invalid=True)
    assert fleet.requests[rid2].status is PS.RequestStatus.REJECTED


def test_all_quarantined_holds_queue_until_readmit():
    inj = PS.FaultInjector(seed=0, p_by_site={"fleet_dispatch": 1.0},
                           max_faults=4)
    fleet = port_fleet(2, greedy(), fault_injector=inj,
                       config=PS.FleetConfig(degraded_after=1,
                                             quarantine_after=2,
                                             probe_every=2))
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    events = [h["event"] for h in fleet.history]
    assert events.count("replica_quarantined") == 2
    assert events.count("replica_readmitted") == 2
    assert all_completed(fleet)


def test_fleet_cancel_and_ttl_reach_terminal():
    fleet = port_fleet(1, greedy(max_new=16), clock=VirtualClock(0.001))
    fleet.replicas[0].rm.scan_chunk = 2
    r0 = fleet.register(PROMPTS[0], 16)
    r1 = fleet.register(PROMPTS[1], 16, ttl_s=0.01)
    r2 = fleet.register(PROMPTS[2], 16)
    assert fleet.cancel(r2)
    fleet.serve_all()
    assert [fleet.requests[r].outcome for r in (r0, r1, r2)] == [
        "ok", "timeout", "cancelled"]
    assert not fleet.has_work()
    assert fleet.replicas[0].rm.im.kv.attributed_rids() == []


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_replica_death_during_brownout_composes(gen_fn):
    pol = PS.SLOPolicy.default(lc_reservation_frac=0.0)
    bo = PS.BrownoutController(
        pol, PS.BrownoutConfig(check_every=1, queue_depth_high=0,
                               escalate_after=1, deescalate_after=4))
    fleet = port_fleet(2, gen_fn(), slo=pol, brownout=bo)
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    seen = kill_spy(fleet)
    fleet.schedule_kill("replica0", at_tick=3)
    rids = [fleet.register(PROMPTS[0], 8, slo_class="latency_critical"),
            fleet.register(PROMPTS[1], 8, slo_class="latency_critical"),
            fleet.register(PROMPTS[2], 8)]
    out = fleet.serve_all()
    want = baseline(gen_fn, PROMPTS)
    assert bo.history and seen["statuses"]
    assert out[rids[0]] == want[0] and out[rids[1]] == want[1]
    assert out[rids[2]] == want[2][:len(out[rids[2]])]
    for rid in rids:
        assert fleet.requests[rid].status in (COMPLETED,
                                              PS.RequestStatus.REJECTED)
    dead = fleet._by_name("replica0")
    assert dead.state is PS.ReplicaState.DEAD and dead.leaked == []
    assert bo.level == PS.BrownoutLevel.NORMAL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_every_rid_terminal(seed):
    """Seeded dispatch, step and decode faults on three replicas, a zero
    retry budget, a kill: every rid ends terminal, every ``ok`` stream is
    the baseline's (a ``failed`` one a prefix of it), and no live replica
    holds attribution at the end."""
    inj = PS.FaultInjector(seed=seed, p_by_site={
        "fleet_dispatch": 0.2, "step": 0.2, "decode_scan": 0.2,
        "prefill_scan": 0.2}, max_faults=6)
    res = PS.ResilienceConfig(retry=PS.RetryPolicy(max_retries=0,
                                                   backoff_s=0.0))
    fleet = port_fleet(3, greedy(), fault_injector=inj, resilience=res,
                       config=PS.FleetConfig(max_failovers_per_request=2))
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.schedule_kill("replica1", at_tick=2 + seed)
    prompts = PROMPTS * 2
    rids = [fleet.register(p) for p in prompts]
    out = fleet.serve_all()
    want = baseline(greedy, PROMPTS) * 2
    assert inj.injected >= 1
    for rid, w in zip(rids, want):
        req = fleet.requests[rid]
        assert req.status in PS.TERMINAL_STATUSES
        assert out[rid] == (w if req.outcome == "ok" else w[:len(out[rid])])
    for rep in fleet.replicas:
        assert rep.rm.im.kv.attributed_rids() == []
        assert rep.state is not PS.ReplicaState.DEAD or rep.leaked == []


def test_failover_restores_from_the_dead_replicas_host_tier():
    """Paged replicas with a host tier: the kill's reclaim preempts the
    victim's rows, spilling their pages to its tier, which outlives its
    KV teardown; the survivor adopts the spills (equal swap signatures)
    and restores them at readmission instead of re-prefilling, and the
    streams stay the baseline's."""
    from test_torch_fleet import PAGE

    def greedy24():
        return greedy(max_new=24)

    w = port_weights()
    res = PS.ResilienceConfig(host_tier_bytes=1 << 26)
    fleet = PS.FleetRouter([w.im(page=PAGE) for _ in range(2)],
                           gen=greedy24(), resilience=res)
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.schedule_kill("replica0", at_tick=3)
    prompts = [list(range(1, 64)), [2, 4, 6], list(range(2, 66))]
    assert fleet.generate(prompts) == baseline(greedy24, prompts)
    dead, survivor = (fleet._by_name(n).rm.im.kv
                      for n in ("replica0", "replica1"))
    assert dead.pages_spilled > 0 and dead.state is None
    assert survivor.pages_restored > 0
    assert survivor.recompute_tokens_saved > 0
