"""The port's live plan migration vs the JAX serve stack, on the CPU.

Analogues of ``tests/test_migration.py`` on ``test_torch_fleet.py``'s
deployments (``max_seq_len`` 128, 64-position pages):

* against the JAX ``MigrationController``, greedy, on the same prompts and
  weights (``params_from_jax``): a contiguous → paged switch landing
  mid-decode gives equal streams, outcomes, migration records and event
  lists (the JAX side with ``use_pallas=True``);
* against the port's own single manager, greedy and seeded: contiguous →
  paged, spec-on → spec-off by a full rebuild and by the flip fast path,
  rollbacks (a failing build, a candidate that cannot hold a request or
  reuses the incumbent), seeded faults in the migration phases and the
  dispatches, a switch inside an arrival session, the plan-health auto
  path and its cooldown, the admission-closed downtime, and
  ``LLM.attach_migration``.  Every switch tears the incumbent's caches
  down with no rid left holding attribution.

The ``tp1 → pp2`` case of the reference is in ``test_torch_pp_paths.py``;
re-search through a planner waits for the planner slice; the auto path
here runs the monitor's ``search_fn`` hook with a fixed candidate.
"""

import numpy as np
import pytest

import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.serve.migration import base_plan_key, spec_shape

from test_serving_under_load import VirtualClock, poisson_arrivals
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_fleet import (  # noqa: F401
    PAGE,
    PROMPTS,
    SIDES,
    PortWeights,
    StepClock,
    _one_thread,
    assert_events_equal,
    baseline,
    events,
    greedy,
    jax_im,
    port_weights,
    seeded,
)
from test_torch_spec import CFG, SSM

PAGED = "tp1_pp1_m1_paged64"


def quiet(rm):
    rm._sleep = lambda s: None
    return rm


def midflight_ctrl(S, rm, build, incumbent="tp1_pp1_m1", **cfg):
    """A controller staged so the switch lands mid-decode: decode
    stretches of 2 steps, two defer ticks, one admission-closed grace
    tick."""
    rm.scan_chunk = 2
    kw = dict(defer_ticks=2, drain_grace_ticks=1)
    kw.update(cfg)
    return S.MigrationController(rm, build, plan={"plan_key": incumbent},
                                 config=S.MigrationConfig(**kw))


def assert_clean_switch(ctrl, old_im):
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed"
    assert rec["preempted_requests"] > 0, "the switch was not in flight"
    assert rec["kv_leaked_rids"] == []
    assert old_im.kv.attributed_rids() == []
    assert old_im.state is None, "incumbent buffers not torn down"


# ---------------------------------------------------------------------------
# against the JAX MigrationController
# ---------------------------------------------------------------------------
def run_reference_migration(side):
    S, O = SIDES[side]
    if side == "jax":
        im = jax_im(0)
        build = (lambda cand: jax_im(0, page=PAGE))
    else:
        w = PortWeights(jax_im(0))
        im = w.im()
        build = (lambda cand: w.im(page=PAGE))
    tel = O.Telemetry(clock=StepClock())
    rm = S.RequestManager(im, greedy(side), telemetry=tel,
                          clock=StepClock(0.5))
    ctrl = midflight_ctrl(S, rm, build)
    ctrl.request_migration(PAGED, reasons=("operator",))
    out = rm.generate(PROMPTS)
    active = ctrl.rm
    view = {
        "streams": out,
        "outcomes": {rid: (r.status.name, r.outcome, r.preemptions)
                     for rid, r in sorted(active.requests.items())},
        "history": ctrl.history,
        "plan": ctrl.plan,
        "paged": active.im.kv.paged,
        "old_state": im.state is None,
        "leaked": im.kv.attributed_rids(),
    }
    return view, events(tel), ctrl


def test_migration_matches_reference():
    """Contiguous → paged mid-decode, greedy: the streams, outcomes (with
    preemption counts), the migration record and every event equal the
    JAX controller's."""
    want, want_ev, _ = run_reference_migration("jax")
    got, got_ev, ctrl = run_reference_migration("port")
    assert got == want
    assert_events_equal(want_ev, got_ev)
    assert got["paged"] and got["old_state"] and got["leaked"] == []
    assert ctrl.history[-1]["preempted_requests"] > 0
    names = [e[0] for e in got_ev if e[0].startswith("migration_")]
    assert names == ["migration_started", "migration_completed"]


# ---------------------------------------------------------------------------
# against the port's own single manager
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_migrate_contiguous_to_paged_bit_identical(gen_fn):
    w = port_weights()
    im = w.im()
    rm = PS.RequestManager(im, gen_fn())
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE))
    ctrl.request_migration(PAGED)
    assert rm.generate(PROMPTS) == baseline(gen_fn, PROMPTS)
    assert_clean_switch(ctrl, im)
    assert ctrl.rm.im.kv.paged and ctrl.plan["plan_key"] == PAGED


class SpecWeights:
    """A target with spec buffers and a draft (``test_torch_spec.SSM``'s
    shape), the target sharing ``port_weights``'s parameters."""

    def __init__(self):
        self.w = port_weights()
        self.draft = PortWeights(seed=11, cfg=SSM)

    def pair(self, page=None):
        llm = self.w.im(max_tokens=32, page=page, max_spec_tokens=8)
        ssm = self.draft.im(max_tokens=32, page=page, max_spec_tokens=8,
                            topk=2)
        return llm, ssm


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_migrate_spec_on_to_spec_off_full_rebuild(gen_fn):
    """A spec incumbent to a plain candidate through drain, rebuild and
    readmit (fast path off): speculation leaves the streams as they
    are, so the switch does too; both incumbent caches tear down."""
    sw = SpecWeights()
    gen = gen_fn(max_new=10)
    want = PS.RequestManager(sw.w.im(max_tokens=32), gen).generate(PROMPTS)
    llm, ssm = sw.pair()
    sm = PS.SpecInferManager(llm, ssm, gen, width=2, depth=3)
    ctrl = midflight_ctrl(PS, sm, lambda cand: sw.w.im(max_tokens=32),
                          incumbent="tp1_pp1_m1_spec_w2d3",
                          spec_flip_fast_path=False)
    ctrl.request_migration("tp1_pp1_m1")
    assert sm.generate(PROMPTS) == want
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["mode"] == "rebuild"
    assert type(ctrl.rm) is PS.RequestManager
    for im in (llm, ssm):
        assert im.kv.attributed_rids() == [] and im.state is None


def test_spec_off_recommendation_takes_flip_fast_path():
    """A candidate that only drops the spec suffix flips every live row
    and the default instead of rebuilding: same manager, same caches, no
    preemption (the plan-key helpers decide it)."""
    assert base_plan_key("tp2_pp1_m1_spec_w2d3") == "tp2_pp1_m1"
    assert base_plan_key("tp1_pp2_m2") == "tp1_pp2_m2"
    assert spec_shape("tp2_pp1_m1_spec_w2d3") == (2, 3)
    assert spec_shape("tp2_pp1_m1") is None
    sw = SpecWeights()
    gen = greedy(max_new=10)
    want = PS.RequestManager(sw.w.im(max_tokens=32), gen).generate(PROMPTS)
    llm, ssm = sw.pair(page=PAGE)
    tel = PO.Telemetry()
    sm = PS.SpecInferManager(llm, ssm, gen, width=2, depth=3, telemetry=tel)
    ctrl = midflight_ctrl(PS, sm, lambda cand: pytest.fail("rebuilt"),
                          incumbent="tp1_pp1_m1_paged64_spec_w2d3")
    ctrl.request_migration(PAGED, reasons=("workload_drift",))
    assert sm.generate(PROMPTS) == want
    rec = ctrl.history[-1]
    assert rec["mode"] == "spec_flip" and rec["preempted_requests"] == 0
    assert rec["flipped_requests"] > 0 and rec["downtime_ticks"] == 0
    assert ctrl.rm is sm and sm.default_spec_mode is False
    assert llm.state is not None
    names = [e["name"] for e in tel.trace.trace_events()]
    assert "spec_mode_changed" in names
    assert [n for n in names if n.startswith("migration_")] == [
        "migration_started", "migration_completed"]


def test_rollback_on_rebuild_failure_zero_lost_requests():
    w = port_weights()
    tel = PO.Telemetry()
    rm = PS.RequestManager(w.im(), greedy(), telemetry=tel)

    def broken(cand):
        raise RuntimeError("candidate devices unavailable")

    ctrl = midflight_ctrl(PS, rm, broken)
    ctrl.request_migration("tp4_pp1_m1")
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "rolled_back" and rec["phase"] == "rebuild"
    assert ctrl.rm is rm and not rm.admission_closed
    assert all(r.status is PS.RequestStatus.COMPLETED
               for r in rm.requests.values())
    [ev] = [e for e in tel.trace.trace_events()
            if e["name"] == "migration_rolled_back"]
    assert "RuntimeError" in ev["args"]["reason"]
    assert tel.metrics.snapshot()["migrations_rolled_back"] == 1
    assert rm.generate([[4, 2]])[0]


def test_rollback_on_a_candidate_that_cannot_serve():
    """A candidate too short for an in-flight request rolls back at
    readmit, its buffers torn down; a ``build_manager`` handing back the
    incumbent's own manager rolls back at rebuild, the incumbent's
    buffers kept."""
    w = port_weights()
    rm = PS.RequestManager(w.im(), greedy())
    built = {}

    def small(cand):
        built["im"] = w.im(max_tokens=8, max_seq=8)   # 5 + 8 > 8
        return built["im"]

    ctrl = midflight_ctrl(PS, rm, small)
    ctrl.request_migration("tp1_pp1_m1_small")
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "rolled_back" and rec["phase"] == "readmit"
    assert "does not fit" in rec["reason"] and built["im"].state is None

    im = w.im()
    rm = PS.RequestManager(im, greedy())
    ctrl = midflight_ctrl(PS, rm, lambda cand: im)
    ctrl.request_migration("tp1_pp1_m1_again")
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "rolled_back" and rec["phase"] == "rebuild"
    assert "FRESH deployment" in rec["reason"] and im.state is not None


def test_chaos_faults_in_migration_phases_retry_to_completion():
    w = port_weights()
    im = w.im()
    inj = PS.FaultInjector(seed=3, p_by_site={"migration": 0.6},
                           max_faults=3)
    rm = quiet(PS.RequestManager(
        im, greedy(), fault_injector=inj,
        resilience=PS.ResilienceConfig(retry=PS.RetryPolicy(
            max_retries=5, backoff_s=0.0))))
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE))
    ctrl.request_migration(PAGED)
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    assert inj.injected == 3
    assert_clean_switch(ctrl, im)


def test_chaos_unrecoverable_rebuild_rolls_back_all_terminal(tmp_path):
    w = port_weights()
    tel = PO.Telemetry()
    inj = PS.FaultInjector(seed=0, p_by_site={"migration_rebuild": 1.0},
                           max_faults=10)
    rm = quiet(PS.RequestManager(
        w.im(), greedy(), telemetry=tel, fault_injector=inj,
        resilience=PS.ResilienceConfig(retry=PS.RetryPolicy(
            max_retries=2, backoff_s=0.0))))
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE))
    ctrl.request_migration(PAGED)
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "rolled_back" and rec["phase"] == "rebuild"
    assert "retries exhausted" in rec["reason"]
    assert all(r.outcome == "ok" for r in rm.requests.values())
    paths = tel.export(str(tmp_path), prefix="chaos_mig")
    assert PO.validate_jsonl(paths["jsonl"]) == []
    assert "migration_rolled_back" in open(paths["jsonl"]).read()


def test_chaos_migration_plus_dispatch_faults_all_terminal():
    prompts = [[3, 11, 25, 40, 7], [2, 4, 6, 8], [33, 1], [9, 8, 1, 5]]
    w = port_weights()
    im = w.im()
    inj = PS.FaultInjector(seed=7, p=0.25, max_faults=6)
    rm = quiet(PS.RequestManager(
        im, greedy(max_new=6), fault_injector=inj,
        resilience=PS.ResilienceConfig(retry=PS.RetryPolicy(
            max_retries=6, backoff_s=0.0))))
    rm.chain_segments = False   # many dispatch sites for the injector
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE))
    ctrl.request_migration(PAGED)
    got = rm.generate(prompts)
    assert inj.injected >= 4
    active = ctrl.rm
    assert all(r.status in PS.TERMINAL_STATUSES
               for r in active.requests.values())
    assert got == [t[:6] for t in baseline(greedy, prompts)]
    assert im.kv.attributed_rids() == []
    assert active.im.kv.attributed_rids() == []


def test_migration_mid_arrival_session_records_complete():
    rng = np.random.RandomState(11)
    arrivals = poisson_arrivals(rng, 6, rate_per_s=40.0,
                                vocab=CFG.vocab_size, max_new=6)
    w = port_weights()
    recs0 = PS.RequestManager(w.im(), greedy(max_new=6)).serve_with_arrivals(
        arrivals, clock=VirtualClock())
    rm = PS.RequestManager(w.im(), greedy(max_new=6))
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE))
    ctrl.request_migration(PAGED)
    recs = rm.serve_with_arrivals(arrivals, clock=VirtualClock())
    assert ctrl.history[-1]["outcome"] == "completed" and ctrl.rm is not rm
    assert sorted(recs) == sorted(recs0)
    assert [recs[r]["tokens"] for r in sorted(recs)] == [
        recs0[r]["tokens"] for r in sorted(recs0)]
    for rec in recs.values():
        assert rec["outcome"] == "ok" and "finish_s" in rec
        assert "queue_wait_s" in rec and "prefill_s" in rec


def _breaching_monitor(tel, search_fn):
    """A monitor whose first check breaches (an absurd TPOT prediction,
    a zero drift threshold) and recommends ``search_fn()``."""
    return PO.PlanHealthMonitor(
        tel, {"plan_key": "tp1_pp1_m1", "tpot_ms": 0.0001},
        reference=tel.workload.snapshot(),
        config=PO.PlanHealthConfig(min_requests=1, max_tpot_error_frac=0.01,
                                   drift_min_samples=1, drift_threshold=0.0),
        search_fn=search_fn)


def test_auto_migration_consumes_replan_recommendation():
    w = port_weights()
    tel = PO.Telemetry()
    mon = _breaching_monitor(tel, lambda: {"plan_key": PAGED,
                                           "tpot_ms": 1.0})
    rm = PS.RequestManager(w.im(), greedy(), telemetry=tel, plan_health=mon)
    rm.health_check_every = 1
    rm.scan_chunk = 2
    ctrl = PS.MigrationController(
        rm, lambda cand: w.im(page=PAGE),
        config=PS.MigrationConfig(defer_ticks=0, drain_grace_ticks=1))
    assert rm.generate(PROMPTS) == baseline(greedy, PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["candidate"] == PAGED
    assert mon.plan["plan_key"] == PAGED and mon.recommendation is None
    assert ctrl.rm.plan_health is mon and mon.kv_allocator is ctrl.rm.im.kv
    snap = tel.metrics.snapshot()
    assert snap["migrations_completed"] == 1
    assert snap["migration_preempted_requests"] > 0


def test_controller_cooldown_prevents_flapping():
    w = port_weights()
    tel = PO.Telemetry()
    flip = {"n": 0}

    def search_fn():
        flip["n"] += 1
        return {"plan_key": PAGED if flip["n"] % 2 else "tp1_pp1_m1",
                "tpot_ms": 1.0}

    rm = PS.RequestManager(w.im(), greedy(max_new=12), telemetry=tel,
                           plan_health=_breaching_monitor(tel, search_fn))
    rm.health_check_every = 1
    rm.scan_chunk = 1
    ctrl = PS.MigrationController(
        rm, lambda cand: w.im(page=PAGE if "paged" in cand["plan_key"]
                              else None),
        config=PS.MigrationConfig(defer_ticks=0, drain_grace_ticks=0,
                                  cooldown_ticks=1000))
    rm.generate(PROMPTS)
    assert flip["n"] >= 2   # the monitor re-recommended after the switch
    assert [h["outcome"] for h in ctrl.history] == ["completed"]


def test_downtime_ticks_count_admission_closed_window():
    w = port_weights()
    tel = PO.Telemetry()
    rm = PS.RequestManager(w.im(), greedy(max_new=12), telemetry=tel)
    rm.scan_chunk = 1
    ctrl = midflight_ctrl(PS, rm, lambda cand: w.im(page=PAGE),
                          defer_ticks=1, drain_grace_ticks=3)
    ctrl.request_migration(PAGED)
    rm.generate(PROMPTS)
    rec = ctrl.history[-1]
    assert rec["downtime_ticks"] == 3 and rec["downtime_s"] > 0
    assert tel.metrics.snapshot()["migration_downtime_ticks"] == 3
    [ev] = [e for e in tel.trace.trace_events()
            if e["name"] == "migration_completed"]
    assert ev["args"]["downtime_ticks"] == 3
    assert ev["args"]["preempted_requests"] == rec["preempted_requests"]


def test_llm_attach_migration_follows_active_deployment():
    """``LLM.attach_migration``: a switch staged while idle runs in the idle
    window (nothing preempted); ``llm.rm`` and ``llm.im`` then follow the
    successor, which serves what the incumbent would have."""
    caps = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
                device="cpu", generation_config=greedy())
    want = PS.LLM(CFG).compile(**caps).generate(PROMPTS * 2)
    llm = PS.LLM(CFG).compile(**caps)
    model = llm.im.model
    first = llm.generate(PROMPTS)
    old_rm, old_im = llm.rm, llm.im

    def build(cand):
        im = PS.InferenceManager(model, max_requests=2,
                                 max_tokens_per_batch=16, max_seq_len=128,
                                 device="cpu", kv_page_size=PAGE)
        im.allocate_kv_cache()   # the weights are the incumbent's
        return im

    ctrl = llm.attach_migration(build)
    assert old_rm.migration is ctrl
    ctrl.request_migration(PAGED)
    assert old_rm.serve_incr_decoding() is not None   # the idle switch
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["preempted_requests"] == 0
    assert llm.rm is ctrl.rm is not old_rm and llm.im is llm.rm.im
    assert llm.im.kv.paged and old_im.state is None
    assert first + llm.generate(PROMPTS) == want
    with pytest.raises(RuntimeError, match="compile"):
        PS.LLM(CFG).attach_migration(lambda cand: None)
