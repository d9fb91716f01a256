"""The port's plan-health checks vs the JAX serve stack, on the CPU.

``obs/plan_health.py`` is the reference's module, copied; held here is its
wiring into the port's managers (``_maybe_check_health`` every
``health_check_every`` ticks and once when a loop drains, the monitor
given the manager's KV allocator, or the target's and the draft's under
the spec manager), against the JAX package on the same workload and
clocks (``test_torch_obs.py``'s harness): every ``check()`` report, and
every event, exactly.  The plan dict is the caller's (``plan_key``, the
predicted ``tpot_ms`` and ``ttft_ms``); with no ``search_fn`` (the port
has no planner yet) an unhealthy check reports and recommends nothing.
"""

import pytest

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

PLAN = {"plan_key": "tp1_pp1_m1", "tpot_ms": 20.0, "ttft_ms": 40.0}
ARRIVALS = [(0.01 * i, p, 6) for i, p in enumerate(
    [[3, 5, 7, 9], [2, 4, 6], [11, 12, 13, 14, 15], [8, 1], [21, 22, 23],
     [30, 31, 32, 33]])]


def serve(side, spec=False, reference=None, **cfg):
    """Arrivals under a monitor checked every two ticks; the reports of
    every check, in order."""
    S, O = SIDES[side]
    clock = LoopClock()
    tel, prof = handles(side, ManualClock(clock))
    config = O.PlanHealthConfig(**{"min_requests": 2,
                                   "drift_min_samples": 4, **cfg})
    mon = O.PlanHealthMonitor(tel, PLAN, reference=reference,
                              config=config)
    reports = []
    inner = mon.check
    mon.check = lambda: reports.append(inner()) or reports[-1]
    gen = S.GenerationConfig(max_new_tokens=6)
    if spec:
        llm, ssm = spec_pair(side)
        rm = S.SpecInferManager(llm, ssm, gen, width=2, depth=3,
                                telemetry=tel, profiler=prof,
                                plan_health=mon)
        assert mon.kv_allocator == [llm.kv, ssm.kv]
    else:
        im = deployment(side)
        rm = S.RequestManager(im, gen, telemetry=tel, profiler=prof,
                              plan_health=mon)
        assert mon.kv_allocator is im.kv
    rm.health_check_every = 2
    rm.serve_with_arrivals(ARRIVALS, clock=clock)
    return reports, observed(tel, prof), mon


@pytest.mark.parametrize("case", ["incremental", "spec"])
def test_check_reports_match_reference(case):
    """TTFT and TPOT against the plan's predictions and an SLO target:
    every report and event equal (exact); the final forced check runs."""
    kw = dict(spec=case == "spec", max_tpot_error_frac=0.1,
              slo_ttft_p95_s=0.05)
    want, want_obs, _ = serve("jax", **kw)
    got, got_obs, mon = serve("port", **kw)
    assert got == want
    assert_same(want_obs, got_obs)
    assert len(got) >= 2 and got[-1]["checks"] == mon.checks
    assert {"prediction_error", "slo_ttft"} & set(got[-1]["reasons"])
    assert mon.recommendation is None, "no search_fn: report only"
    assert "replan_recommended" not in {e[0] for e in got_obs["events"]}


def test_memory_pressure_matches_reference():
    """A projected KV growth past the capacity line breaches as
    ``memory_pressure`` (edge-triggered), as in the reference."""
    want, want_obs, _ = serve("jax", memory_pressure_frac=0.01)
    got, got_obs, _ = serve("port", memory_pressure_frac=0.01)
    assert got == want
    assert_same(want_obs, got_obs)
    assert any("memory_pressure" in r["reasons"] for r in got)
    assert "memory_pressure" in {e[0] for e in got_obs["events"]}


def test_drift_against_the_planned_for_profile_matches_reference():
    """The plan was priced for long prompts; the live traffic is short:
    the drift check fires, with the reference's score and events."""
    def long_profile(side):
        _, O = SIDES[side]
        tel = O.Telemetry(clock=ManualClock())
        for i in range(16):
            tel.request_enqueued(f"r{i}", prompt_len=90 + i)
            tel.request_finished(f"r{i}", n_tokens=40)
        return tel.workload.snapshot()

    want, want_obs, _ = serve("jax", reference=long_profile("jax"))
    got, got_obs, _ = serve("port", reference=long_profile("port"))
    assert got == want
    assert_same(want_obs, got_obs)
    assert all("workload_drift" in r["reasons"] for r in got)
    assert "drift_detected" in {e[0] for e in got_obs["events"]}


def test_llm_health_runs_one_check():
    """``LLM.health()`` runs the attached monitor now and returns its
    report; without one it is None."""
    import flexflow_tpu_torch.obs as PO
    import flexflow_tpu_torch.serve as PS
    from test_torch_spec import CFG

    tel = PO.Telemetry()
    mon = PO.PlanHealthMonitor(tel, PLAN)
    llm = PS.LLM(PS.ServeModelConfig(**CFG.__dict__)).compile(
        max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
        device="cpu", telemetry=tel, plan_health=mon,
        generation_config=PS.GenerationConfig(max_new_tokens=4))
    llm.generate(PROMPTS)
    before = mon.checks
    report = llm.health()
    assert report["plan"] == "tp1_pp1_m1" and mon.checks == before + 1
    assert mon.kv_allocator is llm.im.kv and mon.slo is None
