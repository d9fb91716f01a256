"""The port's pipelined manager on the serve paths around it, vs the JAX
package's on the same inputs (CPU).

The reference's pipelined tests (``test_kv_paged.py:188``,
``test_kv_tiered.py:177``, ``test_spec_infer.py:365``,
``test_migration.py:107``, ``test_resilience.py:480``, ``test_obs.py:259``,
``test_profiler.py:129``, ``test_plan_health.py:225``) in the port: the
JAX side is ``test_pp_serve.make_pp_im`` (``use_pallas=False``), the
port's managers hold its params (``test_torch_pp.port_pim``).  Pages are
64 positions (the kernels' smallest) on both sides.  Held:

* paged ``pp=2`` with a prefix shared across two sessions: the streams,
  the prefix hits and the reused positions equal the reference's, and the
  contiguous ``pp=2`` streams;
* the host tier across stages: a preempted request's pages (every
  stage's blocks in one spill page) restore onto its new row with the
  unpreempted streams; a corrupt host page falls back to recompute with
  the same streams;
* host speculation with a pipelined, paged target (spec and plain rows):
  the reference's streams, which are plain incremental decoding's;
* a ``tp1 -> pp2`` live migration mid-decode: greedy streams equal the
  reference's migration and the unmigrated run, seeded ones the port's
  unmigrated run (seeded draws match the reference in distribution only);
* seeded stage-hop faults retried to the fault-free streams, as in the
  reference;
* telemetry events, metrics, the memory ledger, the profiler's phases
  and counters (``stage{s}``, ``hop``, ``dispatches``) and every
  plan-health report of a ``pp=2`` run equal the reference's, exactly;
* F3: a manager without ``prefill_scan`` prefills chunk by chunk through
  ``step``: events, streams and read-backs equal the reference's.
"""

import jax
import pytest

import flexflow_tpu.obs as JO
import flexflow_tpu.serve as JS
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh

from test_resilience import TriggerClock
from test_serve import TINY, make_im
from test_torch_lifecycle import LONG
from test_torch_obs import StepClock, assert_same, deployment, observed
from test_torch_pp import jax_pim, port_one, port_pim
from test_torch_spec import JAX_SSM, SSM, port_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

SIDES = {"jax": (JS, JO), "port": (PS, PO)}
PAGE = 64
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [13, 8, 1]]


def pair(**kw):
    """The JAX pipelined manager (its Pallas kernels in interpret mode,
    so its request manager's schedule is the port's) and the port's, on
    the same params."""
    jpim = jax_pim(pallas=True, **kw)
    return jpim, port_pim(jpim)


def quiet(rm):
    rm._sleep = lambda s: None
    return rm


# ---------------------------------------------------------------------------
# paged caches and the host tier
# ---------------------------------------------------------------------------
def test_paged_pp2_shares_a_prefix_like_the_reference():
    shared = LONG[:66]
    sessions = [[shared + [30, 31]], [shared + [40, 41, 42], [2, 4, 6]]]
    out = {}
    for side, (S, _) in SIDES.items():
        jpim, pim = pair(max_seq=128, kv_page_size=PAGE)
        im = jpim if side == "jax" else pim
        rm = S.RequestManager(im, S.GenerationConfig(max_new_tokens=6))
        out[side] = ([rm.generate(p) for p in sessions],
                     im.kv.prefix_hits, im.kv.prefix_tokens_reused,
                     im.kv.pages_held())
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0 and out["port"][3] == 0
    contiguous = port_pim(jax_pim(max_seq=128))
    rm = PS.RequestManager(contiguous, PS.GenerationConfig(max_new_tokens=6))
    assert [rm.generate(p) for p in sessions] == out["port"][0]


def _serve_preempting(S, im, prompts, corrupt=False):
    """Serve ``prompts`` with a host tier, preempting rid 0 once both
    requests decode and evicting the prefix index, so the readmission
    restores (or, ``corrupt``, finds a corrupt page and recomputes).
    Returns the streams and the tier's counters."""
    gen = S.GenerationConfig(max_new_tokens=10)
    rm = quiet(S.RequestManager(im, gen, resilience=S.ResilienceConfig(
        host_tier_bytes=64 << 20)))
    rm.scan_chunk = 2
    kv = im.kv

    def ready():
        return (len(rm.requests) == len(prompts) and all(
            r.status is S.RequestStatus.DECODING
            for r in rm.requests.values())
            and 2 <= len(rm.requests[0].generated) < 9)

    def fire():
        rm.preempt(0)
        for key in list(kv._entries):
            kv._drop_entry(key)
        if corrupt:
            kv.host_tier._spills[0].pages[0].corrupt_for_test()

    clock = TriggerClock(ready, fire)
    recs = rm.serve_with_arrivals([(0.0, p, 10) for p in prompts],
                                  clock=clock, quantum=2)
    assert clock.fired and rm.requests[0].preemptions == 1
    assert kv.attributed_rids() == [] and kv.pages_held() == 0
    return ([recs[r]["tokens"] for r in sorted(recs)],
            [kv.pages_spilled, kv.pages_restored, kv.restore_failures,
             kv.recompute_tokens_saved])


@pytest.mark.parametrize("corrupt", [False, True])
def test_host_tier_spill_restores_every_stage(corrupt):
    """The streams and the tier's counters equal the reference's, and the
    streams are the unpreempted run's."""
    prompts = [LONG, [2, 4, 6]]
    jpim, pim = pair(max_seq=128, kv_page_size=PAGE)
    want = JS.RequestManager(jpim, JS.GenerationConfig(
        max_new_tokens=10)).generate(prompts)
    jpim.reset()
    # one spill page holds both stages' blocks: K and V of one layer each
    assert len(list(pim.kv._page_blocks(0))) == 4
    got = _serve_preempting(PS, pim, prompts, corrupt)
    ref = _serve_preempting(JS, jpim, prompts, corrupt)
    assert got == ref and got[0] == want
    spilled, restored, failures, _ = got[1]
    assert spilled > 0 and failures == int(corrupt)
    assert corrupt or restored > 0


# ---------------------------------------------------------------------------
# speculation with a pipelined target
# ---------------------------------------------------------------------------
def test_host_spec_paged_pp2_matches_reference():
    caps = dict(max_tokens=32, max_requests=2, max_seq=128)
    ff = FFModel(FFConfig(), mesh=jax_make_mesh({"pp": 2},
                                                jax.devices()[:2]))
    JS.build_model(ff, TINY, 32)
    jllm = JS.PipelinedInferenceManager(
        ff, max_requests=2, max_tokens_per_batch=32, max_seq_len=128,
        max_spec_tokens=8, use_pallas=False, kv_page_size=PAGE)
    jllm.init_operators_inference(rng=jax.random.PRNGKey(7))
    jssm = make_im(max_spec=8, cfg=JAX_SSM, topk=2, seed=123, **caps)
    llm = port_pim(jllm)
    ssm = port_im(jssm, SSM, max_spec=8, topk=2)
    out = {}
    for side, (S, _) in SIDES.items():
        t, d = (jllm, jssm) if side == "jax" else (llm, ssm)
        sm = S.SpecInferManager(t, d, S.GenerationConfig(max_new_tokens=8),
                                width=2, depth=3)
        r0 = sm.register_new_request(PROMPTS[0], 8, spec=True)
        r1 = sm.register_new_request(PROMPTS[1], 8, spec=False)
        res = sm.serve_spec_infer()
        out[side] = [res[r0], res[r1]]
        assert sm.llm.kv.pages_held() == 0
    assert out["port"] == out["jax"]
    incr = PS.RequestManager(port_one(llm), PS.GenerationConfig(
        max_new_tokens=8)).generate(PROMPTS[:2])
    assert out["port"] == incr


# ---------------------------------------------------------------------------
# migration and faults
# ---------------------------------------------------------------------------
def _migrate(S, incumbent, build, gen):
    rm = quiet(S.RequestManager(incumbent, gen))
    rm.scan_chunk = 2
    ctrl = S.MigrationController(
        rm, build, plan={"plan_key": "tp1_pp1_m1"},
        config=S.MigrationConfig(defer_ticks=2, drain_grace_ticks=1))
    ctrl.request_migration("tp1_pp2_m2")
    got = rm.generate(PROMPTS)
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["preempted_requests"] > 0
    assert rec["kv_leaked_rids"] == [] and incumbent.state is None
    assert ctrl.rm.im.pp == 2
    return got


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_migrate_tp1_to_pp2_matches_reference(seeded):
    kw = (dict(temperature=0.8, top_p=0.9, seed=5) if seeded else {})
    jpim = jax_pim(max_seq=64)
    pgen = PS.GenerationConfig(max_new_tokens=8, **kw)
    want = PS.RequestManager(port_one(port_pim(jpim)), pgen).generate(
        PROMPTS)
    got = _migrate(PS, port_one(port_pim(jpim)),
                   lambda cand: port_pim(jpim), pgen)
    assert got == want, "the port's streams changed across tp1 -> pp2"
    if not seeded:
        jgen = JS.GenerationConfig(max_new_tokens=8)
        jim = make_im(max_seq=64, use_pallas=True)
        assert _migrate(JS, jim, lambda cand: jax_pim(max_seq=64),
                        jgen) == got


def test_stage_hop_faults_retry_to_the_same_streams():
    prompt = [3, 11, 25, 40, 7]
    out = {}
    for side, (S, _) in SIDES.items():
        jpim, pim = pair()
        im = jpim if side == "jax" else pim
        want = S.RequestManager(im, S.GenerationConfig(
            max_new_tokens=6)).generate([prompt])[0]
        im.reset()
        inj = S.FaultInjector(seed=2, p_by_site={"hop": 0.5}, max_faults=2)
        rm = quiet(S.RequestManager(
            im, S.GenerationConfig(max_new_tokens=6), fault_injector=inj,
            resilience=S.ResilienceConfig(retry=S.RetryPolicy(
                max_retries=4, backoff_s=0.0))))
        out[side] = (rm.generate([prompt])[0], want, inj.injected)
    assert out["port"] == out["jax"]
    got, want, injected = out["port"]
    assert got == want and injected == 2


# ---------------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------------
PLAN = {"plan_key": "tp1_pp2_m2", "tpot_ms": 0.0001, "ttft_ms": 40.0}


def run_observed(side, im):
    S, O = SIDES[side]
    clock = StepClock()
    tel, prof = O.Telemetry(clock=clock), O.StepProfiler(clock=clock)
    mon = O.PlanHealthMonitor(tel, PLAN, reference=tel.workload.snapshot(),
                              config=O.PlanHealthConfig(
                                  min_requests=1, max_tpot_error_frac=0.01))
    reports = []
    inner = mon.check
    mon.check = lambda: reports.append(inner()) or reports[-1]
    rm = S.RequestManager(im, S.GenerationConfig(max_new_tokens=6),
                          telemetry=tel, profiler=prof, plan_health=mon)
    rm.health_check_every = 1
    out = rm.generate([[3, 5, 7, 9], [11, 2]])
    return out, observed(tel, prof), reports


def test_pp2_telemetry_profiler_and_plan_health_match_reference():
    jpim, pim = pair()
    want_out, want, want_rep = run_observed("jax", jpim)
    got_out, got, got_rep = run_observed("port", pim)
    assert got_out == want_out
    assert_same(want, got)
    assert got_rep == want_rep and got_rep
    names = {e[0] for e in got["events"]}
    assert {"stage_dispatch", "stage_hop", "pp_macro_step",
            "pp_decode_macro_step"} <= names
    assert got["metrics"]["pp_hops"] > 0
    phases = got["profile"]["phases"]
    assert {"stage0", "stage1", "hop"} <= set(phases)
    assert got["profile"]["work"]["dispatches"] > 0


class NoPrefillScan:
    """A manager without ``prefill_scan`` (as a pipelined one is): every
    other attribute is the wrapped manager's."""

    def __init__(self, im):
        object.__setattr__(self, "_im", im)

    def __getattr__(self, name):
        if name == "prefill_scan":
            raise AttributeError(name)
        return getattr(self._im, name)

    def __setattr__(self, name, value):
        setattr(self._im, name, value)


def test_f3_a_manager_without_prefill_scan_prefills_by_step():
    """The per-step prefill of the reference's request manager (F3):
    events, streams and read-backs of a long and a short prompt equal
    the JAX package's with the same manager limitation."""
    prompts = [LONG[:40], [2, 4, 6, 8]]
    runs = {}
    for side, (S, O) in SIDES.items():
        im = NoPrefillScan(deployment(side))
        clock = StepClock()
        tel, prof = O.Telemetry(clock=clock), O.StepProfiler(clock=clock)
        rm = S.RequestManager(im, S.GenerationConfig(max_new_tokens=6),
                              telemetry=tel, profiler=prof)
        runs[side] = (rm.generate(prompts), observed(tel, prof), rm)
    assert runs["port"][0] == runs["jax"][0]
    assert_same(runs["jax"][1], runs["port"][1])
    names = {e[0] for e in runs["port"][1]["events"]}
    assert "prefill_scan_dispatch" not in names and "step_dispatch" in names
    assert runs["port"][2].readbacks == \
        runs["port"][1]["profile"]["work"]["host_syncs"]
