"""The port's fleet router vs the JAX serve stack, on the CPU.

Analogues of ``tests/test_fleet.py`` on the TINY Llama of
``test_serve.make_im`` (``max_seq_len`` 128, so a paged cache can take the
kernels' 64-position pages):

* against the JAX ``FleetRouter`` on the same prompts, the same weights
  (``params_from_jax``) and the same ``FaultInjector`` schedule, greedy: a
  replica killed mid-decode, then the same under seeded dispatch faults
  and retry exhaustion; the streams, outcomes, per-request placement and
  failover counts, the fleet's history and every telemetry event (name,
  arguments and timestamp on one step clock per side) are equal (the JAX
  side with ``use_pallas=True``, its kernels in interpret mode, so both
  take the tiled prefill stretch and tick alike);
* against the port's own single manager, greedy and seeded: a replica
  killed mid-decode, during prefill and during a rolling migration's
  drain, with the dead replica's KV torn down (buffers freed, no rid
  left holding attribution); the rolling migration never closes more
  than one replica; the arrival loop's records; ``LLM.fleet``.

The replicas of one side share one model's parameter tensors, as the
card's fleet does (each ``InferenceManager`` keeps its own KV).  The
health state machine, admission under shrink and the lifecycle are in
``test_torch_fleet_chaos.py``; ``test_torch_migration.py`` and
``test_torch_replay.py`` use this file's helpers.  Seeded sampling matches
the reference in distribution only (the port draws with its own hash,
``serve/inference_manager.py:fold_uniform``), so the seeded cases
hold the port to itself.
"""

import gc
import weakref

import numpy as np
import pytest

import flexflow_tpu.obs as JO
import flexflow_tpu.serve as JS
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS

from test_serve import make_im
from test_serving_under_load import VirtualClock
# the JAX-parity telemetry helpers: one event tuple per trace event
# (``recompiles_total`` left out), on a clock that steps at every read
from test_torch_obs import StepClock, events
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, _one_thread  # noqa: F401

SIDES = {"jax": (JS, JO), "port": (PS, PO)}
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [13, 8, 1]]
LONG_PROMPT = [5, 3, 7, 2, 9, 4, 8, 6, 1, 11, 13, 10]   # spans prefill ticks
MAX_SEQ = 128
PAGE = 64


def greedy(side="port", max_new=8):
    return SIDES[side][0].GenerationConfig(max_new_tokens=max_new)


def seeded(side="port", max_new=8):
    return SIDES[side][0].GenerationConfig(
        max_new_tokens=max_new, temperature=0.8, top_p=0.9, seed=5)


def assert_events_equal(want, got):
    for i, (a, b) in enumerate(zip(want, got)):
        assert a == b, f"event {i}: {a} != {b}"
    assert len(want) == len(got)


# ---------------------------------------------------------------------------
# deployments: JAX replicas, and port replicas sharing one model
# ---------------------------------------------------------------------------
_JAX_IMS = {}


def jax_im(index=0, max_tokens=16, max_seq=MAX_SEQ, page=None):
    """A JAX replica deployment with its own buffers and programs: replica
    0 is ``make_im``'s (cached across the test files), the others are
    built here once per process.  All start from seed 7's weights and
    empty caches."""
    if index == 0:
        return make_im(max_tokens=max_tokens, max_seq=max_seq,
                       use_pallas=True, kv_page_size=page)
    import jax

    key = (index, max_tokens, max_seq, page)
    im = _JAX_IMS.get(key)
    if im is None:
        from flexflow_tpu import FFConfig, FFModel
        from flexflow_tpu.parallel.mesh import make_mesh

        from test_serve import TINY

        ff = FFModel(FFConfig(), mesh=make_mesh({"tp": 1},
                                                jax.devices()[:1]))
        JS.build_model(ff, TINY, max_tokens)
        im = JS.InferenceManager(
            ff, max_requests=2, max_tokens_per_batch=max_tokens,
            max_seq_len=max_seq, use_pallas=True, kv_page_size=page)
        _JAX_IMS[key] = im
    im.init_operators_inference(rng=jax.random.PRNGKey(7))
    return im


class PortWeights:
    """One port model (``cfg``'s shape) whose parameter tensors every
    replica built from it shares: the JAX manager's (``params_from_jax``)
    or seeded random ones.  The first deployment fills them; the others
    allocate only their caches."""

    def __init__(self, jim=None, seed=3, cfg=CFG):
        self.model = PS.build_model(cfg)
        self.params = None
        if jim is not None:
            self.params = PS.params_from_jax(
                {n: {k: np.asarray(v) for k, v in g.items()}
                 for n, g in jim.params.items()}, cfg, "cpu")
        self.seed = seed
        self.filled = False

    def im(self, max_tokens=16, max_seq=MAX_SEQ, page=None, max_requests=2,
           max_spec_tokens=0, topk=0):
        im = PS.InferenceManager(
            self.model, max_requests=max_requests,
            max_tokens_per_batch=max_tokens, max_seq_len=max_seq,
            device="cpu", kv_page_size=page,
            max_spec_tokens=max_spec_tokens, topk=topk)
        if self.filled:
            im.allocate_kv_cache()
        else:
            im.init_operators_inference(self.params, seed=self.seed)
            self.filled = True
        return im


_WEIGHTS = {}


def port_weights():
    """The port-only tests' shared seeded weights (built once)."""
    if "w" not in _WEIGHTS:
        _WEIGHTS["w"] = PortWeights()
    return _WEIGHTS["w"]


_BASELINES = {}


def baseline(gen_fn, prompts, max_tokens=16):
    """The port's single-manager streams on ``port_weights`` (memoized):
    fleet serving must give them whatever the routing or failures."""
    key = (gen_fn.__name__, tuple(map(tuple, prompts)), max_tokens)
    if key not in _BASELINES:
        rm = PS.RequestManager(port_weights().im(max_tokens), gen_fn())
        _BASELINES[key] = rm.generate(prompts)
    return _BASELINES[key]


def port_fleet(n, gen, max_tokens=16, **kw):
    w = port_weights()
    return PS.FleetRouter([w.im(max_tokens) for _ in range(n)], gen=gen,
                          **kw)


def kill_spy(fleet):
    """Capture the victim's in-flight statuses at its death."""
    seen = {}
    orig = fleet.kill_replica

    def spy(name, reason="operator kill"):
        rep = fleet._by_name(name)
        seen["statuses"] = [(r.rid, r.status.name, len(r.generated))
                            for r in rep.rm._active()]
        seen["admission_closed"] = rep.rm.admission_closed
        return orig(name, reason)

    fleet.kill_replica = spy
    return seen


def fleet_view(fleet, out):
    """What a fleet run leaves, side-independent."""
    return {
        "streams": out,
        "outcomes": {rid: (r.status.name, r.outcome)
                     for rid, r in sorted(fleet.requests.items())},
        "placement": dict(sorted(fleet.placement.items())),
        "failovers": dict(sorted(fleet._failover_counts.items())),
        "history": fleet.history,
        "states": [(rep.name, rep.state.name, rep.dispatched, rep.leaked)
                   for rep in fleet.replicas],
        "ticks": fleet.ticks,
    }


# ---------------------------------------------------------------------------
# against the JAX FleetRouter
# ---------------------------------------------------------------------------
def run_reference_case(side, case):
    S, O = SIDES[side]
    if side == "jax":
        ims = [jax_im(i) for i in range(2)]
    else:
        w = PortWeights(jax_im(0))
        ims = [w.im() for _ in range(2)]
    tel = O.Telemetry(clock=StepClock())
    kw = {}
    if case == "faults":
        # a fleet_dispatch fault on replica1, and step faults that
        # exhaust a zero-retry budget: the on_exhausted hook fails the
        # batch over instead of failing it
        kw = dict(fault_injector=S.FaultInjector(
            seed=3, p_by_site={"fleet_dispatch:replica1": 0.5, "step": 0.4},
            max_faults=3), resilience=S.ResilienceConfig(
            retry=S.RetryPolicy(max_retries=0, backoff_s=0.0)))
    fleet = S.FleetRouter(ims, gen=greedy(side), telemetry=tel, **kw)
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2    # the kill lands mid-decode
        rep.rm._sleep = lambda s: None
    seen = kill_spy(fleet)
    fleet.schedule_kill("replica0", at_tick=3)
    out = fleet.generate(PROMPTS)
    view = fleet_view(fleet, out)
    view["victims"] = seen["statuses"]
    if "fault_injector" in kw:
        view["injected"] = kw["fault_injector"].injected
    return view, events(tel), fleet


@pytest.mark.parametrize("case", ["kill", "faults"])
def test_fleet_failover_matches_reference(case):
    """A replica killed mid-decode (and, ``faults``, seeded
    ``fleet_dispatch`` and ``step`` faults under a zero-retry budget):
    streams, outcomes, placement, failover counts, history and the event
    list equal the JAX fleet's."""
    want, want_ev, _ = run_reference_case("jax", case)
    got, got_ev, fleet = run_reference_case("port", case)
    assert got == want
    assert_events_equal(want_ev, got_ev)
    assert any(st == "DECODING" and n > 0 for _, st, n in got["victims"])
    assert got["failovers"] and all(
        fleet.placement[rid] == "replica1" for rid in got["failovers"])
    assert all(o == ("COMPLETED", "ok") for o in got["outcomes"].values())
    names = [e[0] for e in got_ev]
    assert "replica_dead" in names and "request_failed_over" in names
    if case == "faults":
        assert got["injected"] == 3 and "dispatch_fault" in names


# ---------------------------------------------------------------------------
# against the port's own single manager
# ---------------------------------------------------------------------------
def test_fleet_matches_single_replica_and_spreads_load():
    fleet = port_fleet(3, greedy())
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    assert len(set(fleet.placement.values())) == 3
    snap = fleet.fleet_snapshot()
    assert snap["healthy"] == 3 and snap["alive"] == 3


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_replica_death_mid_decode_bit_identical(gen_fn):
    fleet = port_fleet(2, gen_fn())
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    seen = kill_spy(fleet)
    fleet.schedule_kill("replica0", at_tick=3)
    assert fleet.generate(PROMPTS) == baseline(gen_fn, PROMPTS)
    assert any(st == "DECODING" and n > 0 for _, st, n in seen["statuses"])
    dead = fleet._by_name("replica0")
    assert dead.state is PS.ReplicaState.DEAD and dead.leaked == []
    assert dead.rm.im.state is None and not dead.rm.im.ready
    for rid, _, _ in seen["statuses"]:
        assert fleet._failover_counts[rid] == 1
        assert fleet.placement[rid] == "replica1"
        assert fleet.requests[rid].status is PS.RequestStatus.COMPLETED


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_replica_death_during_prefill_bit_identical(gen_fn):
    """A pure-prefill wave finishes in one tick (the prefill stretch), so
    the long prompt arrives while replica0 decodes: its tiled take
    starves behind the decode row for ``starvation_limit`` steps, then
    feeds 7 of its 12 tokens, and the kill lands there."""
    prompts = [PROMPTS[1], PROMPTS[2], LONG_PROMPT]
    fleet = port_fleet(2, gen_fn(), max_tokens=8)
    seen = {}
    kill = fleet.kill_replica

    def spy(name, reason="operator kill"):
        seen["active"] = [(r.rid, r.status.name, r.prefill_offset)
                          for r in fleet._by_name(name).rm._active()]
        return kill(name, reason)

    fleet.kill_replica = spy
    fleet.schedule_kill("replica0", at_tick=6)
    rids = [fleet.register(p) for p in prompts[:2]]
    fleet._fleet_tick()
    rids.append(fleet.register(prompts[2]))
    out = fleet.serve_all()
    assert [out[r] for r in rids] == baseline(gen_fn, prompts, 8)
    assert (rids[2], "PREFILLING", 7) in seen["active"]
    assert fleet._failover_counts[rids[2]] == 1
    assert fleet._by_name("replica0").leaked == []
    assert all(r.status is PS.RequestStatus.COMPLETED
               for r in fleet.requests.values())


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_replica_death_during_rolling_drain_bit_identical(gen_fn):
    w = port_weights()
    fleet = port_fleet(2, gen_fn())
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.request_rolling_migration(
        "tp1_pp1_m1_paged64", lambda cand: w.im(page=PAGE),
        migration_config=PS.MigrationConfig(auto=False, defer_ticks=1,
                                            drain_grace_ticks=3))
    seen = kill_spy(fleet)
    fleet.schedule_kill("replica0", at_tick=3)   # inside the drain
    assert fleet.generate(PROMPTS) == baseline(gen_fn, PROMPTS)
    assert seen["admission_closed"]
    assert fleet._by_name("replica0").leaked == []
    done = [h for h in fleet.history
            if h["event"] == "rolling_migration_completed"]
    assert len(done) == 1 and fleet._rolling is None
    outcomes = {r["replica"]: r["outcome"] for r in done[0]["replicas"]}
    assert outcomes == {"replica0": "died_mid_migration",
                        "replica1": "completed"}
    assert fleet._by_name("replica1").rm.im.kv.paged


def test_rolling_migration_never_stops_serving():
    w = port_weights()
    fleet = port_fleet(3, greedy())
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    floor = []
    tick = fleet._fleet_tick

    def spy():
        tick()
        floor.append(fleet.replicas_serving())

    fleet._fleet_tick = spy
    old = [rep.rm.im for rep in fleet.replicas]
    fleet.request_rolling_migration("tp1_pp1_m1_paged64",
                                    lambda cand: w.im(page=PAGE))
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    done = [h for h in fleet.history
            if h["event"] == "rolling_migration_completed"]
    assert len(done) == 1
    assert all(r["outcome"] == "completed" for r in done[0]["replicas"])
    assert all(rep.rm.im.kv.paged for rep in fleet.replicas)
    assert all(im.state is None for im in old)   # incumbents torn down
    assert floor and min(floor) >= 2


def test_fleet_arrivals_records_and_schema(tmp_path):
    tel = PO.Telemetry(clock=VirtualClock(0.001))
    fleet = port_fleet(3, greedy(max_new=6), telemetry=tel)
    fleet.schedule_kill("replica0", at_tick=4)
    arrivals = [(0.002 * i, PROMPTS[i % 3], 6) for i in range(6)]
    recs = fleet.serve_with_arrivals(arrivals, clock=VirtualClock(0.001))
    assert len(recs) == 6
    want = baseline(greedy, PROMPTS)
    for rid, rec in recs.items():
        assert rec["outcome"] == "ok"
        assert rec["tokens"] == want[rid % 3][:6]
        assert "queue_wait_s" in rec and "prefill_s" in rec
    assert all(r["replica"] != "replica0" for r in recs.values()
               if r["failovers"])
    summ = PO.under_load_summary(recs)
    assert summ["outcomes"] == {"ok": 6}
    assert sum(s["requests"] for s in summ["per_replica"].values()) == 6
    assert summ["failovers"] == sum(r["failovers"] for r in recs.values())
    paths = tel.export(str(tmp_path), prefix="fleet")
    assert PO.validate_jsonl(paths["jsonl"]) == []
    report = PO.summarize_jsonl(paths["jsonl"])
    assert report["fleet"]["counters"]["replica_deaths"] == 1
    assert report["fleet"]["counters"]["fleet_replicas_alive"] == 2.0


def test_llm_fleet_routes_over_compiled_llms():
    """``LLM.fleet`` over compiled ``LLM``s, the second sharing the first's
    parameter tensors (``share_weights_with``): a kill mid-decode gives
    the streams of one ``LLM``'s ``generate``."""
    caps = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=MAX_SEQ,
                device="cpu", generation_config=greedy())
    llms = [PS.LLM(CFG).compile(**caps)]
    llms.append(PS.LLM(CFG).compile(**caps, share_weights_with=llms[0]))
    assert llms[1].im.model is llms[0].im.model
    assert llms[1].im.kv is not llms[0].im.kv
    with pytest.raises(ValueError, match="share_weights_with"):
        PS.LLM(CFG).compile(**caps, share_weights_with=PS.LLM(CFG))
    fleet = PS.LLM.fleet(llms, gen=llms[0].rm.gen)
    assert [rep.rm for rep in fleet.replicas] == [llm.rm for llm in llms]
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.schedule_kill("replica0", at_tick=3)
    got = fleet.generate(PROMPTS)
    assert got == PS.LLM(CFG).compile(**caps).generate(PROMPTS)
    with pytest.raises(RuntimeError, match="compile"):
        PS.LLM.fleet([PS.LLM(CFG)])


def test_fleet_telemetry_off_is_bit_identical():
    fleet = port_fleet(2, greedy(),
                       telemetry=PO.Telemetry(clock=VirtualClock(0.001)))
    fleet.schedule_kill("replica1", at_tick=3)
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)


@pytest.mark.parametrize("page", [None, PAGE], ids=["contiguous", "paged"])
def test_dead_replica_teardown_frees_its_buffers(page):
    """A killed replica's cache tensors are garbage once it is torn down
    (on the card their memory returns; ``test_torch_cuda.py`` measures
    it), while the survivor and the shared weights are untouched."""
    w = port_weights()
    fleet = PS.FleetRouter([w.im(page=page) for _ in range(2)], gen=greedy())
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    kv = fleet.replicas[0].rm.im.kv
    refs = [weakref.ref(t) for bufs in kv.state.values()
            for t in bufs.values()]
    weights = [p.data_ptr() for p in w.model.parameters()]
    fleet.schedule_kill("replica0", at_tick=3)
    assert fleet.generate(PROMPTS) == baseline(greedy, PROMPTS)
    gc.collect()
    assert refs and all(r() is None for r in refs)
    assert kv.state is None and kv.allocated_bytes() == 0
    assert kv.attributed_rids() == []
    if page:
        assert kv.pages_held() == 0 and not kv._entries
    assert fleet.replicas[1].rm.im.kv.state is not None
    assert [p.data_ptr() for p in w.model.parameters()] == weights
