"""The port's traffic-trace capture and replay vs the JAX serve stack.

Analogues of ``tests/test_replay.py`` on ``test_torch_fleet.py``'s
deployments, on the CPU:

* against the JAX package: a trace that the JAX ``serve_with_arrivals``
  records loads in the port's ``TrafficTrace``, passes ``validate``, and
  replays on the port (the same weights through ``params_from_jax``) with
  ``verify`` at zero mismatches, greedy; the port's artifact equals the
  reference's line for line (``trace_meta``, ``arrival`` and ``outcome``
  lines, on the same virtual clock; the JAX side with ``use_pallas=True``)
  for one manager and for a fleet whose replica dies mid-run;
  ``plan_key_of`` gives the reference's keys; ``what_if`` prices a trace
  as the reference does;
* against the port itself, greedy and seeded: capture leaves the run as
  it is, a replay from the file alone (generation config, fault schedule
  and kills pinned from the artifact) reproduces every stream, outcome
  and failover count, a chaos fleet's included, and a session that
  crosses a live migration records once, with the successor's header as
  a continuation;
* the artifact's integrity stamps, the replay telemetry and
  ``tools/replay_report.py`` (``--check``, the summary, and
  ``--what-if``, priced by the planner's ``price_plan``;
  ``test_torch_machine_model.py`` holds it to the reference's script).
"""

import json
import types

import pytest

import flexflow_tpu.obs.replay as JR
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.obs.replay import (
    TRACE_VERSION,
    ReplayHarness,
    TrafficTrace,
    TrafficTraceRecorder,
    VirtualClock,
    plan_key_of,
    token_hash,
)
from flexflow_tpu_torch.tools import replay_report

# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_fleet import (  # noqa: F401
    PAGE,
    SIDES,
    PortWeights,
    _one_thread,
    greedy,
    jax_im,
    port_weights,
    seeded,
)

ARRIVALS = [
    (0.000, [3, 5, 7, 9], 6, {"priority": 1}),
    (0.002, [2, 4, 6], 6),
    (0.004, [13, 8, 1, 5, 11], 4, {"ttl_s": 5.0}),
]
BAD_ARRIVALS = [
    (0.000, [3, 5, 7], 6),
    (0.001, [2, 4], 6, {"priority": "not-an-int"}),   # rejected
    (0.002, [9, 1, 5], 6, {"bogus_knob": 1}),         # rejected
    (0.003, [6, 2, 8, 4], 6, {"ttl_s": 1e-6}),        # timeout
]


def record(rm, arrivals, path):
    recorder = TrafficTraceRecorder(path=str(path))
    recs = rm.serve_with_arrivals(list(arrivals), clock=VirtualClock(),
                                  record_trace=recorder)
    return recs, recorder


def lines(path):
    return [json.loads(ln) for ln in open(path)]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def record_manager(side, path):
    S, _ = SIDES[side]
    im = jax_im(0) if side == "jax" else PortWeights(jax_im(0)).im()
    return record(S.RequestManager(im, greedy(side)),
                  ARRIVALS + BAD_ARRIVALS[1:], path)


def record_fleet(side, path):
    S, _ = SIDES[side]
    if side == "jax":
        ims = [jax_im(i) for i in range(2)]
    else:
        w = PortWeights(jax_im(0))
        ims = [w.im() for _ in range(2)]
    fleet = S.FleetRouter(ims, gen=greedy(side, max_new=6))
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.schedule_kill("replica0", 3)
    arrivals = [(0.001 * i, a[1], 6) for i, a in enumerate(ARRIVALS * 2)]
    return record(fleet, arrivals, path)


@pytest.mark.parametrize("kind", ["manager", "fleet"])
def test_artifact_lines_equal_reference(tmp_path, kind):
    """The same run recorded by both stacks: every line equal, field for
    field (the header names the serving class, the same on both
    sides)."""
    run = record_manager if kind == "manager" else record_fleet
    run("jax", tmp_path / "jax.jsonl")
    run("port", tmp_path / "port.jsonl")
    want, got = lines(tmp_path / "jax.jsonl"), lines(tmp_path / "port.jsonl")
    assert [ln["kind"] for ln in got] == [ln["kind"] for ln in want]
    for a, b in zip(want, got):
        assert b == a
    meta = got[0]
    assert meta["plan"]["plan_key"] == "tp1_pp1_m1"
    if kind == "fleet":
        assert meta["fleet"]["kills"] == {"replica0": 3}
        assert any(ln.get("failovers") for ln in got[1:])
    else:
        assert sorted(ln["outcome"] for ln in got
                      if ln["kind"] == "outcome").count("rejected") == 2


def test_jax_recorded_trace_replays_in_the_port(tmp_path):
    """A trace of the JAX ``serve_with_arrivals`` (greedy, with a priority,
    a TTL and malformed options) validates and replays on the port's
    deployment of the same weights with zero mismatches."""
    path = tmp_path / "jax.jsonl"
    recs, _ = record_manager("jax", path)
    trace = TrafficTrace.load(str(path))
    assert trace.validate() == []
    harness = ReplayHarness(trace)
    rm = PS.RequestManager(PortWeights(jax_im(0)).im(),
                           PS.GenerationConfig(max_new_tokens=2))
    replayed = harness.replay(rm)
    assert rm.gen == PS.GenerationConfig(**trace.meta["gen"])
    fidelity = harness.verify(replayed)
    assert fidelity["bit_identical"], fidelity["mismatches"]
    assert fidelity["requests"] == len(recs) == 6


def test_plan_key_of_matches_reference():
    w = port_weights()
    for jim, page in ((jax_im(0), None), (jax_im(0, page=PAGE), PAGE)):
        assert plan_key_of(w.im(page=page)) == JR.plan_key_of(jim)
        assert JR.engine_shape_of(jim) == PO.replay.engine_shape_of(
            w.im(page=page))
    int8 = types.SimpleNamespace(kv_dtype="int8", kv_page_size=512)
    assert plan_key_of(int8) == JR.plan_key_of(int8) == \
        "tp1_pp1_m1_kvint8_paged512"


def mk_trace(side):
    """A hand-built trace: 4 simultaneous arrivals on a 2-slot plan, one
    with a TTL that a slow candidate misses."""
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [2, 4, 6, 8]]
    opts = [{"slo_class": "latency_critical"}, {"ttl_s": 0.02}, None, None]
    arrivals, outcomes = [], []
    for i, p in enumerate(prompts):
        a = {"kind": "arrival", "offset_s": 0.0, "prompt": p,
             "prompt_len": len(p), "prompt_hash": token_hash(p),
             "max_new": 4}
        if opts[i]:
            a["opts"] = opts[i]
        arrivals.append(a)
        toks = [10 + i] * 4
        outcomes.append({"kind": "outcome", "rid": i,
                         "trace_id": f"r{i:05d}", "outcome": "ok",
                         "tokens": toks, "tokens_hash": token_hash(toks),
                         "prompt_len": len(p), "arrival_s": 0.0,
                         "queue_wait_s": 0.0, "prefill_s": 0.001,
                         "kv_bytes": 0})
    meta = {"kind": "trace_meta", "version": TRACE_VERSION,
            "driver": "RequestManager", "gen": {"max_new_tokens": 4},
            "plan": {"plan_key": "tp1_pp1_m1", "max_requests": 2},
            "fault": None, "arrivals": 4, "requests": 4}
    cls = JR.TrafficTrace if side == "jax" else TrafficTrace
    return cls(meta=meta, arrivals=arrivals, outcomes=outcomes)


def test_what_if_prices_as_the_reference():
    """``what_if`` over a price dict (here the caller's; the CLI takes the
    planner's ``price_plan``): the records, summary and outcome mix equal the
    reference's for a fast and a slow candidate and a doubled fleet, and
    the diff takes ``tools/bench_compare.py``'s discipline."""
    harness = ReplayHarness(mk_trace("port"))
    ref = JR.ReplayHarness(mk_trace("jax"))
    cands = [({"tpot_s": 1e-4, "plan_key": "tp2_pp1_m1"}, 1),
             ({"tpot_ms": 20.0, "plan_key": "tp1_pp1_m1"}, 1),
             ({"tpot_s": 5e-3}, 2)]
    got = [harness.what_if(p, fleet_size=n) for p, n in cands]
    assert got == [ref.what_if(p, fleet_size=n) for p, n in cands]
    fast, slow, _ = got
    assert fast["outcomes"] == {"ok": 4}
    assert slow["outcomes"] == {"ok": 3, "timeout": 1}
    assert harness.diff(fast["summary"], fast["summary"])["ok"]
    res = harness.diff(fast["summary"], slow["summary"])
    assert res == ref.diff(fast["summary"], slow["summary"])
    assert not res["ok"]
    assert harness.recorded_summary() == ref.recorded_summary()
    with pytest.raises(ValueError, match="tpot"):
        harness.what_if({"plan_key": "nocost"})


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------
def test_recorder_artifact_roundtrip_and_integrity(tmp_path):
    path = tmp_path / "run.jsonl"
    records, recorder = record(
        PS.RequestManager(port_weights().im(), seeded()), ARRIVALS, path)
    assert recorder.saved_path == str(path)
    trace = TrafficTrace.load(str(path))
    assert trace.validate() == []
    meta = trace.meta
    assert meta["version"] == TRACE_VERSION
    assert meta["driver"] == "RequestManager" and meta["fault"] is None
    assert meta["gen"]["seed"] == 5 and meta["gen"]["temperature"] == 0.8
    assert meta["plan"]["plan_key"] == "tp1_pp1_m1"
    assert meta["arrivals"] == meta["requests"] == 3
    assert trace.arrival_tuples() == ARRIVALS
    recs = trace.records()
    assert {r: (v["tokens"], v["outcome"]) for r, v in recs.items()} == {
        r: (v["tokens"], v["outcome"]) for r, v in records.items()}
    tampered = TrafficTrace.load(str(path))
    next(o for o in tampered.outcomes if o["tokens"])["tokens"][0] ^= 1
    assert any("hash mismatch" in e for e in tampered.validate())
    raw = open(path).read().splitlines()
    head = json.loads(raw[0])
    head["version"] = TRACE_VERSION + 1
    (tmp_path / "future.jsonl").write_text(
        "\n".join([json.dumps(head)] + raw[1:]) + "\n")
    with pytest.raises(ValueError, match="version"):
        TrafficTrace.load(str(tmp_path / "future.jsonl"))
    (tmp_path / "junk.jsonl").write_text(
        raw[0] + "\n" + json.dumps({"kind": "mystery"}) + "\n")
    with pytest.raises(ValueError, match="unknown trace line kind"):
        TrafficTrace.load(str(tmp_path / "junk.jsonl"))


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy", "seeded"])
def test_fidelity_replay_bit_identical(tmp_path, gen_fn):
    w = port_weights()
    control = PS.RequestManager(w.im(), gen_fn()).serve_with_arrivals(
        list(ARRIVALS), clock=VirtualClock())
    path = tmp_path / "run.jsonl"
    recorded, _ = record(PS.RequestManager(w.im(), gen_fn()), ARRIVALS, path)
    assert {r: v["tokens"] for r, v in recorded.items()} == {
        r: v["tokens"] for r, v in control.items()}
    harness = ReplayHarness(TrafficTrace.load(str(path)))
    rm = PS.RequestManager(w.im(), PS.GenerationConfig(max_new_tokens=2))
    replayed = harness.replay(rm)
    assert rm.gen.seed == gen_fn().seed
    fidelity = harness.verify(replayed)
    assert fidelity["bit_identical"] and fidelity["requests"] == 3
    broken = {r: dict(v) for r, v in replayed.items()}
    rid = next(r for r in broken if broken[r]["tokens"])
    broken[rid]["tokens"] = [t + 1 for t in broken[rid]["tokens"]]
    assert any(m["field"] == "tokens"
               for m in harness.verify(broken)["mismatches"])
    del broken[rid]
    assert any(m["field"] == "presence"
               for m in harness.verify(broken)["mismatches"])


def test_malformed_options_and_ttl_replay_their_outcomes(tmp_path):
    w = port_weights()
    path = tmp_path / "opts.jsonl"
    recorded, _ = record(PS.RequestManager(w.im(), greedy()), BAD_ARRIVALS,
                         path)
    outcomes = sorted(r["outcome"] for r in recorded.values())
    assert outcomes == ["ok", "rejected", "rejected", "timeout"]
    trace = TrafficTrace.load(str(path))
    assert trace.arrival_tuples()[1][3] == {"priority": "not-an-int"}
    harness = ReplayHarness(trace)
    replayed = harness.replay(PS.RequestManager(w.im(), greedy()))
    assert harness.verify(replayed)["bit_identical"]
    assert sorted(r["outcome"] for r in replayed.values()) == outcomes


def chaos_arrivals():
    import numpy as np

    rng = np.random.RandomState(11)
    return [(0.002 * i,
             [int(x) for x in rng.randint(1, 63, size=rng.randint(3, 8))], 8,
             {"slo_class": "latency_critical" if i % 3 == 0 else "batch"})
            for i in range(14)]


def build_chaos_fleet(gen, telemetry=None, injector=None):
    w = port_weights()
    policy = PS.SLOPolicy.default(
        lc_reservation_frac=0.25, lc_ttft_p95_s=0.120, lc_tpot_p95_s=0.030,
        batch_max_pending=10, degraded_max_new_tokens=2)
    bo = PS.BrownoutController(
        policy, PS.BrownoutConfig(check_every=2, queue_depth_high=1,
                                  escalate_after=2, deescalate_after=3),
        telemetry=telemetry, clock=VirtualClock())
    fleet = PS.FleetRouter(
        [w.im() for _ in range(3)], gen=gen, telemetry=telemetry,
        resilience=PS.ResilienceConfig(kv_gate=True),
        fault_injector=injector, slo=policy, brownout=bo)
    for rep in fleet.replicas:
        rep.rm.chain_segments = False
    return fleet, bo


def test_fleet_chaos_replays_bit_identically_from_artifact(tmp_path):
    """Seeded dispatch faults, replica1 killed mid-run and a brownout
    ladder, seeded sampling: replayed from the file onto a fresh fleet
    with no injector, no kill and the wrong generation config."""
    path = tmp_path / "chaos.jsonl"
    inj = PS.FaultInjector(seed=11, p_by_site={"fleet_dispatch": 0.35},
                           max_faults=2)
    tel1 = PO.Telemetry(clock=VirtualClock())
    fleet1, bo1 = build_chaos_fleet(seeded(), tel1, inj)
    fleet1.schedule_kill("replica1", 4)
    recorder = TrafficTraceRecorder(path=str(path), telemetry=tel1)
    rec = fleet1.serve_with_arrivals(chaos_arrivals(), clock=VirtualClock(),
                                     record_trace=recorder)
    assert sum(r["failovers"] for r in rec.values()) > 0 and bo1.history
    assert inj.injected >= 1
    trace = TrafficTrace.load(str(path))
    assert trace.validate() == []
    assert trace.meta["driver"] == "FleetRouter"
    assert trace.meta["fleet"]["kills"] == {"replica1": 4}
    assert trace.meta["fault"]["seed"] == 11
    tel2 = PO.Telemetry(clock=VirtualClock())
    fleet2, bo2 = build_chaos_fleet(greedy(), tel2, None)
    harness = ReplayHarness(trace, telemetry=tel2)
    replayed = harness.replay(fleet2)
    assert fleet2.injector.seed == 11 and fleet2.gen.seed == 5
    fidelity = harness.verify(replayed)
    assert fidelity["bit_identical"], fidelity["mismatches"]
    assert [int(lv) for _, lv, _ in bo2.history] == [
        int(lv) for _, lv, _ in bo1.history]
    assert {r: v["tokens"] for r, v in replayed.items()} == {
        r: v["tokens"] for r, v in rec.items()}


def test_trace_spans_a_live_migration(tmp_path):
    """A session that migrates contiguous → paged mid-run records once:
    the successor's header is a continuation, every record lands, and the
    trace replays on the paged plan with zero mismatches."""
    w = port_weights()
    rm = PS.RequestManager(w.im(), seeded())
    rm.scan_chunk = 2
    ctrl = PS.MigrationController(
        rm, lambda cand: w.im(page=PAGE), plan={"plan_key": "tp1_pp1_m1"},
        config=PS.MigrationConfig(defer_ticks=1, drain_grace_ticks=1))
    ctrl.request_migration("tp1_pp1_m1_paged64")
    path = tmp_path / "mig.jsonl"
    recs, recorder = record(rm, ARRIVALS, path)
    assert ctrl.history[-1]["outcome"] == "completed" and ctrl.rm is not rm
    trace = TrafficTrace.load(str(path))
    assert trace.validate() == [] and len(trace.outcomes) == 3
    [cont] = trace.meta["continuations"]
    assert cont["plan"]["plan_key"] == "tp1_pp1_m1_paged64"
    harness = ReplayHarness(trace)
    replayed = harness.replay(PS.RequestManager(w.im(page=PAGE), greedy()))
    assert harness.verify(replayed)["bit_identical"]


def test_spec_manager_records_draft_tree_provenance():
    from test_torch_spec import SSM

    draft = PortWeights(seed=11, cfg=SSM)
    sm = PS.SpecInferManager(
        port_weights().im(max_tokens=32, max_spec_tokens=8),
        draft.im(max_tokens=32, max_seq=64, max_spec_tokens=8, topk=2),
        greedy(), width=2, depth=3)
    meta = sm.trace_run_meta()
    assert meta["driver"] == "SpecInferManager"
    assert (meta["spec"]["width"], meta["spec"]["depth"]) == (2, 3)
    assert meta["spec"]["draft_plan"]["max_seq_len"] == 64
    assert meta["plan"]["max_seq_len"] == 128


def test_replay_telemetry_schema_and_report(tmp_path):
    tel = PO.Telemetry(clock=VirtualClock())
    path = str(tmp_path / "mini.jsonl")
    recorder = TrafficTraceRecorder(path=path, telemetry=tel)
    recorder.begin_run({"driver": "RequestManager",
                        "gen": {"max_new_tokens": 4}})
    recorder.record_arrival(0.0, [1, 2], 4, None)
    recorder.finalize({0: {"trace_id": "r00000", "outcome": "ok",
                           "tokens": [7], "arrival_s": 0.0,
                           "prompt_len": 2}})
    trace = TrafficTrace.load(path)
    harness = ReplayHarness(trace, telemetry=tel)
    harness.what_if({"tpot_s": 1e-3})
    assert harness.verify(trace.records())["bit_identical"]
    assert not harness.verify({})["bit_identical"]
    snap = tel.metrics.snapshot()
    assert (snap["traces_recorded"], snap["replays_run"],
            snap["replay_mismatches"]) == (1, 3, 1)
    paths = tel.export(str(tmp_path), prefix="replaytest")
    assert PO.validate_jsonl(paths["jsonl"]) == []
    summary = PO.summarize_jsonl(paths["jsonl"])
    assert summary["replay"]["mismatches"] == [{"trace_id": "r00000",
                                               "field": "presence"}]
    assert len(summary["replay"]["completed"]) == 3
    assert summary["requests"] == 0


def test_healthy_replay_materializes_the_mismatch_counter():
    tel = PO.Telemetry(clock=VirtualClock())
    harness = ReplayHarness(mk_trace("port"), telemetry=tel)
    assert harness.verify(mk_trace("port").records())["bit_identical"]
    snap = tel.metrics.snapshot()
    assert snap["replay_mismatches"] == 0 and snap["replays_run"] == 1


def test_replay_report_cli(tmp_path, capsys):
    """``--check`` exits 0 on a clean artifact and 1 on a tampered one;
    the summary is ``under_load_summary`` of the recorded outcomes;
    ``--what-if`` prices the candidate with the planner and runs it
    through the what-if simulation."""
    path = tmp_path / "run.jsonl"
    recs, _ = record(PS.RequestManager(port_weights().im(), greedy()),
                     ARRIVALS, path)
    assert replay_report.main(["--check", str(path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["requests"] == 3
    assert replay_report.main([str(path), "--json",
                               str(tmp_path / "r.json")]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["recorded"] == PO.under_load_summary(
        TrafficTrace.load(str(path)).records())
    assert doc["recorded"]["outcomes"] == {"ok": 3}
    raw = lines(path)
    raw[-1]["tokens"] = raw[-1]["tokens"][:-1]
    (tmp_path / "bad.jsonl").write_text(
        "".join(json.dumps(ln) + "\n" for ln in raw))
    assert replay_report.main(["--check", str(tmp_path / "bad.jsonl")]) == 1
    capsys.readouterr()
    assert replay_report.main([str(path), "--what-if", "tp1_pp2_m2"]) == 0
    doc = json.loads(capsys.readouterr().out)
    [cand] = doc["what_if"]
    assert cand["candidate"]["plan_key"] == "tp1_pp2_m2"
    assert cand["summary"]["outcomes"] == {"ok": 3} and doc["diffs"] == []
