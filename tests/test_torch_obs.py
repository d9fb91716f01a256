"""The port's serving telemetry vs the JAX serve stack, on the CPU.

The same seeded workload runs through the JAX package's managers and the
port's (the TINY Llama of ``test_serve.make_im``, its params carried
across by ``params_from_jax``; the JAX side with ``use_pallas=True``, its
kernels in interpret mode, so both take the tiled prefill stretch), each
with a ``Telemetry`` and a ``StepProfiler`` on one clock.  Held equal,
exactly:

* the event lists: name, category, track, phase, timestamp, duration and
  arguments of every event, the profiler's per-tick ``step_profile``
  instants (the tick's work-counter deltas) among them, for ``generate``
  (fp, int8 and paged caches), ``serve_with_arrivals`` (Poisson arrivals
  joining chained stretches; a paged cache with a host tier, a
  preemption, a spill and a restore) and ``SpecInferManager`` (all rows
  speculating; spec and plain rows with a flip and the commit flush);
* the metrics snapshot, the workload profile and the memory ledger;
* ``summarize_jsonl`` of the two exports.

The one field left out everywhere is ``recompiles_total``: the reference
counts its jit compiles, eager PyTorch has none (the port's reads 0,
``test_torch_profiler.py``).  Clocks: ``generate`` runs on a clock that
advances at every read, so the two stacks must read it at the same sites
in the same order; the arrival loop runs on a clock that advances at every
read of the loop (``LoopClock``), which the telemetry reads without moving
(``ManualClock``), so a telemetry read cannot move the schedule.

Also: the port's streams are bit-identical with every hook on and off,
``LLM.compile(telemetry=..., slo=...)`` equals driving the managers
directly, ``LLM.health`` and the live-migration and fleet entry points,
the CLI report, and the calibration store's default.
"""

import json

import numpy as np
import pytest

import flexflow_tpu.obs as JO
import flexflow_tpu.serve as JS
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS

from test_serve import TINY, make_im
from test_serving_under_load import poisson_arrivals
from test_torch_lifecycle import LONG, port_im
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, _one_thread  # noqa: F401

SIDES = {"jax": (JS, JO), "port": (PS, PO)}
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
PAGE = 64


class ManualClock:
    """A clock that moves only when told to (or, as a view of a
    ``LoopClock``, when the serve loop reads that one)."""

    def __init__(self, source=None):
        self.t = 0.0
        self.source = source

    def __call__(self):
        return self.source.t if self.source is not None else self.t

    def advance(self, dt):
        self.t += dt


class StepClock:
    """Advances a fixed step at every read."""

    def __init__(self, step=0.25):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


class LoopClock(StepClock):
    """The arrival loop's clock: a fixed step a read, and a callback fired
    once when ``ready()`` holds (a preemption, a flip); ``when`` adds more
    such triggers."""

    def __init__(self, step=0.01, ready=None, fn=None):
        super().__init__(step)
        self.ready, self.fn, self.fired = ready, fn, False
        self.triggers = []

    def when(self, ready, fn):
        self.triggers.append([ready, fn])

    def __call__(self):
        t = super().__call__()
        if self.ready is not None and not self.fired and self.ready():
            self.fired = True
            self.fn()
        for trig in self.triggers:
            if trig[1] is not None and trig[0]():
                fn, trig[1] = trig[1], None
                fn()
        return self.t


def jax_im(paged=False, kv_dtype=None, **kw):
    return make_im(max_seq=128, use_pallas=True, kv_dtype=kv_dtype,
                   kv_page_size=PAGE if paged else None, **kw)


# the paged allocator's cumulative counters (its gauges publish them)
CUMULATIVE = ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
              "cow_copies", "pages_evicted", "pages_mapped", "pages_spilled",
              "pages_restored", "swap_bytes", "recompute_tokens_saved",
              "restore_failures")


def deployment(side, paged=False, kv_dtype=None, **kw):
    """The JAX manager, or a port manager holding the same params (the
    JAX one is re-initialised from its seed first, so both sides start
    from the same weights and empty caches; ``make_im`` caches it, so its
    ops lose an earlier test's int8 marks (the weights are float again),
    and its paged allocator an earlier test's host tier and cumulative
    counters, as the port's new one starts without them)."""
    jim = jax_im(paged, kv_dtype, **kw)
    if side == "jax":
        for node in jim.model.graph.nodes:
            if getattr(node.op, "quantization", None) is not None:
                node.op.quantization = None
        if paged:
            jim.kv.attach_host_tier(0)
            for name in CUMULATIVE:
                if hasattr(jim.kv, name):
                    setattr(jim.kv, name, 0)
        return jim
    return port_im(jim, kv_dtype=kv_dtype, page=PAGE if paged else None)


def strip(doc, key="recompiles_total"):
    """``doc`` without ``key`` at any depth."""
    if isinstance(doc, dict):
        return {k: strip(v, key) for k, v in doc.items() if k != key}
    if isinstance(doc, (list, tuple)):
        return [strip(v, key) for v in doc]
    return doc


def events(tel):
    """Every trace event as a comparable tuple."""
    return [(e["name"], e.get("cat"), e.get("tid"), e.get("ph"),
             e.get("ts"), e.get("dur"),
             json.dumps(strip(e.get("args") or {}), sort_keys=True))
            for e in tel.trace.trace_events()]


def observed(tel, prof):
    """What a run leaves in its telemetry and profiler."""
    return {"events": events(tel),
            "metrics": strip(tel.metrics.snapshot()),
            "workload": tel.workload.snapshot(),
            "memory": tel.memory.report(),
            "profile": strip(prof.report()),
            "per_request": {k: dict(v) for k, v in prof.per_request.items()}}


def assert_same(want, got):
    for key in want:
        if key == "events":
            for i, (a, b) in enumerate(zip(want[key], got[key])):
                assert a == b, f"event {i}: {a} != {b}"
            assert len(want[key]) == len(got[key])
        assert want[key] == got[key], key


def handles(side, clock):
    _, O = SIDES[side]
    return O.Telemetry(clock=clock), O.StepProfiler(clock=clock)


# ---------------------------------------------------------------------------
# generate: the incremental path
# ---------------------------------------------------------------------------
def run_generate(side, prompts, n_new, **dep):
    S, _ = SIDES[side]
    im = deployment(side, **dep)
    tel, prof = handles(side, StepClock())
    rm = S.RequestManager(im, S.GenerationConfig(max_new_tokens=n_new),
                          telemetry=tel, profiler=prof)
    out = rm.generate(prompts)
    return out, observed(tel, prof)


@pytest.mark.parametrize("cache", ["fp", "int8", "paged"])
def test_generate_events_match_reference(cache):
    """Prefill stretch, a chained decode stretch of two segments and a
    one-step trailer; every event, metric and counter equal (tolerance:
    exact)."""
    dep = {"fp": {}, "int8": {"kv_dtype": "int8"},
           "paged": {"paged": True}}[cache]
    prompts = PROMPTS if cache != "paged" else [LONG[:66], PROMPTS[1]]
    want_out, want = run_generate("jax", prompts, 8, **dep)
    got_out, got = run_generate("port", prompts, 8, **dep)
    assert got_out == want_out
    assert_same(want, got)
    names = {e[0] for e in got["events"]}
    assert {"prefill_stretch", "prefill_scan_dispatch", "decode_stretch",
            "decode_scan_dispatch", "serve_step", "step_dispatch",
            "request_first_token", "request_finish", "step_profile"} <= names
    if cache == "paged":
        assert "prefix_miss" in names


# ---------------------------------------------------------------------------
# serve_with_arrivals
# ---------------------------------------------------------------------------
def flush_index(kv):
    """Evict every prefix-index entry (as a busy pool would between a
    preemption and the readmission), so the readmission restores."""
    for key in list(kv._entries):
        kv._drop_entry(key)


def run_arrivals(side, arrivals, n_new, paged=False, preempt=False,
                 scan_chunk=None, res=None, lifecycle=False):
    S, _ = SIDES[side]
    im = deployment(side, paged=paged)
    clock = LoopClock()
    tel, prof = handles(side, ManualClock(clock))
    injector = None
    if lifecycle:
        # chip_smoke.py's phase 12 in small: seeded decode_scan faults, a
        # jump to the priority-5 arrival once both slots decode, a cancel
        res = dict(res, preemption=True,
                   retry=S.RetryPolicy(max_retries=2, backoff_s=0.0))
        injector = S.FaultInjector(seed=1, p_by_site={"decode_scan": 0.3},
                                   max_faults=2)
    rm = S.RequestManager(im, S.GenerationConfig(max_new_tokens=n_new),
                          telemetry=tel, profiler=prof,
                          resilience=S.ResilienceConfig(**(res or {})),
                          fault_injector=injector)
    rm._sleep = lambda s: None
    if scan_chunk:
        rm.scan_chunk = scan_chunk
    if lifecycle:
        clock.when(lambda: all(r in rm.requests and rm.requests[r].status
                               .name == "DECODING" for r in (0, 1)),
                   lambda: setattr(clock, "t", max(clock.t, 1000.0)))
        clock.when(lambda: 1 in rm.requests
                   and len(rm.requests[1].generated) >= 4,
                   lambda: rm.cancel(1))
    if preempt:
        def ready():
            req = rm.requests.get(0)
            return (req is not None and req.status.name == "DECODING"
                    and 2 <= len(req.generated) < n_new - 1)

        def fire():
            rm.preempt(0)
            flush_index(im.kv)

        clock.ready, clock.fn = ready, fire
    records = rm.serve_with_arrivals(arrivals, clock=clock)
    assert not preempt or clock.fired
    return records, observed(tel, prof)


@pytest.mark.parametrize("case", ["poisson", "paged_preempt_spill",
                                  "lifecycle"])
def test_arrivals_events_match_reference(case):
    """Arrivals on the loop clock: the records (their stamps and per
    request work included) and every event equal the reference's.  The
    paged case preempts rid 0 mid-decode with a host tier: its pages
    spill, the readmission restores them.  The lifecycle case is
    ``chip_smoke.py``'s phase 12 in small (a TTL expiring in the queue,
    a priority-5 arrival preempting a row, a cancel, seeded faults and
    retries): its schedule, tick by tick, is the reference's."""
    if case == "poisson":
        # the second arrival is due at the first segment boundary of a
        # chained stretch (a join); the last is malformed (rejected)
        arrivals = [(0.0, [3, 5, 7], 12), (0.075, PROMPTS[1], 8)] + [
            (t + 0.3, p, n) for t, p, n in poisson_arrivals(
                np.random.RandomState(5), 5, rate_per_s=30.0,
                vocab=TINY.vocab_size, max_new=8)] + [(0.4, [], 4)]
        kw = dict(n_new=8)
    elif case == "paged_preempt_spill":
        arrivals = [(0.0, LONG, 8), (0.0, LONG[5:48], 8)]
        kw = dict(n_new=8, paged=True, preempt=True, scan_chunk=2,
                  res=dict(host_tier_bytes=64 << 20))
    else:
        arrivals = [(0.0, LONG, 12), (0.0, LONG[7:40], 12),
                    (0.0, [4, 8, 15, 16], 12, {"ttl_s": 0.02}),
                    (1000.0, LONG[3:30], 12, {"priority": 5})]
        kw = dict(n_new=12, paged=True, scan_chunk=2, lifecycle=True,
                  res=dict(host_tier_bytes=64 << 20))
    want_rec, want = run_arrivals("jax", arrivals, **kw)
    got_rec, got = run_arrivals("port", arrivals, **kw)
    assert got_rec == want_rec
    assert_same(want, got)
    names = [e[0] for e in got["events"]]
    if case == "poisson":
        assert "request_prefill_start" in names and "request_reject" in names
        assert got["metrics"]["stretch_joins"] > 0
    elif case == "paged_preempt_spill":
        for name in ("request_preempt", "kv_spill", "kv_restore",
                     "request_admit"):
            assert name in names, name
        assert got["metrics"]["kv_pages_spilled"] > 0
    else:
        for name in ("request_preempt", "kv_spill", "request_timeout",
                     "request_cancel", "dispatch_fault", "dispatch_retry"):
            assert name in names, name


# ---------------------------------------------------------------------------
# speculative serving
# ---------------------------------------------------------------------------
def spec_pair(side):
    """A target and a perfect draft (the target's own weights) with the
    spec buffers, on the JAX side and carried to the port."""
    S, _ = SIDES[side]
    kw = dict(max_tokens=16, max_requests=2, max_seq=128, use_pallas=True)
    jllm = make_im(max_spec=7, **kw)
    jssm = make_im(max_spec=7, topk=2, **kw)
    if side == "jax":
        return jllm, jssm
    from test_torch_spec import port_im as spec_port_im

    return (spec_port_im(jllm, max_spec=7),
            spec_port_im(jssm, max_spec=7, topk=2))


def run_spec(side, mixed):
    S, _ = SIDES[side]
    llm, ssm = spec_pair(side)
    clock = LoopClock()
    tel, prof = handles(side, ManualClock(clock))
    rm = S.SpecInferManager(llm, ssm, S.GenerationConfig(max_new_tokens=8),
                            width=2, depth=3, telemetry=tel, profiler=prof)
    rm._sleep = lambda s: None
    if mixed:
        # spec and plain rows in one verify batch; the spec row flips off
        # at its third token (the commit flush), then on again
        arrivals = [(0.0, PROMPTS[0], 8, {"spec": True}),
                    (0.0, PROMPTS[1], 8, {"spec": False})]

        def ready():
            req = rm.requests.get(0)
            return req is not None and len(req.generated) >= 3

        clock.ready = ready
        clock.fn = lambda: rm.set_spec_mode(0, False)
        out = rm.serve_with_arrivals(arrivals, clock=clock)
        out = {rid: rec["tokens"] for rid, rec in out.items()}
    else:
        out = rm.generate(PROMPTS)
    return out, observed(tel, prof), rm


@pytest.mark.parametrize("mixed", [False, True], ids=["spec", "mixed"])
def test_spec_events_match_reference(mixed):
    """``SpecInferManager``: the macro-step and verify spans, the batch
    mix, acceptance, the draft's memory record and the summed KV gauges
    equal the reference's; mixed rows flip and flush."""
    want_out, want, _ = run_spec("jax", mixed)
    got_out, got, rm = run_spec("port", mixed)
    assert got_out == want_out
    assert_same(want, got)
    names = {e[0] for e in got["events"]}
    assert {"spec_macro_step", "spec_verify_round"} <= names
    assert got["metrics"]["spec_verify_rounds"] > 0
    assert any(k.endswith("_draft") for k in got["memory"]["plans"])
    if mixed:
        assert "spec_mode_changed" in names and rm.flushes >= 1


# ---------------------------------------------------------------------------
# hooks on and off: the port's own streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["generate", "arrivals_paged", "spec"])
def test_streams_bit_identical_with_hooks_on_and_off(path):
    """Telemetry, the profiler, an SLO policy with a brownout controller
    and a plan-health monitor change no token and no record (exact)."""
    def serve(on):
        hooks = {}
        if on:
            tel = PO.Telemetry()
            slo = PS.SLOPolicy.default()
            hooks = dict(telemetry=tel, profiler=PO.StepProfiler(),
                         slo=slo, brownout=PS.BrownoutController(slo),
                         plan_health=PO.PlanHealthMonitor(
                             tel, {"plan_key": "tp1_pp1_m1",
                                   "tpot_ms": 1.0, "ttft_ms": 1.0}))
        if path == "spec":
            llm, ssm = spec_pair("port")
            rm = PS.SpecInferManager(llm, ssm,
                                     PS.GenerationConfig(max_new_tokens=8),
                                     width=2, depth=3, **hooks)
            return rm.generate(PROMPTS)
        im = deployment("port", paged=path == "arrivals_paged")
        rm = PS.RequestManager(im, PS.GenerationConfig(max_new_tokens=8),
                               **hooks)
        if path == "generate":
            return rm.generate(PROMPTS)
        from test_serving_under_load import VirtualClock

        arrivals = [(0.0, LONG, 8), (0.02, PROMPTS[0], 8),
                    (0.05, PROMPTS[1], 8)]
        recs = rm.serve_with_arrivals(arrivals, clock=VirtualClock())
        return {r: {k: v for k, v in rec.items() if k not in ("work",
                                                                "slo_class")}
                for r, rec in recs.items()}

    assert serve(True) == serve(False)


# ---------------------------------------------------------------------------
# the export, its report, the CLI
# ---------------------------------------------------------------------------
def test_summarize_jsonl_matches_reference(tmp_path):
    """Both stacks export a Poisson run; ``summarize_jsonl`` of the two
    JSONLs is equal (their timestamps are equal too: the same clock), and
    the port's ``trace_report`` CLI prints it and validates the file."""
    arrivals = poisson_arrivals(np.random.RandomState(3), 4,
                                rate_per_s=30.0, vocab=TINY.vocab_size,
                                max_new=5)
    summaries = {}
    for side in ("jax", "port"):
        S, O = SIDES[side]
        clock = LoopClock()
        tel, prof = handles(side, ManualClock(clock))
        prof.bind(tel)
        rm = S.RequestManager(deployment(side),
                              S.GenerationConfig(max_new_tokens=5),
                              telemetry=tel, profiler=prof)
        rm.serve_with_arrivals(arrivals, clock=clock)
        paths = tel.export(str(tmp_path / side))
        summaries[side] = strip(
            __import__(O.__name__ + ".report", fromlist=["x"])
            .summarize_jsonl(paths["jsonl"]))
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["requests"] == 4
    from flexflow_tpu_torch.tools import trace_report

    path = str(tmp_path / "port" / "telemetry.jsonl")
    assert trace_report.main(["--check", path]) == 0
    assert trace_report.main([path]) == 0


def test_llm_compile_hooks_equal_driving_the_managers():
    """``LLM.compile(telemetry=..., profiler=..., slo=..., brownout=...,
    plan_health=...)`` reaches the manager as the reference's does: the
    events equal those of a RequestManager built by hand on the same
    weights; ``health()`` runs the monitor; ``attach_migration`` attaches
    a controller to the manager and ``LLM.fleet`` routes over it, the
    telemetry handle shared."""
    cfg = PS.ServeModelConfig(**{**CFG.__dict__})
    caps = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
                device="cpu")

    def hooks():
        tel = PO.Telemetry(clock=StepClock())
        slo = PS.SLOPolicy.default()
        return dict(telemetry=tel, profiler=PO.StepProfiler(clock=StepClock()),
                    slo=slo, brownout=PS.BrownoutController(slo),
                    plan_health=PO.PlanHealthMonitor(
                        tel, {"plan_key": "tp1_pp1_m1", "tpot_ms": 50.0,
                              "ttft_ms": 100.0}))

    h1 = hooks()
    llm = PS.LLM(cfg).compile(
        generation_config=PS.GenerationConfig(max_new_tokens=6), **caps,
        **h1)
    out = llm.generate(PROMPTS)
    h2 = hooks()
    im = PS.InferenceManager(PS.build_model(cfg), max_requests=2,
                             max_tokens_per_batch=16, max_seq_len=128,
                             device="cpu")
    im.init_operators_inference(
        {k: v.clone() for k, v in llm.im.model.state_dict().items()})
    rm = PS.RequestManager(im, PS.GenerationConfig(
        max_new_tokens=6, eos_token_id=cfg.eos_token_id), **h2)
    assert rm.generate(PROMPTS) == out
    assert events(h1["telemetry"]) == events(h2["telemetry"])
    assert h1["profiler"].report() == h2["profiler"].report()
    assert llm.rm.slo is h1["slo"] and llm.rm.brownout is h1["brownout"]
    report = llm.health()
    assert report["plan"] == "tp1_pp1_m1" and report["checks"] >= 2
    assert "ledger" in llm.memory_report()
    ctrl = llm.attach_migration(lambda plan: None)
    assert isinstance(ctrl, PS.MigrationController)
    assert llm.rm.migration is ctrl and ctrl.rm is llm.rm
    fleet = PS.LLM.fleet([llm], telemetry=h1["telemetry"])
    assert isinstance(fleet, PS.FleetRouter)
    assert fleet.replicas[0].rm is llm.rm
    assert fleet.telemetry is h1["telemetry"]
    assert PS.LLM(cfg).health() is None


def test_calibration_store_never_reads_the_reference_store(monkeypatch,
                                                           tmp_path):
    """The port's default store is its own artifact: the JAX package's
    TPU-measured store and its environment variable never reach it, and
    its own variable redirects or (empty) disables it."""
    import os

    from flexflow_tpu.obs import calibration as jax_calibration
    from flexflow_tpu_torch.obs import calibration

    monkeypatch.setenv("FLEXFLOW_TPU_CALIBRATION_STORE",
                       str(tmp_path / "tpu.json"))
    monkeypatch.delenv(calibration.STORE_ENV, raising=False)
    assert calibration.default_store_path() == calibration.DEFAULT_STORE_PATH
    assert calibration.DEFAULT_STORE_PATH.endswith(
        os.path.join("artifacts", "torch_calibration_store.json"))
    assert calibration.DEFAULT_STORE_PATH != jax_calibration.DEFAULT_STORE_PATH
    monkeypatch.setenv(calibration.STORE_ENV, "")
    assert calibration.default_store_path() is None
    monkeypatch.setenv(calibration.STORE_ENV, str(tmp_path / "port.json"))
    assert calibration.default_store_path() == str(tmp_path / "port.json")
    store = calibration.CalibrationStore.load()
    assert store.path is None and not store.components
    with pytest.raises(ValueError, match="path"):
        store.save()
    saved = calibration.CalibrationStore(str(tmp_path / "port.json"))
    assert saved.save() == str(tmp_path / "port.json")
