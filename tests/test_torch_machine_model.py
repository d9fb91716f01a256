"""The port's machine model, calibration loop and planner wiring, on the CPU.

* the pins of ``tests/test_calibration_loop.py`` on the port's
  ``MachineModel``, ``CalibrationLedger`` and ``CalibrationStore``, each
  with the reference's inputs and held to the reference's results: the
  ledger's geometric-mean scale and its low-confidence flag, the store's
  EWMA, clamp, gate, persistence and malformed files, the
  ``with_calibration`` fallbacks and their composition with
  ``with_store``, the loop end to end through ``search_serve_plan`` and
  ``price_plan`` (the store cuts the prediction error), the
  ``calibration="auto"`` consult (CUDA meshes only, the port's own
  environment variable); its workload flip is
  ``test_torch_serve_search.py::test_workload_flips_the_winner_as_the_reference``;
* ``MachineModel.for_mesh``: CUDA devices price as ``h100``, the CPU as
  ``cpu``, another device type raises; no ``h100`` constant is a value
  measured on a TPU, and ``artifacts/h100_calib.json`` names the card;
* the loop the planner closes: a ``PlanHealthMonitor`` whose
  ``search_fn`` is the port's ``search_serve_plan`` recommends what the
  reference's recommends (speculation off when acceptance drifts below
  the break-even), and a ``MigrationController`` moves a deployment to
  the searched ``tp1_pp2_m2`` plan with the streams unchanged;
* ``tools/replay_report.py --what-if`` prices candidates on a recorded
  CPU trace as the reference's ``scripts/replay_report.py`` does;
* F4: every port allocator's ``capacity_bytes()`` equals the JAX
  allocator's and its snapshot's; ``InjectedFault`` imports from
  ``flexflow_tpu_torch.serve``.
"""

import dataclasses
import importlib.util
import json
import os
import types

import pytest
import torch

import flexflow_tpu.obs as JO
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu.search.machine_model import TPU_SPECS as JAX_SPECS
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu.search.serve_search import price_plan as jax_price_plan
from flexflow_tpu.search.serve_search import (
    search_serve_plan as jax_search_serve_plan,
)
from flexflow_tpu_torch.obs import CalibrationLedger, CalibrationStore
from flexflow_tpu_torch.obs import StoreConfig
from flexflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from flexflow_tpu_torch.search import (
    H100_SOURCES,
    TPU_SPECS,
    MachineModel,
    price_plan,
    search_serve_plan,
)
from flexflow_tpu_torch.search.serve_search import _resolve_store
from flexflow_tpu_torch.serve.migration import plan_shape

from test_plan_health import ManualClock
from test_serve import TINY, make_im
from test_torch_serve_search import assert_close
from test_torch_tp_api import CFG, PROMPTS, caps, one
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (JO, JaxMachine, JAX_SPECS),
         "port": (PO, MachineModel, TPU_SPECS)}
# the TPUSpec defaults that came from a TPU: measured (mxu_efficiency,
# step_overhead, vmem_resident_bytes, spec_break_even_acceptance) or
# taken for a TPU host and program (the rest)
TPU_MEASURED = ("mxu_efficiency", "step_overhead", "vmem_resident_bytes",
                "spec_break_even_acceptance", "host_bandwidth",
                "host_latency", "overlap", "kernel_overhead")


# ---------------------------------------------------------------------------
# the ledger and the store, on the reference's inputs
# ---------------------------------------------------------------------------
def _ledger_case(O, case):
    led = O.CalibrationLedger()
    if case == "geomean":
        # ratios 0.5 and 2.0 cancel: the arithmetic mean would say 1.25
        led.predict("a", tpot_ms=2.0)
        led.measure("a", tpot_ms=1.0)
        led.predict("b", tpot_ms=2.0)
        led.measure("b", tpot_ms=4.0)
    elif case == "single":
        led.predict("a", x_ms=1.0)
        led.measure("a", x_ms=1.3)
    else:
        led.predict("a", d_ms=2.0)
        led.measure("a", d_ms=-1.0)   # a sign bug in a recorded field
    return led.report()


@pytest.mark.parametrize("case", ["geomean", "single", "non_positive"])
def test_ledger_aggregation_equals_reference(case):
    rep = _ledger_case(PO, case)
    assert rep == _ledger_case(JO, case)
    if case == "geomean":
        comp = rep["components"]["tpot_ms"]
        assert comp["suggested_scale"] == 1.0 and comp["mean_ratio"] == 1.0
        assert comp["n"] == 2 and not comp["low_confidence"]
    elif case == "single":
        comp = rep["components"]["x_ms"]
        assert comp["low_confidence"] and comp["n"] == 1
        assert abs(comp["suggested_scale"] - 1.3) < 1e-9
    else:
        assert rep["plans"]["a"]["d_ms"]["ratio"] == -0.5
        assert "d_ms" not in rep["components"]


def _one_run_report(O, ratio, n=2):
    led = O.CalibrationLedger()
    for i in range(n):
        led.predict(f"p{i}", tpot_ms=1.0)
        led.measure(f"p{i}", tpot_ms=ratio)
    return led.report()


def test_store_ewma_clamp_gate_and_persistence(tmp_path):
    scales = {}
    for side, (O, _, _) in SIDES.items():
        path = str(tmp_path / f"{side}.json")
        store = O.CalibrationStore(path, O.StoreConfig(
            ewma_alpha=0.5, min_samples=3, scale_max=4.0))
        got = []
        for ratio in (2.0, 3.0, 100.0):   # gated, blended, clamped
            store.update(_one_run_report(O, ratio, n=2))
            got.append(store.scale_for("tpot_ms"))
        store.save()
        again = O.CalibrationStore.load(path, O.StoreConfig(min_samples=3))
        got += [again.runs, again.scale_for("tpot_ms"),
                again.components["tpot_ms"]["n"], store.scales()]
        scales[side] = got
    assert scales["port"] == scales["jax"]
    assert scales["port"][:3] == [1.0, pytest.approx(2.5),
                                  pytest.approx(0.5 * 2.5 + 0.5 * 4.0)]
    assert scales["port"][3] == 3 and scales["port"][5] == 6


def test_store_missing_and_malformed_files_load_empty(tmp_path):
    missing = CalibrationStore.load(str(tmp_path / "nope.json"))
    assert not missing and missing.scale_for("anything") == 1.0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert not CalibrationStore.load(str(bad))
    weird = tmp_path / "weird.json"
    weird.write_text(json.dumps(
        {"runs": "x", "components": {"a": 1, "b": {"n": 5}}}))
    st = CalibrationStore.load(str(weird))
    assert not st and st.scale_for("a") == 1.0
    assert not JO.CalibrationStore.load(str(weird))


def test_ledger_commit_into_store(tmp_path):
    views = {}
    for side, (O, _, _) in SIDES.items():
        led = O.CalibrationLedger()
        for i, m in enumerate((1.4, 1.6)):
            led.predict(f"p{i}", tpot_ms=1.0)
            led.measure(f"p{i}", tpot_ms=m)
        store = O.CalibrationStore(str(tmp_path / f"{side}.json"),
                                   O.StoreConfig(min_samples=2))
        views[side] = (led.commit(store), store.scale_for("tpot_ms"))
    assert views["port"] == views["jax"]
    assert views["port"][0]["tpot_ms"]["applied"]
    assert views["port"][1] == pytest.approx((1.4 * 1.6) ** 0.5, rel=1e-3)


# ---------------------------------------------------------------------------
# the machine model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["missing", "malformed", "partial"])
def test_with_calibration_fallbacks(tmp_path, case):
    p = tmp_path / "calib.json"
    if case == "malformed":
        p.write_text("{{{{")
    elif case == "partial":
        p.write_text(json.dumps({"step_overhead": 7e-6, "unknown_key": 123}))
    specs = {side: dataclasses.asdict(
        M(S["cpu"]).with_calibration(str(p)).spec)
        for side, (_, M, S) in SIDES.items()}
    assert specs["port"] == specs["jax"]
    out = MachineModel(TPU_SPECS["cpu"]).with_calibration(str(p)).spec
    if case == "partial":
        assert out.step_overhead == 7e-6
        assert out.mxu_efficiency == TPU_SPECS["cpu"].mxu_efficiency
        assert not hasattr(out, "unknown_key")
    else:
        assert out == TPU_SPECS["cpu"]


def test_with_store_composes_with_measured_constants(tmp_path):
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps({"step_overhead": 10e-6,
                                 "mxu_efficiency": 0.8}))
    specs = {}
    for side, (O, M, S) in SIDES.items():
        store = O.CalibrationStore(str(tmp_path / f"{side}.json"),
                                   O.StoreConfig(min_samples=1))
        led = O.CalibrationLedger()
        led.predict("p", step_overhead=1.0)
        led.measure("p", step_overhead=2.0)   # 2x slower than modeled
        led.commit(store)
        specs[side] = dataclasses.asdict(
            M(S["cpu"]).with_calibration(str(calib)).with_store(store).spec)
    assert specs["port"] == specs["jax"]
    assert specs["port"]["step_overhead"] == pytest.approx(20e-6)
    assert specs["port"]["mxu_efficiency"] == 0.8
    mm = MachineModel(TPU_SPECS["cpu"])
    assert mm.with_store(None).spec == TPU_SPECS["cpu"]
    empty = CalibrationStore(str(tmp_path / "none.json"))
    assert mm.with_store(empty).spec == TPU_SPECS["cpu"]


def test_with_store_rate_constants_divide():
    store = CalibrationStore("/dev/null/never", StoreConfig(min_samples=1))
    led = CalibrationLedger()
    led.predict("p", hbm_bandwidth=1.0)
    led.measure("p", hbm_bandwidth=2.0)   # times 2x longer: rate halves
    led.commit(store)
    mm = MachineModel(TPU_SPECS["cpu"]).with_store(store)
    assert mm.spec.hbm_bandwidth == pytest.approx(
        TPU_SPECS["cpu"].hbm_bandwidth / 2.0)


def test_for_mesh_maps_device_types():
    assert MachineModel.for_mesh(
        make_mesh({"tp": 2}, ["cpu", "cpu"])).spec.name == "cpu"
    # a mesh of CUDA devices, built without resolving them (no card here)
    cuda = Mesh({"tp": 1}, [torch.device("cuda", 0)])
    assert MachineModel.for_mesh(cuda).spec == TPU_SPECS["h100"]
    assert MachineModel.for_mesh(cuda, spec_name="cpu").spec.name == "cpu"
    with pytest.raises(ValueError, match="meta"):
        MachineModel.for_mesh(types.SimpleNamespace(
            devices=[torch.device("meta")]))


def test_h100_spec_has_no_tpu_measured_constant():
    """Every ``h100`` field has a stated source, the data sheet's numbers
    are the data sheet's, no constant is a TPU default, and the committed
    calibration artifact was written on the card and names it."""
    h100 = TPU_SPECS["h100"]
    fields = {f.name for f in dataclasses.fields(h100)} - {"name"}
    assert set(H100_SOURCES) == fields
    defaults = {f.name: f.default for f in dataclasses.fields(h100)}
    for name in TPU_MEASURED:
        assert getattr(h100, name) != defaults[name], name
        assert getattr(h100, name) != getattr(JAX_SPECS["v5e"], name), name
    assert (h100.peak_flops_bf16, h100.peak_flops_f32, h100.hbm_bandwidth,
            h100.hbm_capacity) == (989e12, 67e12, 3.35e12, 80e9)
    path = os.path.join(REPO, "artifacts", "h100_calib.json")
    doc = json.load(open(path))
    assert "H100" in doc["card"] and doc["card"].endswith(" W")
    assert doc["device"] == "h100"
    mm = MachineModel(h100).with_calibration(path)
    for name in ("mxu_efficiency", "step_overhead", "host_bandwidth",
                 "host_latency"):
        assert getattr(mm.spec, name) == doc[name] > 0
        assert H100_SOURCES[name].startswith("measured")
    assert 0 < mm.spec.mxu_efficiency <= 1


# ---------------------------------------------------------------------------
# the loop end to end
# ---------------------------------------------------------------------------
def scenario():
    """bench.calibration_scenario on both sides: the reference's graph
    and machines, and the port's model and machines of the same
    configuration."""
    from bench import calibration_scenario

    scen = calibration_scenario()
    model = PS.build_model(PS.ServeModelConfig(
        model_type="llama", vocab_size=128, hidden_size=64,
        intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256))
    PS.register_serve_capacities(model, max_requests=8, max_seq_len=256,
                                 max_tokens_per_batch=16)

    def port(mm):
        return MachineModel(TPU_SPECS["cpu"].__class__(
            **dataclasses.asdict(mm.spec)))

    return scen, model, port(scen["mm_true"]), port(scen["mm_skewed"])


def test_store_auto_apply_reduces_prediction_error(tmp_path):
    scen, model, true, skewed = scenario()
    devices, feats = ["cpu", "cpu"], scen["ref_feats"]

    def measure(plan):
        return price_plan(model, plan["tp"], plan["pp"], plan["n_micro"],
                          machine=true, devices=devices, workload=feats)

    store = CalibrationStore(str(tmp_path / "store.json"),
                             StoreConfig(min_samples=1))
    best1 = search_serve_plan(model, 2, machine=skewed, devices=devices,
                              workload=feats, calibration=store)
    assert best1.get("applied_scales", {}) == {}
    assert_close(jax_search_serve_plan(
        scen["ff"], 2, machine=scen["mm_skewed"], devices=scen["devices"],
        workload=feats, calibration=None), best1)
    meas = measure(best1)
    assert_close(jax_price_plan(
        scen["ff"], best1["tp"], best1["pp"], best1["n_micro"],
        machine=scen["mm_true"], devices=scen["devices"], workload=feats),
        meas)
    err_before = abs(meas["tpot_ms"] - best1["tpot_ms"]) / best1["tpot_ms"]
    led = CalibrationLedger()
    led.predict(best1["plan_key"], tpot_ms=best1["tpot_ms"],
                ttft_ms=best1["ttft_ms"])
    led.measure(best1["plan_key"], tpot_ms=meas["tpot_ms"],
                ttft_ms=meas["ttft_ms"])
    led.commit(store)
    store.save()
    best2 = search_serve_plan(model, 2, machine=skewed, devices=devices,
                              workload=feats, calibration=str(store.path))
    assert best2["applied_scales"]["tpot_ms"] > 1.2
    meas2 = measure(best2)
    err_after = abs(meas2["tpot_ms"] - best2["tpot_ms"]) / best2["tpot_ms"]
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_calibration_auto_consults_the_store_on_cuda_meshes_only(
        tmp_path, monkeypatch):
    """``"auto"`` reads the port's store for CUDA devices only (it holds
    H100 numbers), from the port's own variable (a path redirects, the
    empty string disables); the JAX package's variable never reaches
    it; CPU searches stay hermetic."""
    from flexflow_tpu_torch.obs.calibration import (
        DEFAULT_STORE_PATH,
        STORE_ENV,
        default_store_path,
    )

    _, model, true, _ = scenario()
    spath = str(tmp_path / "redirected.json")
    store = CalibrationStore(spath, StoreConfig(min_samples=1))
    store.update(_one_run_report(PO, 2.0, n=1))
    store.save()
    monkeypatch.setenv("FLEXFLOW_TPU_CALIBRATION_STORE", spath)
    monkeypatch.delenv(STORE_ENV, raising=False)
    assert default_store_path() == DEFAULT_STORE_PATH
    monkeypatch.setenv(STORE_ENV, spath)
    assert default_store_path() == spath
    a = search_serve_plan(model, 2, devices=["cpu", "cpu"],
                          calibration="auto")
    b = search_serve_plan(model, 2, devices=["cpu", "cpu"],
                          calibration=None)
    assert a == b and "applied_scales" not in a
    assert _resolve_store("auto", ["cpu"]) is None
    assert _resolve_store("auto", ["cuda:0"]).scales() == {"tpot_ms": 2.0}
    # an explicit store applies on any device
    c = search_serve_plan(model, 2, devices=["cpu", "cpu"],
                          calibration=spath)
    assert c["applied_scales"] == {"tpot_ms": 2.0}
    assert c["tpot_ms"] == pytest.approx(b["tpot_ms"] * 2.0, rel=1e-3)
    monkeypatch.setenv(STORE_ENV, "")
    assert _resolve_store("auto", ["cuda:0"]) is None
    with pytest.raises(RuntimeError, match="cuda"):   # None: the cards
        search_serve_plan(model, 2)


# ---------------------------------------------------------------------------
# the planner in the loop: plan health, migration, what-if
# ---------------------------------------------------------------------------
def test_plan_health_and_migration_act_on_the_searched_plan():
    """(a) ``test_plan_health.py:291-380``: a spec incumbent searched while
    acceptance was high; acceptance collapses below the break-even and
    the monitor's re-search (the port's ``search_serve_plan``)
    recommends the same shape with speculation off, as the reference's
    does.  (b) A breaching monitor whose ``search_fn`` searches a
    deployment's model over two CPU devices recommends ``tp1_pp2_m2``;
    the migration controller rebuilds through ``LLM.plan_builder`` and
    serves the streams of an unmigrated run."""
    scen, model, true, _ = scenario()
    keys = {}
    for side, (O, _, _) in SIDES.items():
        tel = O.Telemetry(clock=ManualClock(), workload_window=24)

        def search_fn(side=side, tel=tel):
            wl = dict(scen["ref_feats"], mean_spec_acceptance=tel.workload
                      .features()["mean_spec_acceptance"])
            if side == "jax":
                return jax_search_serve_plan(
                    scen["ff"], 2, machine=scen["mm_true"],
                    devices=scen["devices"], calibration=None, workload=wl,
                    spec="auto")
            return search_serve_plan(model, 2, machine=true,
                                     devices=["cpu", "cpu"],
                                     calibration=None, workload=wl,
                                     spec="auto")

        for _ in range(24):
            tel.spec_acceptance(5, 6)
        incumbent = search_fn()
        mon = O.PlanHealthMonitor(
            tel, incumbent, reference=tel.workload.snapshot(),
            config=O.PlanHealthConfig(drift_threshold=0.25,
                                      drift_min_samples=16,
                                      min_requests=1_000_000),
            search_fn=search_fn)
        assert mon.check()["healthy"]
        for _ in range(24):
            tel.spec_acceptance(1, 6)
        drifted = mon.check()
        assert drifted["replan_recommended"]
        keys[side] = (incumbent["plan_key"], drifted["candidate"])
    assert keys["port"] == keys["jax"]
    assert "_spec_" in keys["port"][0]
    assert "_spec_" not in keys["port"][1]["plan_key"]

    # (b) the searched plan drives a migration
    searched = PS.build_model(CFG)
    PS.register_serve_capacities(searched, 2, 128,
                                 max_tokens_per_batch=16)
    tel = PO.Telemetry()
    mon = PO.PlanHealthMonitor(
        tel, {"plan_key": "tp1_pp1_m1", "tpot_ms": 0.0001},
        reference=tel.workload.snapshot(),
        config=PO.PlanHealthConfig(min_requests=1, max_tpot_error_frac=0.01,
                                   drift_min_samples=1, drift_threshold=0.0),
        search_fn=lambda: search_serve_plan(
            searched, 2, devices=["cpu", "cpu"], calibration=None))
    llm = PS.LLM(CFG).compile(device="cpu", plan_health=mon, **caps())
    llm.rm.health_check_every = 1
    llm.rm.scan_chunk = 2
    ctrl = llm.attach_migration(
        llm.plan_builder(devices=["cpu", "cpu"], **caps()),
        config=PS.MigrationConfig(defer_ticks=0, drain_grace_ticks=1))
    assert llm.rm.generate(PROMPTS) == one()
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["candidate"] == "tp1_pp2_m2"
    assert plan_shape(rec["candidate"]) == {"tp": 1, "pp": 2, "m": 2}
    assert llm.im.plan_key == "tp1_pp2_m2" and llm.im.pp == 2


def _reference_replay_report():
    spec = importlib.util.spec_from_file_location(
        "jax_replay_report", os.path.join(REPO, "scripts",
                                          "replay_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replay_report_what_if_prices_as_the_reference(tmp_path, capsys):
    from flexflow_tpu_torch.obs.replay import TrafficTraceRecorder
    from flexflow_tpu_torch.obs.replay import VirtualClock
    from flexflow_tpu_torch.tools import replay_report

    path = str(tmp_path / "run.jsonl")
    rm = PS.LLM(CFG).compile(device="cpu", **caps()).rm
    rm.serve_with_arrivals([(0.0, PROMPTS[0], 6), (0.002, PROMPTS[1], 6),
                            (0.004, PROMPTS[2], 4)], clock=VirtualClock(),
                           record_trace=TrafficTraceRecorder(path=path))
    argv = [path, "--what-if", "tp1_pp2_m2", "--what-if", "tp2_pp1",
            "--fleet-size", "2"]
    docs = []
    for main in (_reference_replay_report().main, replay_report.main):
        rc = main(argv)
        docs.append((rc, json.loads(capsys.readouterr().out)))
    (jrc, want), (rc, got) = docs
    assert rc == jrc
    assert_close(want, got)
    assert [c["candidate"]["plan_key"] for c in got["what_if"]] == [
        "tp1_pp2_m2", "tp2_pp1_m1"]
    assert got["diffs"][0]["new_plan"] == "tp2_pp1_m1"


# ---------------------------------------------------------------------------
# F4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["contiguous", "paged", "int8", "spec"])
def test_capacity_bytes_equals_reference(kind):
    from flexflow_tpu_torch.serve import InjectedFault
    from flexflow_tpu_torch.serve.resilience import InjectedFault as direct

    assert InjectedFault is direct
    kw = {"contiguous": {}, "paged": dict(kv_page_size=64),
          "int8": dict(kv_dtype="int8"), "spec": dict(max_spec=7)}[kind]
    jim = make_im(cfg=TINY, max_seq=128, **kw)
    port_kw = dict(kw)
    if "max_spec" in port_kw:
        port_kw["max_spec_tokens"] = port_kw.pop("max_spec")
    im = PS.InferenceManager(
        PS.build_model(PS.ServeModelConfig(**dataclasses.asdict(TINY))),
        max_requests=jim.max_requests, max_tokens_per_batch=jim.max_tokens,
        max_seq_len=jim.max_seq_len, device="cpu", **port_kw)
    im.allocate_kv_cache()
    assert im.kv.capacity_bytes() == jim.kv.capacity_bytes()
    assert im.kv.snapshot()["capacity_bytes"] == im.kv.capacity_bytes()
