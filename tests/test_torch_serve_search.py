"""The port's serve planner vs the JAX package's, on the CPU.

``flexflow_tpu_torch.search.serve_search`` (``search_serve_plan``,
``price_plan``, ``pp_serve_cost``) prices the port's stage records
(``serve/pp.py:build_stage_plans``: a stage's shard-0 model priced by
``serve/cost.py``, its collectives by ``parallel/tp.py:tp_collectives``)
where the reference prices its per-stage PCG plans.  Both sides build the
same configuration (the reference's graph through ``FFModel``, the port's
model on ``meta``) with the same capacities, and price it under the same
``cpu`` machine spec, on ``jax.devices()[:n]`` and ``["cpu"] * n``.
Held at ``rel=1e-9`` (every other value equal), over the whole returned
plan: the winner and its ``plan_key``, and every candidate's ``fits``,
``per_stage_gb``, ``memory_parts_gb``, ``tpot_ms``, ``bubble_frac``,
``transfer_ms``, ``components`` and ``components_raw``:

* the candidate tables of Llama, OPT, Falcon-7B (multi-query), MPT and
  StarCoder at every ``tp x pp`` factorization of 2 and 4 devices, under
  a per-chip cap that one chip of each table does not meet;
* with a workload (decode-heavy and prompt-heavy: the winner flips),
  with ``kv_page_size`` and the host-tier swap price, with ``spec``
  (``"auto"`` and explicit shapes, flipping at the break-even), with
  ``annotate_int8`` and an int8 KV cache, and with a calibration store;
* ``price_plan`` at every shape (multi-query models at ``tp > 1`` too,
  where Falcon's MLP gathers twice), and equal to the search's own
  pricing of its winner; each stage's collectives equal the reference
  plan's parallel steps, kind and bytes;
* ``pp_serve_cost``'s bubble and hop, and "nothing fits".
"""

import dataclasses
import math

import jax
import pytest

from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.obs import CalibrationLedger as JaxLedger
from flexflow_tpu.obs import CalibrationStore as JaxStore
from flexflow_tpu.obs import StoreConfig as JaxStoreConfig
from flexflow_tpu.parallel.mesh import make_mesh as jax_mesh
from flexflow_tpu.search import serve_search as JSS
from flexflow_tpu.search.machine_model import TPU_SPECS as JAX_SPECS
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu.serve import ServeModelConfig as JaxConfig
from flexflow_tpu.serve import build_model as jax_build_model
from flexflow_tpu.serve.inference_manager import (
    mark_gated_lm_head as jax_mark,
    register_serve_capacities as jax_register,
    tensor_parallel_strategy as jax_strategy,
)
from flexflow_tpu.serve.pp import build_stage_plans as jax_stage_plans
from flexflow_tpu.serve.pp import serve_stage_split as jax_split
from flexflow_tpu.serve.quant import annotate_int8 as jax_annotate_int8
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.obs import CalibrationLedger, CalibrationStore
from flexflow_tpu_torch.obs import StoreConfig
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.search import TPU_SPECS, MachineModel
from flexflow_tpu_torch.search import serve_search as PSS
from flexflow_tpu_torch.serve.migration import plan_shape

# TINY's widths (tests/test_serve.py) at 4 layers, so that every pp of 4
# devices splits, with a vocabulary the TP degrees divide
BASE = dict(vocab_size=68, hidden_size=32, intermediate_size=48,
            num_hidden_layers=4, num_attention_heads=4,
            max_position_embeddings=64)
FAMILIES = {
    "llama": dict(model_type="llama", num_key_value_heads=4),
    "opt": dict(model_type="opt"),
    "falcon_7b": dict(model_type="falcon", parallel_attn=True,
                      num_key_value_heads=1),
    "mpt": dict(model_type="mpt"),
    "starcoder": dict(model_type="gpt_bigcode", num_key_value_heads=1),
}
CAPS = dict(max_requests=8, max_seq_len=64)
ROWS = 16
WORKLOAD = {"mean_prompt_len": 24.0, "mean_output_len": 96.0,
            "arrival_rate_per_s": 10.0, "mean_occupancy": 0.5,
            "shared_prefix_frac": 0.5, "mean_spec_acceptance": 0.7}


def both(fields, max_requests=8, max_seq_len=64, max_spec=0, kv_dtype=None,
         rows=ROWS, mark=False):
    """The reference's serve graph (an ``FFModel``) and the port's model
    on ``meta``, of one configuration, with the same capacities."""
    ff = FFModel(FFConfig(), mesh=jax_mesh({"tp": 1}, jax.devices()[:1]))
    jax_build_model(ff, JaxConfig(**fields), max_tokens=rows)
    jax_register(ff.graph, max_requests, max_seq_len, max_spec, kv_dtype)
    model = PS.build_model(PS.ServeModelConfig(**fields))
    PS.register_serve_capacities(model, max_requests, max_seq_len, max_spec,
                                 kv_dtype, rows)
    if mark:
        jax_mark(ff.graph, [ff.graph.nodes[-1].outputs[-1]], max_requests)
        assert PS.mark_gated_lm_head(model, max_requests)
    return ff, model


def machines(spec="cpu", **changes):
    return (JaxMachine(dataclasses.replace(JAX_SPECS[spec], **changes)),
            MachineModel(dataclasses.replace(TPU_SPECS[spec], **changes)))


def assert_close(want, got, path="plan"):
    """``got`` equals ``want``: floats at ``rel=1e-9``, all else exactly,
    through dicts and lists."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-12), \
            (path, want, got)
    else:
        assert got == want, (path, want, got)


def search_both(ff, model, n, jm=None, pm=None, jax_calibration=None,
                calibration=None, **kw):
    """Both searches on the same inputs: the port's plan, held equal to
    the reference's (its winner's key a migration takes)."""
    jm, pm = (jm, pm) if jm is not None else machines()
    want = JSS.search_serve_plan(ff, n, machine=jm,
                                 devices=jax.devices()[:n],
                                 calibration=jax_calibration, **kw)
    got = PSS.search_serve_plan(model, n, machine=pm, devices=["cpu"] * n,
                                calibration=calibration, **kw)
    assert_close(want, got)
    plan_shape(got["plan_key"])
    return got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_candidate_table_equals_reference(family, n):
    fields = {**BASE, **FAMILIES[family]}
    if family == "llama":
        fields["dtype"] = "bfloat16"
    ff, model = both(fields, mark=family in ("llama", "mpt"))
    kv_heads = fields.get("num_key_value_heads", 4)
    shapes = [(t, n // t) for t in (1, 2, 4)
              if n % t == 0 and kv_heads % t == 0]
    # a per-chip cap between the candidates' largest and smallest stage:
    # one candidate of the table does not fit
    peaks = [max(st.memory["total"] for st in PS.build_stage_plans(
        model, PS.serve_stage_split(model.graph, pp),
        [make_mesh({"tp": tp}, ["cpu"] * tp)] * pp)) for tp, pp in shapes]
    cap = (max(peaks) + min(peaks)) / 2 if len(peaks) > 1 else None
    got = search_both(ff, model, n, hbm_cap=cap)
    assert set(got["candidates"]) == {f"tp{t}_pp{p}" for t, p in shapes}
    if cap is not None:
        assert not all(c["fits"] for c in got["candidates"].values())


@pytest.mark.parametrize("mix", ["decode_heavy", "prompt_heavy"])
def test_workload_flips_the_winner_as_the_reference(mix):
    """bench.calibration_scenario's graph and machine (expensive
    collectives): a decode-heavy mix keeps the pp plan, a prompt-heavy
    one flips to tp (it parallelizes one prefill)."""
    from bench import calibration_scenario

    scen = calibration_scenario()
    fields = dict(model_type="llama", vocab_size=128, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=256)
    ff, model = both(fields, max_seq_len=256)
    pm = MachineModel(dataclasses.replace(TPU_SPECS["cpu"],
                                          ici_bandwidth=0.5e9,
                                          ici_latency=2e-5))
    assert (dataclasses.asdict(pm.spec)
            == dataclasses.asdict(scen["mm_true"].spec))
    wl = scen["ref_feats"] if mix == "decode_heavy" else {
        "mean_prompt_len": 512.0, "mean_output_len": 8.0,
        "arrival_rate_per_s": 40.0, "mean_occupancy": 0.9}
    got = search_both(ff, model, 2, scen["mm_true"], pm, workload=wl)
    assert got["plan_key"] == ("tp1_pp2_m2" if mix == "decode_heavy"
                               else "tp2_pp1_m1")
    if mix == "prompt_heavy":
        # the asymmetry is TTFT: the tp winner's first token beats the
        # pp runner-up's, and the prompts' prefill interference is priced
        assert got["ttft_ms"] < got["candidates"]["tp1_pp2"]["by_micro"][
            "2"]["ttft_ms"]
        assert got["prefill_util"] > PSS.search_serve_plan(
            model, 2, machine=pm, devices=["cpu"] * 2, calibration=None,
            workload=scen["ref_feats"])["prefill_util"]


@pytest.mark.parametrize("family", ["llama", "starcoder"])
def test_paged_kv_and_swap_price_equal_reference(family):
    """``kv_page_size``: the page-rounded KV stream, the shared-prefix
    discount and the host-tier swap price (``test_kv_paged.py:525``)."""
    fields = {**BASE, **FAMILIES[family]}
    ff, model = both(fields, max_requests=2, max_seq_len=2048)
    wl = {"mean_prompt_len": 1500.0, "mean_output_len": 20.0,
          "arrival_rate_per_s": 4.0, "mean_occupancy": 1.0,
          "shared_prefix_frac": 0.9}
    base = search_both(ff, model, 4, workload=wl)
    paged = search_both(ff, model, 4, workload=wl, kv_page_size=512)
    assert paged["kv_page_size"] == 512 and paged["kv_swap"]["tokens"]
    assert paged["objective_ms"] < base["objective_ms"]


@pytest.mark.parametrize("shapes", ["auto", "explicit"])
def test_spec_pricing_flips_at_break_even_as_reference(shapes):
    """Acceptance-aware speculation (``test_serve_search.py:246-330``):
    strictly above the break-even the spec plan wins, at it the
    incremental plan; explicit shapes price each (one with its own
    acceptance)."""
    ff, model = both({**BASE, **FAMILIES["llama"]}, max_seq_len=48)
    jm, pm = machines(spec_break_even_acceptance=0.439)
    spec = "auto" if shapes == "auto" else [
        {"width": 2, "depth": 3}, {"width": 1, "depth": 5,
                                   "acceptance": 0.3}]
    keys = []
    for acc in (0.449, 0.439, 0.429):
        wl = dict(WORKLOAD, mean_spec_acceptance=acc)
        got = search_both(ff, model, 2, jm, pm, workload=wl, spec=spec)
        keys.append(got["plan_key"])
        assert got["spec_break_even"] == 0.439
    assert keys[0].endswith("_spec_w2d3")
    assert "_spec_" not in keys[1] and "_spec_" not in keys[2]


@pytest.mark.parametrize("family", ["llama", "falcon_7b"])
def test_int8_annotations_and_kv_equal_reference(family):
    """``annotate_int8`` on a ``meta`` model and an int8 KV cache with
    spec buffers: int8 weights at one byte plus their scales."""
    fields = {**BASE, **FAMILIES[family]}
    ff, model = both(fields, max_spec=4, kv_dtype="int8")

    def weights():
        split = PS.serve_stage_split(model.graph, 1)
        return PS.build_stage_plans(model, split, [make_mesh(
            {"tp": 1}, ["cpu"])])[0].memory["weights"]

    fp = weights()
    assert jax_annotate_int8(ff.graph) == PS.annotate_int8(model)
    assert weights() < fp / 2
    search_both(ff, model, 4, workload=WORKLOAD, kv_page_size=16)


def test_calibration_store_scales_equal_reference(tmp_path):
    """A store's component scales (attention, hop), constant scales
    (``step_overhead``) and field scales (TTFT, memory) apply as the
    reference applies them; ``telemetry=`` records the winner's raw
    predictions and memory parts."""
    from flexflow_tpu.obs import Telemetry as JaxTelemetry
    from flexflow_tpu_torch.obs import Telemetry

    stores = []
    for led, store in ((JaxLedger(), JaxStore(str(tmp_path / "j.json"),
                                              JaxStoreConfig(min_samples=1))),
                       (CalibrationLedger(), CalibrationStore(
                           str(tmp_path / "p.json"),
                           StoreConfig(min_samples=1)))):
        led.predict("a", tpot_ms=1.0, attention_ms=1.0, hop_ms=2.0,
                    step_overhead=1.0, ttft_ms=1.0, memory_gb=1.0)
        led.measure("a", tpot_ms=1.5, attention_ms=1.3, hop_ms=2.5,
                    step_overhead=3.0, ttft_ms=2.0, memory_gb=1.2)
        led.commit(store)
        stores.append(store)
    ff, model = both({**BASE, **FAMILIES["mpt"]})
    jtel, ptel = JaxTelemetry(), Telemetry()
    got = search_both(ff, model, 4, workload=WORKLOAD,
                      jax_calibration=stores[0], calibration=stores[1],
                      telemetry=None)
    assert got["applied_scales"]["attention_ms"] == 1.3
    JSS.search_serve_plan(ff, 4, machine=machines()[0],
                          devices=jax.devices()[:4], workload=WORKLOAD,
                          calibration=stores[0], telemetry=jtel)
    PSS.search_serve_plan(model, 4, machine=machines()[1],
                          devices=["cpu"] * 4, workload=WORKLOAD,
                          calibration=stores[1], telemetry=ptel)
    assert_close(jtel.calibration.report(), ptel.calibration.report())
    assert_close(jtel.memory.report(), ptel.memory.report())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_price_plan_every_shape_equals_reference(family):
    """``price_plan`` at every ``tp x pp x m`` of 4 devices, with a
    workload, pages and a spec shape, multi-query models at ``tp > 1``
    included (replicated attention; Falcon's MLP gathers twice), and
    each stage's collectives equal the reference plan's parallel steps;
    the search's winner prices as ``price_plan`` prices it."""
    fields = {**BASE, **FAMILIES[family]}
    ff, model = both(fields, mark=True)
    jm, pm = machines()
    for tp, pp in ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (1, 4)):
        jmesh = jax_mesh({"tp": tp}, jax.devices()[:tp])
        split = jax_split(ff.graph, pp)
        strategy = jax_strategy(ff.graph, ("tp",), jmesh) if tp > 1 else {}
        want = [[(s.node.op.type_name,
                  s.node.op.comm_bytes(s.in_specs[0], s.in_shardings[0],
                                       jmesh))
                 for s in plan.steps if s.is_parallel]
                for plan in jax_stage_plans(ff.graph, split, strategy,
                                            [jmesh] * pp)]
        got = [[(c.kind, c.nbytes) for c in st.collectives]
               for st in PS.build_stage_plans(
                   model, PS.serve_stage_split(model.graph, pp),
                   [make_mesh({"tp": tp}, ["cpu"] * tp)] * pp)]
        assert got == want, (tp, pp)
        for m in (1, 2, 4):
            kw = dict(workload=WORKLOAD, kv_page_size=16,
                      spec={"width": 2, "depth": 3})
            assert_close(
                JSS.price_plan(ff, tp, pp, m, machine=jm,
                               devices=jax.devices()[:4], **kw),
                PSS.price_plan(model, tp, pp, m, machine=pm,
                               devices=["cpu"] * 4, **kw))
    best = PSS.search_serve_plan(model, 4, machine=pm, devices=["cpu"] * 4,
                                 calibration=None, workload=WORKLOAD)
    again = PSS.price_plan(model, best["tp"], best["pp"], best["n_micro"],
                           machine=pm, devices=["cpu"] * 4,
                           workload=WORKLOAD)
    assert again["plan_key"] == best["plan_key"]
    assert again["tpot_ms"] == best["tpot_ms"]
    assert again["ttft_ms"] == best["ttft_ms"]
    assert again["components"] == best["components_ms"]


def test_pp_serve_cost_bubble_hop_and_nothing_fits():
    """``test_serve_search.py:140-212``: the hop and the bubble are
    priced, interleaving fills the pipeline, the hop is priced per
    micro-batch; equal to the reference's; a cap nothing meets raises."""
    ff, model = both({**BASE, **FAMILIES["llama"]}, max_seq_len=256)
    jm, pm = machines()
    jmesh = jax_mesh({"tp": 1}, jax.devices()[:1])
    jsplit = jax_split(ff.graph, 2)
    jplans = jax_stage_plans(ff.graph, jsplit, {}, [jmesh] * 2)
    split = PS.serve_stage_split(model.graph, 2)
    plans = PS.build_stage_plans(model, split,
                                 [make_mesh({"tp": 1}, ["cpu"])] * 2)
    b = PSS._boundary_bytes(model.graph, split, ROWS)
    assert b == JSS._boundary_bytes(ff.graph, jsplit) > 0
    costs = []
    for m in (1, 2):
        want = JSS.pp_serve_cost(jplans, jm, n_micro=m, boundary_bytes=b)
        got = PSS.pp_serve_cost(plans, pm, n_micro=m, boundary_bytes=b)
        assert_close(want, got)
        costs.append(got)
    c1, c2 = costs
    assert c1["transfer_s"] > 0 and c2["transfer_s"] > 0
    assert c1["bubble_frac"] == 0.5 and c2["bubble_frac"] == 0.0
    assert c2["tpot_s"] < c1["tpot_s"]
    assert c2["transfer_s"] <= c1["transfer_s"]
    with pytest.raises(ValueError, match="fits"):
        PSS.search_serve_plan(model, 2, machine=pm, devices=["cpu"] * 2,
                              hbm_cap=1024.0, calibration=None)
    with pytest.raises(ValueError, match="fits"):
        JSS.search_serve_plan(ff, 2, machine=jm, devices=jax.devices()[:2],
                              hbm_cap=1024.0, calibration=None)
    bare = PS.build_model(PS.ServeModelConfig(**{**BASE, "model_type":
                                                 "llama"}))
    with pytest.raises(ValueError, match="register_serve_capacities"):
        PSS.search_serve_plan(bare, 2, machine=pm, devices=["cpu"] * 2)
