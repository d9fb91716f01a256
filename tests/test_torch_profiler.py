"""The port's step profiler and cost arithmetic vs the JAX package, on the
CPU.

* ``PlanCostCard`` and the predicted memory parts
  (``flexflow_tpu_torch.serve.cost``) equal the reference's
  (``obs/profiler.py:plan_cost_card``, ``search/simulator.py:
  plan_memory_parts``) field by field, exactly, for the five families,
  bf16, int8 weights, an int8 KV cache, the spec buffers of a draft, and
  paged caches; so does the memory ledger ``publish_memory`` fills
  (predicted and allocated bytes).  The per-tick and per-request work
  counters are held equal in ``test_torch_obs.py`` (the ``step_profile``
  instants and ``per_request``).
* ``recompiles_total`` reads 0 (eager PyTorch has no jit cache);
  ``dispatches`` counts every ``step``, ``decode_scan_async``,
  ``join_slot`` and ``prefill_scan`` call and ``host_syncs`` every
  read-back (``RequestManager.readbacks``): one a chained stretch.
* No hook reads a device value: the device-to-host copies of a run are
  the same with every hook on and off.
* ``python -m flexflow_tpu_torch.tools.bench_compare`` passes two
  repeated runs' counters and fails a changed or missing one.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import flexflow_tpu.obs as JO
import flexflow_tpu.serve as JS
from flexflow_tpu.obs.profiler import plan_cost_card as jax_card
from flexflow_tpu.search.simulator import plan_memory_parts as jax_parts
from flexflow_tpu.serve.quant import quantize_int8 as jax_quantize_int8
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.obs.profiler import WORK_COUNTERS, plan_cost_card
from flexflow_tpu_torch.serve.cost import plan_memory_parts

from test_serve import TINY, make_im
from test_serving_under_load import poisson_arrivals
from test_torch_obs import PROMPTS, LoopClock, deployment
from test_torch_zoo import configs, params_np
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import _one_thread  # noqa: F401

CAPS = dict(max_tokens=8, max_requests=2, max_seq=64)
CASES = {
    "llama": (None, {}),
    "llama_bf16": ("bf16", dict(seed=3)),
    # a draft's deployment: spec buffers and top-k, on an int8 KV cache
    "llama_draft_int8kv": (None, dict(max_tokens=16, kv_dtype="int8",
                                      max_spec=7, topk=2, seed=11)),
    # int8 weights (a seed no other test builds: quantizing marks the
    # cached JAX graph's ops)
    "llama_int8w": (None, dict(seed=41, quantize=True)),
    "llama_paged": (None, dict(max_tokens=16, max_seq=128,
                               kv_page_size=64, seed=12)),
    "opt_post_ln": ("opt_post_ln", {}),
    "falcon_7b": ("falcon_7b", {}),
    "falcon_rw": ("falcon_rw", {}),
    "mpt": ("mpt", {}),
    "starcoder": ("starcoder", dict(max_spec=7, topk=2, max_tokens=16)),
}


def both(case):
    family, kw = CASES[case]
    kw = {**CAPS, **kw}
    quantize = kw.pop("quantize", False)
    if family in (None, "bf16"):
        jcfg = TINY if family is None else dataclasses.replace(
            TINY, dtype="bfloat16")
        cfg = PS.ServeModelConfig(**dataclasses.asdict(jcfg))
    else:
        jcfg, cfg = configs(family)
        kw["use_pallas"] = True
    jim = make_im(cfg=jcfg, **kw)
    if quantize:
        jax_quantize_int8(jim)
    im = PS.InferenceManager(
        PS.build_model(cfg), max_requests=jim.max_requests,
        max_tokens_per_batch=jim.max_tokens, max_seq_len=jim.max_seq_len,
        device="cpu", kv_dtype=kw.get("kv_dtype"),
        kv_page_size=kw.get("kv_page_size"),
        max_spec_tokens=jim.max_spec_tokens, topk=jim.topk)
    im.init_operators_inference(PS.params_from_jax(params_np(jim), cfg,
                                                   "cpu"))
    return jim, im


@pytest.mark.parametrize("case", list(CASES))
def test_cost_card_and_memory_match_reference(case):
    """The card, the predicted memory parts and the ledger's predicted
    and allocated records equal the reference's (exact)."""
    jim, im = both(case)
    assert dataclasses.asdict(plan_cost_card(im)) == \
        dataclasses.asdict(jax_card(jim))
    assert plan_memory_parts(im) == jax_parts(jim.plan, training=False)
    jtel, tel = JO.Telemetry(), PO.Telemetry()
    JS.RequestManager(jim, telemetry=jtel)
    PS.RequestManager(im, telemetry=tel)
    assert tel.memory.report() == jtel.memory.report()
    plan = tel.memory.report()["plans"]["tp1_pp1_m1"]
    assert plan["weights_gb"]["measured"] and plan["kv_gb"]["predicted"]


def counted(rm):
    """Count the port's dispatch calls."""
    calls = {"dispatch": 0}
    im = rm.im
    for name in ("step", "decode_scan_async", "join_slot", "prefill_scan"):
        inner = getattr(im, name)

        def wrapped(*a, _inner=inner, **k):
            calls["dispatch"] += 1
            return _inner(*a, **k)

        setattr(im, name, wrapped)
    return calls


def serve_joins(hooks=True):
    """Arrivals joining chained stretches (``test_torch_obs``'s mix)."""
    prof = PO.StepProfiler() if hooks else None
    tel = PO.Telemetry() if hooks else None
    rm = PS.RequestManager(deployment("port"),
                           PS.GenerationConfig(max_new_tokens=8),
                           telemetry=tel, profiler=prof)
    calls = counted(rm)
    arrivals = [(0.0, [3, 5, 7], 12), (0.075, PROMPTS[1], 8)] + [
        (t + 0.3, p, n) for t, p, n in poisson_arrivals(
            np.random.RandomState(5), 5, rate_per_s=30.0,
            vocab=TINY.vocab_size, max_new=8)]
    recs = rm.serve_with_arrivals(arrivals, clock=LoopClock())
    return rm, prof, calls, recs


def test_dispatches_host_syncs_and_recompiles():
    """``dispatches`` is every dispatch call, ``host_syncs`` equals
    ``readbacks``, and ``recompiles_total`` is 0 (exact)."""
    rm, prof, calls, _ = serve_joins()
    work = prof.report()["work"]
    assert rm.telemetry.metrics.counter("stretch_joins").value > 0
    assert work["dispatches"] == calls["dispatch"] > 0
    assert work["host_syncs"] == rm.readbacks > 0
    assert work["recompiles_total"] == 0 and prof.recompiles() == 0
    assert set(work) == set(WORK_COUNTERS)


def test_a_chained_stretch_is_one_host_sync():
    """A chained decode stretch of several segments reads back once: one
    host sync, one read-back, a dispatch a segment (exact)."""
    prof = PO.StepProfiler()
    rm = PS.RequestManager(deployment("port"),
                           PS.GenerationConfig(max_new_tokens=16),
                           profiler=prof)
    rid = rm.register_new_request([3, 5, 7])
    rm._serve_tick()                       # the prefill stretch
    assert rm.requests[rid].generated
    n = rm._scan_steps_possible()
    w0, r0 = dict(prof.work), rm.readbacks
    rm._decode_stretch(n)
    assert rm.last_stretch["segments"] >= 2
    assert prof.work["host_syncs"] - w0["host_syncs"] == 1
    assert rm.readbacks - r0 == 1
    assert (prof.work["dispatches"] - w0["dispatches"]
            == rm.last_stretch["segments"])


def test_no_hook_copies_a_device_value(monkeypatch):
    """The device-to-host copies of a run are the same with every hook on
    and off (the CPU's proxy for the card's sync-debug test)."""
    copies = {"n": 0}
    inner = torch.Tensor.cpu

    def cpu(self, *a, **k):
        copies["n"] += 1
        return inner(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    counts = []
    for hooks in (True, False):
        copies["n"] = 0
        _, _, _, recs = serve_joins(hooks)
        counts.append(copies["n"])
    assert counts[0] == counts[1] > 0


def test_bench_compare_on_repeated_runs(tmp_path):
    """Two runs of one workload give equal counters: ``bench_compare``
    exits 0; a grown counter or a missing one exits 1."""
    from flexflow_tpu_torch.tools import bench_compare

    docs = []
    for _ in range(2):
        rm, prof, _, recs = serve_joins()
        docs.append({"work": prof.report()["work"],
                     "requests": {str(r): rec["work"]
                                  for r, rec in recs.items()}})
    assert docs[0] == docs[1]
    paths = []
    for i, doc in enumerate(docs + [
            {**docs[1], "work": {**docs[1]["work"],
                                 "flops": docs[1]["work"]["flops"] + 1}},
            {**docs[1], "work": {k: v for k, v in docs[1]["work"].items()
                                 if k != "host_syncs"}}]):
        paths.append(str(tmp_path / f"run{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(doc, f)
    assert bench_compare.main([paths[0], paths[1]]) == 0
    assert bench_compare.main([paths[0], paths[2]]) == 1
    assert bench_compare.main([paths[0], paths[3]]) == 1
    result = bench_compare.compare(docs[0], docs[1])
    assert result["ok"] and result["compared"] >= len(WORK_COUNTERS)
