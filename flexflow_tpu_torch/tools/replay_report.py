"""Validate, summarize or what-if a traffic-trace artifact of the port.

Usage::

    python -m flexflow_tpu_torch.tools.replay_report --check trace.jsonl
    python -m flexflow_tpu_torch.tools.replay_report trace.jsonl
    python -m flexflow_tpu_torch.tools.replay_report trace.jsonl \
        --what-if tp1_pp2_m2 --what-if tp2_pp1 --fleet-size 2

The port's counterpart of the JAX package's ``scripts/replay_report.py``
over one versioned trace artifact (:mod:`flexflow_tpu_torch.obs.replay`,
recorded through ``serve_with_arrivals(..., record_trace=
TrafficTraceRecorder(path))``):

* ``--check`` — integrity: declared arrival and outcome counts, prompt and
  token hashes, seed provenance (``TrafficTrace.validate``).  Exits
  nonzero on any violation.
* default — ``under_load_summary`` of the RECORDED outcomes, the
  reduction a live ``serve_with_arrivals`` run gets: goodput, per-class
  TTFT and TPOT p50/p95, the outcome mix, the per-replica breakdown.
* ``--what-if KEY`` (repeatable) — price candidate plans against the
  recorded stream: each ``tp{T}_pp{P}[_m{M}]`` key is priced by the
  planner's cost model (``search.serve_search.price_plan``) on the
  reference's synthetic scenario, a tiny Llama-shaped model on two CPU
  devices under the ``cpu`` machine spec (relative deltas are what the
  report prices; nothing runs on a device), then run through
  ``ReplayHarness.what_if``'s slot-level simulation.  The FIRST candidate
  is the baseline; every further one is diffed against it under
  ``tools/bench_compare.py``'s discipline (``ReplayHarness.diff``); the
  exit code is the LAST diff's (nonzero: the later candidate regresses).

Fidelity replay (re-driving a built deployment and holding it to the
recording) needs an engine, so it lives in the library
(``ReplayHarness.replay`` and ``verify``).
"""

import argparse
import json
import re
import sys

_PLAN_KEY_RE = re.compile(r"^tp(\d+)_pp(\d+)(?:_m(\d+))?$")


def what_if_model():
    """The synthetic pricing scenario (reference
    ``scripts/replay_report.py:120-150``): a tiny Llama-shaped serve model
    on ``meta`` with its capacities registered, and the two CPU devices
    it is priced over."""
    from ..serve import (
        ServeModelConfig,
        build_model,
        register_serve_capacities,
    )

    cfg = ServeModelConfig(
        model_type="llama", vocab_size=128, hidden_size=64,
        intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256)
    model = build_model(cfg)
    register_serve_capacities(model, max_requests=8, max_seq_len=256,
                              max_tokens_per_batch=16)
    return model, ["cpu", "cpu"]


def price_candidate(key: str, model, devices, machine=None):
    """Price one ``tp{T}_pp{P}[_m{M}]`` candidate with the planner's cost
    model (pure pricing, no device work)."""
    m = _PLAN_KEY_RE.match(key)
    if not m:
        raise SystemExit(
            f"--what-if {key!r}: expected tp{{T}}_pp{{P}}[_m{{M}}]")
    tp, pp, micro = int(m.group(1)), int(m.group(2)), int(m.group(3) or 1)
    from ..search.serve_search import price_plan

    return price_plan(model, tp, pp, micro, machine=machine, devices=devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate, summarize or what-if a traffic trace")
    ap.add_argument("trace", help="path to a TrafficTraceRecorder *.jsonl")
    ap.add_argument("--check", action="store_true",
                    help="validate the artifact's integrity instead of "
                         "summarizing; exit nonzero on violations")
    ap.add_argument("--what-if", action="append", default=[],
                    metavar="PLAN_KEY",
                    help="price a tp{T}_pp{P}[_m{M}] candidate against "
                         "the recorded stream (repeatable; first = "
                         "baseline, later candidates diffed against it)")
    ap.add_argument("--fleet-size", type=int, default=1,
                    help="replicate the what-if candidate N times "
                         "(default 1)")
    ap.add_argument("--default-threshold", type=float, default=0.10,
                    help="relative threshold for measured fields in the "
                         "what-if diff (default 0.10)")
    ap.add_argument("--indent", type=int, default=None)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report document to PATH")
    args = ap.parse_args(argv)

    from ..obs.replay import ReplayHarness, TrafficTrace

    trace = TrafficTrace.load(args.trace)
    if args.check:
        errors = trace.validate()
        doc = {"ok": not errors, "path": args.trace, "errors": errors,
               "arrivals": len(trace.arrivals),
               "requests": len(trace.outcomes),
               "driver": trace.meta.get("driver")}
        rc = 1 if errors else 0
    else:
        harness = ReplayHarness(trace)
        doc = {
            "path": args.trace,
            "driver": trace.meta.get("driver"),
            "plan": trace.meta.get("plan"),
            "fault": trace.meta.get("fault"),
            "fleet": {k: v for k, v in (trace.meta.get("fleet") or {}).items()
                      if k != "plans"} or None,
            "arrivals": len(trace.arrivals),
            "recorded": harness.recorded_summary(),
        }
        rc = 0
        if args.what_if:
            model, devices = what_if_model()
            candidates = []
            for key in args.what_if:
                price = price_candidate(key, model, devices)
                result = harness.what_if(price, fleet_size=args.fleet_size)
                result.pop("records", None)  # per-request detail: off
                candidates.append(result)
            doc["what_if"] = candidates
            diffs = []
            base = candidates[0]
            for cand in candidates[1:]:
                diff = harness.diff(base["summary"], cand["summary"],
                                    default_threshold=args.default_threshold)
                diff["old_plan"] = base["candidate"]["plan_key"]
                diff["new_plan"] = cand["candidate"]["plan_key"]
                diffs.append(diff)
                rc = 0 if diff["ok"] else 1
            doc["diffs"] = diffs
    print(json.dumps(doc, indent=args.indent))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
