"""Validate or summarize a traffic-trace artifact of the port.

Usage::

    python -m flexflow_tpu_torch.tools.replay_report --check trace.jsonl
    python -m flexflow_tpu_torch.tools.replay_report trace.jsonl

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
* ``--what-if PLAN_KEY`` prices candidate plans with the planner's cost
  model, which the port does not have yet (the planner slice): it exits
  with an error saying so rather than make a price up.

Fidelity replay (re-driving a built deployment and holding it to the
recording) needs an engine, so it lives in the library
(``ReplayHarness.replay`` and ``verify``).
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate or summarize a traffic trace")
    ap.add_argument("trace", help="path to a TrafficTraceRecorder *.jsonl")
    ap.add_argument("--check", action="store_true",
                    help="validate the artifact's integrity instead of "
                         "summarizing; exit nonzero on violations")
    ap.add_argument("--what-if", action="append", default=[],
                    metavar="PLAN_KEY",
                    help="price a candidate plan against the recorded "
                         "stream (needs the planner, not ported yet)")
    ap.add_argument("--indent", type=int, default=None)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report document to PATH")
    args = ap.parse_args(argv)

    if args.what_if:
        ap.error(f"--what-if {args.what_if[0]}: what-if pricing needs the "
                 "planner's cost model (price_plan), which the port has not "
                 "ported yet (slice 10 of the port); ReplayHarness.what_if "
                 "takes a price dict from the caller meanwhile")

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
        doc = {
            "path": args.trace,
            "driver": trace.meta.get("driver"),
            "plan": trace.meta.get("plan"),
            "fault": trace.meta.get("fault"),
            "fleet": {k: v for k, v in (trace.meta.get("fleet") or {}).items()
                      if k != "plans"} or None,
            "arrivals": len(trace.arrivals),
            "recorded": ReplayHarness(trace).recorded_summary(),
        }
        rc = 0
    print(json.dumps(doc, indent=args.indent))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
