"""Summarize (or validate) a serving-telemetry JSONL export of the port.

Usage::

    python -m flexflow_tpu_torch.tools.trace_report serve.jsonl
    python -m flexflow_tpu_torch.tools.trace_report --check serve.jsonl

The port's counterpart of the JAX package's ``scripts/trace_report.py``
(the same command line and output), over
:func:`flexflow_tpu_torch.obs.report.summarize_jsonl` and
``validate_jsonl``.  Default mode prints one JSON document: request
counts, p50/p95 TTFT / TPOT / queue wait from the request-lifecycle
events, the outcome mix and resilience counters, per-track span totals,
the calibration and memory ledgers, the workload-drift view, the
``time_budget`` section of a bound ``StepProfiler`` (per-phase host time:
``host_admit``, ``host_prepare``, ``dispatch``, ``readback``; the work
counters), and the ``slo`` section (brownout transitions, lane sheds,
the exact SLO counters).  A trace whose ring dropped events is truncated:
a warning goes to stderr and ``telemetry_events_dropped`` counts it.
``--check`` validates the JSONL against ``telemetry.EVENT_SCHEMA`` and
exits nonzero on unknown or missing fields.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a flexflow_tpu_torch telemetry JSONL")
    ap.add_argument("jsonl", help="path to a Telemetry.export *.jsonl")
    ap.add_argument("--indent", type=int, default=None,
                    help="pretty-print with this JSON indent")
    ap.add_argument("--check", action="store_true",
                    help="validate the JSONL against the expected event "
                         "schema instead of summarizing; exit nonzero on "
                         "unknown/missing fields")
    args = ap.parse_args(argv)

    if args.check:
        from ..obs.report import validate_jsonl

        errors = validate_jsonl(args.jsonl)
        print(json.dumps({"ok": not errors, "path": args.jsonl,
                          "errors": errors}, indent=args.indent))
        return 1 if errors else 0

    from ..obs.report import summarize_jsonl

    summary = summarize_jsonl(args.jsonl)
    if summary.get("dropped"):
        print(f"WARNING: trace ring dropped {summary['dropped']} of "
              f"{summary['events']} events — this summary is computed "
              "from a TRUNCATED trace (raise Telemetry(capacity=...) to "
              "keep the full run)", file=sys.stderr)
    print(json.dumps(summary, indent=args.indent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
