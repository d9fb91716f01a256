"""Structured run log: one JSONL record per training run.

A copy of ``flexflow_tpu/utils/runlog.py``: each ``FFModel.fit`` call
appends one JSON line to ``artifacts/run_log.jsonl`` (override with
``FLEXFLOW_TPU_RUN_LOG``; set it empty to disable), enough to
reconstruct what ran, under which strategy, and how it went.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

_ENV = "FLEXFLOW_TPU_RUN_LOG"
_DEFAULT = os.path.join("artifacts", "run_log.jsonl")


def log_run(kind: str, record: Dict[str, Any]) -> None:
    """Append a run record; never raises (logging must not break runs)."""
    path = os.environ.get(_ENV, _DEFAULT)
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {"kind": kind, "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
               **record}
        with open(path, "a") as f:
            f.write(json.dumps(doc) + "\n")
    except (OSError, TypeError, ValueError):
        pass
