"""Profiling hook: ``FFConfig.profiling`` -> a ``torch.profiler`` trace.

Port of ``flexflow_tpu/utils/profiling.py``: ``FFModel.fit`` wraps its
loop in :func:`maybe_profile`, which records the host's ops and, on a
CUDA device, the kernels, and writes a Chrome trace (``trace.json``,
viewable in Perfetto) into a fresh per-run directory under
``artifacts/profile`` (:func:`run_trace_dir`), so that repeated runs never
overwrite each other.
"""

from __future__ import annotations

import contextlib
import os
import time

TRACE_DIR = os.path.join("artifacts", "profile")


def run_trace_dir(base: str = None, stamp: str = None) -> str:
    """Create and return a fresh per-run trace dir:
    ``<base>/<YYYYmmdd-HHMMSS>-p<pid>[-<k>]``: the pid tells concurrent
    processes apart, the ``-<k>`` suffix same-second runs in one process.
    Never reuses an existing directory."""
    base = base or TRACE_DIR
    stamp = stamp or time.strftime("%Y%m%d-%H%M%S")
    root = os.path.join(base, f"{stamp}-p{os.getpid()}")
    cand, k = root, 0
    while os.path.exists(cand):
        k += 1
        cand = f"{root}-{k}"
    os.makedirs(cand)
    return cand


@contextlib.contextmanager
def maybe_profile(enabled: bool, trace_dir: str = None):
    """Trace the body with ``torch.profiler`` when ``enabled`` and write
    ``trace.json`` into ``trace_dir`` (default: a fresh
    :func:`run_trace_dir`).  Yields the directory (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch

    trace_dir = trace_dir or run_trace_dir()
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield trace_dir
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
