"""The serve planner's machine constants, measured on the CUDA card.

Port of ``flexflow_tpu/search/measure.py:calibrate_machine_constants``
(:242) for the constants the serve search reads, each timed with CUDA
events on the card (never on the CPU: every probe raises without CUDA):

* ``mxu_efficiency`` — the achieved share of the bf16 tensor-core peak
  of a large GEMM, ``[256, 4096] @ [4096, 4096]`` (the reference's probe
  shape), against the spec's ``peak_flops_bf16``;
* ``step_overhead`` — the floor of one trivial step: the time a launch
  of a trivial kernel costs when the host issues them back to back (the
  eager counterpart of the reference's trivial scan body);
* ``host_bandwidth`` and ``host_latency`` — the rate of large pinned
  device-to-host copies and what a small one takes beyond its bytes at
  that rate (the link a KV page spill rides,
  ``serve/kv_paged.py:HostPageTier``).

Not measured here: ``spec_break_even_acceptance`` (it needs a draft
whose acceptance is known), ``overlap`` and the NVLink constants (two
cards), ``train_step_factor`` (the training port); the JSON says so and
the ``h100`` entry keeps its data sheet or placeholder values.

    python scripts/calibrate_h100.py [artifacts/h100_calib.json]
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch

GEMM_SHAPE = (256, 4096, 4096)          # rows, in, out (reference :282)
COPY_MIB = (1, 16, 64, 256)             # pinned D2H copy sizes


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the machine constants are measured on a CUDA "
                           "device; this machine has none")
    return dev


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device milliseconds of one ``fn()`` call: CUDA events around
    ``iters`` calls after ``warmup`` more."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_mxu_efficiency(device="cuda", peak: float = 989e12,
                         iters: int = 50, repeats: int = 3
                         ) -> Tuple[float, float]:
    """(achieved share of ``peak``, GEMM ms) of the bf16 probe GEMM: the
    fastest of ``repeats`` timings of ``iters`` back-to-back calls."""
    dev = _card(device)
    m, k, n = GEMM_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, dtype=torch.bfloat16, generator=g)
    w = torch.randn(k, n, device=dev, dtype=torch.bfloat16, generator=g)
    out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
    ms = min(event_ms(lambda: torch.matmul(a, w, out=out), iters)
             for _ in range(repeats))
    return min(1.0, 2 * m * k * n / (ms / 1e3) / peak), ms


def probe_step_overhead(device="cuda", iters: int = 2000,
                        repeats: int = 3) -> float:
    """Seconds a trivial step costs at least: back-to-back launches of one
    in-place scale of a ``[8, 128]`` float32 tensor, host-issued (the
    fastest of ``repeats`` timings: the host's issue rate varies)."""
    dev = _card(device)
    x = torch.ones(8, 128, device=dev)
    return min(event_ms(lambda: x.mul_(1.0000001), iters, warmup=50)
               for _ in range(repeats)) / 1e3


def probe_host_link(device="cuda", sizes_mib: Sequence[int] = COPY_MIB,
                    iters: int = 4, repeats: int = 5
                    ) -> Tuple[float, float, List[Dict]]:
    """(bytes/s, seconds, points) of pinned device-to-host copies: each
    size's copy time is the fastest of ``repeats`` timings of ``iters``
    back-to-back copies; the rate is the slope between the two largest
    sizes, the latency what the smallest copy takes beyond its bytes at
    that rate (at least 0)."""
    dev = _card(device)
    points = []
    for mib in sizes_mib:
        n = mib << 20
        src = torch.empty(n, dtype=torch.uint8, device=dev).fill_(1)
        dst = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        ms = min(event_ms(lambda: dst.copy_(src, non_blocking=True), iters,
                          warmup=1) for _ in range(repeats))
        points.append({"bytes": n, "ms": ms})
        del src, dst
    (b0, t0), (b1, t1) = [(p["bytes"], p["ms"] / 1e3) for p in points[-2:]]
    bandwidth = (b1 - b0) / (t1 - t0)
    small = points[0]
    latency = max(small["ms"] / 1e3 - small["bytes"] / bandwidth, 0.0)
    return bandwidth, latency, points


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def calibrate_machine_constants(path: Optional[str] = None,
                                spec_name: str = "h100",
                                device="cuda") -> Dict:
    """Measure the serve search's constants on the card and write them to
    ``path`` (read by ``MachineModel.with_calibration``); returns the
    document, which names the card and its power limit."""
    from .machine_model import TPU_SPECS

    spec = TPU_SPECS[spec_name]
    dev = _card(device)
    eff, gemm_ms = probe_mxu_efficiency(dev, spec.peak_flops_bf16)
    bw, lat, points = probe_host_link(dev)
    out: Dict = {
        "device": spec_name,
        "card": card_name(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "mxu_efficiency": eff,
        "step_overhead": probe_step_overhead(dev),
        "host_bandwidth": bw,
        "host_latency": lat,
        "probes": {
            "gemm": {"shape": list(GEMM_SHAPE), "dtype": "bfloat16",
                     "ms": gemm_ms},
            "step": "in-place scale of a [8, 128] float32 tensor, the "
                    "fastest of 3 timings of 2000 launches back to back",
            "host_copies": points,
        },
        "not_measured": {
            "spec_break_even_acceptance": "needs a draft of known "
                                          "acceptance; the spec keeps its "
                                          "placeholder",
            "overlap": "needs two cards; the spec keeps its placeholder",
            "ici_bandwidth": "needs two cards; the spec keeps the data "
                             "sheet",
            "ici_latency": "needs two cards; the spec keeps its "
                           "placeholder",
            "train_step_factor": "training is not ported",
        },
    }
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return out
