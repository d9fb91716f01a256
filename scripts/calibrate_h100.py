"""Measure the planner's machine constants and op costs on the CUDA card.

    python scripts/calibrate_h100.py [CALIB [COSTS]]

Writes ``CALIB`` (default ``artifacts/h100_calib.json``) with the bf16
GEMM's share of the tensor-core peak (``mxu_efficiency``), the floor of a
trivial step (``step_overhead``), a training step over its forward
(``train_step_factor``) and the pinned device-to-host link
(``host_bandwidth``, ``host_latency``), beside the card's name and power
limit; ``MachineModel.with_calibration(CALIB)`` loads them.  Then
measures the standard op-cost probes anew into ``COSTS`` (default
``artifacts/h100_costs.json``, the ``CostCache`` the port reads by
default; ``flexflow_tpu_torch/search/measure.py``).  Exits non-zero
without a CUDA device.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("calibrate_h100: no CUDA device", file=sys.stderr)
        return 1
    from flexflow_tpu_torch.search.measure import (
        calibrate_machine_constants, calibrate_standard_probes)

    path = argv[0] if argv else os.path.join(ROOT, "artifacts",
                                             "h100_calib.json")
    costs = (argv[1] if len(argv) > 1
             else os.path.join(ROOT, "artifacts", "h100_costs.json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(calibrate_machine_constants(path), indent=1))
    if os.path.exists(costs):
        os.remove(costs)
    calibrate_standard_probes(costs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
