"""Measure the serve planner's machine constants on the CUDA card.

    python scripts/calibrate_h100.py [PATH]

Writes ``PATH`` (default ``artifacts/h100_calib.json``) with the bf16
GEMM's share of the tensor-core peak (``mxu_efficiency``), the floor of a
trivial step (``step_overhead``) and the pinned device-to-host link
(``host_bandwidth``, ``host_latency``), beside the card's name and power
limit (``flexflow_tpu_torch/search/measure.py``);
``MachineModel.with_calibration(PATH)`` loads them.  Exits non-zero
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
    from flexflow_tpu_torch.search.measure import calibrate_machine_constants

    path = argv[0] if argv else os.path.join(ROOT, "artifacts",
                                             "h100_calib.json")
    print(json.dumps(calibrate_machine_constants(path), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
