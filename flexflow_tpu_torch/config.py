"""FFConfig: the global configuration and FlexFlow-style flag parsing.

Port of ``flexflow_tpu/config.py`` (``FFConfig`` :18-95): every field and
every flag of the reference (Legion-style argv: ``-ll:gpu``, ``-b``,
``-e``, ``--budget``, ``--only-data-parallel``, ``--import`` /
``--export``, ``--mesh dp=2,tp=2``...).  :meth:`FFConfig.devices` names
torch devices: ``cuda:0`` ... ``cuda:n-1``, capped by ``num_devices``;
``FFModel`` with no mesh and no ``mesh_shape`` trains on ``{"dp": n}``
over them, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .utils.platform import resolve_device


@dataclasses.dataclass
class FFConfig:
    # training loop
    batch_size: int = 64
    epochs: int = 1
    learning_rate: float = 0.01

    # machine: mesh axis name -> size; None = one axis "dp" over all devices
    mesh_shape: Optional[Dict[str, int]] = None
    num_devices: Optional[int] = None  # cap the device count (None = all)

    # Unity-style search
    search_budget: int = 0          # 0 = no search (default/imported strategy)
    search_alpha: float = 0.05
    only_data_parallel: bool = False
    # pipeline parallelism: microbatches per step when the mesh has a "pp"
    # axis; pipeline = "auto" | "force" | "off"
    pipeline_microbatches: int = 4
    pipeline: str = "auto"
    import_strategy_file: Optional[str] = None
    export_strategy_file: Optional[str] = None

    # numerics
    compute_dtype: str = "float32"

    # profiling
    profiling: bool = False
    seed: int = 0

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        import sys

        argv = list(sys.argv[1:] if argv is None else argv)
        cfg = FFConfig()
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            return argv[i - 1]

        while i < len(argv):
            a = take()
            if a in ("-b", "--batch-size"):
                cfg.batch_size = int(take())
            elif a in ("-e", "--epochs"):
                cfg.epochs = int(take())
            elif a in ("-lr", "--learning-rate"):
                cfg.learning_rate = float(take())
            elif a == "--budget" or a == "--search-budget":
                cfg.search_budget = int(take())
            elif a == "--search-alpha":
                cfg.search_alpha = float(take())
            elif a == "--only-data-parallel":
                cfg.only_data_parallel = True
            elif a == "--import" or a == "--import-strategy":
                cfg.import_strategy_file = take()
            elif a == "--export" or a == "--export-strategy":
                cfg.export_strategy_file = take()
            elif a == "--mesh":
                # e.g. --mesh dp=4,tp=2
                cfg.mesh_shape = {}
                for part in take().split(","):
                    k, v = part.split("=")
                    cfg.mesh_shape[k.strip()] = int(v)
            elif a in ("-ll:gpu", "-ll:tpu", "--devices"):
                cfg.num_devices = int(take())
            elif a == "--dtype":
                cfg.compute_dtype = take()
            elif a == "--profiling":
                cfg.profiling = True
            elif a == "--seed":
                cfg.seed = int(take())
            # unknown flags are ignored (Legion-style tolerance)
        return cfg

    def devices(self) -> List[torch.device]:
        """The CUDA cards, ``cuda:0`` ... ``cuda:n-1``, at most
        ``num_devices`` of them; raises without a card."""
        resolve_device("cuda")
        n = torch.cuda.device_count()
        if self.num_devices is not None:
            n = min(n, self.num_devices)
        return [torch.device("cuda", i) for i in range(n)]
