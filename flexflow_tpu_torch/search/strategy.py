"""Strategy import and export: JSON maps of op name -> parallel config.

A copy of ``flexflow_tpu/search/strategy.py`` (FlexFlow's ``--import`` /
``--export`` strategy files).  Format::

    {
      "mesh": {"tp": 2},                        # informational
      "ops": {"lm_head": {"sample": ["tp"]}, ...}
    }
"""

from __future__ import annotations

import json
from typing import Dict


def save_strategy(path: str, strategy: Dict[str, Dict], mesh=None) -> None:
    doc = {
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "ops": {
            name: {k: list(v) for k, v in cfg.items()}
            for name, cfg in strategy.items()
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_strategy(path: str) -> Dict[str, Dict]:
    with open(path) as f:
        doc = json.load(f)
    ops = doc.get("ops", doc)  # a bare {name: cfg} file too
    return {
        name: {k: tuple(v) for k, v in cfg.items()}
        for name, cfg in ops.items()
    }
