"""Metrics computed on the device, per batch.

Port of ``flexflow_tpu/training/metrics.py``.  Each is a 0-d tensor on
the logits' device; the training loop reads them once an epoch.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .loss import clip, sparse_labels

ACCURACY = "accuracy"
CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
MEAN_SQUARED_ERROR = "mean_squared_error"


def compute_metrics(metric_names: List[str], logits: torch.Tensor,
                    labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    out = {}
    for m in metric_names:
        if m == ACCURACY:
            if (labels.ndim == logits.ndim
                    and labels.shape[-1] == logits.shape[-1]):
                y = torch.argmax(labels, dim=-1)
            else:
                y = sparse_labels(labels)
            pred = torch.argmax(logits, dim=-1)
            out[m] = (pred == y).float().mean()
        elif m == SPARSE_CATEGORICAL_CROSSENTROPY:
            probs = clip(logits, 1e-10, 1.0)
            out[m] = -torch.log(probs).gather(
                -1, sparse_labels(labels)[:, None]).mean()
        elif m == CATEGORICAL_CROSSENTROPY:
            probs = clip(logits, 1e-10, 1.0)
            out[m] = -(labels * torch.log(probs)).sum(-1).mean()
        elif m == MEAN_SQUARED_ERROR:
            out[m] = (logits - labels).square().mean()
        else:
            raise ValueError(f"unknown metric {m!r}")
    return out
