"""Loss functions applied to the final op's output.

Port of ``flexflow_tpu/training/loss.py``; autograd gives the backward.
The clips are ``torch.minimum(torch.maximum(x, lo), hi)``, as
``jnp.clip`` is: at a tie (a saturated softmax row, p = 1.0 in float32)
the gradient splits in half, where ``torch.clamp``'s passes whole.
"""

from __future__ import annotations

import torch

CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
MEAN_SQUARED_ERROR = "mean_squared_error"
BINARY_CROSSENTROPY = "binary_crossentropy"
IDENTITY = "identity"


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the gradient splits at a tie with either bound."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def sparse_labels(labels: torch.Tensor) -> torch.Tensor:
    """Class ids ``[batch]`` from labels ``[batch, ...]`` (the first
    entry of each row), as int64 indices."""
    return labels.reshape(labels.shape[0], -1)[..., 0].long()


def compute_loss(loss_type: str, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean loss over the batch.  For the crossentropy losses the final op
    is conventionally Softmax (the reference's softmax+CE pairing), so
    probabilities arrive here."""
    if loss_type == SPARSE_CATEGORICAL_CROSSENTROPY:
        probs = clip(logits, 1e-10, 1.0)
        ll = torch.log(probs).gather(-1, sparse_labels(labels)[:, None])
        return -ll.mean()
    if loss_type == CATEGORICAL_CROSSENTROPY:
        probs = clip(logits, 1e-10, 1.0)
        return -(labels * torch.log(probs)).sum(-1).mean()
    if loss_type == MEAN_SQUARED_ERROR:
        return (logits - labels).square().mean()
    if loss_type == BINARY_CROSSENTROPY:
        p = clip(logits, 1e-7, 1 - 1e-7)
        return -(labels * torch.log(p)
                 + (1 - labels) * torch.log(1 - p)).mean()
    if loss_type == IDENTITY:
        return logits.mean()
    raise ValueError(f"unknown loss type {loss_type!r}")
