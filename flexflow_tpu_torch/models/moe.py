"""A classifier with one Mixture-of-Experts layer.

Port of ``flexflow_tpu/models/moe.py:17`` (``build_moe_classifier``, the
reference's ``examples/cpp/mixture_of_experts``): a dense ``pre`` layer,
``FFModel.moe_layer`` (router, ``group_by``, ``experts``, ``aggregate``
with fixed-capacity dispatch, ``ops/moe.py``) and a dense ``head`` with
softmax.  The strategy it returns is the reference's: the MoE nodes'
experts split over ``ep_axes``, ``pre`` and ``head`` split on the batch
over ``dp_axes``.
"""

from __future__ import annotations

from typing import Optional

from ..config import FFConfig
from ..model import FFModel


def build_moe_classifier(
    config: Optional[FFConfig] = None,
    mesh=None,
    batch: int = 32,
    in_dim: int = 64,
    num_experts: int = 4,
    expert_hidden: int = 128,
    num_classes: int = 10,
    k: int = 2,
    capacity_factor: float = 2.0,
    ep_axes=(),
    dp_axes=(),
    device=None,
):
    """Returns ``(model, input tensor, output tensor, strategy)``."""
    ff = FFModel(config or FFConfig(batch_size=batch), mesh=mesh,
                 device=device)
    x_in = ff.create_tensor((batch, in_dim))
    h = ff.dense(x_in, in_dim, activation="relu", name="pre")
    h = ff.moe_layer(h, num_experts, in_dim, hidden_dim=expert_hidden, k=k,
                     capacity_factor=capacity_factor, name="moe")
    out = ff.softmax(ff.dense(h, num_classes, name="head"))
    strategy = {}
    if ep_axes:
        for node in ("moe.group_by", "moe.experts", "moe.aggregate"):
            strategy[node] = {"expert": ep_axes}
    if dp_axes:
        for node in ("pre", "head"):
            strategy[node] = {"sample": dp_axes}
    return ff, x_in, out, strategy
