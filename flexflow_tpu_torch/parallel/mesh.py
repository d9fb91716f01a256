"""A named mesh of torch devices.

Port of ``flexflow_tpu/parallel/mesh.py:18-40`` (``make_mesh``) for the
serve path's one axis, ``"tp"``: a :class:`Mesh` is the ordered list of
devices that hold the shards of one deployment, shard ``r`` on
``devices[r]``, and the :class:`~.comm.Comm` that joins them.  Which
collective implementation the shards use is fixed here, when the mesh is
built: NCCL across distinct CUDA devices, a local sum otherwise.

Pipeline parallelism (a ``"pp"`` axis) is slice 9b of the port, with the
graph IR it needs (``flexflow_tpu/serve/pp.py:46-48``): a mesh asking for
it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from ..utils.platform import resolve_device
from .comm import Comm

Device = Union[str, torch.device]


class Mesh:
    """``shape`` ``{"tp": n}`` over ``n`` devices, with their collectives
    (``comm``)."""

    def __init__(self, shape: Dict[str, int], devices: Sequence[Device]):
        self.shape = dict(shape)
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.comm = Comm(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {[str(d) for d in self.devices]}, "
                f"comm={self.comm.kind})")


def make_mesh(shape: Dict[str, int],
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A named mesh (reference :18).

    ``shape`` is ``{"tp": n}``; a ``"pp"`` axis above 1 raises
    ``NotImplementedError`` (slice 9b), any other shape ``ValueError``.
    ``devices=None`` is ``cuda:0`` ... ``cuda:n-1`` and raises when the
    machine has fewer cards.  A device may appear more than once only when
    the caller lists it so (``["cuda:0", "cuda:0"]``: two shards on one
    card; ``["cpu", "cpu"]`` in the tests): nothing is co-located
    silently.  The devices must all be CUDA devices, or all the CPU."""
    shape = {k: int(v) for k, v in shape.items()}
    if shape.get("pp", 1) > 1:
        raise NotImplementedError(
            f"mesh {shape}: pipeline-parallel serving is slice 9b of the "
            "port (the graph IR, live_cuts and the stage-split manager), "
            "not ported yet")
    if set(shape) != {"tp"}:
        raise ValueError(f"mesh {shape}: the serve path's mesh is "
                         "{'tp': n}")
    n = shape["tp"]
    if n < 1:
        raise ValueError(f"mesh {shape}: tp must be at least 1")
    if devices is None:
        resolve_device("cuda")   # raises without CUDA
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"mesh {shape} needs {n} CUDA devices, this "
                             f"machine has {have}; pass devices= to place "
                             "several shards on one device")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devices)}")
    devices = devices[:n]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"mesh devices must all be CUDA devices or all "
                         f"the CPU, got {[str(d) for d in devices]}")
    if kinds == {"cuda"}:   # an index on each, so distinct cards compare
        resolve_device("cuda")
        devices = [torch.device("cuda", d.index if d.index is not None
                                else torch.cuda.current_device())
                   for d in devices]
    return Mesh({"tp": n}, devices)
