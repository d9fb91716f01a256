"""A named mesh of torch devices.

Port of ``flexflow_tpu/parallel/mesh.py:18-40`` (``make_mesh``) for the
serve path's two axes.  A ``{"tp": n}`` :class:`Mesh` is the ordered list
of devices that hold the shards of one deployment, shard ``r`` on
``devices[r]``, and the :class:`~.comm.Comm` that joins them.  Which
collective implementation the shards use is fixed here, when the mesh is
built: NCCL across distinct CUDA devices, a local sum otherwise.

A ``{"pp": p, "tp": t}`` mesh (pipeline-parallel serving,
``serve/pp.py``) lists ``p * t`` devices pp-major: stage ``s`` holds
``devices[s*t:(s+1)*t]``, its own ``{"tp": t}`` mesh
(:meth:`Mesh.stage_meshes`, reference ``serve/pp.py:316-323``); the
stages share no collective, so such a mesh has no ``comm``.

A ``{"dp": 1}`` mesh is one device, on which ``FFModel`` trains
(``model.py``); data-parallel training over more comes with slice 11b.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from ..utils.platform import resolve_device
from .comm import Comm

Device = Union[str, torch.device]


class Mesh:
    """``shape`` ``{"tp": n}`` over ``n`` devices, with their collectives
    (``comm``), or ``{"pp": p, "tp": t}`` over ``p * t`` (no ``comm``)."""

    def __init__(self, shape: Dict[str, int], devices: Sequence[Device]):
        self.shape = dict(shape)
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.comm = None if "pp" in self.shape else Comm(self.devices)

    def stage_meshes(self) -> List["Mesh"]:
        """One ``{"tp": t}`` mesh per pipeline stage, pp-major (a mesh
        without a ``pp`` axis is its own one stage)."""
        t = self.shape["tp"]
        return [Mesh({"tp": t}, self.devices[s:s + t])
                for s in range(0, len(self.devices), t)]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self):
        return tuple(self.shape)

    def __repr__(self) -> str:
        comm = "" if self.comm is None else f", comm={self.comm.kind}"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]}{comm})"


def make_mesh(shape: Dict[str, int],
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A named mesh (reference :18).

    ``shape`` is ``{"tp": n}``, or ``{"pp": p, "tp": t}`` (``tp``
    defaults to 1; ``pp=1`` is the plain ``{"tp": t}`` mesh) over ``n =
    p * t`` devices, pp-major, or ``{"dp": 1}`` (one device, training);
    any other shape raises ``ValueError``.
    ``devices=None`` is ``cuda:0`` ... ``cuda:n-1`` and raises when the
    machine has fewer cards.  A device may appear more than once only when
    the caller lists it so (``["cuda:0", "cuda:0"]``: two shards or two
    stages on one card; ``["cpu", "cpu"]`` in the tests): nothing is
    co-located silently.  The devices must all be CUDA devices, or all
    the CPU."""
    shape = {k: int(v) for k, v in shape.items()}
    if shape == {"dp": 1}:
        dev = resolve_device(None if devices is None else devices[0])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(shape, [dev])
    if not set(shape) or set(shape) - {"pp", "tp"}:
        raise ValueError(f"mesh {shape}: the port's mesh is {{'tp': n}} "
                         "or {'pp': p, 'tp': t} (serving), or {'dp': 1} "
                         "(training on one device)")
    pp, tp = shape.get("pp", 1), shape.get("tp", 1)
    if pp < 1 or tp < 1:
        raise ValueError(f"mesh {shape}: pp and tp must be at least 1")
    n = pp * tp
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
    return Mesh({"pp": pp, "tp": tp} if pp > 1 else {"tp": tp}, devices)


def data_parallel_strategy(graph, mesh: Mesh, axes: Sequence[str] = ("dp",)):
    """The data-parallel strategy (reference :49-63): ``sample`` over
    ``axes`` on every op that exposes it and whose batch divides; ``{}``
    on a mesh without those axes (every serve mesh), which is where the
    search starts."""
    axes = tuple(a for a in axes if a in mesh.shape and mesh.shape[a] > 1)
    configs = {}
    if not axes:
        return configs
    for node in graph.nodes:
        in_specs = [graph.spec(t) for t in node.inputs]
        pdims = node.op.parallel_dims(in_specs)
        if "sample" in pdims and pdims["sample"] % int(
                np.prod([mesh.shape[a] for a in axes])) == 0:
            configs[node.name] = {"sample": axes}
    return configs
