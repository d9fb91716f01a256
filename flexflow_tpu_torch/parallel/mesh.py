"""A named mesh of torch devices.

Port of ``flexflow_tpu/parallel/mesh.py:18-63`` (``make_mesh``,
``data_parallel_strategy``).  A :class:`Mesh` is a ``{axis: size}``
shape and the ordered list of devices that hold its shards, row-major
over the shape's axes as the reference lays them out (shard ``r`` on
``devices[r]``), and the :class:`~.comm.Comm` that joins them.  Which
collective implementation the shards use is fixed here, when the mesh is
built: NCCL across distinct CUDA devices, a local sum otherwise.

* ``{"tp": n}``: tensor-parallel serving, and a training mesh;
* ``{"pp": p, "tp": t}`` (pipeline-parallel serving, ``serve/pp.py``):
  ``p * t`` devices pp-major, stage ``s`` holding
  ``devices[s*t:(s+1)*t]``, its own ``{"tp": t}`` mesh
  (:meth:`Mesh.stage_meshes`, reference ``serve/pp.py:316-323``);
  serving's stages run on those, and its ``comm`` joins no stages;
* any shape over ``dp``, ``tp``, ``mp``, ``ep``, ``pp`` and ``sp``
  (``{"dp": d}``, ``{"dp": d, "tp": t}``, ``{"dp": d, "mp": m}``,
  ``{"ep": e}``, ``{"pp": p, "dp": d}``, ``{"dp": d, "sp": s}``..., in
  any order): the training meshes ``FFModel`` runs a plan on
  (``model.py``), ``dp`` the data-parallel axis of
  ``data_parallel_strategy``, ``mp`` the axis DLRM's ``entry``-sharded
  tables split over (``models/dlrm.py``), ``ep`` the axis a MoE layer's
  experts split over (``models/moe.py``), ``pp`` the axis the GPipe
  executor's stages lie on (``parallel/pipeline.py``: activations shift
  stage to stage over it) and ``sp`` the axis ring attention splits the
  sequence over (``parallel/ring_attention.py``).

Every mesh has one :class:`~.comm.Comm` over all its axes: a training
mesh's shifts run over ``pp`` while its means and sums run over ``dp``,
and a serving ``{"pp": p, "tp": t}`` mesh's stages use their own
meshes' (``{"pp": p}`` alone is both: a serving shape, normalised to
``{"pp": p, "tp": 1}``, and a training mesh).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

import torch

from ..utils.platform import resolve_device
from .comm import Comm

Device = Union[str, torch.device]


class Mesh:
    """``shape`` over its devices, row-major, with their collectives
    (``comm``, over all the axes)."""

    def __init__(self, shape: Dict[str, int], devices: Sequence[Device]):
        self.shape = dict(shape)
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.comm = Comm(self.devices, self.shape)

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
        return (f"Mesh({self.shape}, {[str(d) for d in self.devices]}, "
                f"comm={self.comm.kind})")


TRAIN_AXES = frozenset({"dp", "tp", "mp", "ep", "pp", "sp"})


def make_mesh(shape: Dict[str, int],
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A named mesh (reference :18).

    ``shape`` is ``{"tp": n}``, or ``{"pp": p, "tp": t}`` (``tp``
    defaults to 1; ``pp=1`` is the plain ``{"tp": t}`` mesh) over ``n =
    p * t`` devices, pp-major (serving), or any shape over ``dp``,
    ``tp``, ``mp``, ``ep``, ``pp`` and ``sp`` over the product of its
    sizes, row-major over the shape's axes (training; ``{"dp": 1}`` is one
    device).  Any other shape raises ``ValueError``.
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
    serve = set(shape) <= {"pp", "tp"}
    if not shape or not (serve or set(shape) <= TRAIN_AXES):
        raise ValueError(f"mesh {shape}: the port's mesh is {{'tp': n}} "
                         "or {'pp': p, 'tp': t} (serving), or a shape over "
                         f"{sorted(TRAIN_AXES)} (training)")
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh {shape}: every axis must be at least 1")
    if serve:
        pp, tp = shape.get("pp", 1), shape.get("tp", 1)
        shape = {"pp": pp, "tp": tp} if pp > 1 else {"tp": tp}
    n = int(np.prod(list(shape.values())))
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
    return Mesh(shape, devices)


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
