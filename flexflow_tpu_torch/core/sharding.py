"""Per-tensor sharding annotations over a named device mesh.

Port of ``flexflow_tpu/core/sharding.py`` (``DimSharding`` :33,
``TensorSharding`` :45) over the port's ``parallel.Mesh``
(``parallel/mesh.py``), whose ``shape`` is a ``{axis: size}`` dict.  How a
global logical tensor lives on the mesh:

* ``dims[i].axes``: the mesh axes that split logical dimension ``i``;
* replication: any mesh axis neither in ``dims`` nor in ``partial_axes``
  holds a whole copy on each of its devices;
* ``partial_axes``: mesh axes over which the values are partial sums that
  a reduction must add before the value exists.

The reference's ``partition_spec`` and ``named_sharding`` (:131-153) name
JAX's own placement objects and have no counterpart: where the reference
hands GSPMD a sharding, the port's plan executor (``parallel/tp.py``)
takes each device's block itself, :meth:`TensorSharding.local_slice`.
A dimension split over ``n`` devices splits as ``torch.tensor_split``
splits it: the remainder on the lowest ranks, so a flat token batch of
any row count splits (:meth:`TensorSharding.local_shape` with a
``rank``); the planner's shapes must divide, as the reference's must.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``parallel.Mesh``."""
    return dict(mesh.shape)


def mesh_coords(rank: int, mesh) -> Dict[str, int]:
    """The coordinate on each mesh axis of device ``rank`` (row-major over
    ``mesh.shape``'s axis order, as the mesh lists its devices)."""
    coords: Dict[str, int] = {}
    for a, size in reversed(list(mesh_shape(mesh).items())):
        coords[a] = rank % size
        rank //= size
    return coords


@dataclasses.dataclass(frozen=True)
class DimSharding:
    """Sharding of one logical dimension: the mesh axes that split it."""

    axes: Tuple[str, ...] = ()

    def degree(self, shape: Dict[str, int]) -> int:
        d = 1
        for a in self.axes:
            d *= shape[a]
        return d

    def index(self, coords: Dict[str, int], shape: Dict[str, int]) -> int:
        """The block a device with mesh ``coords`` holds (linearised over
        ``axes``, the first axis major)."""
        idx = 0
        for a in self.axes:
            idx = idx * shape[a] + coords[a]
        return idx


@dataclasses.dataclass(frozen=True)
class TensorSharding:
    """The sharding of one PCG tensor: one :class:`DimSharding` a logical
    dimension, and the mesh axes over which it is an unreduced partial
    sum."""

    dims: Tuple[DimSharding, ...]
    partial_axes: frozenset = frozenset()

    # ---- constructors -------------------------------------------------
    @staticmethod
    def replicated(ndim: int) -> "TensorSharding":
        return TensorSharding(tuple(DimSharding() for _ in range(ndim)))

    @staticmethod
    def from_axes(ndim: int, axis_map: Optional[dict] = None,
                  partial: Iterable[str] = ()) -> "TensorSharding":
        """``axis_map``: ``{dim index: mesh axis name or tuple of
        names}``."""
        axis_map = axis_map or {}
        dims = []
        for i in range(ndim):
            a = axis_map.get(i, ())
            if isinstance(a, str):
                a = (a,)
            dims.append(DimSharding(tuple(a)))
        return TensorSharding(tuple(dims), frozenset(partial))

    # ---- queries ------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.dims)

    def sharded_axes(self) -> Tuple[str, ...]:
        out = []
        for d in self.dims:
            out.extend(d.axes)
        return tuple(out)

    def used_axes(self) -> frozenset:
        return frozenset(self.sharded_axes()) | self.partial_axes

    def is_fully_replicated(self) -> bool:
        return not self.used_axes()

    def split_dims(self) -> Tuple[int, ...]:
        """The logical dimensions some mesh axis splits."""
        return tuple(i for i, d in enumerate(self.dims) if d.axes)

    def dim_degree(self, dim: int, mesh) -> int:
        return self.dims[dim].degree(mesh_shape(mesh))

    def local_shape(self, global_shape: Sequence[int], mesh,
                    rank: Optional[int] = None) -> Tuple[int, ...]:
        """One device's block shape.  Without ``rank`` (the planner) every
        split dimension must divide by its degree, else ``ValueError``
        (reference :98-110); with ``rank``, device ``rank``'s block of a
        split that need not divide, the remainder on the low ranks."""
        shape = mesh_shape(mesh)
        coords = None if rank is None else mesh_coords(rank, mesh)
        out = []
        for size, d in zip(global_shape, self.dims):
            deg = d.degree(shape)
            if coords is not None:
                idx = d.index(coords, shape)
                out.append(size // deg + (idx < size % deg))
                continue
            if size % deg != 0:
                raise ValueError(f"dim of size {size} not divisible by "
                                 f"degree {deg} (axes {d.axes})")
            out.append(size // deg)
        return tuple(out)

    def local_slice(self, t: torch.Tensor, rank: int, mesh) -> torch.Tensor:
        """Device ``rank``'s block of the global tensor ``t`` (a view):
        each split dimension cut as ``torch.tensor_split`` cuts it, the
        remainder on the low ranks.  A partial sum has no block of its
        own: the partial axes are ignored."""
        shape = mesh_shape(mesh)
        coords = mesh_coords(rank, mesh)
        for i, d in enumerate(self.dims):
            deg = d.degree(shape)
            if deg > 1:
                t = torch.tensor_split(t, deg, dim=i)[d.index(coords, shape)]
        return t

    def validate(self, global_shape: Sequence[int], mesh) -> None:
        if len(global_shape) != len(self.dims):
            raise ValueError(f"sharding rank {len(self.dims)} != tensor "
                             f"rank {len(global_shape)}")
        shape = mesh_shape(mesh)
        seen = set()
        for d in self.dims:
            for a in d.axes:
                if a not in shape:
                    raise ValueError(f"unknown mesh axis {a!r}")
                if a in seen:
                    raise ValueError(f"mesh axis {a!r} used to shard two "
                                     "dims")
                seen.add(a)
        for a in self.partial_axes:
            if a not in shape:
                raise ValueError(f"unknown mesh axis {a!r} in partial_axes")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} both shards a dim and "
                                 "is partial")
        self.local_shape(global_shape, mesh)

    # ---- rewriting helpers (parallel ops, search) ----------------------
    def with_dim(self, dim: int, axes: Tuple[str, ...]) -> "TensorSharding":
        dims = list(self.dims)
        dims[dim] = DimSharding(tuple(axes))
        return TensorSharding(tuple(dims), self.partial_axes)

    def without_partial(self, axes: Iterable[str]) -> "TensorSharding":
        return TensorSharding(self.dims, self.partial_axes - frozenset(axes))

    def with_partial(self, axes: Iterable[str]) -> "TensorSharding":
        return TensorSharding(self.dims, self.partial_axes | frozenset(axes))

    def __str__(self) -> str:
        parts = ["x".join(d.axes) if d.axes else "-" for d in self.dims]
        s = "[" + ",".join(parts) + "]"
        if self.partial_axes:
            s += "+partial(" + ",".join(sorted(self.partial_axes)) + ")"
        return s
