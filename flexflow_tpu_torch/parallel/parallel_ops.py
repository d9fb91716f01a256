"""The parallel ops: the PCG's resharding nodes, priced and run.

Port of ``flexflow_tpu/parallel/parallel_ops.py``: ``_axes_degree`` and
``_local_nbytes`` (:30-50), ``Replicate``, ``Repartition``, ``Combine``,
``Reduction``, ``AllReduce`` and ``AllToAll`` with their
``transform_sharding`` and ``comm_bytes`` (:58-295), and ``reshard_path``
(:296), the PCG normaliser's core.  Each op is a first-class plan step
(``core/pcg.py``), so the search sees and prices it.

Where the reference lowers an op to ``with_sharding_constraint`` (GSPMD
inserts the collective) or to the explicit ``jax.lax`` collective under
``shard_map``, here each op's :meth:`ParallelOp.run` takes one device's
block and returns that device's block of the result: the plan executor
(``parallel/tp.py``) runs one generator per shard in lockstep
(``parallel/comm.py:run_shards``), and a collective is a value the
generator yields, ``("all_gather", x, dim, axes)`` or ``("all_reduce", x,
axes)``, which ``run_shards`` answers with one ``Comm`` call for each
group of shards the op's ``axes`` join (a ``tp`` collective of a ``dp x
tp`` mesh runs within each ``dp`` row):

* ``Replicate``: the identity;
* ``Repartition``: the device's slice (no communication);
* ``Combine``: an all-gather along the dimension;
* ``AllReduce``: an all-reduce;
* ``Reduction``: an all-reduce, then the device's slice (a reduce-scatter
  in two steps);
* ``AllToAll``: an all-gather along the source dimension, then the
  device's slice of the destination dimension.

A split follows ``torch.tensor_split`` (the remainder on the low ranks),
so a flat token batch of any row count splits and gathers back whole.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.graph import TensorSpec
from ..core.op import Op, register_op
from ..core.sharding import (
    DimSharding,
    TensorSharding,
    mesh_coords,
    mesh_shape,
)


def _axes_degree(axes: Tuple[str, ...], mesh) -> int:
    d = 1
    shape = mesh_shape(mesh)
    for a in axes:
        d *= shape[a]
    return d


def _local_nbytes(spec: TensorSpec, sh: TensorSharding, mesh,
                  exclude_axes: Tuple[str, ...] = ()) -> float:
    """Per-device bytes of a tensor under sharding ``sh`` (dims only; the
    ``exclude_axes`` count as unsharded: the shard as the collective
    itself sees it)."""
    deg = 1
    shape = mesh_shape(mesh)
    for d in sh.dims:
        for a in d.axes:
            if a not in exclude_axes:
                deg *= shape[a]
    return spec.nbytes() / deg


def _slice(x: torch.Tensor, dim: int, axes, rank: int, mesh) -> torch.Tensor:
    """Device ``rank``'s block of ``x`` split on ``dim`` over ``axes``."""
    deg = _axes_degree(axes, mesh)
    if deg == 1:
        return x
    d = DimSharding(tuple(axes))
    idx = d.index(mesh_coords(rank, mesh), mesh_shape(mesh))
    return torch.tensor_split(x, deg, dim=dim)[idx]


class ParallelOp(Op):
    """Base: the identity on the global shape, a rewrite of its
    sharding."""

    axes: Tuple[str, ...] = ()

    def infer_shapes(self, in_specs: List[TensorSpec]) -> List[TensorSpec]:
        return [in_specs[0]]

    def is_parallel_op(self) -> bool:
        return True

    def flops(self, in_specs) -> int:
        return 0

    def transform_sharding(self, sh: TensorSharding, mesh) -> TensorSharding:
        raise NotImplementedError

    def comm_bytes(self, spec: TensorSpec, sh_in: TensorSharding,
                   mesh) -> int:
        """Bytes moved per device (the cost model's hook)."""
        raise NotImplementedError

    def run(self, x: torch.Tensor, rank: int, mesh):
        """Device ``rank``'s block of the result from its block ``x``; a
        generator where the op communicates."""
        raise NotImplementedError


@register_op
class Replicate(ParallelOp):
    """Assert the value is replicated over ``axes``: free, as a tensor
    whose sharding names no axis already lies whole on each device."""

    type_name = "replicate"

    def __init__(self, axes: Tuple[str, ...]):
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        used = sh.used_axes()
        for a in self.axes:
            if a in used:
                raise ValueError(f"replicate: axis {a} already used by {sh}")
        return sh

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        return 0

    def run(self, x, rank, mesh):
        return x


@register_op
class Repartition(ParallelOp):
    """Split logical dim ``dim`` across ``axes`` (from replicated)."""

    type_name = "repartition"

    def __init__(self, dim: int, axes: Tuple[str, ...]):
        self.dim = dim
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        if sh.dims[self.dim].axes:
            raise ValueError(f"repartition: dim {self.dim} already sharded: "
                             f"{sh}")
        for a in self.axes:
            if a in sh.used_axes():
                raise ValueError(f"repartition: axis {a} already used by "
                                 f"{sh}")
        return sh.with_dim(self.dim, self.axes)

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        return 0  # a local slice of a replicated value

    def run(self, x, rank, mesh):
        return _slice(x, self.dim, self.axes, rank, mesh)


@register_op
class Combine(ParallelOp):
    """All-gather logical dim ``dim`` from ``axes`` back to whole."""

    type_name = "combine"

    def __init__(self, dim: int, axes: Tuple[str, ...]):
        self.dim = dim
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        have = sh.dims[self.dim].axes
        if tuple(have) != tuple(self.axes):
            raise ValueError(f"combine: dim {self.dim} sharded over {have}, "
                             f"expected {self.axes}")
        return sh.with_dim(self.dim, ())

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        deg = _axes_degree(self.axes, mesh)
        full = _local_nbytes(spec, sh_in, mesh, exclude_axes=self.axes)
        return int(full * (deg - 1) / max(deg, 1))

    def run(self, x, rank, mesh):
        if _axes_degree(self.axes, mesh) > 1:
            x = yield ("all_gather", x, self.dim, self.axes)
        return x


@register_op
class Reduction(ParallelOp):
    """Reduce-scatter a partial sum: sum over ``axes``, split ``dim``."""

    type_name = "reduction"

    def __init__(self, dim: int, axes: Tuple[str, ...]):
        self.dim = dim
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        if not set(self.axes) <= sh.partial_axes:
            raise ValueError(f"reduction over {self.axes}: input not partial "
                             f"over them ({sh})")
        if sh.dims[self.dim].axes:
            raise ValueError(f"reduction: dim {self.dim} already sharded")
        return sh.without_partial(self.axes).with_dim(self.dim, self.axes)

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        deg = _axes_degree(self.axes, mesh)
        local = _local_nbytes(spec, sh_in, mesh)
        return int(local * (deg - 1) / max(deg, 1))

    def run(self, x, rank, mesh):
        if _axes_degree(self.axes, mesh) > 1:
            x = yield ("all_reduce", x, self.axes)
        return _slice(x, self.dim, self.axes, rank, mesh)


@register_op
class AllReduce(ParallelOp):
    """Sum partial values over ``axes``; the result whole on each."""

    type_name = "allreduce"

    def __init__(self, axes: Tuple[str, ...]):
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        if not set(self.axes) <= sh.partial_axes:
            raise ValueError(f"allreduce over {self.axes}: input not partial "
                             f"over them ({sh})")
        return sh.without_partial(self.axes)

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        deg = _axes_degree(self.axes, mesh)
        local = _local_nbytes(spec, sh_in, mesh)
        return int(2 * local * (deg - 1) / max(deg, 1))

    def run(self, x, rank, mesh):
        if _axes_degree(self.axes, mesh) > 1:
            x = yield ("all_reduce", x, self.axes)
        return x


@register_op
class AllToAll(ParallelOp):
    """Move the split over ``axes`` from dim ``src_dim`` to ``dst_dim``."""

    type_name = "all_to_all"

    def __init__(self, src_dim: int, dst_dim: int, axes: Tuple[str, ...]):
        self.src_dim = src_dim
        self.dst_dim = dst_dim
        self.axes = tuple(axes)

    def transform_sharding(self, sh, mesh):
        if tuple(sh.dims[self.src_dim].axes) != tuple(self.axes):
            raise ValueError(f"all_to_all: src dim {self.src_dim} not "
                             f"sharded over {self.axes}")
        if sh.dims[self.dst_dim].axes:
            raise ValueError(f"all_to_all: dst dim {self.dst_dim} already "
                             "sharded")
        return sh.with_dim(self.src_dim, ()).with_dim(self.dst_dim,
                                                      self.axes)

    def comm_bytes(self, spec, sh_in, mesh) -> int:
        deg = _axes_degree(self.axes, mesh)
        local = _local_nbytes(spec, sh_in, mesh)
        return int(local * (deg - 1) / max(deg, 1))

    def run(self, x, rank, mesh):
        if _axes_degree(self.axes, mesh) > 1:
            x = yield ("all_gather", x, self.src_dim, self.axes)
        return _slice(x, self.dst_dim, self.axes, rank, mesh)


def reshard_path(src: TensorSharding, dst: TensorSharding,
                 mesh) -> List[ParallelOp]:
    """The parallel ops turning sharding ``src`` into ``dst`` (reference
    :296): (1) clear partial sums (an AllReduce, or a Reduction straight
    into a wanted split), (2) per-dim fix-ups, an AllToAll where a split
    moves between dims, else Combine, (3) Repartition the splits still
    missing."""
    if src.ndim != dst.ndim:
        raise ValueError("reshard between different ranks")
    ops: List[ParallelOp] = []
    cur = src

    # 1) pending partial sums
    if cur.partial_axes:
        extra = cur.partial_axes - dst.partial_axes
        if extra:
            fused = False
            for d in range(cur.ndim):
                want = tuple(dst.dims[d].axes)
                if want and set(want) == set(extra) and not cur.dims[d].axes:
                    ops.append(Reduction(d, want))
                    cur = ops[-1].transform_sharding(cur, mesh)
                    fused = True
                    break
            if not fused:
                ops.append(AllReduce(tuple(sorted(extra))))
                cur = ops[-1].transform_sharding(cur, mesh)
        if dst.partial_axes - src.partial_axes:
            raise ValueError(f"cannot introduce partialness: {src} -> {dst}")

    # 2) move or clear dim splits
    for d in range(cur.ndim):
        have, want = tuple(cur.dims[d].axes), tuple(dst.dims[d].axes)
        if have == want:
            continue
        if have and want and have != want:
            ops.append(Combine(d, have))
            cur = ops[-1].transform_sharding(cur, mesh)
            have = ()
        if have and not want:
            moved = False
            for d2 in range(cur.ndim):
                if d2 == d:
                    continue
                w2 = tuple(dst.dims[d2].axes)
                if w2 == have and not cur.dims[d2].axes:
                    ops.append(AllToAll(d, d2, have))
                    cur = ops[-1].transform_sharding(cur, mesh)
                    moved = True
                    break
            if not moved:
                ops.append(Combine(d, have))
                cur = ops[-1].transform_sharding(cur, mesh)

    # 3) the wanted splits still missing
    for d in range(cur.ndim):
        have, want = tuple(cur.dims[d].axes), tuple(dst.dims[d].axes)
        if have != want:
            if have:
                ops.append(Combine(d, have))
                cur = ops[-1].transform_sharding(cur, mesh)
            if want:
                ops.append(Repartition(d, want))
                cur = ops[-1].transform_sharding(cur, mesh)

    if (tuple(cur.dims) != tuple(dst.dims)
            or cur.partial_axes != dst.partial_axes):
        raise AssertionError(f"reshard_path failed: got {cur}, want {dst}")
    return ops
