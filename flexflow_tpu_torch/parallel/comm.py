"""The collectives of the plan executor, and the lockstep runner.

In the reference the shards are one SPMD program and GSPMD inserts the
collectives a plan's parallel ops constrain.  Here one controller holds
one model per shard, and each shard runs its plan's steps
(``parallel/tp.py:PlanExecutor``) as a generator that yields at each
parallel step's collective: ``("all_reduce", t)`` for a partial sum,
``("all_gather", t, dim)`` for a split every shard needs whole,
``("gather", t, dim)`` for one that only shard 0 needs (a range's exit
tensors: the logits, sampled there, the training loss's inputs, and a
stage's activations, sent on from there).  A message may end with the
mesh axes it runs over (``("all_reduce", t, ("tp",))``): the shards are
then grouped by their coordinates on the other axes and each group is
answered on its own, so a ``dp x tp`` plan reduces within each ``dp``
row; a message without axes joins every shard.  A gather answers only
the group that holds shard 0.  :func:`run_shards` steps the shards'
generators in lockstep and answers each round with one :class:`Comm`
call per group; :func:`run_local` answers a lone model's yields with the
identity, so one forward serves one device and many.  A split may be
ragged (a flat batch's rows, the remainder on the low ranks): the
gathers concatenate blocks of any length.

Autograd: where a round's tensors require a gradient (training),
:func:`run_shards` applies each collective as a ``torch.autograd.Function``
over all of a group's tensors at once, whose backward calls the same
``Comm``: an all-reduce's gradient is the all-reduce of the gradients, an
all-gather's is each shard's slice of the summed gradients, and a gather
onto shard 0 gives each shard its slice of shard 0's gradient, and a
shift's is the reverse shift of the gradients (``ppermute``'s
transpose).  So the
CPU tests run the backward that runs over NCCL; only the transport
differs.

:class:`Comm` has two implementations, fixed when the mesh is built and
never swapped at run time:

* ``"nccl"``: shards on distinct CUDA devices, single-process NCCL over
  the group's devices (``torch.cuda.nccl``), one call per collective (a
  ragged all-gather pads each block to the longest and cuts the pads
  off after); a shift is a peer copy of each tensor to its receiver's
  card (``Tensor.to(device, non_blocking=True)``: ``torch.cuda.nccl``
  has no send or receive);
* ``"local"``: shards that share a device, or live on the CPU: the shards'
  tensors are summed (or concatenated) in rank order on the group's first
  device, and the result is copied to each member, so every member holds
  the same bits; a shift is a plain copy onto the receiver's device.
"""

from __future__ import annotations

from typing import Dict, Generator, List, Optional, Sequence, Tuple

import torch

Collectives = Generator  # a forward that yields (op, tensor) and gets a tensor
Ranks = Optional[Sequence[int]]


class Comm:
    """All-reduce, all-gather, gather and shift over one tensor per member
    of a group of shards (``ranks``; None: every shard).  ``shape`` is
    the mesh's ``{axis: size}`` (None: one axis over every device), which
    :meth:`groups` reads.  ``calls`` counts the calls of each
    implementation, so a run shows which one ran."""

    def __init__(self, devices: Sequence[torch.device],
                 shape: Optional[Dict[str, int]] = None):
        self.devices = [torch.device(d) for d in devices]
        self.shape = dict(shape) if shape else None
        distinct = len(set(self.devices)) == len(self.devices)
        self.kind = ("nccl" if len(self.devices) > 1 and distinct
                     and all(d.type == "cuda" for d in self.devices)
                     else "local")
        self.calls = {"nccl": 0, "local": 0}

    def groups(self, axes: Optional[Tuple[str, ...]]) -> List[List[int]]:
        """The ranks of each group a collective over ``axes`` joins: the
        shards with equal coordinates on the mesh's other axes, each group
        ordered by its block index over ``axes`` (the first axis major,
        as ``core/sharding.py:DimSharding.index`` orders blocks); None:
        one group of every shard."""
        n = len(self.devices)
        if axes is None:
            return [list(range(n))]
        if self.shape is None or set(axes) - set(self.shape):
            raise ValueError(f"a collective over {axes} on a mesh of shape "
                             f"{self.shape}")
        out: Dict[tuple, List[Tuple[int, int]]] = {}
        for r in range(n):
            coords, rest = {}, r
            for a, size in reversed(list(self.shape.items())):
                coords[a] = rest % size
                rest //= size
            index = 0
            for a in axes:
                index = index * self.shape[a] + coords[a]
            key = tuple(coords[a] for a in self.shape if a not in axes)
            out.setdefault(key, []).append((index, r))
        return [[r for _, r in sorted(g)] for g in out.values()]

    def _members(self, tensors: Sequence[torch.Tensor],
                 ranks: Ranks) -> List[int]:
        ranks = list(range(len(self.devices)) if ranks is None else ranks)
        if len(tensors) != len(ranks):
            raise ValueError(f"{len(tensors)} tensors for "
                             f"{len(ranks)} shards")
        return ranks

    def all_reduce(self, tensors: Sequence[torch.Tensor],
                   ranks: Ranks = None) -> List[torch.Tensor]:
        """The sum of the members' tensors, on every member (over NCCL in
        place of the inputs)."""
        ranks = self._members(tensors, ranks)
        self.calls[self.kind] += 1
        if self.kind == "nccl":
            out = [t.contiguous() for t in tensors]
            torch.cuda.nccl.all_reduce(out)
            return out
        dev0 = self.devices[ranks[0]]
        acc = tensors[0]
        for t in tensors[1:]:
            acc = acc + t.to(dev0)
        return self._to_members(acc, ranks)

    def all_gather(self, tensors: Sequence[torch.Tensor], dim: int = -1,
                   ranks: Ranks = None) -> List[torch.Tensor]:
        """The members' tensors concatenated along ``dim`` in rank order,
        on every member."""
        ranks = self._members(tensors, ranks)
        self.calls[self.kind] += 1
        if self.kind == "nccl":
            lens = [t.shape[dim] for t in tensors]
            top = max(lens)
            src = []
            for t in tensors:
                if t.shape[dim] < top:
                    pad = list(t.shape)
                    pad[dim] = top - t.shape[dim]
                    t = torch.cat([t, t.new_zeros(pad)], dim=dim)
                src.append(t.contiguous())
            out = [torch.empty((len(src),) + tuple(t.shape), dtype=t.dtype,
                               device=t.device) for t in src]
            torch.cuda.nccl.all_gather(src, out)
            return [torch.cat([b.narrow(dim, 0, n) for b, n in
                               zip(o.unbind(0), lens)], dim=dim)
                    for o in out]
        dev0 = self.devices[ranks[0]]
        return self._to_members(torch.cat([t.to(dev0) for t in tensors],
                                          dim=dim), ranks)

    def gather(self, tensors: Sequence[torch.Tensor], dim: int = -1,
               ranks: Ranks = None) -> List[Optional[torch.Tensor]]:
        """The members' tensors concatenated along ``dim`` on the first
        member (the others get None): over NCCL an all-gather whose other
        copies are dropped, locally one concatenation."""
        if self.kind == "nccl":
            return [self.all_gather(tensors, dim, ranks)[0]] + \
                [None] * (len(tensors) - 1)
        ranks = self._members(tensors, ranks)
        self.calls["local"] += 1
        dev0 = self.devices[ranks[0]]
        return [torch.cat([t.to(dev0) for t in tensors], dim=dim)] + \
            [None] * (len(tensors) - 1)

    def shift(self, tensors: Sequence[torch.Tensor], offset: int = 1,
              ranks: Ranks = None) -> List[torch.Tensor]:
        """Member ``i``'s tensor sent to member ``(i + offset) % n``: the
        result's ``j``-th entry is member ``(j - offset) % n``'s tensor,
        a copy on member ``j``'s device (a peer copy between cards)."""
        ranks = self._members(tensors, ranks)
        self.calls[self.kind] += 1
        n = len(ranks)
        return [tensors[(j - offset) % n].to(
            self.devices[r], copy=True, non_blocking=self.kind == "nccl")
            for j, r in enumerate(ranks)]

    def _to_members(self, t: torch.Tensor, ranks: List[int]
                    ) -> List[torch.Tensor]:
        """``t`` (on the first member's device) for the first member, and
        a copy of it on each other member's device."""
        return [t] + [t.to(self.devices[r], copy=True) for r in ranks[1:]]


# ---- the collectives under autograd ----------------------------------------
def _fresh(comm: Comm, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``xs`` as ``comm`` may consume them: NCCL reduces in place, so
    there a copy of each (a tensor autograd saved must not change)."""
    return [x.clone() for x in xs] if comm.kind == "nccl" else list(xs)


def _offsets(lens: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for n in lens:
        out.append(acc)
        acc += n
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, ranks, *xs):
        ctx.comm, ctx.ranks = comm, ranks
        return tuple(comm.all_reduce(_fresh(comm, xs), ranks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None,
                *ctx.comm.all_reduce(_fresh(ctx.comm, grads), ctx.ranks))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, ranks, dim, *xs):
        ctx.comm, ctx.ranks, ctx.dim = comm, ranks, dim
        ctx.lens = [x.shape[dim] for x in xs]
        return tuple(comm.all_gather(xs, dim, ranks))

    @staticmethod
    def backward(ctx, *grads):
        total = ctx.comm.all_reduce(_fresh(ctx.comm, grads), ctx.ranks)
        return (None, None, None,
                *(t.narrow(ctx.dim, off, n) for t, off, n in
                  zip(total, _offsets(ctx.lens), ctx.lens)))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, ranks, dim, *xs):
        ctx.dim = dim
        ctx.lens = [x.shape[dim] for x in xs]
        ctx.devices = [x.device for x in xs]
        return comm.gather(xs, dim, ranks)[0]

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None,
                *(grad.narrow(ctx.dim, off, n).to(d) for off, n, d in
                  zip(_offsets(ctx.lens), ctx.lens, ctx.devices)))


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, ranks, offset, *xs):
        ctx.comm, ctx.ranks, ctx.offset = comm, ranks, offset
        return tuple(comm.shift(xs, offset, ranks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None,
                *ctx.comm.shift(grads, -ctx.offset, ctx.ranks))


_FUNCTIONS = {"all_reduce": _AllReduce, "all_gather": _AllGather,
              "gather": _Gather, "shift": _Shift}


def _call(comm: Comm, op: str, xs: List[torch.Tensor], args: tuple,
          ranks: List[int]) -> list:
    """One group's collective: under autograd where a tensor needs a
    gradient, else the plain ``Comm`` call."""
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return getattr(comm, op)(xs, *args, ranks=ranks)
    out = _FUNCTIONS[op].apply(comm, ranks, *args, *xs)
    if op == "gather":
        return [out] + [None] * (len(xs) - 1)
    return list(out)


def _parse(msg) -> Tuple[str, tuple, Optional[Tuple[str, ...]]]:
    """A message's op, its arguments after the tensor, and its axes (a
    trailing tuple of axis names; None: every shard).  A shift's axes
    come before its offset, ``("shift", t, axes, offset)``; an axis
    index's are its last item."""
    op, rest = msg[0], tuple(msg[2:])
    if op == "shift":
        return op, (rest[1] if len(rest) > 1 else 1,), tuple(rest[0])
    if op == "axis_index":
        return op, (), tuple(rest[0])
    axes = None
    if rest and isinstance(rest[-1], tuple) and rest[-1] and all(
            isinstance(a, str) for a in rest[-1]):
        rest, axes = rest[:-1], tuple(rest[-1])
    if op in ("all_gather", "gather") and not rest:
        rest = (-1,)
    return op, rest, axes


def run_local(gen: Collectives):
    """Run one model's forward generator alone: every collective is the
    identity (a lone shard holds the whole sum and the whole dimension).
    Returns the generator's value."""
    try:
        msg = next(gen)
        while True:
            msg = gen.send(msg[1])
    except StopIteration as stop:
        return stop.value


def run_shards(gens: Sequence[Collectives], comm: Comm) -> list:
    """Run one forward generator per shard in lockstep: each round steps
    every shard to its next collective, checks they all asked for the same
    one, and answers it with one ``comm`` call per group of its axes (a
    gather: the group of shard 0 only; an axis index: each member's
    place in its group, no call).  Returns the shards' values."""
    n = len(gens)
    replies: List = [None] * n
    while True:
        msgs, done = [], []
        for r, g in enumerate(gens):
            try:
                msgs.append(g.send(replies[r]))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != n:
                raise RuntimeError("tensor-parallel shards left lockstep: "
                                   f"{len(done)} of {n} finished")
            return done
        ops = {(p[0],) + p[1] + (p[2],) for p in map(_parse, msgs)}
        if len(ops) != 1:
            raise RuntimeError(f"tensor-parallel shards left lockstep: "
                               f"{sorted(ops, key=str)} in one round")
        op, args, axes = _parse(msgs[0])
        replies = [None] * n
        for ranks in comm.groups(axes):
            if op == "axis_index":
                for i, r in enumerate(ranks):
                    replies[r] = i
                continue
            if op == "gather" and 0 not in ranks:
                continue
            outs = _call(comm, op, [msgs[r][1] for r in ranks], args, ranks)
            for r, out in zip(ranks, outs):
                replies[r] = out
