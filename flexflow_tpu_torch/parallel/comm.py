"""The collectives of tensor-parallel serving, and the lockstep driver.

In the reference the shards are one SPMD program and GSPMD inserts the
collectives a plan's parallel ops constrain.  Here one controller holds
one model per shard, and each shard runs its plan's steps
(``parallel/tp.py:PlanExecutor``) as a generator that yields at each
parallel step's collective: ``("all_reduce", t)`` for a partial sum,
``("all_gather", t, dim)`` for a split every shard needs whole,
``("gather", t, dim)`` for one that only shard 0 needs (a range's exit
tensors: the logits, sampled there, and a stage's activations, sent on
from there).  :func:`run_shards` steps the shards' generators in lockstep
and answers each round with one :class:`Comm` call; :func:`run_local`
answers a lone model's yields with the identity, so one forward serves
``tp=1`` and ``tp>1``.  A split may be ragged (a flat batch's rows, the
remainder on the low ranks): the gathers concatenate blocks of any
length.

:class:`Comm` has two implementations, fixed when the mesh is built and
never swapped at run time:

* ``"nccl"``: shards on distinct CUDA devices, single-process NCCL over
  the device list (``torch.cuda.nccl``), one call per collective (a
  ragged all-gather pads each block to the longest and cuts the pads
  off after);
* ``"local"``: shards that share a device, or live on the CPU: the shards'
  tensors are summed (or concatenated) in rank order on the first shard's
  device, and the result is copied to each shard, so every shard holds the
  same bits.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Sequence

import torch

Collectives = Generator  # a forward that yields (op, tensor) and gets a tensor


class Comm:
    """All-reduce and all-gather over one tensor per shard.  ``calls``
    counts the calls of each implementation, so a run shows which one
    ran."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        distinct = len(set(self.devices)) == len(self.devices)
        self.kind = ("nccl" if len(self.devices) > 1 and distinct
                     and all(d.type == "cuda" for d in self.devices)
                     else "local")
        self.calls = {"nccl": 0, "local": 0}

    def _check(self, tensors: Sequence[torch.Tensor]) -> None:
        if len(tensors) != len(self.devices):
            raise ValueError(f"{len(tensors)} tensors for "
                             f"{len(self.devices)} shards")

    def all_reduce(self, tensors: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """The sum of the shards' tensors, on every shard."""
        self._check(tensors)
        self.calls[self.kind] += 1
        if self.kind == "nccl":
            out = [t.contiguous() for t in tensors]
            torch.cuda.nccl.all_reduce(out)
            return out
        dev0 = self.devices[0]
        acc = tensors[0]
        for t in tensors[1:]:
            acc = acc + t.to(dev0)
        return self._to_shards(acc)

    def all_gather(self, tensors: Sequence[torch.Tensor], dim: int = -1
                   ) -> List[torch.Tensor]:
        """The shards' tensors concatenated along ``dim`` in rank order,
        on every shard."""
        self._check(tensors)
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
        dev0 = self.devices[0]
        return self._to_shards(torch.cat([t.to(dev0) for t in tensors],
                                         dim=dim))

    def gather(self, tensors: Sequence[torch.Tensor], dim: int = -1
               ) -> List[Optional[torch.Tensor]]:
        """The shards' tensors concatenated along ``dim`` on shard 0 (the
        other shards get None): over NCCL an all-gather whose other
        copies are dropped, locally one concatenation."""
        if self.kind == "nccl":
            return [self.all_gather(tensors, dim)[0]] + \
                [None] * (len(tensors) - 1)
        self._check(tensors)
        self.calls["local"] += 1
        dev0 = self.devices[0]
        return [torch.cat([t.to(dev0) for t in tensors], dim=dim)] + \
            [None] * (len(tensors) - 1)

    def _to_shards(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` (on shard 0's device) for shard 0, and a copy of it on
        each other shard's device."""
        return [t] + [t.to(d, copy=True) for d in self.devices[1:]]


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
    one, and answers it with one ``comm`` call.  Returns the shards'
    values."""
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
        ops = {(m[0],) + tuple(m[2:]) for m in msgs}
        if len(ops) != 1:
            raise RuntimeError(f"tensor-parallel shards left lockstep: "
                               f"{sorted(ops)} in one round")
        op, *args = ops.pop()
        replies = getattr(comm, op)([m[1] for m in msgs], *args)
