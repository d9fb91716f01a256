"""Batched, shuffled, device-prefetching data loader.

Port of ``flexflow_tpu/data/loader.py`` (reference: ``SingleDataLoader``,
``src/loc/loader.cc``, which stages numpy batches into pinned buffers
and overlaps the host-to-device copies with compute).  An iterator that
slices numpy arrays, places each batch with the plan's input shardings
(``core/interpreter.py:place_inputs``: each shard's block through pinned
host memory, copied without a host wait) and keeps ``prefetch`` batches
in flight, so the copies overlap the running step.  Its Python path
shuffles with ``np.random.RandomState(seed).permutation``, so its batches
are the reference's, bit for bit.

One input array goes through the native C++ staging engine
(``data/native.py``) unless ``native=False``: ``native="auto"`` (the
default) and ``native=True`` build it at first use and raise if the
build fails; nothing falls back to the Python path silently (the
reference does, ``flexflow_tpu/data/loader.py:85-101``).  Several input
arrays take the Python path under ``"auto"`` and raise under ``True``.
:attr:`DataLoader.engine` says which path the last iteration took.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.platform import host_to_device


class DataLoader:
    """Iterate ``(inputs dict, labels)`` batches over numpy data.

    ``x``: an array, a list of arrays (several inputs), or ``{tid:
    array}``.  Drops the trailing ragged batch (every step has one
    shape).  With a ``plan`` (``model.plan``), each batch comes placed
    for it, ``{graph input tid: [each shard's block]}`` and the labels
    on shard 0's device; without one, as CPU tensors under the loader's
    keys."""

    def __init__(self, x, y, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, plan=None,
                 native: object = "auto"):
        if isinstance(x, dict):
            self.inputs = {k: np.asarray(v) for k, v in x.items()}
        elif isinstance(x, (list, tuple)):
            self.inputs = {i: np.asarray(v) for i, v in enumerate(x)}
        else:
            self.inputs = {0: np.asarray(x)}
        self.y = np.asarray(y)
        n = len(self.y)
        for v in self.inputs.values():
            if len(v) != n:
                raise ValueError("inputs and labels disagree on length")
        if native not in ("auto", True, False):
            raise ValueError(f"native={native!r}: 'auto', True or False")
        self.n = n
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.rng = np.random.RandomState(seed)
        self.prefetch = max(int(prefetch), 1)
        self.plan = plan
        # the native engine draws from its own stream (std::mt19937_64),
        # so its epoch order differs from the Python path's for one seed
        self.native = native
        self.engine: Optional[str] = None   # "native" | "python", once run
        self._nb = None
        self._nb_gen = 0  # engine generation: advances the restart seed

    def __len__(self) -> int:
        return self.n // self.batch_size

    def _place(self, batch: Dict, labels: np.ndarray):
        if self.plan is None:
            return ({k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in batch.items()},
                    torch.from_numpy(np.ascontiguousarray(labels)))
        from ..core.interpreter import place_inputs

        # place_inputs looks the plan's input shardings up by graph input
        # tid; the loader's keys (0, 1, ... or a dict's) map positionally
        # onto the plan's input tids (sorted tid order is declaration
        # order) unless every key already is one
        known = self.plan.input_vids
        if not all(k in known for k in batch):
            tids = sorted(known)
            if len(batch) != len(tids):
                raise ValueError(
                    f"loader has {len(batch)} inputs but the plan has "
                    f"{len(tids)} graph inputs; positional mapping needs "
                    "them to match (or use tid keys directly)")
            batch = {t: v for t, v in zip(tids, batch.values())}
        return (place_inputs(self.plan, batch),
                host_to_device(labels, self.plan.mesh.devices[0]))

    def _native_iter(self) -> Optional[Iterator]:
        if self.native is False:
            return None
        if len(self.inputs) != 1:
            if self.native is True:
                raise RuntimeError(
                    "native dataloader supports a single input array; got "
                    f"{len(self.inputs)}")
            return None
        if len(self) == 0:
            # as the Python path: no full batch, no iteration
            return None
        from . import native

        native.load()   # builds at first use; raises if it cannot
        if self._nb is not None and self._nb.pos % len(self) != 0:
            # a previous iteration stopped mid-epoch: abandon that engine
            # (a live generator keeps its own reference) and start a fresh
            # one with an advanced seed, so the restarted epoch is a new
            # shuffle, not an epoch-0 replay
            self._nb = None
        if self._nb is None:
            (key, arr), = self.inputs.items()
            self._nkey = key
            # mix (seed, generation) so a restart seed never collides with
            # a sibling loader's plain seed
            gen_seed = (self.seed ^ (self._nb_gen * 0x9E3779B97F4A7C15)) \
                & (2**64 - 1)
            self._nb_gen += 1
            self._nb = native.NativeBatcher(
                arr, self.y, self.batch_size, shuffle=self.shuffle,
                seed=gen_seed, prefetch=self.prefetch)

        nb = self._nb  # captured: concurrent iterators keep their engine

        def gen():
            for _ in range(len(self)):
                xb, yb, _ = nb.next()
                nb.pos += 1
                # own the rows before the engine reuses its staging buffer
                yield self._place({self._nkey: np.array(xb)}, np.array(yb))

        return gen()

    def __iter__(self) -> Iterator:
        it = self._native_iter()
        self.engine = "python" if it is None else "native"
        return self._python_iter() if it is None else it

    def _python_iter(self) -> Iterator:
        idx = (self.rng.permutation(self.n) if self.shuffle
               else np.arange(self.n))
        starts = range(0, self.n - self.batch_size + 1, self.batch_size)
        queue: collections.deque = collections.deque()
        it = iter(starts)

        def enqueue():
            try:
                s = next(it)
            except StopIteration:
                return False
            sel = idx[s: s + self.batch_size]
            queue.append(self._place(
                {k: v[sel] for k, v in self.inputs.items()}, self.y[sel]))
            return True

        for _ in range(self.prefetch):
            if not enqueue():
                break
        while queue:
            out = queue.popleft()
            enqueue()
            yield out
