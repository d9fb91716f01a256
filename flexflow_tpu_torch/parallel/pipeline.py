"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Port of ``flexflow_tpu/parallel/pipeline.py`` (``pipeline_apply`` :27-94,
``pipeline_train_step`` :97-148, ``graph_pipeline_train_step`` :151-238).
Homogeneous stages lie along a ``pp`` mesh axis, each shard holding its
stage's block (leading dim 1) of parameters stacked ``[K, ...]``; a
stage's activation moves to the next stage by a shift over the axis, and
the classic GPipe fill, steady and drain run over ``n_micro + K - 1``
ticks.  The reference runs one SPMD program under ``shard_map`` and
shifts with ``lax.ppermute`` in a ``fori_loop``; here
:func:`pipeline_apply` is a shard-local generator that
``parallel/comm.py:run_shards`` steps in lockstep, yielding
``("shift", y, ("pp",), 1)`` each tick.  The backward is autograd
through the shift's ``torch.autograd.Function``, whose backward is the
reverse shift, as the reference's backward pipeline comes from
differentiating its loop.

Bubble ticks: an SPMD program computes on every tick, so the reference's
stages run ``stage_fn`` on zeros (or on a stale microbatch) and throw the
result away.  The port's stage skips that work when it holds no
microbatch and sends zeros in its place: a stage applies ``stage_fn``
``n_micro`` times a call, and the losses, outputs and gradients are the
reference's.  The last tick's shift, which no stage reads, is skipped
too, so a call shifts ``n_micro + K - 2`` times (none when ``K`` is 1).

:class:`PipelineStep` is the train step of a pipelined graph: each shard
runs its share of the schedule (a prefix on stage 0, the core stages, a
suffix per microbatch on the last stage, the loss there), one
``backward`` differentiates every shard's run, and the gradients are
summed as the reference sums them: prefix and suffix gradients over the
``pp`` axis (only their home stage's are non-zero), every gradient
averaged over the ``dp`` axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..core.sharding import mesh_coords


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   axis_name: str, n_stages: int, broadcast: bool = True,
                   feed_fn: Optional[Callable] = None,
                   act_shape: Optional[tuple] = None, act_dtype=None):
    """Run ``n_stages`` pipelined applications of ``stage_fn`` (a
    shard-local generator).

    ``stage_params``: this shard's stage block, every leaf with a leading
    stage dim of 1 (its block of the ``[n_stages, ...]`` stack);
    ``stage_fn(params, x) -> y`` keeps the activation's shape.
    ``x_micro`` ``[n_micro, ...]``: the microbatches, which stage 0
    feeds in.  Returns the last stage's outputs ``[n_micro, ...]`` on
    every shard (an all-reduce over the axis of the last stage's outputs
    and the others' zeros, as the reference's ``psum``), or with
    ``broadcast=False`` each shard's own buffer: the outputs on the last
    stage, zeros elsewhere (mask the loss to the last stage under
    autodiff).  ``feed_fn`` transforms each microbatch before stage 0 (a
    graph's prefix); ``act_shape``/``act_dtype`` then give the
    activation's shape and dtype (by default the microbatch's)."""
    axes = (axis_name,)
    idx = yield ("axis_index", 0, axes)
    n_micro = x_micro.shape[0]
    total = n_micro + n_stages - 1
    params = _tree_map(lambda p: p[0], stage_params)
    mb_shape = (tuple(act_shape) if act_shape is not None
                else tuple(x_micro.shape[1:]))
    act_dtype = act_dtype if act_dtype is not None else x_micro.dtype
    last = idx == n_stages - 1
    outputs, state = [], None
    for t in range(total):
        y = None
        m = t - idx                  # the microbatch this stage holds
        if 0 <= m < n_micro:
            if idx == 0:
                x_in = x_micro[m] if feed_fn is None else feed_fn(x_micro[m])
            else:
                x_in = state
            y = stage_fn(params, x_in)
            if last:
                outputs.append(y)
        if n_stages > 1 and t < total - 1:
            if y is None:            # a bubble tick: nothing to send
                y = torch.zeros(mb_shape, dtype=act_dtype,
                                device=x_micro.device)
            state = yield ("shift", y, axes, 1)
    out = (torch.stack(outputs) if last else
           torch.zeros((n_micro,) + mb_shape, dtype=act_dtype,
                       device=x_micro.device))
    if not broadcast:
        return out
    return (yield ("all_reduce", out, axes))


def _axis_index(mesh, axis: Optional[str]) -> List[int]:
    """Each rank's coordinate on ``axis`` (0 for every rank: None)."""
    return [0 if axis is None else mesh_coords(r, mesh)[axis]
            for r in range(mesh.size)]


def _dp_block(x: torch.Tensor, d: int, n_dp: int) -> torch.Tensor:
    """Block ``d`` of ``n_dp`` of the microbatch dim (dim 1) of ``x``
    ``[n_micro, mb, ...]`` (the reference's ``P(None, "dp")``)."""
    mb = x.shape[1] // n_dp
    return x[:, d * mb:(d + 1) * mb]


class PipelineStep:
    """The GPipe train step of a graph carved into K isomorphic core
    stages, a prefix on stage 0 and a suffix on the last stage (reference
    ``graph_pipeline_train_step``).

    ``stage_fn(core_params, x) -> y`` (shape-keeping),
    ``prefix_fn(prefix_params, raw_mb) -> x``,
    ``suffix_fn(suffix_params, y) -> logits`` (one microbatch),
    ``loss_fn(logits [n_micro, mb, ...], labels) -> scalar``.

    :meth:`run` drives each shard's own state (its leaves, which it
    differentiates in place: their ``.grad``); calling the step on global
    tensors is the reference's ``step(params3, x, labels) -> (loss,
    logits, grads3)``.  ``stage_applications`` counts ``stage_fn`` calls
    over every shard."""

    def __init__(self, stage_fn: Callable, loss_fn: Optional[Callable],
                 mesh, axis_name: str = "pp", dp_axis: Optional[str] = None,
                 prefix_fn: Optional[Callable] = None,
                 suffix_fn: Optional[Callable] = None,
                 act_shape: Optional[tuple] = None, act_dtype=None):
        self.stage_fn, self.loss_fn = stage_fn, loss_fn
        self.prefix_fn, self.suffix_fn = prefix_fn, suffix_fn
        self.mesh, self.axis_name, self.dp_axis = mesh, axis_name, dp_axis
        self.act_shape, self.act_dtype = act_shape, act_dtype
        self.n_stages = mesh.shape[axis_name]
        self.n_dp = mesh.shape[dp_axis] if dp_axis else 1
        self.stage_of = _axis_index(mesh, axis_name)
        self.dp_of = _axis_index(mesh, dp_axis)
        # the ranks whose copies are the global values: each (stage, dp
        # block) at coordinate 0 on every other axis
        self.home = {}
        for r in range(mesh.size):
            c = mesh_coords(r, mesh)
            if all(v == 0 for a, v in c.items()
                   if a not in (axis_name, dp_axis)):
                self.home[(self.stage_of[r], self.dp_of[r])] = r
        self.stage_applications = 0

    def _stage(self, params, x):
        self.stage_applications += 1
        return self.stage_fn(params, x)

    def local(self, core, pre, suf, x, labels, act_shape=None):
        """One shard's forward (a generator of the schedule's collectives)
        -> ``(loss, logits)`` on the last stage, ``(None, None)``
        elsewhere; no loss without ``labels``."""
        idx = yield ("axis_index", 0, (self.axis_name,))
        feed = ((lambda mb: self.prefix_fn(pre, mb)) if self.prefix_fn
                else None)
        outs = yield from pipeline_apply(
            self._stage, core, x, self.axis_name, self.n_stages,
            broadcast=False, feed_fn=feed,
            act_shape=act_shape or self.act_shape, act_dtype=self.act_dtype)
        if idx != self.n_stages - 1:
            return None, None
        # the suffix per microbatch (the reference's vmap): its ops take
        # dim 0 as the batch
        logits = (torch.stack([self.suffix_fn(suf, o) for o in outs])
                  if self.suffix_fn else outs)
        loss = (None if labels is None or self.loss_fn is None
                else self.loss_fn(logits, labels))
        return loss, logits

    def run(self, params: Sequence, xs: Sequence[torch.Tensor],
            labels: Optional[Sequence[torch.Tensor]] = None,
            act_shape: Optional[tuple] = None):
        """Every shard's step in lockstep: ``params[r]`` is shard ``r``'s
        ``(core, prefix, suffix)`` trees of leaves, ``xs[r]`` and
        ``labels[r]`` its ``[n_micro, mb, ...]`` data blocks.  With
        labels, differentiates the last stages' losses and leaves each
        leaf's ``.grad`` the reference's gradient (prefix and suffix
        summed over the pp axis, all averaged over dp); without, the
        forward alone.  Returns the loss (the mean over dp of the last
        stage's; None without labels) and the logits ``[n_micro, mb x dp,
        ...]``, both on shard 0's device."""
        from .comm import run_shards

        mesh = self.mesh
        n = mesh.size
        gens = [self.local(*params[r], xs[r],
                           None if labels is None else labels[r], act_shape)
                for r in range(n)]
        outs = run_shards(gens, mesh.comm)
        last = self.n_stages - 1
        dev0 = mesh.devices[0]
        homes = [self.home[(last, d)] for d in range(self.n_dp)]
        logits = torch.cat([outs[r][1].detach().to(dev0) for r in homes],
                           dim=1)
        if labels is None:
            return None, logits
        torch.autograd.backward([o[0] for o in outs if o[0] is not None])
        self._reduce_grads(params)
        loss = sum(outs[r][0].detach().to(dev0) for r in homes) / self.n_dp
        return loss, logits

    def _reduce_grads(self, params: Sequence) -> None:
        """The reference's gradient sums, in place on every leaf's
        ``.grad``: prefix and suffix over (pp, dp), the core over dp, then
        the mean over dp; one all-reduce a group and dtype."""
        pp_dp = tuple(a for a in (self.axis_name, self.dp_axis) if a)
        todo = [((self.dp_axis,), [_leaves(p[0]) for p in params])] \
            if self.dp_axis else []
        todo.append((pp_dp, [_leaves(p[1]) + _leaves(p[2])
                             for p in params]))
        comm = self.mesh.comm
        for axes, leaves in todo:
            for ranks in comm.groups(axes):
                by_dtype = {}
                for i, w in enumerate(leaves[ranks[0]]):
                    by_dtype.setdefault(w.dtype, []).append(i)
                for idxs in by_dtype.values():
                    flats = [torch.cat([
                        (leaves[r][i].grad if leaves[r][i].grad is not None
                         else torch.zeros_like(leaves[r][i])).reshape(-1)
                        for i in idxs]) for r in ranks]
                    summed = comm.all_reduce(flats, ranks)
                    for r, flat in zip(ranks, summed):
                        if self.n_dp > 1:
                            flat = flat / self.n_dp
                        off = 0
                        for i in idxs:
                            w = leaves[r][i]
                            w.grad = flat[off:off + w.numel()].view_as(w)
                            off += w.numel()

    def __call__(self, params3, x: torch.Tensor, labels: torch.Tensor):
        """The reference's step over global tensors: ``params3 = (core,
        prefix, suffix)`` with core leaves ``[K, ...]``, ``x`` and
        ``labels`` ``[n_micro, mb, ...]`` (the microbatch dim split over
        dp).  Returns ``(loss, logits, (g_core, g_prefix, g_suffix))``,
        the gradients global (core ``[K, ...]``), on shard 0's device."""
        core, pre, suf = params3
        mesh = self.mesh

        def leaves(tree, dev, stage=None):
            """``tree`` as fresh leaves on ``dev`` (a core tree: the
            stage's ``[1, ...]`` block)."""
            return _tree_map(lambda v: (v if stage is None
                                        else v[stage:stage + 1]).detach().to(
                dev, copy=True).requires_grad_(), tree)

        shard = [(leaves(core, dev, self.stage_of[r]), leaves(pre, dev),
                  leaves(suf, dev)) for r, dev in enumerate(mesh.devices)]
        xs = [_dp_block(x, self.dp_of[r], self.n_dp).to(dev)
              for r, dev in enumerate(mesh.devices)]
        ls = [_dp_block(labels, self.dp_of[r], self.n_dp).to(dev)
              for r, dev in enumerate(mesh.devices)]
        loss, logits = self.run(shard, xs, ls)
        dev0 = mesh.devices[0]

        def grads(tree):
            return _tree_map(lambda w: (w.grad if w.grad is not None
                                        else torch.zeros_like(w)).to(dev0),
                             tree)

        g_core = _cat_trees([grads(shard[self.home[(s, 0)]][0])
                             for s in range(self.n_stages)])
        r0 = self.home[(0, 0)]
        return loss, logits, (g_core, grads(shard[r0][1]),
                              grads(shard[r0][2]))


def _cat_trees(trees: Sequence):
    """The first tree's structure, each leaf the concatenation (dim 0)
    of that leaf over ``trees``."""
    flats = [_leaves(t) for t in trees]
    order = iter(range(len(flats[0])))

    def cat(_):
        i = next(order)
        return torch.cat([f[i] for f in flats])

    return _tree_map(cat, trees[0])


def graph_pipeline_train_step(stage_fn: Callable, loss_fn: Callable, mesh,
                              axis_name: str = "pp",
                              dp_axis: Optional[str] = None,
                              prefix_fn: Optional[Callable] = None,
                              suffix_fn: Optional[Callable] = None,
                              act_shape: Optional[tuple] = None,
                              act_dtype=None) -> PipelineStep:
    """The GPipe train step of a partitioned graph (reference :151-238):
    a :class:`PipelineStep`, called as ``step(params3, x, labels) ->
    (loss, logits, grads3)``."""
    return PipelineStep(stage_fn, loss_fn, mesh, axis_name, dp_axis,
                        prefix_fn, suffix_fn, act_shape, act_dtype)


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, mesh,
                        axis_name: str = "pp",
                        dp_axis: Optional[str] = None) -> Callable:
    """``step(stacked_params, x, labels) -> (loss, grads)`` over global
    tensors (reference :97-148): ``stacked_params`` leaves ``[n_stages,
    ...]``, ``x`` and ``labels`` ``[n_micro, mb, ...]`` with the
    microbatch dim split over ``dp_axis``; ``loss_fn(y, labels)`` on the
    last stage's outputs, its gradients averaged over dp."""
    pstep = PipelineStep(stage_fn, loss_fn, mesh, axis_name, dp_axis)

    def step(stacked_params, x, labels):
        loss, _, (g_core, _, _) = pstep((stacked_params, (), ()), x, labels)
        return loss, g_core

    return step
