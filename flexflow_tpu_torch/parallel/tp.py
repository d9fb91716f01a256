"""The plan executor: shard-local execution of any PCG plan.

A strategy dict ``{node name: {parallel dim: (mesh axes)}}`` (the
Megatron rule below, a searched one, ``search/search.py:graph_optimize``,
the data-parallel one, or one written by hand) is planned by the PCG
(``core/pcg.py``) over a mesh.  :class:`ShardPlan` reads any such plan
shard by shard; the serve path's :class:`TPPlan` plans a model's node
range on a ``{"tp": n}`` mesh, and ``FFModel`` (``core/interpreter.py``)
plans its builder graph on a ``{"dp": d, "tp": t}`` one.  The plan is the
one thing shard-local execution reads:

* **parameters**: each node's ``ShardingSolution`` gives its parameters'
  shardings; :func:`shard_model` gives each rank's module its blocks
  (``TensorSharding.local_shape``) and :meth:`TPPlan.local` slices a
  global weight into them.  An int8 weight's per-output-channel scale
  (its shape minus the first dim) follows the weight's sharding without
  its first dim (reference ``serve/quant.py:55``): split with a
  column-split kernel or ``qkv``, whole with a row-split kernel or
  ``o_proj``.  Global parameters are quantized first and sliced after.
* **modules**: a ``head`` attention holds its shard's KV heads and their
  query heads (``head_sharded``, ``head_offset``; the KV caches follow);
  an embedding split on ``entry`` answers its rows' ids
  (``entry_offset``); a node whose output is a partial sum adds its bias
  on the shards at coordinate 0 of the partial axes only (``skip_bias``
  elsewhere) (:func:`place_module`).  Every other config changes no
  module: a node computes on the blocks its inputs arrive in.
* **values**: :class:`PlanExecutor` turns the plan's steps into the node
  range a shard model runs (``core/interpreter.py:run_nodes``): each op
  step calls its node's module on its inputs' blocks, each parallel step
  runs its op (``parallel/parallel_ops.py``, ``ParallelOp.run``) on the
  rank's block and yields its collective, which ``parallel/comm.py:
  run_shards`` answers, within the groups of shards the op's axes join.
  The range's entry tensors are sliced to the
  plan's input shardings (the token ids too: a ``sample`` split is the
  rank's rows of the flat batch, computed per step from the batch's row
  count, the remainder on the low ranks); its exit tensors leave whole on
  shard 0 (a split one is gathered there over its split's axes).  The batch's metadata stays
  whole on every shard: the nodes that read it per row (the attention,
  the position embedding) take whole rows, as their op IR requires, and
  a gated LM head split on ``sample`` gathers its rows first.

A config the executor cannot run raises ``NotImplementedError`` naming
the node and the config: one that names a parallel dim the node does not
have (the reference's ops ignore such a key and run replicated; here
nothing falls back to replicated).  The attention's ``sample`` is a dim
its IR has and ignores (reference ``serve/ops.py:964-980``), and so does
the executor.

:func:`tensor_parallel_strategy` is a copy of
``flexflow_tpu/serve/inference_manager.py:42-80`` over the port's module
paths, which are the reference's node names: one strategy dict among
others.  :func:`tp_collectives` reads a plan's parallel steps, kind and
bytes (``comm_bytes``): the serve planner's TP communication term.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.graph import Node
from ..core.interpreter import dead_after, parallel_run
from ..core.pcg import PCG, Plan, serve_graph
from ..core.sharding import TensorSharding, mesh_coords, mesh_shape
from ..ops.embedding import Embedding
from ..ops.linear import Linear

# serve/ops.py's attention op types: the base and its two aliases
# (reference serve/inference_manager.py:62-66)
ATTENTION = ("inc_multihead_self_attention",
             "spec_inc_multihead_self_attention",
             "tree_inc_multihead_self_attention")

TP_AXES = ("tp",)
COL_NAMES = ("gate_proj", "up_proj", "fc1", "c_fc")
ROW_NAMES = ("down_proj", "fc2", "c_proj")


def tensor_parallel_strategy(model: nn.Module, degree: int
                             ) -> Dict[str, Dict]:
    """``{module path: {"head" | "channel_out" | "channel_in": ("tp",)}}``
    for every sharded attention layer and Linear of ``model`` (the global
    model), as the reference's strategy for a ``tp`` mesh of ``degree``
    devices (reference :42-80; a path the rules leave whole has no
    entry): attention head-sharded when its KV heads divide, the MLP's
    ``gate_proj``/``up_proj``/``fc1``/``c_fc`` column-split and
    ``down_proj``/``fc2``/``c_proj`` row-split, any other Linear whose
    output width divides column-split."""
    strategy: Dict[str, Dict] = {}
    for name, mod in model.named_modules():
        if getattr(mod, "type_name", None) in ATTENTION:
            if mod.num_kv_heads % degree == 0:
                strategy[name] = {"head": TP_AXES}
        elif isinstance(mod, Linear):
            in_dim, out_dim = mod.kernel.shape
            if any(s in name for s in COL_NAMES):
                if out_dim % degree == 0:
                    strategy[name] = {"channel_out": TP_AXES}
            elif any(s in name for s in ROW_NAMES):
                if in_dim and in_dim % degree == 0:
                    strategy[name] = {"channel_in": TP_AXES}
            elif out_dim % degree == 0:
                strategy[name] = {"channel_out": TP_AXES}
    return strategy


def _live_config(config: Dict, mesh) -> Dict:
    """The entries of a node's config whose axes split something (a
    degree above 1)."""
    shape = mesh_shape(mesh)
    out = {}
    for k, axes in config.items():
        deg = 1
        for a in axes:
            deg *= shape.get(a, 1)
        if deg > 1:
            out[k] = tuple(axes)
    return out


class ShardPlan:
    """A ``core/pcg.py`` :class:`~..core.pcg.Plan` read shard by shard:
    each parameter's sharding by ``<node>.<param>`` name (the plan's
    ``param_shardings``; a training node's module is its name, a serve
    node's its path), a rank's block of a global value (:meth:`local`)
    and the global value from the shards' blocks (:meth:`whole`).  It
    needs the plan and nothing else: ``FFModel`` runs one over its
    builder graph (``core/interpreter.py``), :class:`TPPlan` over a
    serve model's span.  Raises ``NotImplementedError`` for a plan the
    executor cannot run (:func:`_check_executable`)."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self.mesh = plan.mesh
        self.degree = plan.mesh.size
        self.shardings: Dict[str, TensorSharding] = {
            f"{node}.{p}": sh
            for node, group in plan.param_shardings.items()
            for p, sh in group.items()}
        _check_executable(plan, self.mesh)

    def sharding(self, name: str) -> Optional[TensorSharding]:
        """Parameter ``name``'s sharding (None: whole on every shard).  An
        int8 scale ``<w>_scale`` follows its weight's output dims."""
        sh = self.shardings.get(name)
        if sh is None and name.endswith("_scale"):
            w = self.shardings.get(name[:-len("_scale")])
            if w is not None:
                sh = TensorSharding(w.dims[1:])
        return sh

    def dim(self, name: str) -> Optional[int]:
        """The dim parameter ``name`` is split on (None: whole)."""
        sh = self.sharding(name)
        if sh is None:
            return None
        split = [i for i in sh.split_dims()
                 if sh.dim_degree(i, self.mesh) > 1]
        if len(split) > 1:
            raise NotImplementedError(f"parameter {name} is split on dims "
                                      f"{split}: the executor splits one")
        return split[0] if split else None

    def local(self, name: str, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Shard ``rank``'s block of the global parameter ``t``."""
        sh = self.sharding(name)
        if sh is None or self.degree == 1:
            return t
        return sh.local_slice(t, rank, self.mesh)

    def global_shape(self, name: str, shape) -> torch.Size:
        """The global shape of parameter ``name`` from a shard's
        ``shape``."""
        shape = list(shape)
        d = self.dim(name)
        if d is not None:
            shape[d] *= self.sharding(name).dim_degree(d, self.mesh)
        return torch.Size(shape)

    def whole(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        """The global parameter from the shards' parts, one a rank (on the
        first part's device): each block taken from the first rank that
        holds it, the blocks concatenated along each split dim."""
        sh = self.sharding(name)
        if sh is None or len(parts) == 1:
            return parts[0]
        return assemble(sh, parts, self.mesh)

    def unused_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes (of a degree above 1) parameter ``name``'s
        sharding leaves unused: the shards that differ only there hold
        replicas of one block."""
        sh = self.sharding(name)
        used = sh.used_axes() if sh is not None else frozenset()
        return tuple(a for a, size in mesh_shape(self.mesh).items()
                     if size > 1 and a not in used)


def assemble(sh: TensorSharding, parts: Sequence[torch.Tensor], mesh
             ) -> torch.Tensor:
    """The global tensor of sharding ``sh`` from one block a rank of
    ``mesh`` (``parts[r]``), on ``parts[0]``'s device."""
    shape = mesh_shape(mesh)
    split = [(i, d) for i, d in enumerate(sh.dims) if d.degree(shape) > 1]
    if not split:
        return parts[0]
    holder: Dict[tuple, int] = {}
    for r in range(len(parts)):
        coords = mesh_coords(r, mesh)
        holder.setdefault(tuple(d.index(coords, shape) for _, d in split),
                          r)
    dev = parts[0].device

    def join(level: int, key: tuple) -> torch.Tensor:
        i, d = split[level]
        pieces = [parts[holder[key + (k,)]].to(dev)
                  if level == len(split) - 1 else join(level + 1, key + (k,))
                  for k in range(d.degree(shape))]
        return torch.cat(pieces, dim=i)

    return join(0, ())


class TPPlan(ShardPlan):
    """The placement of ``model``'s node range (its ``span``: the whole
    graph, or a pipeline stage's) over ``mesh``: the PCG plan of that
    range under ``strategy`` (restricted to the range's nodes, reference
    ``serve/pp.py:163``; None: :func:`tensor_parallel_strategy` at the
    mesh's degree, ``{}`` on one device), its tensors' token axis at
    ``rows`` rows (the flat batch, ``max_tokens_per_batch``, that a
    ``sample`` split must divide, as the reference's graph shapes must;
    default the mesh's size), and each parameter's sharding by
    state-dict name."""

    def __init__(self, model: nn.Module, mesh, strategy: Optional[Dict]
                 = None, rows: Optional[int] = None):
        degree = mesh.size
        if strategy is None:
            strategy = (tensor_parallel_strategy(model, degree)
                        if degree > 1 else {})
        names = {n.name for n in model.span.nodes}
        self.strategy = {k: {d: tuple(a) for d, a in v.items()}
                         for k, v in strategy.items() if k in names}
        rows = rows or degree
        self.pcg = PCG(serve_graph(model, rows), mesh, self.strategy,
                       output_tids=list(model.span.exit_tids))
        super().__init__(self.pcg.plan())


def _check_executable(plan: Plan, mesh) -> None:
    """Raise ``NotImplementedError`` for a node whose config names a
    parallel dim the node does not have (the op would ignore it and run
    replicated)."""
    for st in plan.steps:
        if st.is_parallel:
            continue
        live = _live_config(st.config, mesh)
        dims = st.node.op.parallel_dims(st.in_specs) if live else {}
        bad = sorted(set(live) - set(dims))
        if bad:
            raise NotImplementedError(
                f"node {st.name!r}: config {st.config} names {bad}, not a "
                f"parallel dim of a {st.node.op.type_name} node "
                f"({sorted(dims)}); the executor runs no other split")


def _param(p: nn.Parameter, shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=p.dtype, device=p.device),
                        requires_grad=False)


def shard_model(model: nn.Module, plan: TPPlan, rank: int) -> nn.Module:
    """Shard ``rank``'s model: a copy of the global ``model`` (on
    ``meta``) whose parameters take their blocks' shapes (still empty)
    and whose modules take their placement, running the plan's steps
    (:class:`PlanExecutor`).  The copy keeps the module paths, so
    state-dict names are the global ones.  On one device the shard is
    ``model`` itself (every block is the whole, nothing is marked), so a
    model whose parameters are already filled keeps them."""
    shard = model
    if plan.degree > 1:
        shard = _sliced_copy(model, plan, rank)
    shard.tp_plan = plan
    shard.tp_rank = rank
    shard.set_executor(PlanExecutor(plan, rank))
    return shard


def _sliced_copy(model: nn.Module, plan: TPPlan, rank: int) -> nn.Module:
    if any(not p.is_meta for p in model.parameters()):
        raise ValueError("shard_model takes a model on the meta device "
                         "(from build_model)")
    # the global model's own plan and executor (a model served on one
    # device before) are not the shard's
    memo = {id(getattr(model, k, None)): None
            for k in ("tp_plan", "_executor")}
    shard = copy.deepcopy(model, memo)
    for st in plan.plan.steps:
        if st.is_parallel or st.node.module is None:
            continue
        place_module(shard.get_submodule(st.node.module), st, plan, rank)
    return shard


def place_module(mod: nn.Module, st, plan: ShardPlan, rank: int) -> None:
    """Give ``mod``, rank ``rank``'s copy of op step ``st``'s module (at
    path ``st.node.module``), its placement under ``plan``: each split
    parameter an empty one at its block's shape; a ``head`` attention its
    shard's heads; an ``entry`` embedding its rows' offset; a partial
    output its bias on the shards at coordinate 0 of the partial axes
    only; a ``sample`` Linear the shards its rows split over."""
    mesh = plan.mesh
    shape, coords = mesh_shape(mesh), mesh_coords(rank, mesh)
    for pname, p in list(mod.named_parameters(recurse=False)):
        sh = plan.sharding(f"{st.node.module}.{pname}")
        if sh is not None and sh.used_axes():
            setattr(mod, pname, _param(p, sh.local_shape(p.shape, mesh)))
    partial = bool(st.out_shardings[0].partial_axes)
    first = all(coords[a] == 0 for a in st.out_shardings[0].partial_axes)
    live = _live_config(st.config, mesh)
    attention = getattr(mod, "type_name", None) in ATTENTION
    if attention and "head" in live:
        head = TensorSharding.from_axes(1, {0: live["head"]}).dims[0]
        deg = head.degree(shape)
        mod.num_kv_heads //= deg
        mod.num_q_heads //= deg
        mod.head_sharded = True
        mod.head_shards = deg
        mod.head_offset = head.index(coords, shape) * mod.num_q_heads
    if isinstance(mod, Embedding) and "entry" in live:
        entry = TensorSharding.from_axes(1, {0: live["entry"]}).dims[0]
        # the global table's rows over the axes (a training shard's copy
        # has no weight until init_params sets its block)
        rows = st.node.op.num_entries // entry.degree(shape)
        mod.entry_offset = entry.index(coords, shape) * rows
    if attention or isinstance(mod, Linear):
        mod.skip_bias = partial and not first
    if isinstance(mod, Linear) and "sample" in live:
        mod.row_shards = TensorSharding.from_axes(
            1, {0: live["sample"]}).dims[0].degree(shape)


class PlanExecutor:
    """The node range one shard runs for a plan (a :class:`ShardPlan`):
    ``nodes`` (the plan's steps over its value ids: each op step its
    graph node, run by ``step_run(step)`` where given, each parallel step
    a node running its op), ``drops`` (the values each leaves dead,
    ``core/interpreter.py:dead_after``), and how the range's tensors
    enter (:meth:`enter`) and leave (:meth:`leave`)."""

    def __init__(self, plan: ShardPlan, rank: int,
                 step_run: Optional[Callable] = None):
        p = plan.plan
        self.mesh = plan.mesh
        self.degree = plan.degree
        self.rank = rank
        self.entry = {t: (v, p.input_shardings[t])
                      for t, v in p.input_vids.items()}
        self.exit = list(zip(p.output_vids, p.output_shardings))
        self.nodes: List[Node] = []
        for st in p.steps:
            if st.is_parallel:
                self.nodes.append(Node(-1, st.name, None, "parallel",
                                       list(st.in_vids), list(st.out_vids),
                                       parallel_run(st.node.op, self.mesh)))
            else:
                self.nodes.append(dataclasses.replace(
                    st.node, inputs=list(st.in_vids),
                    outputs=list(st.out_vids), op=None,
                    run=step_run(st) if step_run else st.node.run))
        self.drops = dead_after(self.nodes, p.output_vids)

    def enter(self, tids: Sequence[int], xs: Sequence[torch.Tensor]
              ) -> Dict[int, torch.Tensor]:
        """The values the range starts from: each entry tensor ``xs[i]``
        (whole) of tensor id ``tids[i]``, as this rank's block of its
        input sharding."""
        env = {}
        for t, x in zip(tids, xs):
            vid, sh = self.entry[t]
            env[vid] = (x if self.degree == 1
                        else sh.local_slice(x, self.rank, self.mesh))
        return env

    def leave(self, env: Dict[int, torch.Tensor]):
        """The range's exit tensors, whole on shard 0 (a split one is
        gathered there over the axes that split it, from the shards at
        coordinate 0 of every other axis; the other shards get None), as
        a generator of those gathers.  A tensor split on several dims
        (a ``sample`` and a ``sequence`` split) is all-gathered over each
        dim's axes but the last first."""
        outs = []
        for vid, sh in self.exit:
            x = env[vid]
            split = [i for i in sh.split_dims()
                     if sh.dim_degree(i, self.mesh) > 1]
            for i in split[:-1]:
                x = yield ("all_gather", x, i, tuple(sh.dims[i].axes))
            if split:
                x = yield ("gather", x, split[-1],
                           tuple(sh.dims[split[-1]].axes))
            outs.append(x)
        return outs


# ---- the serve planner's view of a plan ------------------------------------
@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a plan (a parallel step): its kind (the parallel
    op's ``type_name``: ``allreduce``, ``combine`` = all-gather,
    ``reduction`` = reduce-scatter, ``repartition`` = a local slice,
    ``all_to_all``, ``replicate``), the bytes it moves per device
    (``comm_bytes``, reference ``parallel_ops.py:177-248``) and its mesh
    axes."""

    kind: str
    nbytes: int
    axes: tuple = TP_AXES


def tp_collectives(plan: TPPlan) -> List[Collective]:
    """The collectives of ``plan``'s parallel steps, in order: the
    reference's plan steps are their one source."""
    p = plan.plan
    out = []
    for st in p.steps:
        if st.is_parallel:
            op = st.node.op
            out.append(Collective(
                op.type_name,
                op.comm_bytes(st.in_specs[0], st.in_shardings[0], p.mesh),
                tuple(op.axes)))
    return out
