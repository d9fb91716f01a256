"""FFModel: the graph builder, compile, and the training loop.

Port of ``flexflow_tpu/model.py`` (``FFModel`` :61-556 and :946-1204, and
the compile path's pipeline :413-428, :561-944).
The serve builder methods (the KV-cached attention, its speculative and
tree-verifying aliases, the learned positions) record serve graphs that
``serve.InferenceManager(ff, ...)`` serves (``serve/models/builder.py``).
One builder method per layer appends a node holding its op
(``core/graph.py:Graph.add_op``) under the reference's default name, so
parameters carry across by name.  A node's name is the reference's, dots
included (``"layer1.0.conv1"``): ``layers`` holds each node's module
under its name, escaped only inside the ``nn.ModuleDict``
(:class:`NodeModules`).  ``compile`` resolves a strategy in the
reference's order (the explicit dict, ``--import``, the data-parallel
strategy; ``--export``), plans the graph (``core/pcg.py``), builds its
forward (``core/interpreter.py:build_forward``), draws the parameters
(``init_params``) and each shard's optimizer state over its blocks.

Training runs on a mesh (``parallel/mesh.py``): ``FFModel(config,
mesh=make_mesh({"dp": 2, "tp": 2}, devices))``, or ``mesh=None`` for
``{"dp": n}`` over ``FFConfig.devices()`` (``mesh_shape`` picks another
shape), or ``device=`` for one device.  Every shard runs its block of
the plan in lockstep, with the collectives the plan's parallel steps
name.  A train step runs the forward on every shard, gathers the exit
tensors on shard 0, computes the loss and the metrics there,
``backward()`` (through the collectives' own gradients), sums each
parameter block's gradient over the mesh axes its sharding leaves unused
(the all-reduce GSPMD inserts in the reference: ``dp`` replicas saw
other rows, ``tp`` replicas computed the same rows), and runs the
optimizer's update on each shard's blocks, in place.  The per-step
losses and metrics stay on the device until the end of the epoch, where
the host reads them once, as the reference does.  ``params`` and
``opt_state`` are the reference's global trees, assembled from the
shards; ``load_params`` and ``load_opt_state`` slice global values into
every shard.

A search budget (``FFConfig.search_budget``) runs the joint Unity search
at ``compile`` (``search/search.py:graph_optimize(substitution=True)``):
the model adopts the rewritten graph and its strategy.

A mesh with a ``pp`` axis makes ``compile`` consult the pipeline search
(``search/pipeline_search.py``; ``FFConfig.pipeline`` "auto", "force" or
"off").  When the pipeline wins and the graph carves into K isomorphic
core stages (single-entry single-exit segments, so residual blocks stay
whole), a prefix on stage 0 and a suffix on the last stage, training
runs the GPipe executor (``parallel/pipeline.py``): each shard holds its
stage's core parameters (``params()["_pp_core"]["{j}.{param}"]``,
``[K, ...]`` globally, a ``[1, ...]`` block a stage) and the prefix and
suffix replicated; ``fit``, ``evaluate`` and ``forward`` run the
schedule; ``_pp_meta`` names the carve.  Nothing falls back to one
device.  Initial weights, the shuffle order and dropout
masks come from torch generators seeded by ``FFConfig.seed``, so they
match the JAX package's in distribution; ``load_params`` carries its
weights across.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .config import FFConfig
from .core.graph import Graph, Tensor, TensorSpec, live_cuts
from .core.interpreter import (build_forward, draw_params, init_params,
                               place_inputs, plan_shards)
from .core.op import OpContext
from .core.pcg import PCG, Plan
from .data.loader import DataLoader
from .ops.attention import MultiHeadAttention
from .ops.conv import Conv2D, Pool2D
from .ops.elementwise import (Cast, Dropout, ElementBinary, ElementUnary,
                              as_dtype)
from .ops.embedding import Embedding, PositionEmbedding
from .ops.linear import BatchMatmul, Linear
from .ops.norm import (AddBiasResidualLayerNorm, BatchNorm, LayerNorm,
                       ResidualLayerNorm, ResidualRMSNorm, RMSNorm,
                       SigmoidSiluMulti)
from .ops.misc import Cache
from .ops.moe import Aggregate, AggregateSpec, Experts, GroupBy
from .ops.reduction import (ArgMax, ArgTopK, BeamTopK, Reduce, Sampling,
                            Softmax, TopK)
from .ops.shape import (Concat, Flat, Gather, Reshape, Reverse, Split,
                        Transpose)
from .parallel.mesh import data_parallel_strategy, make_mesh
from .parallel.pipeline import PipelineStep, _dp_block
from .search.strategy import load_strategy, save_strategy
from .training import loss as loss_mod
from .training import metrics as metrics_mod
from .training.optimizer import Optimizer, SGDOptimizer
from .utils.platform import host_to_device, resolve_device
from .utils.profiling import maybe_profile
from .utils.runlog import log_run

def _escape(name: str) -> str:
    return name.replace("%", "%25").replace(".", "%2E")


def _unescape(key: str) -> str:
    return key.replace("%2E", ".").replace("%25", "%")


class NodeModules(nn.ModuleDict):
    """An ``nn.ModuleDict`` keyed by node name.  A node name may hold a
    ``.`` (the reference's ``"layer1.0.conv1"``), which a module's own
    name may not: the key a module is registered under is the name with
    ``%`` and ``.`` escaped, and every access takes and gives node
    names."""

    def __getitem__(self, name: str) -> nn.Module:
        return super().__getitem__(_escape(name))

    def __setitem__(self, name: str, module: nn.Module) -> None:
        super().__setitem__(_escape(name), module)

    def __delitem__(self, name: str) -> None:
        super().__delitem__(_escape(name))

    def __contains__(self, name: str) -> bool:
        return super().__contains__(_escape(name))

    def __iter__(self):
        return (_unescape(k) for k in super().__iter__())

    def keys(self):
        return list(self)

    def items(self):
        return [(_unescape(k), m) for k, m in super().items()]


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, mesh=None,
                 device=None):
        self.config = config or FFConfig()
        self.mesh = mesh          # made at compile if None
        self._device_given = mesh is None and device is not None
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.graph = Graph()
        self.layers = NodeModules()   # node name -> its op module
        self.pcg: Optional[PCG] = None
        self.plan: Optional[Plan] = None
        self.strategy = None
        # each shard's {node: {param: block}} and optimizer state
        self.shard_params: Optional[List[Dict[str, Dict[str,
                                                        nn.Parameter]]]] = None
        self.shard_opt_states: Optional[list] = None
        self.optimizer: Optional[Optimizer] = None
        self.loss_type = None
        self.loss_weights: Optional[List[float]] = None
        self.metric_names: List[str] = []
        self._forward = None
        self._compiled_out_tids: Optional[List[int]] = None
        self.grad_allreduces = 0   # the gradient sum's Comm calls
        # the compile path's pipeline (reference :423): (strategy, carve)
        # when training runs the GPipe executor, else None; its runtime
        self._pipeline_ctx = None
        self._pipeline: Optional[_Pipeline] = None
        self._pp_meta = None
        self.pipeline_choice = None   # the consult's kind and prices
        # the model's own stream: init seeds, epoch seeds, shuffles
        self._generator = torch.Generator().manual_seed(self.config.seed)

    # ------------------------------------------------------------------
    # graph building (one method per layer)
    # ------------------------------------------------------------------
    def create_tensor(self, shape: Sequence[int],
                      dtype=torch.float32) -> Tensor:
        tid = self.graph.add_input(TensorSpec(tuple(shape), as_dtype(dtype)))
        return Tensor(self.graph, tid)

    def _add(self, op, inputs: Sequence[Tensor], name=None) -> List[Tensor]:
        outs = self.graph.add_op(op, list(inputs), name)
        self.layers[self.graph.nodes[-1].name] = op
        return outs

    def dense(self, x, out_dim, activation=None, use_bias=True, name=None,
              kernel_initializer=None, bias_initializer=None, dtype=None):
        op = Linear(x.shape[-1], out_dim, as_dtype(dtype or x.dtype),
                    device="meta", use_bias=use_bias, activation=activation,
                    kernel_initializer=kernel_initializer,
                    bias_initializer=bias_initializer)
        return self._add(op, [x], name or "dense")[0]

    def embedding(self, x, num_entries, out_dim, aggr="none", name=None,
                  kernel_initializer=None, dtype=torch.float32):
        op = Embedding(num_entries, out_dim, as_dtype(dtype), device="meta",
                       aggr=aggr, kernel_initializer=kernel_initializer)
        return self._add(op, [x], name or "embedding")[0]

    def batch_matmul(self, a, b, a_transposed=False, b_transposed=False,
                     name=None):
        return self._add(BatchMatmul(a_transposed, b_transposed), [a, b],
                         name or "batch_matmul")[0]

    # elementwise unary
    def _unary(self, fn, x, name, scalar=None):
        return self._add(ElementUnary(fn, scalar), [x], name or fn)[0]

    def relu(self, x, name=None):
        return self._unary("relu", x, name)

    def gelu(self, x, name=None):
        return self._unary("gelu", x, name)

    def sigmoid(self, x, name=None):
        return self._unary("sigmoid", x, name)

    def tanh(self, x, name=None):
        return self._unary("tanh", x, name)

    def silu(self, x, name=None):
        return self._unary("silu", x, name)

    def elu(self, x, name=None):
        return self._unary("elu", x, name)

    def exp(self, x, name=None):
        return self._unary("exp", x, name)

    def identity(self, x, name=None):
        return self._unary("identity", x, name)

    def scalar_multiply(self, x, scalar, name=None):
        return self._unary("scalar_multiply", x, name, scalar)

    def scalar_add(self, x, scalar, name=None):
        return self._unary("scalar_add", x, name, scalar)

    def scalar_sub(self, x, scalar, name=None):
        return self._unary("scalar_sub", x, name, scalar)

    def scalar_truediv(self, x, scalar, name=None):
        return self._unary("scalar_truediv", x, name, scalar)

    def pow(self, x, exponent, name=None):
        return self._unary("pow", x, name, exponent)

    # elementwise binary
    def _binary(self, fn, a, b, name):
        return self._add(ElementBinary(fn), [a, b], name)[0]

    def add(self, a, b, name=None):
        return self._binary("add", a, b, name or "add")

    def subtract(self, a, b, name=None):
        return self._binary("sub", a, b, name or "subtract")

    def multiply(self, a, b, name=None):
        return self._binary("mul", a, b, name or "multiply")

    def divide(self, a, b, name=None):
        return self._binary("div", a, b, name or "divide")

    def max(self, a, b, name=None):
        return self._binary("max", a, b, name or "max")

    def min(self, a, b, name=None):
        return self._binary("min", a, b, name or "min")

    def cast(self, x, dtype, name=None):
        return self._add(Cast(dtype), [x], name or "cast")[0]

    def dropout(self, x, rate, seed=0, name=None):
        return self._add(Dropout(rate, seed), [x], name or "dropout")[0]

    # normalization
    def layer_norm(self, x, elementwise_affine=True, eps=1e-5, use_bias=True,
                   name=None):
        op = LayerNorm(x.shape[-1], eps, use_bias, x.dtype, device="meta",
                       elementwise_affine=elementwise_affine)
        return self._add(op, [x], name or "layer_norm")[0]

    def rms_norm(self, x, eps=1e-6, name=None):
        op = RMSNorm(x.shape[-1], eps, x.dtype, device="meta")
        return self._add(op, [x], name or "rms_norm")[0]

    def residual_layer_norm(self, x, r1, r2=None, elementwise_affine=True,
                            eps=1e-5, use_bias=True, name=None):
        """``[x + r1 (+ r2), layer_norm of that sum]``."""
        ins = [x, r1] + ([r2] if r2 is not None else [])
        op = ResidualLayerNorm(x.shape[-1], r2 is not None,
                               elementwise_affine, eps, use_bias, x.dtype,
                               device="meta")
        return self._add(op, ins, name or "residual_layer_norm")

    def add_bias_residual_layer_norm(self, x, residual,
                                     elementwise_affine=True, eps=1e-5,
                                     use_bias=True, name=None):
        """``[x + attn_bias + residual, layer_norm of that sum]``."""
        op = AddBiasResidualLayerNorm(x.shape[-1], elementwise_affine, eps,
                                      use_bias, x.dtype, device="meta")
        return self._add(op, [x, residual],
                         name or "add_bias_residual_layer_norm")

    def residual_rms_norm(self, x, residual, eps=1e-6, name=None):
        """``[x + residual, rms_norm of that sum]``."""
        op = ResidualRMSNorm(x.shape[-1], eps, x.dtype, device="meta")
        return self._add(op, [x, residual], name or "residual_rms_norm")

    def sigmoid_silu_multi(self, x1, x2, name=None):
        return self._add(SigmoidSiluMulti(), [x1, x2],
                         name or "sigmoid_silu_multi")[0]

    def batch_norm(self, x, relu=False, eps=1e-5, momentum=0.9, name=None):
        op = BatchNorm(x.shape[1], relu, eps, momentum, x.dtype,
                       device="meta")
        return self._add(op, [x], name or "batch_norm")[0]

    # shape
    def reshape(self, x, shape, name=None):
        return self._add(Reshape(shape), [x], name or "reshape")[0]

    def transpose(self, x, perm, name=None):
        return self._add(Transpose(perm), [x], name or "transpose")[0]

    def concat(self, tensors, axis, name=None):
        return self._add(Concat(axis), list(tensors), name or "concat")[0]

    def split(self, x, sizes, axis, name=None):
        """``sizes`` a list of extents, or an int: that many equal
        parts."""
        if isinstance(sizes, int):
            n = x.shape[axis % len(x.shape)] // sizes
            sizes = [n] * sizes
        return self._add(Split(sizes, axis), [x], name or "split")

    def gather(self, x, idx, axis, name=None):
        return self._add(Gather(axis), [x, idx], name or "gather")[0]

    def reverse(self, x, axis, name=None):
        return self._add(Reverse(axis), [x], name or "reverse")[0]

    def flat(self, x, name=None):
        return self._add(Flat(), [x], name or "flat")[0]

    # reductions
    def softmax(self, x, axis=-1, name=None):
        return self._add(Softmax(axis), [x], name or "softmax")[0]

    def reduce_sum(self, x, axes, keepdims=False, name=None):
        return self._add(Reduce("sum", axes, keepdims), [x],
                         name or "reduce_sum")[0]

    def reduce_mean(self, x, axes, keepdims=False, name=None):
        return self._add(Reduce("mean", axes, keepdims), [x],
                         name or "reduce_mean")[0]

    # the decode heads (a graph that ends in one compiles with
    # loss_type="identity" and runs forward; indices are int32)
    def argmax(self, x, name=None):
        return self._add(ArgMax(), [x], name or "argmax")[0]

    def top_k(self, x, k, sorted=True, name=None):
        return self._add(TopK(k, sorted), [x], name or "top_k")

    def arg_top_k(self, x, k, speculative_decoding=False, name=None):
        return self._add(ArgTopK(k, speculative_decoding), [x],
                         name or "arg_top_k")

    def sampling(self, x, top_p=1.0, temperature=1.0, name=None):
        return self._add(Sampling(top_p, temperature), [x],
                         name or "sampling")[0]

    def beam_top_k(self, x, max_beam_width, name=None):
        return self._add(BeamTopK(max_beam_width), [x], name or "beam_top_k")

    # mixture of experts (reference :259-299)
    def group_by(self, x, gates, num_experts, k=1, capacity_factor=1.25,
                 name=None):
        """``[dispatched [E, C, d], combine [N, E, C]]``."""
        return self._add(GroupBy(num_experts, k, capacity_factor),
                         [x, gates], name or "group_by")

    def experts(self, dispatched, out_dim, hidden_dim=None, activation="relu",
                name=None):
        op = Experts(out_dim, hidden_dim, activation, dtype=dispatched.dtype,
                     device="meta")
        return self._add(op, [dispatched], name or "experts")[0]

    def aggregate(self, expert_out, combine, name=None):
        return self._add(Aggregate(), [expert_out, combine],
                         name or "aggregate")[0]

    def aggregate_spec(self, expert_out, combine, gates, k=1, name=None):
        """Each token's ``k`` chosen experts' outputs, unweighted, ``[N,
        k, d]``."""
        return self._add(AggregateSpec(k), [expert_out, combine, gates],
                         name or "aggregate_spec")[0]

    def moe_layer(self, x, num_experts, out_dim, hidden_dim=None, k=1,
                  capacity_factor=1.25, activation="relu", name=None):
        """The router (a dense without bias, then softmax), ``group_by``,
        ``experts`` and ``aggregate``, as nodes ``{name}.router``,
        ``{name}.group_by``, ``{name}.experts``, ``{name}.aggregate``."""
        name = name or "moe"
        gates = self.softmax(self.dense(x, num_experts, use_bias=False,
                                        name=f"{name}.router"))
        disp, comb = self.group_by(x, gates, num_experts, k, capacity_factor,
                                   name=f"{name}.group_by")
        eo = self.experts(disp, out_dim, hidden_dim, activation,
                          name=f"{name}.experts")
        return self.aggregate(eo, comb, name=f"{name}.aggregate")

    def cache(self, x, name=None):
        """The activation cache (``ops/misc.py``): the identity, or with
        ``extras["cache_use"]`` in a stateful step the stored value."""
        return self._add(Cache(), [x], name or "cache")[0]

    # serve attention (KV-cached, speculative, tree-verifying) and the
    # learned positions (reference :309-354): the nodes run only under a
    # serve manager, ``serve.InferenceManager(ff, ...)``, which gives each
    # step its batch config and caches; under ``compile``/``fit`` they
    # raise, as the reference's lowering does
    def _serve_attention(self, cls, x, embed_dim, num_q_heads, num_kv_heads,
                         head_dim, rotary_embedding, rope_theta, use_bias,
                         scaling_factor, use_alibi, name):
        op = cls(embed_dim, num_q_heads, num_kv_heads, head_dim,
                 rotary_embedding, rope_theta, use_bias, scaling_factor,
                 use_alibi, dtype=x.dtype, device="meta")
        return self._add(op, [x], name)[0]

    def inc_multihead_self_attention(self, x, embed_dim, num_q_heads,
                                     num_kv_heads=None, head_dim=None,
                                     rotary_embedding=True,
                                     rope_theta=10000.0, use_bias=False,
                                     scaling_factor=None, use_alibi=False,
                                     name=None):
        from .serve.ops import IncMultiHeadSelfAttention

        return self._serve_attention(
            IncMultiHeadSelfAttention, x, embed_dim, num_q_heads,
            num_kv_heads, head_dim, rotary_embedding, rope_theta, use_bias,
            scaling_factor, use_alibi, name or "inc_mha")

    def position_embedding(self, x, num_positions, offset=0, name=None):
        op = PositionEmbedding(num_positions, x.shape[-1], offset, x.dtype,
                               device="meta")
        return self._add(op, [x], name or "position_embedding")[0]

    def spec_inc_multihead_self_attention(self, x, embed_dim, num_q_heads,
                                          num_kv_heads=None, head_dim=None,
                                          rotary_embedding=True,
                                          rope_theta=10000.0, use_bias=False,
                                          scaling_factor=None, name=None):
        from .serve.ops import SpecIncMultiHeadSelfAttention

        return self._serve_attention(
            SpecIncMultiHeadSelfAttention, x, embed_dim, num_q_heads,
            num_kv_heads, head_dim, rotary_embedding, rope_theta, use_bias,
            scaling_factor, False, name or "spec_inc_mha")

    def tree_inc_multihead_self_attention(self, x, embed_dim, num_q_heads,
                                          num_kv_heads=None, head_dim=None,
                                          rotary_embedding=True,
                                          rope_theta=10000.0, use_bias=False,
                                          scaling_factor=None, name=None):
        from .serve.ops import TreeIncMultiHeadSelfAttention

        return self._serve_attention(
            TreeIncMultiHeadSelfAttention, x, embed_dim, num_q_heads,
            num_kv_heads, head_dim, rotary_embedding, rope_theta, use_bias,
            scaling_factor, False, name or "tree_inc_mha")

    # attention (training)
    def multihead_attention(self, query, key, value, embed_dim, num_heads,
                            kdim=None, vdim=None, dropout=0.0, use_bias=True,
                            causal=False, name=None):
        op = MultiHeadAttention(embed_dim, num_heads, kdim, vdim, dropout,
                                use_bias, causal, dtype=query.dtype,
                                device="meta")
        return self._add(op, [query, key, value],
                         name or "multihead_attention")[0]

    # conv nets (NCHW)
    def conv2d(self, x, out_channels, kernel=(3, 3), stride=(1, 1),
               padding="SAME", activation=None, use_bias=True, groups=1,
               name=None):
        op = Conv2D(out_channels, kernel, stride, padding, activation,
                    use_bias, groups, in_channels=x.shape[1],
                    dtype=x.dtype, device="meta")
        return self._add(op, [x], name or "conv2d")[0]

    def pool2d(self, x, kernel=(2, 2), stride=(2, 2), padding="VALID",
               pool_type="max", name=None):
        op = Pool2D(kernel, stride, padding, pool_type)
        return self._add(op, [x], name or "pool2d")[0]

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def _training_mesh(self):
        """The mesh training runs on: ``mesh``, else ``mesh_shape`` (or
        ``{"dp": n}``) over ``FFConfig.devices()``, else the one device
        given."""
        shape = (dict(self.mesh.shape) if self.mesh is not None
                 else dict(self.config.mesh_shape or {}))
        if self.mesh is None and self._device_given:
            if math.prod(shape.values()) > 1:
                raise ValueError(
                    f"mesh_shape {shape} spans several devices and "
                    f"device={str(self.device)!r} names one: pass "
                    "mesh=make_mesh(shape, devices) to place the shards")
            self.mesh = make_mesh(shape or {"dp": 1}, [self.device])
        elif self.mesh is None:
            devices = self.config.devices()
            self.mesh = make_mesh(shape or {"dp": len(devices)}, devices)
        self.device = self.mesh.devices[0]
        return self.mesh

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type=loss_mod.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[str] = (),
                strategy: Optional[Dict[str, Dict]] = None,
                mode: str = "spmd",
                outputs: Optional[Sequence[Tensor]] = None,
                loss_weights: Optional[Sequence[float]] = None):
        """Plan the graph under a strategy, build its forward, draw the
        parameters and the optimizer state.

        Strategy resolution (the reference's order): the explicit
        ``strategy``, then the ``--import`` file, then the joint Unity
        search when ``search_budget > 0`` (not with
        ``only_data_parallel``; the model adopts the rewritten graph),
        then the data-parallel strategy; ``--export`` writes the result.
        ``mode`` ("spmd" or "local") is the reference's lowering mode;
        both run the shard-local executor here.

        Multi-output training: pass N ``outputs`` and ``loss_type`` as a
        list of N loss names; ``fit``/``evaluate`` then take ``y`` as a
        list of N label arrays and the step loss is the (optionally
        ``loss_weights``-ed) sum of the per-output losses.  Metrics are
        computed on output 0.
        """
        cfg = self.config
        mesh = self._training_mesh()
        out_tids = [t.tid for t in outputs] if outputs else None
        if strategy is None and cfg.import_strategy_file:
            strategy = load_strategy(cfg.import_strategy_file)
        # a pp axis makes compile consult the pipeline search (reference
        # :413-428); when the pipeline wins, training runs the GPipe
        # executor
        self._pipeline_ctx = self._pipeline = self._pp_meta = None
        self.pipeline_choice = None
        if (strategy is None and not cfg.only_data_parallel
                and cfg.pipeline != "off" and mesh.shape.get("pp", 1) > 1):
            strategy = self._consult_pipeline(cfg, mesh)
        if (strategy is None and cfg.search_budget > 0
                and not cfg.only_data_parallel):
            strategy, out_tids = self._search(mesh, out_tids)
        if strategy is None:
            strategy = data_parallel_strategy(self.graph, mesh)
        if cfg.export_strategy_file:
            save_strategy(cfg.export_strategy_file, strategy)
        self.strategy = strategy
        self._compiled_out_tids = out_tids
        self.pcg = PCG(self.graph, mesh, strategy, output_tids=out_tids)
        self.plan = self.pcg.plan()
        generator = torch.Generator().manual_seed(self._draw_seed())

        self.optimizer = optimizer or SGDOptimizer(lr=cfg.learning_rate)
        self.loss_type = loss_type
        self.loss_weights = list(loss_weights) if loss_weights else None
        if self.loss_weights is not None:
            if not isinstance(loss_type, (list, tuple)):
                raise ValueError("loss_weights requires loss_type to be a "
                                 "list of per-output losses")
            if len(self.loss_weights) != len(loss_type):
                raise ValueError(f"{len(self.loss_weights)} loss_weights "
                                 f"for {len(loss_type)} losses")
        self.metric_names = list(metrics)
        if self._pipeline_ctx is not None:
            self._setup_pipeline_training(cfg, mesh, generator)
        else:
            self._forward = build_forward(self.plan, mode)
            self.shard_params = init_params(self.graph, self.plan, generator)
        # each shard's slots over its own blocks, on its device (the
        # reference places the slots with the parameters, :536-553)
        self.shard_opt_states = [self.optimizer.init_state(self._trainable(r))
                                 for r in range(mesh.size)]
        return self

    def _search(self, mesh, out_tids):
        """The joint Unity search (reference :429-444): graph rewrites and
        parallel configs in one walk of ``search_budget`` proposals; the
        model adopts the rewritten graph (its parameters are drawn after,
        so nothing migrates), ``layers`` holds exactly its nodes' modules,
        and the outputs follow ``tid_map``.  Returns the strategy and the
        output tids.

        Not at parity with the reference without ``outputs``: the port
        keeps the graph's own outputs (the tensors no node reads) and
        protects them all from the rewrites, where the reference protects
        only the last node's last output and then takes the rewritten
        graph's default outputs, which after a fused residual norm are
        its unread sum (the reference's ``fit`` then raises).  With
        ``outputs`` the two agree."""
        from .search.search import graph_optimize

        cfg = self.config
        if not out_tids:
            read = {t for n in self.graph.nodes for t in n.inputs}
            out_tids = [t for n in self.graph.nodes for t in n.outputs
                        if t not in read]
        graph, strategy, tid_map = graph_optimize(
            self.graph, mesh, budget=cfg.search_budget,
            alpha=cfg.search_alpha, substitution=True, output_tids=out_tids)
        self.graph = graph
        self.layers = NodeModules({n.name: n.op for n in graph.nodes})
        return strategy, [tid_map[t] for t in out_tids]

    # ------------------------------------------------------------------
    # the compile path's pipeline (reference :561-944)
    # ------------------------------------------------------------------
    def _consult_pipeline(self, cfg, mesh):
        """Pipeline or GSPMD on a mesh with a ``pp`` axis (reference
        :561-622).  Under ``pipeline="auto"`` ``pipeline_or_gspmd`` prices
        both plans (``pipeline_choice`` keeps the kind and both prices);
        under ``"force"`` ``propose_pipeline`` partitions the chain.  When
        the pipeline wins and the graph carves into stages, sets
        ``_pipeline_ctx`` and returns the inner (non-pp) strategy; else
        the GSPMD strategy, or None (the documented resolution goes on:
        the search if budgeted, else data parallel)."""
        import warnings

        from .search.pipeline_search import (pipeline_or_gspmd,
                                             propose_pipeline)

        budget = cfg.search_budget or 120
        # the GPipe executor drives a chain of single-entry single-exit
        # segments: other graphs skip the pipeline machinery
        segments, chain_err = self._pipeline_segments()
        if chain_err is not None:
            if cfg.pipeline == "force":
                warnings.warn(
                    f"pipeline=force but the graph can't drive the GPipe "
                    f"executor ({chain_err}); falling back to GSPMD",
                    stacklevel=3)
            return None
        # segments are atomic units of the partition: a residual block is
        # never split over stages
        groups = {n.name: gi for gi, (nodes, _, _) in enumerate(segments)
                  for n in nodes}
        costs: Dict[str, float] = {}
        if cfg.pipeline == "force":
            stage_of, costs["pipeline"] = propose_pipeline(
                self.graph, mesh, "pp", n_micro=cfg.pipeline_microbatches,
                strategy={}, groups=groups)
            kind, strategy = "pipeline", {}
        else:
            kind, strategy, stage_of, _ = pipeline_or_gspmd(
                self.graph, mesh, "pp", n_micro=cfg.pipeline_microbatches,
                budget=budget, seed=cfg.seed, training=True, groups=groups,
                candidates=costs)
        self.pipeline_choice = {"kind": kind, "costs": costs}
        if kind != "pipeline":
            # with a search budget the joint search explores strictly
            # more than the consult's GSPMD candidate
            return None if cfg.search_budget > 0 else strategy
        try:
            carve = self._carve_pipeline_stages(stage_of, mesh, cfg)
        except ValueError as e:
            warnings.warn(
                f"pipeline won the cost comparison but the graph can't "
                f"drive the GPipe executor ({e}); falling back to GSPMD",
                stacklevel=3)
            return None
        self._pipeline_ctx = (strategy, carve)
        return strategy

    def _pipeline_segments(self):
        """The graph as a chain of single-entry single-exit segments
        (reference :624-671): walking the nodes in order, a boundary where
        exactly one tensor is live (``core/graph.py:live_cuts``) is a cut
        all dataflow passes through, and the nodes between two cuts are a
        segment, whatever their inner wiring (a transformer block with its
        residual adds is one).  Returns ``(segments, None)``, each
        ``(nodes, entry_tid, exit_tid)`` with ``exit[i] == entry[i+1]``,
        or ``(None, reason)``."""
        g = self.graph
        if len(g.input_tids) != 1:
            return None, "graph has multiple inputs"
        nodes = g.nodes
        if not nodes:
            return None, "empty graph"
        final_tid = nodes[-1].outputs[-1]
        lives = live_cuts(g, [final_tid])
        segments, cur = [], []
        entry = g.input_tids[0]
        for i, node in enumerate(nodes):
            cur.append(node)
            live = lives[i]
            if i == len(nodes) - 1:
                if set(live) != {final_tid}:
                    return None, (
                        "graph's final live set is not the single protected "
                        f"output ({len(live)} tensors live at the end)")
                segments.append((cur, entry, final_tid))
            elif len(live) == 1:
                exit_tid = next(iter(live))
                segments.append((cur, entry, exit_tid))
                cur = []
                entry = exit_tid
        return segments, None

    def _carve_pipeline_stages(self, stage_of, mesh, cfg):
        """Split the segment chain into a prefix, K isomorphic core stages
        and a suffix (reference :673-769); raises ``ValueError`` where the
        structure or the batch cannot drive the executor.  Two stage
        chunks match when their ops' ``attr_signature()``, their
        parameters and their wiring (each input as the chunk's entry or
        a (producer index, output index)) are equal."""
        k = mesh.shape["pp"]
        segments, err = self._pipeline_segments()
        if err is not None:
            raise ValueError(err)
        seg_stage = []
        for nodes, _, _ in segments:
            stgs = {stage_of.get(n.name) for n in nodes}
            if None in stgs:
                raise ValueError(f"no stage for {nodes[0].name}")
            if len(stgs) != 1:
                raise ValueError(f"stage partition splits the segment at "
                                 f"{nodes[0].name}")
            seg_stage.append(stgs.pop())
        if seg_stage != sorted(seg_stage):
            raise ValueError("stage assignment not contiguous on the chain")
        stages = [[] for _ in range(k)]
        for seg, st in zip(segments, seg_stage):
            if not 0 <= st < k:
                raise ValueError(f"stage {st} outside the pp axis ({k})")
            stages[st].append(seg)
        if any(not st for st in stages):
            raise ValueError("partition uses fewer stages than the pp axis")

        def flat_nodes(segs):
            return [n for nodes, _, _ in segs for n in nodes]

        def sig_of(segs):
            index = {segs[0][1]: ("entry",)}
            sig = []
            for j, node in enumerate(flat_nodes(segs)):
                wires = tuple(index.get(t, ("external",))
                              for t in node.inputs)
                sig.append((node.op.attr_signature(), tuple(sorted(
                    (p.name, tuple(p.spec.shape), str(p.spec.dtype))
                    for p in node.op.params())), wires))
                for oi, t in enumerate(node.outputs):
                    index[t] = (j, oi)
            return tuple(sig), index.get(segs[-1][2], ("external",))

        carved = None
        for cut0 in range(len(stages[0])):
            unit = stages[0][cut0:]
            sig_u = sig_of(unit)
            mid_ok = all(sig_of(stages[st]) == sig_u for st in range(1, k - 1))
            last_ok = (len(stages[-1]) >= len(unit)
                       and sig_of(stages[-1][:len(unit)]) == sig_u)
            if mid_ok and last_ok:
                core = ([flat_nodes(unit)]
                        + [flat_nodes(stages[st]) for st in range(1, k - 1)]
                        + [flat_nodes(stages[-1][:len(unit)])])
                carved = (stages[0][:cut0], unit, stages[-1][len(unit):],
                          core)
                break
        if carved is None:
            raise ValueError("stages are not isomorphic after carving")
        prefix_segs, unit, suffix_segs, core = carved
        n_micro = cfg.pipeline_microbatches
        dp = mesh.shape.get("dp", 1)
        if cfg.batch_size % n_micro or (cfg.batch_size // n_micro) % dp:
            raise ValueError(f"batch {cfg.batch_size} not divisible into "
                             f"{n_micro} microbatches over dp={dp}")
        last_unit = stages[-1][:len(unit)]
        return {
            "prefix": flat_nodes(prefix_segs), "core": core,
            "suffix": flat_nodes(suffix_segs), "n_micro": n_micro, "k": k,
            # the replay's wiring (the template's tensor ids)
            "core_entry": unit[0][1], "core_exit": unit[-1][2],
            "prefix_entry": self.graph.input_tids[0],
            "prefix_exit": unit[0][1],
            # the suffix runs with the last stage's own tensor ids
            "suffix_entry": last_unit[-1][2],
            "suffix_exit": segments[-1][2],
        }

    def _setup_pipeline_training(self, cfg, mesh, generator):
        """Train through the GPipe executor (reference :771-944): draw the
        parameters as the whole draw draws them (``draw_params``, so a
        seed gives the unpipelined model's weights), each core node's onto
        its stage's shards as that stage's ``[1, ...]`` block of
        ``_pp_core``, the prefix and suffix onto every shard; build the
        train and eval steps (``parallel/pipeline.py:PipelineStep``, the
        stage replaying its unit's nodes with its parameters) and the
        forward.  A list of losses raises ``ValueError``."""
        if isinstance(self.loss_type, (list, tuple)):
            raise ValueError(
                "multi-output (list) losses are not supported with pipeline "
                "parallelism — use a single loss or pipeline='off'")
        carve = self._pipeline_ctx[1]
        core, prefix, suffix = carve["core"], carve["prefix"], carve["suffix"]
        self._pp_meta = dict(
            core_names=[[n.name for n in st] for st in core],
            pnames=[[p.name for p in n.op.params()] for n in core[0]],
            prefix=[n.name for n in prefix],
            suffix=[n.name for n in suffix])
        dp_axis = "dp" if mesh.shape.get("dp", 1) > 1 else None
        act_dtype = self.graph.spec(carve["core_exit"]).dtype

        def pl_loss(y, lab):
            # microbatched [n_micro, mb, ...] -> the flat batch
            return loss_mod.compute_loss(
                self.loss_type, y.reshape((-1,) + y.shape[2:]),
                lab.reshape((-1,) + lab.shape[2:]))

        steps = {}
        for training in (True, False):
            steps[training] = PipelineStep(
                _replay(core[0], carve["core_entry"], carve["core_exit"],
                        training),
                pl_loss, mesh, "pp", dp_axis,
                _replay(prefix, carve["prefix_entry"], carve["prefix_exit"],
                        training) if prefix else None,
                _replay(suffix, carve["suffix_entry"], carve["suffix_exit"],
                        training) if suffix else None,
                act_dtype=act_dtype)
        self._pipeline = _Pipeline(self, carve, steps)
        stage = steps[True].stage_of
        shards: List[Dict[str, Dict[str, nn.Parameter]]] = [
            {} for _ in mesh.devices]
        for node, p, value in draw_params(self.graph, generator):
            pos = self._pipeline.core_pos.get(node.name)
            for r, dev in enumerate(mesh.devices):
                if pos is None:
                    shards[r].setdefault(node.name, {})[p.name] = \
                        nn.Parameter(value.to(dev, copy=True),
                                     requires_grad=p.trainable)
                elif stage[r] == pos[0]:
                    shards[r].setdefault("_pp_core", {})[
                        f"{pos[1]}.{p.name}"] = nn.Parameter(
                            value[None].to(dev, copy=True),
                            requires_grad=p.trainable)
        self.shard_params = shards
        self._forward = self._pipeline.forward

    def recompile(self, strategy: Optional[Dict[str, Dict]] = None,
                  optimizer: Optional[Optimizer] = None, mode: str = "spmd",
                  outputs: Optional[Sequence[Tensor]] = None) -> "FFModel":
        """Re-plan the same graph under a new strategy (and optionally a
        new optimizer), keeping the trained parameters: each is taken
        whole from the old layout and sliced into the new one; the
        optimizer state moves the same way when the optimizer is
        unchanged and resets otherwise (reference :946-994)."""
        old_params = self.params
        old_opt = self.opt_state if optimizer is None else None
        if strategy is None:
            strategy = self.strategy
        if outputs is None and self._compiled_out_tids:
            outputs = [Tensor(self.graph, t) for t in self._compiled_out_tids]
        self.compile(optimizer=optimizer or self.optimizer,
                     loss_type=self.loss_type, metrics=self.metric_names,
                     strategy=strategy, mode=mode, outputs=outputs,
                     loss_weights=self.loss_weights)
        if old_params is not None:
            self.load_params(old_params)
        if old_opt is not None:
            self.load_opt_state(old_opt)
        return self

    # ------------------------------------------------------------------
    # the global view of the shards' state
    # ------------------------------------------------------------------
    def _whole(self, name: str, pname: str, parts: List[torch.Tensor]
               ) -> torch.Tensor:
        if self._pipeline is not None:
            return self._pipeline.whole(name, parts)
        return plan_shards(self.plan).plan.whole(f"{name}.{pname}", parts)

    def _local(self, name: str, pname: str, value: torch.Tensor,
               rank: int) -> torch.Tensor:
        if self._pipeline is not None:
            return self._pipeline.local(name, value, rank)
        return plan_shards(self.plan).plan.local(f"{name}.{pname}", value,
                                                 rank)

    def _place(self, inputs) -> Dict[int, List[torch.Tensor]]:
        """A host batch as each shard's blocks: the plan's
        (``place_inputs``), or the pipeline's microbatches."""
        if self._pipeline is not None:
            return self._pipeline.place(inputs)
        return place_inputs(self.plan, inputs)

    @property
    def params(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """``{node name: {param name: global value}}`` (reference
        ``model.params``): on one device the parameters themselves, on a
        mesh each assembled from the shards' blocks on shard 0's device;
        a pipelined model's core under ``"_pp_core"``, ``{"{j}.{param}":
        [K, ...]}``."""
        shards = self.shard_params
        if shards is None or len(shards) == 1:
            return None if shards is None else shards[0]
        return {n: {p: self._whole(n, p, [s[n][p].detach() for s in shards])
                    for p in g} for n, g in shards[0].items()}

    @property
    def opt_state(self):
        """The optimizer state as the reference holds it (its slots
        global, as :attr:`params`); on one device the state itself."""
        states = self.shard_opt_states
        if states is None or len(states) == 1:
            return None if states is None else states[0]
        return self._gather_state(states)

    def _gather_state(self, states: list):
        s0 = states[0]
        if _is_param_tree(s0):
            return {n: {p: self._whole(n, p, [s[n][p] for s in states])
                        for p in g} for n, g in s0.items()}
        if isinstance(s0, dict):
            return {k: self._gather_state([s[k] for s in states])
                    for k in s0}
        return s0   # a scalar every shard keeps alike (Adam's step)

    def load_params(self, weights) -> "FFModel":
        """Copy ``{node name: {param name: array}}`` (numpy arrays, as the
        JAX package's ``model.params`` give after ``np.asarray``, or
        tensors; global values) into every shard's blocks, cast to their
        dtype, in place.  A pipelined model takes its own layout
        (``"_pp_core"``) and a core node's own name alike."""
        if self.shard_params is None:
            raise RuntimeError("call compile() before load_params()")
        specs = self.graph.param_specs()
        pl = self._pipeline
        with torch.no_grad():
            for name, group in weights.items():
                pos = None if pl is None else pl.core_pos.get(name)
                if pos is None and name not in self.shard_params[0]:
                    raise KeyError(f"unknown param group {name!r}")
                for p, v in group.items():
                    arr = _as_tensor(v)
                    shape = (pl.core_shape(p, specs) if name == "_pp_core"
                             else tuple(specs[name][p].spec.shape))
                    if tuple(arr.shape) != shape:
                        raise ValueError(f"{name}.{p}: shape "
                                         f"{tuple(arr.shape)} != {shape}")
                    for r, shard in enumerate(self.shard_params):
                        if pos is None:
                            cur = shard[name][p]
                            val = self._local(name, p, arr, r)
                        elif pl.stage_of[r] == pos[0]:
                            cur = shard["_pp_core"][f"{pos[1]}.{p}"]
                            val = arr[None]
                        else:
                            continue
                        cur.copy_(val.to(cur.dtype))
        return self

    def load_opt_state(self, state) -> "FFModel":
        """Copy a global optimizer state (as :attr:`opt_state` gives it)
        into every shard's, in place: each slot sliced to the shard's
        blocks, each scalar onto every shard."""
        if self.shard_opt_states is None:
            raise RuntimeError("call compile() before load_opt_state()")
        self.shard_opt_states = self._scatter_state(self.shard_opt_states,
                                                    state)
        return self

    def _scatter_state(self, states: list, src) -> list:
        s0 = states[0]
        if _is_param_tree(s0):
            with torch.no_grad():
                for n, g in s0.items():
                    for p in g:
                        arr = _as_tensor(src[n][p])
                        for r, s in enumerate(states):
                            s[n][p].copy_(self._local(n, p, arr, r))
            return states
        if isinstance(s0, dict):
            for k in s0:
                for s, v in zip(states, self._scatter_state(
                        [s[k] for s in states], src[k])):
                    s[k] = v
            return states
        if isinstance(s0, tuple):
            return states
        return [type(s0)(src) for _ in states]

    def _draw_seed(self) -> int:
        return int(torch.randint(2 ** 62, (), generator=self._generator))

    def _trainable(self, rank: int = 0
                   ) -> Dict[str, Dict[str, nn.Parameter]]:
        out = {}
        for name, group in self.shard_params[rank].items():
            kept = {p: w for p, w in group.items() if w.requires_grad}
            if kept:
                out[name] = kept
        return out

    # ------------------------------------------------------------------
    # the steps
    # ------------------------------------------------------------------
    def _total_loss(self, outs, labels) -> torch.Tensor:
        lt = self.loss_type
        if not isinstance(lt, (list, tuple)):
            return loss_mod.compute_loss(lt, outs[0], labels)
        labs = labels if isinstance(labels, (list, tuple)) else [labels]
        if len(labs) != len(lt) or len(outs) < len(lt):
            raise ValueError(
                f"multi-output loss: {len(lt)} losses need as many outputs "
                f"({len(outs)}) and label arrays ({len(labs)})")
        w = self.loss_weights or [1.0] * len(lt)
        return sum(wi * loss_mod.compute_loss(t, o, l)
                   for wi, t, o, l in zip(w, lt, outs, labs))

    def _metrics(self, logits, labels):
        first = labels[0] if isinstance(labels, (list, tuple)) else labels
        with torch.no_grad():
            return metrics_mod.compute_metrics(self.metric_names,
                                               logits.detach(), first)

    def _train_step(self, batch, labels, seed: int):
        """Forward on every shard, the loss and metrics on shard 0,
        backward, the gradient sum over replicas and each shard's
        update; returns the loss and the metrics of output 0, on shard
        0's device.  A pipelined model runs its GPipe step
        (``parallel/pipeline.py:PipelineStep.run``: the loss on the last
        stage, the gradients summed there)."""
        params = [self._trainable(r) for r in range(self.mesh.size)]
        if self._pipeline is not None:
            loss, logits = self._pipeline.train_step(batch, labels)
            mets = self._metrics(logits, labels)
        else:
            outs = self._forward(batch, training=True, seed=seed)
            loss = self._total_loss(outs, labels)
            mets = self._metrics(outs[0], labels)
            loss.backward()
            self._sum_grads(params)
        for p_r, state in zip(params, self.shard_opt_states):
            grads = {n: {p: (w.grad if w.grad is not None
                             else torch.zeros_like(w)) for p, w in g.items()}
                     for n, g in p_r.items()}
            self.optimizer.update(grads, state, p_r)
        for p_r in params:
            for g in p_r.values():
                for w in g.values():
                    w.grad = None
        return loss.detach(), mets

    def _sum_grads(self, params: list) -> None:
        """Sum each parameter block's gradient over the mesh axes its
        sharding leaves unused, in place on every replica (a replica
        whose ``.grad`` is None adds zeros): one all-reduce a group of
        replicas for all the blocks that share those axes and a dtype,
        flattened into one buffer."""
        if len(params) == 1:
            return
        sp = plan_shards(self.plan).plan
        buckets: Dict[tuple, list] = {}
        for name, group in params[0].items():
            for p, w in group.items():
                axes = sp.unused_axes(f"{name}.{p}")
                if axes:
                    buckets.setdefault((axes, w.dtype), []).append((name, p))
        comm = self.mesh.comm
        for (axes, _), keys in buckets.items():
            for ranks in comm.groups(axes):
                flats = []
                for r in ranks:
                    ws = [params[r][n][p] for n, p in keys]
                    flats.append(torch.cat([
                        (w.grad if w.grad is not None
                         else torch.zeros_like(w)).reshape(-1) for w in ws]))
                summed = comm.all_reduce(flats, ranks)
                self.grad_allreduces += 1
                for r, flat in zip(ranks, summed):
                    off = 0
                    for n, p in keys:
                        w = params[r][n][p]
                        w.grad = flat[off: off + w.numel()].view_as(w)
                        off += w.numel()

    def _eval_step(self, batch, labels):
        with torch.no_grad():
            outs = self._forward(batch, training=False)
            return self._total_loss(outs, labels), self._metrics(
                outs[0], labels)

    # ------------------------------------------------------------------
    # train / eval loops
    # ------------------------------------------------------------------
    def _standardize_inputs(self, x) -> Dict[int, np.ndarray]:
        tids = self.graph.input_tids
        if isinstance(x, dict):
            return {t.tid if isinstance(t, Tensor) else t: v
                    for t, v in x.items()}
        if isinstance(x, (list, tuple)):
            return {tid: v for tid, v in zip(tids, x)}
        return {tids[0]: x}

    def _labels(self, y, sel):
        """The labels of rows ``sel`` on shard 0's device (a tuple of them
        for per-output losses)."""
        if isinstance(self.loss_type, (list, tuple)):
            return tuple(host_to_device(v[sel], self.device) for v in y)
        return host_to_device(y[sel], self.device)

    def _host_labels(self, y):
        """The labels as host arrays (a list of them for per-output
        losses) and the number of samples."""
        multi = isinstance(self.loss_type, (list, tuple))
        y = [np.asarray(v) for v in y] if multi else np.asarray(y)
        return y, (len(y[0]) if multi else len(y))

    def fit(self, x, y=None, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, verbose: bool = True,
            shuffle: bool = True):
        """Train on host arrays ``x``, ``y`` (the batches drawn and
        placed here), or on a :class:`~.data.DataLoader` ``x`` (its
        batches; ``y`` unused)."""
        if self._forward is None:
            raise RuntimeError("call compile() first")
        t0 = time.perf_counter()
        with maybe_profile(self.config.profiling):
            history = self._fit(x, y, epochs, batch_size, verbose, shuffle)
        log_run("fit", {
            "ops": len(self.graph.nodes),
            "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
            "strategy_ops": len(self.strategy or {}),
            "epochs": len(history),
            "final": history[-1] if history else None,
            "seconds": round(time.perf_counter() - t0, 3),
        })
        return history

    def _fit(self, x, y, epochs, batch_size, verbose, shuffle):
        epochs = epochs or self.config.epochs
        if isinstance(x, DataLoader):
            return self._fit_loader(x, epochs, verbose)
        bs = batch_size or self.config.batch_size
        inputs = self._standardize_inputs(x)
        y, n = self._host_labels(y)
        history = []
        for epoch in range(epochs):
            # the epoch's step seeds and order, from the model's own
            # generator (not global state): training is reproducible
            seeds = torch.Generator().manual_seed(self._draw_seed())
            idx = (torch.randperm(n, generator=self._generator).numpy()
                   if shuffle else np.arange(n))

            def batches():
                for start in range(0, n - bs + 1, bs):
                    sel = idx[start: start + bs]
                    batch = self._place({t: v[sel]
                                         for t, v in inputs.items()})
                    yield batch, self._labels(y, sel)

            history.append(self._train_epoch(batches(), seeds, epoch,
                                             epochs, verbose, bs))
        return history

    def _fit_loader(self, loader, epochs, verbose):
        """The epoch loop over a :class:`~.data.DataLoader` (reference
        :1097-1118): the loader owns the batching and, given this
        model's plan, the placement (its prefetch overlaps the copies
        with the steps).  Its ``{key: array}`` inputs map onto the graph's
        input tids by position, or directly when the keys are tids."""
        if loader.plan is not None and (loader.plan is not self.plan
                                        or self._pipeline is not None):
            raise ValueError("the DataLoader places its batches for another "
                             "plan: build it with plan=model.plan (or none;"
                             " none for a pipelined model)")
        tids = self.graph.input_tids
        history = []
        for epoch in range(epochs):
            seeds = torch.Generator().manual_seed(self._draw_seed())

            def batches():
                for arrs, labels in loader:
                    keys = list(arrs)
                    batch = ({t: arrs[k] for t, k in zip(tids, keys)}
                             if set(keys) != set(tids) else arrs)
                    if loader.plan is None:   # host tensors: place them
                        batch = self._place(batch)
                        labels = host_to_device(labels, self.device)
                    yield batch, labels

            history.append(self._train_epoch(batches(), seeds, epoch,
                                             epochs, verbose,
                                             loader.batch_size))
        return history

    def _train_epoch(self, batch_iter, seeds, epoch, epochs, verbose, bs):
        """One epoch over ``(batch, labels)`` pairs, each step's seed drawn
        from ``seeds``; the history entry."""
        losses, mets_acc = [], []
        t0 = time.perf_counter()
        for batch, labels in batch_iter:
            seed = int(torch.randint(2 ** 62, (), generator=seeds))
            loss, mets = self._train_step(batch, labels, seed)
            losses.append(loss)
            mets_acc.append(mets)
        if not losses:
            raise ValueError("no full batches to train on — dataset "
                             "smaller than the batch size?")
        mean_loss = _mean(losses)      # the epoch's one host wait
        dt = time.perf_counter() - t0
        mean_mets = {k: _mean([m[k] for m in mets_acc])
                     for k in mets_acc[0]}
        if verbose:
            steps = len(losses)
            print(
                f"epoch {epoch + 1}/{epochs}: loss={mean_loss:.4f} "
                + " ".join(f"{k}={v:.4f}" for k, v in mean_mets.items())
                + f" ({steps / dt:.1f} it/s, {steps * bs / dt:.0f} "
                "samples/s)")
        return {"loss": mean_loss, **mean_mets}

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        if self._forward is None:
            raise RuntimeError("call compile() first")
        bs = batch_size or self.config.batch_size
        inputs = self._standardize_inputs(x)
        y, n = self._host_labels(y)
        losses, mets_acc = [], []
        for start in range(0, n - bs + 1, bs):
            sel = slice(start, start + bs)
            batch = self._place({t: v[sel] for t, v in inputs.items()})
            loss, mets = self._eval_step(batch, self._labels(y, sel))
            losses.append(loss)
            mets_acc.append(mets)
        out = {"loss": _mean(losses)}
        for k in self.metric_names:
            out[k] = _mean([m[k] for m in mets_acc])
        return out

    def forward(self, x, training: bool = False):
        """Run the compiled forward on host arrays; the outputs stay on
        shard 0's device, whole."""
        if self._forward is None:
            raise RuntimeError("call compile() first")
        inputs = self._place(self._standardize_inputs(x))
        with torch.no_grad():
            outs = self._forward(inputs, training=training)
        return outs[0] if len(outs) == 1 else outs


def _is_param_tree(x) -> bool:
    """A ``{node: {param: tensor}}`` tree (an optimizer's slots)."""
    return bool(isinstance(x, dict) and x and all(
        isinstance(g, dict) and all(isinstance(v, torch.Tensor)
                                    for v in g.values())
        for g in x.values()))


def _as_tensor(v) -> torch.Tensor:
    return (v.detach() if isinstance(v, torch.Tensor)
            else torch.tensor(np.asarray(v)))


def _mean(values: List[torch.Tensor]) -> float:
    """The mean of 0-d device tensors, read in one host wait and summed
    in float64 (the reference's ``np.mean`` of Python floats)."""
    return float(np.mean(torch.stack(values).tolist() if values else []))


def _replay(nodes, entry_tid: int, exit_tid: int, training: bool):
    """``f(pgroups, x)``: a chunk of nodes replayed on ``x`` (its inner
    wiring, residual adds and fused norms included; reference :812-828),
    each node's module run with ``pgroups``' ``{param: tensor}`` in place
    of its own parameters (``torch.func.functional_call``), on one
    device; returns the chunk's exit tensor."""
    from torch.func import functional_call

    nodes = list(nodes)

    def f(pgroups, x):
        ctx = OpContext(training=training)
        env = {entry_tid: x}
        for node, pg in zip(nodes, pgroups):
            op = node.op
            xs = tuple(env[t] for t in node.inputs)
            kw = {"ctx": ctx} if op.uses_context else {}
            out = functional_call(op, pg, xs, kw) if pg else op(*xs, **kw)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = out
            else:
                env.update(zip(node.outputs, out))
        return env[exit_tid]

    return f


class _Pipeline:
    """A pipelined model's runtime: where its core nodes sit, its train
    and eval steps (``steps[training]``), the batch's placement and the
    layout of its state (``_pp_core`` blocks of ``[1, ...]`` on each
    stage's shards, prefix and suffix on every shard)."""

    def __init__(self, model: FFModel, carve: dict,
                 steps: Dict[bool, PipelineStep]):
        self.model, self.steps = model, steps
        self.mesh = model.mesh
        self.k, self.n_micro = carve["k"], carve["n_micro"]
        meta = model._pp_meta
        self.core_pos = {n: (s, j)
                         for s, names in enumerate(meta["core_names"])
                         for j, n in enumerate(names)}
        self.act_spec = model.graph.spec(carve["core_exit"])
        self.tid = model.graph.input_tids[0]
        st = steps[True]
        self.stage_of, self.dp_of, self.n_dp = st.stage_of, st.dp_of, st.n_dp
        self.stage_homes = [st.home[(s, 0)] for s in range(self.k)]

    def core_shape(self, key: str, specs) -> tuple:
        """The global shape of ``_pp_core``'s ``"{j}.{param}"``."""
        j, pname = key.split(".", 1)
        node = self.model._pp_meta["core_names"][0][int(j)]
        return (self.k,) + tuple(specs[node][pname].spec.shape)

    def whole(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        if name != "_pp_core":
            return parts[0]
        dev0 = self.mesh.devices[0]
        return torch.cat([parts[r].to(dev0) for r in self.stage_homes])

    def local(self, name: str, value: torch.Tensor, rank: int
              ) -> torch.Tensor:
        if name != "_pp_core":
            return value
        s = self.stage_of[rank]
        return value[s:s + 1]

    def trees(self) -> list:
        """Each shard's ``(core, prefix, suffix)`` parameter trees (the
        reference's ``to3``)."""
        meta = self.model._pp_meta
        out = []
        for shard in self.model.shard_params:
            pp = shard.get("_pp_core", {})
            out.append((
                [{p: pp[f"{j}.{p}"] for p in names}
                 for j, names in enumerate(meta["pnames"])],
                [shard.get(n, {}) for n in meta["prefix"]],
                [shard.get(n, {}) for n in meta["suffix"]]))
        return out

    def place(self, inputs) -> Dict[int, List[torch.Tensor]]:
        """The batch as ``[n_micro, mb / dp, ...]`` microbatch blocks, each
        shard's dp block on its device (the reference's ``P(None,
        "dp")``)."""
        x = torch.as_tensor(inputs[self.tid])
        b = x.shape[0]
        if b % (self.n_micro * self.n_dp):
            raise ValueError(f"batch {b} not divisible into {self.n_micro} "
                             f"microbatches over dp={self.n_dp}")
        xm = x.reshape((self.n_micro, b // self.n_micro) + tuple(x.shape[1:]))
        placed: Dict[tuple, torch.Tensor] = {}
        blocks = []
        for r, dev in enumerate(self.mesh.devices):
            key = (dev, self.dp_of[r])
            if key not in placed:
                placed[key] = host_to_device(
                    _dp_block(xm, self.dp_of[r], self.n_dp).contiguous(), dev)
            blocks.append(placed[key])
        return {self.tid: blocks}

    def _act_shape(self, xs) -> tuple:
        return (xs[0].shape[1],) + tuple(self.act_spec.shape[1:])

    def forward(self, batch, training: bool = False, seed=None, **_):
        """The pipelined forward: ``[logits]`` whole on shard 0."""
        xs = batch[self.tid]
        _, logits = self.steps[training].run(
            self.trees(), xs, act_shape=self._act_shape(xs))
        return [logits.reshape((-1,) + tuple(logits.shape[2:]))]

    def train_step(self, batch, labels: torch.Tensor):
        """One GPipe step (forward, backward, the gradient sums): the
        loss and the logits ``[batch, ...]``, on shard 0's device."""
        xs = batch[self.tid]
        lm = labels.reshape((self.n_micro, -1) + tuple(labels.shape[1:]))
        ls = [_dp_block(lm, self.dp_of[r], self.n_dp).to(dev)
              for r, dev in enumerate(self.mesh.devices)]
        loss, logits = self.steps[True].run(
            self.trees(), xs, ls, act_shape=self._act_shape(xs))
        return loss, logits.reshape((-1,) + tuple(logits.shape[2:]))
