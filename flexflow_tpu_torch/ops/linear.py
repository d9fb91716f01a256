"""Dense layer with optional bias and activation, and BatchMatmul.

Port of ``flexflow_tpu/ops/linear.py`` (``Linear`` :50-127,
``BatchMatmul`` :193-258) for the serve and the training paths; the
builder (``model.py:dense``) passes the initializers, and
``core/interpreter.py:init_params`` makes the weights trainable.
``kernel`` is ``[in, out]`` as in the reference, ``bias`` ``[out]``.  The
product stays a ``torch.matmul``, as the reference left it to XLA: for bf16
operands the GEMM accumulates in float32 and rounds its output once, which
is the reference's ``preferred_element_type=_acc_dtype(x.dtype)`` followed
by the cast back.  The reference adds the bias and applies the activation
to the f32 product and casts once; here the bias and the activation run in
f32 on the product as the GEMM returned it, so a bf16 layer with a bias or
an activation rounds once more than the reference (the product, before the
bias; float32 layers are the reference's arithmetic).  An activation is
any of ``ops/elementwise.py:UNARY_FNS`` (reference :27-48): ``"relu"``,
``"gelu"`` (the tanh approximation), ``"gelu_exact"`` (erf)...  An int8
``kernel``
(``serve/quant.py``) carries per-out-channel f32 scales in
``kernel_scale`` and is dequantized to x's dtype just before the product
(reference :110-118); the dequantized copy lives for that product only.
A floating kernel of another dtype than x (parameters loaded in another
dtype than the compute dtype, ``LLM.compile(dtype=...)``) is cast to x's
dtype at use, as the reference's product promotes it: a bf16 kernel
under f32 compute is an f32 product of the same values.

The op IR (reference :128-175, ``core/op.py``): ``parallel_dims``
``sample`` (the token rows), ``channel_out`` (column-parallel: the
kernel and bias split on their output dim, the output on its last dim)
and ``channel_in`` (row-parallel: the input and the kernel split on the
contracted dim, the output a partial sum), ``apply_config`` and
``flops`` (an LM head marked for gating, ``cost_logit_rows``, priced at
that many rows).  Under a plan (``parallel/tp.py``) a shard's layer holds
its slice of the kernel and bias and computes on its block of the input;
a partial output takes the bias on rank 0 only (``bias_once``, reference
``core/op.py:bias_once``), so the sum counts it once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import UNARY_FNS as ACTIVATIONS
from .elementwise import propagate


def dequant(w: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight times its per-out-channel scales, in ``dtype``
    (``flexflow_tpu/serve/quant.py:153``); any other weight cast to
    ``dtype`` (a no-op when it has it).  On a CUDA device the product is
    made for each use and dropped after it; on the CPU it is kept on the
    weight (:func:`_host_dequant`)."""
    if w.dtype != torch.int8:
        return w.to(dtype)
    if w.device.type == "cpu":
        return _host_dequant(w, scale, dtype)
    return (w * scale).to(dtype)   # int8 * f32 promotes to f32


def _host_dequant(w: torch.Tensor, scale, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The dequantized copy of a CPU int8 weight, made once and kept on
    the weight while neither it nor its scales change (their
    ``_version``), so a CPU serve does not rebuild every weight on every
    step; the values are the product's."""
    key = (w._version, scale.data_ptr(), scale._version, dtype)
    held = getattr(w, "_dequant", None)
    if held is None or held[0] != key:
        held = (key, (w * scale).to(dtype))
        w._dequant = held
    return held[1]


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor],
             activation: Optional[str] = None) -> torch.Tensor:
    """``activation(y + bias)`` computed in f32 and cast to y's dtype."""
    out = y.float()
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = ACTIVATIONS[activation](out)
    return out.to(y.dtype)


@register_op
class Linear(Op, nn.Module):
    type_name = "linear"
    # a partial output on a rank other than 0: no bias; the shards a
    # ``sample`` config splits the rows over (parallel/tp.py)
    skip_bias = False
    row_shards = 1
    # LM-head gating: set by serve.mark_gated_lm_head on the logits' Linear
    lm_head_gated = False
    cost_logit_rows: Optional[int] = None

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 use_bias: bool = False,
                 activation: Optional[str] = None,
                 kernel_initializer=None, bias_initializer=None):
        super().__init__()
        if activation is not None and activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.activation = activation
        self.compute_dtype = dtype
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel = nn.Parameter(
            torch.empty(in_dim, out_dim, dtype=dtype, device=device),
            requires_grad=False)
        # a layer without bias registers None, so ``bias`` is no field of
        # its ``vars()`` (the reference's signature has none)
        self.register_parameter("bias", nn.Parameter(
            torch.empty(out_dim, dtype=dtype, device=device),
            requires_grad=False) if use_bias else None)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ kernel``, the kernel dequantized to x's dtype."""
        return torch.matmul(x, dequant(
            self.kernel, getattr(self, "kernel_scale", None), x.dtype))

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The bias and activation on the product ``y``."""
        bias = None if self.skip_bias else self.bias
        if bias is None and self.activation is None:
            return y
        return add_bias(y, bias, self.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.finish(self.product(x))

    # ---- op IR (reference :70-175) --------------------------------------
    @property
    def in_dim(self) -> int:
        return self.kernel.shape[0]

    @property
    def out_dim(self) -> int:
        return self.kernel.shape[1]

    @property
    def use_bias(self) -> bool:
        return self.bias is not None

    def signature_attrs(self):
        # the reference's fields this layer keeps in its kernel's shape
        # and its bias; ``quantization`` None unless int8 marked it
        return {**super().signature_attrs(), "in_dim": self.in_dim,
                "out_dim": self.out_dim, "use_bias": self.use_bias,
                "quantization": getattr(self, "quantization", None)}

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        if self.in_dim != x.shape[-1]:
            raise ValueError(f"linear expects in_dim {self.in_dim}, got "
                             f"{x.shape[-1]}")
        return [TensorSpec(tuple(x.shape[:-1]) + (self.out_dim,),
                           self.compute_dtype)]

    def params(self):
        ps = [ParamSpec("kernel", TensorSpec((self.in_dim, self.out_dim),
                                             self.compute_dtype),
                        self.kernel_initializer)]
        if self.use_bias:
            ps.append(ParamSpec("bias", TensorSpec((self.out_dim,),
                                                   self.compute_dtype),
                                self.bias_initializer))
        return ps

    def parallel_dims(self, in_specs):
        return {"sample": in_specs[0].shape[0],
                "channel_out": self.out_dim,
                "channel_in": in_specs[0].shape[-1]}

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        sample = tuple(config.get("sample", ()))
        c_out = tuple(config.get("channel_out", ()))
        c_in = tuple(config.get("channel_in", ()))
        if c_in and self.activation is not None:
            raise ValueError("channel_in (row-parallel) sharding is "
                             "incompatible with a fused activation: the "
                             "output is a partial sum")
        x_sh = TensorSharding.replicated(x.ndim)
        if sample:
            x_sh = x_sh.with_dim(0, sample)
        if c_in:
            x_sh = x_sh.with_dim(x.ndim - 1, c_in)
        kernel_sh = TensorSharding.replicated(2)
        if c_in:
            kernel_sh = kernel_sh.with_dim(0, c_in)
        if c_out:
            kernel_sh = kernel_sh.with_dim(1, c_out)
        out_sh = TensorSharding.replicated(x.ndim)
        if sample:
            out_sh = out_sh.with_dim(0, sample)
        if c_out:
            out_sh = out_sh.with_dim(x.ndim - 1, c_out)
        if c_in:
            out_sh = out_sh.with_partial(c_in)
        params = {"kernel": kernel_sh}
        if self.use_bias:
            bias_sh = TensorSharding.replicated(1)
            if c_out:
                bias_sh = bias_sh.with_dim(0, c_out)
            params["bias"] = bias_sh
        return ShardingSolution(inputs=[x_sh], outputs=[out_sh],
                                params=params)

    def flops(self, in_specs):
        x = in_specs[0]
        batch = 1
        for d in x.shape[:-1]:
            batch *= d
        if self.cost_logit_rows is not None:
            # a gated LM head computes at most cost_logit_rows rows
            batch = min(batch, self.cost_logit_rows)
        return 2 * batch * x.shape[-1] * self.out_dim


@register_op
class BatchMatmul(Op, nn.Module):
    """Batched matmul: (..., m, k) x (..., k, n) -> (..., m, n), either
    operand optionally transposed in its last two dims."""

    type_name = "batch_matmul"

    def __init__(self, a_transposed: bool = False,
                 b_transposed: bool = False):
        super().__init__()
        self.a_transposed = a_transposed
        self.b_transposed = b_transposed

    def _dims(self, a: TensorSpec, b: TensorSpec):
        am, ak = ((a.shape[-1], a.shape[-2]) if self.a_transposed
                  else a.shape[-2:])
        bk, bn = ((b.shape[-1], b.shape[-2]) if self.b_transposed
                  else b.shape[-2:])
        if ak != bk:
            raise ValueError(f"batch_matmul contraction mismatch: {a} x {b}")
        return am, ak, bn

    def infer_shapes(self, in_specs):
        a, b = in_specs
        m, _, n = self._dims(a, b)
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return [TensorSpec(tuple(batch) + (m, n), a.dtype)]

    def forward(self, a, b):
        if self.a_transposed:
            a = a.transpose(-1, -2)
        if self.b_transposed:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        # the batch dims are the parallel dims: the producers' splits
        # propagate there, the contraction and row/col dims stay whole
        a, b = in_specs
        sample = tuple(config.get("sample", ()))

        def batch_only(sh):
            return TensorSharding(tuple(sh.dims[:-2])
                                  + (type(sh.dims[-2])(),) * 2, frozenset())

        a_sh = batch_only(propagate(in_shardings[0] if in_shardings
                                    else None, a))
        b_sh = batch_only(propagate(in_shardings[1] if in_shardings
                                    else None, b))
        if sample:
            a_sh = a_sh.with_dim(0, sample)
            b_sh = b_sh.with_dim(0, sample)
        out = self.infer_shapes([a, b])[0]
        out_sh = TensorSharding.replicated(out.ndim)
        for i in range(out.ndim - 2):
            if i < len(a_sh.dims) and a_sh.dims[i].axes:
                out_sh = out_sh.with_dim(i, a_sh.dims[i].axes)
        return ShardingSolution(inputs=[a_sh, b_sh], outputs=[out_sh])

    def flops(self, in_specs):
        a, b = in_specs
        m, k, n = self._dims(a, b)
        batch = 1
        for d in torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]):
            batch *= d
        return 2 * batch * m * k * n
