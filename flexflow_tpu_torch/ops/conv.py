"""Conv2D and Pool2D for the vision models (AlexNet, ResNet, Inception).

Port of ``flexflow_tpu/ops/conv.py`` (``Conv2D`` :34-121, ``Pool2D``
:124-175): NCHW activations and OIHW kernels, the reference's API.  The
reference lowers both through XLA (``jax.lax.conv_general_dilated`` :90,
``jax.lax.reduce_window`` :160-166), outside any Pallas kernel, so here
they are torch's own ``F.conv2d``, ``F.max_pool2d`` and ``F.avg_pool2d``,
as large products stay ``torch.matmul``.

Padding is XLA's: ``"VALID"`` none; ``"SAME"`` an output of
``ceil(in / stride)`` with the total pad ``max((out - 1) * stride + k -
in, 0)`` split ``total // 2`` low and the rest high, so a 3x3 stride-2
conv on an even input pads (0, 1) and ResNet's 7x7 stride-2 stem at 224
pads (2, 3) (``F.conv2d``'s own padding is symmetric, and its ``"same"``
refuses strides); an int pads every side alike; explicit ``((top,
bottom), (left, right))`` pairs pass through.  Every form is one
``F.pad`` before a convolution or pool at padding 0: with zeros for the
convolution and the average pool (which divides by ``kh * kw``, pads
included, :164-166), with ``-inf`` for the max pool (:160-162).

The kernel's gradient is one GEMM a group over the unfolded input
(:func:`weight_grad`, a ``torch.bmm``) in place of the library's: on the
H100, cuDNN's float32 weight gradient of a 3x3 stride-1 conv lands
1.5e-5 of its scale from float64 (TF32 off, ``cudnn.deterministic`` or
not), where the GEMM lands 4e-7 (``scripts/conv_precision.py``), past
the port's ``rtol 1e-4``, ``atol 1e-5`` parity with the CPU; the GEMM
is the slower of the two (ResNet-18 at 224, batch 32: 6.0 device ms a
step against 4.2).  The forward and the input's gradient stay
``F.conv2d``'s and its backward's.

The conv's bias and activation come after the product, in float32, cast
once to the compute dtype: float32 is the reference's arithmetic; a
bfloat16 conv rounds its product once before the bias, where the
reference accumulates in float32 (``preferred_element_type`` :97) and
rounds once at the end (as ``ops/linear.py:add_bias`` for a bf16 GEMM).
``in_channels`` is the input's, set by the builder (the reference sets it
in ``infer_shapes`` :58-59, before ``params``): the op's signature is the
reference's either way.

Sharding (reference :107-117, :168-175): ``sample`` splits dim 0 of the
input and the output; the kernel and bias are whole on every shard.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import as_dtype
from .linear import add_bias


def _pair(x) -> Tuple[int, int]:
    if isinstance(x, int):
        return (x, x)
    return tuple(x)


def _out_size(size: int, k: int, s: int, pad: str) -> int:
    if pad == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` pads of one spatial dim: (low, high)."""
    total = max((_out_size(size, k, s, "SAME") - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def spatial_pads(padding, hw, kernel, stride) -> Tuple[Tuple[int, int], ...]:
    """``((top, bottom), (left, right))`` of a ``padding`` form over an
    input of spatial shape ``hw``."""
    if padding == "SAME":
        return tuple(_same_pads(n, k, s)
                     for n, k, s in zip(hw, kernel, stride))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    if not (pt or pb or pl or pr):
        return x
    return F.pad(x, (pl, pr, pt, pb), value=value)


def weight_grad(x: torch.Tensor, wshape, gy: torch.Tensor, stride,
                groups: int) -> torch.Tensor:
    """The kernel's gradient of ``conv2d(x, w, stride, groups)`` (``x``
    already padded) for the output's gradient ``gy``: one GEMM a group,
    ``gy [o/g, n*l] @ cols^T [n*l, c/g*kh*kw]`` over the ``n*l`` output
    positions of every sample.  ``cols`` (im2col) is one copy of a
    strided view of ``x``, and ``gy`` is copied once to put its samples
    beside its positions."""
    o, cg, kh, kw = wshape
    n = x.shape[0]
    win = x.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])
    oh, ow = win.shape[2], win.shape[3]          # [n, c, oh, ow, kh, kw]
    cols = win.reshape(n, groups, cg, oh, ow, kh, kw).permute(
        1, 2, 5, 6, 0, 3, 4).reshape(groups, cg * kh * kw, n * oh * ow)
    rows = gy.reshape(n, groups, o // groups, oh * ow).permute(
        1, 2, 0, 3).reshape(groups, o // groups, n * oh * ow)
    return torch.bmm(rows, cols.transpose(1, 2)).view(wshape)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` at padding 0 whose kernel gradient is
    :func:`weight_grad`'s GEMM (cuDNN's is the less precise in float32;
    the module's docstring)."""

    @staticmethod
    def forward(ctx, x, w, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups
        return F.conv2d(x, w, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy, ctx.stride,
                                            groups=ctx.groups)
        if ctx.needs_input_grad[1]:
            gw = weight_grad(x, w.shape, gy, ctx.stride, ctx.groups)
        return gx, gw, None, None


def _spatial_out(x: TensorSpec, kernel, stride, padding) -> Tuple[int, int]:
    h, w = x.shape[2], x.shape[3]
    if isinstance(padding, str):
        return tuple(_out_size(n, k, s, padding)
                     for n, k, s in zip((h, w), kernel, stride))
    (pt, pb), (pl, pr) = padding
    return ((h + pt + pb - kernel[0]) // stride[0] + 1,
            (w + pl + pr - kernel[1]) // stride[1] + 1)


def _sample_solution(config, x: TensorSpec, out: TensorSpec
                     ) -> ShardingSolution:
    sample = tuple(config.get("sample", ()))
    sh = TensorSharding.replicated(x.ndim)
    out_sh = TensorSharding.replicated(out.ndim)
    if sample:
        sh = sh.with_dim(0, sample)
        out_sh = out_sh.with_dim(0, sample)
    return ShardingSolution(inputs=[sh], outputs=[out_sh])


@register_op
class Conv2D(Op, nn.Module):
    """``activation(conv(x, kernel) + bias)``; ``kernel`` is ``[out,
    in / groups, kh, kw]``.  The window's size is ``kernel_size`` here
    (``kernel`` is the weight), ``kernel`` in the signature."""

    type_name = "conv2d"

    def __init__(self, out_channels: int, kernel=(3, 3), stride=(1, 1),
                 padding="SAME", activation: Optional[str] = None,
                 use_bias: bool = True, groups: int = 1,
                 in_channels: Optional[int] = None,
                 dtype=torch.float32, kernel_initializer=None,
                 bias_initializer=None, device=None):
        super().__init__()
        self.out_channels = int(out_channels)
        self.kernel_size = _pair(kernel)
        self.stride = _pair(stride)
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        self.padding = padding
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.groups = int(groups)
        self.in_channels = in_channels
        self.compute_dtype = as_dtype(dtype)
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        if in_channels is not None:
            for p in self.params():
                setattr(self, p.name, nn.Parameter(
                    torch.empty(p.spec.shape, dtype=p.spec.dtype,
                                device=device), requires_grad=False))

    def signature_attrs(self):
        out = super().signature_attrs()
        out["kernel"] = out.pop("kernel_size")
        return out

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        if self.in_channels is None:
            self.in_channels = x.shape[1]
        oh, ow = _spatial_out(x, self.kernel_size, self.stride, self.padding)
        return [TensorSpec((x.shape[0], self.out_channels, oh, ow),
                           self.compute_dtype)]

    def params(self):
        ps = [ParamSpec("kernel", TensorSpec(
            (self.out_channels, self.in_channels // self.groups,
             *self.kernel_size), self.compute_dtype), self.kernel_initializer)]
        if self.use_bias:
            ps.append(ParamSpec("bias", TensorSpec((self.out_channels,),
                                                   self.compute_dtype),
                                self.bias_initializer))
        return ps

    def forward(self, x):
        pads = spatial_pads(self.padding, x.shape[2:], self.kernel_size,
                            self.stride)
        y = _Conv2d.apply(_pad(x, pads), self.kernel.to(x.dtype),
                          self.stride, self.groups)
        bias = self.bias[:, None, None] if self.use_bias else None
        if bias is not None or self.activation is not None:
            y = add_bias(y, bias, self.activation)
        return y.to(self.compute_dtype)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        return _sample_solution(config, x, self.infer_shapes([x])[0])

    def flops(self, in_specs):
        out = self.infer_shapes(list(in_specs))[0]
        kh, kw = self.kernel_size
        return 2 * out.size * (self.in_channels // self.groups) * kh * kw


@register_op
class Pool2D(Op, nn.Module):
    """Max or average pooling over ``kernel`` windows (``pool_type``
    ``"max"`` or anything else: average)."""

    type_name = "pool2d"

    def __init__(self, kernel=(2, 2), stride=(2, 2), padding="VALID",
                 pool_type: str = "max"):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        self.padding = padding
        self.pool_type = pool_type

    def infer_shapes(self, in_specs):
        x = in_specs[0]
        oh, ow = _spatial_out(x, self.kernel, self.stride, self.padding)
        return [TensorSpec((x.shape[0], x.shape[1], oh, ow), x.dtype)]

    def forward(self, x):
        pads = spatial_pads(self.padding, x.shape[2:], self.kernel,
                            self.stride)
        if self.pool_type == "max":
            return F.max_pool2d(_pad(x, pads, float("-inf")), self.kernel,
                                self.stride)
        return F.avg_pool2d(_pad(x, pads), self.kernel, self.stride)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        return _sample_solution(config, x, self.infer_shapes([x])[0])
