"""LayerNorm, RMSNorm, the fused residual norms, the SwiGLU junction and
BatchNorm.

Port of ``flexflow_tpu/ops/norm.py`` (``_layer_norm`` :33, ``LayerNorm``
:57-91, ``_rms_norm`` :46, ``RMSNorm`` :93-117, ``ResidualLayerNorm``
:119-160, ``AddBiasResidualLayerNorm`` :163-199, ``ResidualRMSNorm``
:202, ``SigmoidSiluMulti`` :231, ``BatchNorm`` :256-311), for the
serve and the training paths (``gamma`` and ``beta`` trainable once
``core/interpreter.py:init_params`` makes them so; a LayerNorm without
``elementwise_affine`` has neither).  The fused ops are what the
substitution rules (``search/substitution.py``) emit; their gradients
come from autograd through both outputs.
The normalisation is computed in float32 and cast back to the input's
dtype at the same place the reference casts, so bf16 models round where
the reference rounds.

The op IR (reference :27, :84-306): a normalisation reduces over the last
(feature) dim, so that dim must be whole and not partial, and the
leading dims propagate their producer's split (``_norm_sharding``); the
SwiGLU junction is elementwise and propagates its first input's
sharding to both inputs and its output.  Their configs change nothing
else: a norm given a ``sample`` config runs on whatever rows reach it.

BatchNorm normalises each channel (NCHW dim 1) over the batch and the
spatial dims.  Training uses the batch's statistics, the variance the
population's (``jnp.var``, ddof 0); ``sample`` splits the batch, and the
reference trains on global arrays (its ``"spmd"`` mode), so a shard's
statistics are the global batch's: the shard's sums, all-reduced over
the sample axes (with their gradients, ``parallel/comm.py``), over the
global count, the mean first and then the squared deviations from it,
the two collectives yielded as the training attention yields its
gathers.  (The reference's ``"local"`` branch averages the shards'
statistics instead, :288-295; its training path never takes it.)
Outside training it normalises with ``running_mean`` and
``running_var``, parameters that are not trained (zeros and ones,
``training/initializer.py``) and that nothing updates, as in the
reference: no code of the reference writes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.graph import ParamSpec, TensorSpec
from ..core.op import Op, ShardingSolution, register_op
from ..core.sharding import TensorSharding
from .elementwise import UNARY_FNS, propagate


def _norm_sharding(spec: TensorSpec, in_sh) -> TensorSharding:
    """The producer's sharding, no partial sum, the feature dim whole
    (reference :27)."""
    sh = propagate(in_sh, spec)
    sh = TensorSharding(sh.dims, frozenset())
    return sh.with_dim(spec.ndim - 1, ())


def layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    if gamma is not None:
        y = y * gamma  # f32 * gamma's dtype -> f32, as in the reference
    return y.to(x.dtype)


def residual_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                      gamma: Optional[torch.Tensor], eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + residual, rms_norm(x + residual))``."""
    s = x + residual
    return s, rms_norm(s, gamma, eps)


def sigmoid_silu_multi(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` in the inputs' dtype."""
    return F.silu(x1) * x2


class _NormIR(Op):
    """The op IR the norms share: one input (the residual norms: two or
    three), its sharding propagated with the feature dim whole."""

    n_out = 1
    flops_per_element = None   # None: one per output element

    def infer_shapes(self, in_specs):
        return [in_specs[0]] * self.n_out

    def params(self):
        if getattr(self, "gamma", None) is None:
            return []
        ps = [ParamSpec("gamma", TensorSpec((self.dim,), self.compute_dtype))]
        if getattr(self, "beta", None) is not None:
            ps.append(ParamSpec("beta", TensorSpec((self.dim,),
                                                   self.compute_dtype)))
        return ps

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = _norm_sharding(in_specs[0],
                            in_shardings[0] if in_shardings else None)
        return ShardingSolution(inputs=[sh] * len(in_specs),
                                outputs=[sh] * self.n_out)

    def flops(self, in_specs):
        if self.flops_per_element is None:
            return super().flops(in_specs)
        return self.flops_per_element * in_specs[0].size

    def signature_attrs(self):
        return {"dim": self.dim, "eps": self.eps,
                "dtype": self.compute_dtype}


@register_op
class LayerNorm(_NormIR, nn.Module):
    """LayerNorm with gain ``gamma`` and, with ``use_bias``, shift
    ``beta`` (MPT's norms have none); neither without
    ``elementwise_affine``."""

    type_name = "layer_norm"
    flops_per_element = 8

    def __init__(self, dim: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 elementwise_affine: bool = True):
        super().__init__()
        self.dim = int(dim)
        self.compute_dtype = dtype
        self.eps = float(eps)
        self.elementwise_affine = bool(elementwise_affine)
        self.use_bias = bool(use_bias)
        self.gamma = (nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device),
                                   requires_grad=False)
                      if elementwise_affine else None)
        self.beta = (nn.Parameter(torch.zeros(dim, dtype=dtype,
                                              device=device),
                                  requires_grad=False)
                     if use_bias and elementwise_affine else None)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self.eps)

    def signature_attrs(self):
        return {**super().signature_attrs(),
                "elementwise_affine": self.elementwise_affine,
                "use_bias": self.use_bias}


@register_op
class ResidualLayerNorm(LayerNorm):
    """``(x + r1 [+ r2], layer_norm(x + r1 [+ r2]))`` (reference
    :119-160): the fused residual sum and its norm, two outputs, the
    sum's gradient the sum of both outputs' (autograd)."""

    type_name = "residual_layer_norm"
    n_out = 2
    flops_per_element = None

    def __init__(self, dim: int, use_two_residuals: bool = False,
                 elementwise_affine: bool = True, eps: float = 1e-5,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(dim, eps, use_bias, dtype, device,
                         elementwise_affine)
        self.use_two_residuals = bool(use_two_residuals)

    def forward(self, x, r1, r2=None):
        s = x + r1
        if self.use_two_residuals:
            s = s + r2
        return s, layer_norm(s, self.gamma, self.beta, self.eps)

    def signature_attrs(self):
        return {**super().signature_attrs(),
                "use_two_residuals": self.use_two_residuals}


@register_op
class AddBiasResidualLayerNorm(LayerNorm):
    """``(x + attn_bias + residual, layer_norm of that sum)`` (reference
    :163-199, OPT's graph shape): ``attn_bias`` ``[dim]`` beside the
    LayerNorm's ``gamma`` and ``beta``, two outputs."""

    type_name = "add_bias_residual_layer_norm"
    n_out = 2
    flops_per_element = None

    def __init__(self, dim: int, elementwise_affine: bool = True,
                 eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(dim, eps, use_bias, dtype, device,
                         elementwise_affine)
        self.attn_bias = nn.Parameter(
            torch.zeros(dim, dtype=dtype, device=device), requires_grad=False)

    def params(self):
        return [ParamSpec("attn_bias", TensorSpec((self.dim,),
                                                  self.compute_dtype)),
                *super().params()]

    def forward(self, x, residual):
        s = x + self.attn_bias + residual
        return s, layer_norm(s, self.gamma, self.beta, self.eps)


@register_op
class RMSNorm(_NormIR, nn.Module):
    type_name = "rms_norm"
    flops_per_element = 5

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = int(dim)
        self.compute_dtype = dtype
        self.eps = float(eps)
        self.gamma = nn.Parameter(
            torch.ones(dim, dtype=dtype, device=device), requires_grad=False)

    def forward(self, x):
        return rms_norm(x, self.gamma, self.eps)


@register_op
class ResidualRMSNorm(RMSNorm):
    """Returns ``(residual_sum, normed)`` like the reference op."""

    type_name = "residual_rms_norm"
    n_out = 2
    flops_per_element = None

    def forward(self, x, residual):
        return residual_rms_norm(x, residual, self.gamma, self.eps)


@register_op
class SigmoidSiluMulti(Op, nn.Module):
    """``silu(x1) * x2``, the SwiGLU junction (reference :211-233): no
    parameters, elementwise."""

    type_name = "sigmoid_silu_multi"

    def forward(self, x1, x2):
        return sigmoid_silu_multi(x1, x2)

    def infer_shapes(self, in_specs):
        return [in_specs[0]]

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        sh = propagate(in_shardings[0] if in_shardings else None,
                       in_specs[0])
        sh = TensorSharding(sh.dims, frozenset())
        return ShardingSolution(inputs=[sh, sh], outputs=[sh])

    def flops(self, in_specs):
        return 5 * in_specs[0].size


@register_op
class BatchNorm(Op, nn.Module):
    """``relu?((x - mean) * rsqrt(var + eps) * gamma + beta)`` per channel
    of an NCHW ``x``: the batch's statistics while training (the global
    batch's under a ``sample`` split), ``running_mean`` and
    ``running_var`` otherwise.  ``momentum`` is the reference's field,
    which nothing reads."""

    type_name = "batch_norm"
    uses_context = True

    def __init__(self, dim: int, relu: bool = False, eps: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dim = int(dim)
        self.relu = bool(relu)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.compute_dtype = dtype
        for p in self.params():
            setattr(self, p.name, nn.Parameter(
                torch.empty(self.dim, dtype=dtype, device=device),
                requires_grad=False))

    def infer_shapes(self, in_specs):
        return [in_specs[0]]

    def params(self):
        spec = TensorSpec((self.dim,), self.compute_dtype)
        return [ParamSpec("gamma", spec), ParamSpec("beta", spec),
                ParamSpec("running_mean", spec, trainable=False),
                ParamSpec("running_var", spec, trainable=False)]

    def forward(self, x, ctx):
        if not ctx.training:
            return self._normalize(x, self.running_mean, self.running_var)
        axes = tuple(ctx.config.get("sample", ())) if ctx.config else ()
        if axes and ctx.mesh is not None:
            return self._global_statistics(x, axes, ctx)
        dims = self._dims(x)
        return self._normalize(x, x.mean(dim=dims),
                               x.var(dim=dims, correction=0))

    @staticmethod
    def _dims(x):
        return (0,) + tuple(range(2, x.ndim))

    def _global_statistics(self, x, axes, ctx):
        """The training forward on a block of a batch split over
        ``axes``: a generator that all-reduces the block's sums."""
        dims = self._dims(x)
        count = x.numel() // x.shape[1]
        for a in axes:
            count *= ctx.mesh.shape[a]
        total = yield ("all_reduce", x.sum(dim=dims), axes)
        mean = total / count
        dev = (x - self._channel(mean, x)).square().sum(dim=dims)
        dev = yield ("all_reduce", dev, axes)
        return self._normalize(x, mean, dev / count)

    def _channel(self, v, x):
        return v.reshape((1, self.dim) + (1,) * (x.ndim - 2))

    def _normalize(self, x, mean, var):
        y = (x - self._channel(mean, x)) * torch.rsqrt(
            self._channel(var, x) + self.eps)
        y = y * self._channel(self.gamma, x) + self._channel(self.beta, x)
        if self.relu:
            y = UNARY_FNS["relu"](y)
        return y.to(x.dtype)

    def apply_config(self, config, in_specs, mesh, in_shardings=None):
        x = in_specs[0]
        sh = TensorSharding.replicated(x.ndim)
        sample = tuple(config.get("sample", ()))
        if sample:
            sh = sh.with_dim(0, sample)
        return ShardingSolution(inputs=[sh], outputs=[sh])
