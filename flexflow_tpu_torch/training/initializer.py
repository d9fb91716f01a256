"""Weight initializers.

Port of ``flexflow_tpu/training/initializer.py``: ``init(generator,
shape, dtype) -> tensor``, drawn on the generator's device from an
explicit ``torch.Generator``.  Glorot's fans are the reference's own
(:24-32): ``fan_in`` is ``shape[0]`` and ``fan_out`` is ``shape[-1]``
(conv OIHW weights scale both by the receptive field), so the
attention's ``[e, h, hd]`` weights use ``e`` and ``hd``; this is not
``torch.nn.init.xavier_uniform_``'s rule.  Values match the reference's
in distribution, not draw for draw (the generators differ).
"""

from __future__ import annotations

import math

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape, dtype):
        raise NotImplementedError


class GlorotUniform(Initializer):
    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, generator, shape, dtype):
        fan_in = shape[0] if len(shape) >= 1 else 1
        fan_out = shape[-1] if len(shape) >= 2 else shape[0]
        if len(shape) == 4:  # conv OIHW: receptive field scales fans
            rf = shape[2] * shape[3]
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype, device=generator.device
                           ).uniform_(-limit, limit, generator=generator)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=generator.device)


class OneInitializer(Initializer):
    def __call__(self, generator, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=generator.device)


class UniformInitializer(Initializer):
    def __init__(self, minv: float = -0.1, maxv: float = 0.1, seed: int = 0):
        self.minv, self.maxv, self.seed = minv, maxv, seed

    def __call__(self, generator, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=generator.device
                           ).uniform_(self.minv, self.maxv,
                                      generator=generator)


class NormInitializer(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 1.0, seed: int = 0):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def __call__(self, generator, shape, dtype):
        return self.mean + self.stddev * torch.randn(
            shape, dtype=dtype, device=generator.device,
            generator=generator)


def default_initializer_for(op, param_spec):
    """The reference's defaults (:60-68): Glorot for kernels, zeros for
    biases, ones for norm gains."""
    name = param_spec.name
    if name in ("bias", "beta", "attn_bias", "running_mean"):
        return ZeroInitializer()
    if name in ("gamma", "running_var"):
        return OneInitializer()
    return GlorotUniform()
