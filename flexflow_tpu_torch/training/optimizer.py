"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam / AdamW.

Port of ``flexflow_tpu/training/optimizer.py`` (:27-112), written as the
reference writes it and run under ``torch.no_grad()``: parameters and
state are updated in place.  Parameters, gradients and state are nested
dicts ``{node name: {param name: tensor}}``.

Adam is not ``torch.optim.Adam``: that one adds ``eps`` after dividing
``sqrt(v)`` by ``sqrt(1 - beta2**t)``, where the reference divides by
``sqrt(v) + eps`` and folds both bias corrections into ``alpha_t``
(:88-99); the two differ wherever ``v`` is small.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _zeros_like(params: Tree) -> Tree:
    return {n: {p: torch.zeros_like(w) for p, w in g.items()}
            for n, g in params.items()}


class Optimizer:
    def init_state(self, params: Tree) -> Any:
        raise NotImplementedError

    def update(self, grads: Tree, state, params: Tree) -> Tuple[Tree, Any]:
        """Update ``params`` and ``state`` in place -> ``(params,
        state)``."""
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def __init__(self, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params):
        if self.momentum == 0.0:
            return ()
        return _zeros_like(params)

    @torch.no_grad()
    def update(self, grads, state, params):
        lr, mu, wd = self.lr, self.momentum, self.weight_decay
        for name, group in params.items():
            for pname, p in group.items():
                g = grads[name][pname]
                if wd:
                    g = g + wd * p
                if mu == 0.0:
                    p.sub_(lr * g)
                    continue
                v = state[name][pname]
                v.mul_(mu).add_(g)          # v = mu * v + g
                step = g + mu * v if self.nesterov else v
                p.sub_(lr * step)
        return params, state


class AdamOptimizer(Optimizer):
    def __init__(self, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, adamw: bool = False):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.adamw = adamw

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params), "t": 0}

    @torch.no_grad()
    def update(self, grads, state, params):
        t = state["t"] + 1
        b1, b2, eps, wd = (self.beta1, self.beta2, self.epsilon,
                           self.weight_decay)
        alpha_t = self.alpha * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        for name, group in params.items():
            for pname, p in group.items():
                g = grads[name][pname]
                m, v = state["m"][name][pname], state["v"][name][pname]
                if wd and not self.adamw:
                    g = g + wd * p
                m.mul_(b1).add_((1 - b1) * g)            # m = b1 m + (1-b1) g
                v.mul_(b2).add_((1 - b2) * g.square())   # v = b2 v + (1-b2) g^2
                step = alpha_t * m / (v.sqrt() + eps)
                if wd and self.adamw:
                    step = step + self.alpha * wd * p
                p.sub_(step)
        state["t"] = t
        return params, state
