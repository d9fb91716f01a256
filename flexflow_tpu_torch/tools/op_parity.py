"""Hold the training ops of slices 11c-i and 11c-ii on a CUDA device
against the same modules on the CPU: ``check(name, device)``,
``check_all(device, names=None)``.

Each case builds one op through ``FFModel``'s builder (the shape ops,
``Conv2D`` in every padding form with strides 1, 2 and 4 and groups,
``Pool2D`` max and average, ``BatchNorm`` in training and outside it,
``AddBiasResidualLayerNorm``, ``Embedding`` with each ``aggr``; the MoE
ops ``GroupBy`` (random gates, and gates with planted ties),
``Experts`` with and without a hidden layer, ``Aggregate``,
``AggregateSpec``; the decode heads ``ArgMax``, ``TopK``, ``ArgTopK``,
``BeamTopK`` on logits with planted ties across the vocabulary,
``Sampling``; ``Cache``), draws
its inputs, parameters and output cotangents from a seed at magnitudes
of order one (unit inputs; kernels and tables from the port's default
Glorot initializer, so a conv's output is about unit too; the other
parameters ``0.5 * randn``; each output's cotangent ``randn`` over the
square root of the elements a channel sums over, so a kernel's gradient
is about unit too), and runs the forward and autograd's backward once
on the CPU and once on the device from the same values: every output
and every gradient (inputs and parameters) must agree within ``rtol
1e-4``, ``atol 1e-5`` (float32; the caller turns TF32 off, as the
port's float32 training does); integer outputs (the indices) must be
equal element for element.  ``Sampling`` draws from the device's own
generator, so its tokens are held to the CPU's nucleus mask instead:
each one inside it, and the same seed giving the same tokens twice.
``chip_smoke.py`` phases 24(a) and 25(a), and
``tests/test_torch_cuda_vision.py`` and ``tests/test_torch_cuda_moe.py``
run the cases (:data:`SLICE_11C_II` names the second slice's).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

RTOL, ATOL = 1e-4, 1e-5


def _ids(shape, high):
    """An int input: ``(shape, high)`` draws ids in ``[0, high)``."""
    return (tuple(shape), int(high))


def _gates(n, e, ties=False):
    """A ``[n, e]`` gate input: a softmax of unit normals, or (``ties``)
    rows of equal gates (every third row favouring the upper half), so
    the lower experts must win."""
    def draw(g):
        if not ties:
            return torch.softmax(torch.randn(n, e, generator=g), -1)
        x = torch.full((n, e), 1.0 / e)
        x[::3, e // 2:] = 2.0 / e
        return x / x.sum(-1, keepdim=True)

    draw.shape = (n, e)
    return draw


def _logits(shape, ties=True):
    """A logits input of unit normals whose largest values tie: ids 0-2
    and every odd id hold 5.0."""
    def draw(g):
        x = torch.randn(shape, generator=g)
        if ties:
            x[..., 1::2] = 5.0
            x[..., :3] = 5.0
        return x

    draw.shape = tuple(shape)
    return draw


def _combine(n, e, c):
    """A ``[n, e, c]`` combine input: uniform weights, two thirds zero."""
    def draw(g):
        return (torch.rand(n, e, c, generator=g)
                * (torch.rand(n, e, c, generator=g) > 0.66))

    draw.shape = (n, e, c)
    return draw


# name -> (inputs: float shapes or _ids(...), build(model, tensors),
#          training)
CASES: Dict[str, Tuple[list, object, bool]] = {
    "reshape": ([(8, 64, 7, 7)], lambda m, t:
                m.reshape(t[0], (8, 64, 49)), False),
    "transpose": ([(8, 64, 7, 7)], lambda m, t:
                  m.transpose(t[0], (0, 2, 3, 1)), False),
    "concat": ([(8, 64, 14, 14), (8, 32, 14, 14)], lambda m, t:
               m.concat(t, axis=1), False),
    "split": ([(8, 96, 14, 14)], lambda m, t:
              m.split(t[0], [64, 32], axis=1), False),
    "gather": ([(8, 512), _ids((8, 64), 512)], lambda m, t:
               m.gather(t[0], t[1], axis=1), False),
    "reverse": ([(8, 64, 14, 14)], lambda m, t: m.reverse(t[0], 2), False),
    "flat": ([(8, 512, 2, 2)], lambda m, t: m.flat(t[0]), False),
    "conv_same_s1": ([(8, 64, 28, 28)], lambda m, t:
                     m.conv2d(t[0], 64, use_bias=False), False),
    "conv_same_s2": ([(8, 64, 28, 28)], lambda m, t:
                     m.conv2d(t[0], 128, stride=(2, 2), use_bias=False),
                     False),
    "conv_same_s4_11x11": ([(8, 3, 64, 64)], lambda m, t:
                           m.conv2d(t[0], 64, kernel=(11, 11),
                                    stride=(4, 4), activation="relu"),
                           False),
    "conv_valid": ([(8, 32, 16, 16)], lambda m, t:
                   m.conv2d(t[0], 48, kernel=(5, 5), padding="VALID",
                            activation="relu"), False),
    "conv_int_padding": ([(8, 32, 15, 15)], lambda m, t:
                         m.conv2d(t[0], 32, stride=(2, 2), padding=1),
                         False),
    "conv_groups2": ([(8, 32, 14, 14)], lambda m, t:
                     m.conv2d(t[0], 64, groups=2), False),
    "pool_max_same": ([(8, 64, 28, 28)], lambda m, t:
                      m.pool2d(t[0], (3, 3), (2, 2), padding="SAME"), False),
    "pool_max_valid": ([(8, 64, 27, 27)], lambda m, t:
                       m.pool2d(t[0], (3, 3), (2, 2)), False),
    "pool_avg_same": ([(8, 64, 14, 14)], lambda m, t:
                      m.pool2d(t[0], (3, 3), (1, 1), padding="SAME",
                               pool_type="avg"), False),
    "pool_avg_valid": ([(8, 512, 7, 7)], lambda m, t:
                       m.pool2d(t[0], (7, 7), (1, 1), pool_type="avg"),
                       False),
    "batch_norm_train": ([(8, 64, 28, 28)], lambda m, t:
                         m.batch_norm(t[0], relu=True), True),
    "batch_norm_eval": ([(8, 64, 28, 28)], lambda m, t:
                        m.batch_norm(t[0]), False),
    "add_bias_residual_layer_norm": ([(8, 128, 768), (8, 128, 768)],
                                     lambda m, t:
                                     m.add_bias_residual_layer_norm(
                                         t[0], t[1]), False),
    "embedding_none": ([_ids((8, 26), 1000)], lambda m, t:
                       m.embedding(t[0], 1000, 16), False),
    "embedding_sum": ([_ids((8, 4), 1000)], lambda m, t:
                      m.embedding(t[0], 1000, 16, aggr="sum"), False),
    "embedding_avg": ([_ids((8, 4), 1000)], lambda m, t:
                      m.embedding(t[0], 1000, 16, aggr="avg"), False),
    # slice 11c-ii: MoE, the decode heads, the cache
    "group_by": ([(256, 64), _gates(256, 8)], lambda m, t:
                 m.group_by(t[0], t[1], 8, k=2, capacity_factor=1.0),
                 False),
    "group_by_ties": ([(256, 64), _gates(256, 8, ties=True)], lambda m, t:
                      m.group_by(t[0], t[1], 8, k=2, capacity_factor=1.0),
                      False),
    "experts_hidden": ([(8, 64, 64)], lambda m, t:
                       m.experts(t[0], 64, hidden_dim=256), False),
    "experts_single": ([(8, 64, 64)], lambda m, t:
                       m.experts(t[0], 64, activation="gelu"), False),
    "aggregate": ([(8, 64, 64), _combine(256, 8, 64)], lambda m, t:
                  m.aggregate(t[0], t[1]), False),
    "aggregate_spec": ([(8, 64, 64), _combine(256, 8, 64),
                        _gates(256, 8, ties=True)], lambda m, t:
                       m.aggregate_spec(t[0], t[1], t[2], k=2), False),
    "argmax": ([_logits((64, 32000))], lambda m, t: m.argmax(t[0]), False),
    "top_k": ([_logits((64, 32000))], lambda m, t: m.top_k(t[0], 8), False),
    "arg_top_k": ([_logits((64, 32000))], lambda m, t:
                  m.arg_top_k(t[0], 8, speculative_decoding=True), False),
    "beam_top_k": ([_logits((16, 4, 8000))], lambda m, t:
                   m.beam_top_k(t[0], 8), False),
    "sampling": ([_logits((64, 32000), ties=False)], lambda m, t:
                 m.sampling(t[0], top_p=0.9, temperature=0.8), False),
    "cache": ([(64, 4096)], lambda m, t: m.cache(t[0]), False),
}
SLICE_11C_II = ("group_by", "group_by_ties", "experts_hidden",
                "experts_single", "aggregate", "aggregate_spec", "argmax",
                "top_k", "arg_top_k", "beam_top_k", "sampling", "cache")
SLICE_11C_I = tuple(n for n in CASES if n not in SLICE_11C_II)


def _is_ids(s) -> bool:
    return not callable(s) and isinstance(s[0], tuple)


def _shape(s):
    return s.shape if callable(s) else (s[0] if _is_ids(s) else s)


def build_case(name: str):
    """The case's op (built on the CPU, its parameters drawn from a seed),
    its inputs and its cotangents, as CPU tensors."""
    from ..config import FFConfig
    from ..model import FFModel
    from ..training.initializer import GlorotUniform

    shapes, build, _ = CASES[name]
    m = FFModel(FFConfig(), device="cpu")
    build(m, [m.create_tensor(s[0], dtype="int32") if _is_ids(s)
              else m.create_tensor(_shape(s)) for s in shapes])
    node = m.graph.nodes[-1]
    op = node.op
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    for p in op.params():
        if p.spec.ndim >= 2:
            v = GlorotUniform()(g, p.spec.shape, torch.float32)
        else:
            v = torch.randn(p.spec.shape, generator=g) * 0.5
        if p.name == "running_var":
            v = v.abs() + 0.5
        setattr(op, p.name, nn.Parameter(v))
    xs = [s(g) if callable(s) else
          torch.randint(0, s[1], s[0], generator=g, dtype=torch.int32)
          if _is_ids(s) else torch.randn(s, generator=g) for s in shapes]
    cts = []
    for t in node.outputs:
        spec = m.graph.spec(t)
        if not spec.dtype.is_floating_point:
            cts.append(None)      # an index output: no gradient
            continue
        shape = spec.shape
        per_channel = math.prod(shape) // (shape[1] if len(shape) > 1
                                           else 1)
        cts.append(torch.randn(shape, generator=g) / math.sqrt(per_channel))
    return op, xs, cts


def _run(op, xs, cts, training: bool):
    """Forward and backward of ``op``; the outputs and the gradients of
    the float inputs and of every parameter, copied to the CPU."""
    from ..core.op import OpContext

    xs = [x.clone().requires_grad_(x.is_floating_point()) for x in xs]
    out = (op(*xs, ctx=OpContext(training=training)) if op.uses_context
           else op(*xs))
    outs = list(out) if isinstance(out, tuple) else [out]
    diff = [(o, c) for o, c in zip(outs, cts)
            if c is not None and o.requires_grad]
    if diff:
        torch.autograd.backward([o for o, _ in diff], [c for _, c in diff])
    grads = [torch.zeros_like(x) if x.grad is None else x.grad
             for x in xs if x.is_floating_point()]
    # a parameter the step leaves unread (the running statistics in
    # training) has no gradient: zeros
    grads += [torch.zeros_like(p) if p.grad is None else p.grad
              for _, p in sorted(op.named_parameters())]
    return [t.detach().cpu() for t in outs + grads]


def _check_sampling(op, xs, device) -> float:
    """Sampling on ``device``: every token inside the nucleus mask of the
    CPU's logits, and a second draw from the same seed equal; returns
    0 (nothing to difference)."""
    from ..ops.reduction import nucleus_keep

    logits = xs[0] / op.temperature if op.temperature != 1.0 else xs[0]
    keep = nucleus_keep(logits, op.top_p)
    dev_op = copy.deepcopy(op).to(device)
    x = xs[0].to(device)
    first, second = dev_op(x).cpu(), dev_op(x).cpu()
    if not torch.equal(first, second):
        raise AssertionError("sampling: one seed gave two token sets")
    rows = torch.arange(len(first))
    if not keep[rows, first.long()].all():
        raise AssertionError("sampling: a token outside the nucleus")
    return 0.0


def check(name: str, device) -> float:
    """Case ``name`` on ``device`` against the CPU; returns the largest
    absolute difference, raising ``AssertionError`` past the tolerance
    (an integer output must be equal)."""
    op, xs, cts = build_case(name)
    if name == "sampling":
        return _check_sampling(op, xs, device)
    training = CASES[name][2]
    dev_op = copy.deepcopy(op).to(device)
    want = _run(op, xs, cts, training)
    got = _run(dev_op, [x.to(device) for x in xs],
               [None if c is None else c.to(device) for c in cts], training)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{name} tensor {i}: indices differ "
                                     f"at {int((a != b).sum())} places")
            continue
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name} tensor {i}: {m}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def check_all(device, names=None) -> List[Tuple[str, float]]:
    return [(name, check(name, device)) for name in (names or CASES)]
