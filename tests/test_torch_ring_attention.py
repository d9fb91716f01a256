"""Ring attention, the ``sequence`` config, the shift collective and a
pipeline stage's parameter draw of the port against the JAX package's,
on the CPU.

* ``parallel/ring_attention.py:ring_attention`` on ``sp=4``, causal and
  not, against the reference's under ``shard_map`` at ``atol = rtol =
  1e-5`` (``tests/test_parallel_ext.py:32-55``), and its count of shifts;
* the attention op's ``sequence`` config (ring attention over ``sp``)
  against the reference's ``"local"`` mode and against one device, both
  at ``1e-5``; on ``{"dp": 2, "sp": 2}`` too; its gradients (two SGD
  steps' losses and parameters) against one device at ``rtol 1e-5``,
  ``atol 1e-6``;
* ``parallel/comm.py``'s ``("shift", t, axes, offset)``: forward,
  backward (the reverse shift) and the lone shard's identity;
* a pipeline stage's draw against the reference's stage-split
  ``init_params(only=...)``: the same nodes, parameters and shapes, and
  on each side bit-identical to the whole draw.

Inputs come from numpy seeds; weights cross from the reference by
``load_params``.  Mesh devices are ``["cpu"] * n``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.compat import shard_map
from flexflow_tpu.core.interpreter import init_params as jax_init
from flexflow_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from flexflow_tpu.utils.platform import collective_safe_compiler_options
from flexflow_tpu_torch.parallel.comm import Comm, run_local, run_shards
from flexflow_tpu_torch.parallel.ring_attention import ring_attention

from test_torch_train import _jax_params, _port_params

B, T_LEN, E, H = 2, 32, 16, 4


def _qkv(seed=0, b=2, t=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(causal):
    q, k, v = _qkv()
    n, d = 4, q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    jmesh = J.make_mesh({"sp": n}, jax.devices()[:n])
    want = jax.jit(shard_map(
        lambda q, k, v: jax_ring(q, k, v, "sp", n, causal, scale),
        mesh=jmesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp")),
        compiler_options=collective_safe_compiler_options(jmesh))(q, k, v)
    mesh = T.make_mesh({"sp": n}, ["cpu"] * n)
    blk = q.shape[1] // n
    gens = [ring_attention(*(torch.from_numpy(a[:, i * blk:(i + 1) * blk])
                             for a in (q, k, v)), "sp", n, causal, scale)
            for i in range(n)]
    calls = mesh.comm.calls["local"]
    got = torch.cat(run_shards(gens, mesh.comm), dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the keys and the values shift n - 1 times each (the last rotation,
    # which brings them home, is never read)
    assert mesh.comm.calls["local"] - calls == 2 * (n - 1)


def _attention_model(pkg, shape, strategy, mode="spmd", dropout=0.0):
    n = int(np.prod(list(shape.values())))
    if pkg is J:
        m = J.FFModel(J.FFConfig(batch_size=B),
                      mesh=J.make_mesh(shape, jax.devices()[:n]))
    else:
        m = T.FFModel(T.FFConfig(batch_size=B),
                      mesh=T.make_mesh(shape, ["cpu"] * n))
    x = m.create_tensor((B, T_LEN, E))
    y = m.multihead_attention(x, x, x, E, H, causal=True, use_bias=False,
                              dropout=dropout, name="mha")
    m.compile(optimizer=pkg.SGDOptimizer(lr=0.1), strategy=strategy,
              mode=mode, outputs=[y], loss_type="mean_squared_error")
    return m


SEQ = {"mha": {"sequence": ("sp",)}}


def _x(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T_LEN, E)).astype(np.float32),
            rng.normal(size=(B, T_LEN, E)).astype(np.float32))


def test_sequence_op_matches_reference_local_mode():
    jm = _attention_model(J, {"sp": 4}, SEQ, "local")
    for mode in ("local", "spmd"):   # both of the port's modes ring
        tm = _attention_model(T, {"sp": 4}, SEQ, mode)
        tm.load_params(_jax_params(jm))
        x, _ = _x()
        np.testing.assert_allclose(tm.forward(x).numpy(),
                                   np.asarray(jm.forward(x)), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("shape,strategy", [
    ({"sp": 4}, SEQ),
    ({"dp": 2, "sp": 2}, {"mha": {"sample": ("dp",), "sequence": ("sp",)}}),
], ids=["sp4", "dp2_sp2"])
def test_sequence_op_trains_as_one_device(shape, strategy):
    one = _attention_model(T, {"dp": 1}, {})
    ring = _attention_model(T, shape, strategy)
    ring.load_params(_port_params(one))
    x, y = _x()
    np.testing.assert_allclose(ring.forward(x).numpy(),
                               one.forward(x).numpy(), atol=1e-5, rtol=1e-5)
    calls = ring.mesh.comm.calls["local"]
    h1 = one.fit(x, y, epochs=2, verbose=False, shuffle=False)
    h2 = ring.fit(x, y, epochs=2, verbose=False, shuffle=False)
    for a, b in zip(h2, h1):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    for p, v in _port_params(one)["mha"].items():
        np.testing.assert_allclose(_port_params(ring)["mha"][p], v,
                                   rtol=1e-5, atol=1e-6, err_msg=p)
    # each step: 2 (n - 1) shifts a ring forward and as many backward
    n = shape["sp"]
    rings = ring.mesh.size // n
    assert ring.mesh.comm.calls["local"] - calls >= 2 * 4 * (n - 1) * rings


def test_sequence_op_keeps_its_checks():
    with pytest.raises(ValueError, match="dropout"):
        _attention_model(T, {"sp": 2}, SEQ, dropout=0.1)


def test_shift_forward_backward_and_lone_shard():
    comm = Comm(["cpu"] * 4, {"pp": 2, "dp": 2})
    xs = [torch.full((2,), float(r), requires_grad=True) for r in range(4)]

    def gen(x):
        i = yield ("axis_index", 0, ("pp",))
        y = yield ("shift", x * (i + 1), ("pp",), 1)
        return y

    outs = run_shards([gen(x) for x in xs], comm)
    # groups over pp: ranks {0, 2} and {1, 3}; rank 2 (pp index 1) sends
    # 2 * its value to rank 0, rank 0 sends its value to rank 2
    assert [o[0].item() for o in outs] == [4.0, 6.0, 0.0, 1.0]
    torch.autograd.backward(outs, [torch.full((2,), float(10 ** r))
                                   for r in range(4)])
    # the reverse shift: rank 0's tensor went to rank 2 (scale 1)
    assert [x.grad[0].item() for x in xs] == [100.0, 1000.0, 2.0, 20.0]
    assert comm.calls["local"] == 4   # 2 groups, forward and backward
    got = comm.shift([torch.tensor([float(i)]) for i in range(3)], -1,
                     ranks=[0, 1, 2])
    assert [g.item() for g in got] == [1.0, 2.0, 0.0]
    # a lone shard: index 0, its own tensor back
    t = torch.arange(3.0)
    assert torch.equal(run_local(gen(t)), t)


KW = dict(batch=4, seq=6, hidden_dim=16, num_heads=2, ff_dim=32,
          num_layers=2, num_classes=5)


def _port_model(**cfg_kw):
    """The port's classifier at ``KW``, seed 0: on one device, or
    pipelined over ``{"pp": 2}`` (one layer a stage)."""
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier
    if not cfg_kw:
        m = build_transformer_classifier(T.FFConfig(seed=0), device="cpu",
                                         **KW)
    else:
        m = build_transformer_classifier(
            T.FFConfig(seed=0, **cfg_kw),
            mesh=T.make_mesh({"pp": 2}, ["cpu"] * 2), **KW)
    m.compile(optimizer=T.SGDOptimizer(lr=0.01))
    return m


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_draw_matches_reference_only_draw(stage):
    """A pipeline stage's core, drawn by the port as the whole draw draws
    it, holds the nodes, parameters and shapes that the reference's
    stage-split ``init_params(only=...)`` draws; on each side the stage's
    values are the whole draw's, bit for bit."""
    from flexflow_tpu.models.transformer import \
        build_transformer_classifier
    pm = _port_model(pipeline="force", pipeline_microbatches=2)
    whole = _port_model().params
    meta = pm._pp_meta
    only = set(meta["core_names"][stage])
    jm = build_transformer_classifier(J.FFConfig(num_devices=1), **KW)
    jm.compile()
    key = jax.random.PRNGKey(0)
    j_whole = jax_init(jm.graph, jm.plan, key)
    j_part = jax_init(jm.graph, jm.plan, key, only=only)
    assert sorted(j_part) == sorted(
        n for j, n in enumerate(meta["core_names"][stage])
        if meta["pnames"][j])
    # the stage's shard holds its core as [1, ...] blocks of _pp_core
    rank = pm._pipeline.steps[True].stage_of.index(stage)
    core = pm.shard_params[rank]["_pp_core"]
    for j, n in enumerate(meta["core_names"][stage]):
        assert sorted(meta["pnames"][j]) == sorted(j_part.get(n, {}))
        for p in meta["pnames"][j]:
            v = core[f"{j}.{p}"].detach()[0]
            assert tuple(v.shape) == j_part[n][p].shape, f"{n}.{p}"
            assert torch.equal(v, whole[n][p]), f"{n}.{p}"
            assert np.array_equal(np.asarray(j_part[n][p]),
                                  np.asarray(j_whole[n][p]))
