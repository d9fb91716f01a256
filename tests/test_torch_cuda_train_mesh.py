"""Training on a mesh on the card: ``FFModel`` with every shard on one
card against one device on that card, at TINY widths (``chip_smoke.py``
phase 22 in small), and over two cards with NCCL.

These tests need an NVIDIA GPU; without one each skips, and the two-card
tests skip with fewer than two cards.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_mesh.py

* ``dp=2`` and ``dp=2 x tp=2`` (the Megatron dict) with every shard on
  ``cuda:0``, the local collectives: 3 steps of SGD with momentum and of
  Adam through ``fit`` from one device's weights, the losses within
  ``rtol 1e-5`` and the parameters within ``1e-5`` (SGD) or ``2 * alpha
  * steps`` (Adam), float32, TF32 off (as ``test_torch_cuda_train.py``);
* a checkpoint written at ``dp=2 x tp=2`` restores on one device with
  equal parameters, and the native ``DataLoader`` places each shard's
  block on the card;
* ``dp=2`` over two cards (NCCL): the same parity; over four cards, a
  sub-axis all-gather's backward over NCCL equal to the local one.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ff
from flexflow_tpu_torch.data import DataLoader
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as build
from flexflow_tpu_torch.parallel.comm import Comm, run_shards
from flexflow_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)

pytestmark = pytest.mark.cuda

TINY = dict(batch=4, seq=16, hidden_dim=32, num_heads=4, ff_dim=64,
            num_layers=2, num_classes=5)
STEPS = 3
OPTS = [("SGDOptimizer", dict(lr=0.05, momentum=0.9)),
        ("AdamOptimizer", dict(alpha=1e-3))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _batch(seed=0, n=TINY["batch"]):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, TINY["seq"], TINY["hidden_dim"]).astype(np.float32),
            rng.randint(0, TINY["num_classes"], n).astype(np.int32))


def _megatron(graph, dp=True):
    out = {}
    for node in graph.nodes:
        c = {"sample": ("dp",)} if dp else {}
        if node.name.endswith("_attn"):
            c["head"] = ("tp",)
        elif node.name.endswith("_ff1"):
            c["channel_out"] = ("tp",)
        elif node.name.endswith("_ff2"):
            c["channel_in"] = ("tp",)
        out[node.name] = c
    return out


def _fit(mesh, opt, init, x, y):
    cls, kw = opt
    m = build(ff.FFConfig(batch_size=TINY["batch"]), mesh=mesh, **TINY)
    m.compile(optimizer=getattr(ff, cls)(**kw),
              strategy=(_megatron(m.graph, "dp" in mesh.shape)
                        if "tp" in mesh.shape else None))
    if init is not None:
        m.load_params(init)
    hist = m.fit(x, y, epochs=STEPS, shuffle=False, verbose=False)
    return [h["loss"] for h in hist], m


def _parity(meshes, opt, dev):
    """Fit on each of ``meshes`` and on one device from the same weights;
    yields each mesh and its model once held to one device's."""
    x, y = _batch()
    one = ff.make_mesh({"dp": 1}, [dev])
    seed = build(ff.FFConfig(batch_size=TINY["batch"]), mesh=one, **TINY)
    init = {n: {p: v.detach().clone() for p, v in g.items()}
            for n, g in seed.compile().params.items()}
    base, ref = _fit(one, opt, init, x, y)
    atol = 2 * opt[1]["alpha"] * STEPS if "alpha" in opt[1] else 1e-5
    for mesh in meshes:
        losses, m = _fit(mesh, opt, init, x, y)
        np.testing.assert_allclose(losses, base, rtol=1e-5)
        for n, g in ref.params.items():
            for p, v in g.items():
                got = m.params[n][p]
                assert got.device == mesh.devices[0]
                np.testing.assert_allclose(
                    got.detach().cpu().numpy(), v.detach().cpu().numpy(),
                    rtol=1e-5, atol=atol, err_msg=f"{mesh.shape} {n}.{p}")
        assert all(b.device == d for s, d in zip(m.shard_params,
                                                 mesh.devices)
                   for g in s.values() for b in g.values())
        np.testing.assert_allclose(m.forward(x).cpu().numpy(),
                                   ref.forward(x).cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        yield mesh, m


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adam"])
def test_shards_on_one_card_train_as_one_device(dev, opt):
    meshes = [ff.make_mesh({"dp": 2}, [dev] * 2),
              ff.make_mesh({"dp": 2, "tp": 2}, [dev] * 4)]
    for mesh, m in _parity(meshes, opt, dev):
        assert mesh.comm.kind == "local" and mesh.comm.calls["nccl"] == 0
        assert m.grad_allreduces == STEPS * (3 if "tp" in mesh.shape else 1)


def test_checkpoint_and_native_loader_on_the_card(dev, tmp_path):
    x, y = _batch(n=4 * TINY["batch"])
    four = ff.make_mesh({"dp": 2, "tp": 2}, [dev] * 4)
    _, m = _fit(four, OPTS[1], None, x, y)
    save_checkpoint(str(tmp_path / "ck"), m, step=STEPS)
    one = build(ff.FFConfig(batch_size=TINY["batch"], seed=5), device=dev,
                **TINY)
    one.compile(optimizer=ff.AdamOptimizer(alpha=1e-3))
    assert restore_checkpoint(str(tmp_path / "ck"), one) == STEPS
    for n, g in m.params.items():
        for p, v in g.items():
            assert torch.equal(one.params[n][p], v), f"{n}.{p}"
    flat = ff.FFModel(ff.FFConfig(batch_size=TINY["batch"]),
                      mesh=ff.make_mesh({"dp": 2}, [dev] * 2))
    t = flat.create_tensor((TINY["batch"], x[0].size))
    flat.softmax(flat.dense(t, TINY["num_classes"]))
    flat.compile(optimizer=ff.SGDOptimizer(lr=0.05))
    loader = DataLoader(x.reshape(len(x), -1), y, batch_size=TINY["batch"],
                        plan=flat.plan, native="auto")
    for arrs, labels in loader:
        blocks = arrs[flat.graph.input_tids[0]]
        assert [b.device for b in blocks] == [dev, dev]
        assert [b.shape[0] for b in blocks] == [TINY["batch"] // 2] * 2
        assert labels.device == dev
    assert loader.engine == "native"
    assert np.isfinite(flat.fit(loader, epochs=1, verbose=False)[0]["loss"])


@pytest.mark.parametrize("opt", OPTS, ids=["sgd_momentum", "adam"])
def test_dp2_over_two_cards_trains_as_one_device(two_cards, opt):
    mesh = ff.make_mesh({"dp": 2}, two_cards)
    assert mesh.comm.kind == "nccl"
    for _, m in _parity([mesh], opt, two_cards[0]):
        assert mesh.comm.calls["nccl"] > 0 and mesh.comm.calls["local"] == 0


def test_nccl_sub_axis_all_gather_backward(dev):
    """An all-gather over ``tp`` within each ``dp`` row of ``dp2 x tp2``
    over four cards, forward and backward equal to the local one."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cards = [torch.device("cuda", i) for i in range(4)]
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 3, generator=g) for _ in range(4)]
    weights = [torch.randn(4, 3, generator=g) for _ in range(4)]

    def run(comm, devs):
        xs = [p.to(d).requires_grad_() for p, d in zip(parts, devs)]

        def shard(x):
            y = yield ("all_gather", x, 0, ("tp",))
            return y

        outs = run_shards([shard(x) for x in xs], comm)
        sum((o * w.to(o.device)).sum()
            for o, w in zip(outs, weights)).backward()
        return [o.detach().cpu() for o in outs] + [x.grad.cpu() for x in xs]

    shape = {"dp": 2, "tp": 2}
    nccl = Comm(cards, shape)
    assert nccl.kind == "nccl"
    got = run(nccl, cards)
    want = run(Comm(["cpu"] * 4, shape), ["cpu"] * 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert nccl.calls == {"nccl": 4, "local": 0}
