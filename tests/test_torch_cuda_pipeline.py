"""Pipeline and ring-attention training on the card against the CPU, at
small widths (``chip_smoke.py`` phase 27 (a) and (c) in small), and the
shift over distinct cards.

These tests need an NVIDIA GPU; without one each skips, and the two- and
four-card tests skip with fewer cards.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pipeline.py

* GPipe (``pipeline="force"``, 4 microbatches) on ``{"pp": 2}`` and
  ``{"pp": 2, "dp": 2}`` with every shard on ``cuda:0`` against the same
  mesh on the CPU: 3 SGD steps' losses within ``rtol 1e-5`` and the
  parameters within ``1e-5``, float32, TF32 off;
* ring attention on ``{"sp": 4}`` with every shard on ``cuda:0``
  against the CPU: logits within ``1e-5``, 2 SGD steps' losses within
  ``rtol 1e-5``;
* a shift over two cards is a peer copy (``Comm.kind == "nccl"``),
  forward and backward equal to the local one; over four cards, GPipe on
  ``{"pp": 2, "dp": 2}`` trains as on one card.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ff
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as build
from flexflow_tpu_torch.parallel.comm import Comm, run_shards

pytestmark = pytest.mark.cuda

TINY = dict(batch=8, seq=16, hidden_dim=32, num_heads=4, ff_dim=64,
            num_layers=4, num_classes=5)
SGD = dict(lr=0.05, momentum=0.9)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _data(kw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(kw["batch"], kw["seq"],
                      kw["hidden_dim"]).astype(np.float32),
            rng.randint(0, kw["num_classes"], kw["batch"]).astype(np.int32))


def _params(m):
    return {n: {p: v.detach().cpu() for p, v in g.items()}
            for n, g in m.params.items()}


def _pipelined(shape, devices, kw=TINY):
    m = build(ff.FFConfig(batch_size=kw["batch"], seed=0, pipeline="force",
                          pipeline_microbatches=4),
              mesh=ff.make_mesh(shape, devices), **kw)
    m.compile(optimizer=ff.SGDOptimizer(**SGD))
    assert m._pipeline is not None
    return m


def _same_training(a, b, x, y, steps=3):
    ha = a.fit(x, y, epochs=steps, shuffle=False, verbose=False)
    hb = b.fit(x, y, epochs=steps, shuffle=False, verbose=False)
    for u, v in zip(ha, hb):
        assert u["loss"] == pytest.approx(v["loss"], rel=1e-5)
    pa, pb = _params(a), _params(b)
    for n, g in pb.items():
        for p, v in g.items():
            np.testing.assert_allclose(pa[n][p].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=f"{n}.{p}")


@pytest.mark.parametrize("shape", [{"pp": 2}, {"pp": 2, "dp": 2}],
                         ids=["pp2", "pp2_dp2"])
def test_gpipe_on_one_card_trains_as_the_cpu(dev, shape):
    n = int(np.prod(list(shape.values())))
    card = _pipelined(shape, [dev] * n)
    cpu = _pipelined(shape, ["cpu"] * n)
    assert card.mesh.comm.kind == "local"
    assert all(v.device == dev for g in card.params.values()
               for v in g.values())
    _same_training(card, cpu, *_data(TINY))


def test_ring_attention_on_one_card_matches_the_cpu(dev):
    kw = dict(TINY, seq=64, num_layers=2, batch=2)
    runs = []
    for d in (dev, "cpu"):
        mesh = ff.make_mesh({"sp": 4}, [d] * 4)
        m = build(ff.FFConfig(batch_size=kw["batch"], seed=0), mesh=mesh,
                  **kw)
        m.compile(optimizer=ff.SGDOptimizer(**SGD),
                  strategy={f"enc{i}_attn": {"sequence": ("sp",)}
                            for i in range(kw["num_layers"])})
        runs.append(m)
    x, y = _data(kw)
    np.testing.assert_allclose(runs[0].forward(x).cpu().numpy(),
                               runs[1].forward(x).numpy(), atol=1e-5)
    _same_training(runs[0], runs[1], x, y, steps=2)


def test_shift_over_two_cards_is_a_peer_copy(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 4, generator=g) for _ in range(2)]

    def run(comm, devs):
        xs = [p.to(d).requires_grad_() for p, d in zip(parts, devs)]

        def gen(x):
            return (yield ("shift", x * 2, ("pp",), 1))

        outs = run_shards([gen(x) for x in xs], comm)
        torch.autograd.backward(outs, [o.detach() for o in outs])
        return [o.cpu() for o in outs], [x.grad.cpu() for x in xs]

    comm = Comm(cards, {"pp": 2})
    assert comm.kind == "nccl"
    got = run(comm, cards)
    want = run(Comm(["cpu"] * 2, {"pp": 2}), ["cpu"] * 2)
    assert comm.calls["nccl"] == 2 and comm.calls["local"] == 0
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_gpipe_over_four_cards_trains_as_one_card(dev):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cards = [torch.device("cuda", i) for i in range(4)]
    spread = _pipelined({"pp": 2, "dp": 2}, cards)
    one = _pipelined({"pp": 2, "dp": 2}, [dev] * 4)
    assert spread.mesh.comm.kind == "nccl"
    _same_training(spread, one, *_data(TINY))
