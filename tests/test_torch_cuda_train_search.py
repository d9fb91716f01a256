"""The training planner on the card: measured op costs, their cache, and
a searched model training there (``chip_smoke.py`` phase 23 in small).

These tests need an NVIDIA GPU; without one each skips.  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_search.py

* ``measure_operator_cost`` gives positive times that repeat within 2x
  (device time, ``search/measure.py:time_fn``), and a cached key returns
  its cached time without measuring;
* measuring a node of a compiled model leaves the op's parameters and
  the model's weights as they were, and the model still trains;
* ``calibrate_standard_probes`` writes a ``CostCache`` that reads back
  equal, with every probe's key;
* a 2-layer classifier compiled with ``search_budget`` on a ``{"dp": 2,
  "tp": 2}`` mesh of shards on the one card adopts the same rewritten
  graph and dict as on a CPU mesh priced as the card (the ``h100``
  spec) and trains 3 Adam steps to the CPU's losses within phase
  21(a)'s ``rtol 1e-4``; float32, TF32 off.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ff
from flexflow_tpu_torch.core.graph import TensorSpec
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as build
from flexflow_tpu_torch.ops.linear import Linear
from flexflow_tpu_torch.search import machine_model, measure

pytestmark = pytest.mark.cuda

TINY = dict(batch=8, seq=16, hidden_dim=32, num_heads=4, ff_dim=64,
            num_layers=2, num_classes=5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_measure_operator_cost_is_positive_and_repeats(dev, tmp_path):
    spec = [TensorSpec((256, 1024))]
    times = [measure.measure_operator_cost(
        Linear(1024, 1024, device="meta", use_bias=True), spec, device=dev)
        for _ in range(2)]
    assert all(0 < t < 1e-2 for t in times)
    assert max(times) / min(times) < 2.0, times
    cache = measure.CostCache(str(tmp_path / "c.json"))
    op = Linear(1024, 1024, device="meta", use_bias=True)
    t = measure.measure_operator_cost(op, spec, cache, device=dev)
    key = (op.attr_signature(), ((256, 1024),))
    assert cache[key] == t
    cache.put(key, 123.0)
    assert measure.measure_operator_cost(op, spec, cache, device=dev) == 123.0


def test_measuring_a_node_leaves_the_model_alone(dev):
    m = build(ff.FFConfig(batch_size=TINY["batch"], seed=0),
              mesh=ff.make_mesh({"dp": 2, "tp": 2}, [dev] * 4), **TINY)
    m.compile(optimizer=ff.AdamOptimizer(alpha=1e-3))
    before = {n: {p: v.detach().clone() for p, v in g.items()}
              for n, g in m.params.items()}
    node = next(n for n in m.graph.nodes if n.op.type_name == "linear")
    own = dict(node.op.named_parameters())
    t = measure.measure_operator_cost(
        node.op, [m.graph.spec(i) for i in node.inputs], device=dev)
    assert 0 < t < 1e-2
    assert all(p is own[k] for k, p in node.op.named_parameters())
    for n, g in m.params.items():
        for p, v in g.items():
            assert torch.equal(v, before[n][p]), (n, p)
    rng = np.random.RandomState(0)
    x = rng.randn(TINY["batch"], TINY["seq"],
                  TINY["hidden_dim"]).astype(np.float32)
    y = rng.randint(0, TINY["num_classes"], TINY["batch"]).astype(np.int32)
    m.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert not all(torch.equal(v, before[n][p])
                   for n, g in m.params.items() for p, v in g.items())


def test_cost_cache_round_trips_the_probes(dev, tmp_path):
    path = str(tmp_path / "probes.json")
    cache = measure.calibrate_standard_probes(path, device=dev)
    again = measure.CostCache(path)
    assert again.data == cache.data
    for _, op, specs in measure.standard_probes():
        key = (op.attr_signature(), tuple(tuple(s.shape) for s in specs))
        assert key in again and again[key] > 0


def test_searched_model_trains_on_the_card_as_on_the_cpu(dev, monkeypatch):
    # the CPU mesh priced as the card's, so both walks are one walk
    monkeypatch.setitem(machine_model.DEVICE_SPECS, "cpu", "h100")
    rng = np.random.RandomState(0)
    x = rng.randn(TINY["batch"], TINY["seq"],
                  TINY["hidden_dim"]).astype(np.float32)
    y = rng.randint(0, TINY["num_classes"], TINY["batch"]).astype(np.int32)
    runs = []
    for devices in (["cpu"] * 4, [dev] * 4):
        m = build(ff.FFConfig(batch_size=TINY["batch"], seed=0,
                              search_budget=120),
                  mesh=ff.make_mesh({"dp": 2, "tp": 2}, devices), **TINY)
        m.compile(optimizer=ff.AdamOptimizer(alpha=1e-3))
        if runs:
            m.load_params(runs[0][1])
        init = {n: {p: v.detach().cpu().clone() for p, v in g.items()}
                for n, g in m.params.items()}
        hist = m.fit(x, y, epochs=3, shuffle=False, verbose=False)
        runs.append((m, init, [h["loss"] for h in hist]))
    (cpu, _, lc), (card, _, lg) = runs
    assert [n.name for n in card.graph.nodes] == \
        [n.name for n in cpu.graph.nodes]
    assert len(card.graph.nodes) < 7 * TINY["num_layers"] + 3   # fused
    assert card.strategy == cpu.strategy
    assert all(p.device.type == "cuda" for g in card.params.values()
               for p in g.values())
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
