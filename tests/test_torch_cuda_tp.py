"""Tensor-parallel serving on the card: the kernels at the shard-local
shapes, two shards on one card, and NCCL across two cards.

These tests need an NVIDIA GPU with nvcc; without one each skips, and the
two-card tests skip on a machine with one card.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp.py

* K1, K2 and both K3 layouts at the shapes a shard gives them, in the four
  cache variants, against their plain versions (tolerances as
  ``test_torch_cuda.py``'s: float32 ``2e-5``, bfloat16 ``1e-2``):
  Llama-2-7B at ``tp=2`` (16 query heads on 16 KV heads) and a 70B shape
  (64 query heads on 8 KV heads) at ``tp=4`` (16 query heads on 2 KV
  heads, a group of 8);
* two shards on one card (``["cuda:0", "cuda:0"]``, the local
  collectives) serve a small Llama's greedy streams of ``tp=1``, each
  shard launching its own kernels;
* two cards: NCCL's all-reduce and all-gather equal the local sum and
  concatenation, and ``tp=2`` over ``cuda:0`` and ``cuda:1`` serves the
  streams of ``tp=1``.
"""

import collections

import pytest
import torch

from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.parallel import Comm, make_mesh
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    build_model,
)

from test_torch_cuda import _check_variants

pytestmark = pytest.mark.cuda

# (query heads, KV heads) of one shard
SHARDS = {"7b_tp2": (16, 16), "70b_tp4": (16, 2)}
D = 128


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
        pytest.skip("NCCL across cards needs two CUDA devices; this "
                    "machine has one")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", list(SHARDS))
def test_decode_kernel_at_shard_shapes(dev, dtype, shard):
    qh, kv = SHARDS[shard]
    s, page = 2048, 512
    g = torch.Generator().manual_seed(21)
    q = torch.randn(7, qh, D, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(4, kv, s, D, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 2], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, s - 1, 0, s // 2, page, 0, s - 2],
                       dtype=torch.int32, device=dev)
    _check_variants("decode_attention", dev, dtype, q, kc, vc, page,
                    (rows, pos), (D ** -0.5,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", list(SHARDS))
def test_prefill_kernel_at_shard_shapes(dev, dtype, shard):
    qh, kv = SHARDS[shard]
    s, bq, page = 2048, 128, 512
    g = torch.Generator().manual_seed(22)
    q = torch.randn(3, bq, qh, D, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(4, kv, s, D, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
    pstart = torch.tensor([page - bq, 0, s - bq], dtype=torch.int32,
                          device=dev)
    _check_variants("prefill_attention", dev, dtype, q, kc, vc, page,
                    (rows, pstart), (D ** -0.5,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", list(SHARDS))
def test_tree_kernels_at_shard_shapes(dev, dtype, shard):
    """K3 per token (a scattered flat batch with pads) and batched
    (``[R, P]`` slot-major) at the shard's heads."""
    qh, kv = SHARDS[shard]
    s, p, page, r = 2048, 8, 512, 3
    g = torch.Generator().manual_seed(23)
    rows = [0, 0, 1, 2, 1, 0, 3, 3, 2]
    clens = [5, 5, 0, s, page, 17, 0, 0, s - 1]
    q = torch.randn(len(rows), qh, D, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, D, generator=g).to(dev, dtype)
                      for n in (s, s, p, p))
    amask = torch.rand(len(rows), p, generator=g) < 0.4
    amask[:, 0] = True
    amask[6:8] = False
    _check_variants("tree_attention", dev, dtype, q, kc, vc, page,
                    (sk, sv, torch.tensor(rows, dtype=torch.int32,
                                          device=dev),
                     torch.tensor(clens, dtype=torch.int32, device=dev),
                     amask.to(dev)), (D ** -0.5,))
    qb = torch.randn(r, 7, qh, D, generator=g).to(dev, dtype)
    bmask = torch.rand(r, 7, p, generator=g) < 0.4
    bmask[:, :, 0] = True
    bmask[2] = False
    _check_variants("tree_attention_batched", dev, dtype, qb, kc, vc, page,
                    (sk, sv, torch.tensor([0, 2, 3], dtype=torch.int32,
                                          device=dev),
                     torch.tensor([page + 3, s - 7, 0], dtype=torch.int32,
                                  device=dev), bmask.to(dev)), (D ** -0.5,))


SMALL = ServeModelConfig(vocab_size=96, hidden_size=128,
                         intermediate_size=192, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
PROMPTS = [[3, 11, 25, 40, 7, 9, 2], [2, 4, 6, 8]]


def _serve(where, gen=None):
    im = InferenceManager(build_model(SMALL), max_requests=2,
                          max_tokens_per_batch=64, max_seq_len=256, **where)
    im.init_operators_inference(seed=4)
    return im, RequestManager(im, gen or GenerationConfig(
        max_new_tokens=8)).generate(PROMPTS)


def _shard_launches(im):
    """Each shard's K1 and K2 launches over one generate, booked between
    its collectives."""
    per = [collections.Counter() for _ in im.shards]
    for model, counter in zip(im.shards, per):
        inner = model.forward_gen

        def probed(*args, _inner=inner, _counter=counter, **kw):
            def book(n0):
                _counter["decode"] += att.decode_attention.launches - n0[0]
                _counter["prefill"] += att.prefill_attention.launches - n0[1]

            gen = _inner(*args, **kw)
            reply = None
            while True:
                n0 = (att.decode_attention.launches,
                      att.prefill_attention.launches)
                try:
                    msg = gen.send(reply)
                except StopIteration as stop:
                    book(n0)
                    return stop.value
                book(n0)
                reply = yield msg

        model.forward_gen = probed
    return per


def test_two_shards_on_one_card_serve_like_one(dev):
    _, want = _serve(dict(device=dev))
    im = InferenceManager(build_model(SMALL), max_requests=2,
                          max_tokens_per_batch=64, max_seq_len=256,
                          mesh=make_mesh({"tp": 2}, [dev, dev]))
    im.init_operators_inference(seed=4)
    per = _shard_launches(im)
    got = RequestManager(im, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)
    assert got == want
    assert im.mesh.comm.kind == "local" and im.mesh.comm.calls["nccl"] == 0
    for counter in per:
        assert counter["decode"] > 0 and counter["prefill"] > 0


def test_nccl_collectives_across_two_cards(two_cards):
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(6, 10, generator=g) for _ in range(2)]
    comm = Comm(two_cards)
    assert comm.kind == "nccl"
    local = Comm(["cpu", "cpu"])
    red = comm.all_reduce([p.to(d) for p, d in zip(parts, two_cards)])
    want = local.all_reduce(parts)[0]
    for t, d in zip(red, two_cards):
        assert t.device == d
        torch.testing.assert_close(t.cpu(), want, atol=1e-6, rtol=1e-6)
    full = comm.all_gather([p.to(d) for p, d in zip(parts, two_cards)])
    for t in full:
        assert torch.equal(t.cpu(), torch.cat(parts, dim=-1))
    first = comm.gather([p.to(d) for p, d in zip(parts, two_cards)], dim=0)
    assert torch.equal(first[0].cpu(), torch.cat(parts)) and first[1] is None
    assert comm.calls == {"nccl": 3, "local": 0}


def test_tp2_across_two_cards_serves_like_one(two_cards):
    _, want = _serve(dict(device=two_cards[0]))
    im, got = _serve(dict(mesh=make_mesh({"tp": 2}, two_cards)))
    assert got == want
    assert im.mesh.comm.calls["nccl"] > 0 and im.mesh.comm.calls["local"] == 0
    assert [p.device for p in (next(m.parameters()) for m in im.shards)] \
        == two_cards
