"""Pipeline-parallel serving on the card: two stages on one card, and two
stages on two cards.

These tests need an NVIDIA GPU with nvcc; without one each skips, and the
two-card tests skip on a machine with one card.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pp.py

* a ``pp=2`` mixed step and a tiled prefill step with both stages on one
  card against the same step of the kernels' plain versions on the CPU
  (float32 ``2e-5``, ``test_torch_cuda.py``'s tolerance), each stage
  launching its own layers' K1 and K2; greedy streams equal ``pp=1``'s on
  the card at ``n_micro`` 1 and 2;
* two cards: a kernel whose tensors lie on ``cuda:1`` launches there with
  ``cuda:0`` current (the wrappers make the tensor's device current), and
  ``pp=2`` over ``cuda:0`` and ``cuda:1`` (the hop a device-to-device
  copy) serves the streams of ``pp=1``, each stage's weights, caches and
  launches on its own card.
"""

import pytest
import torch

from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    PipelinedInferenceManager,
    PrefillBatchConfig,
    RequestManager,
    ServeModelConfig,
    build_model,
)

from test_torch_cuda import _check_variants

pytestmark = pytest.mark.cuda

SMALL = ServeModelConfig(vocab_size=96, hidden_size=128,
                         intermediate_size=192, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2)
PROMPTS = [[3, 11, 25, 40, 7, 9, 2], [2, 4, 6, 8]]
CAPS = dict(max_requests=2, max_tokens_per_batch=64, max_seq_len=256)


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
        pytest.skip("stages on two cards need two CUDA devices; this "
                    "machine has one")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _params():
    """Seeded weights drawn on the CPU, so every device holds the same."""
    im = InferenceManager(build_model(SMALL), device="cpu", **CAPS)
    return im.init_operators_inference(seed=4), dict(
        im.model.named_parameters())


def _pim(devices, params, n_micro=None):
    pim = PipelinedInferenceManager(
        build_model(SMALL), mesh=make_mesh({"pp": 2}, devices),
        n_micro=n_micro, **CAPS)
    return pim.init_operators_inference(
        {k: v.to(devices[0]) for k, v in params.items()})


def _stage_launches(pim):
    """Each stage's K1 and K2 launches: wrap each stage model's forward."""
    per = [{"decode": 0, "prefill": 0} for _ in pim.stages]
    for st, counter in zip(pim.stages, per):
        inner = st.shards[0].forward_gen

        def probed(*args, _inner=inner, _counter=counter, **kw):
            n0 = (att.decode_attention.launches,
                  att.prefill_attention.launches)
            out = yield from _inner(*args, **kw)
            _counter["decode"] += att.decode_attention.launches - n0[0]
            _counter["prefill"] += att.prefill_attention.launches - n0[1]
            return out

        st.shards[0].forward_gen = probed
    return per


def test_pp2_steps_on_one_card_match_the_plain_cpu_steps(dev):
    cpu_one, params = _params()
    cpu = _pim(["cpu", "cpu"], params)
    card = _pim([dev, dev], params)
    per = _stage_launches(card)
    args = ([3, 5, 7, 11, 2], [0, 0, 0, 1, 1], [0, 1, 2, 0, 1], [3, 2])
    segs, lens = [(0, list(range(3, 19)), 0)], [16]
    for side in (cpu, card):
        side.reset()
    steps = [
        lambda d: BatchConfig.build(*args, max_tokens=64, max_requests=2,
                                    device=d),
        lambda d: PrefillBatchConfig.build(segs, lens, card.prefill_tile,
                                           max_tokens=64, max_requests=2,
                                           device=d)[0]]
    for build in steps:
        want = cpu.step(build("cpu"))
        got = card.step(build(dev))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.logits.cpu(), want.logits,
                                   atol=2e-5, rtol=2e-5)
    for counter in per:
        assert counter["decode"] > 0 and counter["prefill"] > 0


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pp2_on_one_card_serves_like_pp1(dev, n_micro):
    _, params = _params()
    one = InferenceManager(build_model(SMALL), device=dev, **CAPS)
    one.init_operators_inference({k: v.to(dev) for k, v in params.items()})
    want = RequestManager(one, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)
    pim = _pim([dev, dev], params, n_micro)
    got = RequestManager(pim, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)
    assert got == want


def test_kernel_launches_on_its_tensors_card(two_cards):
    other = two_cards[1]
    assert torch.cuda.current_device() == 0
    g = torch.Generator().manual_seed(6)
    t, r, qh, kv, d, s, page = 7, 3, 4, 2, 32, 128, 64
    q = torch.randn(t, qh, d, generator=g).to(other)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(other)
              for _ in range(2))
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 2], dtype=torch.int32,
                        device=other)
    pos = torch.tensor([5, s - 1, 0, s // 2, page, 0, s - 2],
                       dtype=torch.int32, device=other)
    _check_variants("decode_attention", other, torch.float32, q, kc, vc,
                    page, (rows, pos), (d ** -0.5,))


def test_pp2_across_two_cards_serves_like_pp1(two_cards):
    _, params = _params()
    one = InferenceManager(build_model(SMALL), device=two_cards[0], **CAPS)
    one.init_operators_inference(
        {k: v.to(two_cards[0]) for k, v in params.items()})
    want = RequestManager(one, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)
    pim = _pim(two_cards, params)
    per = _stage_launches(pim)
    got = RequestManager(pim, GenerationConfig(max_new_tokens=8)).generate(
        PROMPTS)
    assert got == want
    for st, card, counter in zip(pim.stages, two_cards, per):
        assert {p.device for p in st.shards[0].parameters()} == {card}
        assert {b["k"].device for b in st.state.values()} == {card}
        assert counter["decode"] > 0 and counter["prefill"] > 0
