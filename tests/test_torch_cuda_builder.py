"""Builder graphs served on the card, and the frontends on the card,
against the same code on the CPU (``chip_smoke.py`` phase 26 at full
width).

These tests need an NVIDIA GPU with nvcc; without one each skips.  This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_builder.py

* ``InferenceManager(ff)`` over a builder Llama (``build_model(ff, cfg,
  T)``, 2 layers, float32, TF32 off): the card's step logits equal the
  CPU's plain versions within ``1e-4`` and the greedy streams are equal,
  through K1 and K2;
* a ``tree_inc_...`` target and a ``spec_inc_...`` draft through
  ``SpecInferManager`` and ``SpecDecodeScan``: the incremental streams,
  through both K3 layouts;
* ``from_torch`` of a transformer block: the card's forward equals the
  module's within ``1e-4``; a Keras ``Sequential`` CNN's loss falls over
  one epoch on the card.
"""

import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu_torch as T
from flexflow_tpu_torch.frontends import from_torch, keras
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    SpecDecodeScan,
    SpecInferManager,
    build_model,
)

pytestmark = pytest.mark.cuda

CFG = ServeModelConfig(vocab_size=512, hidden_size=256,
                       intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2)
DRAFT = ServeModelConfig(vocab_size=512, hidden_size=128,
                         intermediate_size=256, num_hidden_layers=1,
                         num_attention_heads=2)
PROMPTS = [[(7 * i + r) % 500 + 3 for i in range(n)]
           for r, n in enumerate((30, 9, 20))]
KW = dict(max_requests=4, max_tokens_per_batch=64, max_seq_len=256)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _builder_im(cfg, device, attention="inc_multihead_self_attention",
                weights=None, **kw):
    ff = T.FFModel(T.FFConfig(), device=device)
    build_model(ff, cfg, KW["max_tokens_per_batch"], attention=attention)
    im = InferenceManager(ff, device=device, **{**KW, **kw})
    if weights is None:
        return im.init_operators_inference(seed=5)
    return im.init_operators_inference(
        {k: v.to(device) for k, v in weights.items()})


def _weights(im):
    return {k: v.detach().cpu() for k, v in im.model.named_parameters()}


def test_builder_llama_on_the_card_serves_like_the_cpu(dev):
    cpu = _builder_im(CFG, "cpu")
    card = _builder_im(CFG, dev, weights=_weights(cpu))
    bc = dict(max_tokens=64, max_requests=4)
    args = (PROMPTS[1], [0] * 9, list(range(9)), [9])
    np.testing.assert_allclose(
        card.forward(BatchConfig.build(*args, device=dev, **bc)).cpu(),
        cpu.forward(BatchConfig.build(*args, device="cpu", **bc)),
        atol=1e-4, rtol=1e-4)
    cpu.reset()
    card.reset()
    gen = GenerationConfig(max_new_tokens=12)
    want = RequestManager(cpu, gen).generate(PROMPTS)
    n0 = (att.decode_attention.launches, att.prefill_attention.launches)
    got = RequestManager(card, gen).generate(PROMPTS)
    assert got == want
    assert att.decode_attention.launches > n0[0]
    assert att.prefill_attention.launches > n0[1]


def test_tree_target_and_spec_draft_on_the_card(dev):
    # one slot a prompt: the device loop's carry spans every slot
    llm = _builder_im(CFG, dev, "tree_inc_multihead_self_attention",
                      max_spec_tokens=8, max_requests=3)
    ssm = _builder_im(DRAFT, dev, "spec_inc_multihead_self_attention",
                      max_spec_tokens=8, topk=2, max_requests=3)
    gen = GenerationConfig(max_new_tokens=12)
    want = RequestManager(llm, gen).generate(PROMPTS)
    llm.reset()
    n0 = att.tree_attention.launches
    got = SpecInferManager(llm, ssm, gen, width=2, depth=2).generate(PROMPTS)
    assert got == want and att.tree_attention.launches > n0
    llm.reset()
    ssm.reset()
    firsts = []
    for im in (llm, ssm):
        toks, reqi, pos = [], [], []
        for r, p in enumerate(PROMPTS):
            toks += p
            reqi += [r] * len(p)
            pos += list(range(len(p)))
        ids = im.step(BatchConfig.build(
            toks, reqi, pos, [len(p) for p in PROMPTS], max_tokens=64,
            max_requests=3, device=dev)).token_ids.cpu()
        ends = np.cumsum([len(p) for p in PROMPTS]) - 1
        firsts.append([int(ids[e]) for e in ends])
    lens = [len(p) for p in PROMPTS]
    sc = SpecDecodeScan(llm, ssm, width=2, depth=2)
    n0 = att.tree_attention_batched.launches
    em, _ = sc.run(sc.init_carry(firsts[0], lens, lens, [False] * 3), 11)
    em = em.cpu().numpy()
    scanned = [[firsts[0][r]] + [int(t) for t in em[:, r].reshape(-1)
                                 if t >= 0] for r in range(3)]
    assert [s[:12] for s in scanned] == want
    assert att.tree_attention_batched.launches > n0


class Block(nn.Module):
    def __init__(self, e=64, h=4, ff=128):
        super().__init__()
        self.ln1 = nn.LayerNorm(e)
        self.attn = nn.MultiheadAttention(e, h, batch_first=True)
        self.ln2 = nn.LayerNorm(e)
        self.fc1 = nn.Linear(e, ff)
        self.fc2 = nn.Linear(ff, e)

    def forward(self, x):
        a = self.ln1(x)
        att_out, _ = self.attn(a, a, a)
        x = x + att_out
        return x + self.fc2(torch.relu(self.fc1(self.ln2(x))))


def test_frontends_on_the_card(dev):
    torch.manual_seed(0)
    mod = Block().eval()
    x = np.random.RandomState(0).randn(4, 16, 64).astype(np.float32)
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    model, outs, weights = from_torch(mod, [x.shape], device=dev)
    model.compile(outputs=outs, loss_type="identity")
    model.load_params(weights)
    got = model.forward(x)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-4,
                               rtol=1e-4)
    xs, ys = cnn_data(256)
    m = keras.Sequential([
        keras.Conv2D(8, 3, padding="same", activation="relu",
                     input_shape=(1, 28, 28)),
        keras.MaxPooling2D(2), keras.Flatten(),
        keras.Dense(10, activation="softmax")], device=dev)
    m.compile(optimizer="adam", batch_size=32)
    before = m.evaluate(xs, ys)["loss"]
    m.fit(xs, ys, epochs=1, batch_size=32, verbose=False)
    assert m.evaluate(xs, ys)["loss"] < before
    assert m.model.device.type == "cuda"


def cnn_data(n, seed=0):
    """28x28 single-channel images and the class a fixed random linear
    map of each image scores highest: a task one epoch learns."""
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 1, 28, 28).astype(np.float32)
    ys = np.argmax(xs.reshape(n, -1) @ rng.randn(28 * 28, 10), axis=1)
    return xs, ys.astype(np.int32)
