"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU with nvcc; without one each skips.  This
file imports no JAX (the card's machine has none), so run it there with
the JAX conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 kernels agree with the float32 plain versions to
``atol=rtol=2e-5`` (same math, another summation order); bfloat16 outputs
are rounded to bfloat16 by both sides, so they may differ by one
bfloat16 step (2**-8 relative): ``atol=rtol=1e-2``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    build_model,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s", [
    (4, 2, 8, 40),       # GQA, tiny head dim, S not a multiple of anything
    (4, 4, 16, 64),      # MHA
    (8, 1, 16, 64),      # MQA (8 query heads per KV head)
    (32, 8, 128, 300),   # GQA at the 7B/70B head dim
    (32, 32, 128, 2048),  # Llama-2-7B attention shape
    (16, 16, 64, 256),
])
def test_decode_kernel_matches_plain(dev, dtype, qh, kv, d, s):
    g = torch.Generator().manual_seed(0)
    t, r = 7, 3
    q = torch.randn(t, qh, d, generator=g).to(dev, dtype)
    kc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
    vc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 2], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, s - 1, 0, s // 2, 1, 0, s - 2], dtype=torch.int32,
                       device=dev)
    n0 = att.decode_attention.launches
    got = att.decode_attention(q, kc, vc, rows, pos, d ** -0.5)
    torch.cuda.synchronize()
    assert att.decode_attention.launches == n0 + 1
    want = att.decode_attention_plain(q, kc, vc, rows, pos, d ** -0.5)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,bq", [
    (4, 2, 8, 64, 8),       # GQA, several tiles
    (4, 4, 16, 32, 4),      # MHA
    (8, 1, 16, 64, 16),     # MQA: 128 folded rows, two row chunks
    (32, 32, 128, 2048, 128),  # Llama-2-7B shape, tile 128
    (32, 8, 128, 384, 64),
    (16, 16, 64, 256, 32),
])
def test_prefill_kernel_matches_plain(dev, dtype, qh, kv, d, s, bq):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, bq, qh, d, generator=g).to(dev, dtype)
    kc = torch.randn(4, kv, s, d, generator=g).to(dev, dtype)
    vc = torch.randn(4, kv, s, d, generator=g).to(dev, dtype)
    rows = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
    pstart = torch.tensor([5, 0, s - bq], dtype=torch.int32, device=dev)
    n0 = att.prefill_attention.launches
    got = att.prefill_attention(q, kc, vc, rows, pstart, d ** -0.5)
    torch.cuda.synchronize()
    assert att.prefill_attention.launches == n0 + 1
    want = att.prefill_attention_plain(q, kc, vc, rows, pstart, d ** -0.5)
    _close(got, want, dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(2, 4, 16, device=dev)
    kc = torch.randn(2, 2, 32, 16, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):      # float16 is not built
        att.decode_attention(q.half(), kc.half(), kc.half(), idx, idx, 1.0)
    q24, kc24 = torch.randn(2, 4, 24, device=dev), torch.randn(
        2, 2, 32, 24, device=dev)
    with pytest.raises(ValueError):     # head dim 24 is not built
        att.decode_attention(q24, kc24, kc24, idx, idx, 1.0)
    with pytest.raises(ValueError):     # non-contiguous query
        att.decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                             kc, kc, idx, idx, 1.0)
    with pytest.raises(ValueError):     # int64 index arrays
        att.decode_attention(q, kc, kc, idx.long(), idx, 1.0)
    with pytest.raises(ValueError):     # tensors on two devices
        att.decode_attention(q.cpu(), kc, kc, idx, idx, 1.0)


SMALL = ServeModelConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2)


def test_serving_on_card_matches_cpu(dev):
    """A small float32 model serves the same greedy tokens on the card
    (kernels) as on the CPU (plain versions), logits within 1e-4."""
    cpu = InferenceManager(build_model(SMALL), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=64,
                           device="cpu").init_operators_inference(seed=3)
    gpu = InferenceManager(build_model(SMALL), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=64,
                           device=dev)
    gpu.init_operators_inference(dict(cpu.model.named_parameters()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 97, size=n).tolist() for n in (5, 19, 3)]
    n0 = (att.decode_attention.launches, att.prefill_attention.launches)
    want = RequestManager(cpu, GenerationConfig(max_new_tokens=8)).generate(
        prompts)
    got = RequestManager(gpu, GenerationConfig(max_new_tokens=8)).generate(
        prompts)
    assert got == want
    assert att.decode_attention.launches > n0[0]
    assert att.prefill_attention.launches > n0[1]
    # one more prefill step on fresh caches: logits agree
    from flexflow_tpu_torch.serve import PrefillBatchConfig

    cpu.reset()
    gpu.reset()
    pbc, _ = PrefillBatchConfig.build([(0, prompts[0], 0)], [5], 16,
                                      max_tokens=16, max_requests=2,
                                      device="cpu")
    pbc_gpu = dataclasses.replace(pbc, base=dataclasses.replace(
        pbc.base, **{f.name: getattr(pbc.base, f.name).to(dev)
                     for f in dataclasses.fields(pbc.base)}))
    torch.testing.assert_close(gpu.forward(pbc_gpu).cpu(), cpu.forward(pbc),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,p", [
    (4, 2, 8, 40, 8),        # GQA, tiny head dim
    (4, 4, 16, 64, 8),       # MHA
    (8, 1, 16, 64, 16),      # MQA, deeper tree buffer
    (32, 32, 128, 2048, 8),  # Llama-2-7B verify shape
    (12, 12, 64, 300, 8),    # llama-68m draft shape
    (32, 8, 128, 300, 70),   # spec buffer longer than a key block
])
def test_tree_kernel_matches_plain(dev, dtype, qh, kv, d, s, p):
    g = torch.Generator().manual_seed(2)
    r = 3
    rows = [0, 0, 1, 2, 1, 0, 3, 3, 2]        # 3 = the scratch row
    clens = [5, 5, 0, s, 0, 17, 0, 0, s - 1]
    t = len(rows)
    q = torch.randn(t, qh, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    sk, sv = (torch.randn(r + 1, kv, p, d, generator=g).to(dev, dtype)
              for _ in range(2))
    amask = torch.rand(t, p, generator=g) < 0.4
    amask[:, 0] = True
    amask[6:8] = False                        # pads: no live key at all
    args = (q, kc, vc, sk, sv,
            torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(clens, dtype=torch.int32, device=dev),
            amask.to(dev), d ** -0.5)
    n0 = att.tree_attention.launches
    got = att.tree_attention(*args)
    torch.cuda.synchronize()
    assert att.tree_attention.launches == n0 + 1
    _close(got, att.tree_attention_plain(*args), dtype)
    assert not got[6:8].float().abs().sum()   # zeros, not NaN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,p,pb", [
    (4, 2, 8, 32, 4, 8),        # GQA, tree smaller than buffer
    (8, 1, 16, 64, 7, 8),       # MQA: 56 folded rows, 64-row chunk
    (32, 32, 128, 2048, 7, 8),  # Llama-2-7B verify: 7 rows, 16-row chunk
    (32, 8, 128, 300, 7, 8),    # GQA: 28 folded rows
    (4, 1, 32, 100, 20, 80),    # 80 folded rows: two chunks, two spec blocks
])
def test_batched_tree_kernel_matches_plain(dev, dtype, qh, kv, d, s, p, pb):
    g = torch.Generator().manual_seed(3)
    r = 3
    q = torch.randn(r, p, qh, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    sk, sv = (torch.randn(r + 1, kv, pb, d, generator=g).to(dev, dtype)
              for _ in range(2))
    amask = torch.rand(r, p, pb, generator=g) < 0.4
    amask[:, :, 0] = True
    amask[2] = False            # the scratch-row pad request: no live key
    args = (q, kc, vc, sk, sv,
            torch.tensor([0, 2, 3], dtype=torch.int32, device=dev),
            torch.tensor([7, s, 0], dtype=torch.int32, device=dev),
            amask.to(dev), d ** -0.5)
    n0 = att.tree_attention_batched.launches
    got = att.tree_attention_batched(*args)
    torch.cuda.synchronize()
    assert att.tree_attention_batched.launches == n0 + 1
    _close(got, att.tree_attention_batched_plain(*args), dtype)
    assert not got[2].float().abs().sum()


SMALL_SSM = ServeModelConfig(vocab_size=97, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=1,
                             num_attention_heads=2)


def test_spec_serving_on_card_matches_incremental(dev):
    """Greedy speculative serving in float32 on the card, host loop and
    device loop, equals incremental decoding on the card and the host
    loop on the CPU; both tree kernels launch."""
    from flexflow_tpu_torch.serve import (
        BatchConfig,
        SpecDecodeScan,
        SpecInferManager,
    )

    def pair(cfg, seed, topk):
        kw = dict(max_requests=2, max_tokens_per_batch=32, max_seq_len=96,
                  max_spec_tokens=8, topk=topk)
        cpu = InferenceManager(build_model(cfg), device="cpu",
                               **kw).init_operators_inference(seed=seed)
        gpu = InferenceManager(build_model(cfg), device=dev, **kw)
        gpu.init_operators_inference(dict(cpu.model.named_parameters()))
        return cpu, gpu

    llm_c, llm_g = pair(SMALL, 3, 0)
    ssm_c, ssm_g = pair(SMALL_SSM, 4, 2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 97, size=n).tolist() for n in (5, 19, 3)]
    gen = GenerationConfig(max_new_tokens=10)
    want = RequestManager(llm_g, gen).generate(prompts)
    llm_g.reset()
    n0 = att.tree_attention.launches
    got = SpecInferManager(llm_g, ssm_g, gen, width=2, depth=3).generate(
        prompts)
    assert att.tree_attention.launches > n0
    assert got == want
    assert SpecInferManager(llm_c, ssm_c, gen, width=2,
                            depth=3).generate(prompts) == want

    llm_g.reset()
    ssm_g.reset()
    lens = [len(p) for p in prompts[:2]]
    bc = BatchConfig.build(prompts[0] + prompts[1], [0] * lens[0] + [1] *
                           lens[1], list(range(lens[0])) +
                           list(range(lens[1])), lens, max_tokens=32,
                           max_requests=2, device=dev)
    ssm_g.step(bc)
    ids = llm_g.step(bc).token_ids.cpu().tolist()
    firsts = [ids[lens[0] - 1], ids[sum(lens) - 1]]
    sc = SpecDecodeScan(llm_g, ssm_g, width=2, depth=3)
    carry = sc.init_carry(firsts, lens, lens, [False, False],
                          budget=[9, 9])
    n0 = att.tree_attention_batched.launches
    em, _ = sc.run(carry, 9)
    assert att.tree_attention_batched.launches > n0
    em = em.cpu().numpy()
    scan = [[firsts[r]] + [int(t) for t in em[:, r].reshape(-1) if t >= 0]
            for r in range(2)]
    assert scan == want[:2]
