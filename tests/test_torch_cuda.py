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


# ---------------------------------------------------------------------------
# int8 and paged variants: each against its plain version, and the paged
# kernel bit for bit equal to the contiguous one on the same logical cache
# ---------------------------------------------------------------------------
def _variants(kc, vc, page, seed):
    """{variant: (k, v, cache kwargs)} of one logical fp cache: fp,
    int8 (``kv_quant`` of it), and both paged through a shuffled table."""
    from flexflow_tpu_torch.serve.ops import kv_quant

    r1, _, s = kc.shape[:3]
    table = torch.randperm(r1 * (s // page), generator=torch.Generator()
                           .manual_seed(seed)).reshape(r1, -1).int()
    table = table.to(kc.device)
    kq, ks = kv_quant(kc)
    vq, vs = kv_quant(vc)

    def paged(*ts):
        return [att.page_layout(t, table, page) for t in ts]

    pk, pv = paged(kc, vc)
    pkq, pvq, pks, pvs = paged(kq, vq, ks, vs)
    return {
        "fp": (kc, vc, {}),
        "int8": (kq, vq, dict(k_scale=ks, v_scale=vs)),
        "paged": (pk, pv, dict(page_table=table, page_size=page)),
        "int8+paged": (pkq, pvq, dict(k_scale=pks, v_scale=pvs,
                                      page_table=table, page_size=page)),
    }


def _check_variants(name, dev, dtype, q, kc, vc, page, extra, tail,
                    slopes=None):
    """Each variant's kernel vs its plain version (counted as that
    variant; with ``slopes``, its ALiBi twin), and paged == contiguous
    exactly, fp and int8."""
    fn, plain = getattr(att, name), getattr(att, name + "_plain")
    got = {}
    for var, (k, v, kw) in _variants(kc, vc, page, 5).items():
        args = (q, k, v, *extra, *tail)
        if slopes is not None:
            kw = dict(kw, slopes=slopes)
        key = var if slopes is None else f"{var}+alibi"
        n0 = fn.variant_launches[key]
        got[var] = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.variant_launches[key] == n0 + 1
        _close(got[var], plain(*args, **kw), dtype)
    assert torch.equal(got["paged"], got["fp"])
    assert torch.equal(got["int8+paged"], got["int8"])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,page", [
    (4, 2, 8, 128, 64),         # GQA, D = 8: 8-byte int8 loads
    (8, 1, 16, 256, 64),        # MQA: 8 values per int8 lane
    (32, 8, 128, 384, 128),     # GQA at the 7B/70B head dim
    (32, 32, 128, 2048, 512),   # Llama-2-7B attention shape
])
def test_decode_kernel_variants(dev, dtype, qh, kv, d, s, page):
    g = torch.Generator().manual_seed(6)
    t, r = 7, 3
    q = torch.randn(t, qh, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 2], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, s - 1, 0, s // 2, page, 0, s - 2],
                       dtype=torch.int32, device=dev)
    _check_variants("decode_attention", dev, dtype, q, kc, vc, page,
                    (rows, pos), (d ** -0.5,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,bq,page", [
    (4, 2, 8, 128, 8, 64),
    (8, 1, 16, 256, 16, 128),       # 128 folded rows: two row chunks
    (32, 32, 128, 2048, 128, 512),  # Llama-2-7B shape, tile 128
])
def test_prefill_kernel_variants(dev, dtype, qh, kv, d, s, bq, page):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(3, bq, qh, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(4, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
    pstart = torch.tensor([page - bq, 0, s - bq], dtype=torch.int32,
                          device=dev)
    _check_variants("prefill_attention", dev, dtype, q, kc, vc, page,
                    (rows, pstart), (d ** -0.5,))


@pytest.mark.parametrize("d", att.HEAD_DIMS)
def test_prefill_kernel_ragged_edges(dev, d):
    """The bf16 tensor-core K2 at ragged edges, in the four variants: 3
    query heads per KV head and Bq 40 (120 folded rows: a full and a part
    64-row chunk), pstart off the 64-key grid, a causal frontier inside a
    block, the last tile ending at S - 1 of 2048."""
    g = torch.Generator().manual_seed(11)
    qh, kv, s, bq, page = 12, 4, 2048, 40, 512
    q = torch.randn(3, bq, qh, d, generator=g).to(dev, torch.bfloat16)
    kc, vc = (torch.randn(4, kv, s, d, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    rows = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
    pstart = torch.tensor([100, 0, s - bq], dtype=torch.int32, device=dev)
    _check_variants("prefill_attention", dev, torch.bfloat16, q, kc, vc,
                    page, (rows, pstart), (d ** -0.5,))


@pytest.mark.parametrize("s", [256, 2048])   # one split; eight splits
def test_batched_tree_kernel_split_boundaries(dev, s):
    """The bf16 split-KV K3 batched layout with committed lengths at the
    block and split boundaries (0, 1, 63, 64, 65, S - 1), and a pad
    request with no live key (zeros), in the four variants."""
    g = torch.Generator().manual_seed(12)
    qh, kv, d, p, pb, page = 8, 4, 128, 7, 8, 64
    clens = [0, 1, 63, 64, 65, s - 1, 0]
    r = len(clens)
    q = torch.randn(r, p, qh, d, generator=g).to(dev, torch.bfloat16)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(
        dev, torch.bfloat16) for n in (s, s, pb, pb))
    amask = torch.rand(r, p, pb, generator=g) < 0.4
    amask[:, :, 0] = True
    amask[-1] = False                 # the pad request: no live key at all
    rows = torch.tensor(list(range(r - 1)) + [r], dtype=torch.int32,
                        device=dev)
    got = _check_variants(
        "tree_attention_batched", dev, torch.bfloat16, q, kc, vc, page,
        (sk, sv, rows, torch.tensor(clens, dtype=torch.int32, device=dev),
         amask.to(dev)), (d ** -0.5,))
    for out in got.values():
        assert not out[-1].float().abs().sum()   # zeros, not NaN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,p,page", [
    (4, 2, 8, 128, 8, 64),
    (8, 1, 16, 256, 16, 64),
    (32, 32, 128, 2048, 8, 512),   # Llama-2-7B verify shape
    (12, 12, 64, 256, 8, 128),     # llama-68m draft shape
])
def test_tree_kernel_variants(dev, dtype, qh, kv, d, s, p, page):
    g = torch.Generator().manual_seed(8)
    r = 3
    rows = [0, 0, 1, 2, 1, 0, 3, 3, 2]
    clens = [5, 5, 0, s, page, 17, 0, 0, s - 1]
    t = len(rows)
    q = torch.randn(t, qh, d, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(dev, dtype)
                      for n in (s, s, p, p))
    amask = torch.rand(t, p, generator=g) < 0.4
    amask[:, 0] = True
    amask[6:8] = False
    _check_variants("tree_attention", dev, dtype, q, kc, vc, page,
                    (sk, sv, torch.tensor(rows, dtype=torch.int32,
                                          device=dev),
                     torch.tensor(clens, dtype=torch.int32, device=dev),
                     amask.to(dev)), (d ** -0.5,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,p,pb,page", [
    (4, 2, 8, 128, 4, 8, 64),
    (8, 1, 16, 256, 7, 8, 128),       # 56 folded rows, 64-row chunk
    (32, 32, 128, 2048, 7, 8, 512),   # Llama-2-7B verify: 16-row chunk
    (4, 1, 32, 128, 20, 80, 64),      # two chunks, two spec blocks
])
def test_batched_tree_kernel_variants(dev, dtype, qh, kv, d, s, p, pb, page):
    g = torch.Generator().manual_seed(9)
    r = 3
    q = torch.randn(r, p, qh, d, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(dev, dtype)
                      for n in (s, s, pb, pb))
    amask = torch.rand(r, p, pb, generator=g) < 0.4
    amask[:, :, 0] = True
    amask[2] = False
    _check_variants("tree_attention_batched", dev, dtype, q, kc, vc, page,
                    (sk, sv, torch.tensor([0, 2, 3], dtype=torch.int32,
                                          device=dev),
                     torch.tensor([7, s, 0], dtype=torch.int32, device=dev),
                     amask.to(dev)), (d ** -0.5,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qh,kv,d,s,page", [
    (4, 2, 8, 128, 64),
    (12, 1, 64, 256, 64),       # 12 heads on one KV head: a masked chunk
    (32, 32, 128, 2048, 512),   # MPT-7B attention shape
])
def test_decode_kernel_alibi_variants(dev, dtype, qh, kv, d, s, page):
    """K1 with ALiBi slopes in the four cache variants vs its plain
    version; ALiBi + paged == ALiBi + contiguous bit for bit."""
    from flexflow_tpu_torch.serve import alibi_slopes

    g = torch.Generator().manual_seed(10)
    t, r = 7, 3
    q = torch.randn(t, qh, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 1, 2, 1, 0, 3, 2], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, s - 1, 0, s // 2, page, 0, s - 2],
                       dtype=torch.int32, device=dev)
    _check_variants("decode_attention", dev, dtype, q, kc, vc, page,
                    (rows, pos), (d ** -0.5,),
                    slopes=alibi_slopes(qh, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gq", [1, 2, 4, 8, 12, 48, 71])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernel_any_group(dev, dtype, gq, d):
    """Any number of query heads per KV head (Falcon-7B: 71 at D = 64,
    StarCoder: 48 at D = 128), contiguous and paged, with and without
    ALiBi."""
    from flexflow_tpu_torch.serve import alibi_slopes

    g = torch.Generator().manual_seed(gq)
    kv, s, page = (1, 256, 64) if gq > 8 else (2, 256, 64)
    q = torch.randn(5, kv * gq, d, generator=g).to(dev, dtype)
    kc, vc = (torch.randn(3, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    rows = torch.tensor([0, 1, 2, 0, 1], dtype=torch.int32, device=dev)
    pos = torch.tensor([0, 100, 0, s - 1, 64], dtype=torch.int32, device=dev)
    for slopes in (None, alibi_slopes(kv * gq, dev)):
        _check_variants("decode_attention", dev, dtype, q, kc, vc, page,
                        (rows, pos), (d ** -0.5,), slopes=slopes)


@pytest.mark.parametrize("gq,d", [(3, 128), (48, 128), (71, 64)])
def test_decode_kernel_row_groups(dev, gq, d):
    """The bf16 row-grouped K1 where its row plan and splits have edges,
    in the four variants, with and without ALiBi: 100 prompt tokens of one
    row at consecutive positions (an ALiBi prefill), tokens of other rows
    scattered through the batch at positions on the block and split
    boundaries of S = 2048, pads on the scratch row."""
    from flexflow_tpu_torch.serve import alibi_slopes

    g = torch.Generator().manual_seed(20 + gq)
    kv, s, r, page = (2 if gq == 3 else 1), 2048, 5, 512
    bounds = [0, 63, 64, 255, 256, 257, 511, 512, s - 1]
    rows = [0] * 100 + [1 + i % 4 for i in range(len(bounds))] + [r] * 20
    pos = list(range(1500, 1600)) + bounds + [0] * 20
    order = torch.randperm(len(rows), generator=g)
    rows = torch.tensor(rows, dtype=torch.int32)[order].to(dev)
    pos = torch.tensor(pos, dtype=torch.int32)[order].to(dev)
    q = torch.randn(len(order), kv * gq, d, generator=g).to(dev,
                                                           torch.bfloat16)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    for slopes in (None, alibi_slopes(kv * gq, dev)):
        _check_variants("decode_attention", dev, torch.bfloat16, q, kc, vc,
                        page, (rows, pos), (d ** -0.5,), slopes=slopes)


@pytest.mark.parametrize("gq", [1, 4])
def test_tree_kernel_row_groups(dev, gq):
    """The bf16 row-grouped K3 per-token kernel, in the four variants:
    requests of a 7-token tree scattered through the batch at committed
    depths on the block and split boundaries, one request with 70 tokens
    (two 64-row chunks at gq 1), pads (scratch row, depth 0, empty mask)
    giving zeros."""
    g = torch.Generator().manual_seed(30 + gq)
    kv, s, p, r, d, page = 2, 2048, 8, 6, 128, 512
    depth = [0, 1, 63, 257, s]
    rows = [i // 7 for i in range(35)] + [5] * 70 + [r] * 10
    clens = [depth[i // 7] for i in range(35)] + [1000] * 70 + [0] * 10
    order = torch.randperm(len(rows), generator=g)
    rows = torch.tensor(rows, dtype=torch.int32)[order].to(dev)
    clens = torch.tensor(clens, dtype=torch.int32)[order].to(dev)
    t = len(order)
    q = torch.randn(t, kv * gq, d, generator=g).to(dev, torch.bfloat16)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(
        dev, torch.bfloat16) for n in (s, s, p, p))
    amask = torch.rand(t, p, generator=g) < 0.4
    amask[:, 0] = True
    pads = rows.cpu() == r
    amask[pads] = False
    got = _check_variants("tree_attention", dev, torch.bfloat16, q, kc, vc,
                          page, (sk, sv, rows, clens, amask.to(dev)),
                          (d ** -0.5,))
    for out in got.values():
        assert not out[pads.to(dev)].float().abs().sum()


@pytest.mark.parametrize("gq,d", [(1, 128), (3, 128), (8, 64), (48, 128),
                                  (71, 64)])
def test_decode_f32_row_groups(dev, gq, d):
    """The f32 row-grouped K1 (16-row chunks on 3xTF32 tiles) where its
    row plan and splits have edges, in the four variants, with and without
    ALiBi (``2e-5``; paged == contiguous bit for bit): 100 prompt tokens of
    one row at consecutive positions, tokens of other rows scattered
    through the batch at positions on the 32-key block and split
    boundaries of S = 2048, pads on the scratch row."""
    from flexflow_tpu_torch.serve import alibi_slopes

    g = torch.Generator().manual_seed(40 + gq)
    kv, s, r, page = (1 if gq > 8 else 2), 2048, 5, 512
    bounds = [0, 31, 32, 63, 64, 255, 256, 257, 511, 512, s - 1]
    rows = [0] * 100 + [1 + i % 4 for i in range(len(bounds))] + [r] * 20
    pos = list(range(1500, 1600)) + bounds + [0] * 20
    order = torch.randperm(len(rows), generator=g)
    rows = torch.tensor(rows, dtype=torch.int32)[order].to(dev)
    pos = torch.tensor(pos, dtype=torch.int32)[order].to(dev)
    q = torch.randn(len(order), kv * gq, d, generator=g).to(dev)
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev)
              for _ in range(2))
    for slopes in (None, alibi_slopes(kv * gq, dev)):
        _check_variants("decode_attention", dev, torch.float32, q, kc, vc,
                        page, (rows, pos), (d ** -0.5,), slopes=slopes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gq", [1, 3, 8, 48, 71])
def test_tree_kernel_any_group(dev, dtype, gq):
    """K3 per-token at any number of query heads per KV head (Falcon-7B's
    71 at D 64, StarCoder's 48 at D 128), in the four variants (paged ==
    contiguous bit for bit):
    requests of a 7-token tree scattered through the batch at committed
    depths on the block and split boundaries, pads (scratch row, depth 0,
    empty mask) giving zeros."""
    g = torch.Generator().manual_seed(50 + gq)
    kv, s, p, r, page = (1 if gq > 8 else 2), 2048, 8, 6, 512
    d = 64 if gq == 71 else 128
    depth = [0, 1, 31, 32, 257, s]
    rows = [i // 7 for i in range(42)] + [r] * 10
    clens = [depth[i // 7] for i in range(42)] + [0] * 10
    order = torch.randperm(len(rows), generator=g)
    rows = torch.tensor(rows, dtype=torch.int32)[order].to(dev)
    clens = torch.tensor(clens, dtype=torch.int32)[order].to(dev)
    t = len(order)
    q = torch.randn(t, kv * gq, d, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(
        dev, dtype) for n in (s, s, p, p))
    amask = torch.rand(t, p, generator=g) < 0.4
    amask[:, 0] = True
    pads = rows.cpu() == r
    amask[pads] = False
    got = _check_variants("tree_attention", dev, dtype, q, kc, vc, page,
                          (sk, sv, rows, clens, amask.to(dev)),
                          (d ** -0.5,))
    for out in got.values():
        assert not out[pads.to(dev)].float().abs().sum()


def test_wrappers_reject_bad_cache_variants(dev):
    q = torch.randn(2, 4, 16, device=dev)
    kq = torch.zeros(3, 2, 128, 16, dtype=torch.int8, device=dev)
    sc = torch.ones(3, 2, 128, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    table = torch.arange(6, dtype=torch.int32, device=dev).reshape(3, 2)
    with pytest.raises(TypeError):      # int8 cache without scales
        att.decode_attention(q, kq, kq, idx, idx, 1.0)
    with pytest.raises(ValueError):     # f16 scales
        att.decode_attention(q, kq, kq, idx, idx, 1.0, sc.half(), sc.half())
    with pytest.raises(ValueError):     # a page of 32 keys: half a block
        att.decode_attention(q, kq, kq, idx, idx, 1.0, sc, sc,
                             table.reshape(3, 2).repeat(1, 2), 32)
    with pytest.raises(ValueError):     # an int64 table
        att.decode_attention(q, kq, kq, idx, idx, 1.0, sc, sc, table.long(),
                             64)


def test_int8_paged_serving_on_card_matches_cpu(dev):
    """int8 weights + int8 KV + 64-position pages: the card (kernels) and
    the CPU (plain versions) serve the same greedy tokens from the same
    quantized weights, the paged run equals the contiguous one, and the
    int8+paged kernels launch."""
    from flexflow_tpu_torch.serve import quantize_int8

    def manager(device, page, params=None):
        im = InferenceManager(build_model(SMALL), max_requests=2,
                              max_tokens_per_batch=16, max_seq_len=128,
                              device=device, kv_dtype="int8",
                              kv_page_size=page)
        im.init_operators_inference(params, seed=3)
        quantize_int8(im)
        return im

    cpu = manager("cpu", 64)
    params = {k: p.to(dev) for k, p in cpu.model.named_parameters()}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 97, size=n).tolist() for n in (5, 70, 3)]
    gen = GenerationConfig(max_new_tokens=8)
    want = RequestManager(cpu, gen).generate(prompts)
    att.reset_counts()
    got = RequestManager(manager(dev, 64, params), gen).generate(prompts)
    assert got == want
    for fn in (att.decode_attention, att.prefill_attention):
        assert fn.variant_launches["int8+paged"] > 0
        assert fn.variant_launches["fp"] == 0
    assert RequestManager(manager(dev, None, params), gen).generate(
        prompts) == want


def test_mpt_serving_on_card_matches_cpu(dev):
    """A TINY float32 MPT (ALiBi) serves the same greedy tokens on the card
    as on the CPU, on an fp and an int8 paged cache, launching only the
    ALiBi K1 variants (its prefill goes through K1, not K2)."""
    cfg = ServeModelConfig(model_type="mpt", vocab_size=97, hidden_size=64,
                           intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, size=n).tolist() for n in (5, 70, 3)]
    gen = GenerationConfig(max_new_tokens=8)
    for kv_dtype, page, var in ((None, None, "fp+alibi"),
                                ("int8", 64, "int8+paged+alibi")):
        kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
                  kv_dtype=kv_dtype, kv_page_size=page)
        cpu = InferenceManager(build_model(cfg), device="cpu", **kw)
        cpu.init_operators_inference(seed=4)
        gpu = InferenceManager(build_model(cfg), device=dev, **kw)
        gpu.init_operators_inference(
            {k: p.to(dev) for k, p in cpu.model.named_parameters()})
        want = RequestManager(cpu, gen).generate(prompts)
        att.reset_counts()
        assert RequestManager(gpu, gen).generate(prompts) == want
        launched = {k: n for k, n in
                    att.decode_attention.variant_launches.items() if n}
        assert list(launched) == [var]
        assert att.prefill_attention.launches == 0


# ---------------------------------------------------------------------------
# float32 K2 and K3 batched: error-compensated TF32 on the tensor cores
# ---------------------------------------------------------------------------
def _tf32_rna(x):
    """TF32 rounding to nearest, ties away from zero, on the int32 view
    (the kernels' ``cvt.rna.tf32.f32``)."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & ~0x7FFFFFFF) | mag).view(torch.float32)


def test_tf32_split_rounds_to_nearest_on_card(dev):
    """The kernels' TF32 split (hi = rna(x), lo = rna(x - hi), on the
    integer view) equals the emulation and the hardware's
    ``cvt.rna.tf32.f32`` bit for bit, ties (low 13 bits exactly 0x1000)
    included, of either sign."""
    g = torch.Generator().manual_seed(21)
    x = torch.randn(4096, generator=g) * 10.0 ** torch.randint(
        -8, 8, (4096,), generator=g)
    ties = (x[:512].view(torch.int32) & ~0x1FFF) | 0x1000
    x = torch.cat([x, ties.view(torch.float32)])
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    got = att.tf32x3_probe(2, x.to(dev)).cpu().view(torch.int32)
    for col, want in ((0, hi), (1, lo), (2, hi), (3, lo)):
        assert torch.equal(got[:, col], want.view(torch.int32)), col


def _exact_cases(g, m, k, n):
    """(a [m, k], b [k, n], a . b as 3xTF32 gives it, exactly) for a
    product over k: small integers (lo = 0: hi . hi alone); then a's lo
    parts alone (a = 4 + v 2^-12, v in 0..7, so hi = 4 and lo = v 2^-12,
    against b of integers whose pairs of rows 2c, 2c + 1 cancel, so each
    8-deep step's hi . hi sums to 0); then b's lo parts alone (the same,
    swapped).  Every partial sum is an integer, or a multiple of 2^-12
    below 2, so the tensor cores' f32 accumulation is exact whatever its
    order and truncation."""
    def ints(*shape):
        return torch.randint(-8, 9, shape, generator=g).double()

    def lo_heavy(*shape):
        v = torch.randint(0, 8, shape, generator=g).double()
        return 4.0 + v * 2.0 ** -12, v * 2.0 ** -12

    def cancelling(rows, cols):     # rows 2c + 1 = -rows 2c
        x = ints(rows // 2, cols)
        return torch.stack([x, -x], 1).reshape(rows, cols)

    a, b = ints(m, k), ints(k, n)
    yield a, b, a @ b
    a, a_lo = lo_heavy(m, k)
    b = cancelling(k, n)
    yield a, b, a_lo @ b
    a = cancelling(k, m).T.contiguous()
    b, b_lo = lo_heavy(k, n)
    yield a, b, a @ b_lo


@pytest.mark.parametrize("d", att.HEAD_DIMS)
def test_tf32x3_fragments_exact(dev, d):
    """One warp of the f32 engine through its fragment layout: Q.K^T of a
    16-row tile and an 8-key tile (k = D), then P.V of a 16 x 8 P and an
    8-key V tile (k = 8), each on small integer matrices (exact: pins
    every element's place in the hi fragments) and on values whose hi
    products cancel step by step, leaving each operand's lo parts (pins
    the lo fragments and passes)."""
    g = torch.Generator().manual_seed(22)
    for q, kt, want in _exact_cases(g, 16, d, 8):
        got = att.tf32x3_probe(0, q.float().to(dev),
                               kt.T.contiguous().float().to(dev)).cpu()
        assert torch.equal(got.double(), want)
    for p, v, want in _exact_cases(g, 16, 8, d):
        got = att.tf32x3_probe(1, p.float().to(dev), v.float().to(dev)).cpu()
        assert torch.equal(got.double(), want)


@pytest.mark.parametrize("d", att.HEAD_DIMS)
def test_prefill_f32_ragged_edges(dev, d):
    """The f32 tensor-core K2 at ragged edges, in the four variants
    (``2e-5``; paged == contiguous bit for bit): 3 query heads per KV head
    and Bq 40 (120 folded rows: a full and a part 64-row chunk, rows past
    Bq * gq), pstart off the 32-key grid, causal frontiers inside blocks,
    a tile across the two 1024-key splits' boundary (its rows' partials
    merged) and the last tile ending at S - 1."""
    g = torch.Generator().manual_seed(23)
    qh, kv, s, bq, page = 12, 4, 2048, 40, 512
    q = torch.randn(3, bq, qh, d, generator=g).to(dev)
    kc, vc = (torch.randn(4, kv, s, d, generator=g).to(dev)
              for _ in range(2))
    rows = torch.tensor([0, 2, 1], dtype=torch.int32, device=dev)
    pstart = torch.tensor([1000, 0, s - bq], dtype=torch.int32, device=dev)
    _check_variants("prefill_attention", dev, torch.float32, q, kc, vc,
                    page, (rows, pstart), (d ** -0.5,))


@pytest.mark.parametrize("d,qh", [(d, 8) for d in att.HEAD_DIMS]
                         + [(64, 16)])
def test_batched_tree_f32_split_boundaries(dev, d, qh):
    """The f32 split-KV K3 batched layout, in the four variants (``2e-5``;
    paged == contiguous bit for bit): committed lengths on the block and
    split boundaries (0, 1, 31, 32, 63, 64, 65, 256, S - 1), a pad request
    with no live key (zeros), 7-token trees of 2 query heads per KV head
    (14 folded rows: one chunk) or 8 (56: four chunks)."""
    g = torch.Generator().manual_seed(24)
    kv, s, p, pb, page = 4 if qh == 8 else 2, 1024, 7, 8, 64
    clens = [0, 1, 31, 32, 63, 64, 65, 256, s - 1, 0]
    r = len(clens)
    q = torch.randn(r, p, qh, d, generator=g).to(dev)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(dev)
                      for n in (s, s, pb, pb))
    amask = torch.rand(r, p, pb, generator=g) < 0.4
    amask[:, :, 0] = True
    amask[-1] = False                 # the pad request: no live key at all
    rows = torch.tensor(list(range(r - 1)) + [r], dtype=torch.int32,
                        device=dev)
    got = _check_variants(
        "tree_attention_batched", dev, torch.float32, q, kc, vc, page,
        (sk, sv, rows, torch.tensor(clens, dtype=torch.int32, device=dev),
         amask.to(dev)), (d ** -0.5,))
    for out in got.values():
        assert not out[-1].abs().sum()   # zeros, not NaN


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preempt_spill_restore_on_card(dev, dtype):
    """A small model on 64-position pages with a host page tier: a row
    preempted mid-decode spills its pages to host memory and its
    readmission restores them, each restored page's bytes exactly the
    spilled ones; in float32 the streams equal the CPU port's
    uninterrupted ones.  The paged kernels serve every segment: K2 and K1
    before the preemption; after it, the restored row's catch-up tail
    shares a step with the other row's decode token, so K1's flat path
    serves it, and K1 serves the decode that follows."""
    from flexflow_tpu_torch.serve import RequestStatus, ResilienceConfig

    cfg = dataclasses.replace(SMALL, dtype=dtype)
    kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
              kv_page_size=64)
    cpu = InferenceManager(build_model(cfg), device="cpu",
                           **kw).init_operators_inference(seed=3)
    gpu = InferenceManager(build_model(cfg), device=dev, **kw)
    gpu.init_operators_inference(dict(cpu.model.named_parameters()))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 97, size=n).tolist() for n in (70, 5)]
    gen = GenerationConfig(max_new_tokens=10)
    want = RequestManager(cpu, gen).generate(prompts)
    kv = gpu.kv
    rm = RequestManager(gpu, gen, resilience=ResilienceConfig(
        host_tier_bytes=1 << 26))
    rm.scan_chunk = 2

    def paged_launches(*want_fns):
        """Each kernel's paged launches since the last call (asserting
        that ``want_fns`` launched and no other variant did)."""
        got = {}
        for fn in (att.decode_attention, att.prefill_attention):
            assert fn.launches == fn.variant_launches["paged"]
            got[fn.__name__] = fn.launches
        for fn in want_fns:
            assert got[fn.__name__] > 0, (fn.__name__, got)
        att.reset_counts()
        return got

    att.reset_counts()
    for p in prompts:
        rm.register_new_request(p)
    for _ in range(4):   # a prefill stretch, then decode stretches of 2
        rm._tick()
    assert all(r.status is RequestStatus.DECODING and len(r.generated) > 2
               for r in rm.requests.values())
    paged_launches(att.prefill_attention, att.decode_attention)
    spilled = []
    restore = kv.restore

    def checked_restore(rid, align=1):
        ent = kv.host_tier._spills[rid]
        spilled.append([[b.clone() for b in p.blocks] for p in ent.pages])
        info = restore(rid, align)
        slot = kv._slot_of[rid]
        for k in range(info["pages"]):
            pid = int(kv._table[slot, k])
            for got, blk in zip(kv._page_blocks(pid), spilled[-1][k]):
                assert torch.equal(got.cpu().view(torch.uint8),
                                   blk.view(torch.uint8))
        return info

    kv.restore = checked_restore
    rm.preempt(0)
    for key in list(kv._entries):   # no prefix hit: restore from the tier
        kv._drop_entry(key)
    rm._tick()   # readmission, restore, and the catch-up step
    req = rm.requests[0]
    assert req.kv_restored and req.status is RequestStatus.DECODING
    paged_launches(att.decode_attention)
    out = rm.serve_incr_decoding()
    paged_launches(att.decode_attention)
    assert spilled and kv.pages_restored > 0 and kv.restore_failures == 0
    assert kv.host_tier._spills == {} and kv.attributed_rids() == []
    assert all(len(out[r]) == 10 for r in (0, 1))
    if dtype == "float32":
        assert [out[0], out[1]] == want


# ---------------------------------------------------------------------------
# the reference's default serve path: LM-head gating, the chained stretch,
# seeded speculative sampling
# ---------------------------------------------------------------------------
WIDE = ServeModelConfig(num_hidden_layers=2)   # Llama-2-7B width, 2 layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_prefill_7b_width(dev, dtype):
    """A 512-token prefill chunk of four prompts at Llama-2-7B width (2
    layers): the gated step's ``[8, 32000]`` logits at the four sample
    points against the ungated step's rows, float32 within ``1e-5``
    (another GEMM row count, so not bit for bit) and equal tokens,
    bfloat16 within ``1e-2``; the caches are equal."""
    from flexflow_tpu_torch.serve import PrefillBatchConfig

    cfg = dataclasses.replace(WIDE, dtype=dtype)
    im = InferenceManager(build_model(cfg), max_requests=8,
                          max_tokens_per_batch=512, max_seq_len=2048,
                          device=dev).init_operators_inference(seed=0)
    rng = np.random.default_rng(5)
    segs = [(s, rng.integers(3, 32000, size=n).tolist(), 0)
            for s, n in enumerate((128, 100, 128, 77))]
    lens = [len(t) for _, t, _ in segs]
    res, caches = {}, {}
    for gate in (False, True):
        im.reset()
        pbc, last = PrefillBatchConfig.build(
            segs, lens, im.prefill_tile, max_tokens=512, max_requests=8,
            device=dev, gate_slots=[0, 1, 2, 3] if gate else None)
        res[gate] = im.step(pbc)
        caches[gate] = {n: b["k"].clone() for n, b in im.state.items()}
    rows = [last[s] for s in range(4)]
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-2, rtol=1e-2))
    torch.testing.assert_close(res[True].logits[:4].cpu(),
                               res[False].logits[rows].cpu(), **tol)
    if dtype == "float32":
        assert (res[True].token_ids[:4].tolist()
                == res[False].token_ids[rows].tolist())
    for n, k in caches[True].items():
        assert torch.equal(k, caches[False][n])


def test_chained_stretch_with_join_on_card(dev, monkeypatch):
    """A chained stretch on the card: an arrival joins at a segment
    boundary, its flat prefill and every segment run K1 (no plain
    version), one read-back, and the streams equal the unchained run's
    and the CPU's."""
    kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128)
    cpu = InferenceManager(build_model(SMALL), device="cpu",
                           **kw).init_operators_inference(seed=3)
    gpu = InferenceManager(build_model(SMALL), device=dev, **kw)
    gpu.init_operators_inference(dict(cpu.model.named_parameters()))
    prompts = [[3, 5, 7, 9, 11], [2, 4, 6, 8]]
    gen = GenerationConfig(max_new_tokens=12)
    want = RequestManager(cpu, gen).generate(prompts)
    plain = []
    for name in ("decode_attention", "prefill_attention"):
        fn = getattr(att, name + "_plain")

        def counting(*a, _fn=fn, _name=name, **k):
            plain.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(att, name + "_plain", counting)
    rm = RequestManager(gpu, gen)
    r0 = rm.register_new_request(prompts[0])
    while not rm.requests[r0].generated:
        rm._serve_tick()
    joined = []
    rm._arrival_pump = lambda: joined or joined.append(
        rm.register_new_request(prompts[1]))
    att.reset_counts()
    before = rm.readbacks
    rm._decode_stretch(rm._scan_steps_possible())
    rm._arrival_pump = None
    assert rm.readbacks - before == 1
    assert rm.last_stretch["joins"] == 1
    assert att.decode_attention.variant_launches["fp"] > 0
    while rm.has_work():
        rm._serve_tick()
    assert [rm.requests[r].generated for r in (r0, joined[0])] == want
    gpu.reset()
    rm_u = RequestManager(gpu, gen)
    rm_u.chain_segments = False
    assert rm_u.generate(prompts) == want
    assert plain == []


def test_sampled_host_spec_equals_sampled_incremental_on_card(dev):
    """Seeded sampling at 2 layers of Llama-2-7B width in float32 (TF32
    off), a llama-68m-shaped draft: ``SpecInferManager``'s streams equal
    the incremental ``RequestManager``'s token for token (the verify rows
    draw with the incremental loop's keys); K3 per-token serves the
    verify steps."""
    from flexflow_tpu_torch.serve import SpecInferManager

    kw = dict(max_requests=4, max_tokens_per_batch=64, max_seq_len=512,
              max_spec_tokens=8, device=dev)
    llm = InferenceManager(build_model(WIDE),
                           **kw).init_operators_inference(seed=0)
    draft = InferenceManager(build_model(ServeModelConfig(
        hidden_size=768, intermediate_size=3072, num_hidden_layers=2,
        num_attention_heads=12, num_key_value_heads=12)), topk=2,
        **kw).init_operators_inference(seed=1)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 32000, size=n).tolist() for n in (40, 17, 64)]
    gen = GenerationConfig(max_new_tokens=12, temperature=0.8, top_p=0.9,
                           seed=7)
    want = RequestManager(llm, gen).generate(prompts)
    llm.reset()
    att.reset_counts()
    got = SpecInferManager(llm, draft, gen, width=2, depth=3).generate(
        prompts)
    assert att.tree_attention.launches > 0
    flat_got = [t for s in got for t in s]
    flat_want = [t for s in want for t in s]
    same = [a == b for a, b in zip(flat_got, flat_want)]
    first = same.index(False) if False in same else None
    assert got == want, (f"equal share {sum(same) / len(same):.4f}, "
                         f"first difference at flat index {first}")


# ---------------------------------------------------------------------------
# mixed spec and plain rows: root-only trees, pad nodes inside a kernel row
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernel_root_only_trees(dev, dtype):
    """A mixed verify batch at the Llama-2-7B verify shape: slot 0 ships a
    7-node tree, slots 1 and 2 a root-only tree (each token sees its
    committed prefix and itself), and pads sit on the scratch row; every
    variant against its plain version, paged == contiguous."""
    g = torch.Generator().manual_seed(11)
    qh, kv, d, s, pb, page = 32, 32, 128, 2048, 8, 512
    r = 3
    parents = [-1, 0, 0, 1, 1, 2, 2]
    rows = [0] * 7 + [1, 2, 3, 3]
    clens = [700] * 7 + [s - 1, 1] + [0, 0]
    amask = torch.zeros(len(rows), pb, dtype=torch.bool)
    for i, par in enumerate(parents):
        if par >= 0:
            amask[i] = amask[par]
        amask[i, i] = True
    amask[7, 0] = amask[8, 0] = True        # the root-only trees
    q = torch.randn(len(rows), qh, d, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(dev, dtype)
                      for n in (s, s, pb, pb))
    got = _check_variants(
        "tree_attention", dev, dtype, q, kc, vc, page,
        (sk, sv, torch.tensor(rows, dtype=torch.int32, device=dev),
         torch.tensor(clens, dtype=torch.int32, device=dev), amask.to(dev)),
        (d ** -0.5,))
    assert not got["fp"][9:].float().abs().sum()   # pads: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_tree_kernel_pad_nodes(dev, dtype):
    """``SpecDecodeScan``'s mixed verify in the [R, P] layout: slots 0 and
    2 ship 7-node trees, slots 1 and 3 their root only, their other nodes
    pads of the same kernel row (the slot's row and depth, an empty
    mask), and a finished slot is all pads on the scratch row; every
    variant against its plain version, paged == contiguous."""
    g = torch.Generator().manual_seed(12)
    qh, kv, d, s, p, pb, page = 32, 32, 128, 2048, 7, 8, 512
    r = 5
    parents = [-1, 0, 0, 1, 1, 2, 2]
    tree = torch.zeros(p, pb, dtype=torch.bool)
    for i, par in enumerate(parents):
        if par >= 0:
            tree[i] = tree[par]
        tree[i, i] = True
    amask = torch.zeros(r, p, pb, dtype=torch.bool)
    amask[0] = amask[2] = tree
    amask[1, 0, 0] = amask[3, 0, 0] = True
    q = torch.randn(r, p, qh, d, generator=g).to(dev, dtype)
    kc, vc, sk, sv = (torch.randn(r + 1, kv, n, d, generator=g).to(dev, dtype)
                      for n in (s, s, pb, pb))
    got = _check_variants(
        "tree_attention_batched", dev, dtype, q, kc, vc, page,
        (sk, sv, torch.tensor([0, 1, 2, 3, 5], dtype=torch.int32,
                              device=dev),
         torch.tensor([513, s - 7, 64, 1, 0], dtype=torch.int32, device=dev),
         amask.to(dev)), (d ** -0.5,))
    assert not got["fp"][4].float().abs().sum()    # the finished slot


def test_mixed_rows_7b_width_on_card(dev):
    """2 layers at Llama-2-7B width in float32 (TF32 off) with a
    llama-68m-shaped draft: a spec row and a plain row in one
    ``SpecInferManager``, a flip off that flushes the pending commits and
    a flip on, and ``SpecDecodeScan`` with ``spec_mask``, all equal to
    incremental decoding on the card; the flush runs through K1."""
    from flexflow_tpu_torch.serve import (
        BatchConfig,
        SpecDecodeScan,
        SpecInferManager,
    )

    kw = dict(max_requests=4, max_tokens_per_batch=128, max_seq_len=512,
              max_spec_tokens=8, device=dev)
    llm = InferenceManager(build_model(WIDE),
                           **kw).init_operators_inference(seed=0)
    draft = InferenceManager(build_model(ServeModelConfig(
        hidden_size=768, intermediate_size=3072, num_hidden_layers=2,
        num_attention_heads=12, num_key_value_heads=12)), topk=2,
        **kw).init_operators_inference(seed=1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 32000, size=n).tolist() for n in (40, 17, 64)]
    gen = GenerationConfig(max_new_tokens=12)
    want = RequestManager(llm, gen).generate(prompts)
    llm.reset()
    sm = SpecInferManager(llm, draft, gen, width=2, depth=3)
    rids = [sm.register_new_request(p, spec=i != 1)
            for i, p in enumerate(prompts)]
    for _ in range(3):
        sm._check_lifecycle()
        sm._tick()
    assert any(sm.requests[r].pending_commit for r in rids)
    for r in rids:
        sm.set_spec_mode(r, False)
    k1 = att.decode_attention.launches
    sm._check_lifecycle()
    sm._tick()
    assert sm.flushes == 1 and att.decode_attention.launches > k1
    sm.set_spec_mode(rids[1], True)
    out = sm.serve_spec_infer()
    assert [out[r] for r in rids] == want

    llm.reset()
    draft.reset()
    lens = [len(p) for p in prompts]
    bc = BatchConfig.build(
        [t for p in prompts for t in p],
        [i for i, n in enumerate(lens) for _ in range(n)],
        [j for n in lens for j in range(n)], lens + [0], max_tokens=128,
        max_requests=4, device=dev)
    draft.step(bc)
    ids = llm.step(bc).token_ids.cpu().tolist()
    ends = np.cumsum(lens) - 1
    firsts = [ids[e] for e in ends] + [0]
    sc = SpecDecodeScan(llm, draft, width=2, depth=3)
    carry = sc.init_carry(firsts, lens + [0], lens + [0],
                          [False] * 3 + [True],
                          spec_mask=[True, False, True, False],
                          budget=[11] * 4)
    n0 = att.tree_attention_batched.launches
    em, _ = sc.run(carry, 11)
    assert att.tree_attention_batched.launches > n0
    em = em.cpu().numpy()
    assert ((em[:, 1] >= 0).sum(1) <= 1).all()     # the plain slot
    scan = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1) if t >= 0]
            for i in range(3)]
    assert scan == want


def _control_plane(tel=True):
    """Every observation handle of the control plane (fresh), and an SLO
    policy with a brownout ladder; ``tel=False``: none of them."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.serve import BrownoutController, SLOPolicy

    if not tel:
        return {}
    t = obs.Telemetry()
    slo = SLOPolicy.default()
    return dict(telemetry=t, profiler=obs.StepProfiler(), slo=slo,
                brownout=BrownoutController(slo, telemetry=t),
                plan_health=obs.PlanHealthMonitor(
                    t, {"plan_key": "tp1_pp1_m1", "tpot_ms": 1.0,
                        "ttft_ms": 1.0}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hooks_on_and_off_bit_identical_on_card(dev, dtype):
    """Telemetry, the profiler, plan health and the SLO lanes change no
    token and no record on the card: arrivals joining chained stretches
    on a virtual clock, in both dtypes (exact)."""
    from test_serving_under_load import VirtualClock

    cfg = dataclasses.replace(SMALL, dtype=dtype)
    kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
              device=dev)
    gpu = InferenceManager(build_model(cfg), **kw).init_operators_inference(
        seed=3)
    arrivals = [(0.0, [3, 5, 7], 12), (0.075, [2, 4, 6, 8], 8),
                (0.3, [9, 8, 7, 6, 5], 8), (0.31, [11, 12], 6)]
    runs = []
    for on in (False, True, False):
        gpu.reset()
        rm = RequestManager(gpu, GenerationConfig(max_new_tokens=8),
                            **_control_plane(on))
        recs = rm.serve_with_arrivals(arrivals, clock=VirtualClock())
        runs.append({r: {k: v for k, v in rec.items()
                         if k not in ("work", "slo_class")}
                     for r, rec in recs.items()})
        if on:
            assert rm.telemetry.metrics.snapshot()["requests_finished"] == 4
    assert runs[0] == runs[1] == runs[2]


def test_host_syncs_equal_readbacks_on_card(dev):
    """A chained stretch with a join reads back once on the card: the
    profiler's ``host_syncs`` moves with ``readbacks``, one each, and a
    dispatch counts each segment and the join's steps (exact)."""
    from flexflow_tpu_torch import obs

    kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
              device=dev)
    gpu = InferenceManager(build_model(SMALL), **kw).init_operators_inference(
        seed=3)
    prof = obs.StepProfiler()
    rm = RequestManager(gpu, GenerationConfig(max_new_tokens=16),
                        profiler=prof, telemetry=obs.Telemetry())
    r0 = rm.register_new_request([3, 5, 7, 9, 11])
    while not rm.requests[r0].generated:
        rm._serve_tick()
    joined = []
    rm._arrival_pump = lambda: joined or joined.append(
        rm.register_new_request([2, 4, 6, 8]))
    w0, r_0 = dict(prof.work), rm.readbacks
    rm._decode_stretch(rm._scan_steps_possible())
    rm._arrival_pump = None
    assert rm.last_stretch["joins"] == 1 and rm.readbacks - r_0 == 1
    assert prof.work["host_syncs"] - w0["host_syncs"] == 1
    # the segments, the joiner's prefill step and its join
    assert (prof.work["dispatches"] - w0["dispatches"]
            == rm.last_stretch["segments"] + 2)
    while rm.has_work():
        rm._serve_tick()
    assert prof.work["host_syncs"] == rm.readbacks
    assert prof.report()["work"]["recompiles_total"] == 0


def test_no_hook_syncs_the_card(dev):
    """Every hook of a hooks-on decode stretch tick (the telemetry and
    profiler handles, the monitor, the ladder, the manager's accounting,
    batch-mix and KV-gauge hooks) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: none raises, so none
    waits for the card."""
    kw = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
              device=dev)
    gpu = InferenceManager(build_model(SMALL), **kw).init_operators_inference(
        seed=3)
    hooks = _control_plane()
    hooks["brownout"].config.check_every = 1
    rm = RequestManager(gpu, GenerationConfig(max_new_tokens=16), **hooks)
    for p in ([3, 5, 7, 9, 11], [2, 4, 6, 8]):
        rm.register_new_request(p)
    rm._serve_tick()                       # the prefill stretch
    calls = []

    def strict(fn, name):
        def run(*a, **k):
            calls.append(name)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return run

    targets = [(hooks["telemetry"], None), (hooks["profiler"], None),
               (hooks["plan_health"], ("check",)),
               (hooks["brownout"], ("evaluate",)),
               (gpu.kv, ("observe",)),
               (rm, ("_prof_account", "_note_batch", "_maybe_check_health",
                     "_maybe_brownout"))]
    for obj, names in targets:
        names = names or [n for n in dir(obj) if not n.startswith("_")
                          and callable(getattr(obj, n))]
        for name in names:
            setattr(obj, name, strict(getattr(obj, name), name))
    n = rm._scan_steps_possible()
    assert n > 1
    rm.health_check_every = 1
    rm.profiler.tick_begin()
    rm._serve_tick()                       # a decode stretch
    rm.profiler.tick_end()
    rm._sync_kv()
    rm._maybe_check_health()
    rm._maybe_brownout()
    torch.cuda.synchronize()
    for name in ("span", "account", "observe", "tick_end", "check",
                 "evaluate", "phase", "host_sync"):
        assert name in calls, name


# ---------------------------------------------------------------------------
# the fleet router and live migration on the card
# ---------------------------------------------------------------------------
def _shared(device, params=None, n=2, page=None):
    """``n`` deployments of one SMALL float32 model sharing its parameter
    tensors (each with its own KV), on ``device``."""
    model = build_model(SMALL)
    ims = []
    for i in range(n):
        im = InferenceManager(model, max_requests=2, max_tokens_per_batch=16,
                              max_seq_len=128, device=device,
                              kv_page_size=page)
        if i:
            im.allocate_kv_cache()
        else:
            im.init_operators_inference(params, seed=3)
        ims.append(im)
    return ims


def _fleet_run(ims, on_kill=None):
    from flexflow_tpu_torch.serve import FleetRouter

    fleet = FleetRouter(ims, gen=GenerationConfig(max_new_tokens=8))
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    if on_kill is not None:
        kill = fleet.kill_replica

        def spy(name, reason="operator kill"):
            return on_kill(lambda: kill(name, reason), fleet._by_name(name))

        fleet.kill_replica = spy
    fleet.schedule_kill("replica0", at_tick=3)
    out = fleet.generate([[3, 5, 7, 9, 11], [2, 4, 6], [13, 8, 1]])
    return out, fleet


def test_fleet_kill_on_card_matches_cpu(dev):
    """Two float32 replicas sharing one model, replica0 killed mid-decode:
    the card serves the CPU fleet's streams, the victim's requests fail
    over, and its teardown returns its KV bytes to the card
    (``memory_allocated`` falls by at least them; exact streams)."""
    cpu = _shared("cpu")
    want, cpu_fleet = _fleet_run(cpu)
    params = {k: p.to(dev) for k, p in cpu[0].model.named_parameters()}
    freed = {}

    def measure(kill, rep):
        torch.cuda.synchronize()
        freed["kv"] = rep.rm.im.kv.allocated_bytes()
        before = torch.cuda.memory_allocated()
        moved = kill()
        torch.cuda.synchronize()
        freed["drop"] = before - torch.cuda.memory_allocated()
        freed["moved"] = moved
        return moved

    att.reset_counts()
    got, fleet = _fleet_run(_shared(dev, params), measure)
    assert got == want
    assert fleet._failover_counts == cpu_fleet._failover_counts
    assert freed["moved"] and freed["kv"] > 0
    assert freed["drop"] >= freed["kv"]
    assert fleet._by_name("replica0").leaked == []
    assert att.decode_attention.variant_launches["fp"] > 0
    assert att.prefill_attention.variant_launches["fp"] > 0


def test_migration_contiguous_to_paged_on_card_matches_cpu(dev):
    """A contiguous → paged live migration landing mid-decode: the card
    serves the CPU run's streams, the successor launches the paged
    kernels, and the incumbent's teardown returns its KV bytes."""
    from flexflow_tpu_torch.serve import MigrationConfig, MigrationController

    prompts = [[3, 5, 7, 9, 11], [2, 4, 6], [13, 8, 1]]

    def run(device, params=None):
        inc, = _shared(device, params, n=1)
        model = inc.model
        freed = {}

        def build(cand):
            im = InferenceManager(model, max_requests=2,
                                  max_tokens_per_batch=16, max_seq_len=128,
                                  device=device, kv_page_size=64)
            im.allocate_kv_cache()
            return im

        rm = RequestManager(inc, GenerationConfig(max_new_tokens=8))
        rm.scan_chunk = 2
        ctrl = MigrationController(
            rm, build, plan={"plan_key": "tp1_pp1_m1"},
            config=MigrationConfig(defer_ticks=2, drain_grace_ticks=1))
        teardown = ctrl._teardown

        def measure(old):
            if device != "cpu":
                torch.cuda.synchronize()
                freed["kv"] = old.im.kv.allocated_bytes()
                before = torch.cuda.memory_allocated()
            leaked = teardown(old)
            if device != "cpu":
                torch.cuda.synchronize()
                freed["drop"] = before - torch.cuda.memory_allocated()
            return leaked

        ctrl._teardown = measure
        ctrl.request_migration("tp1_pp1_m1_paged64")
        return rm.generate(prompts), ctrl, freed

    want, _, _ = run("cpu")
    cpu = _shared("cpu", n=1)[0]
    params = {k: p.to(dev) for k, p in cpu.model.named_parameters()}
    att.reset_counts()
    got, ctrl, freed = run(dev, params)
    assert got == want
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["preempted_requests"] > 0
    assert rec["kv_leaked_rids"] == []
    assert freed["kv"] > 0 and freed["drop"] >= freed["kv"]
    for fn in (att.decode_attention, att.prefill_attention):
        assert fn.variant_launches["paged"] > 0
