"""The port's paged KV cache, on the CPU.

* the plain K1/K2/K3 (both layouts) versions behind a shuffled page table
  against the Pallas kernels in interpret mode (``tests/test_kv_paged.py:461``,
  float32 ``atol=rtol=1e-5``), and bit for bit equal to the same plain
  version on the contiguous layout;
* paged vs contiguous serving bit for bit: ``RequestManager.generate`` (fp
  and int8 KV), ``SpecInferManager.generate`` and ``SpecDecodeScan``
  (``tests/test_kv_paged.py:149,205``);
* prefix sharing: reuse across sessions skips prefill (:226), copy-on-write
  when a sharer diverges (:245), and a sole holder diverging inside an
  index entry's extent copies too (:273);
* the pool: exhaustion raises (:399), ``round_need`` and capacity are
  page-granular (:425), no page leaks (:339), the port's table, refcounts
  and counters equal the JAX ``PagedKVAllocator``'s after the same
  bind/prepare/release sequence, and the geometry checks (:79, :94).

Pages are 64 positions, the smallest the kernels take.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import PagedKVAllocator as JaxPagedKVAllocator
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    PagedKVAllocator,
    PagePoolExhausted,
    RequestManager,
    SpecDecodeScan,
    SpecInferManager,
    build_model,
    validate_page_tile,
)

from test_torch_int8 import KERNELS, PAGE, kernel_case
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, SSM, _one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _tokens(n, seed):
    """``n`` token ids of the TINY vocabulary (67), from a seed."""
    return np.random.default_rng(seed).integers(1, 67, size=n).tolist()


# a lead prompt whose prefill crosses the first page boundary
PROMPTS = [_tokens(70, 0), [3, 11, 25, 40, 7], [2, 4]]


@pytest.mark.parametrize("name", KERNELS)
def test_paged_plain_versions_match_pallas_and_contiguous(name):
    got, want = kernel_case(name, "paged")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, kernel_case(name, "fp")[0])


def manager(page=None, kv_dtype=None, cfg=CFG, seed=7, **kw):
    args = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128)
    args.update(kw)
    return InferenceManager(build_model(cfg), device="cpu",
                            kv_dtype=kv_dtype, kv_page_size=page,
                            **args).init_operators_inference(seed=seed)


def _assert_pool_clean(kv):
    assert kv.pages_held() == 0, "request-held pages leaked"
    assert kv.attributed_rids() == []
    assert int(kv._req_refs.sum()) == 0
    snap = kv.snapshot()   # every page not free is an index-held page
    assert snap["pages_free"] + snap["pages_indexed"] == snap["pages_total"]


# ---------------------------------------------------------------------------
# bit-identity: paged == contiguous
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_generate_bit_identical_paged_vs_contiguous(kv_dtype):
    gen = GenerationConfig(max_new_tokens=8)
    want = RequestManager(manager(None, kv_dtype), gen).generate(PROMPTS)
    imp = manager(PAGE, kv_dtype)
    got = RequestManager(imp, gen).generate(PROMPTS)
    assert got == want, "paged path changed served tokens"
    _assert_pool_clean(imp.kv)


def _spec_pair(page):
    kw = dict(max_tokens_per_batch=32, max_spec_tokens=8)
    return (manager(page, **kw),
            manager(page, cfg=SSM, seed=123, topk=2, **kw))


def test_spec_infer_paged_bit_identical():
    gen = GenerationConfig(max_new_tokens=8)
    want = SpecInferManager(*_spec_pair(None), gen, width=2,
                            depth=3).generate(PROMPTS[:2])
    llm, ssm = _spec_pair(PAGE)
    got = SpecInferManager(llm, ssm, gen, width=2, depth=3).generate(
        PROMPTS[:2])
    assert got == want
    _assert_pool_clean(llm.kv)
    _assert_pool_clean(ssm.kv)


def _prefill_bound(im, prompts):
    """Bind request r to slot r, map its prompt's pages and prefill it in
    flat chunks; the first generated token per slot.  The requests stay
    bound (their pages mapped) for the scan."""
    firsts, lens = [], [0] * im.max_requests
    for r, p in enumerate(prompts):
        im.kv.bind(r, slot=r, tokens=p)
        im.kv.prepare_write(r, 0, len(p))
        for lo in range(0, len(p), im.max_tokens):
            chunk = p[lo: lo + im.max_tokens]
            lens[r] = lo + len(chunk)
            ids = im.step(BatchConfig.build(
                chunk, [r] * len(chunk), list(range(lo, lens[r])), lens,
                max_tokens=im.max_tokens, max_requests=im.max_requests,
                device="cpu")).token_ids
        firsts.append(int(ids[len(chunk) - 1]))
    return firsts


def test_spec_scan_paged_bit_identical():
    prompts = [PROMPTS[0][:60], PROMPTS[1]]   # slot 0 crosses a page
    outs = {}
    for page in (None, PAGE):
        llm, ssm = _spec_pair(page)
        firsts = _prefill_bound(llm, prompts)
        _prefill_bound(ssm, prompts)
        sc = SpecDecodeScan(llm, ssm, width=2, depth=2)
        lens = [len(p) for p in prompts]
        em, carry = sc.run(sc.init_carry(firsts, lens, lens, [False] * 2),
                           6)
        outs[page] = em.numpy()
        if page:
            # growth mapped up front: 60 + 20 and 5 + 20 positions
            assert llm.kv.pages_held() == 3
            for kv in (llm.kv, ssm.kv):
                for r in range(2):
                    kv.release(r)
                _assert_pool_clean(kv)
    np.testing.assert_array_equal(outs[PAGE], outs[None])
    assert (outs[PAGE] >= 0).sum() >= 12


# ---------------------------------------------------------------------------
# prefix sharing and copy-on-write
# ---------------------------------------------------------------------------
def test_prefix_reuse_skips_prefill_across_sessions():
    prompt = _tokens(100, 1)   # one full page + a 36-token tail
    gen = GenerationConfig(max_new_tokens=5)
    imp = manager(PAGE)
    want = RequestManager(imp, gen).generate([prompt])
    hits0 = imp.kv.prefix_hits
    rm2 = RequestManager(imp, gen)
    assert rm2.generate([list(prompt)]) == want
    assert imp.kv.prefix_hits == hits0 + 1
    # the index held all but the last position; the prefill resumed at
    # the tile-aligned 96
    assert rm2.requests[0].prefix_cached == 96
    assert imp.kv.prefix_tokens_reused == 96
    imp.reset()   # an empty index: the same tokens, from scratch
    rm3 = RequestManager(imp, gen)
    assert rm3.generate([list(prompt)]) == want
    assert rm3.requests[0].prefix_cached == 0


def _serve_late_joiner(im, first, second, n_new):
    """``first`` decodes a few steps alone, then ``second`` arrives."""
    rm = RequestManager(im, GenerationConfig(max_new_tokens=n_new))
    rm.scan_chunk = 2
    rm.register_new_request(first)
    while len(rm.requests[0].generated) < 3:
        rm._tick()
    rm.register_new_request(second)
    out = rm.serve_incr_decoding()
    return [out[0], out[1]]


def test_cow_on_shared_divergence_bit_identical():
    # B, arriving while A decodes, maps A's registered pages (the full
    # page and the partial tail, whose tile-aligned part it reuses); B's
    # prefill of its remainder writes into the shared tail page, which is
    # copied first, so A's page is never written by B
    prompt = _tokens(104, 2)   # one full page + a 40-token tail
    want = _serve_late_joiner(manager(None), prompt, list(prompt), 12)
    assert want[0] == want[1]
    imp = manager(PAGE)
    got = _serve_late_joiner(imp, prompt, list(prompt), 12)
    assert got == want, "COW/sharing changed served tokens"
    assert imp.kv.prefix_hits >= 1 and imp.kv.cow_copies >= 1
    _assert_pool_clean(imp.kv)


def test_sole_holder_divergence_cannot_corrupt_the_index():
    # B maps A's registered tail page on a shorter match than the entry's
    # (their tokens part inside its protected extent) and is the page's
    # only request holder: its write still copies the page, or the index
    # would serve B's K/V to C, which repeats A
    prompt_a = _tokens(104, 3)   # one full page + a 40-token tail
    prompt_b = prompt_a[:84] + [t % 66 + 1 for t in prompt_a[84:]]
    gen = GenerationConfig(max_new_tokens=5)
    im = manager(None)
    want = [RequestManager(im, gen).generate([p])[0]
            for p in (prompt_a, prompt_b, prompt_a)]
    imp = manager(PAGE)
    got = []
    for p in (prompt_a, prompt_b, prompt_a):
        rm = RequestManager(imp, gen)
        got.append(rm.generate([list(p)])[0])
        if p is prompt_b:   # mapped A's tail on a 20-token match
            assert rm.requests[0].prefix_cached == 80
            assert imp.kv.cow_copies >= 1
    assert got == want, "divergent sharer corrupted an index-held page"
    _assert_pool_clean(imp.kv)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
def _allocator(max_requests=1, max_seq_len=256, page=PAGE):
    return PagedKVAllocator([build_model(CFG)], max_requests, max_seq_len,
                            [torch.device("cpu")], page_size=page)


def test_index_pages_evict_lru_and_exhaustion_raises():
    kv = _allocator()   # 4 pages a row, 7 usable
    kv.bind(0, slot=0, tokens=list(range(128)), need=140)
    kv.prepare_write(0, 0, 128)
    kv.prepare_write(0, 128, 129)   # registers pages 0 and 1
    kv.release(0)
    assert kv.snapshot()["pages_indexed"] == 2
    free0 = kv.snapshot()["pages_free"]
    taken = [kv._alloc_page() for _ in range(free0)]
    assert kv.snapshot()["pages_free"] == 0
    evicted = kv.pages_evicted
    taken.append(kv._alloc_page())   # an index-only page, LRU first
    assert kv.pages_evicted == evicted + 1
    with pytest.raises(PagePoolExhausted):
        for _ in range(kv.n_pages):
            taken.append(kv._alloc_page())


def test_round_need_capacity_and_no_leak():
    imp = manager(PAGE)
    kv = imp.kv
    assert (kv.round_need(1), kv.round_need(64), kv.round_need(65)) == \
        (64, 64, 128)
    # every non-scratch page is capacity: more than R * max_seq_len
    assert kv.capacity_tokens == (kv.n_pages - 1) * PAGE
    assert kv.capacity_tokens > imp.max_requests * imp.max_seq_len
    assert imp.kv.bytes_per_token() == manager(None).kv.bytes_per_token()
    rm = RequestManager(imp, GenerationConfig(max_new_tokens=4))
    with pytest.raises(ValueError):   # rejected: needs 130 > 128 slots
        rm.register_new_request(list(range(1, 127)))
    outs = rm.generate([[3, 5, 7], [2, 4, 6], [11, 13], [9, 8, 1]])
    assert [len(o) for o in outs] == [4] * 4
    _assert_pool_clean(kv)


def test_page_table_matches_reference_allocator():
    """The same bind/prepare/release sequence on the port's allocator and
    the JAX one leaves the same table, refcounts, free list and
    counters."""
    mine, ref = _allocator(2), JaxPagedKVAllocator([], 2, 256,
                                                   page_size=PAGE)
    a = list(range(1, 151))
    b = a[:140] + [7, 7, 7]
    steps = [("bind", 0, 0, a), ("prep", 0, 0, 150), ("prep", 0, 150, 152),
             ("bind", 1, 1, b), ("prep", 1, None, 143),
             ("prep", 0, 152, 200), ("release", 0), ("bind", 2, 0, a),
             ("prep", 2, None, 150), ("release", 1), ("release", 2)]
    cached = {}
    for step in steps:
        for kv in (mine, ref):
            if step[0] == "bind":
                info = kv.bind(step[1], slot=step[2], tokens=step[3],
                               align=16)
                cached[(id(kv), step[1])] = info["cached_tokens"]
            elif step[0] == "prep":
                lo = (cached[(id(kv), step[1])] if step[2] is None
                      else step[2])
                kv.prepare_write(step[1], lo, step[3])
            else:
                kv.release(step[1])
        np.testing.assert_array_equal(mine._table, ref._table)
        np.testing.assert_array_equal(mine._req_refs, ref._req_refs)
        np.testing.assert_array_equal(mine._idx_refs, ref._idx_refs)
        assert mine._free == ref._free
        for key in ("prefix_hits", "prefix_misses", "prefix_tokens_reused",
                    "cow_copies", "pages_evicted", "pages_mapped"):
            assert getattr(mine, key) == getattr(ref, key), key
    assert mine.prefix_hits == 2 and mine.cow_copies >= 1


def test_geometry_checks():
    with pytest.raises(ValueError, match="divide max_seq_len"):
        _allocator(2, 96, 64)
    with pytest.raises(ValueError, match="128-lane"):
        _allocator(2, 192, 96)   # 96 divides 192 but not the 256 pad
    with pytest.raises(ValueError, match="positive"):
        _allocator(2, 96, 0)
    kv = _allocator(2, 192, 64)
    assert kv.pages_per_row == 4 and kv.n_pages == 12
    with pytest.raises(ValueError, match="prefill tile"):
        validate_page_tile(64, 128)
    validate_page_tile(128, 64)
    with pytest.raises(ValueError, match="prefill tile"):
        manager(64, max_tokens_per_batch=128, max_seq_len=128)
    with pytest.raises(ValueError, match="multiple of 64"):
        manager(32, max_seq_len=128)   # the kernels' page rule
    with pytest.raises(ValueError, match="kv_dtype"):
        manager(None, "float16")
    with pytest.raises(ValueError, match="multiple of 64"):
        att.check_page_size(96, 192)
