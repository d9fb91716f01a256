"""The port's host page tier vs the JAX serve stack, on the CPU.

Analogues of ``tests/test_kv_tiered.py`` (its pp and brownout cases
aside) on the TINY Llama of ``test_serve.make_im`` with 64-position pages
(the kernels' smallest):

* a preempted request's pages spill to the host tier and restore at
  readmission; the streams equal the reference's unpreempted streams
  (greedy; seeded: the port's own, see ``test_torch_lifecycle.py``), on
  fp and int8 caches, and with a prefix shared with a live request;
* a restore retires the recompute feed once the catch-up prefill is done;
* a fault at either swap site, and a corrupt host page, fall back to
  recompute with the same streams; a terminal outcome drops its spill;
* the tier's LRU byte bound, its eviction order, and the checksum;
* an evicted index page is demoted to the tier and promoted back by a
  later bind with its bytes;
* a page round-trips bit for bit through ``_read_page`` and
  ``_write_page`` (bf16; f32 with int8 K/V and scale planes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.serve import (
    FaultInjector,
    GenerationConfig,
    HostPageTier,
    InferenceManager,
    PagedKVAllocator,
    RequestManager,
    RequestStatus,
    ResilienceConfig,
    build_model,
)
from flexflow_tpu_torch.serve.kv_paged import _crc, _Demoted, _HostPage, _Spill

from test_resilience import TriggerClock
from test_torch_lifecycle import (
    LONG,
    jax_im,
    port_im,
    quiet,
    reference_streams,
    tokens_of,
)
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import CFG, _one_thread  # noqa: F401

pytestmark = pytest.mark.tiered

PAGE = 64
PROMPTS = [LONG, [2, 4, 6]]   # the first spans two pages


def tiered(**kw):
    return ResilienceConfig(host_tier_bytes=64 << 20, **kw)


def flush_index(kv):
    """Evict every prefix-index entry, as a busy pool would between the
    preemption and the readmission: otherwise the readmission hits its
    own released pages and the restore has nothing left to do."""
    for key in list(kv._entries):
        kv._drop_entry(key)


def serve_spill_restore(im, gen, prompts, res=None, injector=None,
                        after=None, probe=None, arrivals=None, min_tokens=2):
    """Serve ``prompts``, preempting rid 0 once it decodes with
    ``min_tokens`` or more tokens and flushing the index (``after(rm)``
    runs next; ``probe(rm)`` at every clock read once the preemption
    fired)."""
    rm = quiet(RequestManager(im, gen, resilience=res or tiered(),
                              fault_injector=injector))
    kv = im.kv
    assert kv.host_tier is not None
    rm.scan_chunk = 2

    def ready():
        req = rm.requests.get(0)
        return (req is not None and req.status is RequestStatus.DECODING
                and min_tokens <= len(req.generated) < gen.max_new_tokens - 1
                and len(rm.requests) == len(prompts)
                and all(r.status is RequestStatus.DECODING
                        for r in rm.requests.values()))

    def fire():
        rm.preempt(0)
        flush_index(kv)
        if after is not None:
            after(rm)

    class Clock(TriggerClock):
        def __call__(self):
            t = super().__call__()
            if self.fired and probe is not None:
                probe(rm)
            return t

    clock = Clock(ready, fire)
    records = rm.serve_with_arrivals(
        arrivals or [(0.0, p, gen.max_new_tokens) for p in prompts],
        clock=clock, quantum=2)
    assert clock.fired, "the preempt trigger never armed"
    assert rm.requests[0].preemptions == 1
    assert kv.attributed_rids() == [] and kv.pages_held() == 0
    return rm, records


def counters(kv):
    return np.array([kv.pages_spilled, kv.pages_restored,
                     kv.recompute_tokens_saved, kv.restore_failures])


# ---------------------------------------------------------------------------
# spill and restore: the streams of a run that was never preempted
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("seeded", [False, True])
def test_spill_restore_streams_unchanged(seeded, kv_dtype):
    gen = GenerationConfig(max_new_tokens=10)
    im = port_im(jax_im(kv_dtype), kv_dtype, PAGE)
    if seeded:
        gen = GenerationConfig(max_new_tokens=10, temperature=0.8,
                               top_p=0.9, seed=11)
        want = RequestManager(im, gen).generate(PROMPTS)
        im.reset()
    else:
        want = reference_streams(PROMPTS, 10, kv_dtype)
    rm, records = serve_spill_restore(im, gen, PROMPTS)
    assert tokens_of(records) == want
    assert all(r["outcome"] == "ok" for r in records.values())
    kv = im.kv
    # the round trip moved pages: the first restored, the second (past
    # the tile-aligned frontier) recomputed
    assert kv.pages_spilled == 2 and kv.pages_restored == 1
    assert kv.recompute_tokens_saved == PAGE and kv.restore_failures == 0
    assert not kv.host_tier._spills, "the restore consumes the spill"
    snap = kv.snapshot()
    assert snap["pages_restored"] == 1 and snap["host_pages"] == 0
    page_bytes = sum(v.numel() * v.element_size()
                     for v in kv._page_blocks(0))
    assert snap["swap_bytes"] == 3 * page_bytes   # two out, one back


def test_spill_restore_over_a_shared_prefix():
    """The victim's first page is shared with a live request that joined
    later: the restore lands on fresh private pages, never on the page
    the survivor maps."""
    shared = LONG[:PAGE]
    prompts = [shared + [30, 31], shared + [40, 41, 42]]
    gen = GenerationConfig(max_new_tokens=16)
    want = reference_streams(prompts, 16)
    im = port_im(jax_im(), page=PAGE)
    kv = im.kv
    # the joiner binds once the first request's pages are registered
    rm, records = serve_spill_restore(
        im, gen, prompts, arrivals=[(0.0, prompts[0], 16),
                                    (0.1, prompts[1], 16)])
    assert tokens_of(records) == want
    assert kv.prefix_hits >= 1, "the joiner did not share the prefix"
    assert kv.pages_restored > 0


def test_restore_retires_the_recompute_feed_mid_serve():
    """A 60-token prompt preempted after 5 or more tokens: the restored
    span (64 positions, tile-aligned) holds generated tokens, so the
    readmission binds and restores on the whole recompute feed."""
    prompts = [LONG[:60], PROMPTS[1]]
    gen = GenerationConfig(max_new_tokens=10)
    im = port_im(jax_im(), page=PAGE)
    seen = []

    def probe(rm):
        req = rm.requests[0]
        if req.status is RequestStatus.DECODING:
            seen.append((req.kv_restored, req.prefill_src is None,
                         req.n_prefed))

    rm, records = serve_spill_restore(im, gen, prompts, probe=probe,
                                      min_tokens=5)
    assert tokens_of(records) == reference_streams(prompts, 10)
    assert im.kv.pages_restored == 1
    assert im.kv.recompute_tokens_saved == PAGE
    assert (False, True, 0) in seen, f"the feed never retired: {seen}"


# ---------------------------------------------------------------------------
# failures fall back to recompute
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", ["swap_out", "swap_in", "corrupt"])
def test_swap_failures_fall_back_to_recompute(fault):
    gen = GenerationConfig(max_new_tokens=10)
    im = port_im(jax_im(), page=PAGE)
    kv = im.kv
    inj = after = None
    if fault == "corrupt":
        def after(rm):
            kv.host_tier._spills[0].pages[0].corrupt_for_test()
    else:
        inj = FaultInjector(seed=0, p_by_site={f"kv_{fault}": 1.0})
    rm, records = serve_spill_restore(im, gen, PROMPTS, injector=inj,
                                      after=after)
    assert tokens_of(records) == reference_streams(PROMPTS, 10)
    spilled, restored, _, failures = counters(kv)
    assert restored == 0 and not kv.host_tier._spills
    if fault == "swap_out":   # every attempt faulted: nothing spilled
        assert spilled == 0 and rm.retries["kv_swap_out"] == 3
    elif fault == "swap_in":   # spilled, but every upload faulted
        assert spilled == 2 and rm.retries["kv_swap_in"] == 3
    else:
        assert spilled == 2 and failures == 1
    if inj is not None:
        assert inj.injected == 4   # the first attempt and three retries


def test_terminal_outcome_drops_the_spill():
    gen = GenerationConfig(max_new_tokens=10)
    im = port_im(jax_im(), page=PAGE)
    rm = quiet(RequestManager(im, gen, resilience=tiered()))
    for p in PROMPTS:
        rm.register_new_request(p)
    while not all(r.status is RequestStatus.DECODING
                  for r in rm.requests.values()):
        rm._tick()
    rm.preempt(0)
    assert im.kv.has_spill(0)
    rm.cancel(0)
    out = rm.serve_incr_decoding()
    assert rm.requests[0].outcome == "cancelled"
    assert out[1] == reference_streams(PROMPTS, 10)[1]
    assert not im.kv.host_tier._spills and im.kv.attributed_rids() == []


# ---------------------------------------------------------------------------
# the tier itself
# ---------------------------------------------------------------------------
def _page(nbytes=32, fill=0.0):
    blk = torch.full((nbytes // 4,), fill, dtype=torch.float32)
    return _HostPage([blk], _crc([blk]), nbytes)


def test_host_tier_lru_bound_and_eviction_order():
    tier = HostPageTier(100)
    for rid in range(3):
        assert tier.put_spill(rid, _Spill([_page()], [1, 2, 3], 3))
    assert tier.bytes_used == 96 and tier.pages_held() == 3
    assert tier.put_spill(3, _Spill([_page()], [1], 1))   # evicts rid 0
    assert tier.evictions == 1 and 0 not in tier._spills
    tier.get_spill(1)   # refreshed: rid 2 goes next
    assert tier.put_spill(4, _Spill([_page()], [1], 1))
    assert 1 in tier._spills and 2 not in tier._spills
    used = tier.bytes_used
    assert not tier.put_spill(9, _Spill([_page(128)], [1], 1))   # too big
    assert 9 not in tier._spills and tier.bytes_used == used
    # demoted index pages share the byte bound and the LRU
    assert tier.put_demoted(("f", 7), _Demoted(_page(), (1, 2), 16))
    assert tier.bytes_used <= tier.capacity_bytes and tier.evictions >= 2
    snap = tier.snapshot()
    assert snap["host_bytes"] == tier.bytes_used
    assert snap["host_spilled_requests"] == len(tier._spills)
    assert tier.pop_spill(4) is not None and tier.pop_spill(4) is None


def test_host_page_checksum_detects_corruption():
    page = _page(fill=7.0)
    assert page.verify()
    page.corrupt_for_test()
    assert not page.verify()
    # the CRC chains over every block, of every width
    blocks = [torch.ones(4, dtype=torch.bfloat16),
              torch.arange(4, dtype=torch.int8),
              torch.ones(2, dtype=torch.float32)]
    page = _HostPage(blocks, _crc(blocks), 14)
    assert page.verify()
    blocks[2][1] = 2.0
    assert not page.verify()


# ---------------------------------------------------------------------------
# the allocator's page copies
# ---------------------------------------------------------------------------
def _allocator(cfg=CFG, kv_dtype=None, max_requests=1):
    kv = PagedKVAllocator([build_model(cfg)], max_requests=max_requests,
                          max_seq_len=128, devices=[torch.device("cpu")],
                          kv_dtype=kv_dtype, page_size=PAGE)
    kv.allocate()
    g = torch.Generator().manual_seed(0)
    for bufs in kv.state.values():
        for t in bufs.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    return kv


def _page_bytes(kv, pid):
    return [v.clone() for v in kv._page_blocks(pid)]


@pytest.mark.parametrize("dtype,kv_dtype", [("bfloat16", None),
                                            ("float32", "int8")])
def test_page_round_trips_bit_for_bit(dtype, kv_dtype):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    kv = _allocator(cfg, kv_dtype)
    names = {n for _, n in kv._kv_buffers()}
    assert names == ({"k", "v", "k_scale", "v_scale"} if kv_dtype
                     else {"k", "v"})
    page = kv._read_page(1)
    assert page.verify()
    assert page.nbytes == sum(b.numel() * b.element_size()
                              for b in page.blocks)
    src = _page_bytes(kv, 1)
    kv._write_page(2, page)
    for a, b in zip(_page_bytes(kv, 2), src):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    sig = kv.swap_signature()
    assert sig[0] == PAGE and len(sig[1]) == len(page.blocks)


def test_index_page_demoted_and_promoted_back():
    kv = _allocator()
    assert kv.attach_host_tier(1 << 20) is kv.host_tier
    toks = LONG[:PAGE + 1]
    kv.bind(0, slot=0, tokens=toks)
    kv.prepare_write(0, 0, PAGE + 1)
    pid0 = int(kv._table[0, 0])
    want = _page_bytes(kv, pid0)
    kv.release(0, PAGE + 1)   # page 0 and the tail join the index
    assert sorted(k[0] for k in kv._entries) == ["f", "p"]
    # another request needs both pages: the free one and the LRU entry,
    # the full page, which is demoted to the tier
    kv.bind(1, slot=0, tokens=[5, 6, 7])
    kv.prepare_write(1, 0, 2 * PAGE)
    assert kv.pages_spilled == 1 and kv.host_tier.pages_held() == 1
    for t in kv._page_blocks(pid0):   # its device copy is overwritten
        t.zero_()
    kv.release(1, 2 * PAGE)
    # a later bind of the same prompt promotes it back with its bytes
    info = kv.bind(2, slot=0, tokens=toks)
    assert info["cached_tokens"] == PAGE
    assert kv.pages_restored == 1 and kv.recompute_tokens_saved == PAGE
    assert kv.host_tier.pages_held() == 0
    got = _page_bytes(kv, int(kv._table[0, 0]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kv.release(2, PAGE)


def test_slot_contiguous_cache_has_no_tier():
    im = InferenceManager(build_model(CFG), max_requests=2,
                          max_tokens_per_batch=16, max_seq_len=128,
                          device="cpu").init_operators_inference(seed=0)
    rm = RequestManager(im, GenerationConfig(max_new_tokens=4),
                        resilience=tiered())
    assert im.kv.host_tier is None and not im.kv.has_spill(0)
    rm.register_new_request([3, 5, 7])
    rm._tick()
    rm.preempt(0)   # recompute only
    assert rm.generate([[2, 4]])[0] and rm.requests[0].outcome == "ok"
