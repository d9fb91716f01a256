"""The port's chained decode stretch vs its unchained one and the JAX serve
stack, on the CPU (after ``tests/test_host_tick.py``).

A chained stretch issues ``decode_scan_async`` segments back to back,
registers the arrivals due at each segment boundary (the arrival pump of
``serve_with_arrivals``) and joins them into the running batch while a
slot is free (``join_slot``); per-row budgets freeze rows on the device,
whose exit codes say why.  The contract held here: one read-back per
stretch (``RequestManager.readbacks``, and the device-to-host calls the
serve package makes, counted by wrapping them), and token streams equal
to the unchained loop's and to the JAX package's chained streams, greedy
and seeded.  ``decode_scan_async`` and ``BatchConfig.join_row`` are held
against the JAX package's on the same inputs: tokens, masks and exit
codes equal.

The JAX side is ``test_serve.make_im`` (TINY Llama, 2 slots, 16 tokens a
step); its params reach the port through ``params_from_jax``.  Arrivals:
``test_serving_under_load``'s Poisson stream and virtual clock.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu_torch.serve import (
    EXIT_BUDGET,
    EXIT_EOS,
    EXIT_NOT_IN_BATCH,
    EXIT_RUNNING,
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    RequestManager,
    RequestStatus,
    ResilienceConfig,
    ServeModelConfig,
    build_model,
    params_from_jax,
)

from test_serve import TINY, make_im
from test_serving_under_load import VirtualClock, poisson_arrivals
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

CFG = ServeModelConfig(**dataclasses.asdict(TINY))
P0, P1 = [3, 5, 7], [2, 4, 6, 8]


def jax_im(**kw):
    return make_im(max_seq=kw.pop("max_seq", 64), max_requests=2, **kw)


def port_im(jim, **kw):
    """A port manager (CPU) with the JAX manager's params and
    capacities."""
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    im = InferenceManager(build_model(CFG), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu", **kw)
    return im.init_operators_inference(params_from_jax(params, CFG, "cpu"))


def per_stretch(rm):
    """Record each decode stretch's read-backs and shape."""
    seen = []
    inner = rm._decode_stretch

    def wrapper(n):
        r0 = rm.readbacks
        inner(n)
        seen.append((rm.readbacks - r0, dict(rm.last_stretch)))

    rm._decode_stretch = wrapper
    return seen


def solo(im, gen, prompt, n=None):
    im.reset()
    return RequestManager(im, gen).generate([prompt], n)[0]


def tick_until_first_token(rm, rid):
    for _ in range(8):
        if rm.requests[rid].generated:
            return
        rm._serve_tick()
    raise AssertionError("no first token in 8 ticks")


@pytest.mark.parametrize("sampled", [False, True])
def test_quantum1_vs_chained_streams(sampled):
    """The same Poisson stream through the unchained quantum-1 loop and
    the chained one: equal streams, one read-back per chained stretch,
    fewer read-backs in all."""
    rng = np.random.RandomState(9 if sampled else 3)
    arrivals = poisson_arrivals(rng, 6, rate_per_s=40.0,
                                vocab=TINY.vocab_size)
    gen = GenerationConfig(max_new_tokens=6, **(
        dict(temperature=0.8, top_p=0.9, seed=11) if sampled else {}))
    tim = port_im(jax_im())
    rm_a = RequestManager(tim, gen)
    rm_a.chain_segments = False
    rec_a = rm_a.serve_with_arrivals(list(arrivals), clock=VirtualClock(),
                                     quantum=1)
    tim.reset()
    rm_b = RequestManager(tim, gen)
    seen = per_stretch(rm_b)
    rec_b = rm_b.serve_with_arrivals(list(arrivals), clock=VirtualClock())
    assert sorted(rec_a) == sorted(rec_b)
    for rid in rec_a:
        assert rec_a[rid]["tokens"] == rec_b[rid]["tokens"], rid
    assert seen and all(n == 1 for n, _ in seen), seen
    assert rm_b.readbacks < rm_a.readbacks


def test_midstretch_join_commits_and_matches_solo():
    """A request registered at a segment boundary joins the running batch;
    its tokens commit in the stretch's one read-back, and both streams
    equal serving each alone."""
    tim = port_im(jax_im())
    gen = GenerationConfig(max_new_tokens=10)
    want0, want1 = solo(tim, gen, P0), solo(tim, gen, P1)
    tim.reset()
    rm = RequestManager(tim, gen)
    r0 = rm.register_new_request(P0)
    tick_until_first_token(rm, r0)
    joined = []
    rm._arrival_pump = lambda: joined or joined.append(
        rm.register_new_request(P1))
    n = rm._scan_steps_possible()
    assert n >= 2
    before = rm.readbacks
    rm._decode_stretch(n)
    rm._arrival_pump = None
    assert rm.readbacks - before == 1
    assert rm.last_stretch["joins"] == 1 and rm.last_stretch["segments"] == 2
    got1 = rm.requests[joined[0]].generated
    assert got1 and got1 == want1[:len(got1)]
    while rm.has_work():
        rm._serve_tick()
    assert rm.requests[r0].generated == want0
    assert rm.requests[joined[0]].generated == want1


def test_exit_codes_budget_and_eos():
    """The read-back's exit codes say why a row froze: its budget, or
    the EOS token."""
    tim = port_im(jax_im())
    toks = solo(tim, GenerationConfig(max_new_tokens=5), P0)
    tim.reset()
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=5))
    assert rm.generate([P0])[0] == toks
    assert list(rm.last_exit_codes.values()) == [EXIT_BUDGET]
    eos = toks[2]
    assert eos not in toks[:2]
    tim.reset()
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=5,
                                              eos_token_id=eos))
    assert rm.generate([P0])[0] == toks[:3]
    assert list(rm.last_exit_codes.values()) == [EXIT_EOS]


def test_exit_code_running_when_scan_chunk_bounds():
    """A row that outlives its stretch (``scan_chunk`` steps, budget
    left) reads RUNNING, not BUDGET."""
    tim = port_im(jax_im())
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=20))
    rm.scan_chunk = 8
    r0 = rm.register_new_request(P0)
    tick_until_first_token(rm, r0)
    runs = rm.scan_runs
    while rm.scan_runs == runs:
        rm._serve_tick()
    assert rm.last_exit_codes == {r0: EXIT_RUNNING}
    assert rm.last_stretch["steps"] == 8
    while rm.has_work():
        rm._serve_tick()
    assert len(rm.requests[r0].generated) == 20


def test_mixed_budgets_ride_one_stretch():
    """Rows of unequal budgets share one stretch: the short row freezes
    on the device while the long one decodes on, one read-back.  The
    stretch starts at the smaller budget rounded down to a power of two
    and extends in power-of-two segments, as the reference's does, so the
    long row's one-token trailer rides the next tick: it ends RUNNING."""
    tim = port_im(jax_im())
    gen = GenerationConfig(max_new_tokens=12)
    want0, want1 = solo(tim, gen, P0, 4), solo(tim, gen, [2, 4, 6], 12)
    tim.reset()
    rm = RequestManager(tim, gen)
    r0 = rm.register_new_request(P0, 4)
    r1 = rm.register_new_request([2, 4, 6], 12)
    seen = per_stretch(rm)
    while rm.has_work():
        rm._serve_tick()
    assert rm.requests[r0].generated == want0
    assert rm.requests[r1].generated == want1
    assert [n for n, _ in seen] == [1]
    assert seen[0][1]["segments"] >= 2
    assert rm.last_exit_codes == {r0: EXIT_BUDGET, r1: EXIT_RUNNING}


def test_chained_arrivals_match_jax_chained():
    """``serve_with_arrivals`` on its chained path, port vs the JAX
    package's chained path on the same arrivals (one malformed): the same
    streams and outcomes, and at least one mid-stretch join (the second
    arrival is due at the first segment boundary of the virtual clock's
    run, while a slot is free)."""
    rng = np.random.RandomState(5)
    arrivals = [(0.0, P0, 12), (0.075, P1, 8)] + [
        (t + 0.3, p, n) for t, p, n in poisson_arrivals(
            rng, 5, rate_per_s=30.0, vocab=TINY.vocab_size, max_new=8)]
    arrivals.append((0.4, [], 4))                     # rejected: empty
    jim = jax_im()
    want = JaxRequestManager(jim, JaxGenerationConfig(
        max_new_tokens=8)).serve_with_arrivals(list(arrivals),
                                               clock=VirtualClock())
    tim = port_im(jim)
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=8))
    seen = per_stretch(rm)
    got = rm.serve_with_arrivals(list(arrivals), clock=VirtualClock())
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid]["tokens"] == want[rid]["tokens"], rid
        assert got[rid]["outcome"] == want[rid]["outcome"], rid
    assert "rejected" in [r["outcome"] for r in got.values()]
    assert sum(s["joins"] for _, s in seen) >= 1
    assert all(n == 1 for n, _ in seen)
    joined = [r for r in got.values() if "prefill_start_s" in r
              and r["outcome"] == "ok"]
    for r in joined:
        assert (r["queue_wait_s"] + r["prefill_s"]
                == pytest.approx(r["first_token_s"] - r["arrival_s"]))


def test_join_under_page_exhaustion_requeues_and_finishes():
    """A joiner that finds no free page goes back to the head of the
    queue (``_unjoin``: no preemption inside a running chain) and
    finishes on the per-step path once pages are back."""
    tim = port_im(jax_im(max_seq=128), kv_page_size=64)
    gen = GenerationConfig(max_new_tokens=10)
    want1 = solo(tim, gen, P1)
    tim.reset()
    kv = tim.kv
    rm = RequestManager(tim, gen, resilience=ResilienceConfig(
        preemption=True))
    r0 = rm.register_new_request(P0)
    tick_until_first_token(rm, r0)
    stolen = [kv._free.pop() for _ in range(len(kv._free))]
    joined = []
    rm._arrival_pump = lambda: joined or joined.append(
        rm.register_new_request(P1))
    rm._decode_stretch(rm._scan_steps_possible())
    rm._arrival_pump = None
    req1 = rm.requests[joined[0]]
    assert rm.last_stretch["joins"] == 0
    assert req1.status is RequestStatus.PENDING and req1.slot == -1
    assert rm.pending[0] == req1.rid and req1.prefill_offset == 0
    kv._free.extend(stolen)
    while rm.has_work():
        rm._serve_tick()
    assert req1.generated == want1
    assert len(rm.requests[r0].generated) == 10


def test_no_host_read_inside_a_chained_stretch(monkeypatch):
    """The serve package's device-to-host calls during a stretch with a
    join, counted by wrapping them: exactly one copy back (the stretch's
    read-back), and no scalar read."""
    calls = {}
    for name in ("cpu", "item", "tolist", "numpy", "__int__", "__bool__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("flexflow_tpu_torch.serve"):
                calls[_name] = calls.get(_name, 0) + 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    tim = port_im(jax_im())
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=10))
    r0 = rm.register_new_request(P0)
    tick_until_first_token(rm, r0)
    rm._arrival_pump = lambda: rm.pending or len(rm.requests) > 1 or \
        rm.register_new_request(P1)
    calls.clear()
    rm._decode_stretch(rm._scan_steps_possible())
    assert rm.last_stretch["joins"] == 1
    assert calls == {"cpu": 1, "numpy": 1}, calls


def test_pending_blocks_a_stretch_only_when_it_could_act():
    """Pending work blocks a chained stretch only while a slot is free or
    a preemption would fire (``_preempt_would_fire``); unchained, any
    pending work blocks."""
    tim = port_im(jax_im())
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=10),
                        resilience=ResilienceConfig(preemption=True))
    for p in (P0, P1):
        rm.register_new_request(p)
    while not all(r.generated for r in rm.requests.values()):
        rm._serve_tick()
    rm.register_new_request([9, 9, 1])            # priority 0: no victim
    assert not rm._preempt_would_fire()
    assert rm._scan_steps_possible() > 1
    rm.chain_segments = False
    assert rm._scan_steps_possible() == 0
    rm.chain_segments = True
    rm.register_new_request([7, 1], priority=5)   # would preempt a row
    assert rm._preempt_would_fire()
    assert rm._scan_steps_possible() == 0


def _prefilled_pair(jim, tim):
    """Both managers prefill P0 and P1 (slots 0, 1) in one flat step;
    returns the first tokens."""
    args = (P0 + P1, [0] * 3 + [1] * 4, [0, 1, 2, 0, 1, 2, 3], [3, 4])
    jim.allocate_kv_cache()
    tim.reset()
    jt = np.asarray(jim.step(JaxBatchConfig.build(
        *args, max_tokens=16, max_requests=2)).token_ids)
    tt = tim.step(BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                    device="cpu")).token_ids.numpy()
    assert jt[[2, 6]].tolist() == tt[[2, 6]].tolist()
    return tt[[2, 6]].tolist()


def test_decode_scan_async_matches_jax():
    """``decode_scan_async`` on the same batch, budgets and EOS as the JAX
    package's: tokens, emission masks and exit codes equal."""
    jim = jax_im()
    tim = port_im(jim)
    eos = None
    for _ in range(2):
        first = _prefilled_pair(jim, tim)
        args = (first, [0, 1], [3, 4], [4, 5])
        allowed = np.zeros(16, np.int32)
        allowed[:2] = [3, 8]
        jt, jl, jc, _ = jim.decode_scan_async(
            JaxBatchConfig.build(*args, max_tokens=16, max_requests=2), 6,
            eos=eos, allowed=jnp.asarray(allowed), max_position=4)
        tt, tl, tc, _ = tim.decode_scan_async(
            BatchConfig.build(*args, max_tokens=16, max_requests=2,
                              device="cpu"), 6, eos=eos,
            allowed=torch.from_numpy(allowed), max_position=4)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        # a frozen row's tokens are not emissions: compare the live ones
        np.testing.assert_array_equal(np.where(tl.numpy(), tt.numpy(), -1),
                                      np.where(jl, np.asarray(jt), -1))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        if eos is None:
            assert tc.tolist()[:3] == [EXIT_BUDGET, EXIT_RUNNING,
                                       EXIT_NOT_IN_BATCH]
            eos = int(tt[1, 1])    # row 1's second decode token
            assert eos not in tt[:1, 1].tolist()
    assert tc.tolist()[1] == EXIT_EOS


def test_join_row_matches_jax():
    """``join_row`` splices the same row into the same batch as the JAX
    package's, active and frozen."""
    args = ([5, 6, 0], [0, 1, -1], [3, 4, 0], [4, 5, 0, 0])
    jbc = JaxBatchConfig.build(*args, max_tokens=8, max_requests=4)
    tbc = BatchConfig.build(*args, max_tokens=8, max_requests=4,
                            device="cpu")
    for active in (True, False):
        j = jbc.join_row(2, 9, 3, 7, 8, 3, active=active)
        t = tbc.join_row(2, torch.tensor(9), 3, 7, 8, 3,
                         active=torch.tensor(active))
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                          np.asarray(getattr(j, f.name)))
