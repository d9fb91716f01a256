"""Dispatch retries and fault injection in the port vs the JAX serve
stack, on the CPU.

Split from ``test_torch_lifecycle.py`` (whose helpers it uses):
``RetryPolicy``'s backoff, ``FaultInjector`` drawing the reference's fault
sequence, a stretch as one guarded dispatch, a chaos run that ends with
every request terminal and the survivors' streams unchanged, and
exhausted retries that requeue (recompute exactly) or fail (the engine
keeps serving).
"""

import pytest

from flexflow_tpu.serve import FaultInjector as JaxFaultInjector
from flexflow_tpu.serve.resilience import InjectedFault as JaxInjectedFault
from flexflow_tpu_torch.serve import (
    TERMINAL_STATUSES,
    FaultInjector,
    GenerationConfig,
    RequestManager,
    RequestStatus,
    ResilienceConfig,
    RetryPolicy,
)
from flexflow_tpu_torch.serve.resilience import InjectedFault

from test_torch_lifecycle import (
    PROMPTS,
    jax_im,
    port_im,
    quiet,
    reference_streams,
)
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_spec import _one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# retries and fault injection
# ---------------------------------------------------------------------------
def test_retry_policy_backoff_schedule():
    pol = RetryPolicy(max_retries=3, backoff_s=0.05, backoff_mult=2.0,
                      max_backoff_s=0.15)
    assert [pol.backoff(a) for a in (1, 2, 3)] == [0.05, 0.1, 0.15]


@pytest.mark.parametrize("kw", [
    dict(seed=4, p=0.5),
    dict(seed=0, p=0.2, p_by_site={"decode_scan": 0.7, "kv_swap": 0.0},
         max_faults=5)])
def test_fault_injector_draws_the_reference_sequence(kw):
    sites = ["step", "decode_scan", "prefill_scan", "kv_swap_in:3",
             "kv_swap_out:1"] * 12

    def schedule(inj, fault):
        out = []
        for i, site in enumerate(sites):
            try:
                inj.maybe_fail(site)
            except fault as e:
                out.append((i, e.site))
        return out, inj.injected, inj.calls

    got = schedule(FaultInjector(**kw), InjectedFault)
    assert got == schedule(JaxFaultInjector(**kw), JaxInjectedFault)
    assert got[0], "the schedule injected nothing"


def test_a_stretch_is_one_dispatch():
    """A prefill stretch consults only ``prefill_scan`` and a decode
    stretch only ``decode_scan`` (their inner steps never ``step``): with
    ``step`` always faulting, a run made of stretches alone is clean (5
    tokens: the prefill's first, then one 4-step stretch; a budget that is
    not a power of two leaves a one-step trailer to a ``step``)."""
    tim = port_im(jax_im())
    inj = FaultInjector(seed=0, p_by_site={"step": 1.0})
    rm = quiet(RequestManager(tim, GenerationConfig(max_new_tokens=5),
                              fault_injector=inj))
    assert rm.generate(PROMPTS) == reference_streams(PROMPTS, 5)
    assert inj.injected == 0 and inj.calls == 2 and rm.scan_runs == 1


def test_chaos_run_all_terminal_and_survivors_unchanged():
    prompts = PROMPTS + [[33, 1], [9, 8, 1, 5]]
    want = reference_streams(prompts, 6)
    tim = port_im(jax_im())
    inj = FaultInjector(seed=1, p=0.3, max_faults=4)
    rm = quiet(RequestManager(
        tim, GenerationConfig(max_new_tokens=6), fault_injector=inj,
        resilience=ResilienceConfig(retry=RetryPolicy(max_retries=5,
                                                      backoff_s=0.0))))
    got = rm.generate(prompts)
    assert inj.injected == 4 and sum(rm.retries.values()) == 4
    assert all(r.status in TERMINAL_STATUSES for r in rm.requests.values())
    assert got == want


@pytest.mark.parametrize("mode", ["requeue", "fail"])
def test_exhausted_retries(mode):
    want = reference_streams(PROMPTS, 6)
    tim = port_im(jax_im())
    # requeue: 2 sure faults, no retry; fail: every dispatch faults
    inj = FaultInjector(seed=0, p=1.0,
                        max_faults=2 if mode == "requeue" else None)
    rm = quiet(RequestManager(
        tim, GenerationConfig(max_new_tokens=6), fault_injector=inj,
        resilience=ResilienceConfig(
            retry=RetryPolicy(max_retries=0 if mode == "requeue" else 1),
            on_dispatch_failure=mode)))
    got = rm.generate(PROMPTS)
    if mode == "requeue":
        assert inj.injected == 2 and got == want
        assert all(r.requeues >= 1 for r in rm.requests.values())
        return
    assert got == [[], []]
    assert all(r.status is RequestStatus.FAILED and r.outcome == "failed"
               for r in rm.requests.values())
    assert tim.kv.attributed_rids() == []
    # the engine keeps serving: a manager without the injector
    tim.reset()
    assert RequestManager(tim, GenerationConfig(max_new_tokens=6)).generate(
        PROMPTS) == want
