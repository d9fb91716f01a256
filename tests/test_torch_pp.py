"""The port's pipeline-parallel serving vs the JAX package's, on the CPU.

The JAX side is the reference's own ``test_pp_serve.make_pp_im`` (its
``PipelinedInferenceManager`` over the conftest's virtual CPU devices,
``use_pallas=False``: the same function as its Pallas kernels and a
quicker compile; the values and streams held here do not depend on it,
``test_torch_pp_paths.py`` holds the schedule with it on); the port's
managers hold its params
(``params_from_jax``) and live on ``["cpu"] * (pp * tp)``, cached per
configuration as the reference caches its own.  Held:

* the stage split equals the reference's ``serve_stage_split`` node for
  node, with the same tensor ids at every cut, for each family at TINY
  with ``pp=2`` and TINY4 with ``pp=4``; too many stages raise;
* seeded weights equal ``pp=1``'s (OPT's modules register ``project_out``
  before its layers, so the draw follows the global model's order);
* a mixed step, a tiled and gated prefill step, ``decode_scan`` and
  ``decode_scan_async`` (budgets, EOS and exit codes): logits within
  ``atol=rtol=1e-5`` of the JAX pipelined manager's (float32; the gather
  path against the port's plain kernels), tokens, live masks and codes
  equal to it, and logits and caches equal to the port's ``pp=1`` bit for
  bit (the CPU's products do not depend on a micro-batch's row count);
* greedy streams equal to the JAX manager's and the port's ``pp=1`` at
  ``n_micro`` 1, 2 and 4, with int8 weights and int8 KV, at ``pp=2 x
  tp=2`` and at ``pp=4``;
* per-stage memory: ``stage_memory_bytes``, the cost card and the memory
  ledger's predicted and allocated records equal the reference's;
* a count of micro-batches that does not divide the batch warns and
  falls back, and ``SpecDecodeScan`` refuses a pipelined target;
* the graph runs the modules the model holds: a submodule swapped in
  after the graph was recorded is the one that runs.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import flexflow_tpu.obs as JO
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.obs.profiler import plan_cost_card as jax_card
from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve import build_model as jax_build_model
from flexflow_tpu.serve import quantize_int8 as jax_quantize_int8
from flexflow_tpu.serve import serve_stage_split as jax_stage_split
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
from flexflow_tpu_torch.obs.profiler import plan_cost_card
from flexflow_tpu_torch.parallel import make_mesh

from test_pp_serve import TINY4, make_pp_im
from test_serve import TINY
from test_torch_zoo import configs, params_np
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6]]
_PORT = {}


def port_cfg(jcfg):
    return PS.ServeModelConfig(**dataclasses.asdict(jcfg))


def jax_pim(axes=None, pallas=False, **kw):
    """The reference's pipelined manager: the gather path, or with
    ``pallas`` its Pallas kernels in interpret mode, under which its
    request manager tiles prefill chunks and aligns prefix reuse to the
    tile as the port's does (the schedule; the values are the same)."""
    return make_pp_im(axes or {"pp": 2}, use_pallas=pallas, **kw)


def port_pim(jpim, cfg=TINY, n_micro=None, **kw):
    """A port pipelined manager with the JAX manager's mesh shape,
    capacities and params, cached per configuration."""
    caps = dict(max_requests=jpim.max_requests,
                max_tokens_per_batch=jpim.max_tokens,
                max_seq_len=jpim.max_seq_len, kv_dtype=jpim.kv_dtype,
                kv_page_size=jpim.kv_page_size,
                max_spec_tokens=jpim.max_spec_tokens, topk=jpim.topk)
    caps.update(kw)
    axes = {"pp": jpim.pp, "tp": jpim.tp}
    pcfg = port_cfg(cfg)
    key = (tuple(axes.items()), n_micro, repr(pcfg),
           tuple(sorted(caps.items())))
    im = _PORT.get(key)
    if im is None:
        im = _PORT[key] = PS.PipelinedInferenceManager(
            PS.build_model(pcfg), mesh=make_mesh(axes, ["cpu"] * (
                jpim.pp * jpim.tp)), n_micro=n_micro or jpim.n_micro, **caps)
    return im.init_operators_inference(
        PS.params_from_jax(params_np(jpim), pcfg, "cpu"))


def port_one(pim):
    """The port's ``pp=1`` manager on the same params and capacities."""
    im = PS.InferenceManager(
        PS.build_model(pim.model.config), max_requests=pim.max_requests,
        max_tokens_per_batch=pim.max_tokens, max_seq_len=pim.max_seq_len,
        kv_dtype=pim.kv_dtype, kv_page_size=pim.kv_page_size, device="cpu")
    return im.init_operators_inference(pim.params)


def greedy(n=6, **kw):
    return (JaxGenerationConfig(max_new_tokens=n, **kw),
            PS.GenerationConfig(max_new_tokens=n, **kw))


def streams(jim, pims, prompts=PROMPTS, n=6, **kw):
    """The JAX manager's greedy streams, and each port manager's."""
    jgen, pgen = greedy(n, **kw)
    want = JaxRequestManager(jim, jgen).generate(prompts)
    return want, [PS.RequestManager(im, pgen).generate(prompts)
                  for im in pims]


def global_state(pim):
    """The caches of every stage at their global heads: a head-sharded
    layer's shards concatenated in rank order."""
    out = {}
    for st in pim.stages:
        for name in st.state:
            parts = [state[name] for state in st.states]
            out[name] = {buf: (torch.cat([p[buf] for p in parts], dim=1)
                               if pim.kv._head_shards[name] > 1
                               else parts[0][buf]) for buf in ("k", "v")}
    return out


def assert_states_close(jstate, pstate, depths):
    """Every slot's K and V up to its cache depth (``depths[slot]``)
    within the tolerance (past it a tile's pads land in the reference's
    cache, a position no read reaches)."""
    assert set(jstate) == set(pstate)
    for name, bufs in jstate.items():
        for buf in ("k", "v"):
            for slot, n in enumerate(depths):
                np.testing.assert_allclose(
                    pstate[name][buf][slot, :, :n].float().numpy(),
                    np.asarray(bufs[buf], np.float32)[slot, :, :n], **TOL,
                    err_msg=f"{name}.{buf}")


def assert_states_equal(a, b):
    assert set(a) == set(b)
    for name in a:
        for buf in a[name]:
            assert torch.equal(a[name][buf], b[name][buf]), f"{name}.{buf}"


def check_step(jpim, pim, one, jbc, pbc, depths=(3, 2)):
    """One step on the three managers: the JAX tokens and logits, the
    port's pp=1 logits and caches bit for bit."""
    jr, pr, r1 = jpim.step(jbc), pim.step(pbc), one.step(pbc)
    assert np.array_equal(np.asarray(jr.token_ids), pr.token_ids.numpy())
    np.testing.assert_allclose(pr.logits_max.numpy(),
                               np.asarray(jr.logits_max), **TOL)
    assert torch.equal(pr.logits, r1.logits)
    assert torch.equal(pr.token_ids, r1.token_ids)
    assert_states_close(jpim.state, pim.state, depths)
    assert_states_equal(pim.state, one.state)


# ---------------------------------------------------------------------------
# the stage split and the weights
# ---------------------------------------------------------------------------
def test_stage_split_equals_reference_for_every_family():
    cases = [(TINY, 2), (TINY4, 4)] + [
        (configs(f)[0], 2) for f in ("opt", "opt_post_ln", "falcon_7b",
                                     "falcon_rw", "mpt", "starcoder")]
    for jcfg, pp in cases:
        ff = FFModel(FFConfig())
        jax_build_model(ff, jcfg, 16)
        want = [([n.name for n in nodes], entry, exit_)
                for nodes, entry, exit_ in jax_stage_split(ff.graph, pp)]
        model = PS.build_model(port_cfg(jcfg))
        got = [([n.name for n in nodes], entry, exit_)
               for nodes, entry, exit_ in PS.serve_stage_split(model.graph,
                                                               pp)]
        assert got == want, jcfg.model_type
        with pytest.raises(ValueError, match="attention layers"):
            PS.serve_stage_split(model.graph, jcfg.num_hidden_layers + 1)
    # TINY Llama: a two-tensor cut, stage 1 starting at its attention
    split = PS.serve_stage_split(PS.build_model(port_cfg(TINY)).graph, 2)
    assert len(split[0][2]) == 2
    assert split[1][0][0].name == "model.layers.1.self_attn"


@pytest.mark.parametrize("family", ["llama_pp2_tp2", "opt_post_ln"])
def test_seeded_weights_equal_pp1(family):
    if family == "opt_post_ln":
        cfg, axes = configs("opt_post_ln")[1], {"pp": 2}
    else:
        cfg, axes = port_cfg(TINY), {"pp": 2, "tp": 2}
    n = axes["pp"] * axes.get("tp", 1)
    pim = PS.PipelinedInferenceManager(
        PS.build_model(cfg), max_requests=2, max_tokens_per_batch=16,
        max_seq_len=64, mesh=make_mesh(axes, ["cpu"] * n)
    ).init_operators_inference(seed=11)
    one = PS.InferenceManager(
        PS.build_model(cfg), max_requests=2, max_tokens_per_batch=16,
        max_seq_len=64, device="cpu").init_operators_inference(seed=11)
    want = dict(one.model.named_parameters())
    got = pim.params
    assert set(got) == set(want)
    for name, p in want.items():
        assert torch.equal(got[name], p), name
    # each stage holds only its own layers' weights and caches
    for st in pim.stage_plans:
        names = {n.name for n in st.nodes}
        held = {n for n, _ in st.shards[0].named_parameters()}
        assert held and all(n.rsplit(".", 1)[0] in names for n in held)
        attn = {n.name for n in st.nodes if n.kind == "attention"}
        assert set(st.state) == attn


# ---------------------------------------------------------------------------
# steps and scans against the JAX pipelined manager
# ---------------------------------------------------------------------------
def test_mixed_step_matches_reference_and_pp1():
    jpim = jax_pim()
    pim = port_pim(jpim)
    args = ([3, 5, 7, 11, 2], [0, 0, 0, 1, 1], [0, 1, 2, 0, 1], [3, 2])
    check_step(jpim, pim, port_one(pim),
               JaxBatchConfig.build(*args, max_tokens=16, max_requests=2),
               PS.BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                    device="cpu"))


def test_tiled_gated_prefill_step_matches_reference_and_pp1():
    jpim = jax_pim()
    pim = port_pim(jpim)
    segs, lens = [(0, [3, 5, 7], 0), (1, [11, 2], 0)], [3, 2]
    jbc, _ = JaxPrefillBatchConfig.build(segs, lens, tile_size=8,
                                         max_tokens=16, max_requests=2,
                                         gate_slots=[0, 1])
    pbc, _ = PS.PrefillBatchConfig.build(segs, lens, 8, max_tokens=16,
                                         max_requests=2, device="cpu",
                                         gate_slots=[0, 1])
    check_step(jpim, pim, port_one(pim), jbc, pbc)
    assert pim.step(pbc).token_ids.shape == (2,)   # gated: one per slot


def _first_token_bcs(jpim, pim, prompts):
    """Prefill ``prompts`` on both sides through their request managers
    (one new token) and return the decode batch that continues them."""
    jgen, pgen = greedy(1)
    firsts = JaxRequestManager(jpim, jgen).generate(prompts)
    assert PS.RequestManager(pim, pgen).generate(prompts) == firsts
    args = ([f[-1] for f in firsts], list(range(len(prompts))),
            [len(p) for p in prompts], [len(p) + 1 for p in prompts])
    return (JaxBatchConfig.build(*args, max_tokens=16, max_requests=2),
            PS.BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                 device="cpu"))


def test_decode_scan_matches_reference():
    jpim = jax_pim(max_seq=64)
    pim = port_pim(jpim)
    jbc, pbc = _first_token_bcs(jpim, pim, PROMPTS)
    jt, jl, _ = jpim.decode_scan(jbc, 6)
    pt, pl, _ = pim.decode_scan(pbc, 6)
    assert np.array_equal(np.asarray(jt), pt.numpy())
    assert np.array_equal(np.asarray(jl), pl.numpy())
    assert_states_close(jpim.state, pim.state, [len(p) + 6 for p in PROMPTS])


def test_decode_scan_async_budgets_and_eos_match_reference_and_pp1():
    """Budgets of 2 and 6 steps and an EOS that one row emits: tokens,
    live masks and exit codes equal the JAX pipelined scan's and the
    port's single-stage scan's."""
    jpim = jax_pim(max_seq=64)
    pim = port_pim(jpim)
    jbc, pbc = _first_token_bcs(jpim, pim, PROMPTS)
    probe, _, _ = pim.decode_scan(pbc, 6)
    eos = int(probe[3, 1])
    allowed = np.zeros(16, np.int32)
    allowed[:2] = [2, 6]
    jpim.reset()
    pim.reset()
    jbc, pbc = _first_token_bcs(jpim, pim, PROMPTS)
    want = jpim.decode_scan_async(jbc, 6, eos=eos, allowed=allowed,
                                  max_position=5)
    got = pim.decode_scan_async(pbc, 6, eos=eos,
                                allowed=torch.from_numpy(allowed),
                                max_position=5)
    one = port_one(pim)
    PS.RequestManager(one, greedy(1)[1]).generate(PROMPTS)
    ref = one.decode_scan_async(pbc, 6, eos=eos,
                                allowed=torch.from_numpy(allowed),
                                max_position=5)
    live = got[1].numpy()
    assert np.array_equal(np.asarray(want[1]), live)
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    # a frozen row's emission is never read: held where live
    assert np.array_equal(np.asarray(want[0])[live], got[0].numpy()[live])
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)
    assert got[2][:2].tolist() == [PS.EXIT_BUDGET, PS.EXIT_EOS]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------
def test_generate_streams_match_reference_and_pp1_with_eos():
    jpim = jax_pim(max_seq=64)
    pim = port_pim(jpim)
    want, (got, one) = streams(jpim, [pim, port_one(pim)], n=12)
    assert got == want == one
    eos = want[0][5]
    jpim.reset()
    pim.reset()
    want, (got,) = streams(jpim, [pim], n=12, eos_token_id=eos)
    assert got == want and got[0][-1] == eos


def test_microbatch_count_leaves_streams_unchanged():
    prompts = PROMPTS + [[9, 8, 7, 6, 5, 4], [1, 2]]
    jpim = jax_pim(max_requests=4)
    outs = [PS.RequestManager(port_pim(jpim, n_micro=m),
                              greedy()[1]).generate(prompts)
            for m in (1, 2, 4)]
    want, (one,) = streams(jpim, [port_one(port_pim(jpim))], prompts)
    assert outs[0] == outs[1] == outs[2] == want == one


def test_int8_weights_and_kv_match_reference():
    prompts = [[3, 11, 25, 40, 7, 9, 13, 2, 5], [2, 4, 6]]
    jpim = jax_pim(kv_dtype="int8", seed=19)
    jax_quantize_int8(jpim)
    pim = port_pim(jpim)
    assert pim.stages[0].shards[0].model.layers[0].mlp.up_proj.kernel.dtype \
        == torch.int8
    want, (got, one) = streams(jpim, [pim, port_one(pim)], prompts)
    assert got == want == one


def test_pp2_tp2_matches_reference():
    jpim = jax_pim({"pp": 2, "tp": 2})
    pim = port_pim(jpim)
    assert [len(st.shards) for st in pim.stages] == [2, 2]
    args = ([3, 5, 7, 11, 2], [0, 0, 0, 1, 1], [0, 1, 2, 0, 1], [3, 2])
    jr = jpim.step(JaxBatchConfig.build(*args, max_tokens=16,
                                        max_requests=2))
    pr = pim.step(PS.BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                       device="cpu"))
    np.testing.assert_allclose(pr.logits_max.numpy(),
                               np.asarray(jr.logits_max), **TOL)
    assert_states_close(jpim.state, global_state(pim), (3, 2))
    jpim.reset()
    pim.reset()
    want, (got, one) = streams(jpim, [pim, port_one(pim)])
    assert got == want == one
    # each stage's shards split its heads; no shard holds another's layer
    for st in pim.stages:
        for m, state in zip(st.shards, st.states):
            assert set(state) == {n.name for n in st.nodes
                                  if n.kind == "attention"}
            assert all(b["k"].shape[1] == 1 for b in state.values())


def test_pp4_matches_reference():
    jpim = jax_pim({"pp": 4}, cfg=TINY4, max_seq=48)
    pim = port_pim(jpim, cfg=TINY4)
    assert len(pim.stages) == 4 and pim.plan_key == "tp1_pp4_m4"
    want, (got,) = streams(jpim, [pim], [[5, 9, 2, 11, 3]], n=5)
    assert got == want


# ---------------------------------------------------------------------------
# memory and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["fp", "int8_tp2"])
def test_stage_memory_equals_reference(case):
    """``stage_memory_bytes``, the cost card, and the ledger's predicted
    and allocated records (per device: the maximum over stages) equal the
    reference's, exactly."""
    if case == "fp":
        jpim = jax_pim(max_seq=64)
    else:
        jpim = jax_pim({"pp": 2, "tp": 2}, kv_dtype="int8", seed=23)
        jax_quantize_int8(jpim)
    pim = port_pim(jpim)
    assert pim.stage_memory_bytes() == jpim.stage_memory_bytes()
    assert dataclasses.asdict(plan_cost_card(pim)) == \
        dataclasses.asdict(jax_card(jpim))
    jt, pt = JO.Telemetry(), PO.Telemetry()
    jpim.publish_memory(jt)
    pim.publish_memory(pt)
    assert pt.memory.report() == jt.memory.report()
    assert pim.kv.allocated_bytes() == jpim.kv.allocated_bytes(
        kv_only=False)
    assert pim.kv.bytes_per_token() == jpim.kv.bytes_per_token()


def test_microbatch_fallback_warns_and_spec_scan_refuses():
    model = PS.build_model(port_cfg(TINY))
    with pytest.warns(UserWarning, match="n_micro=3 does not divide"):
        pim = PS.PipelinedInferenceManager(
            model, max_requests=2, max_tokens_per_batch=16, max_seq_len=32,
            max_spec_tokens=7, topk=2,
            mesh=make_mesh({"pp": 2}, ["cpu"] * 2), n_micro=3)
    assert pim.n_micro == 2 and pim.plan_key == "tp1_pp2_m2"
    assert not hasattr(pim, "prefill_scan")
    with pytest.raises(ValueError, match="host SpecInferManager"):
        PS.SpecDecodeScan(pim, pim)
    with pytest.raises(ValueError, match="'pp' axis"):
        PS.InferenceManager(model, mesh=make_mesh({"pp": 2}, ["cpu"] * 2))
    with pytest.raises(ValueError, match="'pp' axis"):
        PS.PipelinedInferenceManager(model, mesh=make_mesh({"tp": 1},
                                                           ["cpu"]))


def test_graph_runs_the_modules_the_model_holds():
    """Nodes name their modules by path, so a submodule swapped in after
    the graph was recorded is the one that runs, at any depth of the path
    (``chip_smoke.py``'s perfect draft shares a larger model's layers
    so), and swapping it back restores the first forward; the lookup
    keeps no dropped model alive."""
    cfg = port_cfg(TINY)
    a, b = (PS.InferenceManager(
        PS.build_model(cfg), max_requests=2, max_tokens_per_batch=16,
        max_seq_len=64, device="cpu").init_operators_inference(seed=s)
        for s in (1, 2))
    bc = PS.BatchConfig.build([5, 7], [0, 1], [3, 3], [4, 4], max_tokens=16,
                              max_requests=2, device="cpu")

    def logits(im):
        im.reset()
        return im.forward(bc)

    want_a, want_b = logits(a), logits(b)
    assert not torch.equal(want_a, want_b)
    ma, mb = a.model, b.model
    mine = (ma.model.layers, ma.model.embed_tokens, ma.model.norm,
            ma.lm_head)
    ma.model.layers = mb.model.layers          # a ModuleList above leaves
    ma.model.embed_tokens = mb.model.embed_tokens
    ma.model.norm = mb.model.norm
    ma.lm_head = mb.lm_head
    assert torch.equal(logits(a), want_b)
    (ma.model.layers, ma.model.embed_tokens, ma.model.norm,
     ma.lm_head) = mine
    assert torch.equal(logits(a), want_a)
    # the kept lookup holds no reference to its model: a dropped model is
    # freed at once, not when the cycle collector runs
    model = PS.build_model(cfg)
    assert len(model.span_ops()) == len(model.graph.nodes)
    ref = weakref.ref(model)
    gc.disable()
    try:
        del model
        assert ref() is None
    finally:
        gc.enable()
