"""Builder graphs served by the port vs the JAX package, on the CPU.

The reference serves graphs its ``FFModel`` builder recorded
(``tests/test_serve.py:58-61``: ``FFModel``, ``build_model(ff, cfg,
max_tokens)``, ``InferenceManager(ff, ...)``).  Here the reference's
family builders (``flexflow_tpu/serve/models/*.py``) record on the port's
``FFModel`` too, and the port's ``build_model(ff, cfg, max_tokens)``
replays its families' graphs as the same builder calls: all three graphs
agree in node names, op types, ``attr_signature()``, wiring and parameter
keys and shapes.  ``InferenceManager(ff)`` then serves the port's graph
with the reference's weights (``params_from_jax``): step logits and caches
at ``atol=rtol=1e-5`` (float32) and identical greedy streams, against the
JAX managers over the same builder graphs (Pallas in interpret mode
where its schedule tiles prefill, its gather path elsewhere), on the
incremental (Llama, OPT's learned positions), int8 + paged, speculative
(a ``tree_inc_...`` target and a ``spec_inc_...`` draft: host loop and
``SpecDecodeScan``), ``tp=2`` and ``pp=2`` paths.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.serve as JS
import flexflow_tpu_torch as T
import flexflow_tpu_torch.serve as PS
from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
from flexflow_tpu.serve.inference_manager import (
    tensor_parallel_strategy as jax_strategy,
)
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.serve.cost import memory_parts, recorded_capacities
from flexflow_tpu_torch.serve.models.builder import BuilderModel

from test_pp_serve import make_pp_im
from test_serve import TINY, make_im
from test_torch_spec import JAX_SSM, _both_tree_bcs, _tree_masks
from test_torch_zoo import configs, jax_im, params_np
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
INC, SPEC, TREE = ("inc_multihead_self_attention",
                   "spec_inc_multihead_self_attention",
                   "tree_inc_multihead_self_attention")
FAMILIES = {"llama": (TINY, PS.ServeModelConfig(**dataclasses.asdict(TINY))),
            "opt": configs("opt"), "falcon": configs("falcon_rw"),
            "mpt": configs("mpt"), "starcoder": configs("starcoder")}


class Redirect:
    """An ``FFModel`` (either package's) whose
    ``inc_multihead_self_attention`` records through another builder
    method: a family's graph with the speculative draft's or the
    verifier's attention."""

    def __init__(self, ff, method):
        self._ff, self._method = ff, method

    def __getattr__(self, name):
        return getattr(self._ff, name)

    def inc_multihead_self_attention(self, *args, **kw):
        return getattr(self._ff, self._method)(*args, **kw)


def port_ff(jcfg, max_tokens, attention=INC):
    """The port's ``FFModel`` (CPU) holding the graph the reference's
    family builder records on it."""
    ff = T.FFModel(T.FFConfig(), device="cpu")
    JS.build_model(Redirect(ff, attention), jcfg, max_tokens)
    return ff


def port_im(jim, jcfg, attention=INC, **kw):
    """``InferenceManager(ff)`` over the port's builder graph with the JAX
    manager's params and capacities."""
    caps = dict(max_requests=jim.max_requests,
                max_tokens_per_batch=jim.max_tokens,
                max_seq_len=jim.max_seq_len,
                max_spec_tokens=jim.max_spec_tokens, topk=jim.topk,
                kv_dtype=jim.kv_dtype, kv_page_size=jim.kv_page_size,
                device="cpu")
    caps.update(kw)
    if "mesh" in caps:
        caps.pop("device")
    im = PS.InferenceManager(port_ff(jcfg, jim.max_tokens, attention),
                             **caps)
    cfg = PS.ServeModelConfig(**dataclasses.asdict(jcfg))
    return im.init_operators_inference(
        PS.params_from_jax(params_np(jim), cfg, "cpu"))


_JIM = {}


def jax_builder_im(jcfg, attention, seed, **caps):
    """The reference's ``InferenceManager(ff)`` over its family's graph
    recorded with ``attention``, one device (cached per configuration,
    re-seeded per call, as ``test_serve.make_im``)."""
    key = (repr(jcfg), attention, tuple(sorted(caps.items())))
    im = _JIM.get(key)
    if im is None:
        ff = J.FFModel(J.FFConfig(),
                       mesh=jax_make_mesh({"tp": 1}, jax.devices()[:1]))
        JS.build_model(Redirect(ff, attention), jcfg, caps["max_tokens"])
        im = _JIM[key] = JS.InferenceManager(
            ff, max_requests=caps["max_requests"],
            max_tokens_per_batch=caps["max_tokens"],
            max_seq_len=caps["max_seq"], max_spec_tokens=caps["max_spec"],
            topk=caps.get("topk", 0))
    im.tree_token_layout = None
    return im.init_operators_inference(rng=jax.random.PRNGKey(seed))


def streams(jim, tim, prompts=PROMPTS, n=8):
    want = JS.RequestManager(jim, JS.GenerationConfig(
        max_new_tokens=n)).generate(prompts)
    got = PS.RequestManager(tim, PS.GenerationConfig(
        max_new_tokens=n)).generate(prompts)
    return got, want


def graph_record(g):
    """What two builder graphs must share, node by node."""
    specs = g.param_specs()
    return [(n.name, n.op.type_name, n.op.attr_signature(), list(n.inputs),
             list(n.outputs),
             {p: tuple(s.spec.shape) for p, s in specs.get(n.name,
                                                           {}).items()})
            for n in g.nodes]


# ---------------------------------------------------------------------------
# the graphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_builders_record_the_reference_graph(family):
    """The reference's family builder on the reference's ``FFModel`` and
    on the port's, and the port's ``build_model(ff, cfg, T)`` (its
    family's graph replayed as builder calls), for each attention
    method the family takes (ALiBi only through ``inc_...``)."""
    jcfg, cfg = FAMILIES[family]
    # Falcon's and MPT's builders pass use_alibi, which only inc_... takes
    methods = [INC] if family in ("falcon", "mpt") else [INC, SPEC, TREE]
    for method in methods:
        jff = J.FFModel(J.FFConfig())
        JS.build_model(Redirect(jff, method), jcfg, 8)
        want = graph_record(jff.graph)
        got = graph_record(port_ff(jcfg, 8, method).graph)
        ff = T.FFModel(T.FFConfig(), device="cpu")
        logits = PS.build_model(ff, cfg, 8, attention=method)
        assert got == want
        assert graph_record(ff.graph) == want
        assert logits.tid == jff.graph.nodes[-1].outputs[-1]
        assert [str(ff.graph.spec(t).dtype) for t in range(len(
            ff.graph.tensor_specs))] == [
            "torch." + np.dtype(s.dtype).name for s in jff.graph.tensor_specs]
        assert sum(n.op.type_name == method for n in ff.graph.nodes) == \
            jcfg.num_hidden_layers
    # the modules a manager serves sit at the node names: the state dict
    # is the reference's params' names
    model = BuilderModel(ff)
    assert set(model.state_dict()) == {
        f"{n}.{p}" for n, g in jff.graph.param_specs().items() for p in g}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def jax_step(jim, bc, layout=None):
    """The JAX step's float32 logits through its page table when paged
    (its caches advance too)."""
    base = bc if isinstance(bc, JaxBatchConfig) else bc.base
    outs, state = jim._fwd(
        jim.params, {jim._token_tid: base.tokens}, state=jim.state,
        extras={"batch_config": bc, "pallas_decode": jim.use_pallas,
                "pallas_interpret": jim.pallas_interpret,
                "tree_layout": layout, "qkv0": None,
                "pages": jim.kv.page_view() if jim.kv_page_size else None})
    jim.state = state
    return np.asarray(outs[0], np.float32)


def _prefill_then_decode(jim, tim, prompt):
    """A tiled prefill step of ``prompt`` in slot 0, then a decode step:
    the logits of the real tokens, and the caches (slot-contiguous ones;
    a paged manager maps the slot's pages first)."""
    n = len(prompt)
    if tim.kv_page_size:
        for im in (jim, tim):
            im.kv.bind(0, slot=0)
            im.kv.prepare_write(0, 0, n + 1)
    segs, lens = [(0, prompt, 0)], [n]
    jbc, _ = JaxPrefillBatchConfig.build(segs, lens, jim.prefill_tile,
                                         max_tokens=8, max_requests=2)
    tbc, _ = PS.PrefillBatchConfig.build(segs, lens, tim.prefill_tile,
                                         max_tokens=8, max_requests=2,
                                         device="cpu")
    np.testing.assert_allclose(tim.forward(tbc)[:n].numpy(),
                               jax_step(jim, jbc)[:n], **TOL)
    args = ([7], [0], [n], [n + 1])
    np.testing.assert_allclose(
        tim.forward(PS.BatchConfig.build(*args, max_tokens=8, max_requests=2,
                                         device="cpu"))[:1].numpy(),
        jax_step(jim, JaxBatchConfig.build(*args, max_tokens=8,
                                           max_requests=2))[:1], **TOL)
    if tim.kv_page_size:
        for im in (jim, tim):
            im.kv.release(0)
        return
    for name, bufs in jim.state.items():
        for buf in ("k", "v"):
            np.testing.assert_allclose(
                tim.state[name][buf][0, :, :n + 1].float().numpy(),
                np.asarray(bufs[buf], np.float32)[0, :, :n + 1], **TOL)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_incremental_logits_and_streams_match_reference(family):
    """Llama (RoPE, fused residual norms) and OPT (learned positions at
    offset 2, biases, pre-LN) served by ``InferenceManager(ff)``."""
    jcfg = FAMILIES[family][0]
    if family == "llama":
        jim = make_im(max_tokens=8, max_requests=2, max_seq=32,
                      use_pallas=True)
    else:
        jim = jax_im("opt")
    tim = port_im(jim, jcfg)
    assert isinstance(tim.model, BuilderModel)
    assert tim.lm_head_marked and tim.gate_lm_head
    assert tim.model.get_submodule("lm_head").lm_head_gated
    _prefill_then_decode(jim, tim, PROMPTS[0])
    jim.reset()
    tim.reset()
    got, want = streams(jim, tim)
    assert got == want


def test_int8_kv_and_64_position_pages_match_reference():
    jim = make_im(max_tokens=8, max_requests=2, max_seq=128,
                  use_pallas=True, kv_dtype="int8", kv_page_size=64)
    tim = port_im(jim, TINY)
    assert tim.kv.page_size == 64
    assert tim.state["model.layers.0.self_attn"]["k"].dtype == torch.int8
    long = [(7 * i) % 60 + 3 for i in range(70)]   # spans two pages
    _prefill_then_decode(jim, tim, long[:6])
    jim.reset()
    tim.reset()
    got, want = streams(jim, tim, [long, PROMPTS[1]], n=6)
    assert got == want


def test_spec_host_and_scan_with_tree_target_and_spec_draft():
    """A ``tree_inc_...`` target and a ``spec_inc_...`` draft, both
    builder graphs: a draft's tree-search step, the target's verify step
    per token and in the scan's fixed ``[R, P]`` layout give the
    reference's logits; the port's ``SpecInferManager`` and
    ``SpecDecodeScan`` give the reference ``SpecInferManager``'s
    streams."""
    caps = dict(max_tokens=16, max_requests=2, max_seq=64, max_spec=8)
    jllm = jax_builder_im(TINY, TREE, 7, **caps)
    jssm = jax_builder_im(JAX_SSM, SPEC, 123, topk=2, **caps)
    llm, ssm = port_im(jllm, TINY, TREE), port_im(jssm, JAX_SSM, SPEC)
    assert {n.kind for n in llm.model.graph.nodes
            if n.name.endswith("self_attn")} == {"attention"}
    assert type(llm.model.get_submodule(
        "model.layers.0.self_attn")).type_name == TREE
    assert type(ssm.model.get_submodule(
        "model.layers.0.self_attn")).type_name == SPEC
    # the tree steps: prefill both slots, a draft search step (slot 0 a
    # root and two children, slot 1 a root), then target verify steps
    prefill = ([5, 9, 2, 11, 3, 4, 4, 8], [0] * 5 + [1] * 3,
               list(range(5)) + [0, 1, 2], [5, 3])
    for jim, tim in ((jssm, ssm), (jllm, llm)):
        tim.forward(PS.BatchConfig.build(*prefill, max_tokens=16,
                                         max_requests=2, device="cpu"))
        jax_step(jim, JaxBatchConfig.build(*prefill, max_tokens=16,
                                           max_requests=2))
    jbc, tbc = _both_tree_bcs(
        "search", [7, 12, 30, 1], [0, 0, 0, 1], [5, 6, 6, 3], [6, 7],
        [0, 1, 2, 0], _tree_masks(8, {0: [-1, 0, 0], 1: [-1]}), [5, 3])
    np.testing.assert_allclose(ssm.forward(tbc)[:4].numpy(),
                               jax_step(jssm, jbc)[:4], **TOL)
    jbc, tbc = _both_tree_bcs(
        "verify", [13, 2, 40, 9, 22], [0, 0, 0, 1, 1], [5, 6, 7, 3, 4],
        [8, 5], [0, 1, 2, 0, 1],
        _tree_masks(8, {0: [-1, 0, 1], 1: [-1, 0]}), [5, 3])
    np.testing.assert_allclose(llm.forward(tbc)[:5].numpy(),
                               jax_step(jllm, jbc)[:5], **TOL)
    depth = [0, 1, 1, 2, 2, 3, 3, 3]
    jbc, tbc = _both_tree_bcs(
        "verify", list(range(20, 36)), [0] * 8 + [1] * 8,
        [7 + x for x in depth] + [5 + x for x in depth], [11, 9],
        list(range(8)) * 2,
        _tree_masks(8, {r: [-1, 0, 0, 1, 2, 3, 3, 4] for r in (0, 1)}),
        [7, 5], commit=[(0, 0, 5), (0, 1, 6), (1, 0, 3), (1, 1, 4)],
        layout=(2, 8))
    np.testing.assert_allclose(llm.forward(tbc).numpy(),
                               jax_step(jllm, jbc, layout=(2, 8)), **TOL)
    for im in (jllm, jssm, llm, ssm):
        im.reset()
    jgen, gen = JS.GenerationConfig(max_new_tokens=10), \
        PS.GenerationConfig(max_new_tokens=10)
    want = JS.SpecInferManager(jllm, jssm, jgen, width=2,
                               depth=2).generate(PROMPTS)
    got = PS.SpecInferManager(llm, ssm, gen, width=2,
                              depth=2).generate(PROMPTS)
    assert got == want
    # the device loop: a flat prefill on both, then 10 macro steps
    for im in (llm, ssm):
        im.reset()
    firsts = []
    for im in (llm, ssm):
        ids = im.step(PS.BatchConfig.build(
            PROMPTS[0] + PROMPTS[1], [0] * 5 + [1] * 4,
            list(range(5)) + list(range(4)), [5, 4], max_tokens=16,
            max_requests=2, device="cpu")).token_ids
        firsts.append([int(ids[4]), int(ids[8])])
    sc = PS.SpecDecodeScan(llm, ssm, width=2, depth=2)
    carry = sc.init_carry(firsts[0], [5, 4], [5, 4], [False, False])
    em, _ = sc.run(carry, 10)
    em = em.numpy()
    scanned = [[firsts[0][r]] + [int(t) for t in em[:, r].reshape(-1)
                                 if t >= 0] for r in range(2)]
    assert [s[:10] for s in scanned] == want


def test_tp2_placement_and_streams_match_reference():
    """``tensor_parallel_strategy`` over a builder graph equals the
    reference's for every attention method (all three head-sharded),
    and ``InferenceManager(ff, mesh=tp2)`` serves the reference's
    logits and streams under it."""
    jmesh = jax_make_mesh({"tp": 2}, jax.devices()[:2])
    for method in (INC, SPEC, TREE):
        jff = J.FFModel(J.FFConfig(), mesh=jmesh)
        JS.build_model(Redirect(jff, method), TINY, 8)
        want = jax_strategy(jff.graph, ("tp",), jmesh)
        model = BuilderModel(port_ff(TINY, 8, method))
        got = PS.InferenceManager(
            model, max_requests=2, max_tokens_per_batch=8, max_seq_len=32,
            mesh=make_mesh({"tp": 2}, ["cpu", "cpu"])).strategy
        assert got == want
        assert got["model.layers.1.self_attn"] == {"head": ("tp",)}
    jim = make_im({"tp": 2}, max_tokens=8, max_requests=2, max_seq=32,
                  use_pallas=False)
    tim = port_im(jim, TINY, mesh=make_mesh({"tp": 2}, ["cpu", "cpu"]),
                  strategy=jim.strategy)
    assert tim.strategy == jim.strategy and len(tim.shards) == 2
    assert tim.shards[1].get_submodule(
        "model.layers.0.self_attn").num_kv_heads == 1
    args = ([5, 9, 2, 4, 4], [0, 0, 0, 1, 1], [0, 1, 2, 0, 1], [3, 2])
    np.testing.assert_allclose(
        tim.forward(PS.BatchConfig.build(*args, max_tokens=8,
                                         max_requests=2,
                                         device="cpu"))[:5].numpy(),
        jax_step(jim, JaxBatchConfig.build(*args, max_tokens=8,
                                           max_requests=2))[:5], **TOL)
    jim.reset()
    tim.reset()
    got, want = streams(jim, tim)
    assert got == want


def test_pp2_matches_reference():
    jpim = make_pp_im({"pp": 2}, use_pallas=False)
    pim = PS.PipelinedInferenceManager(
        port_ff(TINY, jpim.max_tokens), max_requests=jpim.max_requests,
        max_tokens_per_batch=jpim.max_tokens, max_seq_len=jpim.max_seq_len,
        mesh=make_mesh({"pp": 2, "tp": 1}, ["cpu", "cpu"]),
        n_micro=jpim.n_micro)
    cfg = PS.ServeModelConfig(**dataclasses.asdict(TINY))
    pim.init_operators_inference(PS.params_from_jax(params_np(jpim), cfg,
                                                    "cpu"))
    assert [sorted(st.state) for st in pim.stages] == [
        ["model.layers.0.self_attn"], ["model.layers.1.self_attn"]]
    # a mixed step (micro-batches through both stages): the reference's
    # tokens and largest logits
    args = ([3, 5, 7, 11, 2], [0, 0, 0, 1, 1], [0, 1, 2, 0, 1], [3, 2])
    jr = jpim.step(JaxBatchConfig.build(*args, max_tokens=16,
                                        max_requests=2))
    pr = pim.step(PS.BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                       device="cpu"))
    assert np.array_equal(np.asarray(jr.token_ids), pr.token_ids.numpy())
    np.testing.assert_allclose(pr.logits_max.numpy(),
                               np.asarray(jr.logits_max), **TOL)
    jpim.reset()
    pim.reset()
    got, want = streams(jpim, pim, n=10)
    assert got == want


def test_builder_llama_equals_family_llama_with_the_same_weights():
    """The builder graph and the family's own model run the same modules
    in the same order: bit-equal logits, equal streams, the same caches."""
    cfg = FAMILIES["llama"][1]
    kw = dict(max_requests=2, max_tokens_per_batch=8, max_seq_len=32,
              device="cpu")
    fam = PS.InferenceManager(PS.build_model(cfg), **kw)
    fam.init_operators_inference(seed=3)
    ff = T.FFModel(T.FFConfig(), device="cpu")
    PS.build_model(ff, cfg, 8)
    im = PS.InferenceManager(ff, **kw)
    im.init_operators_inference(dict(fam.model.named_parameters()))
    bc = PS.BatchConfig.build(PROMPTS[0], [0] * 5, list(range(5)), [5],
                              max_tokens=8, max_requests=2, device="cpu")
    assert torch.equal(im.forward(bc), fam.forward(bc))
    for name in fam.state:
        assert torch.equal(im.state[name]["k"], fam.state[name]["k"])
    im.reset()
    fam.reset()
    gen = PS.GenerationConfig(max_new_tokens=8)
    assert PS.RequestManager(im, gen).generate(PROMPTS) == \
        PS.RequestManager(fam, gen).generate(PROMPTS)
    # the cost model prices the two alike (a bf16 graph, a gated head)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    ff16 = T.FFModel(T.FFConfig(), device="cpu")
    PS.build_model(ff16, cfg16, 8)
    models = [BuilderModel(ff16), PS.build_model(cfg16)]
    for m in models:
        PS.register_serve_capacities(m, 2, 32, 0, None, 8)
        assert PS.mark_gated_lm_head(m, 2)
    caps = [recorded_capacities(m) for m in models]
    assert caps[0] == caps[1] and caps[0].logit_rows == 2
    assert memory_parts(models[0], caps[0]) == memory_parts(models[1],
                                                           caps[1])


def test_serve_ops_raise_where_the_reference_raises():
    """A serve op outside a serve manager, the builders' signatures, and
    graphs a manager cannot serve."""
    for pkg in (J, T):
        kw = {} if pkg is J else dict(device="cpu")
        m = pkg.FFModel(pkg.FFConfig(batch_size=4), **kw)
        x = m.dense(m.create_tensor((4, 8)), 16)
        m.inc_multihead_self_attention(x, 16, 4, 2)
        m.compile(loss_type="identity")
        with pytest.raises(ValueError, match="requires a batch_config and "
                                             "cache state"):
            m.forward(np.zeros((4, 8), np.float32))
        m = pkg.FFModel(pkg.FFConfig(batch_size=4), **kw)
        t = m.create_tensor((4, 16))
        m.position_embedding(t, 8, 2)
        m.compile(loss_type="identity")
        with pytest.raises(ValueError, match="position_embedding requires "
                                             "a batch_config"):
            m.forward(np.zeros((4, 16), np.float32))
        for method in (SPEC, TREE):
            with pytest.raises(TypeError, match="use_alibi"):
                getattr(m, method)(t, 16, 4, use_alibi=True)
    # the port's managers: one token input, module paths, outputs= only
    # with a builder graph
    ff = T.FFModel(T.FFConfig(), device="cpu")
    ff.add(ff.create_tensor((8, 4)), ff.create_tensor((8, 4)))
    with pytest.raises(ValueError, match="one input"):
        PS.InferenceManager(ff, device="cpu")
    ff = T.FFModel(T.FFConfig(), device="cpu")
    x = ff.embedding(ff.create_tensor((8,), np.int32), 16, 8, name="a")
    ff.dense(x, 16, name="a.b")
    with pytest.raises(ValueError, match="holds the path 'a'"):
        PS.InferenceManager(ff, device="cpu")
    with pytest.raises(ValueError, match="outputs="):
        PS.InferenceManager(PS.build_model(FAMILIES["llama"][1]),
                            device="cpu", outputs=[x])
    # an op that reads its split from a context is not served split
    ff = T.FFModel(T.FFConfig(), device="cpu")
    x = ff.embedding(ff.create_tensor((8,), np.int32), 16, 8)
    ff.dense(ff.dropout(ff.inc_multihead_self_attention(x, 8, 2), 0.0), 16)
    with pytest.raises(NotImplementedError, match="'dropout'"):
        PS.InferenceManager(ff, max_tokens_per_batch=8,
                            mesh=make_mesh({"tp": 2}, ["cpu", "cpu"]),
                            strategy={"dropout": {"sample": ("tp",)}})
