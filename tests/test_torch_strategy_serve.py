"""Serving under a parallel strategy: the port's plan executor vs the JAX
package, on the CPU.

Two shards on ``["cpu", "cpu"]`` (``tests/test_serve.py``'s TINY Llama,
float32, greedy), the JAX side an ``InferenceManager`` over a ``{"tp":
2}`` mesh of the conftest's virtual CPU devices with ``use_pallas=False``
(its gather path, a quicker compile), given the same strategy:

* ``strategy="search"``: the port searches the reference's dict; a
  prefill and a decode step's logits within ``atol=rtol=1e-5`` of the
  reference's, and greedy streams equal to the reference's and to the
  port's ``tp=1`` (``tests/test_serve_search.py:84-98``);
* the hand dicts of ``chip_smoke.py`` phase 20(a): the all-``sample``
  dict the search chooses for TINY, and a mixed dict (``head``,
  ``channel_out``, ``channel_in`` and ``entry`` on layer 0, ``sample``
  beside ``channel_out`` on layer 1, so that an all-to-all runs), held
  the same way;
* int8 weights with an int8 paged cache, and the host speculative path,
  under a searched dict: streams equal to the port's ``tp=1``;
* ``PipelinedInferenceManager(strategy=<dict>)`` at ``pp=2 x tp=2``;
* a config the executor cannot run raises ``NotImplementedError``;
* ``strategy=None`` is the Megatron dict, its plan the reference's
  (``tp_collectives`` equal to the reference plan's parallel steps), and
  a step runs one collective a communicating step.
"""

import dataclasses

import jax
import numpy as np
import pytest

import flexflow_tpu.serve as JS
import flexflow_tpu_torch.serve as PS
from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.parallel.mesh import make_mesh as jax_mesh
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.inference_manager import (
    tensor_parallel_strategy as jax_strategy,
)
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.parallel.tp import tp_collectives

from test_serve import TINY
from test_torch_tp import port_cfg
from test_torch_zoo import params_np
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[5, 9, 2, 11, 3, 7, 1], [4, 4, 8]]
CAPS = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=32)
CFG = port_cfg(TINY)
V68 = dataclasses.replace(TINY, vocab_size=68)
TP = ("tp",)


def sample_dict(layers):
    """The dict the search chooses for TINY at ``tp=2``: ``sample`` on the
    attention, the MLP and the LM head."""
    out = {"lm_head": {"sample": TP}}
    for i in range(layers):
        p = f"model.layers.{i}"
        for n in ("self_attn", "post_attention_layernorm", "mlp.gate_proj",
                  "mlp.up_proj", "mlp.act", "mlp.down_proj"):
            out[f"{p}.{n}"] = {"sample": TP}
    return out


def mixed_dict(layers):
    """Even layers Megatron's (``head``, ``channel_out``, ``channel_in``),
    odd layers ``sample`` beside a ``channel_out`` up projection (an
    all-to-all moves its split); the embedding split on its vocabulary
    (``entry``), the LM head on its rows."""
    out = {"model.embed_tokens": {"entry": TP}, "lm_head": {"sample": TP}}
    for i in range(layers):
        p = f"model.layers.{i}"
        if i % 2 == 0:
            out.update({f"{p}.self_attn": {"head": TP},
                        f"{p}.mlp.gate_proj": {"channel_out": TP},
                        f"{p}.mlp.up_proj": {"channel_out": TP},
                        f"{p}.mlp.down_proj": {"channel_in": TP}})
        else:
            out.update({f"{p}.self_attn": {"sample": TP},
                        f"{p}.mlp.gate_proj": {"sample": TP},
                        f"{p}.mlp.up_proj": {"channel_out": TP},
                        f"{p}.mlp.down_proj": {"sample": TP}})
    return out


def jax_im(strategy, cfg=TINY):
    mesh = jax_mesh({"tp": 2}, jax.devices()[:2])
    ff = FFModel(FFConfig(), mesh=mesh)
    JS.build_model(ff, cfg, CAPS["max_tokens_per_batch"])
    im = JS.InferenceManager(
        ff, max_requests=CAPS["max_requests"],
        max_tokens_per_batch=CAPS["max_tokens_per_batch"],
        max_seq_len=CAPS["max_seq_len"], strategy=strategy,
        use_pallas=False)
    im.init_operators_inference(rng=jax.random.PRNGKey(7))
    return im


def port_im(strategy, params=None, tp=2, cfg=CFG, seed=7, **kw):
    caps = {**CAPS, **kw}
    where = (dict(device="cpu") if tp == 1
             else dict(mesh=make_mesh({"tp": tp}, ["cpu"] * tp)))
    im = PS.InferenceManager(PS.build_model(cfg), strategy=strategy,
                             **caps, **where)
    if params is None:
        return im.init_operators_inference(seed=seed)
    return im.init_operators_inference(PS.params_from_jax(params, cfg,
                                                          "cpu"))


def streams(im, side=PS, prompts=PROMPTS, n=6):
    im.reset()
    return side.RequestManager(im, side.GenerationConfig(
        max_new_tokens=n)).generate(prompts)


def logits_match(jim, tim):
    """A mixed prefill step and a decode step: the real tokens' logits."""
    for args in ((PROMPTS[0] + PROMPTS[1], [0] * 7 + [1] * 3,
                  list(range(7)) + [0, 1, 2], [7, 3]),
                 ([6, 1], [0, 1], [7, 3], [8, 4])):
        n = len(args[0])
        jbc = JaxBatchConfig.build(*args, max_tokens=16, max_requests=2)
        tbc = PS.BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                   device="cpu")
        np.testing.assert_allclose(tim.forward(tbc)[:n].numpy(),
                                   jax_logits(jim, jbc)[:n], **TOL)


@pytest.fixture(scope="module")
def jax_search():
    return jax_im("search")


def test_searched_strategy_serves_as_the_reference(jax_search):
    jim = jax_search
    params = params_np(jim)
    tim = port_im("search", params)
    assert tim.strategy == jim.strategy and tim.strategy
    assert tim.plan.pretty().count("[op  ]") == len(tim.pcg.graph.nodes)
    logits_match(jim, tim)
    one = port_im(None, params, tp=1)
    want = streams(one)
    assert streams(tim) == want == streams(jim, JS)
    assert tim.mesh.comm.calls["local"] > 0


@pytest.mark.parametrize("which", ["sample", "mixed"])
def test_hand_dicts_serve_as_the_reference(which):
    """The mixed dict at a vocabulary of 68, which ``entry`` splits."""
    strategy = (sample_dict if which == "sample" else mixed_dict)(2)
    jcfg = TINY if which == "sample" else V68
    jim = jax_im(strategy, jcfg)
    params = params_np(jim)
    cfg = port_cfg(jcfg)
    tim = port_im(strategy, params, cfg=cfg)
    assert tim.strategy == strategy
    kinds = {s.node.op.type_name for s in tim.plan.steps if s.is_parallel}
    if which == "mixed":
        assert {"all_to_all", "allreduce", "repartition"} <= kinds
        emb = tim.shards[1].model.embed_tokens
        assert emb.entry_offset == emb.weight.shape[0] == 34
    logits_match(jim, tim)
    want = streams(port_im(None, params, tp=1, cfg=cfg))
    assert streams(tim) == want == streams(jim, JS)


def test_int8_paged_and_spec_under_a_searched_dict():
    """int8 weights and an int8 paged cache, then the host speculative
    path (the target searched with its spec buffers, a one-device
    draft): the streams of the port at ``tp=1``."""
    kw = dict(kv_dtype="int8", kv_page_size=64, max_seq_len=128)
    ims = []
    for tp in (1, 2):
        im = port_im("search" if tp == 2 else None, tp=tp, **kw)
        PS.quantize_int8(im)
        ims.append(im)
    assert ims[1].strategy
    assert streams(ims[1]) == streams(ims[0])
    draft = dataclasses.replace(CFG, hidden_size=16, intermediate_size=32,
                                num_hidden_layers=1, num_attention_heads=2,
                                num_key_value_heads=2)
    target = port_im("search", tp=2, max_spec_tokens=8, max_seq_len=64)
    ssm = port_im(None, tp=1, cfg=draft, seed=123, max_spec_tokens=8,
                  max_seq_len=64, topk=2)
    spec = PS.SpecInferManager(target, ssm, PS.GenerationConfig(
        max_new_tokens=6), width=2, depth=2).generate(PROMPTS)
    assert spec == streams(port_im(None, tp=1, max_seq_len=64))


def test_pipelined_manager_takes_a_strategy_dict():
    """``pp=2 x tp=2`` under the mixed dict: each stage plans its part
    (layer 0 Megatron's, layer 1 ``sample`` with an all-to-all), the
    streams are the port's at ``tp=1``."""
    strategy = mixed_dict(2)
    cfg = port_cfg(V68)
    pim = PS.PipelinedInferenceManager(
        PS.build_model(cfg), mesh=make_mesh({"pp": 2, "tp": 2},
                                            ["cpu"] * 4),
        strategy=strategy, **CAPS)
    pim.init_operators_inference(seed=7)
    assert pim.strategy == strategy
    names = [{s.name for s in st.plan.plan.steps} for st in pim.stages]
    assert "model.layers.0.self_attn" in names[0]
    assert "model.layers.1.self_attn" in names[1]
    kinds = {s.node.op.type_name for s in pim.stages[1].plan.plan.steps
             if s.is_parallel}
    assert "all_to_all" in kinds
    assert streams(pim) == streams(port_im(None, tp=1, cfg=cfg))


def test_a_config_the_executor_cannot_run_raises():
    """A config naming a parallel dim the node lacks would run
    replicated: it raises, naming the node and the config."""
    bad = {"model.layers.0.mlp.gate_proj": {"head": TP}}
    with pytest.raises(NotImplementedError,
                       match="model.layers.0.mlp.gate_proj.*head"):
        port_im(bad)
    with pytest.raises(ValueError, match="strategy"):
        port_im("searched")


def test_default_strategy_is_megatron_with_the_reference_plan():
    """``strategy=None`` at ``tp=2`` is the Megatron dict; its collectives
    are the reference plan's parallel steps, kind and bytes, and a step
    runs one ``Comm`` call a communicating step (all-reduces here: the
    vocabulary of 67 leaves the LM head whole)."""
    tim = port_im(None)
    jm = jax_mesh({"tp": 2}, jax.devices()[:2])
    ff = FFModel(FFConfig(), mesh=jm)
    JS.build_model(ff, TINY, CAPS["max_tokens_per_batch"])
    want = jax_strategy(ff.graph, ("tp",), jm)
    assert tim.strategy == want
    plan = JPCG(ff.graph, jm, want,
                output_tids=[ff.graph.nodes[-1].outputs[-1]]).plan()
    got = tp_collectives(tim.model.tp_plan)
    assert [(c.kind, c.nbytes) for c in got] == [
        (s.node.op.type_name, s.node.op.comm_bytes(s.in_specs[0],
                                                   s.in_shardings[0], jm))
        for s in plan.steps if s.is_parallel]
    assert [c.kind for c in got] == ["allreduce"] * 4
    calls = tim.mesh.comm.calls["local"]
    tim.forward(PS.BatchConfig.build([1, 2, 3], [0, 0, 0], [0, 1, 2], [3],
                                     max_tokens=16, max_requests=2,
                                     device="cpu"))
    assert tim.mesh.comm.calls["local"] - calls == 4
