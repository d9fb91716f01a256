"""The port's tensor-parallel serving vs the JAX package's, on the CPU.

The port's shards live in one process on ``["cpu", "cpu"]`` (the
collectives' local implementation); the JAX side is ``test_serve.make_im``
on a ``{"tp": 2}`` mesh of the conftest's virtual CPU devices, with
``use_pallas=False`` (its gather path: the same function as its Pallas
kernels under ``shard_map``, and a quicker compile).  The JAX managers are
built once per module: their tensor-parallel programs compile slowly.

* ``parallel.comm``: the local all-reduce sums in rank order and hands
  every shard the same bits; the implementation is fixed by the devices;
* the slicing of every parameter kind, int8 scales included, equals the
  sharding the reference gives each parameter (``jax.Array.sharding``),
  and the port's placement equals ``tensor_parallel_strategy`` on the
  JAX graph of every family, node for node;
* TINY Llama at ``tp=2`` (vocabulary 67: a replicated LM head; 68: a
  vocabulary-sharded one gathered on shard 0): a prefill and a decode
  step's logits within ``atol=rtol=1e-5`` of the JAX package's at
  ``tp=2`` (float32; both sides add the two shards' partial sums, and
  each shard's products sum in another order), and greedy streams equal
  to the JAX package's at ``tp=2`` and to the port's at ``tp=1``;
* per-device memory: the cost card, the predicted memory parts and the
  ledger's predicted and allocated records equal the reference's at
  ``tp=2`` (exact), with fp weights and KV, and with int8 weights and
  int8 KV (the global scale count).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu.obs as JO
import flexflow_tpu.serve as JS
import flexflow_tpu_torch.obs as PO
import flexflow_tpu_torch.serve as PS
from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.obs.profiler import plan_cost_card as jax_card
from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flexflow_tpu.search.simulator import plan_memory_parts as jax_parts
from flexflow_tpu.serve import quantize_int8 as jax_quantize_int8
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.inference_manager import (
    tensor_parallel_strategy as jax_strategy,
)
from flexflow_tpu_torch.obs.profiler import plan_cost_card
from flexflow_tpu_torch.parallel import Comm, make_mesh, run_local, run_shards
from flexflow_tpu_torch.parallel.tp import tensor_parallel_strategy
from flexflow_tpu_torch.serve.cost import plan_memory_parts

from test_serve import TINY, make_im
from test_torch_zoo import configs, params_np
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread, jax_logits  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
CAPS = dict(max_tokens=8, max_requests=2, max_seq=32, use_pallas=False)
CPU2 = ["cpu", "cpu"]


def port_cfg(jcfg):
    return PS.ServeModelConfig(**dataclasses.asdict(jcfg))


def port_im(jim, cfg, tp=2, **kw):
    """A port manager with the JAX manager's (global) params and
    capacities, on ``tp`` CPU shards (``tp=1``: no mesh)."""
    caps = dict(max_requests=jim.max_requests,
                max_tokens_per_batch=jim.max_tokens,
                max_seq_len=jim.max_seq_len,
                max_spec_tokens=jim.max_spec_tokens, topk=jim.topk,
                kv_dtype=jim.kv_dtype, kv_page_size=jim.kv_page_size)
    caps.update(kw)
    where = (dict(device="cpu") if tp == 1
             else dict(mesh=make_mesh({"tp": tp}, ["cpu"] * tp)))
    im = PS.InferenceManager(PS.build_model(cfg), **caps, **where)
    return im.init_operators_inference(
        PS.params_from_jax(params_np(jim), cfg, "cpu"))


VOCABS = {"vocab67": TINY, "vocab68": dataclasses.replace(TINY,
                                                          vocab_size=68)}


def jax_tp2(vocab):
    return make_im({"tp": 2}, cfg=VOCABS[vocab], **CAPS)


def jax_int8_tp2():
    """int8 weights (quantized on the global arrays) and int8 KV at
    ``tp=2``; a seed no other test builds: quantizing marks the cached
    JAX graph's ops."""
    jim = make_im({"tp": 2}, kv_dtype="int8", seed=43, **CAPS)
    jax_quantize_int8(jim)
    return jim


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def test_comm_local_sums_in_rank_order_on_every_shard():
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(5, 7, generator=g) for _ in range(3)]
    comm = Comm(["cpu"] * 3)
    assert comm.kind == "local"
    out = comm.all_reduce(parts)
    want = (parts[0] + parts[1]) + parts[2]
    assert all(torch.equal(o, want) for o in out)
    assert len({o.data_ptr() for o in out}) == 3    # a copy per shard
    full = comm.all_gather(parts, dim=-1)
    assert all(torch.equal(f, torch.cat(parts, dim=-1)) for f in full)
    first = comm.gather(parts, dim=0)
    assert torch.equal(first[0], torch.cat(parts)) and first[1:] == [None,
                                                                       None]
    assert comm.calls == {"nccl": 0, "local": 3}
    # the implementation is fixed by the devices when the mesh is built;
    # nothing swaps NCCL for the local sum at run time
    assert Comm(["cuda:0", "cuda:1"]).kind == "nccl"
    assert Comm(["cuda:0", "cuda:0"]).kind == "local"
    with pytest.raises(Exception):
        Comm(["cuda:0", "cuda:1"]).all_reduce(parts[:2])
    assert make_mesh({"tp": 2}, CPU2).comm.kind == "local"


def test_lockstep_driver_answers_collectives_and_checks_them():
    def fwd(x, ops):
        for op in ops:
            x = yield (op, x)
        return x

    a, b = torch.ones(2, 3), 2 * torch.ones(2, 3)
    comm = Comm(CPU2)
    got = run_shards([fwd(a, ["all_reduce", "all_gather"]),
                      fwd(b, ["all_reduce", "all_gather"])], comm)
    assert torch.equal(got[0], torch.full((2, 6), 3.0))
    assert torch.equal(got[0], got[1])
    # alone, every collective is the identity
    assert torch.equal(run_local(fwd(a, ["all_reduce", "gather"])), a)
    with pytest.raises(RuntimeError, match="lockstep"):
        run_shards([fwd(a, ["all_reduce"]), fwd(b, ["all_gather"])], comm)
    with pytest.raises(RuntimeError, match="lockstep"):
        run_shards([fwd(a, ["all_reduce"]), fwd(b, [])], comm)


# ---------------------------------------------------------------------------
# placement and slicing
# ---------------------------------------------------------------------------
def _tp_dim(arr):
    """The dim a JAX array is sharded on over ``tp`` (None: whole)."""
    spec = tuple(getattr(arr.sharding, "spec", ()) or ())
    for i, axes in enumerate(spec):
        axes = axes if isinstance(axes, tuple) else (axes,)
        if "tp" in axes:
            return i
    return None


def test_slicing_follows_reference_shardings_int8_scales_included():
    """Every parameter of the int8 TINY Llama at ``tp=2`` (fp embeddings,
    norms; int8 kernels, ``qkv`` and ``o_proj`` with their scales) is
    split on the dim the reference shards it on, and each shard's slice
    is its block of the global array."""
    jim = jax_int8_tp2()
    im = port_im(jim, port_cfg(TINY))
    plan = im.model.tp_plan
    seen = set()
    for node, group in jim.params.items():
        for pname, arr in group.items():
            name = f"{node}.{pname}"
            assert plan.dim(name) == _tp_dim(arr), name
            glob = torch.from_numpy(np.asarray(arr).copy())
            for r, shard in enumerate(im.shards):
                local = dict(shard.named_parameters())[name].cpu()
                d = plan.dim(name)
                want = glob if d is None else glob.chunk(2, dim=d)[r]
                assert torch.equal(local, want.to(local.dtype)), name
            seen.add(pname)
    assert {"kernel_scale", "qkv_scale", "o_proj_scale"} <= seen
    # a row-sharded weight's scale is the global one on every shard
    assert plan.dim("model.layers.0.mlp.down_proj.kernel") == 0
    assert plan.dim("model.layers.0.mlp.down_proj.kernel_scale") is None
    assert plan.dim("model.layers.0.self_attn.o_proj_scale") is None


def test_shards_reassemble_the_global_parameters():
    """``TPPlan.whole`` of the shards' parts is the global parameter, for
    every parameter kind of a biased family (OPT: column- and row-sharded
    kernels with biases, ``qkv_bias``, ``o_bias``, position embedding)."""
    _, cfg = configs("opt")
    one = PS.InferenceManager(PS.build_model(cfg), max_requests=2,
                              max_tokens_per_batch=8, max_seq_len=64,
                              device="cpu").init_operators_inference(seed=5)
    sd = {k: v + 0.1 * torch.randn(v.shape)
          for k, v in one.model.state_dict().items()}
    two = PS.InferenceManager(PS.build_model(cfg), max_requests=2,
                              max_tokens_per_batch=8, max_seq_len=64,
                              mesh=make_mesh({"tp": 2}, CPU2))
    two.init_operators_inference(sd)
    plan = two.model.tp_plan
    parts = [dict(m.named_parameters()) for m in two.shards]
    for name, want in sd.items():
        assert torch.equal(plan.whole(name, [p[name] for p in parts]),
                           want), name
    kinds = {n: plan.dim(n) for n in (
        "model.decoder.layers.0.fc1.kernel", "model.decoder.layers.0.fc1.bias",
        "model.decoder.layers.0.fc2.kernel", "model.decoder.layers.0.fc2.bias",
        "model.decoder.layers.0.self_attn.qkv_bias",
        "model.decoder.layers.0.self_attn.o_bias",
        "model.decoder.embed_positions.weight")}
    assert list(kinds.values()) == [1, 0, 0, None, 0, None, None]


@pytest.mark.parametrize("family,degree", [
    ("llama", 2), ("llama", 4), ("opt", 2), ("opt_post_ln", 2),
    ("falcon_7b", 2), ("falcon_rw", 2), ("mpt", 2), ("starcoder", 2)])
def test_placement_equals_reference_strategy(family, degree):
    """The port's ``tensor_parallel_strategy`` over its modules equals the
    reference's over its graph, node for node (Falcon-7B's and
    StarCoder's one KV head leave their attention replicated; OPT's
    projections and Falcon's MLP take the generic column rule)."""
    if family == "llama":
        jcfg = dataclasses.replace(TINY, num_attention_heads=8,
                                   num_key_value_heads=4)
        cfg = port_cfg(jcfg)
    else:
        jcfg, cfg = configs(family)
    mesh = jax_make_mesh({"tp": degree}, jax.devices()[:degree])
    ff = FFModel(FFConfig(), mesh=mesh)
    JS.build_model(ff, jcfg, 8)
    want = jax_strategy(ff.graph, ("tp",), mesh)
    got = tensor_parallel_strategy(PS.build_model(cfg), degree)
    assert got == want
    assert any("head" in v for v in want.values()) == (
        family not in ("falcon_7b", "starcoder"))


# ---------------------------------------------------------------------------
# serving at tp=2 against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_tp2_logits_and_streams_match_reference(vocab):
    jim = jax_tp2(vocab)
    cfg = port_cfg(VOCABS[vocab])
    tim = port_im(jim, cfg)
    assert tim.plan_key == jim.plan_key == "tp2_pp1_m1"
    head = tim.model.tp_plan.strategy.get("lm_head")
    assert (head is not None) == (vocab == "vocab68")
    args = (PROMPTS[0] + PROMPTS[1][:3], [0] * 5 + [1] * 3,
            list(range(5)) + [0, 1, 2], [5, 3])
    jbc = JaxBatchConfig.build(*args, max_tokens=8, max_requests=2)
    tbc = PS.BatchConfig.build(*args, max_tokens=8, max_requests=2,
                               device="cpu")
    np.testing.assert_allclose(tim.forward(tbc).numpy(),
                               jax_logits(jim, jbc), **TOL)
    args = ([7, 1], [0, 1], [5, 3], [6, 4])
    jbc = JaxBatchConfig.build(*args, max_tokens=8, max_requests=2)
    tbc = PS.BatchConfig.build(*args, max_tokens=8, max_requests=2,
                               device="cpu")
    np.testing.assert_allclose(tim.forward(tbc)[:2].numpy(),
                               jax_logits(jim, jbc)[:2], **TOL)
    calls = dict(tim.mesh.comm.calls)
    # two all-reduces a layer, and the vocabulary gather when sharded
    assert calls == {"nccl": 0, "local": 2 * (4 + (head is not None))}
    # greedy streams: the JAX package at tp=2, the port at tp=1
    jim = jax_tp2(vocab)
    want = JS.RequestManager(jim, JS.GenerationConfig(
        max_new_tokens=8)).generate(PROMPTS)
    tim.reset()
    got = PS.RequestManager(tim, PS.GenerationConfig(
        max_new_tokens=8)).generate(PROMPTS)
    one = PS.RequestManager(port_im(jim, cfg, tp=1), PS.GenerationConfig(
        max_new_tokens=8)).generate(PROMPTS)
    assert got == want == one


@pytest.mark.parametrize("case", ["fp", "int8"])
def test_per_device_memory_equals_reference(case):
    """The cost card, the predicted memory parts and the ledger's
    predicted and allocated records at ``tp=2`` equal the reference's:
    one device's weights (replicated parameters whole, sharded ones
    split; int8 values and the global scale count), its KV buffers, the
    largest local op output."""
    jim = jax_tp2("vocab68") if case == "fp" else jax_int8_tp2()
    cfg = port_cfg(VOCABS["vocab68"] if case == "fp" else TINY)
    im = port_im(jim, cfg)
    assert dataclasses.asdict(plan_cost_card(im)) == \
        dataclasses.asdict(jax_card(jim))
    assert plan_memory_parts(im) == jax_parts(jim.plan, training=False)
    jtel, tel = JO.Telemetry(), PO.Telemetry()
    JS.RequestManager(jim, telemetry=jtel)
    PS.RequestManager(im, telemetry=tel)
    assert tel.memory.report() == jtel.memory.report()
    plan = tel.memory.report()["plans"]["tp2_pp1_m1"]
    assert plan["weights_gb"]["measured"] and plan["kv_gb"]["predicted"]
    # per device is one shard's; the global basis counts both
    kv = im.kv
    assert kv.allocated_bytes() == 2 * kv.allocated_bytes(per_device=True)
