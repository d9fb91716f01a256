"""Tensor-parallel serving through the port's entry points, on the CPU.

``LLM.compile(tp=2, devices=["cpu", "cpu"])`` and the deployments built
from plan keys, against the port at ``tp=1`` on the same seeded weights
(the weights drawn at their global shapes are the same at every degree;
``test_torch_tp.py`` holds ``tp=2`` to the JAX package):

* ``LLM.compile(tp=2)`` serves incrementally and speculatively (its SSM
  compiled at ``tp=1`` on the first device, as the reference compiles it)
  with the streams of ``tp=1``, under the plan key ``tp2_pp1_m1`` (the
  manager's and the replay trace's); ``share_weights_with`` takes a deployment
  on the same mesh only;
* ``devices=None`` means ``cuda:0`` ... and raises on a machine with fewer
  cards; a device listed twice is taken only when the caller lists it;
* a ``tp1 -> tp2`` live migration (``LLM.plan_builder`` from the plan key
  ``tp2_pp1_m1``) landing mid-decode gives the unmigrated streams, greedy
  and seeded, and tears the incumbent down;
* a fleet of two ``tp=2`` replicas sharing weights, one killed mid-decode:
  the streams of one ``LLM``, the victim's shards' buffers dropped;
* ``pp > 1`` plan keys, meshes and plan builders are accepted (slice
  9b; ``test_torch_pp*.py`` holds the pipelined manager to the JAX
  package).
"""

import pytest
import torch

import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.obs.replay import plan_key_of
from flexflow_tpu_torch.parallel import make_mesh
from flexflow_tpu_torch.serve.migration import plan_shape

# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401
from test_torch_tp import CPU2, VOCABS, port_cfg

CFG = port_cfg(VOCABS["vocab68"])     # a vocabulary-sharded LM head
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6], [13, 8, 1]]


def caps(gen=None, **kw):
    out = dict(max_requests=2, max_tokens_per_batch=16, max_seq_len=128,
               generation_config=gen or PS.GenerationConfig(
                   max_new_tokens=8))
    out.update(kw)
    return out


def greedy():
    return PS.GenerationConfig(max_new_tokens=8)


def seeded():
    return PS.GenerationConfig(max_new_tokens=8, temperature=0.8, top_p=0.9,
                               seed=5)


def one(gen_fn=greedy):
    return PS.LLM(CFG).compile(device="cpu", **caps(gen_fn())).generate(
        PROMPTS)


def test_llm_compile_tp2_serves_like_tp1():
    llm = PS.LLM(CFG).compile(tp=2, devices=CPU2, **caps())
    assert llm.im.plan_key == "tp2_pp1_m1" and len(llm.im.shards) == 2
    assert plan_key_of(llm.im) == "tp2_pp1_m1"   # the replay trace's key
    assert llm.generate(PROMPTS) == one()
    calls = llm.im.mesh.comm.calls
    assert calls["local"] > 0 and calls["nccl"] == 0
    draft = PS.SSM(PS.ServeModelConfig(
        vocab_size=CFG.vocab_size, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2))
    spec = PS.LLM(CFG).compile(tp=2, devices=CPU2, ssms=[draft],
                               spec_width=2, spec_depth=2, **caps())
    assert draft.im.tp == 1 and draft.im.device == spec.im.device
    assert spec.generate(PROMPTS) == one()


def test_share_weights_with_needs_the_same_mesh():
    a = PS.LLM(CFG).compile(tp=2, devices=CPU2, **caps())
    b = PS.LLM(CFG).compile(tp=2, devices=CPU2, share_weights_with=a,
                            **caps())
    assert b.im.shards[1] is a.im.shards[1] and b.im.kv is not a.im.kv
    assert b.im.mesh is a.im.mesh
    with pytest.raises(ValueError, match="same mesh"):
        PS.LLM(CFG).compile(device="cpu", share_weights_with=a, **caps())
    with pytest.raises(ValueError, match="same mesh"):
        PS.LLM(CFG).compile(tp=4, devices=["cpu"] * 4, share_weights_with=a,
                            **caps())


def test_devices_none_raises_with_fewer_cards(monkeypatch):
    with pytest.raises(RuntimeError, match="cuda"):   # no card at all
        PS.LLM(CFG).compile(tp=2, **caps())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA devices"):
        make_mesh({"tp": 2})
    mesh = make_mesh({"tp": 2}, ["cuda:0", "cuda:0"])   # asked for: taken
    assert mesh.devices == [torch.device("cuda", 0)] * 2
    assert mesh.comm.kind == "local"
    assert make_mesh({"tp": 2}, ["cuda:0", "cuda:1"]).comm.kind == "nccl"
    with pytest.raises(ValueError, match="all the CPU"):
        make_mesh({"tp": 2}, ["cuda:0", "cpu"])


@pytest.mark.parametrize("gen_fn", [greedy, seeded], ids=["greedy",
                                                          "seeded"])
def test_migrate_tp1_to_tp2_bit_identical(gen_fn):
    want = one(gen_fn)
    llm = PS.LLM(CFG).compile(device="cpu", **caps(gen_fn()))
    old = llm.im
    llm.rm.scan_chunk = 2
    ctrl = llm.attach_migration(
        llm.plan_builder(devices=CPU2, **caps(gen_fn())),
        plan={"plan_key": "tp1_pp1_m1"},
        config=PS.MigrationConfig(defer_ticks=2, drain_grace_ticks=1))
    ctrl.request_migration("tp2_pp1_m1")
    assert llm.rm.generate(PROMPTS) == want
    rec = ctrl.history[-1]
    assert rec["outcome"] == "completed" and rec["preempted_requests"] > 0
    assert rec["kv_leaked_rids"] == [] and old.state is None
    assert llm.im.plan_key == "tp2_pp1_m1" and llm.im.tp == 2
    assert ctrl.plan["plan_key"] == "tp2_pp1_m1"


def test_fleet_of_tp2_replicas_survives_a_kill():
    llms = [PS.LLM(CFG).compile(tp=2, devices=CPU2, **caps())]
    llms.append(PS.LLM(CFG).compile(tp=2, devices=CPU2,
                                    share_weights_with=llms[0], **caps()))
    fleet = PS.LLM.fleet(llms, gen=llms[0].rm.gen)
    for rep in fleet.replicas:
        rep.rm.scan_chunk = 2
    fleet.schedule_kill("replica0", at_tick=3)
    assert fleet.generate(PROMPTS) == one()
    dead = fleet._by_name("replica0")
    assert dead.state is PS.ReplicaState.DEAD and dead.leaked == []
    assert dead.rm.im.kv.states is None and not dead.rm.im.ready
    assert dead.rm.im.kv.allocated_bytes() == 0
    assert sum(fleet._failover_counts.values()) > 0
    assert all(fleet.placement[rid] == "replica1"
               for rid in fleet._failover_counts)
    assert llms[1].im.kv.states is not None


def test_pp_raises_naming_slice_9b():
    """Slice 9b is ported: a ``pp > 1`` plan key, mesh and plan builder
    are accepted now (the test keeps its name; it held the refusal
    before), and a key that is not ``tp{t}_pp{p}_m{m}`` still raises."""
    assert plan_shape("tp2_pp1_m1_spec_w2d3") == {"tp": 2, "pp": 1, "m": 1}
    assert plan_shape("tp1_pp2_m2") == {"tp": 1, "pp": 2, "m": 2}
    mesh = make_mesh({"tp": 1, "pp": 2}, CPU2)
    assert mesh.shape == {"pp": 2, "tp": 1} and mesh.comm.kind == "local"
    assert [m.devices for m in mesh.stage_meshes()] == [
        [torch.device("cpu")]] * 2
    llm = PS.LLM(CFG).compile(device="cpu", **caps())
    im = llm.plan_builder(devices=CPU2 * 2, **caps())(
        {"plan_key": "tp2_pp2_m2"})
    assert isinstance(im, PS.PipelinedInferenceManager) and im.ready
    assert im.plan_key == plan_key_of(im) == "tp2_pp2_m2"
    assert [len(st.shards) for st in im.stages] == [2, 2]
    with pytest.raises(ValueError, match="not tp"):
        plan_shape("pp2")


def test_batch_to_moves_every_tensor_of_a_nested_config():
    """A shard on another device than shard 0 takes the step's batch
    there: every tensor of the config and of its ``base``, the other
    fields kept."""
    from flexflow_tpu_torch.serve.batch_config import batch_to

    base = PS.BatchConfig.build([3, 4], [0, 1], [5, 2], [6, 3],
                                max_tokens=4, max_requests=2, device="cpu")
    mask = torch.zeros(2, 3, 3, dtype=torch.bool)
    ints = torch.zeros(4, dtype=torch.int32)
    bc = PS.TreeVerifyBatchConfig(base, ints, mask, ints[:2], ints, ints,
                                  ints, tree_layout=(2, 2))
    assert batch_to(bc, torch.device("cpu")) is bc
    moved = batch_to(bc, torch.device("meta"))
    assert moved.tree_layout == (2, 2)
    assert moved.base.tokens.is_meta and moved.commit_dst_position.is_meta
    assert all(getattr(moved.base, f).is_meta
               for f in ("request_index", "token_position", "seq_lens"))
