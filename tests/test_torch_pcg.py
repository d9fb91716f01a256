"""The port's op IR, shardings, parallel ops and PCG vs the JAX package's.

``flexflow_tpu_torch.core.{sharding,op,pcg}`` and ``parallel.
parallel_ops`` against ``flexflow_tpu.core.{sharding,op,pcg}`` and
``flexflow_tpu.parallel.parallel_ops``, on the CPU (no kernel runs: the
plans are pure planning):

* ``TensorSharding.local_shape`` equals the reference's, and
  ``local_slice`` gives each device the block JAX places on it
  (``jax.device_put`` under the same sharding), on 2- and 4-device
  meshes; ragged splits put the remainder on the low ranks;
* every parallel op's ``transform_sharding`` and ``comm_bytes``, and
  ``reshard_path`` between every pair of a set of shardings (split,
  partial, replicated, two axes), equal the reference's op for op;
* ``PCG(...).plan()`` of the Llama, OPT, Falcon-7B, MPT and StarCoder
  serve graphs at ``tp`` 2 and 4, under ``{}``, the Megatron dict and an
  all-``sample`` dict, equals the reference's plan step for step: node
  names, value ids, input, output and parameter shardings, configs,
  parallel-step kinds and attributes, and bytes.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.core.graph import TensorSpec as JSpec
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.core.sharding import TensorSharding as JSharding
from flexflow_tpu.parallel import parallel_ops as JOPS
from flexflow_tpu.parallel.mesh import make_mesh as jax_mesh
from flexflow_tpu.serve import ServeModelConfig as JaxConfig
from flexflow_tpu.serve import build_model as jax_build_model
from flexflow_tpu.serve.inference_manager import (
    tensor_parallel_strategy as jax_strategy,
)
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.core.graph import TensorSpec
from flexflow_tpu_torch.core.pcg import PCG, serve_graph
from flexflow_tpu_torch.core.sharding import TensorSharding
from flexflow_tpu_torch.parallel import parallel_ops as POPS
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.parallel.tp import tensor_parallel_strategy

ROWS = 16
BASE = dict(vocab_size=68, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
FAMILIES = {
    "llama": dict(model_type="llama", num_key_value_heads=4),
    "opt": dict(model_type="opt"),
    "falcon_7b": dict(model_type="falcon", parallel_attn=True,
                      num_key_value_heads=1),
    "mpt": dict(model_type="mpt"),
    "starcoder": dict(model_type="gpt_bigcode", num_key_value_heads=1),
}
MESHES = {"tp2": {"tp": 2}, "tp4": {"tp": 4}, "dp2xtp2": {"dp": 2, "tp": 2}}


def meshes(shape):
    n = int(np.prod(list(shape.values())))
    return (jax_mesh(shape, jax.devices()[:n]),
            Mesh(shape, ["cpu"] * n))


def shardings(shape, ndim=3):
    """(axis map, partial axes) pairs: replicated, each axis on each dim,
    each axis partial, and with two axes both on one dim and one a dim
    apart."""
    axes = list(shape)
    out = [({}, ())]
    for a in axes:
        out += [({d: (a,)}, ()) for d in range(ndim)] + [({}, (a,))]
        out += [({0: (a,)}, tuple(b for b in axes if b != a))]
    if len(axes) == 2:
        out += [({0: tuple(axes)}, ()), ({0: (axes[0],), 2: (axes[1],)}, ()),
                ({1: (axes[1],)}, (axes[0],))]
    return out


def pair(desc, ndim=3):
    amap, partial = desc
    return (JSharding.from_axes(ndim, amap, partial),
            TensorSharding.from_axes(ndim, amap, partial))


def op_desc(op):
    attrs = {k: v for k, v in vars(op).items()
             if k in ("dim", "axes", "src_dim", "dst_dim")}
    return (op.type_name, tuple(sorted(attrs.items())))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shape_and_slice_are_the_reference_blocks(mesh):
    """Each device's block under a sharding is the block JAX places on
    that device (``jax.device_put``, ``addressable_shards``), its shape
    the reference's ``local_shape``; a ragged split's blocks (rank
    given) cover the dimension, the remainder on the low ranks."""
    jm, pm = meshes(MESHES[mesh])
    shape = (8, 12, 16)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    devs = list(jm.devices.flat)
    for desc in shardings(MESHES[mesh]):
        js, ps = pair(desc)
        assert ps.local_shape(shape, pm) == js.local_shape(shape, jm)
        if ps.partial_axes:
            continue
        arr = jax.device_put(x, NamedSharding(jm, js.partition_spec()))
        blocks = {s.device: np.asarray(x[s.index])
                  for s in arr.addressable_shards}
        for rank, dev in enumerate(devs):
            got = ps.local_slice(torch.from_numpy(x), rank, pm)
            np.testing.assert_array_equal(got.numpy(), blocks[dev])
            assert tuple(got.shape) == ps.local_shape(shape, pm, rank)
    ragged = TensorSharding.from_axes(2, {0: tuple(MESHES[mesh])})
    n = pm.size
    rows = [ragged.local_shape((2 * n + 1, 4), pm, r)[0] for r in range(n)]
    assert sum(rows) == 2 * n + 1 and rows[0] == 3 and rows[-1] == 2
    with pytest.raises(ValueError):
        ragged.local_shape((2 * n + 1, 4), pm)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_parallel_ops_and_reshard_path_equal_reference(mesh):
    """``reshard_path`` between every pair of shardings: the same ops with
    the same attributes, and at every op the same ``transform_sharding``
    and ``comm_bytes``; an impossible path raises on both sides."""
    jm, pm = meshes(MESHES[mesh])
    shape = (8, 12, 16)
    jspec, pspec = JSpec(shape), TensorSpec(shape)
    descs = shardings(MESHES[mesh])
    n_ops = 0
    for src, dst in itertools.product(descs, descs):
        (jsrc, psrc), (jdst, pdst) = pair(src), pair(dst)
        try:
            want = JOPS.reshard_path(jsrc, jdst, jm)
        except (ValueError, AssertionError) as e:
            with pytest.raises(type(e)):
                POPS.reshard_path(psrc, pdst, pm)
            continue
        got = POPS.reshard_path(psrc, pdst, pm)
        assert [op_desc(o) for o in got] == [op_desc(o) for o in want]
        jcur, pcur = jsrc, psrc
        for jo, po in zip(want, got):
            assert po.comm_bytes(pspec, pcur, pm) == jo.comm_bytes(
                jspec, jcur, jm)
            jcur = jo.transform_sharding(jcur, jm)
            pcur = po.transform_sharding(pcur, pm)
            assert str(pcur) == str(jcur)
            n_ops += 1
    assert n_ops > 20
    # each op on its own: the transform and the bytes of every sharding
    ops = [("Replicate", (("tp",),)), ("Repartition", (1, ("tp",))),
           ("Combine", (2, ("tp",))), ("Reduction", (0, ("tp",))),
           ("AllReduce", (("tp",),)), ("AllToAll", (2, 0, ("tp",)))]
    for name, args in ops:
        jo, po = getattr(JOPS, name)(*args), getattr(POPS, name)(*args)
        for desc in descs:
            (js, ps) = pair(desc)
            try:
                want = str(jo.transform_sharding(js, jm))
            except ValueError:
                with pytest.raises(ValueError):
                    po.transform_sharding(ps, pm)
                continue
            assert str(po.transform_sharding(ps, pm)) == want
            assert po.comm_bytes(pspec, ps, pm) == jo.comm_bytes(jspec, js,
                                                                 jm)


def both(family, degree):
    fields = {**BASE, **FAMILIES[family]}
    jm, pm = meshes({"tp": degree})
    ff = FFModel(FFConfig(), mesh=jm)
    jax_build_model(ff, JaxConfig(**fields), ROWS)
    return ff, jm, PS.build_model(PS.ServeModelConfig(**fields)), pm


def describe(plan, mesh):
    """Every step of a plan as plain values: the name, value ids, specs,
    shardings, config, the parallel op with its bytes, and the node's
    parameter shardings."""
    out = []
    for s in plan.steps:
        op = s.node.op
        row = (s.name, s.is_parallel, op.type_name, s.in_vids, s.out_vids,
               [tuple(x.shape) for x in s.in_specs + s.out_specs],
               [x.nbytes() for x in s.in_specs + s.out_specs],
               [str(x) for x in s.in_shardings + s.out_shardings],
               {k: tuple(v) for k, v in s.config.items()},
               {p: str(sh) for p, sh in
                plan.param_shardings.get(s.name, {}).items()})
        if s.is_parallel:
            row += (op_desc(op), op.comm_bytes(s.in_specs[0],
                                               s.in_shardings[0], mesh))
        out.append(row)
    tail = (plan.input_vids, plan.output_vids,
            {t: str(sh) for t, sh in plan.input_shardings.items()},
            [str(sh) for sh in plan.output_shardings])
    return out, tail


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plans_equal_reference_step_for_step(family):
    """Each family's serve graph at ``tp`` 2 and 4, planned under ``{}``,
    the Megatron dict (the port's own rule over its modules, equal to the
    reference's) and an all-``sample`` dict: the port's plan is the
    reference's, step for step."""
    for degree in (2, 4):
        ff, jm, model, pm = both(family, degree)
        mega = tensor_parallel_strategy(model, degree)
        assert mega == jax_strategy(ff.graph, ("tp",), jm)
        sample = {n.name: {"sample": ("tp",)} for n in ff.graph.nodes}
        for strategy in ({}, mega, sample):
            out = [ff.graph.nodes[-1].outputs[-1]]
            want = describe(JPCG(ff.graph, jm, strategy,
                                 output_tids=out).plan(), jm)
            got = describe(PCG(serve_graph(model, ROWS), pm, strategy,
                               output_tids=out).plan(), pm)
            assert got == want, (family, degree, strategy is sample)
            assert any(r[1] for r in got[0]) == bool(strategy)
