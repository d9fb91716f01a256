"""The pipeline search of the port against the JAX package's, on the CPU.

``search/pipeline_search.py``: ``chain_partition``'s stage maps,
``simulate_pipeline``'s time, ``propose_pipeline``'s stage map and cost
(with and without the segment groups ``FFModel`` gives it), and
``pipeline_or_gspmd``'s kind, strategy, stage map and cost, against the
reference's at ``rel=1e-9`` (``tests/test_pipeline_search.py:58-187``):
the ``v5e`` spec with the ``pp`` axis on DCN, including the
memory-forced flip and the ``n_micro`` 16 against 1 boundary, and the
same calls priced on ``h100`` (the reference given the port's
constants).  Only graphs are built: parameters stay unallocated.
"""

import dataclasses
import math

import jax
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.search import pipeline_search as JS
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu.search.machine_model import TPUSpec as JaxSpec
from flexflow_tpu_torch.search import pipeline_search as PS
from flexflow_tpu_torch.search.machine_model import MachineModel

SPECS = ["v5e", "h100"]


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-18)


def meshes(shape):
    n = math.prod(shape.values())
    return (J.make_mesh(shape, jax.devices()[:n]),
            T.make_mesh(shape, ["cpu"] * n))


def machines(spec, jmesh, pmesh):
    """Both machines; the pp axis rides DCN (the reference's tests)."""
    pmm = MachineModel.for_mesh(pmesh, spec_name=spec, dcn_axes=("pp",))
    if spec == "h100":   # the reference priced with the port's constants
        return (JaxMachine(JaxSpec(**dataclasses.asdict(pmm.spec)),
                           frozenset(("pp",))), pmm)
    return JaxMachine.for_mesh(jmesh, spec_name=spec,
                               dcn_axes=("pp",)), pmm


def chain_mlp(pkg, mesh, n_layers=8, width=64, batch=16):
    """``tests/test_pipeline_search.py:chain_mlp``."""
    model = pkg.FFModel(pkg.FFConfig(batch_size=batch), mesh=mesh)
    h = model.create_tensor((batch, width))
    for i in range(n_layers):
        h = model.dense(h, width, activation="relu", name=f"blk{i}",
                        use_bias=True)
    model.softmax(model.dense(h, 8, name="head"))
    return model


def bottleneck_chain(pkg, mesh, n_blocks=4, wide=16384, narrow=512,
                     batch=2048):
    """``tests/test_pipeline_search.py:bottleneck_chain``."""
    model = pkg.FFModel(pkg.FFConfig(batch_size=batch), mesh=mesh)
    h = model.create_tensor((batch, narrow))
    for i in range(n_blocks):
        h = model.dense(h, wide, activation="relu", name=f"up{i}")
        h = model.dense(h, narrow, name=f"down{i}")
    model.softmax(model.dense(h, 8, name="head"))
    return model


def both(build, shape=None, **kw):
    jmesh, pmesh = meshes(shape or {"pp": 4, "dp": 2})
    return (build(J, jmesh, **kw), build(T, pmesh, **kw)), (jmesh, pmesh)


def same_result(jr, pr):
    """``pipeline_or_gspmd``'s four values alike on both sides."""
    assert pr[0] == jr[0]
    assert pr[1] == jr[1]
    assert pr[2] == jr[2]
    assert close(pr[3], jr[3]), (pr[3], jr[3])


@pytest.mark.parametrize("costs,k", [
    ([4, 1, 1, 1, 1, 4], 3), ([1.0, 2.0], 4), ([1.0] * 8, 4),
    ([3.0, 1.5, 2.5, 0.5, 4.0, 1.0, 2.0], 3), ([0.25] * 5 + [2.0], 2)])
def test_chain_partition_matches_reference(costs, k):
    assert PS.chain_partition(costs, k) == JS.chain_partition(costs, k)
    assert PS.chain_partition([4, 1, 1, 1, 1, 4], 3) == [0, 1, 1, 1, 1, 2]


@pytest.mark.parametrize("spec", SPECS)
def test_simulate_pipeline_matches_reference(spec):
    jmesh, pmesh = meshes({"pp": 4, "dp": 2})
    jmm, pmm = machines(spec, jmesh, pmesh)
    for training in (True, False):
        args = ([1e-3, 2e-3, 1.5e-3, 1e-3], [4e6, 1e6, 2e6], 8)
        assert close(
            PS.simulate_pipeline(*args, pmm, ("pp",), pmesh, training),
            JS.simulate_pipeline(*args, jmm, ("pp",), jmesh, training))


@pytest.mark.parametrize("spec", SPECS)
def test_propose_pipeline_matches_reference(spec):
    (jm, pm), (jmesh, pmesh) = both(chain_mlp)
    jmm, pmm = machines(spec, jmesh, pmesh)
    js, jc = JS.propose_pipeline(jm.graph, jmesh, "pp", n_micro=8,
                                 machine=jmm, strategy={})
    ps, pc = PS.propose_pipeline(pm.graph, pmesh, "pp", n_micro=8,
                                 machine=pmm, strategy={})
    assert ps == js and close(pc, jc)
    stages = [ps[f"blk{i}"] for i in range(8)]
    assert stages == sorted(stages) and len(set(ps.values())) == 4


@pytest.mark.parametrize("spec", SPECS)
def test_propose_pipeline_over_segments_matches_reference(spec):
    """The classifier's segments as ``FFModel`` groups them."""
    sizes = dict(batch=16, seq=8, num_layers=4, hidden_dim=32, num_heads=4,
                 ff_dim=64, num_classes=4)
    jmesh, pmesh = meshes({"pp": 2, "dp": 4})
    from flexflow_tpu.models.transformer import \
        build_transformer_classifier as jb
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier as pb
    jm = jb(J.FFConfig(batch_size=16), mesh=jmesh, **sizes)
    pm = pb(T.FFConfig(batch_size=16), mesh=pmesh, **sizes)
    jmm, pmm = machines(spec, jmesh, pmesh)
    out = []
    for m, mod, mesh, mm in ((jm, JS, jmesh, jmm), (pm, PS, pmesh, pmm)):
        segs, err = m._pipeline_segments()
        assert err is None
        groups = {n.name: gi for gi, (nodes, _, _) in enumerate(segs)
                  for n in nodes}
        out.append(mod.propose_pipeline(m.graph, mesh, "pp", n_micro=4,
                                        machine=mm, strategy={},
                                        groups=groups))
    (js, jc), (ps, pc) = out
    assert ps == js and close(pc, jc)


@pytest.mark.parametrize("spec", SPECS)
def test_memory_forced_flip_matches_reference(spec):
    (jm, pm), (jmesh, pmesh) = both(chain_mlp, width=2048, batch=1024)
    jmm, pmm = machines(spec, jmesh, pmesh)
    for limit in (320e6, 0):
        kw = dict(n_micro=8, budget=120, seed=0, memory_limit=limit)
        pr = PS.pipeline_or_gspmd(pm.graph, pmesh, "pp", machine=pmm, **kw)
        jr = JS.pipeline_or_gspmd(jm.graph, jmesh, "pp", machine=jmm, **kw)
        same_result(jr, pr)
        if spec == "v5e":   # the reference's own expectations
            assert pr[0] == ("pipeline" if limit else "gspmd")


@pytest.mark.parametrize("spec", SPECS)
def test_cost_boundary_matches_reference(spec):
    (jm, pm), (jmesh, pmesh) = both(bottleneck_chain)
    jmm, pmm = machines(spec, jmesh, pmesh)
    for n_micro in (16, 1):
        kw = dict(n_micro=n_micro, budget=120, seed=0, memory_limit=0)
        cands = {}
        pr = PS.pipeline_or_gspmd(pm.graph, pmesh, "pp", machine=pmm,
                                  candidates=cands, **kw)
        jr = JS.pipeline_or_gspmd(jm.graph, jmesh, "pp", machine=jmm, **kw)
        same_result(jr, pr)
        assert close(cands[pr[0]], pr[3])
        assert pr[0] == min(cands, key=cands.get)
        if spec == "v5e":
            assert pr[0] == ("pipeline" if n_micro == 16 else "gspmd")
