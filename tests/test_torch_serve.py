"""The port's serve slice vs the JAX serve stack, on the CPU.

The JAX side is ``test_serve.make_im`` (TINY Llama), with the Pallas
kernels in interpret mode (``use_pallas=True``) or the gather path
(``use_pallas=False``); its ``im.params`` reach the port through
``params_from_jax``.  Step logits and caches must agree to
``atol=rtol=1e-5`` (float32, same math in another order) and greedy
token streams must be identical.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.serve import GenerationConfig as JaxGenerationConfig
from flexflow_tpu.serve import RequestManager as JaxRequestManager
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    PrefillBatchConfig as JaxPrefillBatchConfig,
)
from flexflow_tpu.serve.inference_manager import (
    pick_prefill_tile as jax_pick_prefill_tile,
)
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    PrefillBatchConfig,
    RequestManager,
    RequestStatus,
    ServeModelConfig,
    build_model,
    params_from_jax,
    pick_prefill_tile,
    sample_tokens,
)
from flexflow_tpu_torch.serve.inference_manager import fold_uniform

from test_serve import TINY, make_im

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = ServeModelConfig(**dataclasses.asdict(TINY))
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_im(jim, cfg=CFG):
    """A port InferenceManager (CPU) with the JAX manager's params and
    capacities."""
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    im = InferenceManager(build_model(cfg), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu")
    return im.init_operators_inference(params_from_jax(params, cfg, "cpu"))


def jax_logits(jim, bc):
    """The JAX step's full float32 logits (its caches advance too)."""
    base = bc if isinstance(bc, JaxBatchConfig) else bc.base
    outs, state = jim._fwd(
        jim.params, {jim._token_tid: base.tokens}, state=jim.state,
        extras={"batch_config": bc, "pallas_decode": jim.use_pallas,
                "pallas_interpret": jim.pallas_interpret,
                "tree_layout": None, "qkv0": None, "pages": None})
    jim.state = state
    return np.asarray(outs[0].astype(jnp.float32))


def assert_caches_close(tim, jim):
    r = jim.max_requests   # row r is the scratch row: pads only
    for name, bufs in jim.state.items():
        for buf in ("k", "v"):
            np.testing.assert_allclose(
                tim.state[name][buf][:r].numpy(),
                np.asarray(bufs[buf])[:r], **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_step_logits_and_caches_match_reference(use_pallas):
    """A prefill step then a decode step: logits at every real token and
    the caches after each step."""
    jim = make_im(max_tokens=8, max_requests=2, max_seq=32,
                  use_pallas=use_pallas)
    tim = port_im(jim)
    p0, p1 = [5, 9, 2, 11, 3], [4, 4, 8]
    if use_pallas:   # the tiled prefill path (one tile per request)
        segs, lens = [(0, p0, 0)], [5]
        jbc, _ = JaxPrefillBatchConfig.build(segs, lens, jim.prefill_tile,
                                             max_tokens=8, max_requests=2)
        tbc, _ = PrefillBatchConfig.build(segs, lens, tim.prefill_tile,
                                          max_tokens=8, max_requests=2,
                                          device="cpu")
        real = 5
    else:            # a flat mixed prefill of both prompts
        args = (p0 + p1, [0] * 5 + [1] * 3, list(range(5)) + [0, 1, 2],
                [5, 3])
        jbc = JaxBatchConfig.build(*args, max_tokens=8, max_requests=2)
        tbc = BatchConfig.build(*args, max_tokens=8, max_requests=2,
                                device="cpu")
        real = 8
    np.testing.assert_allclose(tim.forward(tbc)[:real].numpy(),
                               jax_logits(jim, jbc)[:real], **TOL)
    assert_caches_close(tim, jim)
    args = ([7, 1], [0, 1], [5, 0], [6, 1])
    got = tim.step(BatchConfig.build(*args, max_tokens=8, max_requests=2,
                                     device="cpu"))
    want = jax_logits(jim, JaxBatchConfig.build(*args, max_tokens=8,
                                                max_requests=2))
    np.testing.assert_allclose(got.logits[:2].numpy(), want[:2], **TOL)
    np.testing.assert_array_equal(got.token_ids[:2].numpy(),
                                  want[:2].argmax(-1))
    assert_caches_close(tim, jim)


def _streams(jim, prompts, n_new, eos=None, tim=None):
    want = JaxRequestManager(jim, JaxGenerationConfig(
        max_new_tokens=n_new, eos_token_id=eos)).generate(prompts)
    tim = tim or port_im(jim)
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=n_new,
                                              eos_token_id=eos))
    return rm.generate(prompts), want, rm


@pytest.mark.parametrize("case", ["one_request", "continuous_batching",
                                  "chunked_prefill", "chunked_prefill_tiled"])
def test_greedy_streams_identical_to_reference(case):
    if case == "one_request":
        jim = make_im()
        prompts, n_new = [[3, 11, 25, 40, 7]], 8
    elif case == "continuous_batching":   # 3 requests, 2 slots
        jim = make_im()
        prompts, n_new = [[5, 9, 13], [2, 4, 6, 8, 10, 12], [33, 1]], 6
    else:   # 11-token prompt, 4-token budget: chunks of one tile each
        jim = make_im(max_tokens=4, max_seq=40,
                      use_pallas=case.endswith("tiled"))
        prompts, n_new = [list(range(1, 12)), [9, 8, 7, 6, 5]], 4
    got, want, rm = _streams(jim, prompts, n_new)
    assert got == want
    assert all(r.status is RequestStatus.COMPLETED
               for r in rm.requests.values())
    assert rm.tokens_decoded == sum(len(w) for w in want)
    assert tuple(rm.im.kv.attributed_rids()) == ()


def test_mixed_budgets_freeze_on_device_like_reference():
    """Requests with different max_new_tokens share decode stretches; each
    row stops at its own budget inside ``decode_scan``."""
    jim = make_im(max_seq=64)
    tim = port_im(jim)
    prompts, budgets = [[3, 11, 25], [2, 4, 6, 8], [9]], [2, 9, 5]
    jrm = JaxRequestManager(jim, JaxGenerationConfig(max_new_tokens=9))
    rm = RequestManager(tim, GenerationConfig(max_new_tokens=9))
    for p, n in zip(prompts, budgets):
        jrm.register_new_request(p, n)
        rm.register_new_request(p, n)
    want, got = jrm.serve_incr_decoding(), rm.serve_incr_decoding()
    assert got == want
    assert [len(got[r]) for r in sorted(got)] == budgets
    assert rm.scan_runs >= 1


def test_eos_stops_generation_like_reference():
    prompts = [[3, 11, 25, 40, 7], [2, 4, 6, 8]]
    jim = make_im(max_seq=64)
    base, _, _ = _streams(jim, prompts, 12)
    eos = base[0][5]
    got, want, rm = _streams(jim, prompts, 12, eos=eos)
    assert got == want
    assert got[0] == base[0][: base[0].index(eos) + 1]
    assert rm.scan_runs >= 1     # the EOS freeze ran inside decode_scan


def test_decode_scan_matches_stepwise_and_reference():
    jim = make_im(max_seq=64)
    prompt = [3, 11, 25, 40, 7]
    first = _streams(jim, [prompt], 1)[1][0][0]
    n = len(prompt)
    args = ([first], [0], [n], [n + 1])
    jtoks, jlive, _ = jim.decode_scan(
        JaxBatchConfig.build(*args, max_tokens=jim.max_tokens,
                             max_requests=2), 5)

    def fresh():
        tim = port_im(jim)
        RequestManager(tim, GenerationConfig(max_new_tokens=1)).generate(
            [prompt])
        return tim

    tim = fresh()
    toks, live, bc = tim.decode_scan(
        BatchConfig.build(*args, max_tokens=tim.max_tokens, max_requests=2,
                          device="cpu"), 5)
    np.testing.assert_array_equal(toks[:, 0].numpy(),
                                  np.asarray(jtoks)[:, 0])
    assert live[:, 0].all() and int(bc.token_position[0]) == n + 5
    tim = fresh()
    step_toks, tok = [], first
    for i in range(5):
        r = tim.step(BatchConfig.build([tok], [0], [n + i], [n + i + 1],
                                       max_tokens=tim.max_tokens,
                                       max_requests=2, device="cpu"))
        tok = int(r.token_ids[0])
        step_toks.append(tok)
    assert step_toks == toks[:, 0].tolist()
    # a budget of 3 freezes the row after its third token
    tim = fresh()
    btoks, blive, bbc = tim.decode_scan(
        BatchConfig.build(*args, max_tokens=tim.max_tokens, max_requests=2,
                          device="cpu"), 5,
        allowed=torch.tensor([3] + [0] * (tim.max_tokens - 1),
                             dtype=torch.int32))
    assert blive[:, 0].tolist() == [True] * 3 + [False] * 2
    assert btoks[:3, 0].tolist() == step_toks[:3]
    assert int(bbc.token_position[0]) == n + 3
    assert int(bbc.request_index[0]) == -1


def test_seeded_sampling_is_keyed_by_request_and_token_index():
    """Same seed, same draws; a request's draws do not depend on what else
    shares its batch (the reference's (rid, token-index) key schedule)."""
    jim = make_im(max_seq=64)
    tim = port_im(jim)
    gen = GenerationConfig(max_new_tokens=10, temperature=0.8, top_p=0.9,
                           seed=5)
    a = RequestManager(tim, gen).generate([[3, 11, 25, 40, 7], [2, 4, 6]])
    tim.reset()
    b = RequestManager(tim, gen).generate([[3, 11, 25, 40, 7]])
    assert a[0] == b[0]
    assert all(0 <= t < TINY.vocab_size for t in a[0] + a[1])
    tim.reset()
    c = RequestManager(tim, dataclasses.replace(gen, seed=6)).generate(
        [[3, 11, 25, 40, 7]])
    assert c[0] != a[0]


def test_sample_tokens_distribution():
    """Temperature sampling draws from softmax(logits / T): frequencies
    over 4000 independent (rid, index) keys within 0.03 of the target;
    temperature 0 and a tiny top_p are exact argmax."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]]).repeat(4000, 1)
    folds = torch.stack([torch.arange(4000, dtype=torch.int32),
                         torch.full((4000,), 3, dtype=torch.int32)], 1)
    toks = sample_tokens(logits, (7, 0.7, 1.0, folds))
    freq = torch.bincount(toks.long(), minlength=5).float() / 4000
    torch.testing.assert_close(freq, torch.softmax(logits[0] / 0.7, -1),
                               atol=0.03, rtol=0)
    assert (sample_tokens(logits, (7, 0.0, 1.0, folds)) == 0).all()
    assert (sample_tokens(logits, (7, 0.7, 1e-4, folds)) == 0).all()
    u = fold_uniform(7, folds[:3], 5)
    assert ((u > 0) & (u < 1)).all()
    torch.testing.assert_close(u, fold_uniform(7, folds[:3], 5))


def test_pick_prefill_tile_matches_reference():
    for tokens in (1, 4, 12, 16, 64, 96, 512, 1000):
        for seq in (32, 40, 64, 2048, 2000):
            assert pick_prefill_tile(tokens, seq) == \
                jax_pick_prefill_tile(tokens, seq)


def test_kv_allocator_pads_seq_and_attributes_requests():
    tim = InferenceManager(build_model(CFG), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=40,
                           device="cpu").init_operators_inference(seed=0)
    kv = tim.kv
    k = tim.state["model.layers.0.self_attn"]["k"]
    assert tuple(k.shape) == (3, CFG.kv_heads, 128, CFG.hdim)
    assert kv.allocated_bytes() == CFG.num_hidden_layers * 2 * k.numel() * 4
    kv.bind(4)
    assert kv.attributed_rids() == [4]
    assert kv.release(4, tokens=10) == 10 * kv.bytes_per_token()
    assert kv.attributed_rids() == []


def test_params_from_jax_carries_bfloat16_exactly():
    jim = make_im()
    params = {n: {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in g.items()}
              for n, g in jim.params.items()}
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    sd = params_from_jax(params, cfg, device="cpu")
    w = sd["model.layers.1.self_attn.qkv"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        params["model.layers.1.self_attn"]["qkv"].astype(np.float32))
    tim = InferenceManager(build_model(cfg), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=32,
                           device="cpu").init_operators_inference(sd)
    out = RequestManager(tim, GenerationConfig(max_new_tokens=3)).generate(
        [[3, 5, 7]])
    assert len(out[0]) == 3


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceManager(build_model(CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchConfig.build([1], [0], [0], [1], max_tokens=2, max_requests=1)


def _imported_modules(path):
    """``(module, enclosing function or None)`` of every absolute import."""
    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                yield from ((a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, func
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            yield from walk(child, inner)

    yield from walk(ast.parse(path.read_text()), None)


def test_port_never_imports_jax_or_the_reference_package():
    files = sorted((REPO / "flexflow_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    assert {"spec_infer.py", "spec_scan.py", "opt.py", "falcon.py",
            "mpt.py", "starcoder.py", "weights.py", "resilience.py",
            "slo.py", "cost.py", "telemetry.py", "trace.py", "metrics.py",
            "calibration.py", "drift.py", "memory.py", "profiler.py",
            "plan_health.py", "report.py", "trace_report.py",
            "bench_compare.py", "pp.py", "machine_model.py",
            "serve_search.py", "simulator.py", "measure.py", "config.py",
            "model.py", "transformer.py", "attention.py", "reduction.py",
            "initializer.py", "loss.py", "optimizer.py", "profiling.py",
            "runlog.py", "mnist_mlp.py"} <= {f.name for f in files}
    # the serve graph IR and the PCG (core/), the parallel ops and the
    # plan executor (parallel/), the planner and the Unity search
    # (search/), and training (FFModel, its ops, training/, utils/) are
    # scanned with the rest
    assert {"core/graph.py", "core/interpreter.py", "core/sharding.py",
            "core/op.py", "core/pcg.py", "parallel/parallel_ops.py",
            "parallel/tp.py", "ops/elementwise.py",
            "search/serve_search.py", "search/machine_model.py",
            "search/search.py", "search/strategy.py",
            "search/simulator.py", "flexflow_tpu_torch/config.py",
            "flexflow_tpu_torch/model.py", "models/transformer.py",
            "ops/attention.py", "ops/reduction.py",
            "training/initializer.py", "training/loss.py",
            "training/metrics.py", "training/optimizer.py",
            "utils/profiling.py", "utils/runlog.py",
            "examples/mnist_mlp.py", "parallel/comm.py",
            "parallel/mesh.py", "training/checkpoint.py",
            "data/__init__.py", "data/loader.py", "data/native.py",
            "models/builder.py", "frontends/__init__.py",
            "frontends/torch_fx.py", "frontends/keras.py"} <= {
        f"{f.parent.name}/{f.name}" for f in files}
    for path in files:
        for mod, func in _imported_modules(path):
            top = mod.split(".")[0]
            # transformers only inside weights.load_hf_model, on call
            if (top == "transformers" and path.name == "weights.py"
                    and func == "load_hf_model"):
                continue
            assert top not in ("jax", "jaxlib", "flexflow_tpu",
                               "transformers"), \
                f"{path.relative_to(REPO)} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, flexflow_tpu_torch.serve, "
            "flexflow_tpu_torch.serve.weights, "
            "flexflow_tpu_torch.serve.models.mpt, "
            "flexflow_tpu_torch.serve.resilience, "
            "flexflow_tpu_torch.serve.slo, flexflow_tpu_torch.obs, "
            "flexflow_tpu_torch.obs.report, "
            "flexflow_tpu_torch.tools.trace_report, "
            "flexflow_tpu_torch.tools.bench_compare, "
            "flexflow_tpu_torch.ops.cuda.attention, "
            "flexflow_tpu_torch.core, flexflow_tpu_torch.serve.pp, "
            "flexflow_tpu_torch.core.sharding, flexflow_tpu_torch.core.op, "
            "flexflow_tpu_torch.core.pcg, "
            "flexflow_tpu_torch.parallel.parallel_ops, "
            "flexflow_tpu_torch.parallel.tp, "
            "flexflow_tpu_torch.search.search, "
            "flexflow_tpu_torch.search.strategy, "
            "flexflow_tpu_torch.search, flexflow_tpu_torch.search.measure, "
            "flexflow_tpu_torch.tools.replay_report, flexflow_tpu_torch, "
            "flexflow_tpu_torch.config, flexflow_tpu_torch.model, "
            "flexflow_tpu_torch.models.transformer, "
            "flexflow_tpu_torch.ops.attention, "
            "flexflow_tpu_torch.ops.reduction, "
            "flexflow_tpu_torch.training.initializer, "
            "flexflow_tpu_torch.training.loss, "
            "flexflow_tpu_torch.training.metrics, "
            "flexflow_tpu_torch.training.optimizer, "
            "flexflow_tpu_torch.utils.profiling, "
            "flexflow_tpu_torch.utils.runlog, "
            "flexflow_tpu_torch.examples.mnist_mlp, "
            "flexflow_tpu_torch.parallel.comm, "
            "flexflow_tpu_torch.training.checkpoint, "
            "flexflow_tpu_torch.data, flexflow_tpu_torch.data.loader, "
            "flexflow_tpu_torch.data.native, "
            "flexflow_tpu_torch.serve.models.builder, "
            "flexflow_tpu_torch.frontends, "
            "flexflow_tpu_torch.frontends.torch_fx, "
            "flexflow_tpu_torch.frontends.keras; "
            "bad = [m for m in sys.modules if m in ('jax', 'flexflow_tpu', "
            "'transformers') or m.startswith(('jax.', 'flexflow_tpu.', "
            "'transformers.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_example_serves_on_cpu(capsys):
    sys.path.insert(0, str(REPO))
    from flexflow_tpu_torch.examples import serve_llama

    assert serve_llama.main(["--device", "cpu", "--layers", "1",
                             "--hidden", "32", "--heads", "4",
                             "--kv-heads", "2", "--vocab", "64",
                             "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("-> [") == 4 and "served 4 requests" in out
