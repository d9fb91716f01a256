"""The modules of the port's other model families vs the JAX package, on
the CPU (K1 with ALiBi: ``tests/test_torch_zoo_kernels.py``).

* the layers: ``LayerNorm`` with and without a shift, ``Linear`` with a
  bias and each activation, ``PositionEmbedding`` (offsets 0 and 2, clipped
  past the table), each against the JAX op's ``lower`` on the same numpy
  inputs, float32 ``atol=rtol=1e-6``;
* the HF converters (when ``transformers`` is installed): for a tiny HF
  model of each family, built as ``tests/test_model_zoo.py`` builds it,
  the port's converter output equals the JAX converter's array for array,
  and the port's greedy stream equals ``model.generate``'s;
* MPT's speculative steps (the gather path with ``spec_pos``): logits,
  caches and spec state against the JAX model's, float32
  ``atol=rtol=1e-5``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.op import OpContext
from flexflow_tpu.ops.linear import Linear as JaxLinear
from flexflow_tpu.ops.norm import LayerNorm as JaxLayerNorm
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.ops import PositionEmbedding as JaxPositionEmbedding
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.ops.embedding import PositionEmbedding
from flexflow_tpu_torch.ops.linear import Linear
from flexflow_tpu_torch.ops.norm import LayerNorm
from flexflow_tpu_torch.serve import (
    BatchConfig,
    GenerationConfig,
    InferenceManager,
    RequestManager,
    ServeModelConfig,
    build_model,
    convert_state_dict,
    params_from_jax,
)

# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401
from test_torch_zoo import configs

LAYER_TOL = dict(atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _copy(mod, **params):
    with torch.no_grad():
        for name, arr in params.items():
            getattr(mod, name).copy_(torch.from_numpy(arr))
    return mod


@pytest.mark.parametrize("use_bias", [True, False])
def test_layer_norm(use_bias):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 32)) * 3 + 1).astype(np.float32)
    p = {"gamma": rng.normal(size=32).astype(np.float32)}
    if use_bias:
        p["beta"] = rng.normal(size=32).astype(np.float32)
    [want] = JaxLayerNorm(32, eps=1e-5, use_bias=use_bias).lower(
        OpContext(), [jnp.asarray(x)], {k: jnp.asarray(v)
                                        for k, v in p.items()})
    mod = _copy(LayerNorm(32, 1e-5, use_bias=use_bias), **p)
    assert (mod.beta is not None) == use_bias
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("activation", [None, "relu", "gelu", "gelu_exact"])
def test_dense_with_bias_and_activation(activation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 32)).astype(np.float32)
    p = {"kernel": (rng.normal(size=(32, 48)) / 6).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    [want] = JaxLinear(48, activation, use_bias=True).lower(
        OpContext(), [jnp.asarray(x)], {k: jnp.asarray(v)
                                        for k, v in p.items()})
    mod = _copy(Linear(32, 48, use_bias=True, activation=activation), **p)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(),
                               np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("offset", [0, 2])
def test_position_embedding(offset):
    rng = np.random.default_rng(2)
    n = 16
    x = rng.normal(size=(5, 8)).astype(np.float32)
    w = rng.normal(size=(n + offset, 8)).astype(np.float32)
    fields = ([1, 2, 3, 4, 5], [0, 0, 1, 1, -1], [0, 7, n - 1, n + 5, 0],
              [8, n + 6])   # position n + 5 is past the table: clipped
    jbc = JaxBatchConfig.build(*fields, max_tokens=5, max_requests=2)
    tbc = BatchConfig.build(*fields, max_tokens=5, max_requests=2,
                            device="cpu")
    [want] = JaxPositionEmbedding(n, 8, offset).lower(
        OpContext(extras={"batch_config": jbc}), [jnp.asarray(x)],
        {"weight": jnp.asarray(w)})
    mod = _copy(PositionEmbedding(n, 8, offset), weight=w)
    got = mod(torch.from_numpy(x), tbc.token_position)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_array_equal(got[3].numpy(), x[3] + w[-1])


# ---------------------------------------------------------------------------
# speculative steps on an ALiBi layer: the gather path
# ---------------------------------------------------------------------------
def test_speculative_steps_on_alibi_layers_match_reference(monkeypatch):
    """MPT's tree steps take the reference's gather path (``spec_pos``,
    ALiBi on the committed and the spec keys): a prefill, a TreeSearch
    step, then a TreeVerify step with a commit descriptor, against the
    JAX model's ``_tree_attend`` (every layer's, through the logits) at
    the real tokens, with the caches, spec buffers and ``spec_pos`` after
    each step; no tree kernel runs."""
    from test_torch_spec import (
        TOL,
        _assert_state_close,
        _both_tree_bcs,
        _jax_step,
        _tree_masks,
    )
    from test_torch_zoo import jax_im, params_np

    def no_tree_kernel(*a, **k):
        raise AssertionError("an ALiBi tree step reached a tree kernel")

    for name in ("tree_attention_plain", "tree_attention_batched_plain"):
        monkeypatch.setattr(att, name, no_tree_kernel)
    jim = jax_im("mpt", max_tokens=16, max_seq=32, max_spec=8)
    _, cfg = configs("mpt")
    tim = InferenceManager(build_model(cfg), max_requests=2,
                           max_tokens_per_batch=16, max_seq_len=32,
                           device="cpu", max_spec_tokens=8)
    tim.init_operators_inference(params_from_jax(params_np(jim), cfg, "cpu"))
    args = ([5, 9, 2, 11, 3, 4, 4, 8], [0] * 5 + [1] * 3,
            list(range(5)) + [0, 1, 2], [5, 3])
    tim.forward(BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                  device="cpu"))
    _jax_step(jim, JaxBatchConfig.build(*args, max_tokens=16,
                                        max_requests=2))
    steps = [_both_tree_bcs(
        "search", [7, 12, 30, 1], [0, 0, 0, 1], [5, 6, 6, 3], [6, 7],
        [0, 1, 2, 0], _tree_masks(8, {0: [-1, 0, 0], 1: [-1]}), [5, 3]),
        _both_tree_bcs(
        "verify", [13, 2, 40, 9, 22], [0, 0, 0, 1, 1], [7, 8, 9, 4, 5],
        [8, 5], [0, 1, 2, 0, 1], _tree_masks(8, {0: [-1, 0, 1], 1: [-1, 0]}),
        [7, 4], commit=[(0, 0, 5), (0, 1, 6), (1, 0, 3)])]
    for n, (jbc, tbc) in zip((4, 5), steps):
        got = tim.forward(tbc)
        np.testing.assert_allclose(got[:n].numpy(), _jax_step(jim, jbc)[:n],
                                   **TOL["float32"])
        _assert_state_close(tim, jim)
        for name, bufs in jim.state.items():
            np.testing.assert_array_equal(
                tim.state[name]["spec_pos"][:2].numpy(),
                np.asarray(bufs["spec_pos"])[:2])


# ---------------------------------------------------------------------------
# HF converters (transformers is optional)
# ---------------------------------------------------------------------------
def _hf_models():
    """{family: HF causal LM}, tiny random models built as
    tests/test_model_zoo.py builds them (float32, eval)."""
    tr = pytest.importorskip("transformers")
    specs = {
        "opt": (tr.OPTConfig, tr.OPTForCausalLM, 1, dict(
            vocab_size=97, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            do_layer_norm_before=True, activation_function="relu",
            word_embed_proj_dim=32)),
        "opt_post_ln": (tr.OPTConfig, tr.OPTForCausalLM, 7, dict(
            vocab_size=97, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            do_layer_norm_before=False, activation_function="relu",
            word_embed_proj_dim=16)),
        # no ffn_hidden_size: HF makes it 4 x hidden, and the config must
        # say so for the MLP's shape
        "falcon_7b": (tr.FalconConfig, tr.FalconForCausalLM, 2, dict(
            vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, multi_query=True, parallel_attn=True,
            new_decoder_architecture=False, bias=False, alibi=False,
            rope_theta=10000.0)),
        "falcon_rw": (tr.FalconConfig, tr.FalconForCausalLM, 5, dict(
            vocab_size=97, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, multi_query=False, parallel_attn=False,
            new_decoder_architecture=False, bias=True, alibi=True,
            ffn_hidden_size=48)),
        # transformers' MPT MLP is 4 x d_model whatever expansion_ratio says
        # (test_model_zoo's 2 gives 4x weights); the config states 4 here
        "mpt": (tr.MptConfig, tr.MptForCausalLM, 3, dict(
            vocab_size=97, d_model=32, n_heads=4, n_layers=2,
            expansion_ratio=4, max_seq_len=64, no_bias=True)),
        "starcoder": (tr.GPTBigCodeConfig, tr.GPTBigCodeForCausalLM, 4, dict(
            vocab_size=97, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            n_inner=64, multi_query=True,
            activation_function="gelu_pytorch_tanh")),
    }
    out = {}
    for family, (cfg_cls, model_cls, seed, kw) in specs.items():
        torch.manual_seed(seed)
        out[family] = model_cls(cfg_cls(**kw)).eval().to(torch.float32)
    return out


@pytest.fixture(scope="module")
def hf_models():
    return _hf_models()


HF_FAMILIES = ["opt", "opt_post_ln", "falcon_7b", "falcon_rw", "mpt",
               "starcoder"]


@pytest.mark.parametrize("family", HF_FAMILIES)
def test_hf_converter_matches_reference_and_hf_generate(hf_models, family):
    from flexflow_tpu.serve.models.base import (
        ServeModelConfig as JaxServeModelConfig,
    )
    from flexflow_tpu.serve.weights import (
        convert_state_dict as jax_convert_state_dict,
    )

    model = hf_models[family]
    cfg = ServeModelConfig.from_hf_config(model.config)
    if family.startswith("falcon"):
        # the reference leaves Falcon's MLP width at the Llama default
        assert cfg.intermediate_size == model.config.ffn_hidden_size
        assert JaxServeModelConfig.from_hf_config(
            model.config).intermediate_size == 11008
    sd = model.state_dict()
    got = convert_state_dict(sd, cfg)
    want = jax_convert_state_dict(
        sd, JaxServeModelConfig(**dataclasses.asdict(cfg)))
    assert got.keys() == want.keys()
    for node, group in want.items():
        assert group.keys() == got[node].keys(), node
        for name, arr in group.items():
            np.testing.assert_array_equal(got[node][name], np.asarray(arr))
    im = InferenceManager(build_model(cfg), max_requests=2,
                          max_tokens_per_batch=16, max_seq_len=64,
                          device="cpu")
    im.init_operators_inference(params_from_jax(got, cfg, "cpu"))
    prompts = [[5, 9, 13, 44, 2], [81, 3, 17]]
    outs = RequestManager(im, GenerationConfig(max_new_tokens=8)).generate(
        prompts)
    for p, o in zip(prompts, outs):
        with torch.no_grad():
            ref = model.generate(torch.tensor([p]), max_new_tokens=8,
                                 do_sample=False, eos_token_id=None,
                                 pad_token_id=0)
        assert o == ref[0, len(p):].tolist(), (family, p)


def test_from_hf_config_takes_a_plain_dict():
    cfg = ServeModelConfig.from_hf_config(dict(
        model_type="mpt", d_model=4096, n_heads=32, n_layers=32,
        expansion_ratio=4, vocab_size=50432, torch_dtype="bfloat16",
        attn_config={"alibi": True}))
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.dtype, cfg.use_alibi) == \
        (4096, 16384, 32, 32, "bfloat16", True)
    falcon = ServeModelConfig.from_hf_config(dict(
        model_type="falcon", hidden_size=4544, num_attention_heads=71,
        multi_query=True))
    assert (falcon.intermediate_size, falcon.kv_heads) == (4 * 4544, 1)
