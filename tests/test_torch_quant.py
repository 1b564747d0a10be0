"""QuantPolicy, the MX fake-quant at the GEMM boundaries (the paper's
asymmetric data path: MXINT4 weights, MXINT8 activations), in the PyTorch
port vs the JAX package, f32 smoke configs on the CPU: qdot (with the MX
exponent edge cases made exact: an all-zero block and blocks whose amax
is grid_max times a power of two, where log2 is exact on both backends),
the dense forward, generate() in every cache mode and head path, and the
serving engine with ``EngineConfig(fwd_kw={"quant": ...})``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.core import sampling as jsampling
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import fused_head_sampling as tfh
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

FMT_PAIRS = [("mxint4", "mxint8"), ("mxint8", "mxint8"),
             ("mxfp8_e4m3", "mxfp8_e4m3")]


def _policies(weight_fmt="mxint4", act_fmt="mxint8"):
    return (jlayers.QuantPolicy(True, weight_fmt, act_fmt),
            tlayers.QuantPolicy(True, weight_fmt, act_fmt))


@pytest.fixture(scope="module", params=["llada-8b", "qwen2-0.5b",
                                        "minicpm-2b"])
def models(request):
    cfg_j = jbase.get_config(request.param, smoke=True)
    cfg_t = tbase.get_config(request.param, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def test_policy_defaults_match_jax():
    j, t = jlayers.QuantPolicy(), tlayers.QuantPolicy()
    assert (t.enabled, t.weight_fmt, t.act_fmt) == \
        (j.enabled, j.weight_fmt, j.act_fmt)
    x = torch.randn(4, 64)
    assert tlayers.QuantPolicy().weights(x) is x
    assert tlayers.QuantPolicy().acts(x) is x


def _edge_operands(seed):
    """x (5, 96) and w (96, 40), f32: random, one all-zero MX block of x
    (along its last axis) and of w (along its first), and blocks whose
    amax is exactly grid_max * 2^k for each format's grid_max (the
    exponent rule's boundary, log2 exact on both backends)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(5, 96) * 3).astype(np.float32)
    w = (rs.randn(96, 40) * 0.2).astype(np.float32)
    x[1, 32:64] = 0.0
    w[:32, 3] = 0.0
    for i, gmax in enumerate((7 / 4, 127 / 64, 448.0)):
        x[2 + i, 5] = gmax * 4
        w[40, 5 + i] = gmax / 8
    return x, w


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("weight_fmt,act_fmt", FMT_PAIRS)
def test_qdot_matches_jax(weight_fmt, act_fmt, with_bias):
    """The fake-quantized operands bit for bit, the product rtol 1e-5."""
    x, w = _edge_operands(len(weight_fmt) + len(act_fmt))
    b = np.random.RandomState(1).randn(40).astype(np.float32)
    pj, pt = _policies(weight_fmt, act_fmt)
    np.testing.assert_array_equal(pt.weights(torch.from_numpy(w)).numpy(),
                                  np.asarray(pj.weights(jnp.asarray(w))))
    np.testing.assert_array_equal(pt.acts(torch.from_numpy(x)).numpy(),
                                  np.asarray(pj.acts(jnp.asarray(x))))
    bias_j = jnp.asarray(b) if with_bias else None
    bias_t = torch.from_numpy(b) if with_bias else None
    want = jlayers.qdot(jnp.asarray(x), jnp.asarray(w), pj, bias_j)
    got = tlayers.qdot(torch.from_numpy(x), torch.from_numpy(w), pt, bias_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    plain = tlayers.qdot(torch.from_numpy(x), torch.from_numpy(w), None,
                         bias_t)
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("head_mode", ["hidden", "logits"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_forward_under_quant_matches_jax(models, head_mode, with_cache):
    """forward(quant=...) over 40 positions, with and without the warm
    cache (rows of length 40, 25, 1): hidden states or logits (the head's
    GEMM fake-quantized too) rtol 1e-5 (atol 1e-6 near 0)."""
    model_j, model_t, params_j, params_t = models
    cfg_j, cfg_t = model_j.cfg, model_t.cfg
    B, S = 3, 40
    toks = np.random.RandomState(1).randint(0, cfg_j.vocab, size=(B, S)
                                            ).astype(np.int32)
    qj, qt = _policies()
    kw_j, kw_t = {}, {}
    if with_cache:
        valid = np.arange(S)[None, :] < np.array([[40], [25], [1]])
        kw_j = dict(cache=jtr.init_cache(cfg_j, B, S),
                    kv_valid=jnp.asarray(valid))
        kw_t = dict(cache=ttr.init_cache(cfg_t, B, S, "cpu"),
                    kv_valid=torch.from_numpy(valid))
    want, _, _ = jtr.forward(params_j, cfg_j, jnp.asarray(toks),
                             head_mode=head_mode, quant=qj, **kw_j)
    got, _ = ttr.forward(params_t, cfg_t, torch.from_numpy(toks),
                         head_mode=head_mode, quant=qt, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_fused_head_quant_on_a_padded_head():
    """The fused sampling step under quant: the head's fake-quant runs on
    its padded rows (V 257 stored 264 wide) and gives the logical head's
    result, which equals JAX's fused oracle with the same policy."""
    rs = np.random.RandomState(4)
    h = rs.randn(2, 8, 64).astype(np.float32)
    w = (rs.randn(64, 257) * 0.5).astype(np.float32)
    x = np.full((2, 8), 256, np.int32)
    k = np.array([3, 8], np.int32)
    qj, qt = _policies()
    cfg = tsampling.SamplingConfig(fmt="bf16")
    got = tsampling.fused_sampling_step_full(
        torch.from_numpy(h), tfh.pad_head(torch.from_numpy(w)),
        torch.from_numpy(x), 256, torch.from_numpy(k), cfg, quant=qt)
    flat = tsampling.fused_sampling_step_full(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(x), 256,
        torch.from_numpy(k), cfg, quant=qt)
    want = jsampling.fused_sampling_step_full(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(x), 256, jnp.asarray(k),
        jsampling.SamplingConfig(fmt="bf16"), quant=qj)
    for a, b in zip(got, flat):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)


@pytest.mark.parametrize("cache_mode,head_path,kv_format", [
    ("none", "fused", None), ("none", "unfused", None),
    ("none", "legacy", None), ("dual", "fused", "mxint4"),
    ("prefix", "fused", "mxint4"), ("dual", "unfused", None)])
def test_generate_under_quant_matches_jax(models, cache_mode, head_path,
                                          kv_format):
    """Greedy tokens of generate(quant=...) equal JAX's, graphed and eager
    steps alike; dual + BAOS mxint4 with bf16 sampling is Table 6's
    operating point (MXINT4 weights and KV, MXINT8 activations, BF16
    sampling)."""
    model_j, model_t, params_j, params_t = models
    on = kv_format is not None
    kw = dict(gen_length=16, block_length=8, steps_per_block=4,
              cache_mode=cache_mode, head_path=head_path)
    dj = jdiff.DiffusionConfig(
        baos=jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4"),
        sampling=jsampling.SamplingConfig(fmt="bf16"), **kw)
    dt = tdiff.DiffusionConfig(
        baos=tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4"),
        sampling=tsampling.SamplingConfig(fmt="bf16"), **kw)
    prompt = np.random.RandomState(9).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    qj, qt = _policies()
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(2), quant=qj)
    for jit_steps in (True, False):
        got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                             seed=2, jit_steps=jit_steps, quant=qt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                           seed=2)
    assert not bool((plain == model_t.cfg.mask_id).any())
    tdiff.clear_step_graphs()


@pytest.mark.parametrize("mode,megatick_k", [("warm", 1), ("none", 1),
                                             ("warm", 4)])
def test_engine_fwd_kw_quant_matches_jax(models, mode, megatick_k):
    """EngineConfig(fwd_kw={'quant': ...}) on a mixed-length trace: final
    tokens equal the JAX engine's with the same fwd_kw (the port's megatick
    against JAX's K=1 engine, whose tokens its own megatick equals)."""
    model_j, model_t, params_j, params_t = models
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    qj, qt = _policies()
    rs = np.random.RandomState(0)
    trace = [(rs.randint(0, model_t.cfg.vocab - 2, size=(8 + 4 * i,)
                         ).astype(np.int32), 8 * (1 + i % 2))
             for i in range(3)]
    eng_j = JEngine(model_j, params_j,
                    jdiff.DiffusionConfig(cache_mode="none", **kw),
                    JEngineConfig(num_slots=2, max_seq_len=48, mode=mode,
                                  rng=jax.random.PRNGKey(0),
                                  fwd_kw={"quant": qj}))
    eng_t = ServingEngine(model_t, params_t, tdiff.DiffusionConfig(**kw),
                          EngineConfig(num_slots=2, max_seq_len=48,
                                       mode=mode, megatick_k=megatick_k,
                                       fwd_kw={"quant": qt}))
    done_j = eng_j.run([JRequest(prompt=p, gen_length=g) for p, g in trace])
    done_t = eng_t.run([Request(prompt=p, gen_length=g) for p, g in trace])
    assert {c.uid: c.tokens.tolist() for c in done_t} == \
        {c.uid: c.tokens.tolist() for c in done_j}


def test_engine_rejects_unknown_fwd_kw(models):
    _, model_t, _, params_t = models
    with pytest.raises(ValueError, match="forward kwargs"):
        ServingEngine(model_t, params_t, tdiff.DiffusionConfig(),
                      EngineConfig(fwd_kw={"remat": "full"}))
