"""The audio family of the PyTorch port (models/whisper.py, whisper-medium)
vs the JAX package on its SMOKE config (f32: 2 encoder and 2 decoder
layers, d 64, 4 heads of D 16, 16 frames), same weights (JAX init ->
numpy -> bridge) and the same frames (numpy, seeded): LayerNorm and the
tanh GELU, ``encode`` and ``cross_kv``, ``forward`` with cross-attention
without a cache, warm and refine (BAOS off and on), greedy ``generate``
in cache modes none, dual and prefix, the slot engine at K = 1 (eager,
graphed and with breakdown), the refusal of the paged pool and the
megatick, and ``serve --arch whisper-medium``.

Tolerance: rtol 1e-5, atol 1e-5 on f32 values (the largest gap on these
inputs is about 2e-6); bf16 LayerNorm within one bf16 ulp of JAX's; MX
fake-quantized K/V within one grid step at a rounding edge
(test_torch_ssm.mx_close).  Greedy tokens are compared exactly: no
near-tie shows on these seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine
from test_torch_ssm import mx_close, serve_trace

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
ARCH = "whisper-medium"
B = 2


@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config(ARCH, smoke=True)
    cfg_t = tbase.get_config(ARCH, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


@pytest.fixture(scope="module")
def cross(models):
    """Both packages' cross_kv of the same seeded frames (B rows)."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    frames = np.random.RandomState(3).randn(
        B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32)
    ckv_j = model_j.cross_kv(params_j, model_j.encode(params_j,
                                                      jnp.asarray(frames)))
    ckv_t = model_t.cross_kv(params_t, model_t.encode(
        params_t, torch.from_numpy(frames)))
    return frames, ckv_j, ckv_t


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(smoke):
    """Every field and the parameter count; build_model builds the full
    config (family audio) with JAX's encoder config."""
    cfg_t = tbase.get_config(ARCH, smoke=smoke)
    cfg_j = jbase.get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(cfg_j):
        assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    assert cfg_t.param_count() == cfg_j.param_count()
    model_t, model_j = tbuild(cfg_t, "cpu"), jbuild(cfg_j)
    for f in dataclasses.fields(cfg_j):
        assert getattr(model_t.enc_cfg, f.name) == \
            getattr(model_j.enc_cfg, f.name), f.name
    assert not model_t.supports_head_mode
    assert tdiff.head_feed_mode(model_t, tdiff.DiffusionConfig()) == "logits"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    """layer_norm at cfg.norm_eps (1e-6) and the tanh GELU, on the same
    inputs: f32 within 1e-5, bf16 LayerNorm within one bf16 ulp."""
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 64) * 2 + 0.5).astype(np.float32)
    w = rs.randn(64).astype(np.float32)
    b = rs.randn(64).astype(np.float32)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.layer_norm(*(jnp.asarray(a).astype(jt) for a in (x, w, b)),
                              1e-6)
    got = tlayers.layer_norm(*(torch.from_numpy(a).to(tt) for a in (x, w, b)),
                             1e-6)
    assert got.dtype == tt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got, want)
        _close(tlayers.gelu(torch.from_numpy(x)), jax.nn.gelu(x))
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_encode_and_cross_kv_match(models, cross):
    """``encode`` (frames + pos_embed, the LN/GELU encoder without RoPE,
    the final LayerNorm) and the stacked per-layer cross K/V."""
    model_j, model_t, params_j, params_t = models
    frames, ckv_j, ckv_t = cross
    cfg = model_t.cfg
    _close(model_t.encode(params_t, torch.from_numpy(frames)),
           model_j.encode(params_j, jnp.asarray(frames)))
    for got, want in zip(ckv_t, ckv_j):
        assert got.shape == (cfg.n_layers, B, cfg.n_audio_ctx,
                             cfg.n_kv_heads, cfg.d_head)
        _close(got, want)


def test_forward_without_cache_matches(models, cross):
    """Full-sequence logits with cross-attention equal JAX's, and the
    cross-attention changes them (it is not skipped)."""
    model_j, model_t, params_j, params_t = models
    _, ckv_j, ckv_t = cross
    toks = _tokens(model_t.cfg, B, 24, seed=1)
    want, _, _ = model_j.forward(params_j, jnp.asarray(toks),
                                 cross_kv=ckv_j)
    got, cache = model_t.forward(params_t, torch.from_numpy(toks),
                                 cross_kv=ckv_t)
    assert cache is None
    _close(got, want)
    bare, _ = model_t.forward(params_t, torch.from_numpy(toks))
    assert float((bare - got).abs().max()) > 1e-3


@pytest.mark.parametrize("kv_format", [None, "mxint8", "mxint4"])
def test_warm_then_refine_matches(models, cross, kv_format):
    """A warm step (calibrate, logits_slice at block start 16) writes the
    cache as JAX's returns it, BAOS off and on; a refine step over the
    block [16:24) from that cache gives JAX's logits and cache."""
    model_j, model_t, params_j, params_t = models
    _, ckv_j, ckv_t = cross
    S, bs, L = 32, 16, 8
    toks = _tokens(model_t.cfg, B, S, seed=2)
    on = kv_format is not None
    bj = jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    bt = tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    lj, cj, _ = model_j.forward(params_j, jnp.asarray(toks),
                                cache=model_j.init_cache(B, S),
                                calibrate=True, baos_cfg=bj,
                                logits_slice=(jnp.int32(bs), L),
                                cross_kv=ckv_j)
    ct = model_t.init_cache(B, S)
    lt, _ = model_t.forward(params_t, torch.from_numpy(toks), cache=ct,
                            calibrate=True, baos_cfg=bt,
                            logits_slice=(bs, L), cross_kv=ckv_t)
    _close(lt, lj)
    for name in ("k", "v"):
        (mx_close if on else _close)(ct[name], cj[name],
                                     *([kv_format] if on else []))
    if on:
        for name in ("k_center", "k_scale", "v_center", "v_scale"):
            _close(ct[name], cj[name])
    seg = toks[:, bs:bs + L]
    rj, cj2, _ = model_j.forward(params_j, jnp.asarray(seg), cache=cj,
                                 seg_start=jnp.int32(bs), baos_cfg=bj,
                                 logits_slice=(0, L), cross_kv=ckv_j)
    rt, _ = model_t.forward(params_t, torch.from_numpy(seg), cache=ct,
                            seg_start=bs, baos_cfg=bt, logits_slice=(0, L),
                            cross_kv=ckv_t)
    _close(rt, rj)
    for name in ("k", "v"):
        (mx_close if on else _close)(ct[name], cj2[name],
                                     *([kv_format] if on else []))


@pytest.mark.parametrize("cache_mode,jit_steps", [
    ("none", True), ("dual", True), ("prefix", True), ("prefix", False)])
def test_generate_greedy_tokens_match(models, cross, cache_mode, jit_steps):
    """Greedy tokens of generate(cross_kv=...) equal JAX's: B 2, prompt
    16, gen 32, block 8, 4 steps; the cached modes with BAOS mxint4."""
    model_j, model_t, params_j, params_t = models
    _, ckv_j, ckv_t = cross
    on = cache_mode != "none"
    kw = dict(gen_length=32, block_length=8, steps_per_block=4,
              cache_mode=cache_mode)
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint4"),
                               **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint4"),
                               **kw)
    prompt = _tokens(model_t.cfg, B, 16, seed=5)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(11), cross_kv=ckv_j)
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11, jit_steps=jit_steps, cross_kv=ckv_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())
    tdiff.clear_step_graphs()


def _trace(vocab):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab - 2, size=(n,)).astype(np.int32), g)
            for n, g in ((12, 16), (8, 8), (10, 16))]


@pytest.mark.parametrize("mode,variant", [
    ("warm", "eager"), ("warm", "graphed"), ("none", "graphed"),
    ("warm", "breakdown")])
def test_slot_engine_matches_jax_engine(models, cross, mode, variant):
    """The slot engine at K = 1 with EngineConfig(fwd_kw={'cross_kv':
    ...}) (two slots: cross_kv's batch) against JAX's engine with the same
    fwd_kw: final tokens, per-request ticks, every CommitEvent and the
    tick count; eager, graphed (jit_steps, which on the CPU runs the same
    code) and with breakdown (BAOS mxint4 on the warm path)."""
    model_j, model_t, params_j, params_t = models
    _, ckv_j, ckv_t = cross
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    baos = mode == "warm"
    dj = jdiff.DiffusionConfig(cache_mode="none", baos=jbaos.BAOSConfig(
        enabled=baos, kv_format="mxint4"), **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(
        enabled=baos, kv_format="mxint4"), **kw)
    base = dict(num_slots=B, max_seq_len=32, mode=mode)
    trace = _trace(model_t.cfg.vocab)
    got = serve_trace(ServingEngine(model_t, params_t, dt, EngineConfig(
        seed=0, jit_steps=variant != "eager",
        breakdown=variant == "breakdown", fwd_kw={"cross_kv": ckv_t},
        **base)), Request, trace)
    want = serve_trace(JEngine(model_j, params_j, dj, JEngineConfig(
        rng=jax.random.PRNGKey(0), fwd_kw={"cross_kv": ckv_j}, **base)),
        JRequest, trace)
    assert got == want
    for toks in got[0].values():
        assert model_t.cfg.mask_id not in toks


def test_paged_pool_and_megatick_refuse_forward_kwargs(models, cross):
    """As in JAX, the paged pool and the megatick raise ValueError for
    forward kwargs other than quant, and so does generate(megatick_k>1)."""
    model_j, model_t, params_j, params_t = models
    _, ckv_j, ckv_t = cross
    dt, dj = tdiff.DiffusionConfig(), jdiff.DiffusionConfig()
    for kw in (dict(pool="paged"), dict(megatick_k=4)):
        with pytest.raises(ValueError, match="forward kwargs"):
            ServingEngine(model_t, params_t, dt, EngineConfig(
                num_slots=B, fwd_kw={"cross_kv": ckv_t}, **kw))
        with pytest.raises(ValueError, match="forward kwargs"):
            JEngine(model_j, params_j, dj, JEngineConfig(
                num_slots=B, fwd_kw={"cross_kv": ckv_j}, **kw))
    with pytest.raises(ValueError, match="forward kwargs"):
        tdiff.generate(model_t, params_t,
                       torch.zeros((B, 8), dtype=torch.int32),
                       tdiff.DiffusionConfig(gen_length=8, block_length=8),
                       megatick_k=4, cross_kv=ckv_t)


def test_bridge_and_own_init_share_the_layout(models):
    """The port's seeded init gives the bridged tree's keys, shapes and
    dtypes: the decoder with ln_x/xattn and LayerNorm dicts, the encoder's
    layers, pos_embed and final_norm."""
    _, model_t, _, params_t = models

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    assert layout(model_t.init(seed=1)) == layout(params_t)
    assert set(params_t["layers"][0]["ln_x"]) == {"w", "b"}
    assert set(params_t["layers"][0]) >= {"w_in", "b_in", "w_out", "b_out",
                                          "xattn"}


def test_serve_fwd_kw_and_command(models, capsys):
    """serve's audio branch on JAX's frames (jax.random.normal(PRNGKey(1)))
    equals JAX's ``_fwd_kw``; ``python -m repro_torch.launch.serve --arch
    whisper-medium --device cpu`` runs the engine path (with breakdown) and
    the legacy path (dual + BAOS)."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    frames = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (B, cfg.n_audio_ctx, cfg.d_model)))
    want = jserve._fwd_kw(model_j.cfg, model_j, params_j, B)["cross_kv"]
    got = serve._fwd_kw(cfg, model_t, params_t, B, frames)["cross_kv"]
    for a, b in zip(got, want):
        _close(a, b)
    assert serve._fwd_kw(tbase.get_config("qwen2-0.5b", smoke=True), None,
                         None, B) == {}
    small = ["--device", "cpu", "--arch", ARCH, "--smoke", "--batch", "2",
             "--prompt-len", "16", "--gen-len", "16", "--block-len", "8",
             "--steps", "4", "--requests", "2"]
    serve.main(small + ["--breakdown"])
    out = capsys.readouterr().out
    assert "engine: slots=2" in out and "sampling:" in out
    serve.main(small + ["--legacy"])
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and "cache=dual" in out
