"""The vlm family of the PyTorch port (models/vlm.py, internvl2-26b) vs the
JAX package on its SMOKE config (f32: 2 layers, d 64, GQA 4 on 2 of D 16,
8 image tokens), same weights (JAX init -> numpy -> bridge) and the same
image embeddings (numpy, seeded): the image splice on a full pass and its
shape rule, warm and refine (BAOS off and on) with a prefix-mode segment
long enough to be spliced, greedy ``generate`` with ``image_embeds`` in
cache modes none, dual and prefix, the engine text-only (slot and paged
pools at K 1 and 4, as JAX's serve runs it) and with ``image_embeds``
(slot, K 1), the refusal of the paged pool and the megatick, and
``serve --arch internvl2-26b``.

Tolerance: rtol 1e-5, atol 1e-5 on f32 values (the largest gap on these
inputs is about 3e-6); MX fake-quantized K/V within one grid step at a
rounding edge (test_torch_ssm.mx_close).  Greedy tokens are compared
exactly: no near-tie shows on these seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.launch import serve
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine
from test_torch_ssm import engine_matches_jax, mx_close, serve_trace

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
ARCH = "internvl2-26b"
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
def image(models):
    cfg = models[1].cfg
    im = np.random.RandomState(3).randn(
        B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)
    return jnp.asarray(im), torch.from_numpy(im)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(smoke):
    """Every field and the parameter count; build_model builds the full
    config (family vlm), without head_mode as in JAX."""
    cfg_t = tbase.get_config(ARCH, smoke=smoke)
    cfg_j = jbase.get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(cfg_j):
        assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    assert cfg_t.param_count() == cfg_j.param_count()
    model = tbuild(cfg_t, "cpu")
    assert model.cfg is cfg_t and not model.supports_head_mode
    assert tdiff.head_feed_mode(model, tdiff.DiffusionConfig()) == "logits"


@pytest.mark.parametrize("S", [4, 8, 24])
def test_splice_on_a_full_pass(models, image, S):
    """A pass of S >= n_image_tokens (8) positions takes the image over
    its first 8 embeddings, equal to JAX's and to forward(embeds=...) of
    the spliced embeddings; a shorter pass is not spliced."""
    model_j, model_t, params_j, params_t = models
    im_j, im_t = image
    toks = _tokens(model_t.cfg, B, S, seed=1)
    want, _, _ = model_j.forward(params_j, jnp.asarray(toks),
                                 image_embeds=im_j)
    got, _ = model_t.forward(params_t, torch.from_numpy(toks),
                             image_embeds=im_t)
    _close(got, want)
    plain, _ = model_t.forward(params_t, torch.from_numpy(toks))
    n = model_t.cfg.n_image_tokens
    if S < n:
        assert torch.equal(got, plain)
        return
    emb = ttr.embed(params_t, model_t.cfg, torch.from_numpy(toks))
    emb[:, :n] = im_t
    by_embeds, _ = ttr.forward(params_t, model_t.cfg, embeds=emb)
    assert torch.equal(got, by_embeds)
    assert float((got - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("kv_format", [None, "mxint4"])
def test_warm_then_prefix_refine_is_spliced(models, image, kv_format):
    """A warm step over 32 positions (spliced) and a prefix-mode refine
    segment [16:32) (16 >= n_image_tokens, so spliced too, as in JAX,
    though it does not start at 0) give JAX's logits and cache, BAOS off
    and on; the segment's logits differ from an unspliced refine."""
    model_j, model_t, params_j, params_t = models
    im_j, im_t = image
    S, bs, L = 32, 16, 8
    toks = _tokens(model_t.cfg, B, S, seed=2)
    on = kv_format is not None
    bj = jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    bt = tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    lj, cj, _ = model_j.forward(params_j, jnp.asarray(toks),
                                cache=model_j.init_cache(B, S),
                                calibrate=True, baos_cfg=bj,
                                logits_slice=(jnp.int32(bs), L),
                                image_embeds=im_j)
    ct = model_t.init_cache(B, S)
    lt, _ = model_t.forward(params_t, torch.from_numpy(toks), cache=ct,
                            calibrate=True, baos_cfg=bt,
                            logits_slice=(bs, L), image_embeds=im_t)
    _close(lt, lj)
    check = (lambda a, b: mx_close(a, b, kv_format)) if on else _close
    for name in ("k", "v"):
        check(ct[name], cj[name])
    unspliced = {k: v.clone() for k, v in ct.items()}
    seg = toks[:, bs:]
    rj, cj2, _ = model_j.forward(params_j, jnp.asarray(seg), cache=cj,
                                 seg_start=jnp.int32(bs), baos_cfg=bj,
                                 logits_slice=(0, L), image_embeds=im_j)
    rt, _ = model_t.forward(params_t, torch.from_numpy(seg), cache=ct,
                            seg_start=bs, baos_cfg=bt, logits_slice=(0, L),
                            image_embeds=im_t)
    _close(rt, rj)
    for name in ("k", "v"):
        check(ct[name], cj2[name])
    ru, _ = model_t.forward(params_t, torch.from_numpy(seg),
                            cache=unspliced, seg_start=bs, baos_cfg=bt,
                            logits_slice=(0, L))
    assert float((ru - rt).abs().max()) > 1e-3


@pytest.mark.parametrize("cache_mode,jit_steps", [
    ("none", True), ("dual", True), ("prefix", True), ("dual", False)])
def test_generate_greedy_tokens_match(models, image, cache_mode, jit_steps):
    """Greedy tokens of generate(image_embeds=...) equal JAX's: B 2,
    prompt 16 (8 image positions + 8 text), gen 32, block 8, 4 steps;
    the cached modes with BAOS mxint4 (prefix mode splices its refine
    segments of 8 positions or more, as JAX does)."""
    model_j, model_t, params_j, params_t = models
    im_j, im_t = image
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
                          rng=jax.random.PRNGKey(11), image_embeds=im_j)
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11, jit_steps=jit_steps, image_embeds=im_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())
    plain = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                           seed=11, jit_steps=jit_steps)
    assert not torch.equal(plain, got)
    tdiff.clear_step_graphs()


@pytest.mark.parametrize("pool,megatick_k,mode,baos", [
    ("slot", 1, "warm", dict(kv_format="mxint4")), ("slot", 4, "none", None),
    ("paged", 1, "warm", None), ("paged", 4, "warm",
                                 dict(kv_format="mxint4"))],
    ids=["slot-K1-warm+baos", "slot-K4-none", "paged-K1-warm",
         "paged-K4-warm+baos"])
def test_text_only_engine_matches_jax_engine(models, pool, megatick_k, mode,
                                             baos):
    """The engine text-only, as JAX's serve runs internvl2-26b: final
    tokens, per-request ticks, every CommitEvent and the tick count equal
    JAX's engine, and the paged runs equal the slot pool's."""
    engine_matches_jax(models, mode, baos, megatick_k, pool)


def test_engine_with_image_matches_jax_engine(models, image):
    """The slot engine at K = 1 with EngineConfig(fwd_kw={'image_embeds':
    ...}) (canvas 32: every warm tick spliced) equals JAX's engine with the
    same fwd_kw; the paged pool and the megatick refuse it, in both
    packages."""
    model_j, model_t, params_j, params_t = models
    im_j, im_t = image
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    dj = jdiff.DiffusionConfig(cache_mode="none", **kw)
    dt = tdiff.DiffusionConfig(**kw)
    base = dict(num_slots=B, max_seq_len=32, mode="warm")
    rs = np.random.RandomState(0)
    trace = [(rs.randint(0, model_t.cfg.vocab - 2, size=(n,)).astype(
        np.int32), g) for n, g in ((12, 16), (10, 8), (9, 16))]
    got = serve_trace(ServingEngine(model_t, params_t, dt, EngineConfig(
        seed=0, fwd_kw={"image_embeds": im_t}, **base)), Request, trace)
    want = serve_trace(JEngine(model_j, params_j, dj, JEngineConfig(
        rng=jax.random.PRNGKey(0), fwd_kw={"image_embeds": im_j}, **base)),
        JRequest, trace)
    assert got == want
    for kw in (dict(pool="paged"), dict(megatick_k=4)):
        with pytest.raises(ValueError, match="forward kwargs"):
            ServingEngine(model_t, params_t, dt, EngineConfig(
                fwd_kw={"image_embeds": im_t}, **base, **kw))
        with pytest.raises(ValueError, match="forward kwargs"):
            JEngine(model_j, params_j, dj, JEngineConfig(
                fwd_kw={"image_embeds": im_j}, **base, **kw))


def test_serve_command_on_internvl2(capsys):
    """``python -m repro_torch.launch.serve --arch internvl2-26b --device
    cpu`` serves text only, as JAX's does: the engine path (drift armed)
    and the legacy path (dual + BAOS)."""
    small = ["--device", "cpu", "--arch", ARCH, "--smoke", "--batch", "2",
             "--prompt-len", "16", "--gen-len", "16", "--block-len", "8",
             "--steps", "4", "--requests", "2"]
    assert serve._fwd_kw(tbase.get_config(ARCH, smoke=True), None, None,
                         2) == {}
    serve.main(small)
    out = capsys.readouterr().out
    assert "engine: slots=2" in out and "drift" in out
    serve.main(small + ["--legacy"])
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and "cache=dual" in out
