"""The serving tick and greedy generate() of the PyTorch port vs the JAX
package, both SMOKE configs, same weights (JAX init -> numpy -> bridge):
cache modes none, dual and prefix, BAOS off and on, head paths fused,
unfused and legacy, and a refine step started from a JAX cache.

Greedy tokens must be equal.  The rule allows a difference only at a
near-tie (the reference's top-2 gap < 1e-5, or with BAOS on one
quantization step's effect, ~1e-3); these seeds have none, so the checks
are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.core import sampling as jsampling
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsampling
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

ARCHS = ["llada-8b", "qwen2-0.5b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jbase.get_config(request.param, smoke=True)
    cfg_t = tbase.get_config(request.param, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _dcfgs(**kw):
    return jdiff.DiffusionConfig(cache_mode="none", **kw), \
        tdiff.DiffusionConfig(**kw)


@pytest.mark.parametrize("warm", [False, True])
def test_batched_tick_matches(models, warm):
    """Three slots at different block offsets and k (one idle: k = 0 and a
    one-key mask), partly committed canvases."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    dj, dt = _dcfgs(gen_length=16, block_length=8, steps_per_block=4)
    B, S, mid = 3, 40, cfg.mask_id
    rs = np.random.RandomState(4)
    x = rs.randint(0, cfg.vocab - 2, size=(B, S)).astype(np.int32)
    x[0, 16:32] = mid
    x[1, 12:] = mid
    x[1, 13] = 5
    lens = np.array([32, 36, 1])
    valid = np.arange(S)[None, :] < lens[:, None]
    bs = np.array([16, 12, 0], np.int32)
    k = np.array([2, 3, 0], np.int32)
    cache_j = model_j.init_cache(B, S) if warm else None
    cache_t = model_t.init_cache(B, S) if warm else None
    xj, _, cmin_j, left_j = jdiff.batched_tick(
        model_j, params_j, jnp.asarray(x), jnp.asarray(valid),
        jnp.asarray(bs), jnp.asarray(k), jax.random.PRNGKey(1), cache_j,
        dcfg=dj, mask_id=mid)
    xt, _, cmin_t, left_t = tdiff.batched_tick(
        model_t, params_t, torch.from_numpy(x), torch.from_numpy(valid),
        torch.from_numpy(bs), torch.from_numpy(k), 0, cache_t, dt, mid)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(left_t.numpy(), np.asarray(left_j))
    np.testing.assert_allclose(cmin_t.numpy(), np.asarray(cmin_j),
                               rtol=1e-5)
    assert np.isinf(cmin_t[2].item())


def test_generate_greedy_tokens_match(models):
    model_j, model_t, params_j, params_t = models
    dj, dt = _dcfgs(gen_length=16, block_length=8, steps_per_block=4)
    prompt = np.random.RandomState(5).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())


def test_state_machine_is_resumable(models):
    _, model_t, _, params_t = models
    _, dt = _dcfgs(gen_length=16, block_length=8, steps_per_block=4)
    prompt = torch.arange(10, dtype=torch.int32)[None]
    s = tdiff.init_state(model_t, prompt, dt, seed=2)
    seen = []
    while not s.done:
        seen.append((s.block_idx, s.step_in_block))
        s = tdiff.step(model_t, params_t, s)
    assert seen == [(b, t) for b in range(2) for t in range(4)]
    torch.testing.assert_close(
        s.x, tdiff.generate(model_t, params_t, prompt, dt, seed=2))
    with pytest.raises(ValueError):
        tdiff.step(model_t, params_t, s)


def _baos(kv_format):
    """(JAX, port) BAOSConfig: off for None, else minmax with kv_format."""
    on = kv_format is not None
    kw = dict(enabled=on, kv_format=kv_format or "mxint4")
    return jbaos.BAOSConfig(**kw), tbaos.BAOSConfig(**kw)


def _generate_both(models, cache_mode, prompt_seed=5, **kw):
    model_j, model_t, params_j, params_t = models
    prompt = np.random.RandomState(prompt_seed).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    kw = dict(gen_length=16, block_length=8, steps_per_block=4, **kw)
    baos = kw.pop("baos", (jbaos.BAOSConfig(enabled=False),
                           tbaos.BAOSConfig(enabled=False)))
    dj = jdiff.DiffusionConfig(cache_mode=cache_mode, baos=baos[0], **kw)
    dt = tdiff.DiffusionConfig(cache_mode=cache_mode, baos=baos[1], **kw)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kv_format", [None, "mxint8", "mxint4"])
@pytest.mark.parametrize("cache_mode", ["dual", "prefix"])
def test_generate_cached_modes_match(models, cache_mode, kv_format):
    """Warm step at each block's start (calibrating, with BAOS on, and
    writing the smoothed MX cache), then refine steps over the block
    (dual) or block + suffix (prefix)."""
    got, want = _generate_both(models, cache_mode, baos=_baos(kv_format))
    np.testing.assert_array_equal(got, want)
    assert not (got == models[1].cfg.mask_id).any()


@pytest.mark.parametrize("head_path", ["unfused", "legacy"])
@pytest.mark.parametrize("cache_mode", ["none", "dual"])
def test_generate_head_paths_match(models, cache_mode, head_path):
    """Stable-Max over stored logits: the head applied to the active
    block's hidden states (unfused) or full-sequence logits out of the
    forward (legacy).  Greedy tokens equal JAX's (and so the fused path's,
    which the tests above hold to JAX on the same prompt)."""
    got, want = _generate_both(models, cache_mode, head_path=head_path)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cache_mode", ["dual", "prefix"])
def test_refine_step_from_a_jax_cache(models, cache_mode):
    """JAX takes the warm step of block 0 (BAOS mxint4); the port's refine
    step then starts from that very cache (bridge.cache_from_numpy).  The
    refine feats, the cache it writes and the tokens it commits match
    JAX's refine step from the same state."""
    model_j, model_t, params_j, params_t = models
    bj, bt = _baos("mxint4")
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    dj = jdiff.DiffusionConfig(cache_mode=cache_mode, baos=bj, **kw)
    dt = tdiff.DiffusionConfig(cache_mode=cache_mode, baos=bt, **kw)
    prompt = np.random.RandomState(6).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    sj = jdiff.init_state(model_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(0))
    sj = jdiff.step(model_j, params_j, sj)                  # the warm step
    cache_t = bridge.cache_from_numpy(jax.tree.map(np.asarray, sj.cache),
                                      model_t.cfg, "cpu")
    st = tdiff.init_state(model_t, torch.from_numpy(prompt), dt)
    st = tdiff.DiffusionState(
        x=torch.from_numpy(np.asarray(sj.x)), ks=st.ks, dcfg=dt,
        mask_id=st.mask_id, prompt_len=12, cache=cache_t, ticks=1,
        step_in_block=1)
    suffix = 28 - 20 if cache_mode == "prefix" else 0
    want, cache_j = jdiff.refine_step(model_j, params_j, sj.x, sj.cache,
                                      jnp.int32(12), dj, suffix_len=suffix,
                                      head_mode="hidden")
    got = tdiff.step_forward(model_t, params_t, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for name in ("k", "v"):
        diff = np.abs(cache_t[name].numpy() - np.asarray(cache_j[name]))
        assert (diff > 0).mean() <= 1e-3 and diff.max() <= 0.25, name
    sj = jdiff.step(model_j, params_j, sj)
    np.testing.assert_array_equal(tdiff.step(model_t, params_t, st).x.numpy(),
                                  np.asarray(sj.x))


def test_unported_modes_raise(models):
    """The random transfer strategy and every sampling format now run:
    generate in modes none and dual + BAOS and the engine (warm, eager)
    finish with no mask id left.  The megatick over a mesh runs (tests/
    test_torch_spmd.py); given something that is no mesh it raises JAX's
    ValueError for missing mesh axes."""
    _, model_t, _, params_t = models
    mid = model_t.cfg.mask_id
    prompt = torch.arange(3, 11, dtype=torch.int32)[None]
    for sampling in (tsampling.SamplingConfig(strategy="random"),
                     tsampling.SamplingConfig(fmt="mxint8"),
                     tsampling.SamplingConfig(fmt="fp4", strategy="random",
                                              temperature=0.8)):
        for kw in (dict(), dict(cache_mode="dual",
                                baos=tbaos.BAOSConfig(kv_format="mxint4"))):
            dcfg = tdiff.DiffusionConfig(gen_length=16, block_length=8,
                                         steps_per_block=4,
                                         sampling=sampling, **kw)
            out = tdiff.generate(model_t, params_t, prompt, dcfg, seed=3)
            assert out.shape == (1, 24) and not bool((out == mid).any())
        eng = ServingEngine(model_t, params_t, dcfg,
                            EngineConfig(num_slots=2, max_seq_len=32,
                                         mode="warm"))
        done = eng.run([Request(prompt=np.arange(3, 11, dtype=np.int32),
                                gen_length=16)])
        assert not bool((done[0].tokens == mid).any())
    with pytest.raises(ValueError, match="mesh axes"):
        ServingEngine(model_t, params_t, tdiff.DiffusionConfig(),
                      EngineConfig(megatick_k=2, mesh=object()))


@pytest.mark.parametrize("fmt", ["mxint4", "mxfp6_e3m2"])
@pytest.mark.parametrize("strategy", ["stablemax", "random"])
def test_one_slot_engine_equals_generate(models, strategy, fmt):
    """generate(cache_mode='none') and a one-slot mode-none engine on a
    canvas of the request's length run the same ticks: equal tokens
    under either strategy and a format new to the port's kernels (the
    random draw comes from the same tick seed stream)."""
    _, model_t, _, params_t = models
    dcfg = tdiff.DiffusionConfig(
        gen_length=16, block_length=8, steps_per_block=4,
        sampling=tsampling.SamplingConfig(fmt=fmt, strategy=strategy))
    prompt = np.arange(3, 19, dtype=np.int32)
    ref = tdiff.generate(model_t, params_t, torch.from_numpy(prompt)[None],
                         dcfg, seed=9)
    eng = ServingEngine(model_t, params_t, dcfg,
                        EngineConfig(num_slots=1, max_seq_len=32,
                                     mode="none", seed=9))
    done = eng.run([Request(prompt=prompt, gen_length=16)])
    np.testing.assert_array_equal(done[0].tokens, ref[0].numpy())
    if strategy == "random":
        greedy = tdiff.generate(
            model_t, params_t, torch.from_numpy(prompt)[None],
            dataclasses.replace(dcfg, sampling=tsampling.SamplingConfig(
                fmt=fmt)), seed=9)
        assert not torch.equal(greedy, ref)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4", "mxfp6_e3m2",
                                 "mxfp4_e2m1"])
def test_generate_every_format_matches_jax(models, fmt):
    """Greedy generate in a sampling format new to the port's kernels,
    mode none and dual + BAOS (mxint4 KV), against JAX: equal tokens."""
    model_j, model_t, params_j, params_t = models
    prompt = np.random.RandomState(5).randint(
        0, model_t.cfg.vocab - 2, size=(2, 12)).astype(np.int32)
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    for cache_mode, baos in (("none", _baos(None)), ("dual",
                                                     _baos("mxint4"))):
        dj = jdiff.DiffusionConfig(
            cache_mode=cache_mode, baos=baos[0],
            sampling=jsampling.SamplingConfig(fmt=fmt), **kw)
        dt = tdiff.DiffusionConfig(
            cache_mode=cache_mode, baos=baos[1],
            sampling=tsampling.SamplingConfig(fmt=fmt), **kw)
        want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                              rng=jax.random.PRNGKey(11))
        got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt),
                             dt, seed=11)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
