"""step()/generate() with ``jit_steps`` (the port's CUDA graphs of each
step, JAX's jitted steps) vs the JAX package, on the CPU where the graphed
steps run eagerly on the same static buffers: greedy tokens in cache modes
none, dual and prefix (BAOS off and on), stepped and through generate(),
equal to JAX's and to the port's eager steps; a second generate() of the
same shapes reuses its step entry (its buffers and cache), and the shared
megatick is one object across calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.models.registry import build_model as tbuild

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


def _dcfgs(cache_mode, kv_format=None):
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    on = kv_format is not None
    dj = jdiff.DiffusionConfig(cache_mode=cache_mode, baos=jbaos.BAOSConfig(
        enabled=on, kv_format=kv_format or "mxint4"), **kw)
    dt = tdiff.DiffusionConfig(cache_mode=cache_mode, baos=tbaos.BAOSConfig(
        enabled=on, kv_format=kv_format or "mxint4"), **kw)
    return dj, dt


def _prompt(cfg, B, P, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, P)).astype(np.int32)


@pytest.mark.parametrize("cache_mode,kv_format", [
    ("none", None), ("dual", None), ("prefix", None), ("dual", "mxint4"),
    ("prefix", "mxint4")])
def test_stepped_graphed_steps_match_jax(models, cache_mode, kv_format):
    """step(jit_steps=True) from init_state, step by step, against JAX's
    jitted step: the canvas after every step is equal, and so is the
    port's eager step's (BAOS on in the cached modes, where it applies)."""
    model_j, model_t, params_j, params_t = models
    dj, dt = _dcfgs(cache_mode, kv_format)
    prompt = _prompt(model_t.cfg, 2, 12, seed=21)
    sj = jdiff.init_state(model_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(3))
    sg = tdiff.init_state(model_t, torch.from_numpy(prompt), dt, seed=3)
    se = tdiff.init_state(model_t, torch.from_numpy(prompt), dt, seed=3)
    while not sj.done:
        sj = jdiff.step(model_j, params_j, sj, jit_steps=True)
        sg = tdiff.step(model_t, params_t, sg, jit_steps=True)
        se = tdiff.step(model_t, params_t, se, jit_steps=False)
        np.testing.assert_array_equal(sg.x.numpy(), np.asarray(sj.x))
        np.testing.assert_array_equal(se.x.numpy(), sg.x.numpy())
    assert sg.done and se.done


@pytest.mark.parametrize("cache_mode", ["none", "dual", "prefix"])
def test_generate_reuses_its_step_entry(models, cache_mode):
    """generate(jit_steps=True) twice with the same shapes: JAX's greedy
    tokens both times (two prompts), one step entry (its canvas, cache and
    graphed steps) serving both calls; on the CPU nothing is captured."""
    model_j, model_t, params_j, params_t = models
    dj, dt = _dcfgs(cache_mode)
    cfg = model_t.cfg
    tdiff.clear_step_graphs()
    entries = []
    for seed in (5, 6):
        prompt = _prompt(cfg, 2, 12, seed=seed)
        want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                              rng=jax.random.PRNGKey(seed))
        got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                             seed=seed, jit_steps=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(tdiff._STEP_GRAPHS) == 1
        entries.append(next(iter(tdiff._STEP_GRAPHS.values())))
    g = entries[0]
    assert entries[1] is g
    assert g.captures == 0
    if cache_mode != "none":
        assert g.cache is not None
    # the entry's buffers are its own: the returned canvas is a copy
    assert got.data_ptr() != g.x.data_ptr()
    tdiff.clear_step_graphs()
    assert not tdiff._STEP_GRAPHS


def test_prefix_mode_keys_one_refine_step_per_suffix(models):
    """Prefix mode's suffix shrinks block by block: one refine step per
    suffix length (as JAX re-jits per suffix), one warm step, one commit;
    dual mode has one refine step for every block."""
    _, model_t, _, params_t = models
    prompt = torch.from_numpy(_prompt(model_t.cfg, 1, 10, seed=2))
    tdiff.clear_step_graphs()
    kinds = {}
    for mode in ("dual", "prefix"):
        dcfg = tdiff.DiffusionConfig(gen_length=24, block_length=8,
                                     steps_per_block=2, cache_mode=mode)
        tdiff.generate(model_t, params_t, prompt, dcfg, jit_steps=True)
        g = tdiff.step_graphs(model_t, dcfg, model_t.cfg.mask_id, None, 1, 34)
        kinds[mode] = sorted(g._steps)
    assert kinds["dual"] == [("commit", 0), ("refine", 0), ("warm", 0)]
    assert kinds["prefix"] == [("commit", 0), ("refine", 0), ("refine", 8),
                               ("refine", 16), ("warm", 0)]
    tdiff.clear_step_graphs()


def test_megatick_is_shared_across_generate_calls(models):
    """get_megatick_fn returns one Megatick per arguments (JAX's
    lru_cache), and generate(megatick_k) runs on its static canvas: two
    calls give the K=1 path's tokens, on one Megatick."""
    _, model_t, _, params_t = models
    dcfg = tdiff.DiffusionConfig(gen_length=16, block_length=8,
                                 steps_per_block=4)
    mid = model_t.cfg.mask_id
    tdiff.clear_step_graphs()
    fn = tdiff.get_megatick_fn(model_t, dcfg, mid, 4)
    assert tdiff.get_megatick_fn(model_t, dcfg, mid, 4) is fn
    for seed in (1, 2):
        prompt = torch.from_numpy(_prompt(model_t.cfg, 2, 12, seed=seed))
        k1 = tdiff.generate(model_t, params_t, prompt, dcfg, seed=seed)
        k4 = tdiff.generate(model_t, params_t, prompt, dcfg, seed=seed,
                            megatick_k=4)
        assert torch.equal(k1, k4)
    assert tdiff.get_megatick_fn(model_t, dcfg, mid, 4) is fn
    assert fn.ticks_run == 2 * 8
    tdiff.clear_step_graphs()


def test_unknown_forward_kwargs_raise(models):
    _, model_t, _, params_t = models
    dcfg = tdiff.DiffusionConfig(gen_length=8, block_length=8)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="forward kwargs"):
        tdiff.generate(model_t, params_t, prompt, dcfg, remat="full")
