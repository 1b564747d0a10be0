"""The serving tick and greedy generate() of the PyTorch port vs the JAX
package, both SMOKE configs, same weights (JAX init -> numpy -> bridge).

Greedy tokens must be equal.  The rule allows a difference only at a
near-tie (the reference's top-2 gap < 1e-5); these seeds have none, so
the checks are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
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


def test_unported_modes_raise(models):
    _, model_t, _, params_t = models
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    for kw in (dict(cache_mode="dual"), dict(cache_mode="prefix"),
               dict(head_path="unfused"), dict(head_path="legacy"),
               dict(baos_enabled=True)):
        dcfg = tdiff.DiffusionConfig(gen_length=8, block_length=8, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdiff.generate(model_t, params_t, prompt, dcfg)
