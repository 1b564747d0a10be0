"""The port's optimizer (optim/adamw.py) and data pipeline
(data/pipeline.py) against the JAX package's, on the CPU: AdamW on the
same gradients and state, the three schedules' learning rate, clipping,
the quadratic minimisation; three full train steps on qwen2-0.5b's smoke
config (loss, every gradient, AdamW) against JAX's; the synthetic corpus
bit for bit, the prefetcher, the motif pool's shape and period.

Tolerances (f32): AdamW's parameters and moments rtol 1e-5, atol 1e-7
after one update on the same inputs, and the schedules' lr exactly (both
compute them in f32 the same way); the train steps' losses rtol 1e-4,
atol 1e-6, the parameters after three steps rtol 1e-4, atol 1e-3 x lr:
an element whose gradient is small against its rounding (qwen2's key
bias, which RoPE alone keeps from cancelling in the softmax) moves up to
lr a step in the direction of m / sqrt(v), a ratio that carries that
rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.data import pipeline as jpipe
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.data import pipeline as tpipe
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _topt(opt):
    return tadamw.OptConfig(**{f: getattr(opt, f)
                               for f in opt.__dataclass_fields__})


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
def test_schedule_lr_matches_jax(schedule):
    opt = jadamw.OptConfig(lr=3e-4, schedule=schedule, warmup_steps=7,
                           stable_steps=13, decay_steps=9, min_lr_ratio=0.1)
    for step in (0, 1, 3, 7, 8, 15, 20, 21, 25, 29, 30, 40):
        want = float(jadamw.schedule_lr(jnp.int32(step), opt))
        got = tadamw.schedule_lr(step, _topt(opt))
        assert got.dtype == torch.float32
        assert float(got) == want, (schedule, step)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    """One update from a non-zero state (step 4), clipping active, on a
    tree of dicts and lists; bf16 parameters round back to bf16."""
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4)}}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def tree(scale):
        return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))

    p_np, g_np = tree(1.0), tree(3.0)
    m_np, v_np = tree(0.1), jax.tree.map(np.abs, tree(0.1))
    opt = jadamw.OptConfig(lr=1e-2, schedule="cosine", warmup_steps=2,
                           stable_steps=3, decay_steps=4, clip_norm=1.0)
    params_j = jax.tree.map(lambda x: jnp.asarray(x, jdt), p_np)
    state_j = {"m": jax.tree.map(jnp.asarray, m_np),
               "v": jax.tree.map(jnp.asarray, v_np), "step": jnp.int32(4)}
    new_j, st_j, stats_j = jadamw.apply_updates(
        params_j, jax.tree.map(jnp.asarray, g_np), state_j, opt)

    def t(x, dt=torch.float32):
        return tree_lib.tree_map(
            lambda a: torch.from_numpy(np.array(a)).to(dt), x)

    params_t = t(p_np, tdt)
    state_t = {"m": t(m_np), "v": t(v_np), "step": 4}
    out, st_t, stats_t = tadamw.apply_updates(params_t, t(g_np), state_t,
                                              _topt(opt))
    assert out is params_t and st_t is state_t       # in place
    assert st_t["step"] == 5
    assert float(stats_t["lr"]) == float(stats_j["lr"])
    _close(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]), 1e-6)
    assert float(stats_t["grad_norm"]) > 1.0         # clipping was active
    for got, want in ((params_t, new_j), (st_t["m"], st_j["m"]),
                      (st_t["v"], st_j["v"])):
        for a, b in zip(tree_lib.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == (tdt if got is params_t else torch.float32)
            _close(a.float().numpy(), np.asarray(b, np.float32), 1e-5, 1e-7)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = tadamw.OptConfig(lr=0.1, weight_decay=0.0, schedule="const",
                           warmup_steps=1)
    state = tadamw.init_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        tadamw.apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping():
    params = {"w": torch.zeros(3)}
    cfg = tadamw.OptConfig(lr=0.0, clip_norm=1.0, schedule="const")
    state = tadamw.init_state(params)
    _, state, stats = tadamw.apply_updates(params, {"w": torch.full(
        (3,), 1e6)}, state, cfg)
    assert float(stats["grad_norm"]) > 1e6 - 1    # reported before clipping
    # the clipped gradient (norm 1) is what reaches the moments
    _close(float(torch.sqrt(torch.sum(state["m"]["w"] ** 2))), 0.1, 1e-5)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,pattern_frac", [(0, 0.5), (3, 0.25),
                                               (11, 0.0)])
def test_synthetic_corpus_equals_jax(seed, pattern_frac):
    jc = jpipe.SyntheticCorpus(jpipe.DataConfig(
        vocab=1000, seq_len=64, global_batch=8, seed=seed,
        pattern_frac=pattern_frac))
    tc = tpipe.SyntheticCorpus(tpipe.DataConfig(
        vocab=1000, seq_len=64, global_batch=8, seed=seed,
        pattern_frac=pattern_frac))
    for step, (a, b) in enumerate(zip(tc, jc)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tc.batch(step), a)
        if step == 4:
            break
    np.testing.assert_array_equal(next(tc.iter_from(9)), jc.batch(9))


def test_prefetcher():
    cfg = tpipe.DataConfig(vocab=100, seq_len=8, global_batch=2)
    corpus = tpipe.SyntheticCorpus(cfg)
    pf = tpipe.Prefetcher(corpus.iter_from(3))
    batches = [next(pf) for _ in range(3)]
    for i, b in enumerate(batches):
        np.testing.assert_array_equal(b, corpus.batch(3 + i))
    pf.close()


def test_motif_pool_batch_shape_and_period():
    """numpy draws (JAX's are jax.random): the shape, the period, the
    value range and the fixed pool match JAX's contract, not its
    tokens."""
    a = tpipe.motif_pool_batch(3, batch=16, seq_len=64, vocab=257)
    j = np.asarray(jpipe.motif_pool_batch(3, batch=16, seq_len=64,
                                          vocab=257))
    assert a.shape == j.shape == (16, 64)
    assert a.min() >= 0 and a.max() < 255
    np.testing.assert_array_equal(a[:, :4], a[:, 4:8])
    np.testing.assert_array_equal(a, np.tile(a[:, :4], (1, 16)))
    np.testing.assert_array_equal(a, tpipe.motif_pool_batch(3))
    rows = {tuple(r) for s in range(8) for r in tpipe.motif_pool_batch(
        s)[:, :4]}
    assert len(rows) <= 4                       # one fixed pool of 4


# ---------------------------------------------------------------------------
# three train steps
# ---------------------------------------------------------------------------

def _models(arch, seed=0):
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(seed))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _port_loss_grads(model_t, params_t, tokens, draw):
    leaves = tree_lib.leaves(params_t)
    for p in leaves:
        p.requires_grad_(True)
    noisy, mask, t = (torch.from_numpy(np.asarray(x)) for x in draw)
    loss, _ = tdiff.masked_diffusion_loss(
        model_t, params_t, torch.from_numpy(tokens).long(),
        draw=(noisy.long(), mask, t))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def test_three_train_steps_match_jax():
    """qwen2-0.5b smoke: three steps of loss, gradients and AdamW (cosine
    schedule, warmup 2, clipping at 1.0) as JAX's train.py runs them, on
    JAX's draws; losses, the updated parameters and the optimizer state
    equal JAX's."""
    model_j, model_t, params_j, params_t = _models("qwen2-0.5b")
    cfg = model_t.cfg
    opt = jadamw.OptConfig(lr=3e-3, schedule="cosine", warmup_steps=2,
                           stable_steps=2, decay_steps=1)
    topt = _topt(opt)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, tok, r: jdiff.masked_diffusion_loss(model_j, p, tok, r),
        has_aux=True))
    update = jax.jit(functools.partial(jadamw.apply_updates, cfg=opt))
    state_j = jadamw.init_state(params_j)
    state_t = tadamw.init_state(params_t)
    losses_j, losses_t = [], []
    for step in range(3):
        tokens = np.random.RandomState(10 + step).randint(
            0, cfg.vocab - 2, size=(2, 48)).astype(np.int32)
        rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        draw = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
        (loss_j, _), grads_j = loss_grad(params_j, jnp.asarray(tokens), rng)
        params_j, state_j, stats_j = update(params_j, grads_j, state_j)
        loss_t, grads_t = _port_loss_grads(model_t, params_t, tokens, draw)
        _, state_t, stats_t = tadamw.apply_updates(params_t, grads_t, state_t,
                                                   topt)
        losses_j.append(float(loss_j))
        losses_t.append(float(loss_t))
        _close(float(stats_t["lr"]), float(stats_j["lr"]), rtol=0, atol=0,
               what="lr")
        _close(float(stats_t["grad_norm"]), float(stats_j["grad_norm"]))
    _close(losses_t, losses_j, what="losses")
    got = bridge.params_to_numpy(params_t, cfg)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(params_j)):
        _close(g, np.asarray(w), atol=1e-3 * opt.lr,
               what=f"param {jax.tree_util.keystr(path)}")
    got_state = bridge.opt_state_to_numpy(state_t, cfg)
    assert int(got_state["step"]) == int(state_j["step"]) == 3
    for g, w in zip(jax.tree.leaves(got_state["m"]),
                    jax.tree.leaves(state_j["m"])):
        _close(g, np.asarray(w), what="m")
    # the state round-trips through the bridge
    back = bridge.opt_state_from_numpy(got_state, cfg, "cpu")
    for a, b in zip(tree_lib.leaves(back["v"]), tree_lib.leaves(state_t["v"])):
        assert torch.equal(a, b)
