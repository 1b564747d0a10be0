"""The split active-block KV cache of the port (ROADMAP item 12, JAX's
``init_cache(act_len)``) against the JAX package, on the CPU.

JAX's three tests/test_split_cache.py cases, each also held against JAX's
own split forward and generate on the same parameters (bridge), with
BAOS off and on; ``layers.attention(extra_kv=)`` and the online-softmax
partials against JAX's; the bridge's round trip of ``k_act``/``v_act``.
Tolerances are stated per test: 2e-3 (JAX's) for a split refine against
the cache-free forward, 5% of the largest logit (JAX's) for split against
unified with BAOS, 1e-5 for f32 attention against JAX's (summation order),
and 2e-3 for the port's split logits against JAX's with a quantized cache
(an MX-quantized cache leaf may sit one grid step apart at a rounding
edge, tests/test_torch_baos.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import flash_bidir as tfb
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)
B, S, L = 2, 32, 8
BS = S - L


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _tokens(cfg):
    return np.random.RandomState(1).randint(0, cfg.vocab - 2,
                                            size=(B, S)).astype(np.int32)


def _dcfgs(baos):
    kw = dict(gen_length=L, block_length=L, steps_per_block=2,
              cache_mode="dual")
    return (jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(
                enabled=baos, kv_format="mxint8"), **kw),
            tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(
                enabled=baos, kv_format="mxint8"), **kw))


def _split_refine(arch, baos, split=True):
    """(port refine logits, JAX refine logits, port cache, JAX cache) after
    a warm step and one refine on unchanged tokens."""
    model_j, model_t, params_j, params_t = _models(arch)
    x = _tokens(model_t.cfg)
    dj, dt = _dcfgs(baos)
    act = L if split else None
    cj = model_j.init_cache(B, S, act_len=act)
    _, cj = jdiff.warm_step(model_j, params_j, jnp.asarray(x), cj,
                            jnp.int32(BS), dj)
    want, cj = jdiff.refine_step(model_j, params_j, jnp.asarray(x), cj,
                                 jnp.int32(BS), dj)
    ct = model_t.init_cache(B, S, act_len=act)
    tdiff.warm_step(model_t, params_t, torch.from_numpy(x), ct, BS, dt)
    got, ct = tdiff.refine_step(model_t, params_t, torch.from_numpy(x), ct,
                                BS, dt)
    return got.float().numpy(), np.asarray(want, np.float32), ct, cj


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-0.5b"])
def test_split_refine_matches_full_forward(arch):
    """BAOS off: a split refine on unchanged tokens equals the cache-free
    forward (JAX's tolerance, 2e-3), and JAX's split refine (1e-5)."""
    model_j, model_t, params_j, params_t = _models(arch)
    x = _tokens(model_t.cfg)
    full, _ = model_t.forward(params_t, torch.from_numpy(x),
                              logits_slice=(BS, L))
    got, want, ct, cj = _split_refine(arch, baos=False)
    assert "k_act" in ct and ct["k_act"].shape == (
        model_t.cfg.n_layers, B, L, model_t.cfg.n_kv_heads,
        model_t.cfg.d_head)
    np.testing.assert_allclose(got, full.float().numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name in ("k_act", "v_act", "k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   rtol=1e-5, atol=1e-5)


def test_split_refine_with_baos_close_to_unified():
    """BAOS mxint8: split within 5% of the largest logit of unified (JAX's
    bound; only the active block is unquantized in split), and within
    2e-3 of JAX's split refine."""
    got_s, want_s, ct, cj = _split_refine("llama3.2-3b", baos=True)
    got_u, _, _, _ = _split_refine("llama3.2-3b", baos=True, split=False)
    err = np.abs(got_s - got_u).max()
    assert err < 0.05 * np.abs(got_u).max(), err
    np.testing.assert_allclose(got_s, want_s, rtol=2e-3, atol=2e-3)
    # the active buffer holds the block smoothed but unquantized
    np.testing.assert_allclose(ct["k_act"].numpy(), np.asarray(cj["k_act"]),
                               rtol=1e-4, atol=1e-4)
    # the refine leaves the full buffer as the warm step wrote it
    diff = np.abs(ct["k"].numpy() - np.asarray(cj["k"]))
    assert (diff > 0).mean() <= 1e-3


def _split_generate(model, params, prompt, dcfg, jax_side, **kw):
    orig = model.init_cache
    model.init_cache = functools.partial(orig, act_len=8)
    try:
        if jax_side:
            return np.asarray(jdiff.generate(model, params, prompt, dcfg))
        return tdiff.generate(model, params, prompt, dcfg, **kw).numpy()
    finally:
        model.init_cache = orig


@pytest.mark.parametrize("baos", [False, True])
def test_split_generation_unmasks(baos):
    """generate in dual mode through the split cache commits every token,
    eager and stepped through ``step_graphs`` (a device block start, as a
    graphed step has), with JAX's split generate's tokens (greedy, f32)."""
    model_j, model_t, params_j, params_t = _models("qwen2-0.5b")
    cfg = model_t.cfg
    prompt = np.random.RandomState(2).randint(0, cfg.vocab - 2,
                                              size=(2, 16)).astype(np.int32)
    kw = dict(gen_length=16, block_length=8, steps_per_block=4,
              cache_mode="dual")
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(
        enabled=baos, kv_format="mxint8"), **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(
        enabled=baos, kv_format="mxint8"), **kw)
    want = _split_generate(model_j, params_j, jnp.asarray(prompt), dj, True)
    tdiff.clear_step_graphs()
    eager = _split_generate(model_t, params_t, torch.from_numpy(prompt), dt,
                            False, jit_steps=False)
    stepped = _split_generate(model_t, params_t, torch.from_numpy(prompt),
                              dt, False, jit_steps=True)
    graphs = tdiff.step_graphs(model_t, dt, cfg.mask_id, None, 2, 32)
    assert "k_act" in graphs.cache
    tdiff.clear_step_graphs()
    assert not (eager[:, 16:] == cfg.mask_id).any()
    np.testing.assert_array_equal(eager, stepped)
    np.testing.assert_array_equal(eager, want)


# ---------------------------------------------------------------------------
# attention over two sources, and the partials
# ---------------------------------------------------------------------------

def _attn_inputs(seed, Hq=4, Hkv=2, D=16, Sq=8, Skv=24):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, Hq, D).astype(np.float32)
    k, v = (rs.randn(B, Skv, Hkv, D).astype(np.float32) for _ in range(2))
    k2, v2 = (rs.randn(B, Sq, Hkv, D).astype(np.float32) for _ in range(2))
    valid = rs.rand(B, Skv) > 0.3
    valid2 = rs.rand(B, Sq) > 0.2
    cal = [rs.randn(B, 1, Hkv, D).astype(np.float32) for _ in range(2)] + \
        [rs.uniform(0.5, 2, (B, 1, Hkv, D)).astype(np.float32)
         for _ in range(2)]
    return q, k, v, k2, v2, valid, valid2, cal


@pytest.mark.parametrize("baos", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_extra_kv_matches_jax(baos, window):
    """``layers.attention(extra_kv=)`` (flash_bidir's plain version of
    route B) against JAX's, 1e-5: the block at offset 16 of a 24-key
    cache, its keys at 16 + j."""
    q, k, v, k2, v2, valid, valid2, cal = _attn_inputs(3)
    off = 16
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = np.broadcast_to(off + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv))
    calib_j = calib_t = None
    if baos:
        kc, vc, ks, vs = cal
        calib_j = jbaos.BAOSCalib(*map(jnp.asarray, (kc, ks, vc, vs)))
        calib_t = tbaos.BAOSCalib(*map(torch.from_numpy, (kc, ks, vc, vs)))
    want = jlayers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=qpos,
        kv_pos=kpos, kv_valid=jnp.asarray(valid), window=window,
        baos_calib=calib_j,
        extra_kv=(jnp.asarray(k2), jnp.asarray(v2), qpos,
                  jnp.asarray(valid2)))
    got = tlayers.attention(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid),
        window=window, baos_calib=calib_t, q_offset=off,
        extra_kv=(torch.from_numpy(k2), torch.from_numpy(v2),
                  torch.from_numpy(valid2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_partials_match_jax():
    """attention_partials of each source, their combine and finalize equal
    JAX's (1e-5), bidir and causal, and the merged result equals one
    softmax over both key sets."""
    q, k, v, k2, v2, valid, valid2, _ = _attn_inputs(5)
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = np.broadcast_to(16 + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv))
    for mode in ("bidir", "causal"):
        pj = [jlayers.attention_partials(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), q_pos=qpos,
            kv_pos=pos, kv_valid=jnp.asarray(val), mode=mode, window=6)
            for a, b, c, pos, val in ((q, k, v, kpos, valid),
                                      (q, k2, v2, qpos, valid2))]
        pt = [tlayers.attention_partials(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
            q_pos=torch.from_numpy(np.ascontiguousarray(qpos)),
            kv_pos=torch.from_numpy(np.ascontiguousarray(pos)),
            kv_valid=torch.from_numpy(val), mode=mode, window=6)
            for a, b, c, pos, val in ((q, k, v, kpos, valid),
                                      (q, k2, v2, qpos, valid2))]
        for a, b in zip(pt, pj):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-5, atol=1e-5)
        Hq, D = q.shape[2], q.shape[3]
        got = tlayers.finalize_partials(
            tlayers.combine_partials(*pt), B, Sq, Hq, D, torch.float32)
        want = jlayers.finalize_partials(
            jlayers.combine_partials(*pj), B, Sq, Hq, D, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    one = tfb.flash_bidir_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid),
        q_offset=16, extra_kv=(torch.from_numpy(k2), torch.from_numpy(v2),
                               torch.from_numpy(valid2)))
    pb = [tlayers.attention_partials(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
        q_pos=torch.from_numpy(np.ascontiguousarray(qpos)),
        kv_pos=torch.from_numpy(np.ascontiguousarray(pos)),
        kv_valid=torch.from_numpy(val))
        for a, b, c, pos, val in ((q, k, v, kpos, valid),
                                  (q, k2, v2, qpos, valid2))]
    merged = tlayers.finalize_partials(tlayers.combine_partials(*pb), B, Sq,
                                       q.shape[2], q.shape[3], torch.float32)
    np.testing.assert_allclose(one.numpy(), merged.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_extra_kv_refuses_autograd():
    """Route B under autograd (it was refused before the cached forward had
    a backward): the gradients of q, k, v and the second source's k2, v2
    equal ``jax.grad`` of JAX's ``layers.attention(extra_kv=)``, 1e-5 of
    each leaf's largest (f32, summation order); the cache's own k and v
    without grad get none, as the split refine's read-only cache."""
    q, k, v, k2, v2, valid, valid2, _ = _attn_inputs(7)
    off = 16
    Sq, Skv = q.shape[1], k.shape[1]
    qpos = np.broadcast_to(off + np.arange(Sq), (B, Sq))
    kpos = np.broadcast_to(np.arange(Skv), (B, Skv))
    do = np.random.RandomState(8).randn(*q.shape).astype(np.float32)

    def f(q, k, v, k2, v2):
        return jnp.sum(jlayers.attention(
            q, k, v, q_pos=qpos, kv_pos=kpos, kv_valid=jnp.asarray(valid),
            extra_kv=(k2, v2, qpos, jnp.asarray(valid2))) * do)
    want = jax.grad(f, (0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, k2, v2)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, k2, v2)]
    out = tfb.flash_bidir(*ts[:3], torch.from_numpy(valid), q_offset=off,
                          extra_kv=(ts[3], ts[4], torch.from_numpy(valid2)))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for n, t, w in zip(("q", "k", "v", "k2", "v2"), ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
    k_ro, v_ro = torch.from_numpy(k), torch.from_numpy(v)
    qt, k2t = (torch.from_numpy(x).requires_grad_() for x in (q, k2))
    tfb.flash_bidir(qt, k_ro, v_ro, torch.from_numpy(valid), q_offset=off,
                    extra_kv=(k2t, torch.from_numpy(v2), None)).sum(
                    ).backward()
    assert k_ro.grad is None and qt.grad is not None and \
        k2t.grad is not None


def test_bridge_round_trip_and_specs():
    """A JAX split cache (after a warm step) carried into the port and back
    leaf for leaf; cache_specs and the families' init_cache(act_len) as in
    JAX (the ssm and the hybrid ignore act_len)."""
    model_j, model_t, params_j, _ = _models("qwen2-0.5b")
    x = _tokens(model_t.cfg)
    dj, _ = _dcfgs(True)
    _, cj = jdiff.warm_step(model_j, params_j, jnp.asarray(x),
                            model_j.init_cache(B, S, act_len=L),
                            jnp.int32(BS), dj)
    cj = jax.tree.map(np.asarray, cj)
    ct = bridge.cache_from_numpy(cj, model_t.cfg, "cpu")
    assert set(ct) == set(cj) and ct["k_act"].dtype == \
        model_t.cfg.torch_dtype
    back = bridge.cache_to_numpy(ct)
    for name in cj:
        np.testing.assert_array_equal(back[name], cj[name].astype(
            np.float32))
    from repro.models import transformer as jtr
    assert ttr.cache_specs(model_t.cfg, L) == jtr.cache_specs(
        jbase.get_config("qwen2-0.5b", smoke=True), L)
    for arch in ("mamba2-130m", "recurrentgemma-2b", "whisper-medium",
                 "internvl2-26b"):
        mj = jbuild(jbase.get_config(arch, smoke=True))
        mt = tbuild(tbase.get_config(arch, smoke=True), "cpu")
        shapes_j = jax.eval_shape(lambda: mj.init_cache(2, 16, act_len=8))
        shapes_t = mt.init_cache(2, 16, act_len=8, device="meta")
        assert {n: tuple(a.shape) for n, a in shapes_j.items()} == \
            {n: tuple(t.shape) for n, t in shapes_t.items()}, arch
