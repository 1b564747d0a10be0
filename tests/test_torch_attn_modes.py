"""Attention at a query offset read from device memory, and JAX's causal
attention mode, in the PyTorch port against the JAX package on the CPU.

* kernels/flash_bidir's plain version with a tensor ``q_offset`` (a 0-d
  int32 tensor, as the step builders pass the block start, and a (B,)
  int64 buffer, as the graphed steps hold it) against JAX's
  layers.attention with q_pos = offset + arange, at windows 7 and 32, on
  the cache alone and with route B's second source (its key j at
  offset + j); bit for bit against the same call with a host int;
* causal attention (``causal=True``) against JAX's ``mode="causal"``,
  with and without a window, at a host and a tensor offset, and its
  gradient (``FlashBidir``'s backward, ``flash_bidir_bwd_plain``)
  against ``jax.grad``;
* ``forward(attn_mode="causal")`` (and a config whose attn_mode is
  "causal") of the dense and MoE smoke configs against JAX's forward:
  no cache, and a warm step followed by dual and prefix refine steps
  from a host and from a device block start, with and without a
  window; the loss and every parameter's gradient of a causal config;
* recurrentgemma-2b's decode step (launch/steps.build_step) on a 96-long
  cache past its smoke window of 32, with a 0-d tensor block start,
  against JAX's step, and bit for bit against the host int.

Tolerances as in the files these cases extend: attention and its
gradients rtol 1e-4, atol 1e-5 (tests/test_torch_train.py); logits rtol
1e-4, atol 1e-4 (tests/test_torch_rglru.py); the loss and the parameter
gradients rtol 1e-4, atol 1e-6 x max(1, the leaf's largest value)
(tests/test_torch_train.py); the decode step's canvas exact and its
cache as tests/test_torch_steps.py holds it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro_torch import bridge
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.kernels import _build
from repro_torch.kernels import flash_bidir as fb
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5
LOGIT_RTOL = LOGIT_ATOL = 1e-4
RTOL, ATOL = 1e-4, 1e-6
GRID_STEP = 0.3      # one mxint4 step of a minmax-smoothed value (<= 2/7)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Sq, Hq, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32))


def _offset_tensor(off, kind, B):
    """``off`` as the port's two device forms of a block start."""
    if kind == "0-d int32":
        return torch.tensor(off, dtype=torch.int32)
    return torch.full((B,), off, dtype=torch.int64)


# ---------------------------------------------------------------------------
# flash_bidir with a tensor offset and in causal mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["0-d int32", "(B,) int64"])
@pytest.mark.parametrize("split", [False, True], ids=["cache", "route-B"])
@pytest.mark.parametrize("window", [7, 32])
def test_tensor_offset_matches_jax_and_host_int(window, split, kind):
    """8 query rows at 40..47 over a 64-long cache with ragged kv_valid;
    route B adds an 8-long source at the rows' positions, the cache's copy
    of them masked out (the split refine's layout)."""
    B, Sq, Skv, Hq, Hkv, D, off = 2, 8, 64, 4, 2, 16, 40
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=window + 3 * split)
    valid = np.arange(Skv)[None, :] < np.array([[Skv], [50]])
    q_pos = np.tile(off + np.arange(Sq), (B, 1))
    kv_pos = np.tile(np.arange(Skv), (B, 1))
    jkw, extra = {}, None
    if split:
        _, k2, v2 = _qkv(B, Sq, Sq, Hq, Hkv, D, seed=17)
        valid &= ~((kv_pos >= off) & (kv_pos < off + Sq))
        jkw["extra_kv"] = (jnp.asarray(k2), jnp.asarray(v2), q_pos,
                           jnp.ones((B, Sq), bool))
        extra = (torch.from_numpy(k2), torch.from_numpy(v2), None)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=q_pos, kv_pos=kv_pos,
                             kv_valid=jnp.asarray(valid), window=window,
                             **jkw)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tvalid = torch.from_numpy(valid)
    got = fb.flash_bidir(*args, tvalid, window=window,
                         q_offset=_offset_tensor(off, kind, B),
                         extra_kv=extra)
    host = fb.flash_bidir(*args, tvalid, window=window, q_offset=off,
                          extra_kv=extra)
    assert torch.equal(got, host)
    _close(got, want, ATTN_RTOL, ATTN_ATOL)
    # the offset moves the window: another start gives another result
    moved = fb.flash_bidir(*args, tvalid, window=window,
                           q_offset=_offset_tensor(off - 20, kind, B),
                           extra_kv=extra)
    assert not torch.equal(moved, got)


@pytest.mark.parametrize("offset", ["host", "tensor"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("split", [False, True], ids=["cache", "route-B"])
def test_causal_matches_jax(split, window, offset):
    """Causal attention of 8 rows at 12..19 over a 24-long cache (the
    suffix after the rows masked by the mode), ragged kv_valid with a row
    of one valid key."""
    B, Sq, Skv, Hq, Hkv, D, off = 3, 8, 24, 4, 2, 16, 12
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=5 + (window or 0))
    valid = np.arange(Skv)[None, :] < np.array([[Skv], [15], [1]])
    q_pos = np.tile(off + np.arange(Sq), (B, 1))
    kv_pos = np.tile(np.arange(Skv), (B, 1))
    jkw, extra = {}, None
    if split:
        _, k2, v2 = _qkv(B, Sq, Sq, Hq, Hkv, D, seed=19)
        valid &= ~((kv_pos >= off) & (kv_pos < off + Sq))
        jkw["extra_kv"] = (jnp.asarray(k2), jnp.asarray(v2), q_pos,
                           jnp.ones((B, Sq), bool))
        extra = (torch.from_numpy(k2), torch.from_numpy(v2), None)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=q_pos, kv_pos=kv_pos,
                             kv_valid=jnp.asarray(valid), mode="causal",
                             window=window, **jkw)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    start = off if offset == "host" else torch.tensor([off])
    got = tlayers.attention(*args, torch.from_numpy(valid), window=window,
                            q_offset=start, extra_kv=extra, causal=True)
    _close(got, want, ATTN_RTOL, ATTN_ATOL)
    bidir = tlayers.attention(*args, torch.from_numpy(valid), window=window,
                              q_offset=start, extra_kv=extra)
    assert not torch.equal(got, bidir)


# (B, Sq, Skv, Hq, Hkv, D, window, q_offset, kv_valid lengths or None)
CAUSAL_GRAD_CASES = {
    "mha": (2, 12, 12, 4, 4, 16, None, 0, None),
    "gqa7": (2, 10, 10, 14, 2, 16, None, 0, None),
    "window": (2, 12, 12, 4, 2, 16, 4, 0, None),
    "window_q_offset_kv_valid": (2, 6, 20, 4, 2, 16, 5, 9, (20, 13)),
    "d256": (1, 6, 6, 2, 1, 256, None, 0, None),
}


@pytest.mark.parametrize("name", sorted(CAUSAL_GRAD_CASES))
def test_causal_grad_matches_jax(name):
    """Every row of these cases has a valid key (its own position, or an
    earlier one), so every gradient is held to ``jax.grad``'s."""
    B, Sq, Skv, Hq, Hkv, D, win, off, lens = CAUSAL_GRAD_CASES[name]
    rs = np.random.RandomState(11)
    q = rs.randn(B, Sq, Hq, D).astype(np.float32)
    k, v = (rs.randn(B, Skv, Hkv, D).astype(np.float32) for _ in range(2))
    do = rs.randn(B, Sq, Hq, D).astype(np.float32)
    valid = np.ones((B, Skv), bool)
    if lens is not None:
        valid = np.arange(Skv)[None, :] < np.asarray(lens)[:, None]
    q_pos = np.tile(off + np.arange(Sq), (B, 1))
    kv_pos = np.tile(np.arange(Skv), (B, 1))

    def f(q, k, v):
        return jlayers.attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 kv_valid=valid, mode="causal", window=win)
    want_out = np.asarray(f(q, k, v))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * do), (0, 1, 2)))(
        q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tvalid = None if lens is None else torch.from_numpy(valid)
    out = fb.flash_bidir(tq, tk, tv, tvalid, window=win, q_offset=off,
                         causal=True)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), want_out, ATTN_RTOL, ATTN_ATOL, "out")
    with torch.no_grad():
        plain = fb.flash_bidir_bwd_plain(
            *(torch.from_numpy(x) for x in (q, k, v, do)), tvalid, win, off,
            causal=True)
    for n, t, p, w in zip("qkv", (tq, tk, tv), plain, want):
        assert torch.equal(t.grad, p)       # the Function runs plain
        _close(t.grad, w, ATTN_RTOL, ATTN_ATOL, f"d{n} {name}")


def test_device_offset_and_backward_refusals():
    """The backward takes a tensor offset (the cached forward under
    autograd; it was refused before): under autograd and called directly
    its gradients equal the host int's bit for bit, with a window and
    causal; a float tensor is no offset, with or without grad."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    k = v = torch.randn(1, 8, 2, 16)
    do = torch.randn(1, 4, 2, 16)
    for causal in (False, True):
        got = []
        for off in (torch.tensor([2]), 2):
            q.grad = None
            fb.flash_bidir(q, k, v, window=4, q_offset=off,
                           causal=causal).backward(do)
            got.append(q.grad.clone())
        assert got[0].any() and torch.equal(got[0], got[1])
        direct = [fb.flash_bidir_bwd(q.detach(), k, v, do, None, 4, off,
                                     causal) for off in (torch.tensor([2]),
                                                         2)]
        assert direct[0][3:] == direct[1][3:] == (None,) * 5
        for a, b in zip(direct[0][:3], direct[1][:3]):
            assert torch.equal(a, b)
        assert torch.equal(direct[0][0], got[0])
    for grad in (True, False):
        with torch.set_grad_enabled(grad), \
                pytest.raises(ValueError, match="integers"):
            fb.flash_bidir(q, k, v, window=4, q_offset=torch.tensor([2.0]))


def test_launch_count_names():
    """Each launch's count entry is one of _build.COUNTED, named for the
    route (the module docstring's rule)."""
    names = {fb.count_name(s, c, d): (s, c, d) for s in (False, True)
             for c in (False, True) for d in (False, True)}
    assert set(names) == {fb.NAME, fb.SPLIT_NAME, fb.OFFSET_NAME,
                          fb.CAUSAL_NAME}
    assert set(names) | {fb.BWD_NAME, fb.BWD_CAUSAL_NAME} <= \
        set(_build.COUNTED)
    assert all(_build.ROUTES[n] == "flash_bidir" for n in names
               if n != fb.NAME)
    assert _build.ROUTES[fb.BWD_CAUSAL_NAME] == fb.BWD_NAME


# ---------------------------------------------------------------------------
# forward(attn_mode="causal")
# ---------------------------------------------------------------------------

MODE_ARCHS = ("llada-8b", "llada-moe-7b-a1b")
B, S, L, BS = 2, 32, 8, 16


def _models(arch, window=None, causal_config=True):
    """JAX's and the port's smoke models of ``arch`` (the port's params
    bridged from JAX's), with ``window``, attn_mode "causal" in the config
    when ``causal_config``."""
    mode = "causal" if causal_config else "bidir"
    cfg_j = dataclasses.replace(jbase.get_config(arch, smoke=True),
                                window=window, attn_mode=mode)
    cfg_t = dataclasses.replace(tbase.get_config(arch, smoke=True),
                                window=window, attn_mode=mode)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _tokens(cfg, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def test_build_model_takes_causal():
    cfg = dataclasses.replace(tbase.get_config("llada-8b", smoke=True),
                              attn_mode="causal")
    model = tbuild(cfg, "cpu")
    assert model.cfg.attn_mode == "causal"
    with pytest.raises(ValueError, match="attn_mode"):
        tbuild(dataclasses.replace(cfg, attn_mode="sliding"), "cpu")
    with pytest.raises(ValueError, match="attn_mode"):
        model.forward(model.init(seed=0), torch.zeros((1, 4), dtype=torch.long),
                      attn_mode="sliding")


@pytest.mark.parametrize("via", ["config", "argument"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_causal_forward_without_cache_matches(arch, window, via):
    """The mode set in the config, or passed to forward() over a bidir
    config (which then differs from the bidir forward)."""
    model_j, model_t, params_j, params_t = _models(
        arch, window, causal_config=via == "config")
    kw = {} if via == "config" else {"attn_mode": "causal"}
    toks = _tokens(model_t.cfg, 1)
    want, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks), **kw)
    got, cache = model_t.forward(params_t, torch.from_numpy(toks), **kw)
    assert cache is None
    _close(got, want, LOGIT_RTOL, LOGIT_ATOL)
    if via == "argument":
        bidir, _ = model_t.forward(params_t, torch.from_numpy(toks))
        assert not torch.allclose(bidir, got)


@pytest.mark.parametrize("device_start", [False, True])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("arch,kv_format", [
    ("llada-8b", None), ("llada-8b", "mxint8"), ("llada-moe-7b-a1b", None)])
def test_causal_warm_then_refine_matches(arch, kv_format, window,
                                         device_start):
    """A warm step (calibrate, the block at BS) then a dual refine over the
    block and a prefix one over block + suffix, each from a host or a
    device block start, with BAOS off (and on the dense config mxint8).
    The warm step's logits within the logit tolerance; with BAOS its cache
    as tests/test_torch_steps.py holds one (an MX-quantized K/V element
    may sit one grid step apart at a rounding edge, at most one in 10^3:
    one V element of 8192 here, which moves the warm logits of a
    6-key window by 1e-3, so they are not held there).  The refine steps
    run on JAX's warm cache, bridged, so both packages refine the same
    cache."""
    model_j, model_t, params_j, params_t = _models(arch, window)
    on = kv_format is not None
    bj = jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    bt = tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    toks = _tokens(model_t.cfg, 2)
    start = torch.tensor([BS]) if device_start else BS
    lj, cj, _ = model_j.forward(params_j, tokens=jnp.asarray(toks),
                                cache=model_j.init_cache(B, S),
                                calibrate=True, baos_cfg=bj,
                                logits_slice=(jnp.int32(BS), L))
    ct = model_t.init_cache(B, S)
    lt, _ = model_t.forward(params_t, torch.from_numpy(toks), cache=ct,
                            calibrate=True, baos_cfg=bt,
                            logits_slice=(start, L))
    if not on:
        _close(lt, lj, LOGIT_RTOL, LOGIT_ATOL, "warm")
    for name, w in cj.items():
        g, w = ct[name].float().numpy(), np.asarray(w, np.float32)
        if name in ("k", "v"):
            diff = np.abs(g - w)
            assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= \
                GRID_STEP, (name, diff.max())
        elif on:
            _close(g, w, RTOL, 1e-5, name)
    ct = bridge.cache_from_numpy(jax.tree.map(np.asarray, cj), model_t.cfg,
                                 "cpu")
    for suffix in (0, S - BS - L):
        seg = toks[:, BS:BS + L + suffix]
        rj, _, _ = model_j.forward(params_j, tokens=jnp.asarray(seg),
                                   cache=cj, seg_start=jnp.int32(BS),
                                   baos_cfg=bj, logits_slice=(0, L))
        rt, _ = model_t.forward(params_t, torch.from_numpy(seg), cache=ct,
                                seg_start=start, baos_cfg=bt,
                                logits_slice=(0, L))
        _close(rt, rj, LOGIT_RTOL, LOGIT_ATOL, f"refine suffix {suffix}")


def test_causal_loss_and_grads_match_jax():
    """A causal dense config trains: the masked-diffusion loss and every
    parameter's gradient against ``jax.value_and_grad`` of JAX's on the
    same draw (through FlashBidir's backward)."""
    model_j, model_t, params_j, params_t = _models("llada-8b", window=6)
    cfg = model_t.cfg
    tokens = _tokens(cfg, 3)
    rng = jax.random.PRNGKey(7)
    noisy, mask, t = jdiff.forward_mask(rng, jnp.asarray(tokens), cfg.mask_id)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdiff.masked_diffusion_loss(model_j, p, jnp.asarray(tokens),
                                              rng), has_aux=True))(params_j)
    leaves = tree_lib.leaves(params_t)
    for p in leaves:
        p.requires_grad_(True)
    loss_t, _ = tdiff.masked_diffusion_loss(
        model_t, params_t, torch.from_numpy(tokens).long(),
        draw=(torch.from_numpy(np.asarray(noisy)).long(),
              torch.from_numpy(np.asarray(mask)),
              torch.from_numpy(np.asarray(t))))
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    _close(float(loss_t), float(loss_j), RTOL, ATOL, "loss")
    got = bridge.params_to_numpy(tree_lib.unflatten(params_t, grads), cfg)
    want = jax.tree.map(np.asarray, grads_j)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        _close(g, w, RTOL, ATOL * max(1.0, float(np.abs(w).max())),
               f"grad {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# recurrentgemma-2b's decode step past its window
# ---------------------------------------------------------------------------

def test_hybrid_decode_step_past_window_matches_jax():
    """recurrentgemma-2b (smoke: window 32) prefill and decode at a
    96-long canvas, the block at 64: JAX's steps, then the port's decode
    from JAX's prefilled cache with the 0-d int32 block start that
    launch/steps.input_specs declares: the canvas equal to JAX's, the
    cache as tests/test_torch_steps.py holds it, and both equal bit for
    bit to the same step with the host int."""
    arch, Bd, Sd, Ld, bs = "recurrentgemma-2b", 2, 96, 8, 64
    cfg_j = jbase.get_config(arch, smoke=True)
    cfg_t = tbase.get_config(arch, smoke=True)
    assert cfg_t.window < bs
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    rs = np.random.RandomState(4)
    x = rs.randint(0, cfg_t.vocab - 2, size=(Bd, Sd)).astype(np.int32)
    x[:, bs:] = cfg_t.mask_id
    k = np.array([3, 2], np.int32)
    jpol, tpol = jsteps.ServePolicy(), tsteps.ServePolicy()
    jpre = jbase.ShapeConfig("prefill", Sd, Bd, "prefill", block_length=Ld)
    fj, _ = jsteps.build_step(model_j, jpre, jpol)
    _, cache_j = jax.jit(fj)(params_j, jnp.asarray(x),
                             model_j.init_cache(Bd, Sd), jnp.int32(bs), {})
    jdec = jbase.ShapeConfig("decode", Sd, Bd, "decode", block_length=Ld)
    tdec = tbase.ShapeConfig("decode", Sd, Bd, "decode", block_length=Ld)
    fj, _ = jsteps.build_step(model_j, jdec, jpol)
    x_j, c_j = jax.jit(fj)(params_j, jnp.asarray(x), cache_j, jnp.int32(bs),
                           jnp.asarray(k), jnp.uint32(3), {})
    ft, _ = tsteps.build_step(model_t, tdec, tpol)
    runs = []
    for start in (torch.tensor(bs, dtype=torch.int32), bs):
        cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache_j),
                                        cfg_t, "cpu")
        runs.append(ft(params_t, torch.from_numpy(x), cache, start,
                       torch.from_numpy(k), 3, {}))
    (x_t, c_t), (x_h, c_h) = runs
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    assert torch.equal(x_t, x_h)
    for name, w in c_j.items():
        assert torch.equal(c_t[name], c_h[name]), name
        g = c_t[name].float().numpy()
        w = np.asarray(w, np.float32)
        if name in ("k", "v"):
            diff = np.abs(g - w)
            assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= \
                GRID_STEP, name
        else:
            _close(g, w, RTOL, 1e-5, name)
