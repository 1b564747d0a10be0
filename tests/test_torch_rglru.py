"""The hybrid family of the PyTorch port (models/rglru.py,
recurrentgemma-2b) vs the JAX package on its SMOKE config (f32: 5 layers,
one (rec, rec, attn) triple and 2 tail rec layers, MQA with D 16, window
32), same weights (JAX init -> numpy -> bridge): the RG-LRU associative
scan and its sequential oracle, replay from a captured state, bounded
decay, the causal conv, the recurrent block's captures, ``forward``
without a cache, warm (every cache leaf, BAOS on and off) and refine
(inside the window and past it, with a host and a device block start),
greedy ``generate`` in cache modes none, dual and prefix, the serving
engine on the slot and paged pools at K 1 and 4, the slot pool's zeroing
release along each leaf's batch axis, and the serving command.  A cached
step with a device block start past the window attends at the start it
reads from device memory, as JAX's traced positions do.

Tolerance: rtol 1e-4, atol 1e-4 on f32 outputs and states, logits with
BAOS on included (the largest gap on these inputs is about 7e-6; the
refine logits with BAOS mxint8/mxint4 differ from JAX's by at most 4.4e-6,
and no K/V element of the warm cache differs); MX fake-quantized K/V
within one grid step at a rounding edge (test_torch_ssm.mx_close)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import rglru as jrg
from repro.models.registry import build_model as jbuild
from repro.serving.cache_pool import CachePool as JCachePool
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.launch import serve
from repro_torch.models import rglru as trg
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving.cache_pool import CachePool
from test_torch_ssm import engine_matches_jax, mx_close

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
ARCH = "recurrentgemma-2b"
CALIB = ("k_center", "k_scale", "v_center", "v_scale")


@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config(ARCH, smoke=True)
    cfg_t = tbase.get_config(ARCH, smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def _lru_inputs(seed, B=2, S=24, D=16, scale=1.0):
    """The JAX tests' distributions, drawn with numpy: x, r, i, lam."""
    rs = np.random.RandomState(seed)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    return (rs.randn(B, S, D).astype(np.float32) * scale,
            sig(rs.randn(B, S, D)).astype(np.float32),
            sig(rs.randn(B, S, D)).astype(np.float32),
            rs.randn(D).astype(np.float32))


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_config_fields_match_jax():
    """Every field of the full and smoke configs; build_model builds the
    full config; a stack that is not 3k + 2 layers raises as in JAX."""
    for smoke in (False, True):
        cfg_t = tbase.get_config(ARCH, smoke=smoke)
        cfg_j = jbase.get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(cfg_j):
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    model = tbuild(tbase.get_config(ARCH), "cpu")
    assert isinstance(model, trg.GriffinModel) and model.n_triples == 8
    assert not model.supports_head_mode
    bad = dataclasses.replace(tbase.get_config(ARCH, smoke=True), n_layers=6)
    with pytest.raises(ValueError, match="3k\\+2"):
        tbuild(bad, "cpu")


@pytest.mark.parametrize("S", [1, 2, 7, 24, 33, 96])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(S, with_h0):
    """Even and odd lengths through the recursion, with and without h0:
    against JAX's rglru_scan and the sequential oracles."""
    arrays = _lru_inputs(S, S=S)
    h0 = (np.random.RandomState(7).randn(2, 16).astype(np.float32)
          if with_h0 else None)
    kw_j = {} if h0 is None else {"h0": jnp.asarray(h0)}
    kw_t = {} if h0 is None else {"h0": torch.from_numpy(h0)}
    want = jrg.rglru_scan(*_j(arrays), **kw_j)
    got = trg.rglru_scan(*_t(arrays), **kw_t)
    _close(got, want)
    ref = jrg.rglru_ref(*_j(arrays), **kw_j)
    _close(got, ref, 2e-4, 2e-4)
    _close(trg.rglru_ref(*_t(arrays), **kw_t), ref)


def test_associative_scan_is_the_recursion():
    """On exactly representable inputs the combines are exact, so the
    scan equals the sequential product-sum bit for bit."""
    a = torch.full((1, 13, 1), 0.5)
    b = torch.arange(13, dtype=torch.float32).reshape(1, 13, 1)
    sa, sb = trg.associative_scan(a, b)
    h, want = torch.tensor(0.0), []
    for t in range(13):
        h = 0.5 * h + float(t)
        want.append(float(h))
    assert sb.flatten().tolist() == want
    assert sa.flatten().tolist() == [0.5 ** (t + 1) for t in range(13)]


def test_rglru_replay_from_state():
    """The state at position 15 replays [16:] to the full scan."""
    arrays = _lru_inputs(1, S=32, D=8)
    x, r, i, lam = _t(arrays)
    h_full = trg.rglru_scan(x, r, i, lam)
    h_rep = trg.rglru_scan(x[:, 16:], r[:, 16:], i[:, 16:], lam,
                           h0=h_full[:, 15])
    _close(h_rep, h_full[:, 16:], 2e-4, 2e-4)


def test_rglru_decay_bounded():
    """a_t in (0, 1]: the recurrence is contractive and the state stays
    bounded over 256 positions of inputs x 10."""
    x, r, i, lam = _t(_lru_inputs(2, B=1, S=256, D=8, scale=10.0))
    h = trg.rglru_scan(x, r, i, lam)
    assert bool(torch.isfinite(h).all()) and float(h.abs().max()) < 1e3
    a = torch.exp(-trg.RGLRU_C * trg.layers.softplus(lam) * r)
    assert bool(((a > 0) & (a <= 1)).all())


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, 12).astype(np.float32)
    w = rs.randn(4, 12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    st = rs.randn(2, 3, 12).astype(np.float32) if with_state else None
    want = jrg._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    got = trg.layers.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          None if st is None else torch.from_numpy(st)) + \
        torch.from_numpy(b)
    _close(got, want, 1e-6, 1e-6)


def test_softplus_and_gelu_are_jax_s():
    """softplus as logaddexp(x, 0) (no linear cut-off: at x = 30 F.softplus
    would return x exactly), GELU in its tanh form."""
    x = np.linspace(-40, 40, 801).astype(np.float32)
    _close(trg.layers.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), 1e-6, 1e-6)
    _close(trg.layers.gelu(torch.from_numpy(x)),
           jax.nn.gelu(jnp.asarray(x)), 1e-6, 1e-6)


@pytest.mark.parametrize("capture_at", [0, 1, 2, 17])
def test_rec_block_capture_matches_jax(models, capture_at):
    """Triple 0's rec1 block: y, h at capture_at - 1 and the conv rows
    before capture_at, the start an int and a one-element tensor."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    pj = jax.tree.map(lambda a: a[0], params_j["triples"]["rec1"])
    pt = params_t["triples"][0]["rec1"]
    x = np.random.RandomState(5).randn(2, 24, cfg.d_model).astype(np.float32)
    yj, hj, cj = jrg.rec_block(jnp.asarray(x), pj["temporal"], model_j.cfg,
                               capture_at=jnp.int32(capture_at))
    for at in (capture_at, torch.tensor([capture_at])):
        yt, ht, ct = trg.rec_block(torch.from_numpy(x), pt["temporal"], cfg,
                                   capture_at=at)
        _close(yt, yj)
        _close(ht, hj)
        _close(ct, cj)


def test_forward_without_cache_matches(models):
    """40 positions (past the window of 32): the local attention masks."""
    model_j, model_t, params_j, params_t = models
    toks = _tokens(model_t.cfg, 3, 40, seed=1)
    want, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks))
    got, cache = model_t.forward(params_t, torch.from_numpy(toks))
    assert cache is None and got.shape == (3, 40, model_t.cfg.vocab)
    _close(got, want)
    with pytest.raises(ValueError, match="supports_head_mode"):
        model_t.forward(params_t, torch.from_numpy(toks), head_mode="hidden")


@pytest.mark.parametrize("kv_format", [None, "mxint8", "mxint4"])
@pytest.mark.parametrize("S,bs", [(32, 16), (48, 32)],
                         ids=["in-window", "past-window"])
@pytest.mark.parametrize("device_start", [False, True])
def test_warm_then_refine_matches(models, kv_format, S, bs, device_start):
    """A warm step (calibrate, the block at ``bs``, length 8) writes the
    K/V, the recurrent states and conv rows as JAX's returns them, and
    with BAOS the calibration (with BAOS off the port keeps identity
    calibration, ROADMAP.md Queue 3); a dual refine step over the block
    and a prefix one over block + suffix give JAX's logits and leave the
    recurrent leaves unchanged.  A 48-long cache is longer than the
    window: there a device block start places the window as the host int
    does."""
    model_j, model_t, params_j, params_t = models
    B, L = 2, 8
    toks = _tokens(model_t.cfg, B, S, seed=2)
    on = kv_format is not None
    bj = jbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    bt = tbaos.BAOSConfig(enabled=on, kv_format=kv_format or "mxint4")
    start = torch.tensor([bs]) if device_start else bs
    lj, cj, _ = model_j.forward(params_j, tokens=jnp.asarray(toks),
                                cache=model_j.init_cache(B, S),
                                calibrate=True, baos_cfg=bj,
                                logits_slice=(jnp.int32(bs), L))
    cache = model_t.init_cache(B, S)
    lt, ct = model_t.forward(params_t, torch.from_numpy(toks), cache=cache,
                             calibrate=True, baos_cfg=bt,
                             logits_slice=(start, L))
    assert ct is cache and sorted(ct) == sorted(cj)
    _close(lt, lj)
    for name in cj:
        f32 = name in CALIB or name.endswith("state")
        assert ct[name].dtype == (torch.float32 if f32
                                  else model_t.cfg.torch_dtype), name
        if name in CALIB and not on:
            fill = 1.0 if name.endswith("scale") else 0.0
            assert bool((ct[name] == fill).all())
        elif name in ("k", "v") and on:
            mx_close(ct[name], cj[name], kv_format)
        else:
            _close(ct[name], cj[name])
    rec = ("rec_state", "rec_conv", "tail_state", "tail_conv")
    before = {n: ct[n].clone() for n in rec}
    for suffix in (0, S - bs - L):
        seg = toks[:, bs:bs + L + suffix]
        rj, cj2, _ = model_j.forward(params_j, tokens=jnp.asarray(seg),
                                     cache=cj, seg_start=jnp.int32(bs),
                                     baos_cfg=bj, logits_slice=(0, L))
        kw = dict(cache=ct, seg_start=start, baos_cfg=bt,
                  logits_slice=(0, L))
        rt, _ = model_t.forward(params_t, torch.from_numpy(seg), **kw)
        _close(rt, rj)
        for n in rec:
            assert torch.equal(ct[n], before[n]), n


def test_bridge_and_own_init_share_the_layout(models):
    """JAX's tree arrives leaf for leaf (lam in f32, norms as plain
    tensors); the port's seeded init and init_cache give the same trees of
    shapes and dtypes as the bridged ones."""
    model_j, model_t, params_j, params_t = models
    tree = jax.tree.map(np.asarray, params_j)

    def flat(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict) and set(v) != {"w"}:
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), (v["w"] if isinstance(v, dict) else v)

    for i, trip in enumerate(params_t["triples"]):
        got = dict(flat(trip))
        for key, leaf in flat(tree["triples"]):
            np.testing.assert_array_equal(got[key].numpy(), leaf[i])
    for j, sub in enumerate(params_t["tail"]):
        got = dict(flat(sub))
        for key, leaf in flat(tree["tail"]):
            np.testing.assert_array_equal(got[key].numpy(), leaf[j])
    assert params_t["tail"][0]["temporal"]["lam"].dtype == torch.float32
    own = model_t.init(seed=1)
    shapes = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in flat(t)}
    for stack in ("triples", "tail"):
        for a, b in zip(own[stack], params_t[stack]):
            assert shapes(a) == shapes(b)
    for name in ("embed", "final_norm", "lm_head"):
        assert own[name].shape == params_t[name].shape
    cache_j = jax.tree.map(np.asarray, model_j.init_cache(2, 32))
    cache_t = bridge.cache_from_numpy(cache_j, model_t.cfg, "cpu")
    for name, t in model_t.init_cache(2, 32).items():
        assert (t.shape, t.dtype) == (cache_t[name].shape,
                                      cache_t[name].dtype), name
        assert torch.equal(t, cache_t[name]), name


@pytest.mark.parametrize("cache_mode,jit_steps,prompt", [
    ("none", True, 16), ("dual", True, 16), ("prefix", True, 16),
    ("dual", True, 24), ("prefix", True, 24), ("dual", False, 24),
    ("prefix", False, 24)])
def test_generate_greedy_tokens_match(models, cache_mode, jit_steps, prompt):
    """Greedy tokens of generate() equal JAX's: B 2, gen 16, block 8, 4
    steps; the cached modes with BAOS mxint8 (tests/test_models.py's
    setting).  A 24-token prompt makes the canvas (40) longer than the
    window: eager steps (a host block start) and graphed ones (a device
    block start) match there.  No near-tie shows on these seeds, so the
    check is exact."""
    model_j, model_t, params_j, params_t = models
    on = cache_mode != "none"
    kw = dict(gen_length=16, block_length=8, steps_per_block=4,
              cache_mode=cache_mode)
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint8"),
                               **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint8"),
                               **kw)
    toks = _tokens(model_t.cfg, 2, prompt, seed=5)
    want = jdiff.generate(model_j, params_j, jnp.asarray(toks), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(toks), dt,
                         seed=11, jit_steps=jit_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())


@pytest.mark.parametrize("pool", ["slot", "paged"])
@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("mode,baos", [
    ("none", None), ("warm", None), ("warm", dict(kv_format="mxint4"))],
    ids=["none", "warm", "warm+baos"])
def test_engine_matches_jax_engine(models, mode, baos, megatick_k, pool):
    """Final tokens, per-request ticks, every CommitEvent and the tick
    count equal the JAX engine's; the paged pool (K/V paged, the
    recurrent leaves per slot with batch on axis 2 or 1) equals the slot
    pool."""
    engine_matches_jax(models, mode, baos, megatick_k, pool)


def test_paged_layout_and_per_slot_leaves(models):
    model_t = models[1]
    names, paged, axes = tdiff.paged_cache_layout(model_t, 8, 32)
    got = dict(zip(names, zip(paged, axes)))
    assert got["k"] == got["v"] == (True, 1)
    assert got["rec_state"] == got["rec_conv"] == (False, 2)
    assert got["tail_state"] == got["tail_conv"] == (False, 1)
    assert tdiff.cache_batch_axes(model_t, 32) == dict(zip(names, axes))


def test_slot_pool_zeroing_release_follows_each_batch_axis(models):
    """release(slot, zero=True) zeroes the slot's row along each leaf's
    own batch axis: axis 2 of rec_state/rec_conv.  JAX's pool zeroes
    [:, slot] of every leaf (ROADMAP.md Queue 3), so it agrees on the
    leaves with batch on axis 1 and not on those two; no engine path
    releases with zero=True."""
    model_j, model_t = models[:2]
    pt = CachePool(model_t, 3, 16)
    for t in pt.cache.values():
        t.fill_(1)
    slot = pt.acquire()
    assert slot == 0
    pt.acquire()
    pt.release(slot, zero=True)
    axes = tdiff.cache_batch_axes(model_t, 16)
    for name, t in pt.cache.items():
        ax = axes[name]
        assert not bool(t.select(ax, slot).any()), name
        for other in (1, 2):
            assert bool((t.select(ax, other) == 1).all()), name
    pj = JCachePool(model_j, 3, 16)
    pj.cache = jax.tree.map(jnp.ones_like, pj.cache)
    pj.release(pj.acquire(), zero=True)
    for name in ("k", "v", "tail_state", "tail_conv"):
        np.testing.assert_array_equal(pt.cache[name].numpy(),
                                      np.asarray(pj.cache[name]))
    assert not np.array_equal(pt.cache["rec_state"].numpy(),
                              np.asarray(pj.cache["rec_state"]))


def test_serve_command_on_recurrentgemma(capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-2b
    --smoke --device cpu``: the engine path with breakdown, and the
    legacy path (dual + BAOS, graphed steps)."""
    small = ["--device", "cpu", "--arch", ARCH, "--smoke", "--batch", "2",
             "--prompt-len", "16", "--gen-len", "16", "--block-len", "16",
             "--steps", "4", "--requests", "2"]
    serve.main(small + ["--breakdown"])
    out = capsys.readouterr().out
    assert "engine: slots=2" in out and "steady-state TPS" in out
    assert "sampling:" in out and "forward:" in out
    serve.main(small + ["--legacy"])
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and "cache=dual" in out
