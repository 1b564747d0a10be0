"""The ssm family of the PyTorch port (models/ssm.py, mamba2-130m) vs the
JAX package on its SMOKE config (f32), same weights (JAX init -> numpy ->
bridge): the SSD chunked scan and its sequential oracle, state capture
and replay, the causal conv, the Mamba2 block, ``forward`` without a
cache, warm (every cache leaf, BAOS on and off) and refine, greedy
``generate`` in cache modes none, dual and prefix, the serving engine on
the slot and paged pools at K 1 and 4, and the SSD chunk rule.

Tolerance: rtol 1e-4, atol 1e-4 on f32 outputs and states.  The port's
SSD contracts its einsums in another order than XLA's (C·Bᵀ first, then
the decay mask and x), so the two agree to f32 rounding, not bit for bit;
the largest gap on these inputs is about 2e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models import ssm as jssm
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
ARCH = "mamba2-130m"


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


# largest magnitude of each integer MX grid (core/mx)
GRID_MAX = {"mxint8": 127.0, "mxint4": 7.0}


def mx_close(got, want, fmt):
    """MX fake-quantized values: equal within ATOL but for rounding edges.
    An f32 gap of a few ulp before the quantizer (the SSD's contraction
    order) can put a value on the other side of a rounding boundary of its
    block's grid, one grid step (at most 2 amax / grid max) away.  At most
    one element in 1000 may do so, and by no more than one step."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert off.mean() < 1e-3, off.mean()
    amax = np.abs(want).max(axis=-1, keepdims=True)
    step = np.broadcast_to(2 * amax / GRID_MAX[fmt], want.shape)
    assert (np.abs(got - want)[off] <= step[off] * (1 + 1e-6)).all()


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab - 2, size=(B, S)).astype(np.int32)


def _ssd_inputs(seed, b=2, s=32, h=2, p=16, g=1, n=8):
    """The JAX tests' distributions, drawn with numpy."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rs.randn(b, s, h).astype(np.float32)))
    A = -np.exp(rs.randn(h).astype(np.float32) * 0.5)
    B = rs.randn(b, s, g, n).astype(np.float32)
    C = rs.randn(b, s, g, n).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_config_fields_match_jax():
    """Every field of the full and smoke configs; build_model builds the
    full config (family ssm) on the CPU."""
    for smoke in (False, True):
        cfg_t = tbase.get_config(ARCH, smoke=smoke)
        cfg_j = jbase.get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(cfg_j):
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    model = tbuild(tbase.get_config(ARCH), "cpu")
    assert isinstance(model, tssm.MambaModel)
    assert not model.supports_head_mode


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    """y and every chunk state against JAX's ssd_chunked, y against JAX's
    sequential ssd_ref and the port's own."""
    arrays = _ssd_inputs(0)
    h0 = (np.random.RandomState(9).randn(2, 2, 16, 8).astype(np.float32)
          if with_h0 else None)
    (xj, dtj, Aj, Bj, Cj), (xt, dtt, At, Bt, Ct) = _both(arrays)
    h0j = None if h0 is None else jnp.asarray(h0)
    h0t = None if h0 is None else torch.from_numpy(h0)
    yj, sj = jssm.ssd_chunked(xj, dtj, Aj, Bj, Cj, h0=h0j, chunk=chunk)
    yt, st = tssm.ssd_chunked(xt, dtt, At, Bt, Ct, h0=h0t, chunk=chunk)
    assert st.shape == (2, 32 // chunk + 1, 2, 16, 8)
    _close(yt, yj)
    _close(st, sj)
    yref = jssm.ssd_ref(xj, dtj, Aj, Bj, Cj, h0=h0j)
    _close(yt, yref, 2e-4, 2e-4)
    _close(tssm.ssd_ref(xt, dtt, At, Bt, Ct, h0=h0t), yref)


def test_ssd_grouped_heads_repeat_as_jax():
    """4 heads on 2 groups: jnp.repeat's order (each group's heads
    adjacent)."""
    (xj, dtj, Aj, Bj, Cj), (xt, dtt, At, Bt, Ct) = _both(
        _ssd_inputs(3, h=4, g=2))
    _close(tssm.ssd_chunked(xt, dtt, At, Bt, Ct)[0],
           jssm.ssd_chunked(xj, dtj, Aj, Bj, Cj)[0])


def test_ssd_state_capture_enables_replay():
    """The state at chunk boundary 32 replays [32:] to the full run's
    output, in the port as in JAX."""
    x, dt, A, B, C = _ssd_inputs(2, s=64)
    (_, _, _, _, _), (xt, dtt, At, Bt, Ct) = _both((x, dt, A, B, C))
    y_full, states = tssm.ssd_chunked(xt, dtt, At, Bt, Ct, chunk=16)
    y_rep, _ = tssm.ssd_chunked(xt[:, 32:], dtt[:, 32:], At, Bt[:, 32:],
                                Ct[:, 32:], h0=states[:, 2], chunk=16)
    _close(y_rep, y_full[:, 32:], 2e-4, 2e-4)
    yj, _ = jssm.ssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, B, C)],
                             chunk=16)
    _close(y_full, yj)


@pytest.mark.parametrize("S", [8, 24, 40])
def test_segment_not_a_multiple_of_the_chunk_raises(models, S):
    """JAX's ValueError, from ssd_chunked and from the model."""
    model_j, model_t, params_j, params_t = models
    (xj, dtj, Aj, Bj, Cj), (xt, dtt, At, Bt, Ct) = _both(
        _ssd_inputs(0, s=S))
    with pytest.raises(ValueError, match="multiple of ssd chunk 16"):
        jssm.ssd_chunked(xj, dtj, Aj, Bj, Cj)
    with pytest.raises(ValueError, match="multiple of ssd chunk 16"):
        tssm.ssd_chunked(xt, dtt, At, Bt, Ct)
    with pytest.raises(ValueError, match="multiple of ssd chunk 16"):
        model_t.forward(params_t, torch.zeros((1, S), dtype=torch.int32))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """conv + bias + silu, with and without the previous segment's W - 1
    rows."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, 12).astype(np.float32)
    w = rs.randn(4, 12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    st = rs.randn(2, 3, 12).astype(np.float32) if with_state else None
    want, _ = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    got = torch.nn.functional.silu(tssm.layers.causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st)) + torch.from_numpy(b))
    _close(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("capture_at", [0, 2, 16, 32])
def test_mamba_block_capture_matches_jax(models, capture_at):
    """Layer 0's block: y, the chunk states and the conv rows captured at
    ``capture_at``, given as an int and as a one-element tensor (a
    graph's block start)."""
    model_j, model_t, params_j, params_t = models
    cfg = model_t.cfg
    lp_j = jax.tree.map(lambda a: a[0], params_j["layers"])
    lp_t = params_t["layers"][0]
    h = np.random.RandomState(5).randn(2, 48, cfg.d_model).astype(
        np.float32)
    yj, sj, cj = jssm.mamba_block(jnp.asarray(h), lp_j, model_j.cfg,
                                  capture_at=jnp.int32(capture_at))
    for at in (capture_at, torch.tensor([capture_at])):
        yt, st, ct = tssm.mamba_block(torch.from_numpy(h), lp_t, cfg,
                                      capture_at=at)
        _close(yt, yj)
        _close(st, sj)
        _close(ct, cj)
        assert bool((ct == 0).all()) == (capture_at < 3)


def test_forward_without_cache_matches(models):
    model_j, model_t, params_j, params_t = models
    toks = _tokens(model_t.cfg, 3, 48, seed=1)
    want, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks))
    got, cache = model_t.forward(params_t, torch.from_numpy(toks))
    assert cache is None and got.shape == (3, 48, model_t.cfg.vocab)
    _close(got, want)
    with pytest.raises(ValueError, match="supports_head_mode"):
        model_t.forward(params_t, torch.from_numpy(toks), head_mode="hidden")


@pytest.mark.parametrize("kv_format", [None, "mxint8", "mxint4"])
@pytest.mark.parametrize("device_start", [False, True])
def test_warm_then_refine_matches(models, kv_format, device_start):
    """A warm step (calibrate, logits_slice at block start 32) writes
    every cache leaf as JAX's returns it, BAOS off and on (the state MX
    fake-quantized); a refine step over [32:] from that cache gives JAX's
    logits and leaves the cache unchanged.  The block start is an int or a
    one-element tensor (the graphed steps' form)."""
    model_j, model_t, params_j, params_t = models
    B, S, bs, L = 2, 64, 32, 16
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
        assert ct[name].dtype == (torch.float32 if name == "state"
                                  else model_t.cfg.torch_dtype)
        if name == "state" and on:
            mx_close(ct[name], cj[name], kv_format)
        else:
            _close(ct[name], cj[name])
    assert float(ct["state"].abs().max()) > 0
    before = {k: v.clone() for k, v in ct.items()}
    rj, _, _ = model_j.forward(params_j, tokens=jnp.asarray(toks[:, bs:]),
                               cache=cj, seg_start=jnp.int32(bs), baos_cfg=bj,
                               logits_slice=(0, L))
    rt, _ = model_t.forward(params_t, torch.from_numpy(toks[:, bs:]),
                            cache=ct, seg_start=start, baos_cfg=bt,
                            logits_slice=(0, L))
    _close(rt, rj)
    for name, t in ct.items():
        assert torch.equal(t, before[name]), name
    if not on:
        full, _ = model_t.forward(params_t, torch.from_numpy(toks))
        _close(rt, full[:, bs:bs + L], 2e-3, 2e-3)


def test_bridge_and_own_init_share_the_layout(models):
    """JAX's tree arrives leaf for leaf (A_log, D and dt_bias in f32); the
    port's seeded init gives the same tree of shapes and dtypes."""
    model_j, model_t, params_j, params_t = models
    tree = jax.tree.map(np.asarray, params_j)
    for i, lp in enumerate(params_t["layers"]):
        for name, leaf in tree["layers"].items():
            want = leaf["w"][i] if isinstance(leaf, dict) else leaf[i]
            np.testing.assert_array_equal(lp[name].numpy(), want)
    own = model_t.init(seed=1)
    for a, b in zip(own["layers"], params_t["layers"]):
        assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in b.items()}
    cache_j = jax.tree.map(np.asarray, model_j.init_cache(2, 32))
    cache_t = bridge.cache_from_numpy(cache_j, model_t.cfg, "cpu")
    own_cache = model_t.init_cache(2, 32)
    for name, t in own_cache.items():
        assert (t.shape, t.dtype) == (cache_t[name].shape,
                                      cache_t[name].dtype)


@pytest.mark.parametrize("cache_mode,jit_steps", [
    ("none", True), ("dual", True), ("prefix", True), ("dual", False)])
def test_generate_greedy_tokens_match(models, cache_mode, jit_steps):
    """Greedy tokens of generate() equal JAX's: B 2, prompt 32, gen 32,
    block 16, 4 steps; the cached modes with BAOS mxint8 on the state
    (tests/test_models.py's setting).  No near-tie shows on these seeds,
    so the check is exact."""
    model_j, model_t, params_j, params_t = models
    on = cache_mode != "none"
    kw = dict(gen_length=32, block_length=16, steps_per_block=4,
              cache_mode=cache_mode)
    dj = jdiff.DiffusionConfig(baos=jbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint8"),
                               **kw)
    dt = tdiff.DiffusionConfig(baos=tbaos.BAOSConfig(enabled=on,
                                                     kv_format="mxint8"),
                               **kw)
    prompt = _tokens(model_t.cfg, 2, 32, seed=5)
    want = jdiff.generate(model_j, params_j, jnp.asarray(prompt), dj,
                          rng=jax.random.PRNGKey(11))
    got = tdiff.generate(model_t, params_t, torch.from_numpy(prompt), dt,
                         seed=11, jit_steps=jit_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool((got == model_t.cfg.mask_id).any())


def _engine_trace(vocab):
    """Two requests share a two-page prompt (page 8); gens 8 and 16."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab - 2, size=(16,)).astype(np.int32)
    prompts = [shared, shared.copy(),
               rs.randint(0, vocab - 2, size=(12,)).astype(np.int32),
               rs.randint(0, vocab - 2, size=(8,)).astype(np.int32)]
    return [(p, 8 * (1 + i % 2)) for i, p in enumerate(prompts)]


def serve_trace(engine, make_request, trace):
    """Final tokens, per-request ticks, every CommitEvent and the tick
    count of a run of ``trace``."""
    events = []
    for prompt, gen in trace:
        engine.submit(make_request(prompt=prompt.copy(), gen_length=gen),
                      on_commit=events.append)
    engine.warmup()
    while engine.pending:
        if not engine.tick():
            break
    done = sorted(engine.completed, key=lambda c: c.uid)
    keys = [(e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
             e.done, tuple(int(p) for p in e.positions),
             tuple(int(t) for t in e.tokens)) for e in events]
    return ({c.uid: c.tokens.tolist() for c in done},
            {c.uid: c.ticks for c in done}, keys, engine.ticks_total)


def engine_matches_jax(models, mode, baos, megatick_k, pool):
    """The port's engine and JAX's on one trace (canvas 32, a multiple of
    the SSD chunk): equal outputs, and the paged run equal to the slot
    run."""
    model_j, model_t, params_j, params_t = models
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    bj = jbaos.BAOSConfig(**baos) if baos else jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(**baos) if baos else tbaos.BAOSConfig(enabled=False)
    dj = jdiff.DiffusionConfig(cache_mode="none", baos=bj, **kw)
    dt = tdiff.DiffusionConfig(baos=bt, **kw)
    base = dict(num_slots=2, max_seq_len=32, page_size=8, mode=mode,
                megatick_k=megatick_k)
    trace = _engine_trace(model_t.cfg.vocab)
    got = serve_trace(ServingEngine(model_t, params_t, dt,
                                    EngineConfig(pool=pool, seed=0, **base)),
                      Request, trace)
    want = serve_trace(JEngine(model_j, params_j, dj,
                               JEngineConfig(pool=pool,
                                             rng=jax.random.PRNGKey(0),
                                             **base)), JRequest, trace)
    assert got == want
    if pool == "paged":
        slot = serve_trace(ServingEngine(model_t, params_t, dt,
                                         EngineConfig(pool="slot", seed=0,
                                                      **base)),
                           Request, trace)
        assert got == slot
    for toks in got[0].values():
        assert model_t.cfg.mask_id not in toks


@pytest.mark.parametrize("pool", ["slot", "paged"])
@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("mode,baos", [
    ("none", None), ("warm", None), ("warm", dict(kv_format="mxint4"))],
    ids=["none", "warm", "warm+baos"])
def test_engine_matches_jax_engine(models, mode, baos, megatick_k, pool):
    """Final tokens, per-request ticks, every CommitEvent and the tick
    count equal the JAX engine's; the paged pool (which pages only the
    canvas: the SSM cache has no sequence axis) equals the slot pool."""
    engine_matches_jax(models, mode, baos, megatick_k, pool)


def test_paged_pool_has_no_paged_leaf(models):
    model_t = models[1]
    names, paged, axes = tdiff.paged_cache_layout(model_t, 8, 32)
    assert names == ["conv", "state"] and paged == [False, False]
    assert axes == [1, 1]
