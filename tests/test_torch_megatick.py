"""The port's megatick and graphed-tick engine (core/diffusion
get_megatick_fn, EngineConfig(megatick_k, jit_steps)) against its own
K=1 engine and against the JAX package's megatick, on the CPU (llada-8b
smoke config, JAX parameters through ``bridge``): the non-mesh cases of
tests/test_megatick.py.

Greedy tokens, per-request tick counts, CommitEvent keys (uid, tick,
block/step, masks_left, done, positions, tokens; ``now`` is wall clock and
is not compared) and ``ticks_total`` are exact.  Buffer confidences are
compared with rtol 1e-5: the port's Stable-Max sums in another order than
XLA's (tests/test_torch_sampling.py uses the same tolerance).  On the CPU
every step runs eagerly: the CUDA graphs are exercised by chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.scheduler import SlowFastPolicy as JSlowFast
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsampling
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import (EngineConfig, Policy, Request,
                                 ServingEngine, SlowFastPolicy)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config("llada-8b", smoke=True)
    cfg_t = tbase.get_config("llada-8b", smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _dcfg(pkg, **kw):
    base = dict(gen_length=16, block_length=8, steps_per_block=4,
                cache_mode="none")
    base.update(kw)
    return pkg.DiffusionConfig(**base)


def _prompts(vocab, n=4, prompt_len=8, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab - 2, size=(prompt_len,)).astype(np.int32)
            for _ in range(n)]


def _key(e):
    return (e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
            e.done, tuple(int(p) for p in e.positions),
            tuple(int(t) for t in e.tokens))


def _run_port(models, mode="none", dcfg=None, n=4, sinks=True, **cfg_kw):
    _, model_t, _, params_t = models
    eng = ServingEngine(model_t, params_t, dcfg or _dcfg(tdiff),
                        EngineConfig(num_slots=2, max_seq_len=24, mode=mode,
                                     seed=7, **cfg_kw))
    events = []
    for p in _prompts(model_t.cfg.vocab, n):
        eng.submit(Request(prompt=p, gen_length=16),
                   on_commit=events.append if sinks else None)
    eng.warmup()
    done = sorted(eng.run(), key=lambda c: c.uid)
    return eng, done, [_key(e) for e in events]


def _run_jax(models, mode="none", n=4, sinks=True, policy=None, **cfg_kw):
    model_j, model_t, params_j, _ = models
    eng = JEngine(model_j, params_j, _dcfg(jdiff),
                  JEngineConfig(num_slots=2, max_seq_len=24, mode=mode,
                                policy=policy, rng=jax.random.PRNGKey(7),
                                **cfg_kw))
    events = []
    for p in _prompts(model_t.cfg.vocab, n):
        eng.submit(JRequest(prompt=p, gen_length=16),
                   on_commit=events.append if sinks else None)
    eng.warmup()
    done = sorted(eng.run(), key=lambda c: c.uid)
    return eng, done, [_key(e) for e in events]


def _same(a, b):
    eng_a, done_a, ev_a = a
    eng_b, done_b, ev_b = b
    assert [c.tokens.tolist() for c in done_a] == \
        [np.asarray(c.tokens).tolist() for c in done_b]
    assert [c.ticks for c in done_a] == [c.ticks for c in done_b]
    assert ev_a == ev_b
    assert eng_a.ticks_total == eng_b.ticks_total


@pytest.mark.parametrize("megatick_k", [1, 2, 8])
@pytest.mark.parametrize("mode", ["none", "warm"])
def test_engine_megatick_matches_k1_and_jax(models, mode, megatick_k):
    ref = _run_port(models, mode, jit_steps=False)
    out = _run_port(models, mode, megatick_k=megatick_k)
    _same(out, ref)
    _same(out, _run_jax(models, mode, megatick_k=megatick_k))
    if megatick_k > 1:
        assert out[0].host_syncs_elided > ref[0].host_syncs_elided
        assert out[0].host_waits < ref[0].host_waits


def test_slowfast_early_exit_partial_megastep(models):
    """SlowFast (threshold 0: fire on every tick after the first of a
    block) inside a megastep: fewer ticks than the schedule, the same
    early exits, tokens and events as K=1 and as the JAX megatick."""
    ref = _run_port(models, policy=SlowFastPolicy(threshold=0.0))
    out = _run_port(models, policy=SlowFastPolicy(threshold=0.0),
                    megatick_k=4)
    _same(out, ref)
    jax_out = _run_jax(models, policy=JSlowFast(threshold=0.0),
                       megatick_k=4)
    _same(out, jax_out)
    assert out[0].policy.early_exits == ref[0].policy.early_exits == \
        jax_out[0].policy.early_exits > 0
    ticks = [e[1] for e in out[2]]
    assert sorted(set(ticks)) == list(range(min(ticks), max(ticks) + 1))
    assert out[0].ticks_total < (16 // 8) * 4 * len(out[1]) // 2


def test_host_syncs_elided_without_sinks(models):
    """K=1 without sinks skips the canvas fetch on every tick but the last
    (both requests release together); as in JAX."""
    eng, done, ev = _run_port(models, n=2, sinks=False)
    jeng, _, _ = _run_jax(models, n=2, sinks=False)
    assert not ev
    assert eng.host_syncs_elided == eng.ticks_total - 1 > 0
    assert eng.host_syncs_elided == jeng.host_syncs_elided
    assert all((c.tokens[c.prompt_len:] != models[1].cfg.mask_id).all()
               for c in done)


@pytest.mark.parametrize("sinks", [False, True])
def test_megastep_sync_accounting(models, sinks):
    """An n-tick megastep elides n - 1 syncs, and the buffer canvas fetch
    too when no sink reads it; the counts equal JAX's."""
    eng, _, _ = _run_port(models, n=2, sinks=sinks, megatick_k=8)
    jeng, _, _ = _run_jax(models, n=2, sinks=sinks, megatick_k=8)
    assert eng.host_syncs_elided == jeng.host_syncs_elided
    if sinks:
        assert 0 < eng.host_syncs_elided < eng.ticks_total
    else:
        assert eng.host_syncs_elided == eng.ticks_total


def test_tick_max_ticks_caps_megastep(models):
    _, model_t, _, params_t = models
    eng = ServingEngine(model_t, params_t, _dcfg(tdiff),
                        EngineConfig(num_slots=2, max_seq_len=24,
                                     mode="none", megatick_k=8))
    eng.submit(Request(prompt=_prompts(model_t.cfg.vocab, 1)[0],
                       gen_length=16))
    eng.warmup()
    eng.tick(max_ticks=3)
    assert eng.ticks_total == 3
    eng.tick()
    assert eng.ticks_total == 8
    assert not eng.pending


def test_megatick_rejects_incompatible_configs(models):
    _, model_t, _, params_t = models

    def make(**kw):
        return ServingEngine(model_t, params_t, _dcfg(tdiff),
                             EngineConfig(num_slots=2, max_seq_len=24, **kw))

    with pytest.raises(ValueError):
        make(megatick_k=0)
    with pytest.raises(ValueError):   # per-stage timing needs 2 dispatches
        make(megatick_k=4, breakdown=True)

    class WeirdPolicy(Policy):
        name = "weird"

        def step_k(self, slot, default_k):
            return default_k

    with pytest.raises(ValueError):   # a host step_k can't run on device
        make(megatick_k=4, policy=WeirdPolicy())
    eng = make(megatick_k=4, policy=SlowFastPolicy(threshold=0.5))
    assert eng._sf_threshold == 0.5
    prompt = _prompts(model_t.cfg.vocab, 1)[0]
    with pytest.raises(ValueError):   # per-request policy must match
        eng.submit(Request(prompt=prompt, gen_length=16, policy="fifo"))
    eng.submit(Request(prompt=prompt, gen_length=16, policy="slowfast",
                       policy_params=dict(threshold=0.5)))


def test_megatick_state_defaults():
    st = tdiff.megatick_state(np.array([3, 5]), np.array([2, 2]),
                              _dcfg(tdiff))
    js = jdiff.megatick_state(np.array([3, 5]), np.array([2, 2]),
                              _dcfg(jdiff))
    assert set(st) == set(js)
    for name, t in st.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(js[name]))
        assert t.numpy().dtype == np.asarray(js[name]).dtype, name
    assert st["block_masks_left"].tolist() == [8, 8]
    assert st["active"].tolist() == [True, True]


@pytest.mark.parametrize("megatick_k", [2, 4, 8])
def test_generate_megatick_matches_k1_and_jax(models, megatick_k):
    model_j, model_t, params_j, params_t = models
    prompt = np.stack(_prompts(model_t.cfg.vocab, 2, seed=3))
    ref = tdiff.generate(model_t, params_t, torch.from_numpy(prompt),
                         _dcfg(tdiff), seed=5)
    out = tdiff.generate(model_t, params_t, torch.from_numpy(prompt),
                         _dcfg(tdiff), seed=5, megatick_k=megatick_k)
    jout = jdiff.generate(model_j, params_j, jnp.asarray(prompt),
                          _dcfg(jdiff), rng=jax.random.PRNGKey(5),
                          megatick_k=megatick_k)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_generate_megatick_sampled_matches_k1(models):
    """At temperature 0.8 the megatick draws the per-step path's
    tick_seed stream (from the device tick counter), so sampled tokens
    equal K=1's."""
    _, model_t, _, params_t = models
    dcfg = _dcfg(tdiff)
    dcfg = dataclasses.replace(dcfg, sampling=dataclasses.replace(
        dcfg.sampling, temperature=0.8))
    prompt = torch.from_numpy(np.stack(_prompts(model_t.cfg.vocab, 2)))
    ref = tdiff.generate(model_t, params_t, prompt, dcfg, seed=11)
    out = tdiff.generate(model_t, params_t, prompt, dcfg, seed=11,
                         megatick_k=4)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("cache_mode", ["dual", "prefix"])
def test_generate_megatick_requires_cache_mode_none(models, cache_mode):
    _, model_t, _, params_t = models
    prompt = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cache_mode='none'"):
        tdiff.generate(model_t, params_t, prompt,
                       _dcfg(tdiff, cache_mode=cache_mode), megatick_k=4)


@pytest.mark.parametrize("variant", ["baos", "unfused"])
def test_warm_megatick_variants_equal_k1(models, variant):
    """warm + BAOS (every tick recalibrates and writes the mxint4 cache)
    and warm on the unfused head: K=4 equals K=1."""
    kw = (dict(baos=tbaos.BAOSConfig(kv_format="mxint4"))
          if variant == "baos" else dict(head_path="unfused"))
    dcfg = _dcfg(tdiff, **kw)
    ref = _run_port(models, "warm", dcfg, jit_steps=False)
    out = _run_port(models, "warm", dcfg, megatick_k=4)
    _same(out, ref)


@pytest.mark.parametrize("fmt", ["mxfp8_e4m3", "mxint4"])
@pytest.mark.parametrize("mode", ["none", "warm"])
def test_random_strategy_megatick_equals_k1(models, mode, fmt):
    """strategy='random': the megatick (K=4) gives the K=1 engine's
    tokens, per-request ticks, CommitEvents and ticks_total: tick j draws
    from tick_seed(seed, tick + j) in both, the megatick counting ticks on
    the device.  generate(megatick_k=4) equals generate too."""
    _, model_t, _, params_t = models
    dcfg = _dcfg(tdiff, sampling=tsampling.SamplingConfig(
        strategy="random", fmt=fmt))
    ref = _run_port(models, mode, dcfg, jit_steps=False)
    _same(_run_port(models, mode, dcfg, megatick_k=4), ref)
    for c in ref[1]:
        assert not bool((c.tokens == model_t.cfg.mask_id).any())
    if mode == "none":
        prompt = torch.from_numpy(np.stack(_prompts(model_t.cfg.vocab, 2)))
        one = tdiff.generate(model_t, params_t, prompt, dcfg, seed=4)
        four = tdiff.generate(model_t, params_t, prompt, dcfg, seed=4,
                              megatick_k=4)
        assert torch.equal(one, four)


def _megatick_inputs(model_t, B=3, S=48):
    """Three rows at prompt offsets 8, 16, 12 with 2, 1, 2 blocks of 8."""
    rs = np.random.RandomState(1)
    x = np.full((B, S), model_t.cfg.mask_id, np.int32)
    pl = np.array([8, 16, 12], np.int32)
    gb = np.array([2, 1, 2], np.int32)
    for i in range(B):
        x[i, :pl[i]] = rs.randint(0, model_t.cfg.vocab - 2, size=pl[i])
    valid = np.arange(S)[None, :] < (pl + 8 * gb)[:, None]
    return x, valid, pl, gb


@pytest.mark.parametrize("stop_on_release", [False, True])
def test_megatick_buffers_match_jax(models, stop_on_release):
    """One megastep over rows at different offsets and block counts: the
    tick count and every buffer row equal the JAX loop's."""
    model_j, model_t, params_j, params_t = models
    x, valid, pl, gb = _megatick_inputs(model_t)
    fn = tdiff.get_megatick_fn(model_t, _dcfg(tdiff), model_t.cfg.mask_id, 8)
    st = tdiff.megatick_state(pl, gb, _dcfg(tdiff))
    xt, _, tick, _, bufs, n = fn(params_t, torch.from_numpy(x.copy()),
                                 torch.from_numpy(valid), st, 0, 7,
                                 stop_on_release)
    jfn = jdiff.get_megatick_fn(model_j, _dcfg(jdiff), model_t.cfg.mask_id,
                                8)
    jx, _, _, _, jbufs, jn = jfn(
        params_j, jnp.asarray(x), jnp.asarray(valid),
        jdiff.megatick_state(pl, gb, _dcfg(jdiff)), jax.random.PRNGKey(0),
        jnp.int32(7), jnp.asarray(stop_on_release))
    assert n == int(jn) and tick == n
    assert n == (4 if stop_on_release else 7)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jx))
    for name, buf in bufs.items():
        want = np.asarray(jbufs[name])
        if name == "conf":
            np.testing.assert_allclose(buf.numpy(), want, rtol=1e-5)
        else:
            np.testing.assert_array_equal(buf.numpy(), want, err_msg=name)


@pytest.mark.parametrize("variant", ["none", "warm", "warm+baos",
                                     "none+random"])
def test_stopped_tick_changes_nothing(models, variant):
    """A predicated tick run after the loop stopped (what the graphed
    megastep may enqueue once) leaves the canvas, the per-row state, the
    counters and the buffers as they were, under the random strategy too
    (every row gets k = 0, so its draw selects nothing); in warm mode it
    rewrites the K/V from the unchanged canvas, and doing so again (BAOS
    recalibration included) gives the same cache bit for bit."""
    _, model_t, _, params_t = models
    kw = (dict(baos=tbaos.BAOSConfig(kv_format="mxint4"))
          if variant == "warm+baos" else {})
    if variant == "none+random":
        kw = dict(sampling=tsampling.SamplingConfig(strategy="random"))
    dcfg = _dcfg(tdiff, **kw)
    x, valid, pl, gb = _megatick_inputs(model_t)
    cache = (model_t.init_cache(x.shape[0], x.shape[1])
             if variant.startswith("warm") else None)
    fn = tdiff.get_megatick_fn(model_t, dcfg, model_t.cfg.mask_id, 4)
    xt = torch.from_numpy(x.copy())
    vt = torch.from_numpy(valid)
    fn(params_t, xt, vt, tdiff.megatick_state(pl, gb, dcfg), 0, 4, True,
       cache)
    c = fn._carry_for(xt)
    assert bool(c["scalars"]["stop"][0])       # a row released at tick 4
    args = (params_t, xt, vt, cache, c["scalars"], c["state"], c["bufs"],
            c["ksched"])

    def snapshot():
        return [t.clone() for t in [xt, *c["scalars"].values(),
                                    *c["state"].values(),
                                    *c["bufs"].values()]]

    before = snapshot()
    fn._tick(*args)
    cache_once = None if cache is None else {k: v.clone()
                                             for k, v in cache.items()}
    fn._tick(*args)
    for a, b in zip(before, snapshot()):
        assert torch.equal(a, b)
    if cache is not None:
        for name, t in cache.items():
            assert torch.equal(t, cache_once[name]), name
