"""The port's paged block pool (serving/cache_pool.PagedCachePool, the
paged tick and megatick of core/diffusion, EngineConfig(pool="paged"),
preemption) against the JAX package's, on the CPU at smoke size (llada-8b
smoke config, JAX parameters through ``bridge``), and against the port's
own slot pool.

Every comparison is exact: block tables, free lists, ``stats()``, canvas
and KV pages, spilled rows, greedy tokens, per-request tick counts and
CommitEvent keys (uid, tick, block/step, masks_left, done, positions,
tokens; ``now`` is wall clock and is not compared).  On the CPU the
graphed paths run eagerly: the CUDA graphs are exercised by
chip_smoke.py."""
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
from repro.serving.cache_pool import CachePool as JCachePool
from repro.serving.cache_pool import PagedCachePool as JPagedPool
from repro.serving.scheduler import FIFOPolicy as JFIFOPolicy
from repro.serving.scheduler import Policy as JPolicy
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.core import sampling as tsampling
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import (CachePool, EngineConfig, FIFOPolicy,
                                 PagedCachePool, Policy, Request,
                                 ServingEngine)

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


def _row(seed, n):
    return np.random.RandomState(seed).randint(
        0, 250, size=(n,)).astype(np.int32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# Layout probe, gather and scatter
# ---------------------------------------------------------------------------

def test_paged_cache_layout_matches_jax(models):
    model_j, model_t, _, _ = models
    _, flags_j, axes_j = jdiff.paged_cache_layout(model_j, 8, 32)
    names, flags_t, axes_t = tdiff.paged_cache_layout(model_t, 8, 32)
    assert names == sorted(model_j.init_cache(1, 8))
    assert (flags_t, axes_t) == (flags_j, axes_j)
    assert flags_t == [name in ("k", "v") for name in names]


class _Probe:
    """A model whose cache has one leaf of a given layout (JAX: jnp arrays;
    the port: tensors on the requested device)."""

    def __init__(self, shape_of, torch_side: bool):
        self.shape_of, self.torch_side = shape_of, torch_side

    def init_cache(self, batch, s, device=None):
        shape = self.shape_of(batch, s)
        if self.torch_side:
            return {"k": torch.zeros(shape, device=device)}
        return {"k": jnp.zeros(shape)}


@pytest.mark.parametrize("shape_of,match", [
    (lambda b, s: (2, 4, b, s), "supports"),        # seq at axis 3
    (lambda b, s: (2, s, 4), "batch axis")],        # no batch axis
    ids=["seq-axis-3", "no-batch-axis"])
def test_paged_cache_layout_rejects_what_jax_rejects(shape_of, match):
    for pkg, torch_side in ((jdiff, False), (tdiff, True)):
        with pytest.raises(ValueError, match=match):
            pkg.paged_cache_layout(_Probe(shape_of, torch_side), 4, 16)


# a (3, 4) table: rows 0 and 1 share prompt pages 1 and 2, row 0's tail
# and the idle row 2 sit on the null page 0
TABLE = np.array([[1, 2, 3, 0], [1, 2, 4, 5], [0, 0, 0, 0]], np.int32)
PRIVATE = (3, 4, 5)


def _private_positions(ps):
    """(row, column) of every dense position on a private page."""
    return [(b, r * ps + c) for b in range(TABLE.shape[0])
            for r in range(TABLE.shape[1]) if TABLE[b, r] in PRIVATE
            for c in range(ps)]


def test_gather_scatter_canvas_bit_equal_to_jax():
    rs = np.random.RandomState(0)
    ps = 4
    pages = rs.randint(0, 1000, size=(7, ps)).astype(np.int32)
    dense_j = np.asarray(jdiff.gather_canvas_rows(jnp.asarray(pages),
                                                  jnp.asarray(TABLE)))
    pages_t = torch.from_numpy(pages.copy())
    table_t = torch.from_numpy(TABLE).long()
    dense_t = tdiff.gather_canvas_rows(pages_t, table_t)
    np.testing.assert_array_equal(dense_t.numpy(), dense_j)
    out = torch.empty_like(dense_t)
    assert tdiff.gather_canvas_rows(pages_t, table_t, out=out) is out
    np.testing.assert_array_equal(out.numpy(), dense_j)
    # a tick commits on private pages only: shared and null pages get
    # their own gathered values back from every writer
    rows = dense_j.copy()
    for b, s in _private_positions(ps):
        rows[b, s] = rs.randint(1000, 2000)
    want = np.asarray(jdiff.scatter_canvas_rows(
        jnp.asarray(pages), jnp.asarray(TABLE), jnp.asarray(rows)))
    got = tdiff.scatter_canvas_rows(pages_t, table_t, torch.from_numpy(rows))
    assert got is pages_t
    np.testing.assert_array_equal(pages_t.numpy(), want)


def _store(rs, L=2, NP=7, ps=4, H=2, D=4, B=3):
    """A page store in the smoke cache's layout: k, v paged; the four
    calibration leaves per slot."""
    out = {}
    for name in ("k", "k_center", "k_scale", "v", "v_center", "v_scale"):
        shape = ((L, NP, ps, H, D) if name in ("k", "v")
                 else (L, B, 1, H, D))
        out[name] = rs.standard_normal(shape).astype(np.float32)
    return out


FLAGS = [True, False, False, True, False, False]       # sorted key order


@pytest.mark.parametrize("null_writers_differ", [False, True])
def test_gather_scatter_cache_bit_equal_to_jax(null_writers_differ):
    """Gather equal; scatter equal on every page but the null page when
    its writers differ (then an arbitrary writer wins: no valid position
    reads it), on every page when they agree."""
    rs = np.random.RandomState(1)
    ps = 4
    store = _store(rs)
    table_j, table_t = jnp.asarray(TABLE), torch.from_numpy(TABLE).long()
    dense_j = jdiff.gather_cache_rows(
        {n: jnp.asarray(a) for n, a in store.items()}, table_j, FLAGS)
    store_t = {n: torch.from_numpy(a.copy()) for n, a in store.items()}
    dense_t = tdiff.gather_cache_rows(store_t, table_t, FLAGS)
    for name in store:
        np.testing.assert_array_equal(dense_t[name].numpy(),
                                      np.asarray(dense_j[name]))
    out = {n: torch.zeros_like(t) for n, t in dense_t.items()}
    tdiff.gather_cache_rows(store_t, table_t, FLAGS, out=out)
    for name in store:
        np.testing.assert_array_equal(out[name].numpy(),
                                      dense_t[name].numpy())
        if not FLAGS[sorted(store).index(name)]:
            assert dense_t[name] is store_t[name]     # passed through

    new = {n: np.asarray(a).copy() for n, a in dense_j.items()}
    for name in ("k", "v"):
        for b, s in _private_positions(ps):
            new[name][:, b, s] = rs.standard_normal(new[name][:, b, s].shape)
        if null_writers_differ:
            new[name][:, 2] = rs.standard_normal(new[name][:, 2].shape)
    for name in ("k_center", "v_scale"):
        new[name] = rs.standard_normal(new[name].shape).astype(np.float32)
    want = jdiff.scatter_cache_rows(
        {n: jnp.asarray(a) for n, a in store.items()}, table_j,
        {n: jnp.asarray(a) for n, a in new.items()}, FLAGS)
    got = tdiff.scatter_cache_rows(
        store_t, table_t, {n: torch.from_numpy(a) for n, a in new.items()},
        FLAGS)
    assert got is store_t
    for name in store:
        w, g = np.asarray(want[name]), store_t[name].numpy()
        if null_writers_differ and name in ("k", "v"):
            w, g = w[:, 1:], g[:, 1:]
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The pool: the same calls give the same state in both packages
# ---------------------------------------------------------------------------

def _jax_pool(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 16)
    kw.setdefault("page_size", 4)
    return JPagedPool(None, with_cache=False, **kw)


def _torch_pool(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 16)
    kw.setdefault("page_size", 4)
    return PagedCachePool(None, with_cache=False, device="cpu", **kw)


def _snap(pool) -> dict:
    """The pool's whole observable state, after a flush."""
    pool.flush()
    return {"canvas_table": _np(pool._canvas_np).tolist(),
            "kv_table": _np(pool._kv_np).tolist(),
            "device_tables": (_np(pool.canvas_table).tolist(),
                              _np(pool.kv_table).tolist()),
            "free": list(pool._free),
            "free_canvas": list(pool._free_canvas),
            "free_kv": list(pool._free_kv),
            "stats": pool.stats(),
            "canvas_pages": _np(pool.canvas_pages).tolist()}


def _call(log, fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except (RuntimeError, ValueError) as e:
        log.append(("raises", type(e).__name__, str(e)))
        return None
    log.append(("returns", out if isinstance(out, (bool, int, tuple))
                else None))
    return out


def _pad(prompt, n):
    return np.concatenate([prompt, np.zeros(n, np.int32)])


def scenario_prefix_dedup(make, log):
    pool = make()
    row = _pad(_row(1, 8), 4)
    a, b = pool.acquire(), pool.acquire()
    pool.bind_row(a, row, prompt_len=8, total_len=12)
    log.append(_snap(pool))
    pool.bind_row(b, row, prompt_len=8, total_len=12)
    log.append(_snap(pool))


def scenario_cow_partial_page(make, log):
    pool = make()
    row = _pad(_row(2, 10), 6)                   # 2.5 pages of prompt
    a, b = pool.acquire(), pool.acquire()
    pool.bind_row(a, row, prompt_len=10, total_len=16)
    pool.bind_row(b, row, prompt_len=10, total_len=16)
    log.append(_snap(pool))


def scenario_lru_eviction(make, log):
    pool = make(num_slots=2, num_pages=5)        # 4 usable pages
    row1 = _pad(_row(3, 8), 4)
    s = pool.acquire()
    pool.bind_row(s, row1, prompt_len=8, total_len=12)
    pool.release(s)
    log.append(_snap(pool))
    s = pool.acquire()
    pool.bind_row(s, row1, prompt_len=8, total_len=12)   # a pure hit
    pool.release(s)
    log.append(_snap(pool))
    s = pool.acquire()
    pool.bind_row(s, _pad(_row(4, 8), 4), prompt_len=8, total_len=12)
    log.append(_snap(pool))                      # evicted the LRU pages
    s2 = pool.acquire()
    row3 = _pad(_row(5, 8), 4)
    _call(log, pool.can_admit, row3[:8], 12)
    _call(log, pool.bind_row, s2, row3, prompt_len=8, total_len=12)
    _call(log, pool.release, s2)
    _call(log, pool.release, s2)                 # double release
    log.append(_snap(pool))


def scenario_can_admit_projection(make, log):
    pool = make(num_slots=3, num_pages=5)
    row = _pad(_row(6, 8), 4)
    s = pool.acquire()
    pool.bind_row(s, row, prompt_len=8, total_len=12)
    cold = _pad(_row(7, 8), 4)
    for args in ((cold[:8], 12), (row[:8], 12), (row[:4], 12)):
        _call(log, pool.can_admit, *args)
        _call(log, pool.projected_pages, *args)
    log.append(_snap(pool))


def scenario_spill_restore(make, log):
    pool = make()
    row = np.concatenate([_row(8, 8), _row(9, 4)])
    other = _pad(_row(8, 8), 4)                  # shares the prompt
    s, t = pool.acquire(), pool.acquire()
    pool.bind_row(s, row, prompt_len=8, total_len=12)
    pool.bind_row(t, other, prompt_len=8, total_len=12)
    pool.flush()
    sp = pool.spill(s)
    sp.prompt_len = 8
    log.append(("spilled", sp.row.tolist(), sp.total_len))
    log.append(_snap(pool))
    _call(log, pool.can_restore, sp)
    s2 = pool.acquire()
    pool.restore(s2, sp)
    log.append(_snap(pool))
    pool.release(t)
    pool.release(s2)
    log.append(_snap(pool))


def scenario_validation(make, log):
    _call(log, make, max_seq_len=18)
    _call(log, make, page_size=1)
    _call(log, make, num_pages=1)
    p = make(num_slots=1)
    p.acquire()
    _call(log, p.acquire)


@pytest.mark.parametrize("scenario", [
    scenario_prefix_dedup, scenario_cow_partial_page, scenario_lru_eviction,
    scenario_can_admit_projection, scenario_spill_restore,
    scenario_validation], ids=lambda f: f.__name__[len("scenario_"):])
def test_pool_calls_match_jax(scenario):
    want, got = [], []
    scenario(_jax_pool, want)
    scenario(_torch_pool, got)
    assert got == want


def test_pool_with_cache_spill_restore_matches_jax(models):
    """KV pages and per-slot rows spill and restore as JAX's do, from one
    store state carried over by bridge.load_paged_pool."""
    model_j, model_t, _, _ = models
    kw = dict(page_size=4, mask_id=model_t.cfg.mask_id)
    pj = JPagedPool(model_j, 3, 16, **kw)
    pt = PagedCachePool(model_t, 3, 16, device="cpu", **kw)
    assert pt.cache["k_scale"].eq(1).all()       # per-slot init values
    rows = [_pad(_row(10, 8), 4), _pad(_row(10, 8), 8), _pad(_row(11, 6), 6)]
    for i, row in enumerate(rows):
        for pool in (pj, pt):
            slot = pool.acquire()
            pool.bind_row(slot, row, prompt_len=len(row) - 4 * (1 + i % 2),
                          total_len=len(row))
            pool.flush()
    rs = np.random.RandomState(2)
    store = {n: rs.standard_normal(np.asarray(a).shape).astype(np.float32)
             for n, a in pj.cache.items()}
    pj.cache = {n: jnp.asarray(a) for n, a in store.items()}
    bridge.load_paged_pool(pt, np.asarray(pj.canvas_pages),
                           pj._canvas_np, pj._kv_np, store)
    sj, st = pj.spill(1), pt.spill(1)
    np.testing.assert_array_equal(st.row, sj.row)
    names = sorted(store)
    kv_j = iter(sj.kv_pages)
    dense_j = iter(sj.slot_leaves)
    for name, paged in zip(names, pt._paged_flags):
        want = next(kv_j) if paged else next(dense_j)
        got = (st.kv_pages if paged else st.slot_leaves)[name]
        np.testing.assert_array_equal(got.numpy(), want)
    assert st.nbytes == sj.row.nbytes + sum(
        np.asarray(a).nbytes for a in list(sj.kv_pages) + sj.slot_leaves)
    for pool, sp in ((pj, sj), (pt, st)):
        sp.prompt_len = 8
        pool.restore(pool.acquire(), sp)
        pool.flush()
    assert _snap(pt) == _snap(pj)
    for name in names:
        np.testing.assert_array_equal(pt.cache[name].numpy(),
                                      np.asarray(pj.cache[name]))


def test_slot_pool_stats_and_zeroing_release_match_jax(models):
    model_j, model_t, _, _ = models
    pj, pt = JCachePool(model_j, 3, 16), CachePool(model_t, 3, 16)
    pj.cache = jax.tree.map(jnp.ones_like, pj.cache)
    for t in pt.cache.values():
        t.fill_(1)
    for pool in (pj, pt):
        a, b = pool.acquire(), pool.acquire()
        pool.release(a, zero=True)
        pool.release(b)
        with pytest.raises(ValueError, match="double"):
            pool.release(a)
        pool.acquire()
    assert pt.stats() == pj.stats()
    for name, t in pt.cache.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(pj.cache[name]))


def test_policy_preempt_default_is_none():
    for policy in (JPolicy(), JFIFOPolicy(), Policy(), FIFOPolicy()):
        assert policy.preempt([None], object(), 0.0) is None


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _trace(vocab):
    """Two requests share a two-page prompt (page 8); gens 8 and 16."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab - 2, size=(16,)).astype(np.int32)
    prompts = [shared, shared.copy(),
               rs.randint(0, vocab - 2, size=(12,)).astype(np.int32),
               rs.randint(0, vocab - 2, size=(8,)).astype(np.int32)]
    return [(p, 8 * (1 + i % 2)) for i, p in enumerate(prompts)]


def _key(e):
    return (e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
            e.done, tuple(int(p) for p in e.positions),
            tuple(int(t) for t in e.tokens))


def _dcfgs(baos):
    kw = dict(gen_length=16, block_length=8, steps_per_block=4)
    bj = jbaos.BAOSConfig(**baos) if baos else jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(**baos) if baos else tbaos.BAOSConfig(enabled=False)
    return (jdiff.DiffusionConfig(cache_mode="none", baos=bj, **kw),
            tdiff.DiffusionConfig(baos=bt, **kw))


def _serve(engine, make_request, trace, on_tick=None):
    events = []
    for prompt, gen, *arrival in trace:
        engine.submit(make_request(prompt=prompt.copy(), gen_length=gen,
                                   arrival_time=arrival[0] if arrival
                                   else 0.0),
                      on_commit=events.append)
    engine.warmup()
    ticks = 0
    while engine.pending:
        if not engine.tick():
            break
        ticks += 1
        if on_tick is not None:
            on_tick(engine, ticks)
    done = sorted(engine.completed, key=lambda c: c.uid)
    return ({c.uid: c.tokens.tolist() for c in done},
            {c.uid: c.ticks for c in done}, [_key(e) for e in events])


def _port(models, dcfg, **cfg):
    _, model_t, _, params_t = models
    base = dict(num_slots=2, max_seq_len=32, page_size=8, seed=0)
    base.update(cfg)
    return ServingEngine(model_t, params_t, dcfg, EngineConfig(**base))


def _jax(models, dcfg, **cfg):
    model_j, _, params_j, _ = models
    base = dict(num_slots=2, max_seq_len=32, page_size=8,
                rng=jax.random.PRNGKey(0))
    base.update(cfg)
    return JEngine(model_j, params_j, dcfg, JEngineConfig(**base))


@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("mode,baos", [
    ("none", None), ("warm", None), ("warm", dict(kv_format="mxint4"))],
    ids=["none", "warm", "warm+baos"])
def test_paged_engine_matches_jax_and_slot_pool(models, mode, baos,
                                                megatick_k):
    dj, dt = _dcfgs(baos)
    trace = _trace(models[1].cfg.vocab)
    kw = dict(mode=mode, megatick_k=megatick_k)
    eng = _port(models, dt, pool="paged", **kw)
    paged = _serve(eng, Request, trace)
    jax_paged = _serve(_jax(models, dj, pool="paged", **kw), JRequest, trace)
    slot = _serve(_port(models, dt, pool="slot", **kw), Request, trace)
    assert paged == jax_paged
    assert paged == slot
    st = eng.pool.stats()
    assert st["prefix_hits"] == 2 and st["in_use"] == 0
    assert eng.metrics.summary()["stage_paged_io_s"] > 0
    for toks in paged[0].values():
        assert models[1].cfg.mask_id not in toks


def test_paged_engine_under_quant_policy_matches_slot_pool(models):
    _, dt = _dcfgs(None)
    trace = _trace(models[1].cfg.vocab)[:2]
    kw = dict(mode="warm", fwd_kw={"quant": tlayers.QuantPolicy(True)})
    assert (_serve(_port(models, dt, pool="paged", **kw), Request, trace)
            == _serve(_port(models, dt, pool="slot", **kw), Request, trace))


@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("sampling", [
    dict(strategy="random"), dict(fmt="mxint4"),
    dict(fmt="mxfp4_e2m1", strategy="random")],
    ids=["random", "mxint4", "mxfp4-random"])
def test_paged_engine_sampling_options_match_slot_pool(models, sampling,
                                                       megatick_k):
    """The random strategy and formats new to the sampling kernels on the
    paged pool (warm, K=1 and the megatick): tokens, ticks and
    CommitEvents equal the slot pool's, with no mask id left."""
    _, dt = _dcfgs(None)
    dt = dataclasses.replace(dt, sampling=tsampling.SamplingConfig(
        **sampling))
    trace = _trace(models[1].cfg.vocab)
    kw = dict(mode="warm", megatick_k=megatick_k)
    paged = _serve(_port(models, dt, pool="paged", **kw), Request, trace)
    assert paged == _serve(_port(models, dt, pool="slot", **kw), Request,
                           trace)
    for toks in paged[0].values():
        assert models[1].cfg.mask_id not in toks


def test_admission_waits_for_pages(models):
    """3 requests, 3 slots, pages for 2 rows: at most 2 run at once, all
    complete, as in the JAX engine."""
    dj, dt = _dcfgs(None)
    rs = np.random.RandomState(3)
    trace = [(rs.randint(0, 250, size=(8,)).astype(np.int32), 8)
             for _ in range(3)]
    kw = dict(num_slots=3, max_seq_len=16, mode="none", pool="paged",
              num_pages=5)
    eng = _port(models, dt, **kw)
    jeng = _jax(models, dj, **kw)
    assert _serve(eng, Request, trace) == _serve(jeng, JRequest, trace)
    assert eng.pool.peak_in_use == 2
    assert eng.pool.stats() == jeng.pool.stats()
    assert eng.pool.stats()["pages_in_use"] == eng.pool.cached_pages


def _preempt_last_at(tick_no):
    def on_tick(engine, ticks):
        if ticks == tick_no:
            live = [s.request.uid for s in engine.slots if s is not None]
            assert engine.preempt(live[-1])
            assert engine.pending == 3           # two queued + the spilled
    return on_tick


@pytest.mark.parametrize("baos", [None, dict(kv_format="mxint4")],
                         ids=["warm", "warm+baos"])
def test_preempt_restore_bit_exact(models, baos):
    """preempt(uid) mid-block spills a live request (canvas row, KV
    pages, calibration rows); it restores at the next admission, so its
    tokens and every CommitEvent equal the uninterrupted run's, and the
    JAX engine's under the same preemption."""
    dj, dt = _dcfgs(baos)
    trace = [(p, 16) for p, _ in _trace(models[1].cfg.vocab)[:3]]
    kw = dict(mode="warm", pool="paged")
    base = _serve(_port(models, dt, **kw), Request, trace)
    eng = _port(models, dt, **kw)
    pre = _serve(eng, Request, trace, on_tick=_preempt_last_at(2))
    jeng = _jax(models, dj, **kw)
    assert pre == _serve(jeng, JRequest, trace, on_tick=_preempt_last_at(2))
    assert pre == base
    assert eng.pool.stats() == jeng.pool.stats()
    assert (eng.pool.stats()["preemptions"],
            eng.pool.stats()["restores"]) == (1, 1)


class _PreemptOnce:
    """Spill the slot of the newest admitted request, once, when a request
    is page-blocked."""

    def preempt(self, slots, incoming, now):
        if self.fired:
            return None
        live = [(s.request.uid, i) for i, s in enumerate(slots)
                if s is not None]
        self.fired = True
        return max(live)[1] if live else None


class _JPolicy(_PreemptOnce, JFIFOPolicy):
    fired = False


class _TPolicy(_PreemptOnce, FIFOPolicy):
    fired = False


def test_policy_preempt_hook_matches_jax(models):
    """Pages for 2 rows, 3 slots: the third request arrives after the
    first tick and is page-blocked, the policy spills the newest request
    (one tick into its first block) for it, and the spilled one restores
    when pages free up.  Tokens equal an unpreempted run's; tokens,
    events and pool stats equal the JAX engine's."""
    dj, dt = _dcfgs(None)
    rs = np.random.RandomState(4)
    trace = [(rs.randint(0, 250, size=(8,)).astype(np.int32), 16, t)
             for t in (0.0, 0.0, 1e-9)]
    kw = dict(num_slots=3, max_seq_len=24, mode="warm", pool="paged",
              num_pages=7)
    eng = _port(models, dt, policy=_TPolicy(), **kw)
    jeng = _jax(models, dj, policy=_JPolicy(), **kw)
    got = _serve(eng, Request, trace)
    assert got == _serve(jeng, JRequest, trace)
    assert eng.pool.stats() == jeng.pool.stats()
    assert eng.pool.stats()["preemptions"] == 1
    base = _serve(_port(models, dt, **kw), Request, trace)
    assert got[0] == base[0]


def test_null_kv_page_is_never_read(models):
    """A large finite value in page 0 of every KV store before the first
    tick changes no token (a NaN would leak through P.V even at P = 0)."""
    _, dt = _dcfgs(dict(kv_format="mxint4"))
    trace = _trace(models[1].cfg.vocab)

    def poison(engine, ticks):
        if ticks == 0:
            for name in ("k", "v"):
                engine.pool.cache[name][:, 0] = 1e4

    def run(sentinel):
        eng = _port(models, dt, mode="warm", pool="paged")
        events = []
        for prompt, gen in trace:
            eng.submit(Request(prompt=prompt, gen_length=gen),
                       on_commit=events.append)
        eng.warmup()
        if sentinel:
            poison(eng, 0)
        eng.run()
        return ({c.uid: c.tokens.tolist() for c in eng.completed},
                [_key(e) for e in events])

    assert run(True) == run(False)


def test_preempt_requires_the_paged_pool(models):
    _, dt = _dcfgs(None)
    eng = _port(models, dt, mode="none")
    with pytest.raises(RuntimeError, match="paged"):
        eng.preempt(1)
    peng = _port(models, dt, mode="none", pool="paged")
    assert peng.preempt(1) is False              # unknown uid


@pytest.mark.parametrize("option,error", [
    (dict(pool="bogus"), ValueError),
    (dict(pool="paged", breakdown=True), ValueError),
    (dict(pool="paged", fwd_kw={"extra": 1}), ValueError),
    (dict(pool="paged", max_seq_len=36), ValueError),
    # a mesh shape is not a launch/mesh.Mesh (the paged pool runs under
    # one: tests/test_torch_paged_mesh.py)
    (dict(pool="paged", mesh=tmesh.make_production_mesh()), TypeError)],
    ids=["unknown-pool", "breakdown", "fwd-kw", "page-multiple", "mesh"])
def test_paged_engine_validation(models, option, error):
    _, dt = _dcfgs(None)
    with pytest.raises(error):
        _port(models, dt, **option)
