"""The port engine's observability hooks and breakdown mode against the JAX
engine's, on the CPU at smoke size (llada-8b, parameters carried across
by ``bridge.params_from_numpy``).

On the same trace (slot and paged pools, K 1 and 4, with and without
preemption, one ``cancel(uid, reason)``) the event logs are equal record
for record without their time fields, the lifecycle counters of the
``/metrics`` exposition are equal, and so are the stage names of every
tick.  Breakdown (``EngineConfig(breakdown=True)``) gives the tokens and
CommitEvents of the plain engine and of the JAX breakdown engine, eager
and with ``jit_steps``; obs off and on give the same tokens, CommitEvents
and host waits."""
import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jbase
from repro.core import baos as jbaos
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.scheduler import FIFOPolicy as JFIFOPolicy
from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.core import baos as tbaos
from repro_torch.core import diffusion as tdiff
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving.scheduler import FIFOPolicy

torch.set_num_threads(1)

# fields of an event record that read a clock
TIME_FIELDS = ("ts", "t", "queue_wait_s", "latency_s", "ttft_s",
               "violations")
# /metrics series that count work (not time)
COUNTERS = ("dllm_requests_total", "dllm_tokens_committed_total",
            "dllm_blocks_committed_total", "dllm_ticks_total",
            "dllm_kv_valid_uploads_total", "dllm_host_syncs_elided_total",
            "dllm_megasteps_total", "dllm_megastep_ticks_count",
            "dllm_megastep_ticks_sum", "dllm_requests_by_policy_total",
            "dllm_preemptions_total", "dllm_prefix_pages_total",
            "dllm_page_evictions_total", "dllm_policy_early_exits_total",
            "dllm_slo_requests_total", "dllm_slo_tokens_total",
            "dllm_tick_stage_seconds_count", "dllm_tick_seconds_count",
            "dllm_queue_wait_seconds_count", "dllm_ttft_seconds_count",
            "dllm_request_latency_seconds_count", "dllm_pool_pages",
            "dllm_active_slots", "dllm_queue_depth")


@pytest.fixture(scope="module")
def models():
    cfg_j = jbase.get_config("llada-8b", smoke=True)
    cfg_t = tbase.get_config("llada-8b", smoke=True)
    model_j, model_t = jbuild(cfg_j), tbuild(cfg_t, "cpu")
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, "cpu")
    return model_j, model_t, params_j, params_t


def _dcfgs(baos=None, **kw):
    kw = dict(gen_length=16, block_length=8, steps_per_block=4, **kw)
    bj = jbaos.BAOSConfig(**baos) if baos else jbaos.BAOSConfig(enabled=False)
    bt = tbaos.BAOSConfig(**baos) if baos else tbaos.BAOSConfig(enabled=False)
    return (jdiff.DiffusionConfig(cache_mode="none", baos=bj, **kw),
            tdiff.DiffusionConfig(baos=bt, **kw))


class _PreemptOnce:
    """Spill the newest admitted request's slot, once, when a request is
    page-blocked."""
    fired = False

    def preempt(self, slots, incoming, now):
        if self.fired:
            return None
        live = [(s.request.uid, i) for i, s in enumerate(slots)
                if s is not None]
        self.fired = True
        return max(live)[1] if live else None


class _JPreempt(_PreemptOnce, JFIFOPolicy):
    pass


class _TPreempt(_PreemptOnce, FIFOPolicy):
    pass


def _trace(vocab):
    """(prompt, gen, arrival, slo_class, trace id, streamed): three
    requests, the third arriving just after the first tick (page-blocked
    on the small paged pool), and one that never arrives (cancelled)."""
    rs = np.random.RandomState(4)
    rows = []
    for i, (at, cls) in enumerate(((0.0, "interactive"), (0.0, "standard"),
                                   (1e-9, "batch"), (1e9, "standard"))):
        rows.append((rs.randint(0, vocab - 2, size=(8,)).astype(np.int32),
                     16, at, cls, f"{i + 1:032x}", i % 2 == 0))
    return rows


def _obs(pkg, tick_keys):
    """A ServingObs with an in-memory event log whose tick hook records
    each tick's stage names."""
    root = pkg.ServingObs()
    root.set_event_log(pkg.EventLog(autoflush=False))
    rep = root.for_replica("replica-0")
    tick = rep.tick

    def recording_tick(stages, *args, **kw):
        tick_keys.append(tuple(sorted(stages)))
        return tick(stages, *args, **kw)

    rep.tick = recording_tick
    return root, rep


def _serve_obs(engine, make_request, trace, root):
    events = []
    uids = []
    for prompt, gen, at, cls, tid, streamed in trace:
        uids.append(engine.submit(
            make_request(prompt=prompt.copy(), gen_length=gen,
                         arrival_time=at, slo_class=cls, trace_id=tid),
            on_commit=events.append if streamed else None))
    assert engine.cancel(uids[-1], reason="deadline")
    assert not engine.cancel(uids[-1])
    engine.warmup()
    engine.run()
    records = [{k: v for k, v in r.items() if k not in TIME_FIELDS}
               for r in root.events.tail()]
    for r in records:
        for key in ("positions", "tokens"):        # arrays in commits
            if isinstance(r.get(key), (list, np.ndarray)):
                r[key] = [int(x) for x in r[key]]
    parsed = jobs.parse_exposition(root.registry.expose())
    counters = {name: parsed.get(name, {}) for name in COUNTERS}
    done = {c.uid: c.tokens.tolist() for c in engine.completed}
    keys = [(e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
             e.done, [int(p) for p in e.positions],
             [int(t) for t in e.tokens]) for e in events]
    return records, counters, done, keys


@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("pool,preempt", [("slot", False),
                                          ("paged", False),
                                          ("paged", True)],
                         ids=["slot", "paged", "paged-preempt"])
def test_event_log_counters_and_stages_equal_jax(models, pool, preempt,
                                                 megatick_k):
    model_j, model_t, params_j, params_t = models
    dj, dt = _dcfgs()
    kw = dict(mode="warm" if preempt else "none", megatick_k=megatick_k,
              pool=pool, max_seq_len=24)
    if pool == "paged":
        kw.update(page_size=8, num_slots=3,
                  num_pages=7 if preempt else 10)
    else:
        kw.update(num_slots=2)
    trace = _trace(model_t.cfg.vocab)
    jkeys, tkeys = [], []
    jroot, jrep = _obs(jobs, jkeys)
    troot, trep = _obs(tobs, tkeys)
    jeng = JEngine(model_j, params_j, dj, JEngineConfig(
        rng=jax.random.PRNGKey(0), obs=jrep,
        policy=_JPreempt() if preempt else None, **kw))
    teng = ServingEngine(model_t, params_t, dt, EngineConfig(
        obs=trep, policy=_TPreempt() if preempt else None, **kw))
    jout = _serve_obs(jeng, JRequest, trace, jroot)
    tout = _serve_obs(teng, Request, trace, troot)
    assert tout[2] == jout[2]                       # tokens
    assert tout[3] == jout[3]                       # CommitEvents
    assert tout[0] == jout[0]                       # event log records
    assert tout[1] == jout[1]                       # lifecycle counters
    assert tkeys == jkeys                           # stage names per tick
    want = {"host_prep", "dispatch", "device_sync", "commit"}
    if pool == "paged":
        want.add("paged_io")
    assert set(tkeys) == {tuple(sorted(want))}
    events = [r["event"] for r in tout[0]]
    assert events.count("shed") == 1
    assert ("preempt" in events) == ("restore" in events) == preempt
    tobs.validate_events(troot.events.tail(), require_terminal=True)
    assert teng.kv_valid_uploads == jeng.kv_valid_uploads


def _run(engine, make_request, trace):
    events = []
    for prompt, gen in trace:
        engine.submit(make_request(prompt=prompt.copy(), gen_length=gen),
                      on_commit=events.append)
    engine.warmup()
    engine.run()
    keys = [(e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
             e.done, [int(p) for p in e.positions],
             [int(t) for t in e.tokens]) for e in events]
    return ({c.uid: c.tokens.tolist() for c in engine.completed}, keys,
            engine.ticks_total)


def _short_trace(vocab):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab - 2, size=(8 + 4 * i,)).astype(np.int32),
             8 * (1 + i % 2)) for i in range(3)]


@pytest.mark.parametrize("jit_steps", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("mode,baos,head_path", [
    ("warm", None, "fused"), ("warm", dict(kv_format="mxint4"), "fused"),
    ("none", None, "legacy")], ids=["warm", "warm+baos", "legacy"])
def test_breakdown_equals_plain_and_jax_breakdown(models, mode, baos,
                                                  head_path, jit_steps):
    model_j, model_t, params_j, params_t = models
    dj, dt = _dcfgs(baos, head_path=head_path)
    trace = _short_trace(model_t.cfg.vocab)
    kw = dict(num_slots=2, max_seq_len=32, mode=mode, jit_steps=jit_steps)
    tkeys = []
    _, trep = _obs(tobs, tkeys)
    bd = ServingEngine(model_t, params_t, dt,
                       EngineConfig(breakdown=True, obs=trep, **kw))
    got = _run(bd, Request, trace)
    plain = _run(ServingEngine(model_t, params_t, dt, EngineConfig(**kw)),
                 Request, trace)
    jbd = _run(JEngine(model_j, params_j, dj, JEngineConfig(
        breakdown=True, rng=jax.random.PRNGKey(0), **kw)), JRequest, trace)
    assert got == plain
    assert got == jbd
    assert set(tkeys) == {("commit", "forward", "host_prep", "host_sync",
                           "sampling")}
    summary = bd.metrics.format_summary()
    for stage in ("forward", "sampling", "host_sync"):
        assert f"{stage}:" in summary
    s = bd.metrics.summary()
    assert s["stage_forward_s"] > 0 and s["stage_sampling_s"] > 0
    # two waits (forward, sampling) and the result fetch per tick
    assert bd.host_waits >= 3 * bd.ticks_total


def test_breakdown_rejects_paged_pool_and_megatick(models):
    _, model_t, _, params_t = models
    _, dt = _dcfgs()
    for kw in (dict(pool="paged"), dict(megatick_k=4)):
        with pytest.raises(ValueError, match="breakdown"):
            ServingEngine(model_t, params_t, dt,
                          EngineConfig(breakdown=True, **kw))


@pytest.mark.parametrize("cfg", [
    dict(mode="warm"), dict(mode="warm", megatick_k=4),
    dict(mode="none", pool="paged", page_size=8),
    dict(mode="warm", jit_steps=False)],
    ids=["warm", "warm-K4", "paged", "eager"])
def test_obs_off_and_on_equal(models, cfg, tmp_path):
    """Metrics + drift + trace + an event log change no token, no
    CommitEvent and no host wait."""
    _, model_t, _, params_t = models
    _, dt = _dcfgs()
    trace = _short_trace(model_t.cfg.vocab)
    runs = []
    for on in (False, True):
        obs = None
        if on:
            root = tobs.ServingObs(trace=tobs.TraceCollector())
            root.set_event_log(tobs.EventLog(str(tmp_path / "ev.jsonl")))
            obs = root.for_replica("replica-0")
            obs.set_drift_model(tobs.modeled_tick_stages(
                model_t.cfg, dt, batch=2, prompt_len=16))
        eng = ServingEngine(model_t, params_t, dt, EngineConfig(
            num_slots=2, max_seq_len=32, obs=obs, **cfg))
        runs.append(_run(eng, Request, trace) + (eng.host_waits,
                                                 eng.host_syncs_elided))
    assert runs[1] == runs[0]
    tobs.validate_trace(root.trace.to_json())
    root.events.close()
    tobs.validate_events(tobs.read_events(str(tmp_path / "ev.jsonl")),
                         require_terminal=True)
    assert obs.drift_report()["ticks"] == runs[1][2]
