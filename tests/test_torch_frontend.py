"""The port's streaming HTTP frontend (repro_torch.serving.frontend) on the
CPU at smoke size, over loopback: the wire protocol is byte-equal to the
JAX package's; a one-slot stream equals the port's ``generate``; a
multi-request stream equals the JAX engine's CommitEvents; the bounded
queue answers 429, ``max_queue_wait`` sheds, the router picks the least
loaded replica and fails over, a graceful drain finishes pending work,
``loadgen`` reports every request, and ``profile_ticks`` writes a
torch.profiler trace."""
import asyncio
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.models.registry import build_model as jbuild
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import CommitEvent as JCommitEvent
from repro.serving.frontend import protocol as jprotocol
from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import Request
from repro_torch.serving.engine import CommitEvent
from repro_torch.serving.frontend import (Overloaded, Router,
                                          build_frontend, loadgen, protocol)

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


def _dcfg(gen=16, block=8, steps=4):
    return tdiff.DiffusionConfig(gen_length=gen, block_length=block,
                                 steps_per_block=steps)


def _prompt(vocab, seed, n):
    return np.random.RandomState(seed).randint(0, vocab - 2,
                                               size=(n,)).astype(np.int32)


def _frontend(models, dcfg, **kw):
    _, model_t, _, params_t = models
    kw.setdefault("model_name", "llada-8b")
    kw.setdefault("mode", "none")
    kw.setdefault("max_seq_len", 48)
    return build_frontend(model_t, params_t, dcfg, **kw)


# ---------------------------------------------------------------------------
# Wire protocol: byte-equal to JAX's
# ---------------------------------------------------------------------------

BODIES = [{"prompt": [1, 2, 3], "max_tokens": 16, "stream": True},
          {"prompt": "4 5 6"},
          {"prompt": [1], "max_tokens": 12}, {"prompt": [1], "max_tokens": 0},
          {"prompt": [1] * 30, "max_tokens": 8}, {"prompt": [],
                                                 "max_tokens": 8},
          {"prompt": [100], "max_tokens": 8}, {"prompt": 7, "max_tokens": 8},
          {"prompt": "x y", "max_tokens": 8}, "nope",
          {"prompt": [1], "policy": "slowfast",
           "policy_params": {"threshold": 0.5}},
          {"prompt": [1], "policy": "nope"},
          {"prompt": [1], "policy_params": {"threshold": 0.5}},
          {"prompt": [1], "slo_class": "interactive"},
          {"prompt": [1], "slo_class": "platinum"},
          {"prompt": [1], "slo_class": ""}]


def _parse_all(proto, body):
    out = []
    for fn in (lambda: proto.parse_completion(body, block_length=8,
                                              max_seq_len=32, vocab=100),
               lambda: proto.parse_policy(body),
               lambda: proto.parse_slo_class(
                   body, {"standard": 1, "interactive": 1})):
        try:
            r = fn()
            out.append(("ok", [x.tolist() if isinstance(x, np.ndarray)
                               else x for x in (r if isinstance(r, tuple)
                                                else (r,))]))
        except (proto.BadRequest, AttributeError) as e:
            out.append(("error", type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_protocol_parsing_equals_jax(body):
    assert _parse_all(protocol, body) == _parse_all(jprotocol, body)


def test_protocol_traceparent_and_framing_bytes_equal_jax():
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    for header in (None, "", f"00-{tid}-00f067aa0ba902b7-01",
                   f"00-{tid.upper()}-00f067aa0ba902b7-01",
                   f"00-{'0' * 32}-00f067aa0ba902b7-01",
                   f"00-{tid}-{'0' * 16}-01", "garbage", f"01-{tid}-x-01"):
        assert protocol.parse_traceparent(header) == \
            jprotocol.parse_traceparent(header)
    assert protocol.format_traceparent(tid, "00f067aa0ba902b7") == \
        jprotocol.format_traceparent(tid, "00f067aa0ba902b7")
    assert len(protocol.mint_trace_id()) == 32
    args = dict(uid=3, tick=7, now=0.5, block_idx=1, step_in_block=2,
                positions=np.array([9, 4]), tokens=np.array([5, 6]),
                masks_left=3, done=True,
                final_tokens=np.arange(12, dtype=np.int32))
    t_ev, j_ev = CommitEvent(**args), JCommitEvent(**args)
    assert protocol.sse_event("block_committed",
                              protocol.commit_payload(t_ev)) == \
        jprotocol.sse_event("block_committed",
                            jprotocol.commit_payload(j_ev))
    for mod in (protocol, jprotocol):
        assert mod.SSE_DONE == b"data: [DONE]\n\n"
    pays = [m.completion_payload(3, "llada-8b", 4, np.arange(12), 7, 0.1,
                                 0.5, trace_id=tid)
            for m in (protocol, jprotocol)]
    assert pays[0] == pays[1]
    th = {"traceparent": protocol.format_traceparent(tid, "1" * 16)}
    for status in (200, 400, 429, 404):
        assert protocol.json_response(status, pays[0], headers=th) == \
            jprotocol.json_response(status, pays[1], headers=th)
    assert protocol.sse_headers(th) == jprotocol.sse_headers(th)
    assert protocol.http_response(200, b"x", "text/plain") == \
        jprotocol.http_response(200, b"x", "text/plain")
    assert protocol.error_payload("overloaded", "m") == \
        jprotocol.error_payload("overloaded", "m")
    assert protocol.entok(protocol.detok([9, 8, 7])).tolist() == [9, 8, 7]


# ---------------------------------------------------------------------------
# Streaming parity
# ---------------------------------------------------------------------------

def test_one_slot_stream_equals_generate(models):
    """One streamed and one gathered request through the HTTP surface equal
    the port's generate(cache_mode='none') bit for bit; tick numbers
    increase and the commit sets partition the generation region.  The
    engine's canvas is the request's length (mode none attends over every
    position, as generate's canvas does)."""
    _, model_t, _, params_t = models
    dcfg = _dcfg()
    prompt = _prompt(model_t.cfg.vocab, 5, 16)
    ref = tdiff.generate(model_t, params_t, torch.from_numpy(prompt)[None],
                         dcfg)
    ref_ids = ref[0, 16:].tolist()

    async def go():
        fe = _frontend(models, dcfg, replicas=1, num_slots=1,
                       max_seq_len=32)
        await fe.start()
        try:
            row = await loadgen.complete(fe.url, prompt.tolist(), 16)
            gathered = await loadgen.complete(fe.url, prompt.tolist(), 16,
                                              stream=False)
        finally:
            await fe.shutdown()
        return row, gathered

    row, gathered = asyncio.run(go())
    assert row["status"] == "ok"
    assert row["ticks_monotone"] and len(row["ticks"]) >= 2
    assert sorted(row["positions"]) == list(range(16, 32))
    assert row["token_ids"] == ref_ids
    assert row["text"] == protocol.detok(ref_ids)
    assert gathered["token_ids"] == ref_ids
    assert gathered["ttft_s"] is not None


def test_multi_request_stream_equals_jax_commit_events(models):
    """Four requests staged on paused workers, then served by a 2-slot
    engine: each stream's ticks, commit positions and final tokens equal
    the JAX engine's CommitEvents for the same requests."""
    model_j, model_t, params_j, _ = models
    prompts = [_prompt(model_t.cfg.vocab, 30 + i, 8 + 4 * i)
               for i in range(4)]
    gens = [16, 8, 16, 8]
    jeng = JEngine(model_j, params_j, jdiff.DiffusionConfig(
        gen_length=16, block_length=8, steps_per_block=4,
        cache_mode="none"), num_slots=2, max_seq_len=48, mode="none",
        rng=jax.random.PRNGKey(0))
    jevents = []
    for p, g in zip(prompts, gens):
        jeng.submit(JRequest(prompt=p, gen_length=g),
                    on_commit=jevents.append)
    jeng.run()
    want = {}
    for uid in range(1, 5):
        evs = [e for e in jevents if e.uid == uid and len(e.positions)]
        want[uid] = ([e.tick for e in evs],
                     [int(p) for e in evs for p in e.positions],
                     [int(t) for t in evs[-1].final_tokens[
                         evs[-1].final_tokens.size - gens[uid - 1]:]])

    async def go():
        fe = _frontend(models, _dcfg(), replicas=1, num_slots=2,
                       max_queue=8)
        await fe.start(start_workers=False)
        try:
            tasks = []
            for i, (p, g) in enumerate(zip(prompts, gens)):
                tasks.append(asyncio.ensure_future(
                    loadgen.complete(fe.url, p.tolist(), g)))
                while fe.router.load < i + 1:     # staged in this order
                    await asyncio.sleep(0.005)
            fe.start_workers()
            rows = await asyncio.gather(*tasks)
        finally:
            await fe.shutdown()
        return rows

    rows = asyncio.run(go())
    for i, r in enumerate(rows):
        assert r["status"] == "ok"
        assert (r["ticks"], r["positions"], r["token_ids"]) == want[i + 1]


# ---------------------------------------------------------------------------
# Backpressure, router, drain
# ---------------------------------------------------------------------------

def test_bounded_queue_answers_429(models):
    """Paused workers: a 1-slot replica with max_queue=2 accepts queued <
    2 + 1 free slot = 3 requests and 429s the rest; once the workers
    start, every accepted request completes."""
    prompt = _prompt(models[1].cfg.vocab, 7, 8)

    async def go():
        fe = _frontend(models, _dcfg(gen=8), replicas=1, num_slots=1,
                       max_queue=2)
        await fe.start(start_workers=False)
        try:
            tasks = [asyncio.ensure_future(
                loadgen.complete(fe.url, prompt.tolist(), 8))
                for _ in range(6)]
            while sum(t.done() for t in tasks) < 3:
                await asyncio.sleep(0.01)
            assert all(t.result()["status"] == "shed"
                       for t in tasks if t.done())
            fe.start_workers()
            rows = await asyncio.gather(*tasks)
            metrics = await loadgen.scrape_metrics(fe.url)
        finally:
            await fe.shutdown()
        return rows, metrics

    rows, metrics = asyncio.run(go())
    assert sorted(r["status"] for r in rows) == ["ok"] * 3 + ["shed"] * 3
    assert all(r["http"] == 429 for r in rows if r["status"] == "shed")
    assert metrics["dllm_router_overloaded_total"][""] == 3.0


def test_max_queue_wait_sheds_queued_requests(models):
    """A request stuck behind a busy slot past max_queue_wait is cancelled
    with reason "deadline" and answered 429; admitted work runs on."""
    p = _prompt(models[1].cfg.vocab, 8, 8)
    log = tobs.EventLog(autoflush=False)

    async def go():
        fe = _frontend(models, _dcfg(gen=32, steps=8), replicas=1,
                       num_slots=1, max_queue=8, max_queue_wait=0.0,
                       tick_floor_s=0.01, event_log=log)
        await fe.start()
        try:
            first = asyncio.ensure_future(
                loadgen.complete(fe.url, p.tolist(), 32))
            await asyncio.sleep(0.05)
            rest = await asyncio.gather(*[
                loadgen.complete(fe.url, p.tolist(), 8, stream=False)
                for _ in range(2)])
            head = await first
        finally:
            await fe.shutdown()
        return head, rest

    head, rest = asyncio.run(go())
    assert head["status"] == "ok"
    assert [r["status"] for r in rest] == ["shed", "shed"]
    sheds = [r for r in log.tail() if r["event"] == "shed"]
    assert [r["reason"] for r in sheds] == ["deadline", "deadline"]
    tobs.validate_events(log.tail(), require_terminal=True)


class _StubWorker:
    def __init__(self, name, load, accepting=True, refuse=False):
        self.name, self.load, self.accepting = name, load, accepting
        self.refuse = refuse
        self.got = []

    def submit(self, request, deliver):
        if self.refuse:
            raise Overloaded(f"{self.name} full")
        self.got.append(request)


def _req(uid):
    return Request(uid=uid, prompt=np.zeros(4, np.int32), gen_length=8)


def test_router_least_loaded_and_failover():
    a, b, c = (_StubWorker("a", 5), _StubWorker("b", 1), _StubWorker("c", 3))
    r = Router([a, b, c], strategy="least_loaded")
    r.submit(_req(1), lambda ev: None)
    assert [len(w.got) for w in (a, b, c)] == [0, 1, 0]
    b.load = 9
    r.submit(_req(2), lambda ev: None)
    assert [len(w.got) for w in (a, b, c)] == [0, 1, 1]
    a.load = c.load = 0                      # ties go to the first
    r.submit(_req(3), lambda ev: None)
    assert len(a.got) == 1
    a.refuse = True                          # failover to the next
    r.submit(_req(4), lambda ev: None)
    assert len(c.got) == 2
    rr = Router([_StubWorker("x", 0, refuse=True), _StubWorker("y", 0)],
                strategy="rr")
    for i in range(3):
        rr.submit(_req(10 + i), lambda ev: None)
    assert len(rr.workers[1].got) == 3
    rr.workers[1].refuse = True
    with pytest.raises(Overloaded):
        rr.submit(_req(20), lambda ev: None)
    for w in rr.workers:
        w.accepting = False
    with pytest.raises(Overloaded):
        rr.candidates()
    with pytest.raises(ValueError):
        Router([a], strategy="nope")


def test_graceful_drain_completes_pending_work(models):
    p = _prompt(models[1].cfg.vocab, 9, 8)

    async def go(drain, gen):
        fe = _frontend(models, _dcfg(gen=gen, steps=8), replicas=1,
                       num_slots=1, max_queue=4, max_seq_len=8 + gen)
        await fe.start()
        tasks = [asyncio.ensure_future(
            loadgen.complete(fe.url, p.tolist(), gen)) for _ in range(2)]
        for _ in range(1000):
            if fe.router.load >= 2:
                break
            await asyncio.sleep(0.005)
        await fe.shutdown(drain=drain)
        return await asyncio.gather(*tasks), fe

    rows, fe = asyncio.run(go(True, 16))
    assert [r["status"] for r in rows] == ["ok", "ok"]
    assert all(not w.accepting for w in fe.router.workers)
    rows, _ = asyncio.run(go(False, 64))
    assert "shed" in [r["status"] for r in rows]


def test_loadgen_report_metrics_and_profile(models, tmp_path):
    """run_load over two replicas with the /metrics scrape: every request
    is accounted for, counters are monotone, the tick counter equals the
    engines' ticks; profile_ticks=2 writes a torch.profiler trace."""
    async def go():
        fe = _frontend(models, _dcfg(gen=8), replicas=2, num_slots=2,
                       max_queue=2, profile_ticks=2,
                       profile_dir=str(tmp_path))
        await fe.start()
        try:
            rep = await loadgen.run_load(
                fe.url, rate=300.0, n_requests=10, prompt_len=8,
                max_tokens=8, seed=0, scrape=True)
            stats = await loadgen.get_json(fe.url, "/v1/stats")
        finally:
            await fe.shutdown()
        return rep, stats, fe

    rep, stats, fe = asyncio.run(go())
    assert rep["completed"] + rep["shed"] + rep["errors"] == 10
    assert rep["errors"] == 0 and rep["completed"] >= 1
    assert rep["ticks_monotone"] is True and rep["goodput_tok_s"] > 0
    m = rep["metrics"]
    assert m["counters_monotone"]
    assert m["ticks_total"] == sum(w.engine.ticks_total
                                   for w in fe.router.workers)
    assert m["requests_completed_total"] == rep["completed"]
    assert len(stats["replicas"]) == 2
    assert all("drift" in r for r in stats["replicas"])
    # one profiler window at a time: the replicas take turns
    paths = [w.profile_path for w in fe.router.workers if w.profile_path]
    assert paths
    for w in fe.router.workers:
        if w.profile_path is not None:
            with open(w.profile_path) as f:
                assert "traceEvents" in json.load(f)
            assert os.path.dirname(w.profile_path) == str(tmp_path / w.name)
