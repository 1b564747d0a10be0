"""Asyncio HTTP frontend for online dLLM serving (stdlib only): a copy of
src/repro/serving/frontend/server.py over the port's engine.

Endpoints:

  POST /v1/completions   OpenAI-style completion.  ``"stream": true``
                         answers Server-Sent Events with the dLLM-native
                         ``block_committed`` / ``done`` schema
                         (frontend/protocol.py) — positions within a block
                         arrive confidence-ordered, not left-to-right.
  GET  /v1/models        model + engine geometry (loadgen reads vocab,
                         block_length, max_seq_len from here)
  GET  /v1/stats         router + per-replica load/shed counters, engine
                         metrics summaries (per-stage seconds, shed,
                         kv_valid_uploads) and drift reports
  GET  /metrics          Prometheus text exposition (repro_torch.obs:
                         per-replica tick/stage histograms, request
                         lifecycle counters, drift gauges)
  GET  /healthz          liveness

The server owns no engine state: requests go through the
:class:`~repro_torch.serving.frontend.router.Router` into per-replica worker
threads, and events come back via ``loop.call_soon_threadsafe`` into a
per-request asyncio queue.  Admission refusals (bounded queue, draining)
answer HTTP 429 with an ``overloaded`` error body; requests shed *after*
acceptance (max_queue_wait) get the same error as an SSE ``error`` event
or a 429 JSON body.  See docs/streaming_serving.md.
"""
from __future__ import annotations

import asyncio
import json
import time
from typing import Optional, Set

from repro_torch.obs import CONTENT_TYPE as _METRICS_CT
from repro_torch.obs import ServingObs, frontend_metrics
from repro_torch.obs.registry import OPENMETRICS_CONTENT_TYPE as _OM_CT
from repro_torch.serving.engine import CommitEvent, Request
from repro_torch.serving.frontend import protocol
from repro_torch.serving.frontend.router import Overloaded, Router, ShedEvent

_MAX_BODY = 8 << 20          # 8 MiB: far above any token-id prompt
_HEAD_TIMEOUT_S = 30.0


class ServeFrontend:
    """HTTP server + router bundle.  Typical lifecycle::

        frontend = ServeFrontend(router, model_name="llada-8b")
        await frontend.start()          # workers + listener; port resolved
        ...
        await frontend.shutdown()       # graceful drain
    """

    def __init__(self, router: Router, *, model_name: str,
                 host: str = "127.0.0.1", port: int = 0,
                 obs: Optional[ServingObs] = None):
        self.router = router
        self.model_name = model_name
        self.host = host
        self.port = port                 # 0 -> ephemeral, resolved in start
        eng = router.workers[0].engine
        # share the engines' obs root when build_frontend wired one (any
        # replica view reaches the shared registry/trace); otherwise make a
        # standalone registry so /metrics always answers
        if obs is None:
            obs = eng.obs if eng.obs is not None else ServingObs()
        self.obs = obs
        # SLO class table for slo_class body validation (unknown tier ->
        # 400); None when the obs object predates SLO support
        self.slo_classes = getattr(obs, "slo_classes", None)
        self._http, self._submits, self._overloaded = frontend_metrics(
            obs.registry)
        self.block_length = eng.dcfg.block_length
        self.max_seq_len = min(w.engine.max_seq_len for w in router.workers)
        self.vocab = int(eng.model.cfg.vocab)
        self.mask_id = int(eng.mask_id)
        self._server: Optional[asyncio.base_events.Server] = None
        self._tasks: Set[asyncio.Task] = set()
        self._workers_started = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _count(self, route: str, code: int) -> None:
        self._http.inc(route=route, code=str(code))

    # -- lifecycle ----------------------------------------------------------

    async def start(self, start_workers: bool = True) -> "ServeFrontend":
        if start_workers:
            self.start_workers()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def start_workers(self) -> None:
        """Start replica tick threads (idempotent; split out so tests can
        stage submissions against a paused engine deterministically)."""
        if not self._workers_started:
            self.router.start()
            self._workers_started = True

    async def shutdown(self, drain: bool = True,
                       timeout: Optional[float] = 60.0) -> None:
        """Graceful shutdown, in three phases: (1) refuse new admissions —
        connections already in flight or still being accepted get fast
        429s instead of silently dying in a closed listener's backlog;
        (2) drain (or shed) the replicas and flush in-flight responses;
        (3) close the listener last.  A connection racing the final close
        is the one case only a client-side timeout can cover."""
        self.router.stop_accepting()
        await asyncio.sleep(0)          # let pending accepts run -> 429
        loop = asyncio.get_running_loop()
        if self._workers_started:
            await loop.run_in_executor(
                None, lambda: self.router.shutdown(drain=drain,
                                                   timeout=timeout))
        if self._tasks:
            await asyncio.wait(self._tasks, timeout=timeout)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            await self._handle_inner(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                          # client went away mid-response
        finally:
            self._tasks.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_inner(self, reader, writer) -> None:
        try:
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), _HEAD_TIMEOUT_S)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            return
        try:
            request_line, *header_lines = head.decode(
                "latin-1").split("\r\n")
            method, path, _ = request_line.split(" ", 2)
            headers = {}
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
        except ValueError:
            writer.write(protocol.json_response(400, protocol.error_payload(
                "bad_request", "malformed HTTP request")))
            await writer.drain()
            return
        body = b""
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            n = -1
        if n < 0 or n > _MAX_BODY:
            writer.write(protocol.json_response(
                400, protocol.error_payload(
                    "bad_request",
                    f"Content-Length must be an int in [0, {_MAX_BODY}]")))
            await writer.drain()
            return
        if n:
            body = await reader.readexactly(n)

        if method == "GET" and path == "/healthz":
            self._count("/healthz", 200)
            writer.write(protocol.json_response(200, {
                "status": "ok", "model": self.model_name,
                "replicas": len(self.router.workers),
                "load": self.router.load}))
        elif method == "GET" and path == "/v1/models":
            self._count("/v1/models", 200)
            writer.write(protocol.json_response(200, {
                "object": "list",
                "data": [{
                    "id": self.model_name, "object": "model",
                    "vocab": self.vocab, "mask_id": self.mask_id,
                    "block_length": self.block_length,
                    "max_seq_len": self.max_seq_len,
                    "replicas": len(self.router.workers),
                    "num_slots": sum(w.engine.num_slots
                                     for w in self.router.workers),
                }]}))
        elif method == "GET" and path == "/v1/stats":
            self._count("/v1/stats", 200)
            writer.write(protocol.json_response(200, self.router.stats()))
        elif method == "GET" and path == "/metrics":
            self._count("/metrics", 200)
            # OpenMetrics negotiation: exemplars (trace-id joins on the
            # counters) are only legal in the OpenMetrics exposition, so
            # the default Prometheus 0.0.4 scrape stays byte-identical
            om = "application/openmetrics-text" in headers.get("accept", "")
            writer.write(protocol.http_response(
                200,
                self.obs.registry.expose(openmetrics=om).encode("utf-8"),
                content_type=_OM_CT if om else _METRICS_CT))
        elif method == "POST" and path == "/v1/completions":
            await self._completions(writer, body, headers)
        else:
            # unknown paths collapse to one label: client-chosen strings
            # must not mint unbounded metric label values
            self._count("other", 404 if method in ("GET", "POST") else 405)
            writer.write(protocol.json_response(
                404 if method in ("GET", "POST") else 405,
                protocol.error_payload("not_found",
                                       f"no route for {method} {path}")))
        await writer.drain()

    # -- /v1/completions ----------------------------------------------------

    async def _completions(self, writer, body: bytes,
                           headers: Optional[dict] = None) -> None:
        headers = headers or {}
        # trace context first: even a 400/429 response carries the
        # traceparent so clients can join their log line to ours
        trace_id = protocol.parse_traceparent(headers.get("traceparent")) \
            or protocol.mint_trace_id()
        traceparent = protocol.format_traceparent(trace_id)
        th = {"traceparent": traceparent}
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            writer.write(protocol.json_response(400, protocol.error_payload(
                "bad_request", "body is not valid JSON"), headers=th))
            return
        try:
            ids, gen_len, stream = protocol.parse_completion(
                payload, block_length=self.block_length,
                max_seq_len=self.max_seq_len, vocab=self.vocab)
            policy, policy_params = protocol.parse_policy(payload)
            slo_class = protocol.parse_slo_class(payload, self.slo_classes)
        except protocol.BadRequest as e:
            self._count("/v1/completions", 400)
            writer.write(protocol.json_response(
                400, protocol.error_payload("bad_request", str(e)),
                headers=th))
            return

        # uid=None: the engine assigns the next free uid at submit on the
        # worker thread; responses carry the uid from the commit events
        req = Request(prompt=ids, gen_length=gen_len,
                      policy=policy, policy_params=policy_params,
                      slo_class=slo_class, trace_id=trace_id)
        events: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()

        def deliver(ev):          # fires on the worker thread
            loop.call_soon_threadsafe(events.put_nowait, ev)

        try:
            # router hop: which replica took the request, and how long the
            # pick + stage took (spans land on the event-loop thread lane)
            with self.obs.trace.span("router.submit", cat="router",
                                     args={"prompt_len": int(ids.size),
                                           "trace": trace_id,
                                           "class": slo_class}):
                worker = self.router.submit(req, deliver)
            self._submits.inc(replica=worker.name)
        except Overloaded as e:
            self._overloaded.inc()
            self._count("/v1/completions", 429)
            writer.write(protocol.json_response(
                429, protocol.error_payload("overloaded", str(e)),
                headers=th))
            return
        t0 = time.perf_counter()

        if stream:
            await self._stream_response(writer, events, int(ids.size), t0,
                                        trace_id, th)
        else:
            await self._gathered_response(writer, events, int(ids.size),
                                          t0, trace_id, th)

    async def _stream_response(self, writer, events,
                               prompt_len: int, t0: float,
                               trace_id: Optional[str] = None,
                               trace_headers: Optional[dict] = None
                               ) -> None:
        self._count("/v1/completions", 200)
        writer.write(protocol.sse_headers(trace_headers))
        await writer.drain()
        ttft: Optional[float] = None
        ticks = 0
        while True:
            ev = await events.get()
            if isinstance(ev, ShedEvent):
                writer.write(protocol.sse_event("error",
                             protocol.error_payload("overloaded",
                                                    ev.reason)))
                break
            if not isinstance(ev, CommitEvent):
                raise TypeError(f"unexpected event on request stream: "
                                f"{type(ev).__name__}")
            ticks += 1
            if len(ev.positions):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                # buffered write, flushed by the transport: per-event
                # drain() would wake the event loop per tick per slot and
                # starve the worker threads of the GIL under load
                p = protocol.commit_payload(ev)
                if trace_id is not None:
                    # server-layer stamp (not commit_payload): the event
                    # log's block_commit records carry the identical
                    # payload fields, and "trace" is this stream's join
                    # key, not part of the commit delta
                    p["trace"] = trace_id
                writer.write(protocol.sse_event("block_committed", p))
            if ev.done:
                writer.write(protocol.sse_event("done",
                             protocol.completion_payload(
                                 ev.uid, self.model_name, prompt_len,
                                 ev.final_tokens, ticks, ttft,
                                 time.perf_counter() - t0,
                                 trace_id=trace_id)))
                break
        writer.write(protocol.SSE_DONE)
        await writer.drain()

    async def _gathered_response(self, writer, events,
                                 prompt_len: int, t0: float,
                                 trace_id: Optional[str] = None,
                                 trace_headers: Optional[dict] = None
                                 ) -> None:
        ttft: Optional[float] = None
        ticks = 0
        while True:
            ev = await events.get()
            if isinstance(ev, ShedEvent):
                self._count("/v1/completions", 429)
                writer.write(protocol.json_response(
                    429, protocol.error_payload("overloaded", ev.reason),
                    headers=trace_headers))
                return
            ticks += 1
            if ttft is None and len(ev.positions):
                ttft = time.perf_counter() - t0
            if ev.done:
                self._count("/v1/completions", 200)
                writer.write(protocol.json_response(
                    200, protocol.completion_payload(
                        ev.uid, self.model_name, prompt_len,
                        ev.final_tokens, ticks, ttft,
                        time.perf_counter() - t0, trace_id=trace_id),
                    headers=trace_headers))
                return


def build_frontend(model, params, dcfg, *, model_name: str,
                   replicas: int = 1, num_slots: int = 4,
                   max_seq_len: int = 128, mode: str = "none",
                   strategy: str = "least_loaded",
                   max_queue: Optional[int] = None,
                   max_queue_wait: Optional[float] = None,
                   tick_floor_s: Optional[float] = None,
                   policy=None, mesh=None, host: str = "127.0.0.1",
                   port: int = 0, seed: int = 0,
                   warmup: bool = True,
                   obs: Optional[ServingObs] = None,
                   breakdown: bool = False,
                   drift: bool = True,
                   profile_ticks: int = 0,
                   profile_dir: Optional[str] = None,
                   megatick_k: int = 1,
                   pool: str = "slot",
                   page_size: int = 16,
                   num_pages: Optional[int] = None,
                   prefix_cache: bool = True,
                   event_log=None,
                   slo_classes=None) -> ServeFrontend:
    """Wire engines -> workers -> router -> frontend.  One independent
    engine per replica (each with its own pool, its own seed ``seed + i``
    for the counter-Gumbel stream, its own graphs and its tick thread;
    params are shared read-only).  Every replica is warmed up here, on the
    calling thread, before any worker starts, so all CUDA graph capture
    happens before a worker ticks (``warmup=False`` leaves a graphed
    engine to capture on its worker's first tick, which the worker
    refuses).

    Observability: ``obs`` (default: a fresh :class:`ServingObs` root) is
    fanned out as per-replica labeled views, so one ``/metrics`` scrape
    covers every replica.  ``breakdown=True`` splits the tick into jitted
    forward/sampling stages so the per-stage histograms and the drift
    monitor see the paper's Fig. 1 split; ``drift=True`` arms each replica
    with the sim/analytical per-tick stage prediction for this exact
    model/serving config (every family: the analytical model's
    dense-shaped estimate, as in JAX).  ``profile_ticks=N`` wraps the first N ticks
    of each replica in a torch.profiler trace under ``profile_dir``.
    ``megatick_k=K`` fuses up to K ticks per engine dispatch
    (docs/megatick.md) — commit callbacks still see every per-tick event.
    ``event_log`` (an :class:`repro_torch.obs.events.EventLog` or a JSONL path)
    wires the structured event log onto the shared obs root, and
    ``slo_classes`` (a :func:`repro_torch.obs.slo.resolve_classes` spec)
    installs the SLO tier table — both must land before the per-replica
    views fan out, which this function guarantees.
    """
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.frontend.router import EngineWorker

    if obs is None:
        obs = ServingObs()
    if slo_classes is not None:
        obs.set_slo_classes(slo_classes)
    if event_log is not None:
        from repro_torch.obs.events import EventLog
        obs.set_event_log(event_log if isinstance(event_log, EventLog)
                          else EventLog(event_log))
    paged = pool == "paged"
    modeled = None
    if drift:
        from repro_torch.obs.drift import modeled_tick_stages
        from repro_torch.sim.analytical import HostConfig
        modeled = modeled_tick_stages(
            model.cfg, dcfg, batch=num_slots,
            prompt_len=max(1, max_seq_len - dcfg.gen_length),
            megatick_k=megatick_k, host=HostConfig(), paged=paged)
    host_stages = ("dispatch", "device_sync") + (
        ("paged_io",) if paged else ())
    workers = []
    for i in range(replicas):
        rep_obs = obs.for_replica(f"replica-{i}")
        if modeled is not None:
            rep_obs.set_drift_model(modeled, host_stages=host_stages)
        eng = ServingEngine(model, params, dcfg, EngineConfig(
            num_slots=num_slots, max_seq_len=max_seq_len, mode=mode,
            policy=policy, mesh=mesh, seed=seed + i,
            breakdown=breakdown, obs=rep_obs, megatick_k=megatick_k,
            pool=pool, page_size=page_size, num_pages=num_pages,
            prefix_cache=prefix_cache))
        if warmup:
            eng.warmup()              # compile off-clock, before accepting
        workers.append(EngineWorker(eng, name=f"replica-{i}",
                                    max_queue=max_queue,
                                    max_queue_wait=max_queue_wait,
                                    tick_floor_s=tick_floor_s,
                                    profile_ticks=profile_ticks,
                                    profile_dir=profile_dir))
    router = Router(workers, strategy=strategy)
    return ServeFrontend(router, model_name=model_name, host=host,
                         port=port, obs=obs)


async def serve_forever(frontend: ServeFrontend) -> None:
    """CLI helper: start, print the URL, run until cancelled, then drain."""
    await frontend.start()
    print(f"serving {frontend.model_name} on {frontend.url}  "
          f"(replicas={len(frontend.router.workers)}, "
          f"strategy={frontend.router.strategy})", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await frontend.shutdown(drain=True)
