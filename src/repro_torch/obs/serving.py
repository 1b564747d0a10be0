"""Serving-stack observability bundle: metrics + tracing + drift in one
object the engine, router, and HTTP frontend all hook into.

One root :class:`ServingObs` owns the shared :class:`~repro_torch.obs.registry.
Registry` and :class:`~repro_torch.obs.tracing.TraceCollector`; each replica
gets a cheap labeled view via :meth:`for_replica`, so every series carries
a ``replica`` label and one ``/metrics`` scrape covers the whole router.

Metric catalog (names/labels/units in docs/observability.md):

  dllm_requests_total{replica,event}        queued|admitted|completed|shed
  dllm_tokens_committed_total{replica}      committed generation tokens
  dllm_blocks_committed_total{replica}      fully-unmasked blocks
  dllm_ticks_total{replica}                 engine ticks
  dllm_kv_valid_uploads_total{replica}      host->device mask refreshes
  dllm_policy_early_exits_total{replica}    SlowFast whole-block commits
  dllm_host_syncs_elided_total{replica}     skipped per-tick host syncs
  dllm_megasteps_total{replica}             fused megatick dispatches
  dllm_megastep_ticks{replica}              histogram, ticks per megastep
  dllm_tick_seconds{replica}                histogram, full tick wall time
  dllm_tick_stage_seconds{replica,stage}    histogram, per-stage seconds
  dllm_queue_wait_seconds{replica}          histogram, arrival -> admit
  dllm_ttft_seconds{replica}                histogram, arrival -> first commit
  dllm_request_latency_seconds{replica}     histogram, arrival -> done
  dllm_active_slots{replica}                gauge
  dllm_queue_depth{replica}                 gauge
  dllm_drift_ratio{replica,stage}           gauge, calibrated measured/modeled
  dllm_drift_scale{replica}                 gauge, hardware calibration factor
  dllm_pool_pages{replica,state}            gauge, paged-pool occupancy
                                            (in_use|free_canvas|free_kv|cached)
  dllm_prefix_pages_total{replica,result}   prompt-page radix lookups (hit|miss)
  dllm_page_evictions_total{replica}        LRU-reclaimed cached pages
  dllm_preemptions_total{replica,event}     spill|restore page preemptions
  dllm_requests_by_policy_total{replica,policy}  admissions by step policy
  dllm_http_requests_total{route,code}      HTTP frontend answers
  dllm_router_submits_total{replica}        requests routed to each replica
  dllm_router_overloaded_total{}            submissions every replica refused

The engine calls the ``on_*``/``tick`` hooks with data it already has in
hand (stage timings, commit deltas), so instrumentation adds no device
syncs and no extra clock reads (``chip_smoke.py`` phase 6b holds the
engine's ``host_waits`` equal with obs off and on, and prints the tick
walls of both).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.obs import slo as slo_lib
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.events import EventLog
from repro_torch.obs.registry import (LATENCY_BUCKETS, Registry,
                                      exp_buckets)
from repro_torch.obs.tracing import TraceCollector

# bound on the per-class latency/ttft reservoirs behind slo_summary()
_SLO_RESERVOIR = 1024


def _pctl(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(q * len(vs)))]


def _new_slo_stat() -> dict:
    return {"completed": 0, "shed": 0, "tokens": 0,
            "violations": {}, "ttft": [], "latency": []}


class ServingObs:
    """Root observability context (or a replica-labeled view of one)."""

    def __init__(self, registry: Optional[Registry] = None,
                 trace: Optional[TraceCollector] = None,
                 replica: str = "replica-0",
                 events: Optional[EventLog] = None,
                 slo_classes: Optional[Dict[str, "slo_lib.SLOClass"]] = None,
                 _root: Optional["ServingObs"] = None):
        self.registry = registry if registry is not None else Registry()
        # disabled-by-default collector: span calls cost one bool check
        # until someone passes/enables a real one (--trace-out)
        self.trace = trace if trace is not None \
            else TraceCollector(enabled=False)
        self.replica = replica
        self.drift: Optional[DriftMonitor] = None
        # structured event log (repro_torch.obs.events): shared with the
        # root so one JSONL stream totally orders every replica's lifecycle
        # edges; None keeps the emit path a single attr check
        self.events = events if events is not None \
            else (_root.events if _root is not None else None)
        # SLO tier table (repro_torch.obs.slo), shared with the root
        self.slo_classes = slo_classes if slo_classes is not None \
            else (_root.slo_classes if _root is not None
                  else slo_lib.resolve_classes(None))
        r = self.registry
        if _root is None:
            self._requests = r.counter(
                "dllm_requests_total", "Request lifecycle transitions",
                ("replica", "event"))
            self._tokens = r.counter(
                "dllm_tokens_committed_total",
                "Committed generation tokens", ("replica",))
            self._blocks = r.counter(
                "dllm_blocks_committed_total",
                "Fully unmasked blocks", ("replica",))
            self._ticks = r.counter(
                "dllm_ticks_total", "Engine ticks", ("replica",))
            self._kv_uploads = r.counter(
                "dllm_kv_valid_uploads_total",
                "Batched host->device kv-validity uploads", ("replica",))
            self._early_exits = r.counter(
                "dllm_policy_early_exits_total",
                "SlowFast whole-block early-exit commits", ("replica",))
            self._host_elided = r.counter(
                "dllm_host_syncs_elided_total",
                "Per-tick host syncs skipped (no streaming sink needed "
                "them, or folded into one megastep drain)", ("replica",))
            self._megasteps = r.counter(
                "dllm_megasteps_total",
                "Fused megatick while_loop dispatches", ("replica",))
            self._megastep_ticks = r.histogram(
                "dllm_megastep_ticks",
                "Denoising ticks fused per megastep", ("replica",),
                exp_buckets(1.0, 2.0, 8))
            self._tick_s = r.histogram(
                "dllm_tick_seconds", "Engine tick wall seconds",
                ("replica",), LATENCY_BUCKETS)
            self._stage_s = r.histogram(
                "dllm_tick_stage_seconds",
                "Per-stage engine tick seconds", ("replica", "stage"),
                LATENCY_BUCKETS)
            self._queue_wait = r.histogram(
                "dllm_queue_wait_seconds",
                "Arrival to slot admission", ("replica",), LATENCY_BUCKETS)
            self._ttft = r.histogram(
                "dllm_ttft_seconds",
                "Arrival to first committed tokens", ("replica",),
                LATENCY_BUCKETS)
            self._latency = r.histogram(
                "dllm_request_latency_seconds",
                "Arrival to completion", ("replica",), LATENCY_BUCKETS)
            self._active = r.gauge(
                "dllm_active_slots", "Occupied batch slots", ("replica",))
            self._queue_depth = r.gauge(
                "dllm_queue_depth", "Requests queued (not admitted)",
                ("replica",))
            self._drift = r.gauge(
                "dllm_drift_ratio",
                "Calibrated measured/modeled per-stage drift",
                ("replica", "stage"))
            self._drift_scale = r.gauge(
                "dllm_drift_scale",
                "measured/modeled hardware calibration factor",
                ("replica",))
            self._pool_pages = r.gauge(
                "dllm_pool_pages",
                "Paged-pool page occupancy by state",
                ("replica", "state"))
            self._prefix_pages = r.counter(
                "dllm_prefix_pages_total",
                "Prompt-page radix-cache lookups by result",
                ("replica", "result"))
            self._page_evictions = r.counter(
                "dllm_page_evictions_total",
                "Radix-cached canvas pages reclaimed by LRU eviction",
                ("replica",))
            self._preempt_events = r.counter(
                "dllm_preemptions_total",
                "Requests spilled to host (spill) / re-admitted into "
                "fresh pages (restore)", ("replica", "event"))
            self._req_by_policy = r.counter(
                "dllm_requests_by_policy_total",
                "Admitted requests by effective step policy",
                ("replica", "policy"))
            self._slo_requests = r.counter(
                "dllm_slo_requests_total",
                "Completed/shed requests by SLO class",
                ("replica", "class", "event"))
            self._slo_violations = r.counter(
                "dllm_slo_violations_total",
                "SLO deadline misses by class and kind "
                "(ttft|latency|shed)", ("replica", "class", "kind"))
            self._slo_tokens = r.counter(
                "dllm_slo_tokens_total",
                "Committed generation tokens by SLO class (per-class "
                "goodput numerator)", ("replica", "class"))
            self._slo_ttft = r.histogram(
                "dllm_slo_ttft_seconds",
                "Arrival to first committed tokens, by SLO class",
                ("replica", "class"), LATENCY_BUCKETS)
            self._slo_latency = r.histogram(
                "dllm_slo_latency_seconds",
                "Arrival to completion, by SLO class",
                ("replica", "class"), LATENCY_BUCKETS)
        else:
            for attr in ("_requests", "_tokens", "_blocks", "_ticks",
                         "_kv_uploads", "_early_exits", "_host_elided",
                         "_megasteps", "_megastep_ticks", "_tick_s",
                         "_stage_s", "_queue_wait", "_ttft", "_latency",
                         "_active", "_queue_depth", "_drift",
                         "_drift_scale", "_pool_pages", "_prefix_pages",
                         "_page_evictions", "_preempt_events",
                         "_req_by_policy", "_slo_requests",
                         "_slo_violations", "_slo_tokens", "_slo_ttft",
                         "_slo_latency"):
                setattr(self, attr, getattr(_root, attr))
        # pre-bound label handles for the tick hot path: label validation
        # and key construction happen once here, not per tick
        rep = self.replica
        self._b_ticks = self._ticks.labels(replica=rep)
        self._b_tokens = self._tokens.labels(replica=rep)
        self._b_blocks = self._blocks.labels(replica=rep)
        self._b_kv = self._kv_uploads.labels(replica=rep)
        self._b_elided = self._host_elided.labels(replica=rep)
        self._b_megasteps = self._megasteps.labels(replica=rep)
        self._b_megastep_ticks = self._megastep_ticks.labels(replica=rep)
        self._b_tick_s = self._tick_s.labels(replica=rep)
        self._b_active = self._active.labels(replica=rep)
        self._b_queue = self._queue_depth.labels(replica=rep)
        self._b_scale = self._drift_scale.labels(replica=rep)
        self._b_pages = {state: self._pool_pages.labels(replica=rep,
                                                        state=state)
                         for state in ("in_use", "free_canvas", "free_kv",
                                       "cached")}
        self._b_prefix_hit = self._prefix_pages.labels(replica=rep,
                                                       result="hit")
        self._b_prefix_miss = self._prefix_pages.labels(replica=rep,
                                                        result="miss")
        self._b_evictions = self._page_evictions.labels(replica=rep)
        # last-seen pool counter values: the pool keeps lifetime totals,
        # the registry counters advance by the per-tick delta
        self._pool_seen = {"hits": 0, "misses": 0, "evictions": 0}
        # per-class SLO state, replica-local: lazily bound label handles
        # plus a bounded reservoir behind slo_summary() (/v1/stats)
        self._b_slo: Dict[str, Dict[str, object]] = {}
        self._slo_stats: Dict[str, dict] = {}
        self._stage_handles: Dict[str, object] = {}
        self._drift_handles: Dict[str, object] = {}
        self._tick_count = 0
        # drift gauges re-derive ratios over all stages; refreshing every
        # tick would dominate the hook budget for no scrape-visible gain
        self.drift_refresh_ticks = 16

    def for_replica(self, name: str) -> "ServingObs":
        """Labeled view sharing this root's registry, trace buffer, event
        log, and SLO class table."""
        return ServingObs(self.registry, self.trace, replica=name,
                          _root=self)

    def set_event_log(self, events: Optional[EventLog]) -> "ServingObs":
        """Attach the structured event log (call on the root *before*
        ``for_replica`` so every view shares the sink)."""
        self.events = events
        return self

    def set_slo_classes(self, classes) -> "ServingObs":
        """Install an SLO tier table (call on the root before
        ``for_replica``).  Accepts a ready ``{name: SLOClass}`` dict or
        any ``repro_torch.obs.slo.resolve_classes`` spec (overlay mapping or
        JSON string)."""
        if isinstance(classes, dict) and classes and all(
                isinstance(v, slo_lib.SLOClass) for v in classes.values()):
            self.slo_classes = dict(classes)
        else:
            self.slo_classes = slo_lib.resolve_classes(classes)
        return self

    # -- structured event log (repro_torch.obs.events) ----------------------

    def event(self, event: str, uid: Optional[int] = None,
              trace: str = "", cls: str = "",
              t: Optional[float] = None, **fields) -> None:
        """Emit one lifecycle edge to the shared event log (no-op until a
        log is attached — one attr check on the disabled path)."""
        ev = self.events
        if ev is not None:
            ev.emit(event, uid, replica=self.replica, trace=trace,
                    cls=cls, t=t, **fields)

    # -- per-class SLO accounting -------------------------------------------

    def _slo_handles(self, cls: str) -> Dict[str, object]:
        h = self._b_slo.get(cls)
        if h is None:
            rep = self.replica
            kw = {"class": cls}
            h = self._b_slo[cls] = {
                "completed": self._slo_requests.labels(
                    replica=rep, event="completed", **kw),
                "shed": self._slo_requests.labels(
                    replica=rep, event="shed", **kw),
                "tokens": self._slo_tokens.labels(replica=rep, **kw),
                "ttft": self._slo_ttft.labels(replica=rep, **kw),
                "latency": self._slo_latency.labels(replica=rep, **kw),
            }
        return h

    def slo_summary(self) -> Dict[str, dict]:
        """Per-class rollup for /v1/stats: counts, violation kinds,
        percentile TTFT/latency, and the deadlines in force."""
        out: Dict[str, dict] = {}
        for cls in sorted(self._slo_stats):
            st = self._slo_stats[cls]
            sc = slo_lib.get_class(self.slo_classes, cls)

            def _fin(v):
                return None if v is None or v != v or v == float("inf") \
                    else v
            out[cls] = {
                "completed": st["completed"], "shed": st["shed"],
                "tokens": st["tokens"],
                "violations": dict(st["violations"]),
                "ttft_p50_s": _pctl(st["ttft"], 0.50),
                "ttft_p99_s": _pctl(st["ttft"], 0.99),
                "latency_p50_s": _pctl(st["latency"], 0.50),
                "latency_p99_s": _pctl(st["latency"], 0.99),
                "deadlines": {
                    "ttft_s": _fin(sc.ttft_deadline_s),
                    "latency_s": _fin(sc.latency_deadline_s),
                    "queue_s": _fin(sc.queue_deadline_s),
                },
            }
        return out

    def set_drift_model(self, modeled: Mapping[str, float],
                        calibrate: bool = True,
                        host_stages: tuple = ()) -> "ServingObs":
        """Arm the drift monitor with modeled per-tick stage seconds
        (see obs.drift.modeled_tick_stages).  ``host_stages`` names the
        host-wall-clock stages (dispatch/device_sync under megatick) kept
        out of the hardware-scale calibration."""
        self.drift = DriftMonitor(modeled, calibrate=calibrate,
                                  host_stages=host_stages)
        return self

    # -- request lifecycle (engine hooks) -----------------------------------

    def request_queued(self, uid: int, trace: str = "",
                       cls: str = "") -> None:
        self._requests.inc(replica=self.replica, event="queued")
        if self.trace.enabled:
            args = {"replica": self.replica}
            if trace:
                args["trace"] = trace      # the log<->trace join key
            if cls:
                args["class"] = cls
            self.trace.begin_async("request", id=uid, args=args)

    def request_admitted(self, uid: int, queue_wait_s: float) -> None:
        self._requests.inc(replica=self.replica, event="admitted")
        self._queue_wait.observe(queue_wait_s, replica=self.replica)
        if self.trace.enabled:
            self.trace.instant_async(
                "admitted", id=uid,
                args={"queue_wait_s": round(queue_wait_s, 6)})

    def request_first_commit(self, uid: int, ttft_s: float) -> None:
        self._ttft.observe(ttft_s, replica=self.replica)
        if self.trace.enabled:
            self.trace.instant_async("first_commit", id=uid,
                                     args={"ttft_s": round(ttft_s, 6)})

    def block_committed(self, uid: int, block_idx: int, tick: int,
                        n_tokens: int, positions=None,
                        tokens=None) -> None:
        self._b_blocks.inc()
        if self.trace.enabled:
            args = {"tick": tick, "block_idx": block_idx,
                    "n_tokens": n_tokens}
            if positions is not None:
                args["positions"] = [int(p) for p in positions]
                args["tokens"] = [int(t) for t in tokens]
            self.trace.instant_async("block_committed", id=uid, args=args)

    def tokens_committed(self, n: int) -> None:
        if n > 0:
            self._b_tokens.inc(n)

    def request_done(self, uid: int, latency_s: float, ticks: int,
                     ttft_s: Optional[float] = None, cls: str = "",
                     trace: str = "", tokens: int = 0
                     ) -> Tuple[str, ...]:
        """Completion accounting.  With an SLO class the per-class series
        advance and the class deadlines classify the request; the missed
        kinds are returned so the engine can stamp them on the ``done``
        event record.  ``trace`` also lands as the exemplar on the
        completed-requests counter (the metrics<->trace join)."""
        self._requests.inc(replica=self.replica, event="completed",
                           exemplar=({"trace_id": trace} if trace
                                     else None))
        self._latency.observe(latency_s, replica=self.replica)
        kinds: Tuple[str, ...] = ()
        if cls:
            sc = slo_lib.get_class(self.slo_classes, cls)
            h = self._slo_handles(sc.name)
            h["completed"].inc()
            h["latency"].observe(latency_s)
            if ttft_s is not None:
                h["ttft"].observe(ttft_s)
            if tokens > 0:
                h["tokens"].inc(tokens)
            kinds = sc.violations(ttft_s, latency_s)
            st = self._slo_stats.setdefault(sc.name, _new_slo_stat())
            st["completed"] += 1
            st["tokens"] += tokens
            for vals, v in ((st["ttft"], ttft_s),
                            (st["latency"], latency_s)):
                if v is not None:
                    vals.append(v)
                    if len(vals) > _SLO_RESERVOIR:
                        del vals[:_SLO_RESERVOIR // 2]
            for k in kinds:
                self._slo_violations.inc(replica=self.replica, kind=k,
                                         **{"class": sc.name})
                st["violations"][k] = st["violations"].get(k, 0) + 1
        if self.trace.enabled:
            args = {"latency_s": round(latency_s, 6), "ticks": ticks}
            if trace:
                args["trace"] = trace
            if cls:
                args["class"] = cls
            if kinds:
                args["violations"] = list(kinds)
            self.trace.end_async("request", id=uid, args=args)
        return kinds

    def request_shed(self, uid: int, cls: str = "", trace: str = "",
                     deadline: bool = False) -> None:
        """Shed accounting; ``deadline=True`` (queue-wait/SLO deadline
        expiry) additionally counts a ``kind="shed"`` violation for the
        class."""
        self._requests.inc(replica=self.replica, event="shed")
        if cls:
            sc = slo_lib.get_class(self.slo_classes, cls)
            self._slo_handles(sc.name)["shed"].inc()
            st = self._slo_stats.setdefault(sc.name, _new_slo_stat())
            st["shed"] += 1
            if deadline:
                self._slo_violations.inc(replica=self.replica,
                                         kind="shed",
                                         **{"class": sc.name})
                st["violations"]["shed"] = \
                    st["violations"].get("shed", 0) + 1
        if self.trace.enabled:
            args = {"shed": True}
            if trace:
                args["trace"] = trace
            if cls:
                args["class"] = cls
            self.trace.end_async("request", id=uid, args=args)

    # -- tick (engine hook) -------------------------------------------------

    def tick(self, stage_seconds: Mapping[str, float], dt: float,
             active_slots: int, queued: int,
             t_start_us: Optional[float] = None) -> None:
        """One engine tick: histogram the stage split, refresh gauges,
        feed drift, and (when tracing) emit the tick span with the stage
        sub-spans back-dated to the measured boundaries."""
        self._tick_count += 1
        self._b_ticks.inc()
        self._b_tick_s.observe(dt)
        handles = self._stage_handles
        for stage, s in stage_seconds.items():
            h = handles.get(stage)
            if h is None:
                h = handles[stage] = self._stage_s.labels(
                    replica=self.replica, stage=stage)
            h.observe(s)
        self._b_active.set(active_slots)
        self._b_queue.set(queued)
        if self.drift is not None:
            self.drift.observe_tick(stage_seconds)
            self.drift.observe("tick", dt)
            if self._tick_count == 1 \
                    or self._tick_count % self.drift_refresh_ticks == 0:
                self._refresh_drift_gauges()
        if self.trace.enabled and t_start_us is not None:
            # complete (ph X) events built in one list, one lock: the
            # stage boundaries were measured by the engine, so tracing a
            # tick re-reads no clocks
            tr = self.trace
            pid, tid = tr.pid, tr._tid()
            t = t_start_us
            evs = [{"ph": "X", "name": "tick", "cat": "engine",
                    "ts": t_start_us, "dur": 0.0, "pid": pid, "tid": tid,
                    "args": {"active_slots": active_slots,
                             "queued": queued}}]
            for stage, s in stage_seconds.items():
                evs.append({"ph": "X", "name": stage, "cat": "engine",
                            "ts": t, "dur": s * 1e6, "pid": pid,
                            "tid": tid})
                t += s * 1e6
            evs[0]["dur"] = max(t - t_start_us, dt * 1e6)
            evs.append({"ph": "C", "name": "slots", "cat": "engine",
                        "ts": t_start_us, "pid": pid, "tid": tid,
                        "args": {"active": active_slots,
                                 "queued": queued}})
            tr.emit_many(evs)

    def _refresh_drift_gauges(self) -> None:
        handles = self._drift_handles
        for stage, ratio in self.drift.ratios().items():
            if ratio is None:
                continue
            h = handles.get(stage)
            if h is None:
                h = handles[stage] = self._drift.labels(
                    replica=self.replica, stage=stage)
            h.set(ratio)
        self._b_scale.set(self.drift.scale)

    def kv_valid_upload(self) -> None:
        self._b_kv.inc()

    def host_syncs_elided(self, n: int = 1) -> None:
        if n > 0:
            self._b_elided.inc(n)

    def megastep(self, n_ticks: int, k_req: int, dt: float,
                 t_start_us: Optional[float] = None) -> None:
        """One fused megatick dispatch of ``n_ticks`` (<= requested
        ``k_req``) denoising ticks taking ``dt`` seconds end to end.  The
        per-tick attribution already flowed through :meth:`tick`; this
        records the dispatch-level shape (and, when tracing, a megastep
        span the back-dated tick spans nest under)."""
        self._b_megasteps.inc()
        self._b_megastep_ticks.observe(n_ticks)
        if self.trace.enabled and t_start_us is not None:
            tr = self.trace
            tr.emit_many([{"ph": "X", "name": "megastep", "cat": "engine",
                           "ts": t_start_us, "dur": dt * 1e6, "pid": tr.pid,
                           "tid": tr._tid(),
                           "args": {"n_ticks": n_ticks, "k_req": k_req}}])

    def policy_early_exit(self, n: int = 1) -> None:
        if n > 0:
            self._early_exits.inc(n, replica=self.replica)

    # -- paged pool (engine hooks, docs/paged_cache.md) ---------------------

    def request_policy(self, name: str) -> None:
        """Admission under an effective step policy (engine-global or
        per-request override)."""
        self._req_by_policy.inc(replica=self.replica, policy=name)

    def request_preempted(self, uid: int) -> None:
        self._preempt_events.inc(replica=self.replica, event="spill")
        if self.trace.enabled:
            self.trace.instant_async("preempted", id=uid)

    def request_restored(self, uid: int) -> None:
        self._preempt_events.inc(replica=self.replica, event="restore")
        if self.trace.enabled:
            self.trace.instant_async("restored", id=uid)

    def pool_pages(self, pool) -> None:
        """Refresh page-occupancy gauges and advance the prefix/eviction
        counters by the pool's lifetime-total deltas (one call per tick)."""
        self._b_pages["in_use"].set(pool.pages_in_use)
        self._b_pages["free_canvas"].set(pool.free_canvas_pages)
        self._b_pages["free_kv"].set(pool.free_kv_pages)
        self._b_pages["cached"].set(pool.cached_pages)
        seen = self._pool_seen
        d = pool.prefix_hits - seen["hits"]
        if d > 0:
            self._b_prefix_hit.inc(d)
            seen["hits"] = pool.prefix_hits
        d = pool.prefix_misses - seen["misses"]
        if d > 0:
            self._b_prefix_miss.inc(d)
            seen["misses"] = pool.prefix_misses
        d = pool.evictions - seen["evictions"]
        if d > 0:
            self._b_evictions.inc(d)
            seen["evictions"] = pool.evictions

    def drift_report(self) -> Optional[dict]:
        return None if self.drift is None else self.drift.report()


def frontend_metrics(registry: Registry):
    """HTTP-layer counters (created once per root registry)."""
    http = registry.counter("dllm_http_requests_total",
                            "HTTP responses by route and status code",
                            ("route", "code"))
    submits = registry.counter("dllm_router_submits_total",
                               "Requests routed to each replica",
                               ("replica",))
    overloaded = registry.counter(
        "dllm_router_overloaded_total",
        "Submissions refused by every replica (HTTP 429)", ())
    return http, submits, overloaded
