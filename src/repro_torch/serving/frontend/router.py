"""Replica workers + multi-replica request router: a copy of
src/repro/serving/frontend/router.py over the port's engine.

Each :class:`EngineWorker` owns one
:class:`~repro_torch.serving.ServingEngine` and drives its tick loop on a
dedicated thread — engine state is only ever touched from that thread.
The asyncio HTTP layer talks to workers through two thread-safe seams:

  * ``submit()`` appends to a small staging deque under a lock (drained
    into ``engine.submit()`` between ticks) and applies the admission
    bound *synchronously*, so overload answers (429) never wait on a tick;
  * commit/shed events flow back through the ``deliver`` callable the
    caller provides (the server wraps ``loop.call_soon_threadsafe``).

PyTorch releases the GIL inside its kernels and while the host waits on
the card, so N workers tick their engines concurrently.  A graphed
engine captures its CUDA graphs in ``warmup()``, on the thread that
builds it (``build_frontend`` warms every replica before any worker
starts): under the global capture mode a CUDA call from another thread
during a capture fails, so a worker's ticks only replay, and a worker
raises if a tick captured a graph.

Backpressure (docs/streaming_serving.md): a request is accepted iff

    queued < max_queue + free_slots

``queued`` counts staging + engine queue (never admitted work) and
``free_slots`` is the worker's cache-pool occupancy snapshot — when slots
are free the bound stretches so the pool can refill in one loop, when the
pool is full the queue is hard-bounded at ``max_queue``.  Queued requests
additionally shed once their wait exceeds ``max_queue_wait``.

The :class:`Router` load-balances across workers: ``rr`` (rotating start)
or ``least_loaded`` (min ``pending`` = queued + active), with failover to
the next candidate when the preferred replica refuses, and graceful drain
on shutdown (stop accepting, tick until empty, join).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.kernels import _build
from repro_torch.serving import scheduler as scheduler_lib
from repro_torch.serving.engine import CommitEvent, Request, ServingEngine

# --profile-ticks writes its traces under <repository>/build/dllm-profile
PROFILE_DIR = _build.BUILD_DIR.parent / "dllm-profile"
_PROFILER_LOCK = threading.Lock()


class Overloaded(RuntimeError):
    """Admission refused: bounded queue full or replica draining (HTTP 429
    at the server; the router tries the next candidate first)."""


@dataclasses.dataclass
class ShedEvent:
    """Terminal event for a request dropped *before* any commit.
    ``slo_class`` reports the shed request's tier so per-class violation
    accounting (and the 429 body) can name it."""
    uid: int
    reason: str
    slo_class: str = ""


class EngineWorker:
    """One serving replica: an engine plus the thread that ticks it."""

    def __init__(self, engine: ServingEngine, name: str = "replica-0",
                 max_queue: Optional[int] = None,
                 max_queue_wait: Optional[float] = None,
                 tick_floor_s: Optional[float] = None,
                 profile_ticks: int = 0,
                 profile_dir: Optional[str] = None,
                 slo_classes: Optional[dict] = None):
        self.engine = engine
        self.name = name
        # --profile-ticks N: wrap the first N productive ticks of this
        # replica in a torch.profiler trace (CPU and CUDA activity, a
        # Chrome-trace JSON under profile_dir/<name>, by default under the
        # repository's build/); 0 disables.  One profiler runs at a time:
        # replicas take turns
        self.profile_ticks = int(profile_ticks)
        self.profile_dir = str(profile_dir or PROFILE_DIR)
        self._profiled = 0
        self._profiler = None
        self.profile_path: Optional[str] = None
        self.max_queue = (2 * engine.num_slots if max_queue is None
                          else max_queue)
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        self.max_queue_wait = max_queue_wait
        # per-class queue deadlines (repro_torch.obs.slo): the shed path uses
        # the tighter of max_queue_wait and each request's class
        # queue_deadline_s.  Defaults to the engine obs class table.
        if slo_classes is None and engine.obs is not None:
            slo_classes = getattr(engine.obs, "slo_classes", None)
        self.slo_classes = slo_classes
        self._class_deadlines = bool(slo_classes) and any(
            c.queue_deadline_s is not None for c in slo_classes.values())
        # Optional device-paced tick emulation: sleep out the remainder of
        # ``tick_floor_s`` after each tick's host work.  On a real
        # accelerator the tick is device-bound and the host sits idle, so
        # replica throughput scales with device count; on a small CI host
        # the same experiment would otherwise be bound by host cores.  The
        # sleep releases the GIL exactly like a device wait does, making
        # the serving layer (admission, routing, streaming) the measured
        # quantity.  None (default, production) = tick flat out.
        self.tick_floor_s = tick_floor_s
        self._lock = threading.Lock()
        self._staging: List = []          # (Request, deliver) pairs
        self._sinks: Dict[int, Callable] = {}   # uid -> deliver (shed path)
        self._wake = threading.Event()
        self._stop = False
        self._abort = False
        self._thread: Optional[threading.Thread] = None
        self._epoch = time.perf_counter()
        self.accepting = True
        # load snapshots, refreshed every loop; racy reads are benign and
        # at most one tick stale (the admission bound absorbs the skew)
        self.free_slots = engine.pool.free_slots
        self.queued = 0
        self.active = 0
        self.completed = 0
        self.shed_count = 0
        # paged engines also key admission off page occupancy: worst-case
        # (no prefix sharing) page need of waiting work vs the free +
        # evictable page snapshot, with a max_queue-shaped allowance —
        # pages_needed is static geometry, so the async thread never
        # touches the engine-owned radix tree
        self.paged = bool(getattr(engine, "paged", False))
        self.free_pages: Optional[int] = None
        self.queued_pages = 0
        if self.paged:
            pool = engine.pool
            self.page_capacity = pool.num_pages - 1
            self._row_pages = pool.pages_needed(engine.max_seq_len)
            self.free_pages = self._free_pages_snapshot()

    def _pages_of(self, request: Request) -> int:
        return self.engine.pool.pages_needed(request.total_len)

    def _free_pages_snapshot(self) -> int:
        """Effective free pages: the tighter of the canvas (free + LRU-
        evictable) and KV stores.  Worker-thread only — cached_pages walks
        the radix node list."""
        pool = self.engine.pool
        free = pool.free_canvas_pages + pool.cached_pages
        if pool.with_cache:
            free = min(free, pool.free_kv_pages)
        return free

    # -- thread-safe surface (called from the event loop) -------------------

    @property
    def load(self) -> int:
        """Pending work: staged + queued + active (least-loaded key)."""
        return self.queued + self.active

    def now_rel(self) -> float:
        """Seconds since worker epoch — the arrival clock requests are
        stamped with (the engine's virtual clock tracks it via measured
        tick durations + idle fast-forwards)."""
        return time.perf_counter() - self._epoch

    def submit(self, request: Request, deliver: Callable) -> None:
        """Stage a request; raises :class:`Overloaded` when refused.
        ``deliver`` must be thread-safe — it fires on the worker thread
        with CommitEvent / ShedEvent objects."""
        with self._lock:
            if not self.accepting:
                raise Overloaded(f"{self.name} is draining")
            if self.queued >= self.max_queue + self.free_slots:
                raise Overloaded(
                    f"{self.name} queue full "
                    f"({self.queued} >= {self.max_queue} + "
                    f"{self.free_slots} free slots)")
            if self.paged:
                need = self._pages_of(request)
                if need > self.page_capacity:
                    raise Overloaded(
                        f"{self.name}: request needs {need} pages per "
                        f"store, pool capacity is {self.page_capacity}")
                budget = self.free_pages + self.max_queue * self._row_pages
                if self.queued_pages + need > budget:
                    raise Overloaded(
                        f"{self.name} page budget exhausted "
                        f"({self.queued_pages} queued + {need} > "
                        f"{self.free_pages} free + "
                        f"{self.max_queue * self._row_pages} queueable)")
                self.queued_pages += need
            request.arrival_time = self.now_rel()
            self._staging.append((request, deliver))
            self.queued += 1
        self._wake.set()

    def start(self) -> "EngineWorker":
        self._thread = threading.Thread(
            target=self._loop, name=f"engine-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop_accepting(self) -> None:
        """Refuse new submissions (fast 429s) without stopping the tick
        loop — phase one of graceful shutdown."""
        with self._lock:
            self.accepting = False

    def shutdown(self, drain: bool = True) -> None:
        """Stop accepting; ``drain=True`` finishes all admitted + queued
        work first, ``drain=False`` sheds everything still pending."""
        with self._lock:
            self.accepting = False
            self._stop = True
            self._abort = self._abort or not drain
        self._wake.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stats(self) -> dict:
        eng = self.engine
        out = {"name": self.name, "accepting": self.accepting,
               "queued": self.queued, "active": self.active,
               "free_slots": self.free_slots, "completed": self.completed,
               "shed": self.shed_count, "max_queue": self.max_queue,
               "kv_valid_uploads": eng.kv_valid_uploads,
               # summary() snapshots defensively, so scraping it from the
               # event-loop thread mid-tick is safe (serving/metrics.py)
               "metrics": eng.metrics.summary()}
        if self.paged:
            out["free_pages"] = self.free_pages
            out["queued_pages"] = self.queued_pages
            out["pool"] = eng.pool.stats()
        if eng.obs is not None and eng.obs.drift is not None:
            out["drift"] = eng.obs.drift_report()
        if eng.obs is not None and hasattr(eng.obs, "slo_summary"):
            out["slo"] = eng.obs.slo_summary()
            if getattr(eng.obs, "events", None) is not None:
                out["events"] = eng.obs.events.stats()
        return out

    # -- worker thread ------------------------------------------------------

    @property
    def _profiling(self) -> bool:
        return self._profiler is not None

    def _profile_start(self) -> None:
        if self._profiling or self._profiled >= self.profile_ticks:
            return
        if not _PROFILER_LOCK.acquire(blocking=False):
            return                  # another replica's window is open
        import torch.profiler as tp
        activities = [tp.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        self._profiler = tp.profile(activities=activities)
        self._profiler.__enter__()

    def _profile_stop_if_done(self, force: bool = False) -> None:
        if not self._profiling:
            return
        if force or self._profiled >= self.profile_ticks:
            import os
            prof, self._profiler = self._profiler, None
            prof.__exit__(None, None, None)
            _PROFILER_LOCK.release()
            d = os.path.join(self.profile_dir, self.name)
            os.makedirs(d, exist_ok=True)
            self.profile_path = os.path.join(
                d, f"ticks-{self._profiled}.pt.trace.json")
            prof.export_chrome_trace(self.profile_path)
            print(f"[{self.name}] wrote torch.profiler trace for "
                  f"{self._profiled} ticks to {self.profile_path}")

    def _on_commit(self, deliver: Callable, ev: CommitEvent) -> None:
        if ev.done:
            self._sinks.pop(ev.uid, None)
        deliver(ev)

    def _shed_expired(self, eng: ServingEngine) -> None:
        # only requests that genuinely *cannot* be admitted shed: with a
        # free slot the next tick admits from the queue, so waiters there
        # are one loop from service, not stuck
        use_classes = self._class_deadlines
        if (self.max_queue_wait is None and not use_classes) \
                or not eng.queue or eng.pool.free_slots > 0:
            return
        now = self.now_rel()
        for r in scheduler_lib.expired_requests(
                eng.queue, now, self.max_queue_wait,
                slo_classes=self.slo_classes if use_classes else None):
            cls = getattr(r, "slo_class", "")
            if eng.cancel(r.uid, reason="deadline"):
                self.shed_count += 1
                sink = self._sinks.pop(r.uid, None)
                if sink is not None:
                    wait = now - r.arrival_time
                    if use_classes:
                        reason = (f"queue wait {wait:.3f}s exceeded the "
                                  f"deadline for slo_class "
                                  f"{cls or 'standard'!r}")
                    else:
                        reason = (f"queue wait {wait:.3f}s exceeded "
                                  f"max_queue_wait "
                                  f"{self.max_queue_wait:.3f}s")
                    sink(ShedEvent(uid=r.uid, reason=reason,
                                   slo_class=cls))

    def _loop(self) -> None:
        # a crashed worker must fail loudly, not strand clients: shed every
        # live sink, refuse new work, and re-raise into the thread log
        try:
            self._loop_inner()
        except BaseException:
            with self._lock:
                self.accepting = False
                staged, self._staging = self._staging, []
            for req, deliver in staged:
                deliver(ShedEvent(uid=req.uid, reason="replica crashed",
                                  slo_class=getattr(req, "slo_class", "")))
            for uid, sink in list(self._sinks.items()):
                sink(ShedEvent(uid=uid, reason="replica crashed"))
            self._sinks.clear()
            raise

    def _loop_inner(self) -> None:
        eng = self.engine
        captures = eng.graph_captures
        while True:
            with self._lock:
                staged, self._staging = self._staging, []
            for req, deliver in staged:
                try:
                    eng.submit(req, on_commit=functools.partial(
                        self._on_commit, deliver))
                    self._sinks[req.uid] = deliver
                except ValueError as e:
                    # the server validates before staging; this is the
                    # belt-and-braces path (e.g. duplicate uid)
                    deliver(ShedEvent(uid=req.uid,
                                      reason=f"rejected: {e}"))
            self._shed_expired(eng)
            if eng.pending:
                # online serving runs on the wall clock: sync the engine's
                # virtual `now` up to real time before the tick, or queued
                # requests (stamped with real arrival times) would look
                # like future arrivals to _admit() and starve the slots
                eng.now = max(eng.now, self.now_rel())
                if self.profile_ticks:
                    self._profile_start()
                t_tick = time.perf_counter()
                # one tick() call may be a K-tick megastep: count *productive
                # ticks* (engine tick counter delta), not calls, so
                # --profile-ticks N captures exactly N ticks at any K —
                # while profiling, cap the megastep at the remaining budget
                prev_ticks = eng.ticks_total
                if self._profiling:
                    progressed = eng.tick(
                        max_ticks=max(1, self.profile_ticks - self._profiled))
                else:
                    progressed = eng.tick()
                n_ticks = eng.ticks_total - prev_ticks
                if eng.graph_captures != captures:
                    raise RuntimeError(
                        f"{self.name}: a tick captured "
                        f"{eng.graph_captures - captures} CUDA graphs on "
                        "the worker thread; capture belongs in warmup()")
                if self._profiling:
                    self._profiled += n_ticks
                    self._profile_stop_if_done()
                if progressed and self.tick_floor_s:
                    # pace by ticks advanced: a K-tick megastep owes K
                    # emulated device waits, not one
                    rem = (self.tick_floor_s * max(1, n_ticks)
                           - (time.perf_counter() - t_tick))
                    if rem > 0:
                        time.sleep(rem)       # emulated device wait
            else:
                progressed = False
            with self._lock:
                self.queued = len(eng.queue) + len(self._staging)
                if self.paged:
                    self.queued_pages = (
                        sum(self._pages_of(r) for r in eng.queue)
                        + sum(self._pages_of(r) for r, _ in self._staging))
            self.active = eng.active_slots
            self.free_slots = eng.pool.free_slots
            if self.paged:
                self.free_pages = self._free_pages_snapshot()
            # results already reached clients through the commit callbacks;
            # nothing reads eng.completed in server mode, so drain it (and
            # periodically fold old metrics records into aggregates) or a
            # long-lived replica grows per-request state without bound
            if eng.completed:
                self.completed += len(eng.completed)
                eng.completed.clear()
                eng.metrics.compact()
            if self._stop:
                if self._abort:
                    # shed *everything* still pending, including requests
                    # staged after this iteration's drain — anything left
                    # in staging here would otherwise strand its client
                    with self._lock:
                        staged, self._staging = self._staging, []
                    for req, deliver in staged:
                        deliver(ShedEvent(uid=req.uid,
                                          reason="server shutdown"))
                    for uid in [r.uid for r in eng.queue]:
                        eng.cancel(uid)
                    for uid, sink in list(self._sinks.items()):
                        sink(ShedEvent(uid=uid, reason="server shutdown"))
                    self._sinks.clear()
                    break
                with self._lock:
                    drained = not eng.pending and not self._staging
                if drained:
                    break
            if not progressed and not staged:
                with self._lock:
                    idle = not self._staging and not self._stop
                if idle:
                    self._wake.wait(timeout=0.1)
                self._wake.clear()
        self._profile_stop_if_done(force=True)
        eng.metrics.elapsed = eng.now


class Router:
    """Load-balances submissions across replica workers."""

    STRATEGIES = ("rr", "least_loaded")

    def __init__(self, workers: Sequence[EngineWorker],
                 strategy: str = "least_loaded"):
        if strategy not in self.STRATEGIES:
            raise ValueError(f"unknown routing strategy {strategy!r}; "
                             f"choose from {list(self.STRATEGIES)}")
        if not workers:
            raise ValueError("router needs at least one worker")
        self.workers = list(workers)
        self.strategy = strategy
        self._rr = 0

    def candidates(self) -> List[EngineWorker]:
        """Accepting workers in preference order for the next submit."""
        live = [w for w in self.workers if w.accepting]
        if not live:
            raise Overloaded("no accepting replicas")
        if self.strategy == "least_loaded":
            order = {id(w): i for i, w in enumerate(self.workers)}
            return sorted(live, key=lambda w: (w.load, order[id(w)]))
        start = self._rr % len(live)
        self._rr += 1
        return live[start:] + live[:start]

    def submit(self, request: Request, deliver: Callable) -> EngineWorker:
        """Submit to the preferred replica, falling through the remaining
        candidates when it refuses; raises Overloaded when all do."""
        err: Optional[Overloaded] = None
        for w in self.candidates():
            try:
                w.submit(request, deliver)
                return w
            except Overloaded as e:
                err = e
        raise err if err is not None else Overloaded("no accepting replicas")

    @property
    def load(self) -> int:
        return sum(w.load for w in self.workers)

    def start(self) -> "Router":
        for w in self.workers:
            w.start()
        return self

    def stop_accepting(self) -> None:
        for w in self.workers:
            w.stop_accepting()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Graceful drain: every replica stops accepting, finishes (or
        sheds, with ``drain=False``) its pending work, and joins."""
        for w in self.workers:
            w.shutdown(drain=drain)
        for w in self.workers:
            w.join(timeout)

    def stats(self) -> dict:
        return {"strategy": self.strategy, "load": self.load,
                "replicas": [w.stats() for w in self.workers]}
