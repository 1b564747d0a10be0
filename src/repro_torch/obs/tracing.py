"""Low-overhead span tracing emitting Chrome-trace / Perfetto JSON.

The collector records Trace Event Format events (the JSON Perfetto and
``chrome://tracing`` open natively, docs/observability.md):

  * **Duration spans** (``ph: B``/``E``) for thread-local work — engine
    tick phases, router hops.  Use :meth:`TraceCollector.span` (context
    manager) or explicit :meth:`begin`/:meth:`end` with overridden
    timestamps when the caller already measured the interval (the engine
    times stages itself and emits the spans after the fact, so tracing
    adds zero extra clock reads to the hot path).
  * **Async spans** (``ph: b``/``n``/``e``, keyed by ``id``) for work that
    crosses threads — the request lifecycle begins on the asyncio thread
    (queued), progresses on a replica worker thread (admitted,
    ``block_committed`` instants, done), and is stitched by uid.
  * **Metadata** (``ph: M``) naming each thread once, so the Perfetto
    timeline shows ``replica-0`` instead of a raw thread id; tids are
    remapped to small ints stable for the collector's lifetime.

All timestamps come from one monotonic clock (``time.perf_counter``),
reported in microseconds, per the trace format.  A disabled collector
(``enabled=False``) costs one attribute check per call; a bounded buffer
(``max_events``) drops *new* events once full (``dropped`` counts them)
so a long-lived server cannot grow the trace without bound.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_CLOCK = time.perf_counter


def now_us() -> float:
    """Collector timebase: monotonic microseconds."""
    return _CLOCK() * 1e6


class TraceCollector:
    """Thread-safe Chrome-trace event buffer."""

    def __init__(self, enabled: bool = True, max_events: int = 1_000_000,
                 pid: int = 1):
        self.enabled = enabled
        self.max_events = max_events
        self.pid = pid
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = threading.Lock()
        # per-thread stable tid: thread-local, NOT keyed by get_ident() —
        # the OS recycles idents of dead threads, which would silently
        # alias two workers onto one lane (and drop one name meta)
        self._tid_local = threading.local()
        self._n_tids = 0

    # -- plumbing -----------------------------------------------------------

    def _tid(self) -> int:
        tid = getattr(self._tid_local, "tid", None)
        if tid is None:
            with self._lock:
                self._n_tids += 1
                tid = self._tid_local.tid = self._n_tids
            # name the lane once so Perfetto shows the thread's role
            self._emit({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "args":
                        {"name": threading.current_thread().name}})
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def emit_many(self, evs: List[dict]) -> None:
        """Append pre-built events under one lock acquisition (the engine
        emits a whole tick's spans in one call)."""
        with self._lock:
            room = self.max_events - len(self._events)
            if room >= len(evs):
                self._events.extend(evs)
            else:
                self._events.extend(evs[:room])
                self.dropped += len(evs) - room

    def _event(self, ph: str, name: str, cat: str,
               ts: Optional[float] = None, *, dur: Optional[float] = None,
               id: Optional[object] = None,
               args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": ph, "name": name, "cat": cat or "default",
              "ts": now_us() if ts is None else ts,
              "pid": self.pid, "tid": self._tid()}
        if dur is not None:
            ev["dur"] = dur
        if id is not None:
            ev["id"] = str(id)
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- duration spans (same-thread) ---------------------------------------

    def begin(self, name: str, cat: str = "", ts: Optional[float] = None,
              args: Optional[dict] = None) -> None:
        self._event("B", name, cat, ts, args=args)

    def end(self, name: str, cat: str = "",
            ts: Optional[float] = None) -> None:
        self._event("E", name, cat, ts)

    def complete(self, name: str, cat: str, ts: float, dur: float,
                 args: Optional[dict] = None) -> None:
        """Complete event (``ph: X``): one event instead of a B/E pair,
        for spans whose duration the caller already measured."""
        self._event("X", name, cat, ts, dur=dur, args=args)

    @contextmanager
    def span(self, name: str, cat: str = "", args: Optional[dict] = None):
        """Duration span around a block; no-ops (one bool check) when the
        collector is disabled."""
        if not self.enabled:
            yield self
            return
        self.begin(name, cat, args=args)
        try:
            yield self
        finally:
            self.end(name, cat)

    # -- async spans (cross-thread, keyed by id) ----------------------------

    def begin_async(self, name: str, id: object, cat: str = "request",
                    ts: Optional[float] = None,
                    args: Optional[dict] = None) -> None:
        self._event("b", name, cat, ts, id=id, args=args)

    def instant_async(self, name: str, id: object, cat: str = "request",
                      ts: Optional[float] = None,
                      args: Optional[dict] = None) -> None:
        self._event("n", name, cat, ts, id=id, args=args)

    def end_async(self, name: str, id: object, cat: str = "request",
                  ts: Optional[float] = None,
                  args: Optional[dict] = None) -> None:
        self._event("e", name, cat, ts, id=id, args=args)

    # -- one-off marks ------------------------------------------------------

    def instant(self, name: str, cat: str = "", ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        self._event("i", name, cat, ts, args=args)

    def counter(self, name: str, values: Dict[str, float], cat: str = "",
                ts: Optional[float] = None) -> None:
        """Perfetto counter track (e.g. active slots / queue depth)."""
        self._event("C", name, cat, ts, args=dict(values))

    # -- output -------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_json(self) -> dict:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


def validate_trace(payload: dict) -> None:
    """Schema check for a saved trace (used by tests and check_bench):

      * every event carries ph/name/ts/pid/tid,
      * duration events pair up: per (pid, tid) the B/E sequence is a
        well-formed bracket string with matching names and non-decreasing
        timestamps,
      * complete events (``X``) carry a non-negative ``dur``,
      * async events pair up per (cat, id): b before e, n only inside.

    Raises ``ValueError`` with the first offending event.
    """
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    stacks: Dict[tuple, list] = {}
    last_ts: Dict[tuple, float] = {}
    async_open: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None or "name" not in ev or "pid" not in ev \
                or "tid" not in ev or ("ts" not in ev and ph != "M"):
            raise ValueError(f"event {i} missing required fields: {ev}")
        if ph == "M":
            continue
        key = (ev["pid"], ev["tid"])
        if ph in ("B", "E"):
            if ev["ts"] < last_ts.get(key, -1.0):
                raise ValueError(
                    f"event {i}: ts went backwards on thread {key}")
            last_ts[key] = ev["ts"]
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append(ev["name"])
            else:
                if not stack:
                    raise ValueError(f"event {i}: E without B: {ev}")
                opened = stack.pop()
                if opened != ev["name"]:
                    raise ValueError(
                        f"event {i}: E {ev['name']!r} closes B {opened!r}")
        elif ph == "X":
            if ev.get("dur", -1.0) < 0:
                raise ValueError(
                    f"event {i}: X without non-negative dur: {ev}")
        elif ph in ("b", "n", "e"):
            akey = (ev.get("cat"), ev.get("id"))
            if ev.get("id") is None:
                raise ValueError(f"event {i}: async event without id")
            if ph == "b":
                async_open[akey] = async_open.get(akey, 0) + 1
            elif ph == "e":
                if async_open.get(akey, 0) <= 0:
                    raise ValueError(f"event {i}: 'e' without 'b': {ev}")
                async_open[akey] -= 1
            elif async_open.get(akey, 0) <= 0:
                raise ValueError(f"event {i}: 'n' outside b..e: {ev}")
    leftovers = {k: v for k, v in stacks.items() if v}
    if leftovers:
        raise ValueError(f"unclosed B spans: {leftovers}")
