"""Crash-safe structured event log for request-scoped serving telemetry.

Aggregate metrics (registry.py) answer "how many requests shed"; this
module answers *which* request, *when*, and *why*: one JSON record per
request lifecycle edge — submit / admit / prefix_hit / preempt / spill /
restore / evict / shed / policy_decision / early_exit / block_commit /
done — emitted by the engine, scheduler paths, paged pool, and router
(docs/observability.md has the full event catalog).

Design constraints, in order:

  * **Hot-path cheap.**  :meth:`EventLog.emit` sits next to the engine's
    commit loop: it builds one flat dict and appends it to a bounded
    in-memory ring under a lock.  JSON serialization and file I/O happen
    on the background flusher thread, never on the tick path.
  * **Crash-safe.**  The sink is an append-only JSONL file: every flush
    writes whole ``\\n``-terminated lines and fsyncs, so a crash loses at
    most the unflushed tail of the ring plus (worst case) one torn final
    line — which :func:`read_events` detects and skips.  Records are
    never rewritten in place.
  * **Bounded.**  Both the in-memory tail (:meth:`EventLog.tail`) and the
    unflushed write queue are capped at ``capacity`` records; if the
    producer outruns the flusher the *oldest* unflushed records drop and
    ``dropped`` counts them — memory stays bounded under overload, like
    the trace collector's ring.

Every record is schema-versioned (``"v"``) and machine-checkable:
:func:`validate_events` verifies field shapes and replays each request's
lifecycle through a state machine (submit -> admit -> commits -> done,
with preempt/restore excursions), so a missing or out-of-order edge is a
hard error, not a silent analysis gap.  ``python -m repro_torch.obs.logquery``
is the reader (filters, per-request timelines, percentile rollups).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Union

SCHEMA_VERSION = 1

# The event catalog (docs/observability.md).  Request-scoped events carry
# the request uid; pool- and engine-level events (prefix_hit, spill,
# restore, evict, early_exit) may carry uid=None.
EVENT_TYPES = frozenset({
    "submit",           # request entered an engine queue
    "admit",            # queued request took a batch slot
    "prefix_hit",       # prompt pages served from the radix prefix cache
    "preempt",          # admitted request spilled to host (request edge)
    "spill",            # pool copied a slot's pages to host (page edge)
    "restore",          # spilled request re-admitted into fresh pages
    "evict",            # LRU reclaimed cached canvas pages
    "shed",             # request dropped before completion
    "policy_decision",  # scheduler picked an admission/preemption action
    "early_exit",       # SlowFast whole-block early-exit commits
    "block_commit",     # tokens committed on a tick (streaming unit)
    "done",             # request completed
})

# Events that are valid without a request uid.
_UIDLESS = frozenset({"prefix_hit", "spill", "restore", "evict",
                      "early_exit"})

_REQUIRED = ("v", "ts", "event", "uid", "replica")


def _json_default(o):
    """Serialize numpy scalars/arrays lazily at flush time, so emit()
    never converts on the tick path."""
    import numpy as np
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


class EventLog:
    """Bounded ring of structured event records with an async JSONL sink.

    ``path=None`` keeps records purely in memory (tests, offline runs);
    with a path, a daemon flusher appends JSONL every
    ``flush_interval_s`` seconds (plus a final flush on :meth:`close`).
    One EventLog is shared by every replica of a frontend — the emit
    lock makes the append order a total order across replicas.
    """

    def __init__(self, path: Optional[str] = None, *,
                 capacity: int = 65536,
                 flush_interval_s: float = 0.25,
                 autoflush: bool = True,
                 fsync: bool = True,
                 clock: Callable[[], float] = time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = path
        self.capacity = int(capacity)
        self.fsync = fsync
        self._clock = clock
        self._lock = threading.Lock()
        # in-memory tail (always kept, even with a file sink)
        self._recent: collections.deque = collections.deque(
            maxlen=self.capacity)
        # unflushed write queue (file sink only)
        self._pending: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.emitted = 0
        self.flushed = 0
        self.dropped = 0        # oldest unflushed records lost to the ring
        self._file = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if path is not None:
            self._file = open(path, "a", encoding="utf-8")
            if autoflush:
                self._thread = threading.Thread(
                    target=self._flush_loop, name="event-log-flush",
                    daemon=True)
                self._interval = float(flush_interval_s)
                self._thread.start()

    # -- hot path -----------------------------------------------------------

    def emit(self, event: str, uid: Optional[int] = None, *,
             replica: str = "", trace: str = "", cls: str = "",
             t: Optional[float] = None, **fields) -> None:
        """Record one lifecycle edge.  ``t`` is the engine's virtual-clock
        seconds (relative timings); ``ts`` (wall clock) is stamped here.
        Extra ``fields`` ride along verbatim — ndarray/numpy values are
        converted at flush time, not here."""
        rec = {"v": SCHEMA_VERSION, "ts": self._clock(), "event": event,
               "uid": uid, "replica": replica}
        if trace:
            rec["trace"] = trace
        if cls:
            rec["cls"] = cls
        if t is not None:
            rec["t"] = t
        if fields:
            rec.update(fields)
        with self._lock:
            self.emitted += 1
            self._recent.append(rec)
            if self._file is not None:
                if len(self._pending) == self.capacity:
                    self.dropped += 1    # deque evicts the oldest unflushed
                self._pending.append(rec)

    # -- flush / read -------------------------------------------------------

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.flush()

    def flush(self) -> int:
        """Drain the pending queue to the JSONL sink (whole lines, then
        fsync).  Serialization happens here, off the tick path.  Returns
        the number of records written."""
        if self._file is None:
            return 0
        with self._lock:
            if not self._pending:
                return 0
            batch = list(self._pending)
            self._pending.clear()
        lines = "".join(
            json.dumps(rec, default=_json_default, separators=(",", ":"))
            + "\n" for rec in batch)
        f = self._file
        f.write(lines)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        with self._lock:
            self.flushed += len(batch)
        return len(batch)

    def close(self) -> None:
        """Stop the flusher, write the remaining tail, close the file."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._file is not None:
            self.flush()
            self._file.close()
            self._file = None

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """Most recent records (in-memory ring), oldest first."""
        with self._lock:
            recent = list(self._recent)
        return recent if n is None else recent[-n:]

    def stats(self) -> dict:
        with self._lock:
            return {"emitted": self.emitted, "flushed": self.flushed,
                    "dropped": self.dropped,
                    "pending": len(self._pending),
                    "capacity": self.capacity, "path": self.path}

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str, strict: bool = False) -> List[dict]:
    """Parse a JSONL event log.  A torn final line (crash mid-write) is
    skipped unless ``strict``; a torn line anywhere else is always an
    error (flushes write whole lines, so that means corruption)."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1 and not strict:
                break                      # torn tail from a crash
            raise ValueError(f"{path}:{i + 1}: corrupt event record")
    return out


# request lifecycle state machine for validate_events
_LIFECYCLE = {
    # state -> {event: next state}
    "QUEUED": {"admit": "ACTIVE", "shed": "SHED",
               "policy_decision": "QUEUED"},
    "ACTIVE": {"block_commit": "ACTIVE", "preempt": "PREEMPTED",
               "done": "DONE", "policy_decision": "ACTIVE"},
    "PREEMPTED": {"restore": "ACTIVE", "policy_decision": "PREEMPTED"},
}


def validate_events(records: Union[Iterable[dict], Iterable[str]],
                    require_terminal: bool = False) -> dict:
    """Schema + lifecycle validation; raises ``ValueError`` on the first
    violation.  ``records`` may be dicts or raw JSONL lines.

    Checks, per record: schema version, known event type, ts numeric,
    uid shape (int for request-scoped events).  Across records: each
    uid's edges must replay through the lifecycle state machine (submit
    first; commits only while active; preempt/restore pair; nothing
    after done/shed).  ``require_terminal`` additionally demands every
    uid reached done or shed (drained-run logs).

    Returns a summary: record count, per-event counts, per-uid final
    states.
    """
    by_event: Dict[str, int] = {}
    state: Dict[int, str] = {}
    n = 0
    for i, rec in enumerate(records):
        if isinstance(rec, (str, bytes)):
            rec = json.loads(rec)
        if not isinstance(rec, dict):
            raise ValueError(f"record {i}: not an object: {rec!r}")
        missing = [k for k in _REQUIRED if k not in rec]
        if missing:
            raise ValueError(f"record {i}: missing fields {missing}")
        if rec["v"] != SCHEMA_VERSION:
            raise ValueError(
                f"record {i}: schema version {rec['v']!r} != "
                f"{SCHEMA_VERSION}")
        ev = rec["event"]
        if ev not in EVENT_TYPES:
            raise ValueError(f"record {i}: unknown event {ev!r}")
        if not isinstance(rec["ts"], (int, float)):
            raise ValueError(f"record {i}: ts must be a number")
        uid = rec["uid"]
        if uid is None:
            if ev not in _UIDLESS:
                raise ValueError(
                    f"record {i}: event {ev!r} requires a request uid")
        elif not isinstance(uid, int):
            raise ValueError(f"record {i}: uid must be int or null, "
                             f"got {uid!r}")
        else:
            st = state.get(uid)
            if st is None:
                if ev != "submit":
                    raise ValueError(
                        f"record {i}: first event for uid {uid} is "
                        f"{ev!r}, expected 'submit'")
                state[uid] = "QUEUED"
            elif st in ("DONE", "SHED"):
                raise ValueError(
                    f"record {i}: event {ev!r} for uid {uid} after "
                    f"terminal state {st}")
            else:
                nxt = _LIFECYCLE[st].get(ev)
                if nxt is None:
                    raise ValueError(
                        f"record {i}: illegal edge {ev!r} for uid {uid} "
                        f"in state {st}")
                state[uid] = nxt
        by_event[ev] = by_event.get(ev, 0) + 1
        n += 1
    if require_terminal:
        open_uids = sorted(u for u, st in state.items()
                           if st not in ("DONE", "SHED"))
        if open_uids:
            raise ValueError(
                f"uids without a terminal done/shed event: {open_uids}")
    return {"records": n, "by_event": by_event,
            "uids": {u: st for u, st in state.items()}}
