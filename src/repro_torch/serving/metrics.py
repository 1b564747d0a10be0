"""Latency/throughput tracking for the serving engine: a copy of
src/repro/serving/metrics.py (pure Python and numpy).

Per-request records give queueing + end-to-end latency percentiles; per-tick
records give slot occupancy; optional per-stage device timings reproduce the
paper's Fig. 1 forward-vs-sampling breakdown for the serving path.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    uid: int
    arrival: float
    gen_tokens: int
    admitted: Optional[float] = None
    first_commit: Optional[float] = None   # first tick that committed tokens
    completed: Optional[float] = None
    shed: Optional[float] = None           # cancelled while queued
    ticks: int = 0

    @property
    def latency(self) -> float:
        return self.completed - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.admitted - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first committed tokens (a dLLM commits a confidence-
        ordered *set* of positions per tick, so this is the streaming TTFT:
        the first ``block_committed`` event, not the first left-to-right
        suffix token)."""
        return self.first_commit - self.arrival


class MetricsTracker:
    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.requests: Dict[int, RequestRecord] = {}
        self.seen_uids: set = set()         # every uid ever submitted
        self.stage_s: Dict[str, float] = defaultdict(float)
        self._tick_s: List[float] = []
        self._tick_active: List[int] = []
        self.elapsed: float = 0.0
        # running aggregates of records folded away by compact() — an
        # online server would otherwise grow per-request/per-tick state
        # without bound (offline runs never compact, so these stay zero)
        self._folded_done = 0
        self._folded_shed = 0
        self._folded_tokens = 0
        self._folded_ticks = 0
        self._folded_busy = 0.0
        self._folded_active_s = 0.0         # sum(active_slots * tick_s)

    # -- recording ----------------------------------------------------------

    def request_arrived(self, uid: int, arrival: float, gen_tokens: int):
        self.requests[uid] = RequestRecord(uid, arrival, gen_tokens)
        self.seen_uids.add(int(uid))

    def request_admitted(self, uid: int, now: float):
        self.requests[uid].admitted = now

    def request_first_commit(self, uid: int, now: float):
        self.requests[uid].first_commit = now

    def request_shed(self, uid: int, now: float):
        self.requests[uid].shed = now

    def request_completed(self, uid: int, now: float, ticks: int):
        rec = self.requests[uid]
        rec.completed = now
        rec.ticks = ticks

    def record_tick(self, seconds: float, active_slots: int):
        self._tick_s.append(seconds)
        self._tick_active.append(active_slots)

    def record_stage(self, name: str, seconds: float):
        self.stage_s[name] += seconds

    def compact(self, keep: int = 4096) -> None:
        """Bound memory for server lifetimes: fold *finished* (completed or
        shed) request records and per-tick samples beyond the most recent
        ``keep`` into the running aggregates.  Totals (counts, tokens,
        busy time, occupancy) stay exact; percentiles afterwards reflect
        the kept window.  ``seen_uids`` is never pruned — duplicate-uid
        rejection must outlive the records."""
        finished = [r for r in self.requests.values()
                    if r.completed is not None or r.shed is not None]
        if len(finished) > keep:
            for r in finished[:-keep]:
                if r.completed is not None:
                    self._folded_done += 1
                    self._folded_tokens += r.gen_tokens
                else:
                    self._folded_shed += 1
                del self.requests[r.uid]
        if len(self._tick_s) > keep:
            drop_s, self._tick_s = (self._tick_s[:-keep],
                                    self._tick_s[-keep:])
            drop_a, self._tick_active = (self._tick_active[:-keep],
                                         self._tick_active[-keep:])
            self._folded_ticks += len(drop_s)
            self._folded_busy += sum(drop_s)
            self._folded_active_s += sum(a * s
                                         for a, s in zip(drop_a, drop_s))

    # -- aggregation --------------------------------------------------------

    def summary(self) -> dict:
        # summary() is scraped from the HTTP thread while a worker thread
        # ticks: snapshot shared containers with C-atomic list()/dict()
        # copies, and truncate the two tick lists to their common length
        # (record_tick appends them one at a time, so a scrape can land
        # between the appends)
        records = list(self.requests.values())
        done = [r for r in records if r.completed is not None]
        shed = [r for r in records if r.shed is not None]
        lat = np.array([r.latency for r in done]) if done else np.zeros(0)
        wait = np.array([r.queue_wait for r in done]) if done else np.zeros(0)
        ttfts = [r.ttft for r in done if r.first_commit is not None]
        ttft = np.array(ttfts) if ttfts else np.zeros(0)
        raw_s, raw_a = list(self._tick_s), list(self._tick_active)
        n = min(len(raw_s), len(raw_a))
        tick_s = np.array(raw_s[:n])
        active = np.array(raw_a[:n], dtype=np.float64)
        busy = float(tick_s.sum()) + self._folded_busy
        tokens = sum(r.gen_tokens for r in done) + self._folded_tokens
        active_s = float((active * tick_s).sum()) + self._folded_active_s
        occupancy = (active_s / (self.num_slots * busy)
                     if busy > 0 else 0.0)
        elapsed = self.elapsed if self.elapsed > 0 else busy
        n_done = len(done) + self._folded_done
        n_shed = len(shed) + self._folded_shed
        n_seen = len(self.seen_uids)
        out = {
            "requests_completed": n_done,
            "requests_shed": n_shed,
            # shed fraction of everything that arrived (completed or not)
            "shed_rate": n_shed / n_seen if n_seen else 0.0,
            "gen_tokens": tokens,
            "ticks": len(tick_s) + self._folded_ticks,
            "busy_s": busy,
            "elapsed_s": elapsed,
            # steady-state throughput: completed tokens over time the
            # engine was actually ticking (excludes idle/fast-forward gaps)
            "tokens_per_s": tokens / busy if busy > 0 else 0.0,
            # goodput: completed tokens over the full wall window (idle
            # included) — shed/abandoned work contributes nothing, so this
            # is the number a capacity planner compares against offered
            # load, and it is <= tokens_per_s whenever the engine idled
            "goodput_tok_s": tokens / elapsed if elapsed > 0 else 0.0,
            "slot_occupancy": occupancy,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttfts else 0.0,
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttfts else 0.0,
            "latency_p50_s": float(np.percentile(lat, 50)) if done else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if done else 0.0,
            "queue_wait_p50_s": float(np.percentile(wait, 50)) if done else 0.0,
        }
        stage_s = dict(self.stage_s)
        total_stage = sum(stage_s.values())
        for name, s in sorted(stage_s.items()):
            out[f"stage_{name}_s"] = s
            if total_stage > 0:
                out[f"stage_{name}_frac"] = s / total_stage
        return out

    def format_summary(self) -> str:
        s = self.summary()
        lines = [
            f"requests: {s['requests_completed']}  "
            f"shed: {s['requests_shed']}  "
            f"ticks: {s['ticks']}  gen tokens: {s['gen_tokens']}",
            f"steady-state TPS: {s['tokens_per_s']:.1f}  "
            f"goodput: {s['goodput_tok_s']:.1f} tok/s  "
            f"slot occupancy: {s['slot_occupancy'] * 100:.0f}%",
            f"TTFT p50: {s['ttft_p50_s'] * 1e3:.1f} ms  "
            f"p99: {s['ttft_p99_s'] * 1e3:.1f} ms",
            f"request latency p50: {s['latency_p50_s'] * 1e3:.1f} ms  "
            f"p99: {s['latency_p99_s'] * 1e3:.1f} ms  "
            f"queue wait p50: {s['queue_wait_p50_s'] * 1e3:.1f} ms",
        ]
        stages = [(k[len("stage_"):-len("_frac")], v)
                  for k, v in s.items() if k.endswith("_frac")]
        if stages:
            lines.append("stage breakdown: " + "  ".join(
                f"{name}: {frac * 100:.0f}%" for name, frac in stages))
        return "\n".join(lines)
