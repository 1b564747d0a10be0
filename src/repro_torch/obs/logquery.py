"""Query CLI for the structured serving event log (repro_torch.obs.events).

``python -m repro_torch.obs.logquery LOG.jsonl [filters] [action]``

Filters (AND-combined):
  --uid N          one request
  --replica NAME   one replica
  --event NAME     one event type
  --class NAME     one SLO class
  --trace ID       one trace id (links to Perfetto/exemplars)

Actions (default: summary):
  --summary        record/request counts by event, class, replica
  --timeline UID   reconstruct one request's lifecycle, dt from submit
  --rollup         per-class p50/p99 queue-wait / TTFT / latency rollups
  --records        print the matching records as JSON lines
  --validate       schema + lifecycle check (repro_torch.obs.events
                   .validate_events); exit 1 on violation

Timings prefer the engine-relative ``t`` field (virtual-clock seconds,
comparable within a replica) and fall back to wall ``ts``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.obs.events import read_events, validate_events


def _pctl(vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a sorted copy (matches
    serving/metrics.py conventions)."""
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(q * len(vs)))]


def _t(rec: dict) -> float:
    t = rec.get("t")
    return float(t if t is not None else rec.get("ts", 0.0))


def filter_records(records: List[dict], *, uid: Optional[int] = None,
                   replica: Optional[str] = None,
                   event: Optional[str] = None,
                   cls: Optional[str] = None,
                   trace: Optional[str] = None) -> List[dict]:
    out = []
    for r in records:
        if uid is not None and r.get("uid") != uid:
            continue
        if replica is not None and r.get("replica") != replica:
            continue
        if event is not None and r.get("event") != event:
            continue
        if cls is not None and r.get("cls") != cls:
            continue
        if trace is not None and r.get("trace") != trace:
            continue
        out.append(r)
    return out


def summarize(records: List[dict]) -> dict:
    by_event: Dict[str, int] = {}
    by_class: Dict[str, int] = {}
    by_replica: Dict[str, int] = {}
    uids = set()
    for r in records:
        by_event[r.get("event", "?")] = by_event.get(r.get("event", "?"),
                                                     0) + 1
        if r.get("uid") is not None:
            uids.add(r["uid"])
        if r.get("event") == "submit":
            c = r.get("cls", "") or "standard"
            by_class[c] = by_class.get(c, 0) + 1
        rep = r.get("replica", "")
        if rep:
            by_replica[rep] = by_replica.get(rep, 0) + 1
    return {"records": len(records), "requests": len(uids),
            "by_event": by_event, "by_class": by_class,
            "by_replica": by_replica}


def timeline(records: List[dict], uid: int) -> List[dict]:
    """One request's records in log order, annotated with ``dt_s`` from
    its submit edge."""
    recs = [r for r in records if r.get("uid") == uid]
    if not recs:
        return []
    t0 = next((_t(r) for r in recs if r.get("event") == "submit"),
              _t(recs[0]))
    return [dict(r, dt_s=round(_t(r) - t0, 6)) for r in recs]


def rollup(records: List[dict]) -> dict:
    """Per-class percentile rollups from each request's lifecycle edges:
    queue wait (submit->admit), TTFT (submit->first block_commit), and
    latency (submit->done), plus completed/shed/violation counts."""
    per_uid: Dict[int, dict] = {}
    for r in records:
        uid = r.get("uid")
        if uid is None:
            continue
        d = per_uid.setdefault(uid, {"cls": "standard"})
        ev = r.get("event")
        if ev == "submit":
            d["submit"] = _t(r)
            d["cls"] = r.get("cls", "") or "standard"
        elif ev == "admit" and "admit" not in d:
            d["admit"] = _t(r)
        elif ev == "block_commit" and "first_commit" not in d:
            d["first_commit"] = _t(r)
        elif ev == "done":
            d["done"] = _t(r)
            d["violations"] = r.get("violations", [])
        elif ev == "shed":
            d["shed"] = True
    out: Dict[str, dict] = {}
    for d in per_uid.values():
        c = out.setdefault(d["cls"], {
            "requests": 0, "completed": 0, "shed": 0, "violations": 0,
            "_qw": [], "_ttft": [], "_lat": []})
        c["requests"] += 1
        t0 = d.get("submit")
        if d.get("shed"):
            c["shed"] += 1
        if "done" in d:
            c["completed"] += 1
            c["violations"] += len(d.get("violations", []))
            if t0 is not None:
                c["_lat"].append(d["done"] - t0)
                if "admit" in d:
                    c["_qw"].append(d["admit"] - t0)
                if "first_commit" in d:
                    c["_ttft"].append(d["first_commit"] - t0)
    for c in out.values():
        for key, name in (("_qw", "queue_wait"), ("_ttft", "ttft"),
                          ("_lat", "latency")):
            vals = c.pop(key)
            c[f"{name}_p50_s"] = round(_pctl(vals, 0.50), 6)
            c[f"{name}_p99_s"] = round(_pctl(vals, 0.99), 6)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.logquery",
        description="query a structured serving event log (JSONL)")
    ap.add_argument("path", help="event log file (JSONL)")
    ap.add_argument("--uid", type=int, default=None)
    ap.add_argument("--replica", default=None)
    ap.add_argument("--event", default=None)
    ap.add_argument("--class", dest="cls", default=None,
                    help="SLO class filter")
    ap.add_argument("--trace", default=None, help="trace id filter")
    ap.add_argument("--summary", action="store_true",
                    help="counts by event/class/replica (default action)")
    ap.add_argument("--timeline", type=int, default=None, metavar="UID",
                    help="per-request lifecycle timeline")
    ap.add_argument("--rollup", action="store_true",
                    help="per-class p50/p99 rollups")
    ap.add_argument("--records", action="store_true",
                    help="print matching records as JSON lines")
    ap.add_argument("--validate", action="store_true",
                    help="schema + lifecycle validation (exit 1 on fail)")
    args = ap.parse_args(argv)

    records = read_events(args.path)
    recs = filter_records(records, uid=args.uid, replica=args.replica,
                          event=args.event, cls=args.cls,
                          trace=args.trace)

    if args.validate:
        try:
            res = validate_events(recs)
        except ValueError as e:
            print(f"INVALID: {e}")
            return 1
        print(f"OK: {res['records']} records, "
              f"{len(res['uids'])} requests")
        return 0
    if args.timeline is not None:
        rows = timeline(recs, args.timeline)
        if not rows:
            print(f"no records for uid {args.timeline}")
            return 1
        for r in rows:
            extra = {k: v for k, v in r.items()
                     if k not in ("v", "ts", "t", "uid", "replica",
                                  "event", "dt_s")}
            print(f"+{r['dt_s']:.6f}s {r['event']:<16} "
                  f"{json.dumps(extra, sort_keys=True)}")
        return 0
    if args.rollup:
        print(json.dumps(rollup(recs), sort_keys=True, indent=2))
        return 0
    if args.records:
        for r in recs:
            print(json.dumps(r, sort_keys=True))
        return 0
    # default: summary
    s = summarize(recs)
    print(f"{s['records']} records, {s['requests']} requests")
    for ev in sorted(s["by_event"]):
        print(f"  event {ev:<16} {s['by_event'][ev]}")
    for c in sorted(s["by_class"]):
        print(f"  class {c:<16} {s['by_class'][c]}")
    for rep in sorted(s["by_replica"]):
        print(f"  replica {rep:<14} {s['by_replica'][rep]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
