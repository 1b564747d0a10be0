"""Async load generator for the streaming frontend (real HTTP surface): a
copy of src/repro/serving/frontend/loadgen.py.

Drives ``POST /v1/completions`` with Poisson arrivals (or a replayed
trace), one connection per request, parsing the SSE stream exactly like a
real client: TTFT is the wall time to the first ``block_committed`` event,
latency to the ``done`` event, and 429/``overloaded`` answers count as
shed.  Prints the aggregate report as JSON.

    PYTHONPATH=src python -m repro_torch.serving.frontend.loadgen \
        --url http://127.0.0.1:8080 --rate 50 --requests 32 --max-tokens 16

Trace replay (``--trace trace.json``) expects a JSON list of
``{"at": seconds, "prompt_len": int, "max_tokens": int}`` rows.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
import urllib.parse
from typing import List, Optional

import numpy as np


_READ_LIMIT = 8 << 20   # SSE `done` lines carry full token_ids + text:
                        # far above asyncio's 64 KiB default line limit


async def _open(url: str):
    u = urllib.parse.urlsplit(url)
    return await asyncio.open_connection(u.hostname, u.port,
                                         limit=_READ_LIMIT)


async def _read_headers(reader) -> int:
    """Consume the status line + headers, return the HTTP status."""
    status_line = await reader.readline()
    parts = status_line.split()
    if len(parts) < 2:
        raise ConnectionError(f"bad status line {status_line!r}")
    status = int(parts[1])
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            return status


async def get_text(url: str, path: str) -> str:
    reader, writer = await _open(url)
    host = urllib.parse.urlsplit(url).netloc
    writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()
    status = await _read_headers(reader)
    body = await reader.read()
    writer.close()
    if status != 200:
        raise RuntimeError(f"GET {path} -> {status}: {body[:200]!r}")
    return body.decode("utf-8")


async def get_json(url: str, path: str) -> dict:
    return json.loads(await get_text(url, path))


async def scrape_metrics(url: str) -> dict:
    """One ``/metrics`` scrape, parsed and schema-checked.  Returns
    ``{series: {labels: value}}`` (repro_torch.obs.parse_exposition);
    raises on HTTP errors or malformed exposition."""
    from repro_torch.obs import parse_exposition, validate_histogram
    parsed = parse_exposition(await get_text(url, "/metrics"))
    for name in ("dllm_tick_seconds", "dllm_request_latency_seconds"):
        samples = {k: v for k, v in parsed.items()
                   if k.startswith(name)}
        if samples:
            validate_histogram(samples, name)
    return parsed


async def complete(url: str, prompt_ids: List[int], max_tokens: int,
                   stream: bool = True, timeout: float = 120.0,
                   slo_class: Optional[str] = None,
                   traceparent: Optional[str] = None) -> dict:
    """One completion request -> a per-request result row.

    Row fields: status ("ok" | "shed" | "error"), ttft_s, latency_s,
    completion_tokens, text, token_ids, ticks (event tick numbers, for
    the monotone-ordering assertion), ticks_monotone, positions (all
    streamed commit positions, in arrival order), trace_id (the server's
    trace context, from the done payload).

    ``slo_class`` rides in the request body (the server validates it
    against its tier table); ``traceparent`` sends a client-minted W3C
    trace context header.

    ``timeout`` bounds the whole request wall time: TCP accepts raced
    against a server shutdown can die silently in the closed listener's
    backlog, and a client without a deadline would wait on them forever.
    """
    try:
        return await asyncio.wait_for(
            _complete_inner(url, prompt_ids, max_tokens, stream,
                            slo_class, traceparent), timeout)
    except asyncio.TimeoutError:
        return {"status": "error",
                "error": f"client timeout after {timeout}s"}


async def _complete_inner(url: str, prompt_ids: List[int],
                          max_tokens: int, stream: bool,
                          slo_class: Optional[str] = None,
                          traceparent: Optional[str] = None) -> dict:
    t_sub = time.perf_counter()
    reader, writer = await _open(url)
    req: dict = {"prompt": [int(t) for t in prompt_ids],
                 "max_tokens": int(max_tokens),
                 "stream": bool(stream)}
    if slo_class is not None:
        req["slo_class"] = slo_class
    body = json.dumps(req).encode()
    host = urllib.parse.urlsplit(url).netloc
    extra = f"traceparent: {traceparent}\r\n" if traceparent else ""
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n"
                  f"{extra}"
                  f"Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    try:
        status = await _read_headers(reader)
        if status == 429:
            await reader.read()
            return {"status": "shed", "http": 429}
        if status != 200:
            payload = await reader.read()
            return {"status": "error", "http": status,
                    "body": payload[:200].decode("utf-8", "replace")}
        if not stream:
            payload = json.loads(await reader.read())
            return {"status": "ok", "ttft_s": payload.get("ttft_s"),
                    "latency_s": time.perf_counter() - t_sub,
                    "completion_tokens":
                        payload["usage"]["completion_tokens"],
                    "text": payload["choices"][0]["text"],
                    "token_ids": payload["choices"][0]["token_ids"],
                    "trace_id": payload.get("trace_id"),
                    "ticks": [], "ticks_monotone": True, "positions": []}
        return await _consume_sse(reader, t_sub)
    finally:
        writer.close()


async def _consume_sse(reader, t_sub: float) -> dict:
    row = {"status": "error", "ttft_s": None, "latency_s": None,
           "completion_tokens": 0, "text": None, "token_ids": None,
           "ticks": [], "ticks_monotone": True, "positions": []}
    event_name = None
    async for raw in reader:
        line = raw.decode("utf-8").rstrip("\n").rstrip("\r")
        if line.startswith("event: "):
            event_name = line[len("event: "):]
            continue
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            break
        payload = json.loads(data)
        if event_name == "block_committed":
            if row["ttft_s"] is None:
                row["ttft_s"] = time.perf_counter() - t_sub
            if row["ticks"] and payload["tick"] <= row["ticks"][-1]:
                row["ticks_monotone"] = False
            row["ticks"].append(payload["tick"])
            row["positions"].extend(payload["positions"])
            row["completion_tokens"] += len(payload["tokens"])
        elif event_name == "done":
            row["status"] = "ok"
            row["latency_s"] = time.perf_counter() - t_sub
            row["text"] = payload["choices"][0]["text"]
            row["token_ids"] = payload["choices"][0]["token_ids"]
            row["trace_id"] = payload.get("trace_id")
        elif event_name == "error":
            row["status"] = ("shed" if payload["error"]["type"]
                             == "overloaded" else "error")
            row["error"] = payload["error"]
    return row


def _pctl(vals: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals), q)) if vals else 0.0


async def run_load(url: str, *, rate: float = 50.0, n_requests: int = 32,
                   prompt_len: int = 16, max_tokens: int = 16,
                   seed: int = 0, stream: bool = True,
                   trace: Optional[List[dict]] = None,
                   window_s: Optional[float] = None,
                   scrape: bool = False,
                   class_mix: Optional[dict] = None) -> dict:
    """Fire the workload and aggregate client-side percentiles.

    Poisson mode draws exponential inter-arrivals at ``rate`` req/s;
    trace mode replays explicit ``{"at", "prompt_len", "max_tokens"}``
    rows (optionally carrying ``"slo_class"``).  Goodput counts only
    completed requests' generated tokens — shed requests contribute zero.

    ``class_mix`` maps SLO class name -> weight (need not sum to 1);
    each request draws its ``slo_class`` from that distribution and the
    report gains a ``by_class`` section with per-class completed/shed
    counts, goodput tokens, and TTFT/latency percentiles — the mixed-
    class signal to hold against the server-side
    ``dllm_slo_violations_total`` accounting.

    ``window_s`` switches to a fixed-window open-loop measurement:
    arrivals fill exactly [0, window_s), stragglers are awaited but only
    requests that *finish* inside the window count toward goodput, and
    the denominator is the window itself.  That removes the drain-tail
    from the comparison, so configs of different capacity are measured
    over identical saturated intervals (the 1 vs 2 replica benchmark
    relies on this).  Without it, goodput is completed tokens over the
    full wall time to the last event.
    """
    info = (await get_json(url, "/v1/models"))["data"][0]
    vocab = int(info["vocab"])
    rs = np.random.RandomState(seed)
    if trace is not None:
        arrivals = [float(t["at"]) for t in trace]
        plens = [int(t["prompt_len"]) for t in trace]
        gens = [int(t["max_tokens"]) for t in trace]
    else:
        if window_s is not None:
            n_requests = max(1, int(np.ceil(rate * window_s * 1.2)))
        arrivals = np.cumsum(
            rs.exponential(1.0 / rate, size=n_requests)).tolist()
        if window_s is not None:
            arrivals = [a for a in arrivals if a < window_s] or [0.0]
        plens = [prompt_len] * len(arrivals)
        gens = [max_tokens] * len(arrivals)
    n = len(arrivals)
    prompts = [rs.randint(0, vocab - 2, size=(p,)).tolist() for p in plens]
    classes: Optional[List[Optional[str]]] = None
    if class_mix:
        names = sorted(class_mix)
        w = np.asarray([float(class_mix[k]) for k in names], dtype=float)
        w = w / w.sum()
        classes = [str(names[j]) for j in rs.choice(len(names), size=n,
                                                    p=w)]
    elif trace is not None and any("slo_class" in t for t in trace):
        classes = [t.get("slo_class") for t in trace]

    t0 = time.perf_counter()

    async def fire(i: int) -> dict:
        delay = t0 + arrivals[i] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        cls = classes[i] if classes is not None else None
        try:
            row = await complete(url, prompts[i], gens[i], stream=stream,
                                 slo_class=cls)
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                ValueError) as e:      # ValueError: line-limit overrun
            row = {"status": "error", "error": repr(e)}
        row["i"] = i
        row["slo_class"] = cls
        row["end_s"] = time.perf_counter() - t0
        return row

    # mid-run /metrics scrape (--scrape-metrics): proves the endpoint
    # serves a parseable exposition *while* worker threads are ticking,
    # and that counters only move forward between scrapes
    scrape_mid: Optional[dict] = None

    async def scraper() -> Optional[dict]:
        await asyncio.sleep(max(0.05, arrivals[-1] / 2 if arrivals else 0))
        return await scrape_metrics(url)

    tasks = [fire(i) for i in range(n)]
    if scrape:
        mid_task = asyncio.ensure_future(scraper())
        rows = await asyncio.gather(*tasks)
        scrape_mid = await mid_task
    else:
        rows = await asyncio.gather(*tasks)
    duration = max((r["end_s"] for r in rows), default=0.0)
    ok = [r for r in rows if r["status"] == "ok"]
    shed = [r for r in rows if r["status"] == "shed"]
    errors = [r for r in rows if r["status"] == "error"]
    if window_s is not None:
        good_tokens = sum(r["completion_tokens"] for r in ok
                          if r["end_s"] <= window_s)
        good_denom = window_s
    else:
        good_tokens = sum(r["completion_tokens"] for r in ok)
        good_denom = duration
    offered_rps = (n / arrivals[-1] if arrivals and arrivals[-1] > 0
                   else float(rate))
    out = {
        "n_requests": n,
        "offered_rps": offered_rps,
        "completed": len(ok),
        "shed": len(shed),
        "errors": len(errors),
        "shed_rate": len(shed) / n if n else 0.0,
        "duration_s": duration,
        "window_s": window_s,
        "good_tokens": good_tokens,
        "goodput_tok_s": good_tokens / good_denom if good_denom > 0
                         else 0.0,
        "ttft_p50_s": _pctl([r["ttft_s"] for r in ok
                             if r.get("ttft_s") is not None], 50),
        "ttft_p99_s": _pctl([r["ttft_s"] for r in ok
                             if r.get("ttft_s") is not None], 99),
        "latency_p50_s": _pctl([r["latency_s"] for r in ok], 50),
        "latency_p99_s": _pctl([r["latency_s"] for r in ok], 99),
        "ticks_monotone": all(r.get("ticks_monotone", True) for r in ok),
    }
    if classes is not None:
        by_class = {}
        for name in sorted({c for c in classes if c is not None}):
            rows_c = [r for r in rows if r.get("slo_class") == name]
            okc = [r for r in rows_c if r["status"] == "ok"]
            by_class[name] = {
                "requests": len(rows_c),
                "completed": len(okc),
                "shed": sum(1 for r in rows_c if r["status"] == "shed"),
                "errors": sum(1 for r in rows_c
                              if r["status"] == "error"),
                "good_tokens": sum(r["completion_tokens"] for r in okc),
                "ttft_p50_s": _pctl([r["ttft_s"] for r in okc
                                     if r.get("ttft_s") is not None], 50),
                "ttft_p99_s": _pctl([r["ttft_s"] for r in okc
                                     if r.get("ttft_s") is not None], 99),
                "latency_p50_s": _pctl([r["latency_s"] for r in okc], 50),
                "latency_p99_s": _pctl([r["latency_s"] for r in okc], 99),
            }
        out["by_class"] = by_class
    if scrape:
        out["metrics"] = await _metrics_report(url, scrape_mid)
    return out


def _counter_total(parsed: dict, series: str) -> float:
    return sum(parsed.get(series, {}).values())


async def _metrics_report(url: str, mid: Optional[dict]) -> dict:
    """Final scrape vs the mid-run one: exposition parses, counters are
    monotone, and the core series exist with per-replica labels."""
    end = await scrape_metrics(url)
    counters = [s for s in end if s.endswith("_total")]
    monotone = all(
        end.get(s, {}).get(lbl, 0.0) >= v - 1e-9
        for s in counters if mid and s in mid
        for lbl, v in mid[s].items())
    replicas = {lbl for lbl in end.get("dllm_ticks_total", {})}
    return {
        "scrapes": 2 if mid is not None else 1,
        "series": len(end),
        "counters_monotone": bool(monotone),
        "replica_series": sorted(replicas),
        "ticks_total": _counter_total(end, "dllm_ticks_total"),
        "tokens_committed_total":
            _counter_total(end, "dllm_tokens_committed_total"),
        "requests_completed_total": sum(
            v for lbl, v in end.get("dllm_requests_total", {}).items()
            if 'event="completed"' in lbl),
        "stage_series": sorted({
            lbl for lbl in end.get("dllm_tick_stage_seconds_count", {})}),
        "drift": {lbl: v
                  for lbl, v in end.get("dllm_drift_ratio", {}).items()},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True,
                    help="frontend base URL, e.g. http://127.0.0.1:8080")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson offered load, requests/s")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-stream", action="store_true",
                    help="gathered JSON responses instead of SSE")
    ap.add_argument("--trace", default=None,
                    help="JSON trace file to replay instead of Poisson")
    ap.add_argument("--window", type=float, default=None,
                    help="fixed-window mode: offer load for this many "
                         "seconds; goodput counts only in-window "
                         "completions (see run_load)")
    ap.add_argument("--scrape-metrics", action="store_true",
                    help="scrape /metrics mid-run and at the end; the "
                         "report gains a 'metrics' section (parse + "
                         "monotonicity checks)")
    ap.add_argument("--class-mix", default=None,
                    help="JSON object of slo_class -> weight, e.g. "
                         '\'{"interactive": 0.3, "standard": 0.7}\'; '
                         "each request draws its class and the report "
                         "gains a per-class 'by_class' section")
    args = ap.parse_args(argv)
    trace = None
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    class_mix = json.loads(args.class_mix) if args.class_mix else None
    report = asyncio.run(run_load(
        args.url, rate=args.rate, n_requests=args.requests,
        prompt_len=args.prompt_len, max_tokens=args.max_tokens,
        seed=args.seed, stream=not args.no_stream, trace=trace,
        window_s=args.window, scrape=args.scrape_metrics,
        class_mix=class_mix))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
