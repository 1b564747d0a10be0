"""The port's observability stack (repro_torch.obs, repro_torch.sim) against
the JAX package's (repro.obs, repro.sim): the same operations give
byte-equal Prometheus/OpenMetrics expositions, trace events equal apart
from timestamps and thread ids, event records equal apart from ``ts``,
and each package's parser and validators accept the other's output.  The
analytical model's per-tick stages are equal (``==``) on llada-8b and
qwen2-0.5b, slot and paged, K 1 and 4."""
import dataclasses
import json
import math

import pytest

from repro import obs as jobs
from repro.configs import base as jbase
from repro.core import diffusion as jdiff
from repro.obs import drift as jdrift
from repro.obs import events as jevents
from repro.obs import slo as jslo
from repro.sim import analytical as jana
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.core import diffusion as tdiff
from repro_torch.obs import drift as tdrift
from repro_torch.obs import events as tevents
from repro_torch.obs import logquery as tlogquery
from repro_torch.obs import slo as tslo
from repro_torch.sim import analytical as tana

PKGS = {"jax": jobs, "port": tobs}
PAIRS = [("jax", "port"), ("port", "jax")]


def _fill_registry(o):
    r = o.Registry()
    c = r.counter("dllm_requests_total", "Requests seen",
                  ("replica", "event"))
    c.inc(replica="replica-0", event="queued")
    c.inc(2, replica="replica-0", event="queued")
    c.inc(replica="replica-1", event="completed",
          exemplar={"trace_id": "ab" * 16})
    g = r.gauge("weird", "escaping", ("k",))
    g.set(1.5, k='a"b\\c\nd')
    g.inc(0.25, k="plain")
    h = r.histogram("lat_seconds", "latency", ("replica",),
                    buckets=o.exp_buckets(1e-3, 10.0, 4))
    for v in (0.0005, 0.005, 0.005, 0.05, 5.0, math.inf):
        h.observe(v, replica="r0")
    b = h.labels(replica="r1")
    b.observe(0.002)
    r.counter("dllm_router_overloaded_total", "refused", ()).inc(3)
    return r


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_byte_equal(monkeypatch, openmetrics):
    import time
    monkeypatch.setattr(time, "time", lambda: 1234.5)   # exemplar stamps
    texts = {k: _fill_registry(o).expose(openmetrics=openmetrics)
             for k, o in PKGS.items()}
    assert texts["port"] == texts["jax"]
    assert jobs.CONTENT_TYPE == tobs.CONTENT_TYPE
    assert jobs.OPENMETRICS_CONTENT_TYPE == tobs.OPENMETRICS_CONTENT_TYPE


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_exposition_parsed_by_the_other_package(writer, reader):
    text = _fill_registry(PKGS[writer]).expose()
    parsed = PKGS[reader].parse_exposition(text)
    assert parsed == PKGS[writer].parse_exposition(text)
    PKGS[reader].validate_histogram(parsed, "lat_seconds")
    with pytest.raises(ValueError):
        PKGS[reader].parse_exposition(text + "\ngarbage line here {")


def _fill_trace(o):
    tr = o.TraceCollector()
    with tr.span("outer", cat="t", args={"n": 1}):
        with tr.span("inner", cat="t"):
            pass
    tr.complete("tick", cat="engine", ts=10.0, dur=2.5,
                args={"active_slots": 2})
    tr.begin_async("request", id=7, args={"trace": "ab" * 16})
    tr.instant_async("admitted", id=7, args={"queue_wait_s": 0.1})
    tr.end_async("request", id=7, args={"latency_s": 0.5})
    tr.instant("mark", cat="t", ts=11.0)
    tr.counter("slots", {"active": 2, "queued": 1}, ts=12.0)
    tr.emit_many([{"ph": "X", "name": "megastep", "cat": "engine",
                   "ts": 13.0, "dur": 4.0, "pid": tr.pid, "tid": tr._tid(),
                   "args": {"n_ticks": 4, "k_req": 8}}])
    return tr


def _strip(events, keys=("ts", "tid")):
    return [{k: v for k, v in e.items() if k not in keys} for e in events]


def test_trace_events_equal_apart_from_clock_and_thread():
    js, ts = (_fill_trace(o).to_json() for o in PKGS.values())
    assert _strip(ts["traceEvents"]) == _strip(js["traceEvents"])
    assert {k: v for k, v in ts.items() if k != "traceEvents"} == \
        {k: v for k, v in js.items() if k != "traceEvents"}


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_trace_validated_by_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "t.json")
    _fill_trace(PKGS[writer]).save(path)
    with open(path) as f:
        PKGS[reader].validate_trace(json.load(f))
    bad = PKGS[writer].TraceCollector()
    bad.begin("left_open")
    with pytest.raises(ValueError, match="unclosed"):
        PKGS[reader].validate_trace(bad.to_json())


def test_event_schema_identical():
    assert tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES


def _fill_events(o, path=None):
    ev = o.EventLog(path, autoflush=False)
    ev.emit("submit", 1, replica="r0", trace="ab" * 16, cls="standard",
            t=0.0, prompt_len=8, gen_length=16)
    ev.emit("policy_decision", 1, replica="r0", t=0.0, kind="admit",
            policy="fifo")
    ev.emit("admit", 1, replica="r0", t=0.0, slot=0, queue_wait_s=0.0)
    ev.emit("prefix_hit", None, replica="r0", slot=0, pages=2)
    ev.emit("block_commit", 1, replica="r0", t=0.1, tick=1, block_idx=0,
            step_in_block=0, positions=[8, 9], tokens=[5, 6], masks_left=6)
    ev.emit("preempt", 1, replica="r0", t=0.2, slot=0, total_len=24)
    ev.emit("spill", None, replica="r0", slot=0, pages=2, total_len=24)
    ev.emit("restore", 1, replica="r0", t=0.3, slot=1, total_len=24)
    ev.emit("block_commit", 1, replica="r0", t=0.4, tick=2, block_idx=0,
            step_in_block=1, committed=8, masks_left=0)
    ev.emit("done", 1, replica="r0", t=0.5, latency_s=0.5, ttft_s=0.1,
            ticks=2, tokens=16, violations=[])
    ev.emit("submit", 2, replica="r0", t=0.0, prompt_len=8, gen_length=8)
    ev.emit("shed", 2, replica="r0", t=0.6, reason="deadline",
            queue_wait_s=0.6)
    ev.emit("early_exit", None, replica="r0", t=0.6, n=1)
    return ev


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_event_log_validated_by_the_other_package(tmp_path, writer,
                                                  reader):
    path = str(tmp_path / "events.jsonl")
    ev = _fill_events(PKGS[writer], path)
    ev.close()
    recs = PKGS[reader].read_events(path)
    summary = PKGS[reader].validate_events(recs, require_terminal=True)
    assert summary == PKGS[writer].validate_events(recs,
                                                   require_terminal=True)
    assert summary["uids"] == {1: "DONE", 2: "SHED"}


def test_event_records_equal_apart_from_wall_clock():
    recs = {k: _strip(_fill_events(o).tail(), ("ts",))
            for k, o in PKGS.items()}
    assert recs["port"] == recs["jax"]


@pytest.mark.parametrize("recs,msg", [
    ([("admit", 1)], "expected 'submit'"),
    ([("submit", 1), ("block_commit", 1)], "illegal edge"),
    ([("submit", 1), ("admit", 1), ("done", 1), ("block_commit", 1)],
     "after terminal"),
    ([("warp", 1)], "unknown event"),
    ([("admit", None)], "requires a request uid"),
])
def test_validators_reject_the_same_logs(recs, msg):
    rows = [{"v": 1, "ts": 0.0, "event": e, "uid": u, "replica": "r0"}
            for e, u in recs]
    for o in PKGS.values():
        with pytest.raises(ValueError, match=msg):
            o.validate_events(rows)


def test_logquery_reads_both_packages_logs(tmp_path, capsys):
    for name, o in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        _fill_events(o, path).close()
        assert tlogquery.main([path, "--validate"]) == 0
        assert "OK: 13 records, 2 requests" in capsys.readouterr().out
        assert tlogquery.main([path, "--timeline", "1"]) == 0
        assert "done" in capsys.readouterr().out


def test_slo_classes_equal():
    for spec in (None, {"interactive": {"ttft_deadline_s": 1.0}},
                 '{"batch": {"queue_deadline_s": 2.0}}'):
        j, t = jslo.resolve_classes(spec), tslo.resolve_classes(spec)
        assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
            {k: dataclasses.asdict(v) for k, v in j.items()}
        for name in list(j) + ["unknown"]:
            jc, tc = jslo.get_class(j, name), tslo.get_class(t, name)
            for ttft, lat in ((None, 0.1), (0.5, 3.0), (30.0, 300.0)):
                assert tc.violations(ttft, lat) == jc.violations(ttft, lat)
            for wait in (None, 0.5, 5.0):
                assert tslo.queue_deadline(tc, wait) == \
                    jslo.queue_deadline(jc, wait)


@pytest.mark.parametrize("megatick_k", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("arch", [
    "llada-8b", "qwen2-0.5b", "llada-moe-7b-a1b", "mamba2-130m",
    "recurrentgemma-2b", "whisper-medium", "internvl2-26b"])
def test_modeled_tick_stages_equal(arch, paged, megatick_k):
    kw = dict(gen_length=64, block_length=16, steps_per_block=8,
              cache_mode="dual")
    stages = [m.modeled_tick_stages(
        b.get_config(arch), d.DiffusionConfig(**kw), batch=4, prompt_len=32,
        megatick_k=megatick_k, host=a.HostConfig(), paged=paged)
        for m, b, d, a in ((jdrift, jbase, jdiff, jana),
                           (tdrift, tbase, tdiff, tana))]
    assert stages[1] == stages[0]
    assert ("paged_io" in stages[1]) == paged


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b",
                                  "whisper-medium", "internvl2-26b"])
def test_analytical_model_covers_every_family(arch):
    """end_to_end gives every family JAX's dense-shaped estimate (no scan,
    no encoder): the same result field for field, in each cache mode."""
    for mode in ("none", "prefix", "dual"):
        got, want = (a.end_to_end(b.get_config(arch), a.HWConfig(), B=4,
                                  prompt=32, gen_len=64, block_len=16,
                                  steps=8, cache_mode=mode)
                     for a, b in ((tana, tbase), (jana, jbase)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_drift_monitor_reports_equal():
    modeled = {"forward": 0.004, "sampling": 0.001, "tick": 0.005,
               "dispatch": 2e-4, "device_sync": 1e-4}
    ticks = [{"host_prep": 1e-4, "forward": 0.02, "sampling": 0.01,
              "dispatch": 3e-4, "device_sync": 2e-4},
             {"host_prep": 2e-4, "forward": 0.03, "sampling": 0.005,
              "dispatch": 1e-4, "device_sync": 1e-4}]
    reports = []
    for m in (jdrift, tdrift):
        mon = m.DriftMonitor(modeled, host_stages=("dispatch",
                                                   "device_sync"))
        for st in ticks:
            mon.observe_tick(st)
            mon.observe("tick", sum(st.values()))
        reports.append(mon.report())
    assert reports[1] == reports[0]
    assert tdrift.HOST_DRIFT_BAND == jdrift.HOST_DRIFT_BAND


def _serving_obs_hooks(o):
    """The engine's and frontend's hook sequence on a root ServingObs with
    two replica views."""
    root = o.ServingObs(trace=o.TraceCollector())
    root.set_slo_classes({"interactive": {"ttft_deadline_s": 0.05}})
    root.set_event_log(o.EventLog(autoflush=False))
    http, submits, over = o.frontend_metrics(root.registry)
    for i, rep in enumerate((root.for_replica("replica-0"),
                             root.for_replica("replica-1"))):
        rep.set_drift_model({"forward": 0.004, "sampling": 0.001,
                             "tick": 0.005})
        rep.request_queued(1, trace="cd" * 16, cls="interactive")
        rep.event("submit", uid=1, trace="cd" * 16, cls="interactive",
                  t=0.0, prompt_len=8, gen_length=16)
        rep.request_admitted(1, 0.01 * (i + 1))
        rep.request_policy("fifo")
        rep.kv_valid_upload()
        rep.request_first_commit(1, 0.1)
        rep.block_committed(1, 0, 3, 2, positions=[8, 9], tokens=[4, 5])
        rep.tokens_committed(2)
        rep.tick({"host_prep": 1e-4, "forward": 0.02, "sampling": 0.01,
                  "host_sync": 1e-4, "commit": 1e-5}, 0.031, 1, 0,
                 t_start_us=100.0)
        rep.host_syncs_elided(2)
        rep.policy_early_exit(1)
        rep.megastep(4, 8, 0.12, t_start_us=200.0)
        rep.request_preempted(1)
        rep.request_restored(1)
        kinds = rep.request_done(1, 0.4, 5, ttft_s=0.1, cls="interactive",
                                 trace="cd" * 16, tokens=16)
        rep.request_shed(2, cls="standard", deadline=True)
        http.inc(route="/v1/completions", code="200")
        submits.inc(replica=rep.replica)
    over.inc()
    return root, kinds, rep


def test_serving_obs_hooks_equal(monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    out = {k: _serving_obs_hooks(o) for k, o in PKGS.items()}
    (jroot, jkinds, jrep), (troot, tkinds, trep) = out["jax"], out["port"]
    for om in (False, True):
        assert troot.registry.expose(openmetrics=om) == \
            jroot.registry.expose(openmetrics=om)
    assert tkinds == jkinds and "ttft" in tkinds
    assert trep.slo_summary() == jrep.slo_summary()
    assert trep.drift_report() == jrep.drift_report()
    assert _strip(troot.trace.events()) == _strip(jroot.trace.events())
    assert _strip(troot.events.tail(), ("ts",)) == \
        _strip(jroot.events.tail(), ("ts",))
