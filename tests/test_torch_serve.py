"""The port's serving command (``python -m repro_torch.launch.serve``) on
the CPU: the engine path (with breakdown, a trace and an event log), the
legacy path and the HTTP path run with ``--device cpu``; without it and
with no card the command raises; ``--mesh`` and
``--compilation-cache-dir`` exit with a message; the flags and synthetic
requests equal the JAX command's."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch import obs as tobs
from repro_torch.launch import serve
from repro_torch.serving import frontend

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--arch", "qwen2-0.5b", "--batch", "2",
         "--prompt-len", "16", "--gen-len", "16", "--block-len", "8",
         "--steps", "4", "--requests", "2"]


def test_engine_path_with_breakdown_trace_and_event_log(tmp_path, capsys):
    trace, log = str(tmp_path / "t.json"), str(tmp_path / "e.jsonl")
    serve.main(SMALL + ["--breakdown", "--trace-out", trace,
                        "--event-log", log])
    out = capsys.readouterr().out
    assert "engine: slots=2 mode=warm" in out
    assert "stage breakdown:" in out and "sampling:" in out
    assert "forward:" in out and "drift (calibrated" in out
    with open(trace) as f:
        tobs.validate_trace(json.load(f))
    summary = tobs.validate_events(tobs.read_events(log),
                                   require_terminal=True)
    assert summary["uids"] == {uid: "DONE" for uid in range(1, 5)}
    q = subprocess.run([sys.executable, "-m", "repro_torch.obs.logquery",
                        log, "--validate"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert q.returncode == 0, q.stderr
    assert q.stdout.startswith("OK:")


@pytest.mark.parametrize("extra", [["--megatick", "4"],
                                   ["--pool", "paged", "--mode", "none"],
                                   ["--policy", "slowfast", "--mixed"],
                                   ["--sampling-fmt", "mxint4"],
                                   ["--sampling-fmt", "fp6", "--megatick",
                                    "4"]],
                         ids=["megatick", "paged", "slowfast-mixed",
                              "sampling-mxint4", "sampling-fp6-megatick"])
def test_engine_path_options(extra, capsys):
    serve.main(SMALL + extra)
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and "request latency p50" in out


@pytest.mark.parametrize("cache", ["none", "dual", "prefix"])
def test_legacy_path(cache, capsys):
    serve.main(SMALL + ["--legacy", "--cache", cache])
    out = capsys.readouterr().out
    assert "steady-state TPS" in out and f"cache={cache}" in out


def test_http_path(monkeypatch, tmp_path, capsys):
    """--http serves until interrupted: stand in for the wait with one
    streamed request, then drain."""
    from repro_torch.serving.frontend import loadgen
    rows = []

    async def serve_one(fe):
        await fe.start()
        try:
            rows.append(await loadgen.complete(fe.url, list(range(16)), 16))
        finally:
            await fe.shutdown()

    monkeypatch.setattr(frontend, "serve_forever", serve_one)
    log = str(tmp_path / "e.jsonl")
    serve.main(SMALL + ["--http", "0", "--slots", "1", "--mode", "none",
                        "--event-log", log, "--trace-out",
                        str(tmp_path / "t.json")])
    assert rows[0]["status"] == "ok"
    assert sorted(rows[0]["positions"]) == list(range(16, 32))
    assert "--- replica-0 ---" in capsys.readouterr().out
    tobs.validate_events(tobs.read_events(log), require_terminal=True)


def test_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(SMALL[2:])                  # no --device cpu
    # --mesh runs (tests/test_torch_spmd.py); a mesh of more ranks than
    # this process's job has refuses, pointing at the launcher
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        serve.main(SMALL + ["--mesh", "2,1"])
    with pytest.raises(SystemExit, match="XLA"):
        serve.main(SMALL + ["--compilation-cache-dir", "x"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve.main(SMALL + ["--legacy", "--http", "0"])


def test_requests_and_flags_equal_jax():
    argv = SMALL[2:] + ["--mixed", "--requests", "3"]
    jargs = jserve.build_parser().parse_args(argv)
    targs = serve.build_parser().parse_args(SMALL[:2] + argv)
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)

    class Cfg:
        vocab = 1000
    j = jserve.make_requests(jargs, Cfg, 3)
    t = serve.make_requests(targs, Cfg, 3)
    assert [(r.prompt.tolist(), r.gen_length) for r in t] == \
        [(r.prompt.tolist(), r.gen_length) for r in j]
    assert all(isinstance(r.prompt, np.ndarray) for r in t)


def test_drift_armed_for_dense_configs():
    """make_obs arms drift for every arch the port registers (all six
    families), as JAX's serve does."""
    args = serve.build_parser().parse_args(SMALL)
    from repro_torch.configs import base
    archs = sorted(base.REGISTRY)
    assert len(archs) == 12
    for arch in archs:
        cfg = base.get_config(arch)
        obs = serve.make_obs(args, cfg, serve.make_dcfg(args), 2, 32)
        assert obs.drift is not None, arch
