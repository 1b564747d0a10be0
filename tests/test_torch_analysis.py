"""The port's static-analysis gate (src/repro_torch/analysis), on the CPU:
each rule fires on a planted source snippet or toy entry point and stays
quiet on its clean twin, as tests/test_analysis.py holds JAX's passes;
``python -m repro_torch.analysis --check`` over the port exits 0 with its
allowlist; stale and unjustified allowlist entries are reported; the NPU
half's footprint table equals JAX's sram_budget table and its allocator
cross-check lies in the band.  ANL-RECAPTURE counts CUDA graph captures,
which exist only on a card: here it reports itself as not run, and
chip_smoke.py runs it on the H100.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import sram_budget as jax_sram
from repro_torch.analysis import (graph_audit, hotpath_lint, locks, registry,
                                  smem_budget)
from repro_torch.analysis.report import Allowlist, Violation, assemble, render

ROOT = Path(__file__).resolve().parents[1]
# a module registered as fully hot ("*"): snippets lint as if they lived
# there, so the hot-path rules apply
HOT_PATH = "repro_torch/core/sampling.py"
COLD_PATH = "repro_torch/launch/dryrun.py"


def _lint(src, relpath=HOT_PATH):
    vs, _ = hotpath_lint.lint_source(relpath, textwrap.dedent(src))
    return vs


def _rules(vs):
    return sorted(v.rule for v in vs)


# ---------------------------------------------------------------------------
# hotpath_lint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["conf.item()", "conf.tolist()",
                                  "conf.cpu()", "conf.numpy()",
                                  "torch.cuda.synchronize()", "float(conf)",
                                  "int(conf[0])", "bool(flags[0][1])"])
def test_hostsync_fires_in_a_hot_path(call):
    vs = _lint(f"""
        import torch
        def stable_max(conf, flags):
            return {call}
    """)
    assert _rules(vs) == ["ANL-HOSTSYNC"], call


def test_hostsync_quiet_on_clean_twins():
    """Device-side equivalents, numbers annotated as such, a cold module,
    and ``.cpu()`` with arguments (not Tensor.cpu) stay quiet."""
    assert _lint("""
        import torch
        def stable_max(conf, scale: float, k: Optional[int] = None,
                       fmt: str = "none"):
            m = torch.amax(conf, dim=-1)
            return m * float(scale) + int(k) + len(fmt) + float(3)
    """) == []
    assert _lint("""
        import torch
        def tick(conf):
            return conf.item(), float(conf)
    """, relpath=COLD_PATH) == []


def test_time_and_assert_fire_anywhere():
    vs = _lint("""
        import time
        from time import time as now
        def f(x):
            assert x > 0
            return time.time() + now()
    """, relpath=COLD_PATH)
    assert _rules(vs) == ["ANL-ASSERT", "ANL-TIME", "ANL-TIME"]
    assert _lint("""
        import time
        def f(x):
            if x <= 0:
                raise ValueError(x)
            return time.perf_counter()
    """, relpath=COLD_PATH) == []


@pytest.mark.parametrize("draw", [
    "torch.rand(3)", "torch.randn_like(x)", "torch.randint(0, 5, (3,))",
    "torch.multinomial(x, 1)", "torch.bernoulli(x)", "x.uniform_()",
    "x.normal_(0, 1)", "torch.manual_seed(0)", "torch.cuda.manual_seed(1)"])
def test_rng_fires_on_the_global_generator(draw):
    vs = _lint(f"""
        import torch
        def draw(x):
            return {draw}
    """, relpath=COLD_PATH)
    assert _rules(vs) == ["ANL-RNG"], draw


def test_rng_quiet_with_an_explicit_generator():
    assert _lint("""
        import torch
        def draw(x, seed):
            gen = torch.Generator().manual_seed(seed)
            a = torch.rand(3, generator=gen)
            b = torch.randint(0, 5, (3,), generator=gen)
            return a, b, x.uniform_(generator=gen)
    """, relpath=COLD_PATH) == []


def test_rng_fires_at_module_level():
    vs = _lint("""
        import torch
        NOISE = torch.randn(4)
    """, relpath=COLD_PATH)
    assert [v.where for v in vs] == [f"{COLD_PATH}::module"]


def test_emit_io_fires_in_a_registered_emit_path():
    vs = _lint("""
        import json
        class EventLog:
            def emit(self, rec):
                line = json.dumps(rec)
                self._f.write(line)
                self._f.flush()
    """, relpath="repro_torch/obs/events.py")
    assert _rules(vs) == ["ANL-EMITIO"] * 3
    assert _lint("""
        class EventLog:
            def emit(self, rec):
                with self._lock:
                    self._pending.append(dict(rec))
    """, relpath="repro_torch/obs/events.py") == []


def test_port_lint_is_clean_with_its_allowlist():
    allow = Allowlist.load(registry.default_allowlist_path())
    res = hotpath_lint.run(allow)
    assert res.violations == []
    assert res.checked > 500
    assert sorted(v.where for v in res.suppressed) == [
        "repro_torch/core/sampling.py::_seed_bits",
        "repro_torch/core/sampling.py::seed_tensor",
        "repro_torch/core/sampling.py::selection_seed",
        "repro_torch/obs/registry.py::module"]


# ---------------------------------------------------------------------------
# locks
# ---------------------------------------------------------------------------

def _scan(src):
    vs, edges, _, _ = locks.scan_source("repro_torch/serving/fixture.py",
                                        textwrap.dedent(src))
    return vs, edges


def test_lock_mixed_fires_and_its_twin_is_quiet():
    vs, _ = _scan("""
        import threading
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def a(self):
                with self._lock:
                    self.n += 1
            def b(self):
                self.n = 0
    """)
    assert _rules(vs) == ["ANL-LOCK-MIXED"]
    vs, _ = _scan("""
        import threading
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def a(self):
                with self._lock:
                    self.n += 1
            def b(self):
                with self._lock:
                    self.n = 0
    """)
    assert vs == []


def test_lock_order_fires_on_a_cycle_and_a_reacquire():
    vs, edges = _scan("""
        import threading
        class AB:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
            def f(self):
                with self._a:
                    with self._b:
                        pass
            def g(self):
                with self._b:
                    with self._a:
                        pass
            def h(self):
                with self._a:
                    with self._a:
                        pass
    """)
    assert _rules(vs) == ["ANL-LOCK-ORDER"]            # the re-acquire
    assert locks._find_cycles(edges)                   # the AB/BA cycle


def test_port_lock_discipline_is_clean():
    res = locks.run(Allowlist())
    assert res.violations == [] and res.checked > 20
    # the frontend's mesh control channel and followers are scanned
    assert any("router.py" in k for k in res.info["guard_map"])


# ---------------------------------------------------------------------------
# smem_budget: the NPU half against JAX's, the Hopper half
# ---------------------------------------------------------------------------

def test_npu_footprint_table_equals_jax():
    vs, table = smem_budget.check_budgets()
    jvs, jtable = jax_sram.check_budgets()
    assert vs == [] and jvs == []
    assert table == jtable


def test_sram_budget_fires_on_an_overflow():
    huge = registry.KernelSpec(
        "synthetic_overflow", {"d": 8192, "chunk": 8192},
        {"w_slab": 8192 * 8192 * 2, "scratch": 1024}, ("w_slab",))
    vs, table = smem_budget.check_budgets([huge])
    assert [v.rule for v in vs] == ["ANL-SRAM-BUDGET"]
    assert table["synthetic_overflow"]["utilization"] > 1.0


def test_crossval_lies_in_the_band_and_the_band_discriminates():
    vs, info = smem_budget.crossval_allocator()
    jvs, jinfo = jax_sram.crossval_allocator()
    assert vs == [] and info["sram_ok"] is True
    lo, hi = registry.SRAM_CROSSVAL_BAND
    assert lo <= info["ratio"] <= hi
    assert info["static_peak_bytes"] == jinfo["static_peak_bytes"]
    assert info["allocator_peak_bytes"] == jinfo["allocator_peak_bytes"]
    # a mis-modeled vocab chunk falls outside the band
    static = smem_budget.static_stream_peak(8, 32, 126464, 4096,
                                            chunk_v=512)
    assert static < info["allocator_peak_bytes"] * lo


def test_smem_budget_fits_and_fires_on_an_overflow():
    vs, table = smem_budget.check_smem()
    assert vs == []
    assert all(t["total_bytes"] <= registry.SMEM_LIMIT_BYTES
               for t in table.values())
    # every library's instantiations are stated; the largest is the
    # attention's bf16 route at D 256 with BAOS (5 warps: 226 KB)
    libs = {k.split("::")[0] for k in table}
    assert libs == set(("fused_head_sampling", "stablemax_sampling",
                        "topk_mask", "flash_bidir", "flash_bidir_bwd",
                        "baos_mx_quant"))
    tc = table["flash_bidir::flash_bidir_tc_kernel<256, SPLIT>"]
    assert tc["total_bytes"] == (6 * 32 + 5 * 3 * 16) * 264 * 2 + 3 * 256 * 4
    big = registry.SmemSpec("flash_bidir", "synthetic", 1024,
                            registry.SMEM_LIMIT_BYTES)
    vs, _ = smem_budget.check_smem([big])
    assert [v.rule for v in vs] == ["ANL-SMEM-BUDGET"]


# ---------------------------------------------------------------------------
# graph_audit: toy entry points, the registered ones, the capture bound
# ---------------------------------------------------------------------------

def _entry(fn, *args, **kw):
    return registry.EntryPoint("toy", lambda device: (fn, tuple(
        a.to(device) if isinstance(a, torch.Tensor) else a for a in args)),
        **kw)


def _audit_rules(ep):
    vs, _ = graph_audit.audit_entry(ep)
    return _rules(vs)


def test_graph_sync_fires_on_a_host_read():
    x = torch.ones(4)
    assert _audit_rules(_entry(lambda t: t * t.sum().item(), x)) == \
        ["ANL-GRAPH-SYNC"]
    for shaped in (lambda t: t[t > 0], torch.nonzero,
                   lambda t: t.masked_select(t > 0)):
        assert _audit_rules(_entry(shaped, x)) == ["ANL-GRAPH-SYNC"]
    assert _audit_rules(_entry(lambda t: t * t.sum(), x)) == []


def test_graph_transfer_fires_past_its_budget():
    x = torch.ones(4)

    def fetch(t):
        return (t * 2).to("cpu")

    assert _audit_rules(_entry(fetch, x)) == ["ANL-GRAPH-TRANSFER"]
    assert _audit_rules(_entry(fetch, x, max_d2h=1)) == []


def test_graph_inplace_fires_on_a_fresh_allocation():
    x = torch.zeros(4)

    def fresh(t):
        return (t + 1,)

    def inplace(t):
        return (t.add_(1),)

    assert _audit_rules(_entry(fresh, x, inplace=((0, 0),))) == \
        ["ANL-GRAPH-INPLACE"]
    assert _audit_rules(_entry(inplace, x, inplace=((0, 0),))) == []


def test_graph_collective_fires_on_an_undeclared_axis():
    from repro_torch.launch import mesh as mesh_lib
    model = mesh_lib.shape_mesh(1, 2).axis("model")
    x = torch.ones(4)

    def reduce(t):
        return mesh_lib.all_reduce(t, "sum", model)

    assert _audit_rules(_entry(reduce, x)) == ["ANL-GRAPH-COLLECTIVE"]
    assert _audit_rules(_entry(reduce, x, mesh_axes=("model",))) == []


def test_registered_entry_points_are_clean():
    eps = registry.entry_points()
    names = {ep.name for ep in eps}
    assert {"tick_forward", "tick_sample", "batched_tick", "warm_step",
            "refine_step", "megatick", "megatick_mesh", "paged_tick",
            "spmd_tick"} <= names
    assert sum(ep.kernel_only for ep in eps) == 5
    for ep in eps:
        vs, info = graph_audit.audit_entry(ep)
        assert vs == [], (ep.name, vs)
        if ep.inplace:
            assert all(info["inplace"].values()), ep.name
    spmd = next(ep for ep in eps if ep.name == "spmd_tick")
    _, info = graph_audit.audit_entry(spmd)
    assert {c.split("@")[1] for c in info["collectives"]} == {"data",
                                                              "model"}


def test_recapture_bound_fires_and_reports_itself_not_run_on_the_cpu():
    vs = graph_audit.recapture_violations({"megatick": 2, "tick": 2})
    assert [(v.rule, v.where) for v in vs] == [("ANL-RECAPTURE",
                                                "megatick")]
    assert graph_audit.recapture_violations(
        dict(registry.RECAPTURE_BOUNDS)) == []
    vs, info = graph_audit.check_recapture("cpu")
    assert vs == [] and info["run"] is False and "card" in info["reason"]


# ---------------------------------------------------------------------------
# allowlist and report plumbing; the CLI
# ---------------------------------------------------------------------------

def test_stale_and_unjustified_allowlist_entries_are_reported(tmp_path):
    p = tmp_path / "allow.txt"
    p.write_text("# header\n"
                 "ANL-TIME:a.py::module  # reviewed wall-clock use\n"
                 "ANL-RNG:gone.py::fn    # no longer exists\n"
                 "ANL-ASSERT:b.py::module\n")
    allow = Allowlist.load(str(p))
    kept, supp = allow.filter([Violation("ANL-TIME", "a.py::module", "x"),
                               Violation("ANL-HOSTSYNC", "c.py::f", "y")])
    assert [v.rule for v in kept] == ["ANL-HOSTSYNC"]
    assert [v.rule for v in supp] == ["ANL-TIME"]
    details = " | ".join(v.detail for v in allow.meta_violations())
    assert "stale" in details and "no justification" in details
    assert all("stale" not in v.detail
               for v in allow.meta_violations(check_stale=False))
    payload = assemble([], Allowlist({"ANL-X:nowhere": ""}))
    assert payload["violations"] == 2 and "FAIL" in render(payload)


def test_cli_check_exits_zero_over_the_port(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--json",
         str(out)], cwd=ROOT, env={**os.environ,
                                   "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert payload["violations"] == 0
    assert set(payload["passes"]) == {"hotpath_lint", "locks",
                                      "smem_budget", "graph_audit"}
    assert payload["passes"]["graph_audit"]["info"]["recapture"][
        "run"] is False


def test_cli_check_exits_nonzero_on_a_violation(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    bad = tmp_path / "allow.txt"
    bad.write_text("ANL-TIME:nowhere.py::module\n")
    assert main(["--check", "--passes", "locks", "--allowlist",
                 str(bad)]) == 1
    assert "no justification" in capsys.readouterr().out
