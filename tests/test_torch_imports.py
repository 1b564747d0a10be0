"""The PyTorch port stands alone: no module of it, and nothing
chip_smoke.py imports, pulls in JAX or the JAX package; entry points run
on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import transformer
from repro_torch.models.registry import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    """Without device= an entry point asks for CUDA and, on a host without
    a card, raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = base.get_config("llada-8b", smoke=True)
    for call in (lambda: build_model(cfg),
                 lambda: transformer.init_params(cfg),
                 lambda: transformer.init_cache(cfg, 1, 8),
                 lambda: bridge.params_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_slice_modules_are_covered():
    """The step builders' slice (launch/steps.py and what it reads) is
    among the modules the two checks above import and parse."""
    mods = set(_modules())
    for m in ("repro_torch.sharding", "repro_torch.launch.sharding",
              "repro_torch.launch.steps", "repro_torch.optim.compress",
              "repro_torch.checkpoint.checkpointing",
              "repro_torch.launch.mesh"):
        assert m in mods, m


def test_dryrun_is_covered():
    """The dry run (launch/dryrun.py) is one of the modules checked above,
    and its CLI answers without JAX."""
    assert "repro_torch.launch.dryrun" in _modules()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, runpy\n"
            "sys.argv = ['dryrun', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--multi-pod" in out.stdout


def test_analysis_gate_is_covered():
    """The static-analysis gate (repro_torch.analysis) is among the modules
    checked above, and running its passes (the graph audit builds and
    traces the port's entry points) loads no JAX."""
    mods = set(_modules())
    for m in ("repro_torch.analysis", "repro_torch.analysis.__main__",
              "repro_torch.analysis.registry", "repro_torch.analysis.report",
              "repro_torch.analysis.hotpath_lint",
              "repro_torch.analysis.locks",
              "repro_torch.analysis.smem_budget",
              "repro_torch.analysis.graph_audit"):
        assert m in mods, m
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--check', '--passes', "
            "'hotpath_lint,locks,smem_budget,graph_audit', "
            "'--no-crossval'])\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "analysis: clean" in out.stdout
