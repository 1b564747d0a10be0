"""AST hot-path lint over ``src/repro_torch/``, the port's counterpart of
src/repro/analysis/hotpath_lint.py.

Rules (allowlist keys use ``rule:relpath::qualname``):

  * ``ANL-HOSTSYNC`` - host-synchronizing calls inside registered hot
    paths (``registry.HOT_PATHS``: the tick functions and the kernel
    launchers, which run per tick and inside CUDA graph captures):
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``torch.cuda.synchronize()``, and ``float()`` / ``int()`` / ``bool()``
    of a variable or an element (``x``, ``x[0]``) that is not a parameter
    annotated as a Python number.  Each waits for the card per call, and
    inside a graph capture it is an error.
  * ``ANL-TIME`` - ``time.time()`` anywhere in the library: every duration
    is measured, and the wall clock is not monotonic.  Use
    ``time.perf_counter()``.
  * ``ANL-RNG`` - a draw from torch's global generator in library code
    (``torch.rand*`` / ``randint`` / ``randperm`` / ``normal`` /
    ``multinomial`` / ``bernoulli`` / ``poisson`` or ``Tensor.random_`` /
    ``uniform_`` / ``normal_`` ... without ``generator=``), or any
    ``torch.manual_seed``: the port's draws come from explicit generators
    and counter streams, so a run is reproducible whatever else drew.
  * ``ANL-ASSERT`` - bare ``assert`` in library code: stripped under
    ``python -O``, and the wrong exception type for callers.
  * ``ANL-EMITIO`` - serialization or blocking file I/O inside a
    registered event-emit path (``registry.EVENT_EMIT_PATHS``): the emit
    side of the event log stays a dict build + deque append.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.report import Allowlist, PassResult, Violation

# method names whose call forces a device->host copy or wait
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch functions that draw from the global generator
_RNG_FUNCS = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "multinomial",
              "bernoulli", "poisson"}
# Tensor methods that draw from the global generator
_RNG_METHODS = {"random_", "uniform_", "normal_", "exponential_",
                "geometric_", "cauchy_", "log_normal_", "bernoulli_"}
# calls that reseed the global generator
_RNG_SEEDS = {"manual_seed", "seed", "manual_seed_all"}
# serialization / blocking-I/O calls forbidden inside event-emit paths
_EMIT_IO_CALLS = {"json.dumps", "json.dump", "os.fsync", "time.sleep"}
_EMIT_IO_METHODS = {"write", "flush", "fsync"}
# annotations of a parameter that holds a Python number, not a tensor
_NUMBER_TYPES = {"int", "float", "bool", "str"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _ModuleIndex(ast.NodeVisitor):
    """Import aliases for torch / time."""

    def __init__(self):
        self.torch: Set[str] = set()
        self.time_mod: Set[str] = set()
        self.time_func: Set[str] = set()     # from time import time [as t]

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = a.asname or a.name
            if a.name == "torch":
                self.torch.add(name)
            elif a.name == "time":
                self.time_mod.add(name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if node.module == "time" and a.name == "time":
                self.time_func.add(a.asname or a.name)


def _qualname_functions(tree: ast.Module
                        ) -> List[Tuple[str, str, ast.AST]]:
    """(qualname, toplevel_name, node) for every top-level function and
    every method of a top-level class."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node.name, node))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{node.name}.{sub.name}", node.name, sub))
    return out


def _is_hot(relpath: str, toplevel: str) -> bool:
    spec = registry.HOT_PATHS.get(relpath)
    if spec is None:
        return False
    return spec == "*" or toplevel in spec


def _number_params(fn: ast.AST) -> Set[str]:
    """Parameters of ``fn`` and the functions nested in it annotated as a
    Python number (``int``, ``Optional[float]``, ...), with no tensor in
    the annotation."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.annotation is None:
                continue
            names = {n.id if isinstance(n, ast.Name) else n.attr
                     for n in ast.walk(arg.annotation)
                     if isinstance(n, (ast.Name, ast.Attribute))}
            if names & _NUMBER_TYPES and not (
                    names & {"Tensor", "Seed", "Any"}):
                out.add(arg.arg)
    return out


def _base_name(node: ast.AST) -> Optional[str]:
    """The variable under a chain of subscripts (``x`` of ``x[0]``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _check_hostsync(fn: ast.AST, idx: _ModuleIndex, where: str
                    ) -> List[Violation]:
    out = []
    numbers = _number_params(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        line = node.lineno
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not node.args:
                out.append(Violation(
                    "ANL-HOSTSYNC", where,
                    f"line {line}: .{f.attr}() waits for the card inside a "
                    f"hot path"))
                continue
            dotted = _dotted(f)
            if dotted is None:
                continue
            root, _, rest = dotted.partition(".")
            if root in idx.torch and rest == "cuda.synchronize":
                out.append(Violation(
                    "ANL-HOSTSYNC", where,
                    f"line {line}: {dotted}() blocks on device work inside "
                    f"a hot path"))
        elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
              and len(node.args) == 1 and not node.keywords
              and isinstance(node.args[0], (ast.Name, ast.Subscript))):
            base = _base_name(node.args[0])
            if base is None or base in numbers:
                continue
            text = ast.unparse(node.args[0])
            out.append(Violation(
                "ANL-HOSTSYNC", where,
                f"line {line}: {f.id}({text}) in a hot path: on a tensor "
                f"it is a silent device sync"))
    return out


def _check_rng(fn: ast.AST, idx: _ModuleIndex, where: str
               ) -> List[Violation]:
    """Draws from torch's global generator, and reseeding it."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        has_gen = any(k.arg == "generator" for k in node.keywords)
        f = node.func
        dotted = _dotted(f)
        root, _, rest = (dotted or "").partition(".")
        last = rest.split(".")[-1] if rest else ""
        if root in idx.torch and last in _RNG_SEEDS and \
                rest in ("manual_seed", "seed", "random.manual_seed",
                         "random.seed", "cuda.manual_seed",
                         "cuda.manual_seed_all"):
            out.append(Violation(
                "ANL-RNG", where,
                f"line {node.lineno}: {dotted}() reseeds torch's global "
                f"generator: seed an explicit torch.Generator instead"))
        elif root in idx.torch and rest in _RNG_FUNCS and not has_gen:
            out.append(Violation(
                "ANL-RNG", where,
                f"line {node.lineno}: {dotted}() draws from torch's global "
                f"generator: pass generator="))
        elif isinstance(f, ast.Attribute) and f.attr in _RNG_METHODS and \
                not has_gen:
            out.append(Violation(
                "ANL-RNG", where,
                f"line {node.lineno}: .{f.attr}() draws from torch's "
                f"global generator: pass generator="))
    return out


def _check_emit_io(fn: ast.AST, where: str) -> List[Violation]:
    """The emit side of the event log must not serialize or touch the
    file: those run on the tick and request path."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id == "open":
            out.append(Violation(
                "ANL-EMITIO", where,
                f"line {node.lineno}: open() inside an event-emit path: "
                f"file I/O belongs to the flusher thread"))
        elif isinstance(f, ast.Attribute):
            if f.attr in _EMIT_IO_METHODS:
                out.append(Violation(
                    "ANL-EMITIO", where,
                    f"line {node.lineno}: .{f.attr}() inside an event-emit "
                    f"path: defer to the flusher thread"))
                continue
            dotted = _dotted(f)
            if dotted in _EMIT_IO_CALLS:
                out.append(Violation(
                    "ANL-EMITIO", where,
                    f"line {node.lineno}: {dotted}() inside an event-emit "
                    f"path: serialization and blocking I/O belong to the "
                    f"flusher thread"))
    return out


def lint_source(relpath: str, source: str) -> Tuple[List[Violation], int]:
    """All rules over one module; returns (violations, n_functions)."""
    tree = ast.parse(source, filename=relpath)
    idx = _ModuleIndex()
    idx.visit(tree)
    out: List[Violation] = []

    # module-wide rules ---------------------------------------------------
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            out.append(Violation(
                "ANL-ASSERT", f"{relpath}::module",
                f"line {node.lineno}: bare assert in library code: raise "
                f"ValueError instead (stripped under -O)"))
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            root, _, rest = dotted.partition(".")
            if (root in idx.time_mod and rest == "time") \
                    or (not rest and root in idx.time_func):
                out.append(Violation(
                    "ANL-TIME", f"{relpath}::module",
                    f"line {node.lineno}: time.time(): durations must use "
                    f"the monotonic time.perf_counter()"))

    # per-function rules --------------------------------------------------
    fns = _qualname_functions(tree)
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    loose = [n for n in tree.body if not isinstance(n, defs)]
    loose += [s for c in tree.body if isinstance(c, ast.ClassDef)
              for s in c.body if not isinstance(s, defs)]
    out.extend(_check_rng(ast.Module(body=loose, type_ignores=[]), idx,
                          f"{relpath}::module"))
    emit_paths = registry.EVENT_EMIT_PATHS.get(relpath, ())
    for qual, toplevel, fn in fns:
        where = f"{relpath}::{qual}"
        out.extend(_check_rng(fn, idx, where))
        if qual in emit_paths:
            out.extend(_check_emit_io(fn, where))
        if _is_hot(relpath, toplevel):
            out.extend(_check_hostsync(fn, idx, where))
    return out, len(fns)


def run(allow: Allowlist, files: Optional[List[str]] = None) -> PassResult:
    files = registry.src_files() if files is None else files
    violations: List[Violation] = []
    checked = 0
    for rel in files:
        with open(registry.abspath(rel)) as f:
            src = f.read()
        vs, n = lint_source(rel, src)
        violations.extend(vs)
        checked += n
    kept, suppressed = allow.filter(violations)
    return PassResult("hotpath_lint", kept, suppressed,
                      info={"files": len(files),
                            "hot_modules": len(registry.HOT_PATHS),
                            "emit_paths": sum(
                                len(v) for v in
                                registry.EVENT_EMIT_PATHS.values())},
                      checked=checked)
