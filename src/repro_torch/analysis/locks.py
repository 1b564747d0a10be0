"""Lock-discipline check over the threaded serving/obs modules of the
port, a copy of src/repro/analysis/locks.py.

For every class in ``registry.lock_scope_files()`` this pass extracts the
guard map — which ``threading.Lock``/``RLock`` attribute protects which
instance fields — by classifying every ``self.<field>`` mutation (plain
and augmented assigns, and mutating container-method calls) as inside or
outside a ``with self.<lock>:`` block.  ``__init__`` writes are
construction-time and exempt.

Rules:

  * ``ANL-LOCK-MIXED`` — a field written both under a lock and bare: the
    lock either guards the field (the bare write is a race) or it does
    not (the locked write is misleading).  Deliberately single-writer
    fields (written bare everywhere, read via snapshot) are *not*
    flagged — that is the documented MetricsTracker/EngineWorker load
    pattern — only inconsistent fields are.
  * ``ANL-LOCK-ORDER`` — lexically nested lock acquisitions that form a
    cycle across the scanned modules (classic AB/BA deadlock), or a
    re-acquisition of the same non-reentrant lock.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.report import Allowlist, PassResult, Violation

_MUTATORS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "add",
    "setdefault", "sort",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassScan:
    """Per-class guard map: field -> {'locked': {...}, 'bare': {...}}
    (sets of "method:line" write sites)."""

    def __init__(self, relpath: str, cls: ast.ClassDef):
        self.relpath = relpath
        self.cls = cls
        self.lock_attrs: Set[str] = set()
        self.writes: Dict[str, Dict[str, Set[str]]] = {}
        self.edges: List[Tuple[str, str, str]] = []   # (outer, inner, site)
        self._find_locks()
        for m in cls.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_method(m)

    def _find_locks(self) -> None:
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                dotted = None
                f = node.value.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in ("Lock", "RLock"):
                    dotted = f.attr
                elif isinstance(f, ast.Name) and f.id in ("Lock", "RLock"):
                    dotted = f.id
                if dotted is None:
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        self.lock_attrs.add(attr)

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.lock_attrs:
            return f"{self.cls.name}.{attr}"
        # a lock reached through another object: key on the attr name so
        # cross-class nesting still builds an edge
        if isinstance(expr, ast.Attribute) and \
                ("lock" in expr.attr.lower()):
            return f"?.{expr.attr}"
        return None

    def _record(self, field: str, method: str, line: int, locked: bool
                ) -> None:
        slot = self.writes.setdefault(field,
                                      {"locked": set(), "bare": set()})
        slot["locked" if locked else "bare"].add(f"{method}:{line}")

    def _scan_method(self, m: ast.AST) -> None:
        init = m.name == "__init__"
        site = f"{self.relpath}::{self.cls.name}.{m.name}"

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    lock = self._lock_of(item.context_expr)
                    if lock is not None:
                        for h in held + tuple(acquired):
                            self.edges.append((h, lock, site))
                        acquired.append(lock)
                inner = held + tuple(acquired)
                for child in node.body:
                    walk(child, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not m:
                # a closure runs when called, not where defined: its
                # writes are not protected by the enclosing with-block
                for child in ast.iter_child_nodes(node):
                    walk(child, ())
                return
            if not init:
                locked = any(e.startswith(f"{self.cls.name}.")
                             for e in held)
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        field = _self_attr(t)
                        if field is not None and \
                                field not in self.lock_attrs:
                            self._record(field, m.name, node.lineno,
                                         locked)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _MUTATORS:
                    field = _self_attr(node.func.value)
                    if field is not None:
                        self._record(field, m.name, node.lineno, locked)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(m, ())


def _find_cycles(edges: List[Tuple[str, str, str]]
                 ) -> List[Tuple[str, ...]]:
    graph: Dict[str, Set[str]] = {}
    for a, b, _ in edges:
        if a != b:          # self-edges are reported per-class instead
            graph.setdefault(a, set()).add(b)
    cycles: List[Tuple[str, ...]] = []
    seen_cycles: Set[frozenset] = set()

    def dfs(start: str, node: str, path: Tuple[str, ...]) -> None:
        for nxt in graph.get(node, ()):
            if nxt == start:
                key = frozenset(path)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(path + (start,))
            elif nxt not in path:
                dfs(start, nxt, path + (nxt,))

    for n in sorted(graph):
        dfs(n, n, (n,))
    return cycles


def scan_source(relpath: str, source: str
                ) -> Tuple[List[Violation], List[Tuple[str, str, str]],
                           int, Dict[str, Dict[str, List[str]]]]:
    """(violations, lock-order edges, n_classes, guard map) for a module."""
    tree = ast.parse(source, filename=relpath)
    violations: List[Violation] = []
    edges: List[Tuple[str, str, str]] = []
    guard_map: Dict[str, Dict[str, List[str]]] = {}
    n_classes = 0
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        n_classes += 1
        scan = _ClassScan(relpath, node)
        edges.extend(scan.edges)
        cls_map: Dict[str, List[str]] = {}
        for field, sites in sorted(scan.writes.items()):
            locked, bare = sites["locked"], sites["bare"]
            cls_map[field] = (["locked"] if locked else []) + \
                             (["bare"] if bare else [])
            if locked and bare:
                violations.append(Violation(
                    "ANL-LOCK-MIXED",
                    f"{relpath}::{node.name}.{field}",
                    f"written under lock at {sorted(locked)} but bare at "
                    f"{sorted(bare)} — pick one discipline"))
        if scan.lock_attrs or cls_map:
            guard_map[f"{relpath}::{node.name}"] = cls_map
        # same non-reentrant lock acquired while already held
        for a, b, site in scan.edges:
            if a == b and not a.startswith("?."):
                violations.append(Violation(
                    "ANL-LOCK-ORDER", site,
                    f"lock {a} re-acquired while held (threading.Lock "
                    f"is not reentrant)"))
    return violations, edges, n_classes, guard_map


def run(allow: Allowlist, files: Optional[List[str]] = None) -> PassResult:
    files = registry.lock_scope_files() if files is None else files
    violations: List[Violation] = []
    edges: List[Tuple[str, str, str]] = []
    guard_map: Dict[str, Dict[str, List[str]]] = {}
    checked = 0
    for rel in files:
        with open(registry.abspath(rel)) as f:
            src = f.read()
        vs, es, n, gm = scan_source(rel, src)
        violations.extend(vs)
        edges.extend(es)
        guard_map.update(gm)
        checked += n
    for cycle in _find_cycles(edges):
        violations.append(Violation(
            "ANL-LOCK-ORDER", " -> ".join(cycle),
            "inconsistent lock acquisition order (deadlock cycle)"))
    kept, suppressed = allow.filter(violations)
    return PassResult("locks", kept, suppressed,
                      info={"files": len(files),
                            "guard_map": guard_map,
                            "nesting_edges": len(edges)},
                      checked=checked)
