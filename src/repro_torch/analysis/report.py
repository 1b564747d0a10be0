"""Violation records, allowlist filtering, and report assembly shared by
the four analysis passes (see package docstring): a copy of
src/repro/analysis/report.py."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding.  ``where`` is a stable location key
    (``relpath::qualname`` for source rules, an entry-point or kernel name
    for the audit passes); ``detail`` carries line numbers and values and
    is *not* part of the allowlist key, so reformatting a file does not
    invalidate a reviewed exception."""

    rule: str
    where: str
    detail: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.where}"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.detail}"


class Allowlist:
    """Reviewed exceptions, one per line: ``RULE:where  # justification``.

    Blank lines and pure-comment lines are ignored.  Every entry must
    carry a justification comment — an uncommented entry is itself a
    violation (the "reviewed, commented allowlist" contract), as is an
    entry that no longer matches anything (stale exceptions must be
    deleted, not accumulate).
    """

    def __init__(self, entries: Optional[Dict[str, str]] = None,
                 path: Optional[str] = None):
        self.entries = dict(entries or {})
        self.path = path
        self._used: set = set()

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        entries: Dict[str, str] = {}
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, comment = line.partition("#")
                entries[key.strip()] = comment.strip()
        return cls(entries, path=path)

    def filter(self, violations: Iterable[Violation]
               ) -> Tuple[List[Violation], List[Violation]]:
        """Split into (kept, suppressed); remembers which entries matched
        so :meth:`meta_violations` can flag the stale ones."""
        kept, suppressed = [], []
        for v in violations:
            if v.key in self.entries:
                self._used.add(v.key)
                suppressed.append(v)
            else:
                kept.append(v)
        return kept, suppressed

    def meta_violations(self, check_stale: bool = True) -> List[Violation]:
        """``check_stale=False`` on partial-pass runs: an entry owned by a
        pass that did not run is not stale."""
        out = []
        src = self.path or "<allowlist>"
        for key, comment in self.entries.items():
            if not comment:
                out.append(Violation("ANL-ALLOWLIST", src,
                                     f"entry {key!r} has no justification "
                                     f"comment"))
            if check_stale and key not in self._used:
                out.append(Violation("ANL-ALLOWLIST", src,
                                     f"stale entry {key!r} matches no "
                                     f"current finding — delete it"))
        return out


@dataclasses.dataclass
class PassResult:
    """Outcome of one pass after allowlist filtering."""

    name: str
    violations: List[Violation]
    suppressed: List[Violation] = dataclasses.field(default_factory=list)
    info: Dict[str, object] = dataclasses.field(default_factory=dict)
    checked: int = 0    # entities examined (functions/kernels/entry points)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "checked": self.checked,
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "suppressed": [dataclasses.asdict(v) for v in self.suppressed],
            "info": self.info,
        }


def assemble(results: List[PassResult], allow: Allowlist,
             full_run: bool = True) -> dict:
    """Full JSON payload: per-pass results plus allowlist meta-findings."""
    meta = allow.meta_violations(check_stale=full_run)
    total = sum(len(r.violations) for r in results) + len(meta)
    return {
        "benchmark": "analysis",          # the report's kind
        "violations": total,
        "passes": {r.name: r.to_json() for r in results},
        "allowlist": {
            "path": allow.path,
            "entries": len(allow.entries),
            "meta_violations": [dataclasses.asdict(v) for v in meta],
        },
    }


def render(payload: dict) -> str:
    """Human report for the terminal / CI log."""
    lines = []
    for name, r in payload["passes"].items():
        mark = "OK  " if r["ok"] else "FAIL"
        lines.append(f"{mark} {name:14s} checked={r['checked']:<4d} "
                     f"violations={len(r['violations'])} "
                     f"suppressed={len(r['suppressed'])}")
        for v in r["violations"]:
            lines.append(f"     [{v['rule']}] {v['where']}: {v['detail']}")
        for v in r["suppressed"]:
            lines.append(f"     (allowlisted) [{v['rule']}] {v['where']}")
    for v in payload["allowlist"]["meta_violations"]:
        lines.append(f"FAIL [{v['rule']}] {v['where']}: {v['detail']}")
    n = payload["violations"]
    lines.append(f"analysis: {n} violation(s)" if n
                 else "analysis: clean")
    return "\n".join(lines)


def save_json(payload: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path
