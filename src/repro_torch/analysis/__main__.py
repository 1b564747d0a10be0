"""CLI for the port's static-analysis gate.

    PYTHONPATH=src python -m repro_torch.analysis [--check] [--json PATH]
        [--passes hotpath_lint,locks,smem_budget,graph_audit]
        [--allowlist PATH] [--no-recapture-guard] [--no-crossval]

``--check`` exits 1 on any violation; the JSON payload is the report of
``report.assemble``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from repro_torch.analysis import registry
from repro_torch.analysis import report as report_lib

PASS_NAMES = ("hotpath_lint", "locks", "smem_budget", "graph_audit")


def run_passes(names: List[str], allow: report_lib.Allowlist,
               recapture: bool = True, crossval: bool = True
               ) -> List[report_lib.PassResult]:
    results = []
    for name in names:
        if name == "hotpath_lint":
            from repro_torch.analysis import hotpath_lint
            results.append(hotpath_lint.run(allow))
        elif name == "locks":
            from repro_torch.analysis import locks
            results.append(locks.run(allow))
        elif name == "smem_budget":
            from repro_torch.analysis import smem_budget
            results.append(smem_budget.run(allow, crossval=crossval))
        elif name == "graph_audit":
            from repro_torch.analysis import graph_audit
            results.append(graph_audit.run(allow, recapture=recapture))
        else:
            raise SystemExit(f"unknown pass {name!r}; "
                             f"have {', '.join(PASS_NAMES)}")
    return results


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description=__doc__)
    p.add_argument("--check", action="store_true",
                   help="exit 1 on any violation (the gate)")
    p.add_argument("--json", metavar="PATH",
                   help="write the full JSON report")
    p.add_argument("--passes", default=",".join(PASS_NAMES),
                   help="comma-separated subset of passes to run")
    p.add_argument("--allowlist",
                   default=registry.default_allowlist_path(),
                   help="reviewed-exception file (default: the package's "
                        "allowlist.txt)")
    p.add_argument("--no-recapture-guard", action="store_true",
                   help="skip the CUDA-graph capture bound (which runs "
                        "only on a card)")
    p.add_argument("--no-crossval", action="store_true",
                   help="skip the SRAM cross-check against the cycle "
                        "simulator's allocator")
    args = p.parse_args(argv)

    names = [n.strip() for n in args.passes.split(",") if n.strip()]
    allow = (report_lib.Allowlist.load(args.allowlist)
             if os.path.exists(args.allowlist)
             else report_lib.Allowlist(path=args.allowlist))
    results = run_passes(names, allow,
                         recapture=not args.no_recapture_guard,
                         crossval=not args.no_crossval)
    payload = report_lib.assemble(results, allow,
                                  full_run=set(names) >= set(PASS_NAMES))
    print(report_lib.render(payload))
    if args.json:
        report_lib.save_json(payload, args.json)
        print(f"report written to {args.json}")
    if args.check and payload["violations"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
