"""SLO tiers for serving requests (docs/observability.md).

A request carries an ``slo_class`` ("interactive" | "standard" | "batch"
by default); each class maps to a deadline config, and the serving stack
accounts TTFT/latency/goodput/violations/sheds *per class* — the signal
layer the ROADMAP's SLO-tiered shedding and policy-autotuner items need.

Deadlines are measured on the engine's request clock: from first submit
(``Request.arrival_time``), never from a preempt/restore — a restored
request keeps its original arrival, so its deadlines keep ticking while
it is spilled.

``queue_deadline_s`` feeds the scheduler's shed path
(:func:`repro_torch.serving.scheduler.expired_requests`): a queued request
whose wait exceeds its class deadline sheds with the class reported on
the shed event and counted as ``dllm_slo_violations_total{class,
kind="shed"}``.  ``ttft_deadline_s`` / ``latency_deadline_s`` classify
completed requests (``kind="ttft"`` / ``kind="latency"``) — a late
completion still completes; violation counters make the miss visible.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

DEFAULT_CLASS = "standard"

#: violation kinds reported in dllm_slo_violations_total{class,kind}
VIOLATION_KINDS = ("ttft", "latency", "shed")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service tier: deadlines in seconds (``inf`` = unbounded).

    ``queue_deadline_s`` is the max queued wait before the shed path
    drops the request (None = only the worker-level ``max_queue_wait``
    applies, if any).
    """
    name: str
    ttft_deadline_s: float = math.inf
    latency_deadline_s: float = math.inf
    queue_deadline_s: Optional[float] = None

    def violations(self, ttft_s: Optional[float],
                   latency_s: float) -> Tuple[str, ...]:
        """Deadline kinds a completed request missed."""
        out = []
        if ttft_s is not None and ttft_s > self.ttft_deadline_s:
            out.append("ttft")
        if latency_s > self.latency_deadline_s:
            out.append("latency")
        return tuple(out)


def default_classes() -> Dict[str, SLOClass]:
    """The built-in three-tier ladder.  Deadlines are sized for the smoke
    models CI serves (CPU ticks ~ms, loadgen windows ~seconds); real
    deployments override via ``resolve_classes``."""
    return {c.name: c for c in (
        SLOClass("interactive", ttft_deadline_s=2.0,
                 latency_deadline_s=20.0, queue_deadline_s=4.0),
        SLOClass("standard", ttft_deadline_s=10.0,
                 latency_deadline_s=60.0),
        SLOClass("batch"),            # best-effort: no deadlines
    )}


def resolve_classes(spec: Union[None, Mapping, str] = None
                    ) -> Dict[str, SLOClass]:
    """Build the class table: defaults overlaid with ``spec``.

    ``spec`` may be None (defaults), a mapping of name ->
    SLOClass/field-dict, or a JSON object string (the ``--slo-classes``
    CLI form), e.g. ``'{"interactive": {"ttft_deadline_s": 0.5}}'``.
    Overlay entries merge field-wise into the default for that name (or
    define a brand-new class).  The table always contains
    :data:`DEFAULT_CLASS`.
    """
    table = default_classes()
    if spec is None:
        return table
    if isinstance(spec, str):
        import json
        try:
            spec = json.loads(spec)
        except ValueError as e:
            raise ValueError(f"--slo-classes is not valid JSON: {e}")
        if not isinstance(spec, dict):
            raise ValueError("--slo-classes must be a JSON object")
    for name, val in spec.items():
        if isinstance(val, SLOClass):
            table[name] = dataclasses.replace(val, name=name)
            continue
        if not isinstance(val, Mapping):
            raise ValueError(f"SLO class {name!r}: expected an object of "
                             f"deadline fields, got {val!r}")
        base = table.get(name, SLOClass(name))
        fields = {f.name for f in dataclasses.fields(SLOClass)} - {"name"}
        bad = set(val) - fields
        if bad:
            raise ValueError(f"SLO class {name!r}: unknown fields "
                             f"{sorted(bad)} (valid: {sorted(fields)})")
        table[name] = dataclasses.replace(base, **dict(val))
    if DEFAULT_CLASS not in table:
        raise ValueError(f"SLO class table must define {DEFAULT_CLASS!r}")
    return table


def get_class(table: Mapping[str, SLOClass], name: str) -> SLOClass:
    """Look up ``name``, falling back to the default tier for unknown or
    empty names (telemetry must never throw on a label)."""
    return table.get(name) or table[DEFAULT_CLASS]


def queue_deadline(cls: Optional[SLOClass],
                   default_wait: Optional[float]) -> Optional[float]:
    """Effective max queued wait: the tighter of the worker-level bound
    and the class deadline (None = wait forever)."""
    waits = [w for w in (default_wait,
                         cls.queue_deadline_s if cls else None)
             if w is not None]
    return min(waits) if waits else None
