"""Pluggable admission + step policies for the serving engine: a copy of
src/repro/serving/scheduler.py (pure Python).

Admission (``select``) picks which queued request takes a freed slot;
the step hook (``step_k``) can override how many tokens a slot commits on
the next tick; the preemption hook (``preempt``) names a slot to spill
when a request's pages do not fit the paged pool;
``expired_requests`` is the frontend's queue-deadline shed rule.  The
SlowFast policy implements the adaptive-step idea of
"SlowFast Sampling" (PAPERS.md): once every token committed in a tick
clears a confidence threshold, the model is in its convergent phase and
the rest of the block is committed in one shot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


class Policy:
    """Base policy: FIFO admission, paper-faithful linear step schedule."""

    name = "base"
    # lifetime count of whole-block early exits taken by step_k
    early_exits = 0

    def select(self, queue: Sequence, now: float) -> int:
        """Index into ``queue`` of the request to admit next."""
        return 0

    def step_k(self, slot, default_k: int) -> int:
        """Tokens slot should commit next tick (default: transfer schedule)."""
        return default_k

    def preempt(self, slots: Sequence, incoming, now: float):
        """Slot index to spill so page-blocked ``incoming`` can admit, or
        None to leave it queued (paged pool only).  The default never
        preempts: admitted work runs to completion."""
        return None


class FIFOPolicy(Policy):
    """Admit strictly in arrival order."""

    name = "fifo"


class ShortestGenFirstPolicy(Policy):
    """Admit the queued request with the fewest generation tokens first
    (SJF: minimizes mean wait when service time ~ gen_length)."""

    name = "sgf"

    def select(self, queue: Sequence, now: float) -> int:
        return min(range(len(queue)), key=lambda i: queue[i].gen_length)


@dataclasses.dataclass
class SlowFastPolicy(Policy):
    """FIFO admission + per-block confidence early exit.

    ``last_conf`` on a slot is the minimum Stable-Max confidence over the
    tokens committed on its previous tick (-inf at block start).  Once it
    clears ``threshold`` the block is finished in one tick by committing
    every still-masked position.
    """

    threshold: float = 0.9
    early_exits: int = 0
    name = "slowfast"

    def step_k(self, slot, default_k: int) -> int:
        if (slot.step_in_block > 0 and slot.block_masks_left > 0
                and slot.last_conf >= self.threshold
                and math.isfinite(slot.last_conf)):
            if slot.block_masks_left > default_k:
                self.early_exits += 1
            return slot.block_masks_left
        return default_k


_POLICIES = {
    "fifo": FIFOPolicy,
    "sgf": ShortestGenFirstPolicy,
    "sjf": ShortestGenFirstPolicy,
    "slowfast": SlowFastPolicy,
}


def get_policy(name: str, **kwargs) -> Policy:
    try:
        return _POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(_POLICIES)}")


def expired_requests(queue: Sequence, now: float,
                     max_queue_wait: float,
                     slo_classes=None) -> list:
    """Still-queued requests whose wait exceeds their deadline: the
    frontend cancels these on the engine and answers 429/overloaded
    instead of letting queue waits grow without bound.

    With ``slo_classes`` (a name -> :class:`repro_torch.obs.slo.SLOClass`
    table) each request's deadline is the tighter of ``max_queue_wait``
    and its class ``queue_deadline_s``; waits are always measured from
    ``arrival_time`` (the first submit, never a restore)."""
    if slo_classes is None:
        if max_queue_wait is None:
            return []
        return [r for r in queue if now - r.arrival_time > max_queue_wait]
    from repro_torch.obs import slo as slo_lib
    out = []
    for r in queue:
        cls = slo_lib.get_class(slo_classes, getattr(r, "slo_class", ""))
        deadline = slo_lib.queue_deadline(cls, max_queue_wait)
        if deadline is not None and now - r.arrival_time > deadline:
            out.append(r)
    return out
