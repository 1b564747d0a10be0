"""Pluggable admission + step policies for the serving engine: a copy of
src/repro/serving/scheduler.py (pure Python), without the frontend's
queue-deadline helper.

Admission (``select``) picks which queued request takes a freed slot;
the step hook (``step_k``) can override how many tokens a slot commits on
the next tick; the preemption hook (``preempt``) names a slot to spill
when a request's pages do not fit the paged pool.  The SlowFast policy implements the adaptive-step idea of
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
