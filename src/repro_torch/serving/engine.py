"""Continuous-batching serving engine over the diffusion tick, ported from
src/repro/serving/engine.py (slot pool, one tick per call).

Every engine tick advances *all* active requests by one denoising step with
a single forward + Stable-Max sampling call (core/diffusion
``batched_tick``, on the head path ``dcfg.head_path`` selects), whatever
each request's block index or step within the block.  Requests are packed into fixed batch slots backed by a slot KV pool;
a slot frees (and a queued request admits) the moment its request's last
block unmasks.

Tick modes:
  * ``none``: cache-free full recompute per tick (Block Diffusion).  A
    one-slot engine in this mode runs exactly what
    ``generate(cache_mode='none')`` runs.
  * ``warm``: every tick is a warm step through the pooled KV cache: all KV
    recomputed and rewritten (with ``dcfg.baos`` on: recalibrated, smoothed
    and MX-quantized), attention masked by each slot's length.

``submit(request, on_commit=cb)`` registers a per-request commit callback:
every tick the engine diffs the request's row against its host-tracked mask
state and hands the callback a :class:`CommitEvent` with the positions and
tokens that committed on that tick.  ``cancel(uid)`` removes a still-queued
request.  Not ported yet (ROADMAP.md): the paged pool, megatick, the mesh,
per-stage breakdown timing and the observability hooks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import diffusion, schedule as schedule_lib
from repro_torch.serving.cache_pool import CachePool
from repro_torch.serving.metrics import MetricsTracker
from repro_torch.serving.scheduler import FIFOPolicy, Policy, get_policy


@dataclasses.dataclass(eq=False)
class Request:
    """One single-sequence generation request (identity equality: requests
    hold ndarray prompts).  ``uid`` may be left None: ``submit`` assigns the
    next free one.  ``policy`` optionally names a per-request step policy
    (scheduler.get_policy) overriding the engine policy's ``step_k``."""
    prompt: np.ndarray            # (P,) int32
    gen_length: int
    uid: Optional[int] = None
    arrival_time: float = 0.0
    policy: Optional[str] = None
    policy_params: Optional[dict] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.gen_length


@dataclasses.dataclass
class CompletedRequest:
    uid: int
    tokens: np.ndarray            # (P + gen,) int32
    prompt_len: int
    gen_length: int
    arrival_time: float
    admitted_time: float
    completed_time: float
    ticks: int

    @property
    def latency(self) -> float:
        return self.completed_time - self.arrival_time


@dataclasses.dataclass
class CommitEvent:
    """Per-tick commit delta for one request (the streaming unit).
    ``positions`` are absolute indices into the request's row, in
    confidence order's commit set, not left to right; ``done`` events also
    carry the full final row in ``final_tokens``."""
    uid: int
    tick: int                     # engine tick counter (monotone)
    now: float                    # engine clock at commit (wall seconds)
    block_idx: int
    step_in_block: int
    positions: np.ndarray         # (k,) int, committed this tick
    tokens: np.ndarray            # (k,) int32
    masks_left: int               # masks left in the active block after tick
    done: bool = False
    final_tokens: Optional[np.ndarray] = None   # (P + gen,) when done


@dataclasses.dataclass
class _Slot:
    """Host-side per-slot resume state."""
    request: Request
    admitted_time: float
    block_idx: int = 0
    step_in_block: int = 0
    ticks: int = 0
    last_conf: float = float("-inf")
    block_masks_left: int = 0
    first_commit: bool = False
    # host mirror of still-masked positions, kept only for requests with a
    # commit callback (the per-tick streaming diff)
    masked: Optional[np.ndarray] = None
    policy: Optional[Policy] = None


@dataclasses.dataclass
class EngineConfig:
    """The JAX EngineConfig's fields; ``seed`` (uint32, the counter-Gumbel
    stream) stands for its ``rng``, and the device is the model's.  The
    mesh, megatick, paged-pool and breakdown options are not ported yet
    and raise unless left at their defaults."""
    num_slots: int = 4
    max_seq_len: int = 128
    mode: str = "warm"
    policy: Optional[Policy] = None
    seed: int = 0
    mesh: Any = None
    megatick_k: int = 1
    pool: str = "slot"
    breakdown: bool = False


class ServingEngine:
    """Continuous-batching engine: submit() requests, tick() until drained."""

    def __init__(self, model, params, dcfg: diffusion.DiffusionConfig,
                 config: Optional[EngineConfig] = None):
        config = config or EngineConfig()
        if config.mode not in ("warm", "none"):
            raise ValueError(f"unknown engine mode {config.mode!r}")
        for name, default in (("mesh", None), ("megatick_k", 1),
                              ("pool", "slot"), ("breakdown", False)):
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(config, name)!r} is not "
                    "ported yet (ROADMAP.md, Queue 1)")
        diffusion.check_supported(dcfg)
        self.config = config
        self.model = model
        self.params = params
        self.dcfg = dcfg
        self.mode = config.mode
        self.num_slots = config.num_slots
        self.max_seq_len = config.max_seq_len
        self.mask_id = int(model.cfg.mask_id)
        self.policy = config.policy or FIFOPolicy()
        self.seed = config.seed
        self.device = model.device
        self.pool = CachePool(model, self.num_slots, self.max_seq_len,
                              with_cache=(self.mode == "warm"))
        self.slots: List[Optional[_Slot]] = [None] * self.num_slots
        self.slot_of_uid: Dict[int, int] = {}
        self.queue: List[Request] = []
        self._req_policy: Dict[int, Policy] = {}
        self._next_uid = 1
        self.completed: List[CompletedRequest] = []
        self.metrics = MetricsTracker(self.num_slots)
        self.now = 0.0                      # engine clock (seconds)
        self.ticks_total = 0
        self._commit_cbs: Dict[int, Callable[[CommitEvent], None]] = {}

        L, T = dcfg.block_length, dcfg.steps_per_block
        self._ksched = schedule_lib.linear_unmask_schedule(L, T).numpy()
        self.x = torch.full((self.num_slots, self.max_seq_len), self.mask_id,
                            dtype=torch.int32, device=self.device)
        # idle rows keep one valid key so their (discarded) attention rows
        # never see an all-masked softmax
        self._valid_np = np.tile(np.arange(self.max_seq_len) < 1,
                                 (self.num_slots, 1))
        self.kv_valid = torch.as_tensor(self._valid_np, device=self.device)
        self._kv_dirty = False

    # -- request lifecycle --------------------------------------------------

    def submit(self, request: Request,
               on_commit: Optional[Callable[[CommitEvent], None]] = None
               ) -> int:
        """Queue a request and return its uid; ``on_commit`` (if given)
        receives a CommitEvent after every tick that touches it, including
        the final done event."""
        uid = request.uid
        if uid is None:
            uid = self._next_uid
            while uid in self.metrics.seen_uids:
                uid += 1
            request.uid = uid
        elif not isinstance(uid, (int, np.integer)) or uid <= 0:
            raise ValueError(f"request uid must be a positive int, "
                             f"got {uid!r}")
        elif uid in self.metrics.seen_uids:
            raise ValueError(f"duplicate request uid {uid}")
        uid = int(uid)
        self._next_uid = max(self._next_uid, uid + 1)
        pol: Optional[Policy] = None
        if request.policy is not None:
            pol = get_policy(request.policy, **(request.policy_params or {}))
        L = self.dcfg.block_length
        if request.gen_length <= 0 or request.gen_length % L:
            raise ValueError(
                f"gen_length {request.gen_length} must be a positive "
                f"multiple of block_length {L}")
        if request.total_len > self.max_seq_len:
            raise ValueError(
                f"request length {request.total_len} exceeds engine "
                f"max_seq_len {self.max_seq_len}")
        self.queue.append(request)
        if pol is not None:
            self._req_policy[uid] = pol
        if on_commit is not None:
            self._commit_cbs[uid] = on_commit
        self.metrics.request_arrived(request.uid, request.arrival_time,
                                     request.gen_length)
        return uid

    def cancel(self, uid: int) -> bool:
        """Remove a still-*queued* request.  Returns False when the uid is
        unknown or already admitted to a slot."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                self._commit_cbs.pop(uid, None)
                self._req_policy.pop(uid, None)
                self.metrics.request_shed(uid, self.now)
                return True
        return False

    def _admit(self) -> None:
        while self.pool.free_slots:
            arrived = [r for r in self.queue if r.arrival_time <= self.now]
            if not arrived:
                break
            pick = arrived[self.policy.select(arrived, self.now)]
            self.queue.remove(pick)
            slot = self.pool.acquire()
            self.slots[slot] = _Slot(
                request=pick, admitted_time=self.now,
                block_masks_left=self.dcfg.block_length,
                policy=self._req_policy.pop(pick.uid, None))
            if pick.uid in self._commit_cbs:
                m = np.zeros((pick.total_len,), bool)
                m[pick.prompt_len:] = True
                self.slots[slot].masked = m
            self.slot_of_uid[pick.uid] = slot
            row = np.full((self.max_seq_len,), self.mask_id, np.int32)
            row[:pick.prompt_len] = np.asarray(pick.prompt, np.int32)
            self.x[slot] = torch.as_tensor(row, device=self.device)
            self._valid_np[slot] = np.arange(self.max_seq_len) < pick.total_len
            self._kv_dirty = True      # uploaded once per tick, not per admit
            self.metrics.request_admitted(pick.uid, self.now)

    def _release(self, slot: int, x_host: np.ndarray) -> None:
        s = self.slots[slot]
        req = s.request
        self.completed.append(CompletedRequest(
            uid=req.uid, tokens=x_host[:req.total_len].copy(),
            prompt_len=req.prompt_len, gen_length=req.gen_length,
            arrival_time=req.arrival_time, admitted_time=s.admitted_time,
            completed_time=self.now, ticks=s.ticks))
        self.metrics.request_completed(req.uid, self.now, s.ticks)
        self.slots[slot] = None
        del self.slot_of_uid[req.uid]
        self._valid_np[slot] = np.arange(self.max_seq_len) < 1
        self._kv_dirty = True
        self.pool.release(slot)

    # -- stepping -----------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue) + self.active_slots

    def _next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.queue), default=None)

    def _flush_kv_valid(self) -> None:
        """One host->device refresh of the validity mask after admission
        and release settle."""
        if self._kv_dirty:
            self.kv_valid = torch.as_tensor(self._valid_np,
                                            device=self.device)
            self._kv_dirty = False

    def warmup(self) -> "ServingEngine":
        """Build and load the kernels with a zero-commit tick (outputs
        discarded), so the first timed tick pays no build.  Leaves the
        clock, metrics and canvas untouched; in warm mode it rewrites the
        pool's K/V, which every tick rewrites before reading anyway."""
        self._flush_kv_valid()
        zeros = torch.zeros((self.num_slots,), dtype=torch.int32,
                            device=self.device)
        cache = self.pool.cache if self.mode == "warm" else None
        diffusion.batched_tick(self.model, self.params, self.x,
                               self.kv_valid, zeros, zeros, 0, cache,
                               self.dcfg, self.mask_id)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def tick(self) -> bool:
        """Admit, run one batched step, advance slot states.  Returns False
        when there is nothing to do (drained)."""
        self._admit()
        if self.active_slots == 0:
            nxt = self._next_arrival()
            if nxt is None:
                return False
            self.now = max(self.now, nxt)     # fast-forward through idle gap
            self._admit()
        self._flush_kv_valid()

        T = self.dcfg.steps_per_block
        L = self.dcfg.block_length
        bs_np = np.zeros((self.num_slots,), np.int32)
        k_np = np.zeros((self.num_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            bs_np[i] = s.request.prompt_len + s.block_idx * L
            t = s.step_in_block
            default_k = int(self._ksched[t]) if t < T else s.block_masks_left
            pol = s.policy or self.policy
            k_np[i] = min(pol.step_k(s, default_k), L)

        t0 = time.perf_counter()
        cache = self.pool.cache if self.mode == "warm" else None
        x_new, new_cache, conf_min, masks_left = diffusion.batched_tick(
            self.model, self.params, self.x, self.kv_valid,
            torch.as_tensor(bs_np, device=self.device),
            torch.as_tensor(k_np, device=self.device),
            diffusion.tick_seed(self.seed, self.ticks_total), cache,
            self.dcfg, self.mask_id)
        conf_np = conf_min.cpu().numpy()      # device sync point
        masks_np = masks_left.cpu().numpy()
        dt = time.perf_counter() - t0
        self.x = x_new
        if self.mode == "warm":
            self.pool.update(new_cache)

        n_active = self.active_slots
        self.now += dt
        self.ticks_total += 1
        self.metrics.record_tick(dt, n_active)
        x_host: Optional[np.ndarray] = None
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.ticks += 1
            uid = s.request.uid
            cb = self._commit_cbs.get(uid)
            masks_left_i = int(masks_np[i])
            # host copy only when someone reads it: a streaming diff, or a
            # request completing this tick (release needs the row)
            if x_host is None and (cb is not None or (
                    masks_left_i == 0
                    and (s.block_idx + 1) * L >= s.request.gen_length)):
                x_host = self.x.cpu().numpy()  # one copy serves all rows
            positions = tokens = None
            if cb is not None:
                row = x_host[i, :s.request.total_len]
                newly = s.masked & (row != self.mask_id)
                positions = np.nonzero(newly)[0]
                tokens = row[positions].copy()
                s.masked &= ~newly
            if not s.first_commit and masks_left_i < L:
                s.first_commit = True
                self.metrics.request_first_commit(uid, self.now)
            block_idx, step_in_block = s.block_idx, s.step_in_block
            done = False
            final: Optional[np.ndarray] = None
            if masks_left_i == 0:             # block fully committed
                s.block_idx += 1
                s.step_in_block = 0
                s.last_conf = float("-inf")
                s.block_masks_left = L
                if s.block_idx * L >= s.request.gen_length:
                    done = True
                    if cb is not None:
                        final = x_host[i, :s.request.total_len].copy()
                    self._release(i, x_host[i])
            else:
                s.step_in_block += 1
                s.last_conf = float(conf_np[i])
                s.block_masks_left = masks_left_i
            if cb is not None:
                cb(CommitEvent(
                    uid=uid, tick=self.ticks_total, now=self.now,
                    block_idx=block_idx, step_in_block=step_in_block,
                    positions=positions, tokens=tokens,
                    masks_left=masks_left_i, done=done, final_tokens=final))
                if done:
                    del self._commit_cbs[uid]
        return True

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[CompletedRequest]:
        """Submit ``requests`` (if given) and tick until fully drained."""
        for r in requests or ():
            self.submit(r)
        while self.pending:
            if not self.tick():
                break
        self.metrics.elapsed = self.now
        return self.completed
