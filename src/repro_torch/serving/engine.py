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
request.  Not ported yet (ROADMAP.md): the mesh, per-stage breakdown
timing and the observability hooks.

``EngineConfig(pool="paged")`` stores the canvas and the warm KV in pages
behind per-slot block tables (serving/cache_pool.PagedCachePool): full
prompt pages are shared through a radix tree, admission counts pages
(``page_size``, ``num_pages``, ``prefix_cache``), and a request can be
preempted to the host (``preempt(uid)``, or a ``Policy.preempt`` hook when
a request's pages do not fit) and restored bit for bit.  Each tick flushes
the pool's staged pages and tables (timed as the ``paged_io`` stage), then
gathers the pages into dense views, runs the unchanged tick and scatters
back (core/diffusion.get_paged_tick_fn, PagedMegatick), so tokens and
CommitEvents equal the slot pool's.

``EngineConfig.fwd_kw`` carries the forward's keyword arguments, as in
JAX: ``{"quant": layers.QuantPolicy(...)}`` runs every tick with the MX
fake-quant at the GEMM boundaries and on the head's operands.

``EngineConfig.jit_steps`` (default True) is the JAX field of the same
name: on the card the tick then replays a captured CUDA graph
(core/graphs.py) against the engine's static device buffers (the canvas
``x``, ``kv_valid``, a staging vector of block starts, k and the tick's
seed, and the warm cache), which the host fills with ``copy_`` from pinned
memory.  ``megatick_k > 1`` runs each ``tick()`` as a *megastep* of up to
K ticks (core/diffusion.get_megatick_fn, the scheduler state on the
device, one host sync per megastep) and replays its drained commit
buffers tick by tick through the same host state machine, so requests,
CommitEvents and tick numbering equal the K=1 engine's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import diffusion, schedule as schedule_lib
from repro_torch.serving.cache_pool import (CachePool, PagedCachePool,
                                            SpilledSlot)
from repro_torch.serving.metrics import MetricsTracker
from repro_torch.serving.scheduler import (FIFOPolicy, Policy,
                                           SlowFastPolicy, get_policy)


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
    stream) stands for its ``rng``, and the device is the model's.
    ``fwd_kw`` takes ``quant`` (a ``models/layers.QuantPolicy``).
    ``pool`` selects the storage: ``"slot"`` (one fixed region per batch
    slot) or ``"paged"`` (block pool + radix prefix cache);
    ``page_size``/``num_pages``/``prefix_cache`` apply to the paged pool
    only.  The mesh and breakdown options are not ported yet and raise
    unless left at their defaults."""
    num_slots: int = 4
    max_seq_len: int = 128
    mode: str = "warm"
    policy: Optional[Policy] = None
    seed: int = 0
    jit_steps: bool = True
    mesh: Any = None
    megatick_k: int = 1
    pool: str = "slot"
    breakdown: bool = False
    fwd_kw: Optional[dict] = None
    page_size: int = 16
    num_pages: Optional[int] = None
    prefix_cache: bool = True


class _HostCanvas:
    """The engine's canvas copied to the host once, at its first use in a
    tick or megastep (one device sync, counted in ``host_waits``)."""

    def __init__(self, engine: "ServingEngine"):
        self.engine = engine
        self.host: Optional[np.ndarray] = None

    def __call__(self) -> np.ndarray:
        if self.host is None:
            self.host = self.engine.x.cpu().numpy()
            self.engine.host_waits += 1
        return self.host


class ServingEngine:
    """Continuous-batching engine: submit() requests, tick() until drained."""

    def __init__(self, model, params, dcfg: diffusion.DiffusionConfig,
                 config: Optional[EngineConfig] = None):
        config = config or EngineConfig()
        if config.mode not in ("warm", "none"):
            raise ValueError(f"unknown engine mode {config.mode!r}")
        if config.pool not in ("slot", "paged"):
            raise ValueError(f"unknown pool backend {config.pool!r}; "
                             "choose 'slot' or 'paged'")
        self.paged = config.pool == "paged"
        if self.paged and config.breakdown:
            raise ValueError(
                "the paged pool is incompatible with breakdown timing (the "
                "paged tick is one gather/tick/scatter step)")
        policy = config.policy or FIFOPolicy()
        self.megatick_k = int(config.megatick_k)
        if self.megatick_k < 1:
            raise ValueError(
                f"megatick_k must be >= 1, got {config.megatick_k}")
        self._sf_threshold: Optional[float] = None
        if self.megatick_k > 1:
            if config.breakdown:
                raise ValueError(
                    "megatick_k > 1 is incompatible with breakdown timing "
                    "(the megastep is one fused loop on the device)")
            if isinstance(policy, SlowFastPolicy):
                # step_k moves on device: the loop applies the confidence
                # early exit per tick without a host round-trip
                self._sf_threshold = float(policy.threshold)
            elif type(policy).step_k is not Policy.step_k:
                raise ValueError(
                    f"policy {policy.name!r} overrides step_k; only the "
                    "default schedule and SlowFastPolicy run on the device "
                    "inside a megatick")
        for name, default in (("mesh", None), ("breakdown", False)):
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(config, name)!r} is not "
                    "ported yet (ROADMAP.md, Queue 1)")
        diffusion.check_supported(dcfg)
        # the policy is bound into the tick fns, as JAX binds it statically
        # into its jitted ones
        self._quant = diffusion._quant_of(config.fwd_kw or {})
        self.config = config
        self.model = model
        self.params = params
        self.dcfg = dcfg
        self.mode = config.mode
        self.num_slots = config.num_slots
        self.max_seq_len = config.max_seq_len
        self.mask_id = int(model.cfg.mask_id)
        self.policy = policy
        self.seed = config.seed
        self.jit_steps = config.jit_steps
        self.device = model.device
        with_cache = self.mode == "warm"
        if self.paged:
            self.pool = PagedCachePool(
                model, self.num_slots, self.max_seq_len,
                page_size=config.page_size, num_pages=config.num_pages,
                with_cache=with_cache, mask_id=self.mask_id,
                prefix_cache=config.prefix_cache, device=self.device)
        else:
            self.pool = CachePool(model, self.num_slots, self.max_seq_len,
                                  with_cache=with_cache)
        self.slots: List[Optional[_Slot]] = [None] * self.num_slots
        self.slot_of_uid: Dict[int, int] = {}
        self.queue: List[Request] = []
        self._preempted: Dict[int, Tuple[_Slot, SpilledSlot]] = {}
        self._req_policy: Dict[int, Policy] = {}
        self._next_uid = 1
        self.completed: List[CompletedRequest] = []
        self.metrics = MetricsTracker(self.num_slots)
        self.now = 0.0                      # engine clock (seconds)
        self.ticks_total = 0
        self._commit_cbs: Dict[int, Callable[[CommitEvent], None]] = {}
        # canvas fetches (and, with megatick, per-tick result syncs)
        # skipped because no streaming sink needed them, counted as JAX
        # counts them; host_waits counts the host's waits that drain the
        # device's queue (result and canvas fetches; a megastep's event
        # waits, which keep a tick in flight, are its megatick fn's
        # event_waits)
        self.host_syncs_elided = 0
        self.host_waits = 0

        B, S = self.num_slots, self.max_seq_len
        L, T = dcfg.block_length, dcfg.steps_per_block
        self._ksched = schedule_lib.linear_unmask_schedule(L, T).numpy()
        # x and kv_valid keep their storage for the engine's life (a
        # graphed tick reads them by address); the host writes kv_valid
        # and the staging vector from pinned memory
        self.x = torch.full((B, S), self.mask_id, dtype=torch.int32,
                            device=self.device)
        pin = self.device.type == "cuda"
        self._valid_host = torch.zeros((B, S), dtype=torch.bool,
                                       pin_memory=pin)
        self._valid_np = self._valid_host.numpy()
        # idle rows keep one valid key so their (discarded) attention rows
        # never see an all-masked softmax
        self._valid_np[:] = np.arange(S) < 1
        self.kv_valid = self._valid_host.to(self.device, copy=True)
        self._kv_dirty = False
        # the graphed K=1 tick's inputs: block starts, k and the seed
        self._stage_host = torch.zeros((2 * B + 1,), dtype=torch.int64,
                                       pin_memory=pin)
        self._stage_np = self._stage_host.numpy()
        self._stage = self._stage_host.to(self.device, copy=True)
        # a megatick engine runs every tick() as a megastep, so it holds
        # the megatick fn and no K=1 tick fn; the paged K=1 tick runs
        # through its tick fn eagerly too (jit_steps=False)
        self._tick_fn = None
        if self.megatick_k == 1 and self.paged:
            self._tick_fn = diffusion.get_paged_tick_fn(
                model, dcfg, self.mask_id, config.page_size,
                self.max_seq_len, with_cache=with_cache,
                jit_steps=self.jit_steps, quant=self._quant)
        elif self.megatick_k == 1 and self.jit_steps:
            self._tick_fn = diffusion.get_tick_fn(model, dcfg, self.mask_id,
                                                  quant=self._quant)
        self._megatick_fn = None
        if self.megatick_k > 1:
            # the engine's own megatick, not get_megatick_fn's shared one:
            # its graphs hold this engine's canvas and cache (the paged
            # one's: its own dense buffers)
            kw = dict(jit_steps=self.jit_steps,
                      slowfast_threshold=self._sf_threshold,
                      quant=self._quant)
            self._megatick_fn = (
                diffusion.PagedMegatick(
                    model, dcfg, self.mask_id, self.megatick_k,
                    config.page_size, self.max_seq_len,
                    with_cache=with_cache, **kw) if self.paged
                else diffusion.Megatick(model, dcfg, self.mask_id,
                                        self.megatick_k, **kw))

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
            if self.megatick_k > 1 and not self._policy_matches(pol):
                raise ValueError(
                    f"per-request policy {request.policy!r} must match the "
                    f"engine policy {self.policy.name!r} under megatick "
                    "(step_k runs on device inside the fused loop)")
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

    def _policy_matches(self, pol: Policy) -> bool:
        """Whether a per-request policy resolves to the same on-device
        step behavior as the engine policy (the megatick constraint)."""
        if type(pol) is not type(self.policy):
            return False
        if isinstance(pol, SlowFastPolicy):
            return pol.threshold == self.policy.threshold
        return True

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
        if self.paged:
            self._restore_preempted()
        while self.pool.free_slots:
            arrived = [r for r in self.queue if r.arrival_time <= self.now]
            if not arrived:
                break
            pick = arrived[self.policy.select(arrived, self.now)]
            if self.paged and not self.pool.can_admit(
                    np.asarray(pick.prompt, np.int32), pick.total_len):
                # footprint-blocked: the slot exists but the projected
                # pages do not fit.  Ask the policy for a victim to spill;
                # with no preemption hook the request waits in the queue
                victim = self.policy.preempt(self.slots, pick, self.now)
                if victim is None or self.slots[victim] is None:
                    break
                self.preempt(self.slots[victim].request.uid)
                if not self.pool.can_admit(
                        np.asarray(pick.prompt, np.int32), pick.total_len):
                    break
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
            if self.paged:
                # prompt pages dedup through the radix cache; uploads are
                # staged and flushed once per tick (PagedCachePool.flush)
                self.pool.bind_row(slot, row, pick.prompt_len,
                                   pick.total_len)
            else:
                self.x[slot] = torch.as_tensor(row, device=self.device)
            self._valid_np[slot] = np.arange(self.max_seq_len) < pick.total_len
            self._kv_dirty = True      # uploaded once per tick, not per admit
            self.metrics.request_admitted(pick.uid, self.now)

    # -- preemption (paged pool only) ---------------------------------------

    def preempt(self, uid: int) -> bool:
        """Spill an admitted request to host memory and free its slot and
        pages; it re-admits with bit-identical state once pages free up,
        ahead of the queue.  Returns False for an unknown or unadmitted
        uid."""
        if not self.paged:
            raise RuntimeError("preempt() requires the paged pool "
                               "(EngineConfig(pool='paged'))")
        slot = self.slot_of_uid.get(uid)
        if slot is None:
            return False
        s = self.slots[slot]
        sp = self.pool.spill(slot)
        sp.prompt_len = s.request.prompt_len
        self._preempted[uid] = (s, sp)
        self.slots[slot] = None
        del self.slot_of_uid[uid]
        self._valid_np[slot] = np.arange(self.max_seq_len) < 1
        self._kv_dirty = True
        return True

    def _restore_preempted(self) -> None:
        """Re-admit spilled requests (oldest first) while slots and pages
        allow: they resume where they left off, so they outrank the
        queue."""
        for uid in list(self._preempted):
            if not self.pool.free_slots:
                break
            s, sp = self._preempted[uid]
            if not self.pool.can_restore(sp):
                break
            slot = self.pool.acquire()
            self.pool.restore(slot, sp)
            self.slots[slot] = s
            self.slot_of_uid[uid] = slot
            self._valid_np[slot] = np.arange(self.max_seq_len) < sp.total_len
            self._kv_dirty = True
            del self._preempted[uid]

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
        return len(self.queue) + self.active_slots + len(self._preempted)

    def _next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.queue), default=None)

    def _flush_kv_valid(self) -> None:
        """One host->device refresh of the validity mask after admission
        and release settle."""
        if self._kv_dirty:
            self.kv_valid.copy_(self._valid_host, non_blocking=True)
            self._kv_dirty = False

    def warmup(self) -> "ServingEngine":
        """Build and load the kernels with a zero-commit tick (outputs
        discarded) and, with ``jit_steps``, capture the graphed tick (or,
        with megatick_k > 1, the megastep's) on the card, so the first
        timed tick pays no build and no capture.  Leaves the clock, metrics
        and canvas untouched; in warm mode it rewrites the pool's K/V,
        which every tick rewrites before reading anyway.  The paged
        megatick warms up on copies of the page stores, as JAX's does (its
        dense buffers, which its graphs read, are the live run's)."""
        self._flush_kv_valid()
        if self.paged:
            self.pool.flush()
        B = self.num_slots
        cache = self.pool.cache if self.mode == "warm" else None
        if self._tick_fn is not None:
            self._stage_np[:] = 0
            for _ in range(2):              # the eager call, then capture
                if self.paged:
                    self._paged_tick()
                else:
                    self._graphed_tick(cache)
        elif self._megatick_fn is None:
            zeros = torch.zeros((B,), dtype=torch.int32, device=self.device)
            diffusion.batched_tick(self.model, self.params, self.x,
                                   self.kv_valid, zeros, zeros, 0, cache,
                                   self.dcfg, self.mask_id, self._quant)
        else:
            zeros = np.zeros((B,), np.int32)
            state = diffusion.megatick_state(
                zeros, zeros, self.dcfg, active=np.zeros((B,), bool))
            fn = self._megatick_fn
            if self.paged:
                pool = self.pool
                store = (None if cache is None else
                         {name: t.clone() for name, t in cache.items()})
                args = (self.params, pool.canvas_pages.clone(), store,
                        pool.canvas_table, pool.kv_table, self.kv_valid,
                        state, 0, 1, False, self.seed)
            else:
                args = (self.params, self.x, self.kv_valid, state, 0, 1,
                        False, cache, self.seed)
            for _ in range(2):              # the eager call, then capture
                fn(*args)
            fn.ticks_run = fn.ticks_wasted = 0
            fn.host_waits = fn.event_waits = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _graphed_tick(self, cache):
        """One tick through the (graphed) tick fn on the static buffers:
        the staging vector goes up, the canvas is updated in place.
        Returns the graph's (conf_min, masks_left)."""
        B = self.num_slots
        self._stage.copy_(self._stage_host, non_blocking=True)
        x_new, _, conf_min, masks_left = self._tick_fn(
            self.params, self.x, self.kv_valid, self._stage[:B],
            self._stage[B:2 * B], self._stage[2 * B:], cache)
        self.x.copy_(x_new)
        return conf_min, masks_left

    def _paged_tick(self):
        """One tick through the paged tick fn on the pool's stores and
        tables and the staging vector; ``x`` becomes the post-tick dense
        canvas (with a graph, its output tensor).  Returns (conf_min,
        masks_left)."""
        B, pool = self.num_slots, self.pool
        self._stage.copy_(self._stage_host, non_blocking=True)
        _, _, self.x, conf_min, masks_left = self._tick_fn(
            self.params, pool.canvas_pages, pool.cache, pool.canvas_table,
            pool.kv_table, self.kv_valid, self._stage[:B],
            self._stage[B:2 * B], self._stage[2 * B:])
        return conf_min, masks_left

    def _flush_pages(self) -> None:
        """The paged pool's staged pages and tables go up before a tick
        (or megastep), timed apart from it as the ``paged_io`` stage."""
        if self.paged:
            t0 = time.perf_counter()
            self.pool.flush()
            self.metrics.record_stage("paged_io", time.perf_counter() - t0)

    def _admit_or_idle(self) -> bool:
        """Admit; when no slot is busy, fast-forward the clock to the next
        arrival and admit again.  False when there is nothing to do."""
        self._admit()
        if self.active_slots == 0:
            nxt = self._next_arrival()
            if nxt is None:
                return False
            self.now = max(self.now, nxt)     # fast-forward through idle gap
            self._admit()
        self._flush_kv_valid()
        return True

    def tick(self, max_ticks: Optional[int] = None) -> bool:
        """Admit, run one batched step, advance slot states.  Returns False
        when there is nothing to do (drained).  With ``megatick_k > 1`` a
        call runs one megastep of up to megatick_k ticks (fewer under
        queue pressure or early release); ``max_ticks`` caps the ticks
        this call may run.  ``ticks_total`` counts denoising ticks either
        way."""
        if self.megatick_k > 1:
            return self._megastep(max_ticks)
        if not self._admit_or_idle():
            return False
        self._flush_pages()

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
        seed = diffusion.tick_seed(self.seed, self.ticks_total)
        if self._tick_fn is None:
            x_new, new_cache, conf_min, masks_left = diffusion.batched_tick(
                self.model, self.params, self.x, self.kv_valid,
                torch.as_tensor(bs_np, device=self.device),
                torch.as_tensor(k_np, device=self.device), seed, cache,
                self.dcfg, self.mask_id, self._quant)
            self.x = x_new
            if self.mode == "warm":
                self.pool.update(new_cache)
        else:
            B = self.num_slots
            self._stage_np[:B] = bs_np
            self._stage_np[B:2 * B] = k_np
            self._stage_np[2 * B] = seed
            conf_min, masks_left = (self._paged_tick() if self.paged
                                    else self._graphed_tick(cache))
        conf_np = conf_min.cpu().numpy()      # device sync point
        masks_np = masks_left.cpu().numpy()
        self.host_waits += 1
        dt = time.perf_counter() - t0

        n_active = self.active_slots
        self.now += dt
        self.ticks_total += 1
        self.metrics.record_tick(dt, n_active)
        canvas = _HostCanvas(self)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            diff = None
            if s.request.uid in self._commit_cbs:
                diff = (0, canvas()[i, :s.request.total_len])
            self._advance_slot(i, s, int(masks_np[i]), float(conf_np[i]),
                               diff, canvas)
        if canvas.host is None and n_active:
            # no streaming sink and no release needed the canvas this tick
            self.host_syncs_elided += 1
        return True

    def _advance_slot(self, i: int, s: _Slot, masks_left: int, conf: float,
                      diff: Optional[tuple], canvas: _HostCanvas) -> None:
        """The host state machine of slot ``i`` after one tick that left
        ``masks_left`` masks in its block with min committed confidence
        ``conf``: tick count, streaming diff, first commit, block advance
        and release, and the CommitEvent.  ``diff`` is ``(offset, row)``, a
        host copy of the canvas row from position ``offset`` that covers
        this tick's commits (given when the request has a commit sink);
        ``canvas()`` gives the host canvas a release reads."""
        L = self.dcfg.block_length
        s.ticks += 1
        uid = s.request.uid
        cb = self._commit_cbs.get(uid)
        positions = tokens = None
        if cb is not None:
            off, row = diff
            span = slice(off, off + len(row))
            newly = s.masked[span] & (row != self.mask_id)
            local = np.nonzero(newly)[0]
            positions = off + local
            tokens = row[local].copy()
            s.masked[span] &= ~newly
        if not s.first_commit and masks_left < L:
            s.first_commit = True
            self.metrics.request_first_commit(uid, self.now)
        block_idx, step_in_block = s.block_idx, s.step_in_block
        done = False
        final: Optional[np.ndarray] = None
        if masks_left == 0:                   # block fully committed
            s.block_idx += 1
            s.step_in_block = 0
            s.last_conf = float("-inf")
            s.block_masks_left = L
            if s.block_idx * L >= s.request.gen_length:
                done = True
                x_host = canvas()
                if cb is not None:
                    final = x_host[i, :s.request.total_len].copy()
                self._release(i, x_host[i])
        else:
            s.step_in_block += 1
            s.last_conf = conf
            s.block_masks_left = masks_left
        if cb is not None:
            cb(CommitEvent(
                uid=uid, tick=self.ticks_total, now=self.now,
                block_idx=block_idx, step_in_block=step_in_block,
                positions=positions, tokens=tokens, masks_left=masks_left,
                done=done, final_tokens=final))
            if done:
                del self._commit_cbs[uid]

    # -- device-resident megatick -------------------------------------------

    def _choose_megatick_k(self, max_ticks: Optional[int]) -> tuple:
        """Megastep depth from queue pressure (the JAX rule): admission
        happens only at megastep boundaries, so with requests queued the
        loop stops at the first release (``stop_on_release``), and if slots
        are already free (the queued work has not arrived on the clock
        yet) the depth drops to 1, the K=1 admission cadence."""
        k = self.megatick_k
        if max_ticks is not None:
            k = max(1, min(k, int(max_ticks)))
        if self.queue:
            if self.pool.free_slots:
                k = 1
            return k, True
        return k, False

    def _megastep(self, max_ticks: Optional[int] = None) -> bool:
        """One megastep: admit at the boundary, run up to K ticks on the
        device with one host sync, then replay the drained commit buffers
        tick by tick through the host state machine: metrics and streaming
        callbacks see the K=1 event sequence, with contiguous tick numbers
        and ``now`` advanced by an equal share of the megastep per tick."""
        if not self._admit_or_idle():
            return False
        self._flush_pages()
        k_req, stop_on_release = self._choose_megatick_k(max_ticks)
        L = self.dcfg.block_length
        B = self.num_slots
        pl = np.zeros((B,), np.int32)
        gb = np.zeros((B,), np.int32)
        bi = np.zeros((B,), np.int32)
        ti = np.zeros((B,), np.int32)
        bml = np.zeros((B,), np.int32)
        lc = np.full((B,), -np.inf, np.float32)
        act = np.zeros((B,), bool)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            pl[i] = s.request.prompt_len
            gb[i] = s.request.gen_length // L
            bi[i] = s.block_idx
            ti[i] = s.step_in_block
            bml[i] = s.block_masks_left
            lc[i] = s.last_conf
            act[i] = True
        cache = self.pool.cache if self.mode == "warm" else None

        t0 = time.perf_counter()
        state = diffusion.megatick_state(
            pl, gb, self.dcfg, block_idx=bi, step_in_block=ti,
            block_masks_left=bml, last_conf=lc, active=act)
        fn = self._megatick_fn
        waits0 = fn.host_waits
        if self.paged:
            pool = self.pool
            _, _, self.x, _, _, bufs, n = fn(
                self.params, pool.canvas_pages, cache, pool.canvas_table,
                pool.kv_table, self.kv_valid, state, self.ticks_total, k_req,
                stop_on_release, self.seed)
        else:
            _, _, _, _, bufs, n = fn(self.params, self.x, self.kv_valid,
                                     state, self.ticks_total, k_req,
                                     stop_on_release, cache, self.seed)
        self.host_waits += fn.host_waits - waits0
        masks_b = bufs["masks_left"][:n].cpu().numpy()
        conf_b = bufs["conf"][:n].cpu().numpy()
        early_b = (bufs["early"][:n].cpu().numpy()
                   if self._sf_threshold is not None else None)
        sinks = any(s is not None and s.request.uid in self._commit_cbs
                    for s in self.slots)
        xa_b = bufs["xa"][:n].cpu().numpy() if sinks else None
        dt = time.perf_counter() - t0
        elided = (n - 1) + (0 if sinks else 1)
        if elided > 0:
            self.host_syncs_elided += elided

        now0 = self.now
        # released rows tick with k = 0 after their release, so the final
        # canvas still holds them
        canvas = _HostCanvas(self)
        for j in range(n):
            self.now = now0 + dt * (j + 1) / n
            self.ticks_total += 1
            self.metrics.record_tick(dt / n, self.active_slots)
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                diff = None
                if s.request.uid in self._commit_cbs:
                    diff = (s.request.prompt_len + s.block_idx * L,
                            xa_b[j, i])
                self._advance_slot(i, s, int(masks_b[j, i]),
                                   float(conf_b[j, i]), diff, canvas)
        if early_b is not None:
            self.policy.early_exits += int(early_b.sum())
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
