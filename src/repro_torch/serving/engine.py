"""Continuous-batching serving engine over the diffusion tick, ported from
src/repro/serving/engine.py (slot pool, one tick per call).

Every engine tick advances *all* active requests by one denoising step with
a single forward + Stable-Max sampling call (core/diffusion
``batched_tick``, on the head path ``dcfg.head_path`` selects), whatever
each request's block index or step within the block.  Requests are
packed into fixed batch slots backed by a slot KV pool; a slot frees (and
a queued request admits) the moment its request's last block unmasks.

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
tokens that committed on that tick, once the tick's obs hooks have run.
``cancel(uid, reason)`` removes a still-queued request.

``EngineConfig(mesh=...)`` (a launch/mesh.Mesh) runs every tick as the SPMD
tick (core/diffusion.get_spmd_tick_fn), as in JAX: the slots shard over
``data`` (this rank's pool holds its slots' cache rows), the LM head's
columns over ``model`` (placed once, at construction).  The port is
multi-controller: every rank runs this engine on the same requests, its
host holds the whole canvas and every tick's gathered results, and the
ranks agree on each tick's seconds (the slowest rank's), so their
schedulers take the same decisions.  Modes none and warm, K = 1 and the
megatick; a graphed tick needs a mesh whose collectives a CUDA graph
captures (NCCL).  Breakdown timing and forward kwargs are refused, as in
JAX.  The paged pool runs under a mesh too: every rank keeps the same
page stores and bookkeeping and gathers, ticks and scatters its ``data``
shard's slots (core/diffusion.get_paged_tick_fn).

``EngineConfig.obs`` takes a ``repro_torch.obs.ServingObs``: the JAX
engine's hooks at the same places (request lifecycle counters and
histograms, per-stage tick histograms, drift, spans, and with an event log
one record per lifecycle edge, the paged pool's page edges included).
Every hook receives data the tick already has, so ``obs`` adds host
bookkeeping only: no device sync (``host_waits`` is the same with and
without it).  Each tick times its stages under JAX's names: ``host_prep``,
``paged_io`` (paged pool), ``dispatch`` (until the tick is enqueued),
``device_sync`` (the wait for its results) and ``commit`` (the host state
machine); ``metrics`` records them whether or not ``obs`` is set.

``EngineConfig(breakdown=True)`` runs each tick as its two halves
(core/diffusion.get_tick_stage_fns, each its own CUDA graph with
``jit_steps``) with a device wait after each, and times them as the
``forward``, ``sampling`` and ``host_sync`` stages: the paper's Fig. 1
split.  Slot pool and K = 1 only, as in JAX.

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
fake-quant at the GEMM boundaries and on the head's operands;
``cross_kv`` (whisper's encoder K/V, batch ``num_slots``) and
``image_embeds`` reach every tick's forward, eager, graphed (read in
place) and with breakdown.  Like JAX, the paged pool and the megatick
refuse any but ``quant``.

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

from repro_torch.core import diffusion, graphs
from repro_torch.core import schedule as schedule_lib
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
    # SLO tier (repro_torch.obs.slo): deadlines are measured from
    # ``arrival_time``, the first submit; preempt/restore never re-stamps it
    slo_class: str = "standard"
    # W3C trace id (32 hex chars) linking this request across the event
    # log, trace spans, SSE stream and /metrics exemplars; "" = none
    trace_id: str = ""

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
    first_commit_t: Optional[float] = None   # engine clock at first commit
    # host mirror of still-masked positions, kept only for requests with a
    # commit callback (the per-tick streaming diff)
    masked: Optional[np.ndarray] = None
    policy: Optional[Policy] = None


@dataclasses.dataclass
class EngineConfig:
    """The JAX EngineConfig's fields; ``seed`` (uint32, the counter-Gumbel
    stream) stands for its ``rng``, and the device is the model's.
    ``fwd_kw`` takes ``quant`` (a ``models/layers.QuantPolicy``) and, on
    the slot pool at K = 1, ``cross_kv`` and ``image_embeds``.
    ``pool`` selects the storage: ``"slot"`` (one fixed region per batch
    slot) or ``"paged"`` (block pool + radix prefix cache);
    ``page_size``/``num_pages``/``prefix_cache`` apply to the paged pool
    only.  ``obs`` takes a ``repro_torch.obs.ServingObs``; ``breakdown``
    splits each tick into timed forward and sampling stages.  ``mesh``
    takes a ``repro_torch.launch.mesh.Mesh`` (modes none and warm on the
    slot pool)."""
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
    obs: Any = None


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
        # the policy is bound into the tick fns, as JAX binds it statically
        # into its jitted ones; the other kwargs are the tick's inputs
        self._quant, self.fwd_kw = diffusion.split_fwd_kw(
            config.fwd_kw or {})
        if self.paged and self.fwd_kw:
            raise ValueError(
                "paged serving does not support extra forward kwargs")
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
            if self.fwd_kw:
                raise ValueError(
                    "megatick serving does not support extra forward "
                    "kwargs")
            if isinstance(policy, SlowFastPolicy):
                # step_k moves on device: the loop applies the confidence
                # early exit per tick without a host round-trip
                self._sf_threshold = float(policy.threshold)
            elif type(policy).step_k is not Policy.step_k:
                raise ValueError(
                    f"policy {policy.name!r} overrides step_k; only the "
                    "default schedule and SlowFastPolicy run on the device "
                    "inside a megatick")
        self.mesh = mesh = config.mesh
        if mesh is not None:
            if config.breakdown:
                raise ValueError(
                    "breakdown timing is not supported under a mesh (the "
                    "SPMD tick is one step)")
            if self.fwd_kw:
                raise ValueError(
                    "mesh serving does not support extra forward kwargs")
            # mesh axes, the fused greedy head, a capturable mesh for graphs
            diffusion.check_spmd(model, dcfg, mesh, config.jit_steps)
            if config.num_slots % mesh.shape["data"]:
                raise ValueError(
                    f"num_slots {config.num_slots} must be divisible by the "
                    f"data axis size {mesh.shape['data']}")
            # once: the LM-head columns over 'model', the rest replicated
            params = diffusion.place_spmd_params(params, mesh)
        diffusion.check_supported(dcfg)
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
        self.breakdown = config.breakdown
        self.device = model.device
        # optional repro_torch.obs.ServingObs; obs=None keeps the tick as
        # it is, obs set adds host bookkeeping only
        self.obs = config.obs
        # the structured event-log hook (a no-op inside ServingObs until an
        # EventLog is attached)
        self._event = (config.obs.event if config.obs is not None
                       and hasattr(config.obs, "event") else None)
        self._early_exits_seen = 0
        self._early_exits_released = 0  # from released per-request policies
        with_cache = self.mode == "warm"
        if self.paged:
            self.pool = PagedCachePool(
                model, self.num_slots, self.max_seq_len,
                page_size=config.page_size, num_pages=config.num_pages,
                with_cache=with_cache, mask_id=self.mask_id,
                prefix_cache=config.prefix_cache, device=self.device)
        else:
            self.pool = CachePool(
                model, self.num_slots, self.max_seq_len,
                with_cache=with_cache,
                rows=None if mesh is None else mesh.rows(self.num_slots))
        if self.paged and self._event is not None:
            # the pool's page edges (spill/restore/prefix_hit/evict) go
            # through the same hook, uid-less
            self.pool.event_cb = self._event
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
        # a tick's CommitEvents, handed to their callbacks once the tick's
        # counters are recorded (``_deliver``)
        self._outbox: List[Tuple[Callable, CommitEvent]] = []
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
        self.kv_valid_uploads = 0           # host->device refreshes
        # the graphed K=1 tick's inputs: block starts, k and the seed
        self._stage_host = torch.zeros((2 * B + 1,), dtype=torch.int64,
                                       pin_memory=pin)
        self._stage_np = self._stage_host.numpy()
        self._stage = self._stage_host.to(self.device, copy=True)
        # a megatick engine runs every tick() as a megastep, so it holds
        # the megatick fn and no K=1 tick fn; the paged K=1 tick runs
        # through its tick fn eagerly too (jit_steps=False)
        self._tick_fn = None
        self._fwd_fn = self._smp_fn = None
        if self.breakdown:
            self._fwd_fn, self._smp_fn = diffusion.get_tick_stage_fns(
                model, dcfg, self.mask_id, jit_steps=self.jit_steps,
                quant=self._quant)
        elif self.megatick_k == 1 and self.paged:
            self._tick_fn = diffusion.get_paged_tick_fn(
                model, dcfg, self.mask_id, config.page_size,
                self.max_seq_len, with_cache=with_cache,
                jit_steps=self.jit_steps, quant=self._quant, mesh=mesh)
        elif self.megatick_k == 1 and mesh is not None:
            self._tick_fn = diffusion.get_spmd_tick_fn(
                model, dcfg, self.mask_id, mesh, jit_steps=self.jit_steps,
                quant=self._quant)
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
                    with_cache=with_cache, mesh=mesh, **kw) if self.paged
                else diffusion.Megatick(model, dcfg, self.mask_id,
                                        self.megatick_k, mesh=mesh, **kw))

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
        if self.obs is not None:
            self.obs.request_queued(uid, trace=request.trace_id,
                                    cls=request.slo_class)
        if self._event is not None:
            self._event("submit", uid=uid, trace=request.trace_id,
                        cls=request.slo_class, t=request.arrival_time,
                        prompt_len=request.prompt_len,
                        gen_length=request.gen_length)
        return uid

    def _policy_matches(self, pol: Policy) -> bool:
        """Whether a per-request policy resolves to the same on-device
        step behavior as the engine policy (the megatick constraint)."""
        if type(pol) is not type(self.policy):
            return False
        if isinstance(pol, SlowFastPolicy):
            return pol.threshold == self.policy.threshold
        return True

    def cancel(self, uid: int, reason: str = "shed") -> bool:
        """Remove a still-*queued* request (the frontend's shed path).
        Returns False when the uid is unknown or already admitted to a
        slot: admitted work is never interrupted.  ``reason="deadline"``
        marks a queue-deadline expiry, which counts as an SLO violation
        for the request's class."""
        for i, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[i]
                self._commit_cbs.pop(uid, None)
                self._req_policy.pop(uid, None)
                self.metrics.request_shed(uid, self.now)
                if self.obs is not None:
                    self.obs.request_shed(uid, cls=r.slo_class,
                                          trace=r.trace_id,
                                          deadline=(reason == "deadline"))
                if self._event is not None:
                    self._event(
                        "shed", uid=uid, trace=r.trace_id,
                        cls=r.slo_class, t=self.now, reason=reason,
                        queue_wait_s=round(
                            max(0.0, self.now - r.arrival_time), 6))
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
                if self._event is not None:
                    self._event("policy_decision", uid=pick.uid,
                                trace=pick.trace_id, cls=pick.slo_class,
                                t=self.now, kind="preempt_victim",
                                victim=int(self.slots[victim].request.uid),
                                policy=self.policy.name)
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
            pol = self.slots[slot].policy or self.policy
            if self.obs is not None:
                self.obs.request_admitted(
                    pick.uid, max(0.0, self.now - pick.arrival_time))
                self.obs.request_policy(pol.name)
            if self._event is not None:
                self._event(
                    "admit", uid=pick.uid, trace=pick.trace_id,
                    cls=pick.slo_class, t=self.now, slot=slot,
                    queue_wait_s=round(
                        max(0.0, self.now - pick.arrival_time), 6))
                self._event("policy_decision", uid=pick.uid,
                            trace=pick.trace_id, cls=pick.slo_class,
                            t=self.now, kind="admit", policy=pol.name)

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
        if self.obs is not None:
            self.obs.request_preempted(uid)
        if self._event is not None:
            self._event("preempt", uid=uid, trace=s.request.trace_id,
                        cls=s.request.slo_class, t=self.now, slot=slot,
                        total_len=sp.total_len)
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
            if self.obs is not None:
                self.obs.request_restored(uid)
            if self._event is not None:
                self._event("restore", uid=uid, trace=s.request.trace_id,
                            cls=s.request.slo_class, t=self.now, slot=slot,
                            total_len=sp.total_len)

    def _release(self, slot: int, x_host: np.ndarray) -> None:
        s = self.slots[slot]
        req = s.request
        self.completed.append(CompletedRequest(
            uid=req.uid, tokens=x_host[:req.total_len].copy(),
            prompt_len=req.prompt_len, gen_length=req.gen_length,
            arrival_time=req.arrival_time, admitted_time=s.admitted_time,
            completed_time=self.now, ticks=s.ticks))
        self.metrics.request_completed(req.uid, self.now, s.ticks)
        if s.policy is not None:
            # fold the released per-request policy's early exits into the
            # accumulator, so the obs total stays monotone
            self._early_exits_released += getattr(s.policy, "early_exits", 0)
        latency_s = max(0.0, self.now - req.arrival_time)
        ttft_s = (None if s.first_commit_t is None
                  else max(0.0, s.first_commit_t - req.arrival_time))
        kinds: Tuple[str, ...] = ()
        if self.obs is not None:
            # obs owns the SLO class table; it returns the deadline kinds
            # this request missed, for the done record
            kinds = self.obs.request_done(
                req.uid, latency_s, s.ticks, ttft_s=ttft_s,
                cls=req.slo_class, trace=req.trace_id,
                tokens=req.gen_length) or ()
        if self._event is not None:
            self._event(
                "done", uid=req.uid, trace=req.trace_id,
                cls=req.slo_class, t=self.now,
                latency_s=round(latency_s, 6),
                ttft_s=None if ttft_s is None else round(ttft_s, 6),
                ticks=s.ticks, tokens=req.gen_length,
                violations=list(kinds))
        self.slots[slot] = None
        del self.slot_of_uid[req.uid]
        self._valid_np[slot] = np.arange(self.max_seq_len) < 1
        self._kv_dirty = True
        self.pool.release(slot)

    def _emit_commit(self, req: Request, cb, tick: int, block_idx: int,
                     step_in_block: int, positions, tokens,
                     masks_left: int, block_masks_before: int) -> None:
        """Event-log record of one tick's commits on a request: streaming
        requests (``cb`` set) get one record per tick with the
        ``block_committed`` SSE payload's fields; the others one summary
        record per completed block (no positions: the canvas diff never
        ran, so the host fetch stays elided)."""
        if self._event is None:
            return
        if cb is not None:
            self._event("block_commit", uid=req.uid, trace=req.trace_id,
                        cls=req.slo_class, t=self.now, tick=tick,
                        block_idx=block_idx, step_in_block=step_in_block,
                        positions=positions, tokens=tokens,
                        masks_left=masks_left)
        elif masks_left == 0:
            self._event("block_commit", uid=req.uid, trace=req.trace_id,
                        cls=req.slo_class, t=self.now, tick=tick,
                        block_idx=block_idx, step_in_block=step_in_block,
                        committed=block_masks_before, masks_left=0)

    # -- stepping -----------------------------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue) + self.active_slots + len(self._preempted)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs the engine's graphed steps have captured (0 while
        its ticks run eagerly).  All capture happens in ``warmup()``; a
        replica's worker thread holds its ticks to capturing none."""
        steps = [self._tick_fn, self._fwd_fn, self._smp_fn]
        if self._megatick_fn is not None:
            steps.append(self._megatick_fn._step)
        return sum(s.captures for s in steps
                   if isinstance(s, graphs.GraphedStep))

    def _early_exits_total(self) -> int:
        """Early exits across the engine policy, live per-request policies
        and released ones."""
        tot = getattr(self.policy, "early_exits", 0)
        tot += self._early_exits_released
        for s in self.slots:
            if s is not None and s.policy is not None:
                tot += getattr(s.policy, "early_exits", 0)
        return tot

    def _next_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.queue), default=None)

    def _flush_kv_valid(self) -> None:
        """One host->device refresh of the validity mask after admission
        and release settle."""
        if self._kv_dirty:
            self.kv_valid.copy_(self._valid_host, non_blocking=True)
            self._kv_dirty = False
            self.kv_valid_uploads += 1
            if self.obs is not None:
                self.obs.kv_valid_upload()

    def warmup(self) -> "ServingEngine":
        """Build and load the kernels with a zero-commit tick (outputs
        discarded) and, with ``jit_steps``, capture the graphed tick (or
        its two breakdown stages, or with megatick_k > 1 the megastep's)
        on the card, so the first timed tick pays no build and no capture.
        Leaves the clock, metrics and canvas untouched; in warm mode it
        rewrites the pool's K/V, which every tick rewrites before reading
        anyway.  The paged megatick warms up on copies of the page stores,
        as JAX's does (its dense buffers, which its graphs read, are the
        live run's)."""
        self._flush_kv_valid()
        if self.paged:
            self.pool.flush()
        B = self.num_slots
        cache = self.pool.cache if self.mode == "warm" else None
        if self._fwd_fn is not None:
            zeros = np.zeros((B,), np.int32)
            for _ in range(2 if self.jit_steps else 1):
                bs, k, seed = self._stage_inputs(zeros, zeros, 0)
                feats = self._forward_stage(bs, cache)
                self._sampling_stage(feats, bs, k, seed)
        elif self._tick_fn is not None:
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
                                   self.dcfg, self.mask_id, self._quant,
                                   **self.fwd_kw)
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
            self._stage[B:2 * B], self._stage[2 * B:], cache, **self.fwd_kw)
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

    # -- breakdown stages ---------------------------------------------------

    def _fill_stage(self, bs_np: np.ndarray, k_np: np.ndarray, seed) -> None:
        """Write a tick's block starts, k and seed into the pinned host
        staging vector."""
        B = self.num_slots
        self._stage_np[:B] = bs_np
        self._stage_np[B:2 * B] = k_np
        self._stage_np[2 * B] = seed

    def _stage_inputs(self, bs_np: np.ndarray, k_np: np.ndarray, seed):
        """A breakdown tick's block starts, k and seed: with ``jit_steps``
        the staging vector's slices (the graphs' static inputs), else new
        tensors and an int seed."""
        if not self.jit_steps:
            return (torch.as_tensor(bs_np, device=self.device),
                    torch.as_tensor(k_np, device=self.device), seed)
        B = self.num_slots
        self._fill_stage(bs_np, k_np, seed)
        self._stage.copy_(self._stage_host, non_blocking=True)
        return self._stage[:B], self._stage[B:2 * B], self._stage[2 * B:]

    def _forward_stage(self, bs, cache):
        """The breakdown's forward stage; returns its feats (with a graph,
        its output tensor, which the sampling graph reads by address)."""
        feats, new_cache = self._fwd_fn(self.params, self.x, self.kv_valid,
                                        bs, cache, **self.fwd_kw)
        if self.mode == "warm":
            self.pool.update(new_cache)
        return feats

    def _sampling_stage(self, feats, bs, k, seed):
        """The breakdown's sampling stage: head path, top-k and commit into
        the canvas (in place on the static canvas with ``jit_steps``).
        Returns (conf_min, masks_left)."""
        x_new, conf_min, masks_left = self._smp_fn(self.params, feats,
                                                   self.x, bs, k, seed)
        if self.jit_steps:
            self.x.copy_(x_new)
        else:
            self.x = x_new
        return conf_min, masks_left

    def _device_wait(self) -> None:
        """The breakdown's wait for a stage's work (JAX's
        ``block_until_ready``), counted in ``host_waits``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host_waits += 1

    # -- one tick -----------------------------------------------------------

    def _flush_pages(self) -> float:
        """The paged pool's staged pages and tables go up before a tick
        (or megastep); returns the seconds it took (the ``paged_io``
        stage; 0 on the slot pool)."""
        if not self.paged:
            return 0.0
        t0 = time.perf_counter()
        self.pool.flush()
        return time.perf_counter() - t0

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
        t_enter = time.perf_counter()
        if not self._admit_or_idle():
            return False
        paged_io = self._flush_pages()

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

        # per-stage timing, at JAX's boundaries: host_prep is the host's
        # admission and k-schedule bookkeeping; dispatch ends when the
        # tick is enqueued, device_sync when its results are on the host
        # (with breakdown: forward and sampling, each ending in a wait,
        # then host_sync)
        stages: Dict[str, float] = {}
        t0 = time.perf_counter()
        stages["host_prep"] = t0 - t_enter - paged_io
        if self.paged:
            stages["paged_io"] = paged_io
        cache = self.pool.cache if self.mode == "warm" else None
        seed = diffusion.tick_seed(self.seed, self.ticks_total)
        if self.breakdown:
            bs, k, seed = self._stage_inputs(bs_np, k_np, seed)
            feats = self._forward_stage(bs, cache)
            self._device_wait()
            t1 = time.perf_counter()
            self.metrics.record_stage("forward", t1 - t0)
            stages["forward"] = t1 - t0
            conf_min, masks_left = self._sampling_stage(feats, bs, k, seed)
            self._device_wait()
            t2 = time.perf_counter()
            self.metrics.record_stage("sampling", t2 - t1)
            stages["sampling"] = t2 - t1
        elif self._tick_fn is None:
            x_new, new_cache, conf_min, masks_left = diffusion.batched_tick(
                self.model, self.params, self.x, self.kv_valid,
                torch.as_tensor(bs_np, device=self.device),
                torch.as_tensor(k_np, device=self.device), seed, cache,
                self.dcfg, self.mask_id, self._quant, **self.fwd_kw)
            self.x = x_new
            if self.mode == "warm":
                self.pool.update(new_cache)
            t2 = time.perf_counter()
            stages["dispatch"] = t2 - t0
        else:
            self._fill_stage(bs_np, k_np, seed)
            conf_min, masks_left = (self._paged_tick() if self.paged
                                    else self._graphed_tick(cache))
            t2 = time.perf_counter()
            stages["dispatch"] = t2 - t0
        conf_np = conf_min.cpu().numpy()      # device sync point
        masks_np = masks_left.cpu().numpy()
        self.host_waits += 1
        t3 = time.perf_counter()
        stages["host_sync" if self.breakdown else "device_sync"] = t3 - t2
        dt = self._agree(t3 - t0)

        n_active = self.active_slots
        self.now += dt
        self.ticks_total += 1
        self.metrics.record_tick(dt, n_active)
        t4 = time.perf_counter()
        committed = 0
        canvas = _HostCanvas(self)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            diff = None
            if s.request.uid in self._commit_cbs:
                diff = (0, canvas()[i, :s.request.total_len])
            committed += self._advance_slot(i, s, int(masks_np[i]),
                                            float(conf_np[i]), diff, canvas)
        if canvas.host is None and n_active:
            # no streaming sink and no release needed the canvas this tick
            self.host_syncs_elided += 1
            if self.obs is not None:
                self.obs.host_syncs_elided(1)
        stages["commit"] = time.perf_counter() - t4
        for name, sec in stages.items():
            if name not in ("forward", "sampling"):   # recorded above
                self.metrics.record_stage(name, sec)
        if self.obs is not None:
            self._obs_committed(committed)
            self.obs.tick(stages, dt, self.active_slots, len(self.queue),
                          t_start_us=t_enter * 1e6)
        self._deliver()
        return True

    def _agree(self, seconds: float) -> float:
        """A tick's (or megastep's) seconds on the engine clock: this
        process's own, or under a mesh the slowest rank's, so every rank's
        clock, and with it every admission, stays the same."""
        if self.mesh is None:
            return seconds
        from repro_torch.launch import mesh as mesh_lib
        return mesh_lib.agree_max(seconds, self.mesh)

    def _obs_committed(self, committed: int) -> None:
        """The obs hooks after a tick's (or megastep's) commits: tokens,
        SlowFast early exits, the paged pool's gauges."""
        obs = self.obs
        obs.tokens_committed(committed)
        ee = self._early_exits_total()
        if ee > self._early_exits_seen:
            obs.policy_early_exit(ee - self._early_exits_seen)
            if self._event is not None:
                self._event("early_exit", t=self.now,
                            n=ee - self._early_exits_seen)
            self._early_exits_seen = ee
        if self.paged:
            obs.pool_pages(self.pool)

    def _advance_slot(self, i: int, s: _Slot, masks_left: int, conf: float,
                      diff: Optional[tuple], canvas: _HostCanvas) -> int:
        """The host state machine of slot ``i`` after one tick that left
        ``masks_left`` masks in its block with min committed confidence
        ``conf``: tick count, streaming diff, first commit, block advance
        and release, the obs hooks and the CommitEvent.  ``diff`` is
        ``(offset, row)``, a host copy of the canvas row from position
        ``offset`` that covers this tick's commits (given when the request
        has a commit sink); ``canvas()`` gives the host canvas a release
        reads.  Returns the tokens committed."""
        L = self.dcfg.block_length
        obs = self.obs
        s.ticks += 1
        uid = s.request.uid
        cb = self._commit_cbs.get(uid)
        committed = max(0, s.block_masks_left - masks_left)
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
            s.first_commit_t = self.now
            self.metrics.request_first_commit(uid, self.now)
            if obs is not None:
                obs.request_first_commit(
                    uid, max(0.0, self.now - s.request.arrival_time))
        block_idx, step_in_block = s.block_idx, s.step_in_block
        # the commit record precedes the done record a release emits
        self._emit_commit(s.request, cb, self.ticks_total, block_idx,
                          step_in_block, positions, tokens, masks_left,
                          s.block_masks_left)
        done = False
        final: Optional[np.ndarray] = None
        if masks_left == 0:                   # block fully committed
            if obs is not None:
                obs.block_committed(
                    uid, block_idx, self.ticks_total,
                    len(positions) if positions is not None
                    else s.block_masks_left, positions, tokens)
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
            self._outbox.append((cb, CommitEvent(
                uid=uid, tick=self.ticks_total, now=self.now,
                block_idx=block_idx, step_in_block=step_in_block,
                positions=positions, tokens=tokens, masks_left=masks_left,
                done=done, final_tokens=final)))
            if done:
                del self._commit_cbs[uid]
        return committed

    def _deliver(self) -> None:
        """Hand the tick's CommitEvents to their callbacks, in order.  It
        runs after the obs hooks, so a client that sees its request's last
        commit and then scrapes ``/metrics`` finds the tick counted."""
        out, self._outbox = self._outbox, []
        for cb, ev in out:
            cb(ev)

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
        tick by tick through the host state machine: metrics, streaming
        callbacks and obs hooks see the K=1 event sequence, with
        contiguous tick numbers and ``now`` advanced by an equal share of
        the megastep per tick."""
        t_enter = time.perf_counter()
        if not self._admit_or_idle():
            return False
        paged_io = self._flush_pages()
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

        # stages as the K=1 tick's: dispatch ends when the megastep's
        # ticks are enqueued and its tick count is read, device_sync when
        # its commit buffers are on the host
        stages: Dict[str, float] = {}
        t0 = time.perf_counter()
        stages["host_prep"] = t0 - t_enter - paged_io
        if self.paged:
            stages["paged_io"] = paged_io
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
        t2 = time.perf_counter()
        stages["dispatch"] = t2 - t0
        masks_b = bufs["masks_left"][:n].cpu().numpy()
        conf_b = bufs["conf"][:n].cpu().numpy()
        early_b = (bufs["early"][:n].cpu().numpy()
                   if self._sf_threshold is not None else None)
        sinks = any(s is not None and s.request.uid in self._commit_cbs
                    for s in self.slots)
        xa_b = bufs["xa"][:n].cpu().numpy() if sinks else None
        t3 = time.perf_counter()
        stages["device_sync"] = t3 - t2
        dt = self._agree(t3 - t0)
        elided = (n - 1) + (0 if sinks else 1)
        if elided > 0:
            self.host_syncs_elided += elided
            if self.obs is not None:
                self.obs.host_syncs_elided(elided)

        t4 = time.perf_counter()
        now0 = self.now
        committed = 0
        active_counts: List[int] = []
        # released rows tick with k = 0 after their release, so the final
        # canvas still holds them
        canvas = _HostCanvas(self)
        for j in range(n):
            self.now = now0 + dt * (j + 1) / n
            self.ticks_total += 1
            active_counts.append(self.active_slots)
            self.metrics.record_tick(dt / n, self.active_slots)
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                diff = None
                if s.request.uid in self._commit_cbs:
                    diff = (s.request.prompt_len + s.block_idx * L,
                            xa_b[j, i])
                committed += self._advance_slot(
                    i, s, int(masks_b[j, i]), float(conf_b[j, i]), diff,
                    canvas)
        if early_b is not None:
            self.policy.early_exits += int(early_b.sum())
        stages["commit"] = time.perf_counter() - t4
        for name, sec in stages.items():
            self.metrics.record_stage(name, sec)
        if self.obs is not None:
            self._obs_committed(committed)
            # each replayed tick carries 1/n of the megastep's stage
            # seconds, so the stage histograms show the amortization
            per_tick = {name: sec / n for name, sec in stages.items()}
            queued = len(self.queue)
            for j in range(n):
                self.obs.tick(per_tick, dt / n, active_counts[j], queued,
                              t_start_us=(t_enter + j * (dt / n)) * 1e6)
            self.obs.megastep(n, k_req, dt, t_start_us=t_enter * 1e6)
        self._deliver()
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
