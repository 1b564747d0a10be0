"""Blocked diffusion inference, ported from src/repro/core/diffusion.py.

Generation proceeds block by block over N_B blocks of length L.  Per
cache mode:

  * "none": every step is one batched tick, a full-sequence recompute;
  * "dual" / "prefix": each block begins with a **warm step** (a
    full-sequence forward that rewrites the whole KV cache and, with BAOS,
    recalibrates it), then T - 1 **refine steps** over the active block
    (dual: the suffix KV stays frozen from the warm step) or over the block
    and its suffix (prefix: the suffix KV is recomputed every step).

``batched_tick`` is one engine tick: ``tick_forward`` (the dense forward,
with or without the warm KV cache) and ``tick_sample`` (each row's active
block sliced, the head path, the top-k transfer mask and the commit).  The
head path (``head_feed_mode``): "fused" streams hidden states through the
fused LM head + Stable-Max kernel; "unfused" applies the head to the
(B, L, d) slice and runs Stable-Max on the stored block logits; "legacy"
takes full-sequence logits out of the forward and slices them.

Randomness is an explicit uint32 seed: step t of a stream seeded s draws
its counter-Gumbel noise from ``tick_seed(s, t)``, so a saved state
resumes bit for bit.  Greedy decoding (temperature 0, the default) draws
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import baos as baos_lib
from repro_torch.core import sampling as sampling_lib
from repro_torch.core import schedule as schedule_lib

CACHE_MODES = ("none", "dual", "prefix")
HEAD_PATHS = ("fused", "unfused", "legacy")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The JAX DiffusionConfig's fields that the port runs.  ``cache_mode``
    defaults to 'none' here (the JAX default is 'dual')."""
    gen_length: int = 128
    block_length: int = 32
    steps_per_block: int = 8
    cache_mode: str = "none"          # none | prefix | dual
    head_path: str = "fused"          # fused | unfused | legacy
    sampling: sampling_lib.SamplingConfig = sampling_lib.SamplingConfig()
    baos: baos_lib.BAOSConfig = baos_lib.BAOSConfig(enabled=False)

    @property
    def num_blocks(self) -> int:
        if self.gen_length % self.block_length:
            raise ValueError(
                f"gen_length {self.gen_length} must be a multiple of "
                f"block_length {self.block_length}")
        return self.gen_length // self.block_length


def check_supported(dcfg: DiffusionConfig) -> None:
    """Raise for options that are unknown (ValueError) or that the port
    lacks (NotImplementedError, pointing at ROADMAP.md)."""
    if dcfg.cache_mode not in CACHE_MODES:
        raise ValueError(f"unknown cache_mode {dcfg.cache_mode!r}")
    if dcfg.head_path not in HEAD_PATHS:
        raise ValueError(f"unknown head_path {dcfg.head_path!r}")
    sampling_lib.check_supported(dcfg.sampling)
    baos_lib.check_supported(dcfg.baos)


def head_feed_mode(model, dcfg: DiffusionConfig) -> str:
    """The sampling stage's feed for ``model``: 'fused'/'unfused' (active
    blocks sliced at the hidden level, the head applied after) or 'logits'
    (the legacy full-logits forward, also for models without head_mode)."""
    if dcfg.head_path not in HEAD_PATHS:
        raise ValueError(f"unknown head_path {dcfg.head_path!r}")
    if dcfg.head_path != "legacy" and getattr(model, "supports_head_mode",
                                              False):
        return dcfg.head_path
    return "logits"


def _forward_head_mode(model, dcfg: DiffusionConfig) -> str:
    return "logits" if head_feed_mode(model, dcfg) == "logits" else "hidden"


def tick_seed(seed: int, tick: int) -> int:
    """uint32 counter-Gumbel seed of tick ``tick`` of a stream seeded
    ``seed``."""
    x = (int(seed) ^ (int(tick) * 0x9E3779B9)) & sampling_lib.MASK32
    return int(sampling_lib._mix32(torch.tensor(x)))


def _active_mask(batch: int, s_tot: int, block_start, block_len: int,
                 device) -> torch.Tensor:
    """(batch, s_tot) bool: positions in [block_start, block_start + L);
    ``block_start`` an int or a (batch,) tensor."""
    pos = torch.arange(s_tot, device=device)[None, :]
    bs = torch.as_tensor(block_start, device=device).reshape(-1, 1)
    return ((pos >= bs) & (pos < bs + block_len)).expand(batch, s_tot)


def _active_sampling_step(feats: torch.Tensor, xa: torch.Tensor,
                          k: torch.Tensor, seed: int, params: Dict,
                          mode: str, dcfg: DiffusionConfig, mask_id: int,
                          model):
    """Route one active block through the head path.  feats is (B, L, V)
    block logits (mode 'logits') or (B, L, d) hidden states (modes 'fused'
    and 'unfused').  Returns (new tokens, transfer, conf), each (B, L)."""
    if mode == "logits":
        return sampling_lib.sampling_step_full(feats, xa, mask_id, k,
                                               dcfg.sampling, seed)
    scale = float(model.cfg.logit_scale)
    if mode == "fused":
        return sampling_lib.fused_sampling_step_full(
            feats, params["lm_head"], xa, mask_id, k, dcfg.sampling, seed,
            logit_scale=scale)
    # unfused: the head after the (B, L, d) slice, so at most (B, L, V)
    # block logits exist; JAX computes this product outside any Pallas
    # kernel, so it stays on torch.matmul
    logits = sampling_lib.head_logits(feats, params["lm_head"],
                                      logit_scale=scale)
    return sampling_lib.sampling_step_full(logits, xa, mask_id, k,
                                           dcfg.sampling, seed)


# ---------------------------------------------------------------------------
# Warm and refine steps (cache modes dual and prefix)
# ---------------------------------------------------------------------------

def warm_step(model, params, x: torch.Tensor, cache: Dict, block_start: int,
              dcfg: DiffusionConfig, head_mode: str = "logits"):
    """Full-sequence forward that rewrites the whole cache (and, with BAOS,
    recalibrates it).  Returns (active-block logits, or with
    ``head_mode='hidden'`` hidden states (B, L, d); the cache)."""
    B, s_tot = x.shape
    L = dcfg.block_length
    calib_mask = (_active_mask(B, s_tot, block_start, L, x.device)
                  if dcfg.baos.calib_scope == "active_block" else None)
    return model.forward(params, x, cache=cache, seg_start=0,
                         baos_cfg=dcfg.baos, calibrate=True,
                         calib_mask=calib_mask,
                         logits_slice=(block_start, L), head_mode=head_mode)


def refine_step(model, params, x: torch.Tensor, cache: Dict,
                block_start: int, dcfg: DiffusionConfig, suffix_len: int = 0,
                head_mode: str = "logits"):
    """One refinement forward over the segment x[block_start:
    block_start + L + suffix_len] (dual: suffix_len 0; prefix: the whole
    suffix), its K/V written into the cache in place, the stored
    calibration read.  Returns (active-block feats, the cache)."""
    L = dcfg.block_length
    seg = x[:, block_start:block_start + L + suffix_len]
    return model.forward(params, seg, cache=cache, seg_start=block_start,
                         baos_cfg=dcfg.baos, calibrate=False,
                         logits_slice=(0, L), head_mode=head_mode)


# ---------------------------------------------------------------------------
# Batched serving tick
# ---------------------------------------------------------------------------

def tick_forward(model, params, x: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], block_start: torch.Tensor,
                 cache, dcfg: DiffusionConfig):
    """Forward half of a tick: full-sequence hidden states (B, S, d), or
    full-sequence logits (B, S, V) on the legacy head path.  Without
    ``cache`` this is the full recompute (cache_mode 'none'; like the JAX
    forward it attends over all positions and ignores kv_valid); with it, a
    warm step per tick that rewrites every K/V of the cache in place
    (calibrated and MX-quantized with ``dcfg.baos`` on, over the rows'
    active blocks with calib_scope 'active_block') and attends through
    kv_valid."""
    check_supported(dcfg)
    head_mode = _forward_head_mode(model, dcfg)
    if cache is None:
        return model.forward(params, x, kv_valid=kv_valid,
                             head_mode=head_mode)
    B, s_tot = x.shape
    calib_mask = None
    if dcfg.baos.calib_scope == "active_block":
        calib_mask = _active_mask(B, s_tot, block_start, dcfg.block_length,
                                  x.device)
    return model.forward(params, x, cache=cache, seg_start=0,
                         kv_valid=kv_valid, baos_cfg=dcfg.baos,
                         calibrate=True, calib_mask=calib_mask,
                         head_mode=head_mode)


def tick_sample(params, feats: torch.Tensor, x: torch.Tensor,
                block_start: torch.Tensor, k: torch.Tensor, seed: int,
                dcfg: DiffusionConfig, mask_id: int, model
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling half of a tick: each row's active block sliced out of the
    full-sequence feats ((B, L, d) hidden states, or (B, L, V) logits on
    the legacy path), the head path, top-k and commit of k tokens per row
    (k = 0 rows are no-ops), scattered back into the canvas.

    Returns (x_new, conf_min, masks_left): conf_min is the minimum
    confidence over the tokens committed this tick (+inf when none, the
    SlowFast signal), masks_left the masked positions left in each row's
    active block."""
    L = dcfg.block_length
    B, S = x.shape
    # the JAX dynamic_slice clamps a start so the block fits; so does this
    start = torch.clamp(block_start.to(torch.int64), 0, S - L)
    cols = start[:, None] + torch.arange(L, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None]
    xa_new, transfer, conf = _active_sampling_step(
        feats[rows, cols], x[rows, cols], k, seed, params,
        head_feed_mode(model, dcfg), dcfg, mask_id, model)
    x_new = x.clone()
    x_new[rows, cols] = xa_new
    conf_min = torch.amin(torch.where(transfer, conf, float("inf")), dim=-1)
    masks_left = torch.sum(xa_new == mask_id, dim=-1).to(torch.int32)
    return x_new, conf_min, masks_left


def batched_tick(model, params, x: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], block_start: torch.Tensor,
                 k: torch.Tensor, seed: int, cache, dcfg: DiffusionConfig,
                 mask_id: int):
    """One engine tick over all serving slots: one forward, one sampling
    call.  Also the cache_mode='none' step of ``generate`` (block_start
    broadcast), so a one-slot engine runs exactly what generate runs.
    Returns (x_new, cache, conf_min, masks_left)."""
    feats, cache = tick_forward(model, params, x, kv_valid, block_start,
                                cache, dcfg)
    x_new, conf_min, masks_left = tick_sample(
        params, feats, x, block_start, k, seed, dcfg, mask_id, model)
    return x_new, cache, conf_min, masks_left


# ---------------------------------------------------------------------------
# Resumable per-request state machine and generate()
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffusionState:
    """Everything needed to resume blocked-diffusion decoding of a request:
    the canvas ``x`` (prompt + masked generation region), the KV ``cache``
    (None for cache_mode 'none'; updated in place by each step), the
    per-block transfer schedule ``ks`` (B, steps_per_block) on the host,
    the seed and the number of ticks taken, and the host-side block/step
    counters."""
    x: torch.Tensor
    ks: torch.Tensor
    dcfg: DiffusionConfig
    mask_id: int
    prompt_len: int
    cache: Optional[Dict] = None
    seed: int = 0
    ticks: int = 0
    block_idx: int = 0
    step_in_block: int = 0

    @property
    def done(self) -> bool:
        return self.block_idx >= self.dcfg.num_blocks

    @property
    def block_start(self) -> int:
        return self.prompt_len + self.block_idx * self.dcfg.block_length


def init_state(model, prompt: torch.Tensor, dcfg: DiffusionConfig,
               seed: int = 0, mask_id: Optional[int] = None
               ) -> DiffusionState:
    """Step-0 state of a (batched) request: masked canvas on the model's
    device, a fresh KV cache for the cached modes, transfer schedule,
    seed."""
    check_supported(dcfg)
    mask_id = model.cfg.mask_id if mask_id is None else mask_id
    B, P = prompt.shape
    x = torch.cat([prompt.to(device=model.device, dtype=torch.int32),
                   torch.full((B, dcfg.gen_length), mask_id,
                              dtype=torch.int32, device=model.device)], dim=1)
    cache = (model.init_cache(B, P + dcfg.gen_length)
             if dcfg.cache_mode != "none" else None)
    ks = schedule_lib.get_num_transfer_tokens(
        torch.full((B,), dcfg.block_length, dtype=torch.int32),
        dcfg.steps_per_block)
    return DiffusionState(x=x, ks=ks, dcfg=dcfg, mask_id=mask_id,
                          prompt_len=P, cache=cache, seed=seed)


def step_forward(model, params, state: DiffusionState) -> torch.Tensor:
    """The forward of the next step of a cached mode: the warm step at
    step_in_block 0, a refine step after it.  Updates ``state.cache`` in
    place and returns the active block's feats ((B, L, d) hidden states,
    or (B, L, V) logits on the legacy path)."""
    dcfg = state.dcfg
    head_mode = _forward_head_mode(model, dcfg)
    bs = state.block_start
    if state.step_in_block == 0:
        feats, _ = warm_step(model, params, state.x, state.cache, bs, dcfg,
                             head_mode)
    else:
        suffix = (state.x.shape[1] - (bs + dcfg.block_length)
                  if dcfg.cache_mode == "prefix" else 0)
        feats, _ = refine_step(model, params, state.x, state.cache, bs,
                               dcfg, suffix, head_mode)
    return feats


def commit_block(model, params, state: DiffusionState, feats: torch.Tensor
                 ) -> torch.Tensor:
    """The sampling half of a cached-mode step: the head path on the
    active block's feats, top-k and commit of ks[:, t] tokens.  Returns the
    new canvas."""
    dcfg = state.dcfg
    L, bs = dcfg.block_length, state.block_start
    xa_new, _, _ = _active_sampling_step(
        feats, state.x[:, bs:bs + L],
        state.ks[:, state.step_in_block].to(state.x.device),
        tick_seed(state.seed, state.ticks), params,
        head_feed_mode(model, dcfg), dcfg, state.mask_id, model)
    x = state.x.clone()
    x[:, bs:bs + L] = xa_new
    return x


def advance(state: DiffusionState, x: torch.Tensor) -> DiffusionState:
    """The state after a step that produced canvas ``x``: one more tick,
    the next step, or the next block after the last step."""
    t = state.step_in_block + 1
    block_idx = state.block_idx
    if t == state.dcfg.steps_per_block:
        t, block_idx = 0, block_idx + 1
    return dataclasses.replace(state, x=x, ticks=state.ticks + 1,
                               block_idx=block_idx, step_in_block=t)


def step(model, params, state: DiffusionState) -> DiffusionState:
    """Advance one denoising step: the forward for the cache mode (a
    batched tick for 'none'; warm at step_in_block 0, else refine), then
    the commit of ks[:, t] tokens of the active block."""
    if state.done:
        raise ValueError("step() called on a finished DiffusionState")
    dcfg = state.dcfg
    if dcfg.cache_mode == "none":
        B = state.x.shape[0]
        dev = state.x.device
        x, _, _, _ = batched_tick(
            model, params, state.x, None,
            torch.full((B,), state.block_start, dtype=torch.int32,
                       device=dev),
            state.ks[:, state.step_in_block].to(dev),
            tick_seed(state.seed, state.ticks), None, dcfg, state.mask_id)
    else:
        feats = step_forward(model, params, state)
        x = commit_block(model, params, state, feats)
    return advance(state, x)


def generate(model, params, prompt: torch.Tensor, dcfg: DiffusionConfig,
             seed: int = 0, mask_id: Optional[int] = None) -> torch.Tensor:
    """Blocked diffusion generation (paper Alg. 2 outer loops) in
    ``dcfg.cache_mode``.  prompt (B, P) int -> (B, P + gen_length)
    int32."""
    state = init_state(model, prompt, dcfg, seed=seed, mask_id=mask_id)
    while not state.done:
        state = step(model, params, state)
    return state.x
