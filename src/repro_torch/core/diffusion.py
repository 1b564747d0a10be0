"""Blocked diffusion inference: the serving tick, ported from
src/repro/core/diffusion.py.

``batched_tick`` is one engine tick: ``tick_forward`` (the dense forward
up to the final norm, with or without the warm KV cache) and
``tick_sample`` (each row's active block sliced at the hidden level, the
fused LM head + Stable-Max, the top-k transfer mask and the commit).
``generate(cache_mode='none')`` is the one-request loop over the same tick.

Randomness is an explicit uint32 seed: tick t of a stream seeded s draws
its counter-Gumbel noise from ``tick_seed(s, t)``, so a saved state
resumes bit for bit.  Greedy decoding (temperature 0, the default) draws
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import sampling as sampling_lib
from repro_torch.core import schedule as schedule_lib

ROADMAP = "ROADMAP.md, Queue 1"


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The JAX DiffusionConfig's fields that the port runs.  ``cache_mode``
    defaults to 'none', the one mode ``generate`` runs here (the JAX default
    'dual' raises); ``baos_enabled`` stands for the JAX ``baos`` field."""
    gen_length: int = 128
    block_length: int = 32
    steps_per_block: int = 8
    cache_mode: str = "none"          # none (dual | prefix: not ported)
    head_path: str = "fused"          # fused (unfused | legacy: not ported)
    sampling: sampling_lib.SamplingConfig = sampling_lib.SamplingConfig()
    baos_enabled: bool = False

    @property
    def num_blocks(self) -> int:
        if self.gen_length % self.block_length:
            raise ValueError(
                f"gen_length {self.gen_length} must be a multiple of "
                f"block_length {self.block_length}")
        return self.gen_length // self.block_length


def check_supported(dcfg: DiffusionConfig) -> None:
    """Raise for the tick options this slice of the port lacks."""
    if dcfg.head_path != "fused":
        raise NotImplementedError(
            f"head_path={dcfg.head_path!r} is not ported yet ({ROADMAP}); "
            "the port runs head_path='fused'")
    if dcfg.baos_enabled:
        raise NotImplementedError(
            f"BAOS KV smoothing is not ported yet ({ROADMAP})")
    sampling_lib.check_supported(dcfg.sampling)


def tick_seed(seed: int, tick: int) -> int:
    """uint32 counter-Gumbel seed of tick ``tick`` of a stream seeded
    ``seed``."""
    x = (int(seed) ^ (int(tick) * 0x9E3779B9)) & sampling_lib.MASK32
    return int(sampling_lib._mix32(torch.tensor(x)))


# ---------------------------------------------------------------------------
# Batched serving tick
# ---------------------------------------------------------------------------

def tick_forward(model, params, x: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], cache,
                 dcfg: DiffusionConfig):
    """Forward half of a tick: full-sequence hidden states (B, S, d).
    Without ``cache`` this is the full recompute (cache_mode 'none'; like
    the JAX forward it attends over all positions and ignores kv_valid);
    with it, a warm step that rewrites every K/V of the cache in place and
    attends through kv_valid."""
    check_supported(dcfg)
    feats, cache = model.forward(params, x, cache=cache, kv_valid=kv_valid,
                                 head_mode="hidden")
    return feats, cache


def tick_sample(params, feats: torch.Tensor, x: torch.Tensor,
                block_start: torch.Tensor, k: torch.Tensor, seed: int,
                dcfg: DiffusionConfig, mask_id: int, model
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling half of a tick: per-row active-block slice (B, L, d), the
    fused head + Stable-Max, top-k and commit of k tokens per row (k = 0
    rows are no-ops), scattered back into the canvas.

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
    xa_new, transfer, conf = sampling_lib.fused_sampling_step_full(
        feats[rows, cols], params["lm_head"], x[rows, cols], mask_id, k,
        dcfg.sampling, seed, logit_scale=float(model.cfg.logit_scale))
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
    feats, cache = tick_forward(model, params, x, kv_valid, cache, dcfg)
    x_new, conf_min, masks_left = tick_sample(
        params, feats, x, block_start, k, seed, dcfg, mask_id, model)
    return x_new, cache, conf_min, masks_left


# ---------------------------------------------------------------------------
# Resumable per-request state machine and generate()
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffusionState:
    """Everything needed to resume blocked-diffusion decoding of a request:
    the canvas ``x`` (prompt + masked generation region), the per-block
    transfer schedule ``ks`` (B, steps_per_block) on the host, the seed and
    the number of ticks taken, and the host-side block/step counters."""
    x: torch.Tensor
    ks: torch.Tensor
    dcfg: DiffusionConfig
    mask_id: int
    prompt_len: int
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


def _check_generate(dcfg: DiffusionConfig) -> None:
    check_supported(dcfg)
    if dcfg.cache_mode != "none":
        raise NotImplementedError(
            f"cache_mode={dcfg.cache_mode!r} is not ported yet ({ROADMAP}); "
            "generate runs cache_mode='none'")


def init_state(model, prompt: torch.Tensor, dcfg: DiffusionConfig,
               seed: int = 0, mask_id: Optional[int] = None
               ) -> DiffusionState:
    """Step-0 state of a (batched) request: masked canvas on the model's
    device, transfer schedule, seed."""
    _check_generate(dcfg)
    mask_id = model.cfg.mask_id if mask_id is None else mask_id
    B, P = prompt.shape
    x = torch.cat([prompt.to(device=model.device, dtype=torch.int32),
                   torch.full((B, dcfg.gen_length), mask_id,
                              dtype=torch.int32, device=model.device)], dim=1)
    ks = schedule_lib.get_num_transfer_tokens(
        torch.full((B,), dcfg.block_length, dtype=torch.int32),
        dcfg.steps_per_block)
    return DiffusionState(x=x, ks=ks, dcfg=dcfg, mask_id=mask_id,
                          prompt_len=P, seed=seed)


def step(model, params, state: DiffusionState) -> DiffusionState:
    """Advance one denoising step: one batched tick committing
    ks[:, t] tokens of the active block."""
    if state.done:
        raise ValueError("step() called on a finished DiffusionState")
    dcfg = state.dcfg
    B = state.x.shape[0]
    dev = state.x.device
    t = state.step_in_block
    x, _, _, _ = batched_tick(
        model, params, state.x, None,
        torch.full((B,), state.block_start, dtype=torch.int32, device=dev),
        state.ks[:, t].to(dev), tick_seed(state.seed, state.ticks), None,
        dcfg, state.mask_id)
    t += 1
    block_idx = state.block_idx
    if t == dcfg.steps_per_block:
        t, block_idx = 0, block_idx + 1
    return dataclasses.replace(state, x=x, ticks=state.ticks + 1,
                               block_idx=block_idx, step_in_block=t)


def generate(model, params, prompt: torch.Tensor, dcfg: DiffusionConfig,
             seed: int = 0, mask_id: Optional[int] = None) -> torch.Tensor:
    """Blocked diffusion generation (paper Alg. 2 outer loops),
    cache_mode='none'.  prompt (B, P) int -> (B, P + gen_length) int32."""
    state = init_state(model, prompt, dcfg, seed=seed, mask_id=mask_id)
    while not state.done:
        state = step(model, params, state)
    return state.x
