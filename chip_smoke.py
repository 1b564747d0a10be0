#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  -- nvcc builds every kernel of src/repro_torch/kernels/csrc
               into build/repro_torch/ (one process per source, in
               parallel);
  2. kernels -- each kernel against its plain PyTorch version on the card
               at the main path's shapes, with its time, the plain
               version's, a one-call PyTorch yardstick's and its bound
               (baos_mx_quant bit for bit in every KV format of core/mx,
               mxfp6_e3m2 and mxfp4_e2m1 included, each timed, also on
               the f32 route, on zero
               and extreme-exponent blocks, at D 32, into an odd-offset
               cache slice and at unaligned addresses, after torch.exp2
               is checked at every integer in [-127, 127];
               stablemax_sampling and the fused head within the near-tie
               rule on every fmt and T, the head at R in {16, 64, 200},
               Stable-Max on bf16 and f32 logits and a (3, 1003) case with
               a tie across a vocab-range boundary; flash_bidir within one
               bf16 ulp + 1e-6; topk_mask with 0 differences on bool masks,
               k int32 and int64, L 1/16/33/64, R not a multiple of 4,
               ties, and one launch per top-k; the sampling kernels with
               the seed from device memory; the empty kernel's device
               time, the floor of a launch); the f32 routes of the fused
               head and flash_bidir at a small shape; the profiler's
               device time of each kernel and of its library yardstick;
               the limits lifted in this slice: topk_mask at L 65, 128,
               256 and 1000 (the CTA route), the fused head's bf16 route
               on padded heads at V 122753 (minicpm-2b, R 64) and 1003
               (R 3) against plain and the f32 route, flash_bidir at
               D 256 (10 q heads on 1 KV head, window 2048, kv_valid,
               BAOS), D 16 and D 96, each with its time and bound;
               the shapes phase 9 first gives: flash_bidir's whisper
               cross-attention (4, 96, 16, 64) on (4, 1500, 16, 64) and
               encoder self-attention (4, 1500, 16, 64), no mask, against
               SDPA; stablemax_sampling at (64, 51865) and (64, 92553)
               bf16 (rows not 16-byte aligned) against softmax + max;
               phase 10's kernel cases: the fused head at (64, 4096,
               126464) bf16 and stablemax_sampling at (64, 126464) bf16 in
               mxint8, mxint4, mxfp6_e3m2 and mxfp4_e2m1 (NEW_FMTS), T 0
               and 0.8, against plain, each timed with its bound and its
               library call (torch.matmul; softmax + max); every format of
               core/mx on the f32 routes, the padded heads, Stable-Max's
               (64, 126464) f32 and (3, 1003) cases and the device seed;
               phase 11's kernel: flash_bidir_bwd against its plain
               version at llada-8b's (8, 128, 32 on 32, 128) and
               qwen2-0.5b's (8, 128, 14 on 2, 64) training attention, D 256
               with window 2048 and kv_valid (4, 256, 10 on 1), all bf16
               (error against an f32 recomputation at most 2x the plain
               bf16 version's plus one bf16 ulp), and the f32 route with a
               row that has no valid key (1e-4 of max|grad|; its dq and
               dk 0), two launches bit for bit, each timed beside its
               bound and SDPA's backward; the four kernels without a
               backward refuse inputs that require grad;
  3. e2e    -- llada-8b at full width (32 layers, d 4096, bf16, seeded
               random weights): one-slot generate in cache mode none,
               stepped through tick_forward and tick_sample, and in modes
               dual and prefix with BAOS (minmax, mxint4 KV, mxfp8
               sampling), through generate() and stepped, and mode none
               through generate(megatick_k=4) (graphed); each step's
               sampling held against the plain functions on the same
               hidden states, and the first warm step's layer-0 cache
               against the plain smooth_quantize of the same K/V;
  4. engine -- ServingEngine paths warm, none, warm with BAOS and warm on
               the unfused head (4 slots, 8 requests, prompts 16-32,
               generations 32-64, block 16, 8 steps); every request must
               finish with no mask id left, and each path must launch the
               kernels it runs and no other (launch counts zeroed just
               before a path runs, read just after).  Then the sampling
               stage's device time on the fused, unfused and legacy head
               paths at the engine's shape.  Each path runs three ways:
               eager K=1 (jit_steps=False), graphed K=1 (the tick a CUDA
               graph) and graphed K=8 (the megatick); the graphed runs
               must give the eager run's tokens, per-request ticks,
               CommitEvents and ticks_total, and its launch counts plus
               those of any tick run after a megastep's stop.  Per run:
               tick wall median/p84, tokens/s, latency, peak memory, host
               syncs per tick; per graphed run a profile: device busy and
               idle share, the gap before each topk_mask launch, and each
               port kernel's launches per tick as the profiler sees them
               inside the graphs, which must equal the eager run's per
               tick and the counts the graph replays added; on path warm
               a SlowFast(0) trace, whose megasteps stop mid-way, eager
               K=1 against graphed K=1 and K=8;
  4b. paged -- the engine trace of phase 4 through the paged pool (page
               16) on paths warm, none and warm with BAOS, each eager K=1,
               graphed K=1 and graphed K=8: tokens, per-request ticks,
               CommitEvents, ticks_total and launch counts equal to the
               slot pool's run at the same settings, and no graph captured
               after warmup(); a profile of the paged warm graphed K=1
               tick beside the slot tick's, and the gather and scatter's
               device time beside their byte bound; a warm + BAOS graphed
               run with a request preempted mid-block (spilled to the host
               and restored), equal to the uninterrupted run, with the
               spill bytes and the spill and restore times; the
               prefix-heavy goodput case at an equal page budget (48
               requests in two groups sharing a 64-token prompt, 20 pages
               of 16: the slot pool's 4 slots against the paged pool's
               12), tokens/s, latency, tick wall, peak pages, prefix hit
               rate and peak memory for each;
  3b. table6 -- llada-8b at the paper's Table 6 shape (B 16, prompt 128,
               gen 256, block 64, 16 steps) in cache modes none, prefix +
               BAOS and dual + BAOS (mxint4 KV), and dual + BAOS under
               QuantPolicy (MXINT4 weights, MXINT8 activations, bf16
               sampling; the first 8 of 32 layers, a depth cut for the
               script's time limit): step() eager against
               graphed (equal tokens), step wall, tokens/s, peak memory,
               graphs captured, then a second graphed generate() that
               must capture nothing; the QuantPolicy run's sampling held
               against plain;
  5. configs -- llama3.2-3b (generate, block 128: topk_mask's CTA route),
               minicpm-2b (engine warm: the padded fused head; each
               tick's sampling held against plain) and codeqwen1.5-7b
               (engine warm) at full width, one model at a time, eager
               against graphed K=1.
  6. serve -- the port's serving stack on llada-8b at full width.  6a:
               the engine trace with EngineConfig(breakdown=True) on paths
               warm, warm + BAOS and warm on the legacy head at fmt none
               (the Fig. 1 pair with warm's fused mxfp8 head), eager and
               graphed: tokens, per-request ticks, CommitEvents and
               ticks_total equal the plain engine's; the forward,
               sampling, host_prep and host_sync medians and the sampling
               share.  6b: warm graphed K=1 and K=8 with obs off, metrics
               + drift, and metrics + drift + trace + event log: tokens,
               CommitEvents and host waits equal; the log and the trace
               valid, /metrics ticks and tokens equal the engine's, drift
               has ticks; tick wall medians.  6c: build_frontend on
               127.0.0.1: one slot in mode none, a streamed and a gathered
               request equal generate() bit for bit; four slots warm
               graphed: 17 requests on paused workers (one answered 429),
               each complete with its commit positions partitioning its
               generation region, monotone ticks, no mask id; a
               torch.profiler trace of 4 ticks; loadgen's 16 requests
               (TTFT, tokens/s, latency); a graceful drain.  6d:
               ``python -m repro_torch.launch.serve --arch llada-8b
               --full`` as a subprocess with --breakdown, a trace and an
               event log (both valid, logquery --validate exits 0), and
               with --legacy; each exits 0.
  7. moe  -- the MoE family, one model at a time after llada-8b is freed:
               llada-moe-7b-a1b at full width, 2 of its 24 layers (a
               depth cut for the script's time limit; d 2048,
               64 experts top-2, bf16, seeded random weights) through
               generate (mode none stepped, each step's sampling held
               against plain; dual + BAOS and prefix + BAOS as phase 3),
               the engine's four paths eager K=1, graphed K=1 and K=8
               with phase 4's checks, warm + BAOS with an mxfp4_e2m1 KV
               cache (graphed K=1 equal to eager), the paged pool on warm
               graphed K=1 and K=8 (equal to the slot pool, no capture
               after warmup()), breakdown on warm graphed (the MoE
               sampling share), the Table 6 shape in modes none, prefix +
               BAOS and dual + BAOS (eager against graphed, a second
               generate() capturing nothing, tokens/s beside the paper's
               H100 rows), the batched expert dispatch at the engine's
               shape against JAX's one-group algorithm row by row (kept
               pairs equal, output within one bf16 ulp) and the expert
               products' device time against their byte floors; then
               qwen2-moe-a2.7b at full width and depth and
               moonshot-v1-16b-a3b at full width, 6 of 48 layers (a depth
               cut for the script's time limit), through the
               engine on path warm, eager against graphed K=1, each tick's
               sampling held against plain (a model whose weights leave
               under 12 GiB free runs at a cut depth, logged).
  8. recurrent -- a windowed refine past the window on the card (smoke
               widths, bf16: graphed equals eager); then the recurrent
               families at full width, one model at a time, on the
               legacy head (full-sequence logits, stablemax_sampling,
               topk_mask; no fused head): recurrentgemma-2b (5 of 26
               layers, a depth cut for the script's time limit, d 2560,
               MQA 10 on 1 KV head of D 256, V 256000) through
               generate (mode none stepped, dual + BAOS and prefix + BAOS
               stepped and through generate()), the engine paths warm,
               none and warm + BAOS eager K=1, graphed K=1 and K=8 with
               phase 4's checks, the paged pool on warm graphed K=1 and
               K=8, breakdown on warm graphed and the Table 6 shape in
               modes none, prefix + BAOS and dual + BAOS; mamba2-130m (2
               of 24 layers, d 768, state 128, V 50280) through generate (none,
               dual, prefix with BAOS on the state) and the engine paths
               warm and none; per model the RG-LRU or SSD scan's device
               time at 4 x 96 and 16 x 384, flash_bidir at D 256 in the
               warm tick's shape against its bound and SDPA,
               stablemax_sampling at (1024, V) and (64, V) against plain,
               its bound and softmax + max, and the legacy head product
               against its bound (which must show device time).
  9. audio, vlm -- the last two families, one model at a time, on the
               legacy head, in a process of its own (phase_audio_vlm;
               budget PHASE9_BUDGET_S):
               whisper-medium at full width (24 encoder layers, 4 of 24
               decoder layers, a depth cut) with the cross K/V
               of seeded frames (4, 1500, 1024) through generate (none
               stepped, dual and prefix + BAOS), the engine's warm, none
               and warm + BAOS eager and graphed K=1 (the paged pool and
               the megatick must refuse the kwargs), breakdown and the
               serve CLI; internvl2-26b at full width (4 of its 48
               layers, a depth cut for the script's time limit) with
               image embeddings through generate (prompts 288, gen 64) and
               the engine text-only (warm and none, eager, K=1, K=8; paged
               warm K=1).
  10. formats, random, sim -- on llada-8b after phase 6, in the main
               process (budget PHASE10_BUDGET_S): the engine's warm path
               graphed K=1 for 16 ticks at sampling format mxint4 (the
               fused head) and at mxint8 on the unfused head
               (stablemax_sampling), exactly one sampling-kernel and one
               topk_mask launch a tick and no plain version run; each
               tick's sampling at 4 x 16 rows against plain in both
               (check_ticks_sampling); strategy 'random' on the warm path
               eager K=1, graphed K=1 and K=8 (equal tokens, CommitEvents,
               ticks; no mask id left), each tick's transfer the plain
               top-k of the documented draw (sampling.random_select of the
               tick seed), and generate dual + BAOS graphed = eager; then
               sim/trace.capture_tick_trace of llada-8b on the meta device
               at the engine's shape (B 4, s_tot 96, L 16) and Table 6's
               (B 16, s_tot 384, L 64), head paths fused, unfused and
               legacy, cache none and warm: an eager tick on the card with
               a Tracer records the same op list, and each trace's
               simulated NPU sampling stage (sim/cycle.simulate) is
               printed beside the card's measured tick_sample.
  11. train -- the training path, in a process of its own after phase 9
               (budget PHASE11_BUDGET_S): (a) qwen2-0.5b at full width and
               depth (24 layers, d 896, 14 q heads on 2, V 151936, bf16,
               seeded random weights), one step of loss and every
               gradient at B 8 x S 128 through the kernels (24 launches
               each of flash_bidir and flash_bidir_bwd) against plain
               attention under autograd and an f32 reference
               (check_train_step's gates); (b) 20 steps through
               launch/train.main with a checkpoint every 5 and a failure
               injected at step 7 (restarts=1, every loss finite), then a
               resume from the step-15 checkpoint whose steps 16-20 equal
               the first run's losses bit for bit; step wall, tokens/s,
               peak memory; (c) packed MX storage at llada-8b's cache
               shape (4, 96, 32, 128) bf16: unpack(pack(x)) ==
               mx_fake_quant(x) bit for bit in mxint4 and mxint8, its
               bytes, and QuaRot keeping QKᵀ within 1e-5 of its largest
               value.
  12. mesh and split cache -- (budget PHASE12_BUDGET_S) (a) in the main
               process after phase 10, llada-8b at full width and depth on
               a (1, 1) mesh, a one-rank NCCL group: the engine's warm and
               none paths eager K=1, graphed K=1 (the tick and its
               collectives one CUDA graph) and graphed K=8, each equal to
               phase 4's run of the same path without a mesh (tokens,
               per-request ticks, CommitEvents, ticks), every tick exactly
               one launch of the fused head's vocab-shard entry (route A)
               and one of topk_mask, no plain version; (c) llada-8b
               generate in dual mode + BAOS mxint4 at Table 6's shape
               (B 16, prompt 128, gen 256, block 64, 16 steps) through the
               split cache (act_len 64), eager and graphed: graphed equal
               to eager, no mask id left, a refine launching route B
               (flash_bidir over the cache and the active buffer) once a
               layer, one refine's logits with BAOS mxint8 within 5% of
               the largest logit of the unified cache's (JAX's
               tests/test_split_cache.py case and bound; mxint4's
               printed), step wall and tokens/s; (b) after phase 10's model
               is freed, meshes (1, 2) and (2, 1) of two ranks sharing the
               card (gloo, eager) in a job of their own
               (torch.distributed.run, ``phase12b_main``): llada-8b at full
               width, PHASE12B_LAYERS of its 32 layers (a depth cut for
               memory and time), the engine's warm path on the slot pool
               and on the paged pool against a one-rank run of the same
               model, canvas for canvas each tick (live rows), any
               difference a recorded near-tie, the paged pool's canvases
               equal to the slot pool's on the same mesh, and each tick's
               collective time.  Phase 2 holds route A at (64, 4096,
               V_pad / 2) bf16 mxfp8, shard 1, and on padded heads
               (col_limit), route B at the split refine's shape (16, 64,
               32 on 32, 128) over 384 + 64 keys with BAOS, and route C at
               recurrentgemma-2b's shard (64, 128000) bf16 mxfp8 in every
               format, each against its plain version, timed beside its
               bound and a library call.
  13. step builders -- launch/steps.py (budget PHASE13_BUDGET_S): (a) in
               phase 11's process, qwen2-0.5b at full width and depth, B 8
               x S 128: build_step(train) equal to make_train_step on the
               same draw bit for bit (loss and every updated parameter),
               loss_chunk=64 within 1e-6 relative, the step on a (1, 1)
               NCCL mesh equal to no mesh bit for bit, compressed_psum over
               that mesh's data axis on the step's full gradients equal to
               dequant(quant(g + e)) with the residual as its error, bit
               for bit, timed; (b) beside phase 12c, llada-8b at Table 6's
               shape: build_step(prefill) then build_step(decode) under
               ServePolicy() and ServePolicy(split_cache=True), the decode
               canvas equal to refine_step + sampling_step with every
               kernel plain off recorded near-ties, exact launches a step,
               no plain version, ms a step; (c) in phase 12b's two-rank
               job, now run after phase 11: llada-8b prefill + decode on
               mesh (1, 2), the tensor-parallel body against one rank as
               in phase 14 (``tp_serve_check``, 4 layers), qwen2-0.5b in
               f32 at PHASE13C_LAYERS layers (cut_depth) trains on (2, 1) within 1e-5 of one rank (loss relative,
               each gradient leaf against its largest value; parameters
               within 2 x lr + 1e-6), llada-8b (4 layers) prefill + decode
               on (2, 1) equal to one rank bit for bit, compressed_psum
               over the two ranks within each block's int8 half-step of
               the plain mean, and the elastic restore of phase 11's
               qwen2-0.5b checkpoint under (1, 2) and (2, 1) placements,
               each rank's shard equal to the full leaf's slice bit for
               bit, with bytes read and ms.
  14. the tensor-parallel body -- models/tp.py (budget PHASE14_BUDGET_S),
               four ranks sharing the card over gloo in a job of their own
               (torch.distributed.run, ``phase14_main``), after phase 12b's
               job; f32 copies of the models, the BAOS cache in format
               none (TP_POLICY_FMT), Table 6's shape, each rank holding
               only its shards: (a) llada-8b at PHASE14_LAYERS layers,
               prefill + decode on (2, 2) (head-parallel cache, route A);
               (b) qwen2-0.5b at PHASE14B_LAYERS layers on (1, 4) (two
               KV heads: a context-parallel cache, ``wk`` cut mid-head,
               q/k/v gathered, route A); (d) mamba2-130m at 4 layers on
               (1, 4) (six SSD heads a rank, the head gathered) and (e)
               recurrentgemma-2b at 5 layers on (2, 2) (a context-parallel
               cache, route C); each against the one-rank steps on the
               rank's rows: logits, the cache (per channel) and its
               calibration within TP_*_BOUND, the decode canvas equal off
               recorded near-ties, every model rank's canvas equal, exact
               launches a step, no plain version, ms a step and its
               collectives' ms; (a') llada-8b at PHASE14_LAYERS layers on
               (2, 2) in the served configuration (bf16, ServePolicy():
               the mxint4 cache; ``tp_served_check``): its distance from
               an f32 run at most TP_BF16_RATIO times one bf16 rank's, the
               canvas equal to one bf16 rank's off near-ties; (c)
               qwen2-0.5b's f32 train step at PHASE13C_LAYERS layers on
               (2, 2) against one rank (loss 1e-5 relative, gradients 1e-5
               of each leaf's largest, parameters 2 x lr + 1e-6), and
               mamba2-130m's on (1, 4) (its gradients per stacked leaf,
               JAX's layout).  Then the
               dry run's llada-8b decode_32k cell at (16, 16), traced on
               meta tensors in the main process (launch/dryrun.py).
Every path's launch counts are zeroed just before it and read just after;
the kernels line sums them over phases 4, 4b, 3b, 5, 6a-6c, 10, 12, 13b,
7, 8, 9, 11 (with 13a), 12b (with 13c) and 14 (route C's from 14e); the
fused head's and Stable-Max's rows carry ``by_fmt``, phase 10's kernel
cases per new format.
Prints the run's time, the kernels JSON line, the card's name and power
limit, and last the {"ok": true, ...} line.  Exits non-zero without a
result when there is no CUDA device or the port is not beside this
script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, f32
# FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

LLADA = dict(d=4096, V=126464, mask_id=126336)
# sampling formats: the three the sampling kernels took before phase 10,
# then the four MX formats they learnt with it (core/mx.FORMATS)
BASE_FMTS = ("none", "bf16", "mxfp8_e4m3")
NEW_FMTS = ("mxint8", "mxint4", "mxfp6_e3m2", "mxfp4_e2m1")
ALL_FMTS = BASE_FMTS + NEW_FMTS
# phase 12's time budget, seconds (stated before its first run)
PHASE12_BUDGET_S = 120
# the Pallas kernel each CUDA kernel replaces (def line)
REPLACES = {
    "fused_head_sampling_shard":
        "src/repro/kernels/fused_head_sampling.py:134",
    "flash_bidir_split": "src/repro/kernels/flash_bidir.py:78",
    "stablemax_sampling_shard":
        "src/repro/kernels/stablemax_sampling.py:71",
    "fused_head_sampling_shard_sampled":
        "src/repro/kernels/fused_head_sampling.py:134",
    "stablemax_sampling_shard_sampled":
        "src/repro/kernels/stablemax_sampling.py:71",
    "fused_head_sampling": "src/repro/kernels/fused_head_sampling.py:134",
    "topk_mask": "src/repro/kernels/topk_mask.py:44",
    "flash_bidir": "src/repro/kernels/flash_bidir.py:78",
    "baos_mx_quant": "src/repro/kernels/baos_mx_quant.py:61",
    "stablemax_sampling": "src/repro/kernels/stablemax_sampling.py:71",
    "flash_bidir_bwd": "jax.grad of src/repro/models/layers.py attention "
                       "(no Pallas backward)"}
QWEN2 = dict(d=896, V=151936, mask_id=151935)
MINICPM = dict(d=2304, V=122753, mask_id=122752)
# the device kernel each wrapper call launches once, as the profiler names
# it (the head and Stable-Max wrappers then launch their combine kernel,
# flash_bidir_bwd its dk/dv kernel)
DEVICE_KERNEL = {"fused_head_sampling": "head_partials",
                 "topk_mask": "topk_mask_kernel",
                 "flash_bidir": "flash_bidir",
                 "baos_mx_quant": "baos_mx_quant_kernel",
                 "stablemax_sampling": "stablemax_kernel",
                 "flash_bidir_bwd": "flash_bidir_bwd_dq"}


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Host sleep at both ends of a profiler window, with the device idle
PROFILE_PAD_S = 0.05


@contextlib.contextmanager
def profiled():
    """torch.profiler over host and device activity.  The profiler keeps a
    device activity only if it lies inside the window on the host's clock,
    into which the device's timestamps are converted; where the two clocks
    disagree, the first or last kernels of a window that starts just
    before its first launch, or ends just after its last synchronize, are
    dropped although they ran.  One H100 run lost the last five kernels of
    a 16-tick window so.  The device is idle and the host asleep for
    PROFILE_PAD_S at both ends, so such skew falls on empty time.  The
    caller synchronizes before the window and before leaving it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


class Failure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def head_logits_f32(h, w, fmt, suppress_id, logit_scale=1.0):
    """The plain version's quantized f32 logits, for the near-tie rule."""
    from repro_torch.core import sampling
    return quantized_f32(sampling.head_logits(h, w, logit_scale=logit_scale),
                         fmt, suppress_id)


def quantized_f32(z, fmt, suppress_id):
    from repro_torch.core import mx, sampling
    z = mx.mx_fake_quant(z, fmt).float()
    z[:, suppress_id] = sampling.NEG_INF
    return z


def near_ties(z, tok, temperature, seed, rows, col0: int = 0):
    """Whether each row's kernel token is a near-tie of the plain one: its
    score (the quantized logit, or z/T + g with Gumbel, drawn at global row
    ``rows[i]`` and global column ``col0`` + j) within 1e-2 relative of the
    row's best score."""
    from repro_torch.core import sampling
    if temperature > 0:
        cols = torch.arange(z.shape[1], device=z.device)[None, :] + col0
        r = torch.as_tensor(rows, device=z.device)[:, None]
        z = z / temperature + sampling.counter_gumbel(seed, r, cols)
    zk = z.gather(1, tok.long()[:, None])[:, 0]
    zmax = z.amax(-1)
    return ((zmax - zk).abs() <= 1e-2 * zmax.abs()).tolist()


def check_head(h, w, mid, fmt, temperature, seed):
    """Kernel vs plain on hidden h (R, d) and head w (d, V); returns (rows
    that differ, max abs conf error on agreeing rows).  Every differing
    row must be a near-tie, and conf within 1e-2 relative."""
    from repro_torch.kernels import fused_head_sampling as fhs
    R, d = h.shape
    kw = dict(fmt=fmt, suppress_id=mid, temperature=temperature, seed=seed)
    conf_k, tok_k = fhs.fused_head_sampling(h, w, **kw)
    conf_p, tok_p = fhs.fused_head_stable_max(
        h, w, fmt, suppress_id=mid, temperature=temperature, seed=seed)
    torch.cuda.synchronize()
    what = f"fused head {h.dtype} R={R} d={d} {fmt} T={temperature}"
    same = tok_k == tok_p
    diff_rows = torch.nonzero(~same).flatten().tolist()
    if diff_rows:
        z = head_logits_f32(h[diff_rows], w, fmt, mid)
        near = near_ties(z, tok_k[diff_rows], temperature, seed, diff_rows)
        require(all(near), f"{what}: tokens differ off a near-tie in rows "
                           f"{diff_rows}")
    err = (conf_k - conf_p).abs()[same]
    rel = (err / conf_p.abs()[same])
    require(bool((rel <= 1e-2).all()),
            f"{what}: conf rel err {float(rel.max()):.3g} > 1e-2")
    return len(diff_rows), float(err.max())


def random_head(widths, gen, dtype=torch.bfloat16):
    d, V = widths["d"], widths["V"]
    return (torch.randn(d, V, generator=gen, device=DEVICE)
            * (2.0 / (d + V)) ** 0.5 * 8).to(dtype)


def bf16_ulp(x):
    """One bf16 ulp at each value of bf16 x (8 significant bits; 0 at 0)."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def phase_kernels(gen) -> dict:
    import torch.nn.functional as F
    from repro_torch.core import sampling
    from repro_torch.kernels import flash_bidir as fb
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import topk_mask as tk
    out = {}

    # fused head, bf16 (tensor cores): llada and qwen2 widths, R 16 (one
    # generate block), 64 (the engine's 4 x 16, the main path) and 200
    # (four row groups), greedy and T = 0.8, every sampling fmt
    n_diff = n_rows = 0
    for widths in (LLADA, QWEN2):
        w = random_head(widths, gen)
        for R in (16, 64, 200):
            h = torch.randn(R, widths["d"], generator=gen,
                            device=DEVICE).to(torch.bfloat16)
            for fmt in BASE_FMTS:
                for temperature in (0.0, 0.8):
                    nd, err = check_head(h, w, widths["mask_id"], fmt,
                                         temperature, 1234)
                    n_diff, n_rows = n_diff + nd, n_rows + R
                    log(f"fused_head bf16 d={widths['d']} V={widths['V']} "
                        f"R={R} {fmt} T={temperature}: rows differing "
                        f"{nd}/{R}, conf max abs err {err:.3g}")
                    if (widths is LLADA and R == 64 and temperature == 0.0
                            and fmt == "mxfp8_e4m3"):
                        main_inputs, head_err = (h, w), err
        del w
    require(n_diff <= 0.01 * n_rows,
            f"fused head: {n_diff}/{n_rows} rows differ (> 1%)")
    # the f32 route (CUDA cores) at a small shape
    w = random_head(dict(d=256, V=3000), gen, torch.float32)
    h = torch.randn(24, 256, generator=gen, device=DEVICE)
    for fmt in ALL_FMTS:
        for temperature in (0.0, 0.8):
            nd, err = check_head(h, w, 2999, fmt, temperature, 99)
            log(f"fused_head f32 (24, 256) @ (256, 3000) {fmt} "
                f"T={temperature}: rows differing {nd}/24, conf max abs "
                f"err {err:.3g}")
    check_head_ragged(gen)
    h, w = main_inputs
    kw = dict(fmt="mxfp8_e4m3", suppress_id=LLADA["mask_id"])
    R, d = h.shape
    V = w.shape[1]
    b_ms, b_by = bound(R * d * 2 + d * V * 2 + R * 8, 2.0 * R * d * V,
                       BF16_FLOPS)
    log(f"fused_head bf16 ({R}, {d}) @ ({d}, {V}) mxfp8 greedy device "
        f"time (profiler) {device_ms(lambda: fhs.fused_head_sampling(h, w, **kw), 20):.4f}"
        f" ms per call (partials + combine), bound {b_ms:.4f} ms; "
        f"torch.matmul(h, w) {device_ms(lambda: torch.matmul(h, w), 20):.4f}"
        f" ms")
    out["fused_head_sampling"] = dict(
        max_abs_err=head_err,
        ms=time_ms(lambda: fhs.fused_head_sampling(h, w, **kw), 20),
        plain_ms=time_ms(lambda: fhs.fused_head_stable_max(
            h, w, kw["fmt"], suppress_id=kw["suppress_id"]), 5),
        library_ms=time_ms(lambda: torch.matmul(h, w), 20),
        bound_ms=b_ms, bound_by=b_by)

    check_seed_tensor(h, w, LLADA["mask_id"])
    del h, w, main_inputs
    out["topk_mask"] = check_topk(gen)

    # attention, bf16 (tensor cores): main path (warm tick: ragged
    # kv_valid), GQA, BAOS + window, D 32, a batch row with no valid key
    # (every key counts), a refine segment (16 query rows at positions 40..
    # over a 96-long cache) and a long sequence that runs the K/V ring over
    # 32 tiles; each within one bf16 ulp of the plain value + 1e-6
    for (B, S, Sk, Hq, Hkv, D, baos, win, off, lens) in (
            (4, 96, 96, 32, 32, 128, False, None, 0, (96, 48, 37, 1)),
            (4, 96, 96, 14, 2, 64, False, None, 0, (96, 48, 37, 1)),
            (2, 80, 80, 32, 32, 128, True, 17, 0, (80, 40)),
            (4, 96, 96, 8, 4, 32, True, 9, 0, (96, 48, 37, 1)),
            (3, 64, 64, 8, 8, 64, False, None, 0, (0, 64, 33)),
            (2, 16, 96, 32, 32, 128, False, 9, 40, (96, 48)),
            (1, 1024, 1024, 32, 32, 128, False, None, 0, (1024,))):
        q = torch.randn(B, S, Hq, D, generator=gen, device=DEVICE).bfloat16()
        kk = torch.randn(B, Sk, Hkv, D, generator=gen, device=DEVICE).bfloat16()
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=DEVICE).bfloat16()
        valid = torch.arange(Sk, device=DEVICE)[None, :] < torch.tensor(
            lens, device=DEVICE)[:, None]
        cal = [None] * 3
        if baos:
            cal = [torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.randn(B, Hkv, D, generator=gen, device=DEVICE)]
        got = fb.flash_bidir(q, kk, v, valid, *cal, window=win, q_offset=off)
        want = fb.flash_bidir_plain(q, kk, v, valid, *cal, window=win,
                                    q_offset=off)
        err = (got.float() - want.float()).abs()
        excess = float((err - bf16_ulp(want)).max())
        log(f"flash_bidir bf16 B={B} Sq={S} Skv={Sk} Hq={Hq} Hkv={Hkv} D={D} "
            f"baos={baos} window={win} q_offset={off} kv_valid lengths "
            f"{lens}: max abs err "
            f"{float(err.max()):.3g}, max err beyond one bf16 ulp "
            f"{excess:.3g}")
        require(excess <= 1e-6, f"flash_bidir {(B, S, Sk, Hq, Hkv, D)} "
                                f"beyond one bf16 ulp + 1e-6")
        if (B, S, Hq, D) == (4, 96, 32, 128):
            main_attn = (q, kk, v, valid, float(err.max()))
    # the f32 route (CUDA cores) at a small shape, BAOS, window, kv_valid
    q = torch.randn(2, 40, 4, 64, generator=gen, device=DEVICE)
    kk = torch.randn(2, 40, 2, 64, generator=gen, device=DEVICE)
    v = torch.randn(2, 40, 2, 64, generator=gen, device=DEVICE)
    valid = torch.arange(40, device=DEVICE)[None, :] < torch.tensor(
        [[40], [0]], device=DEVICE)
    cal = [torch.rand(2, 2, 64, generator=gen, device=DEVICE) + 0.5,
           torch.rand(2, 2, 64, generator=gen, device=DEVICE) + 0.5,
           torch.randn(2, 2, 64, generator=gen, device=DEVICE)]
    got = fb.flash_bidir(q, kk, v, valid, *cal, window=7, q_offset=3)
    want = fb.flash_bidir_plain(q, kk, v, valid, *cal, window=7, q_offset=3)
    err = float((got - want).abs().max())
    log(f"flash_bidir f32 (2, 40, 4, 2, 64) baos window=7 q_offset=3: max "
        f"abs err {err:.3g} (max |out| {float(want.abs().max()):.3g})")
    require(err <= 1e-5 * float(want.abs().max()),
            "flash_bidir f32 route differs from plain beyond 1e-5 of max|out|")
    check_attn_head_dims(gen)
    q, kk, v, valid, attn_err = main_attn
    B, S, Hq, D = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    sdpa_mask = valid[:, None, None, :]
    # what this run's data needs: q and out, and K and V at the keys that
    # count (the valid ones, or every key of a row without a valid key)
    n_keys = int(torch.where(valid.any(1), valid.sum(1), S).sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * n_keys * kk.shape[2] * D * 2
                       + valid.numel(), 4.0 * Hq * S * n_keys * D,
                       BF16_FLOPS)
    log(f"flash_bidir bf16 (4, 96, 32, 32, 128) kv_valid device time "
        f"(profiler) {device_ms(lambda: fb.flash_bidir(q, kk, v, valid), 50):.4f}"
        f" ms per call (all keys valid: "
        f"{device_ms(lambda: fb.flash_bidir(q, kk, v), 50):.4f} ms), bound "
        f"{b_ms:.4f} ms; scaled_dot_product_attention "
        f"{device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask), 50):.4f}"
        f" ms")
    out["flash_bidir"] = dict(
        max_abs_err=attn_err,
        ms=time_ms(lambda: fb.flash_bidir(q, kk, v, valid), 50),
        plain_ms=time_ms(lambda: fb.flash_bidir_plain(q, kk, v, valid), 20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask), 50),
        bound_ms=b_ms, bound_by=b_by)
    out["flash_bidir_bwd"] = check_attn_backward(gen)
    check_no_backward_guard(gen)
    out["fused_head_sampling_shard"] = check_route_a(gen)
    out["flash_bidir_split"] = check_route_b(gen)
    out["stablemax_sampling_shard"] = check_route_c(gen)
    (out["fused_head_sampling_shard_sampled"],
     out["stablemax_sampling_shard_sampled"]) = check_sampled_routes(gen)
    out["baos_mx_quant"] = check_baos(gen)
    out["stablemax_sampling"] = check_stablemax(gen)
    for name, rows in check_sampling_formats(gen).items():
        out[name]["by_fmt"] = rows
    check_audio_vlm_shapes(gen)
    return out


def attn_mask_pairs(B, Sq, Skv, valid, window) -> int:
    """The (row, key) pairs attention's gradient needs per query head: the
    keys each row attends to, or every key for a row with none (it
    averages V)."""
    from repro_torch.kernels import flash_bidir as fb
    ok = fb._mask(B, Sq, Skv, valid, window, 0, DEVICE)[:, 0]
    n = ok.sum(-1)
    return int(torch.where(n > 0, n, Skv).sum())


def check_attn_backward(gen) -> dict:
    """flash_bidir_bwd (csrc/flash_bidir_bwd.cu) against
    flash_bidir_bwd_plain on the card: llada-8b's training attention (8,
    128, 32 on 32, 128) bf16, qwen2-0.5b's (8, 128, 14 on 2, 64) bf16 (the
    shape phase 11's train step gives it), D 256 with window 2048 and
    kv_valid (4, 256, 10 on 1) bf16, and the f32 route at a small shape
    with a batch row that has no valid key.  f32: within 1e-4 x the
    largest reference gradient, and dq = dk = 0 on the row with no valid
    key.  bf16: the kernel's error against an f32 recomputation of the
    same bf16 inputs at most 2x the plain bf16 version's, plus one bf16
    ulp.  Two launches give the same bits.  Each case timed (CUDA events;
    a graph of 20 calls) beside its bound and the library yardstick, the
    backward of scaled_dot_product_attention (its forward + backward less
    its forward, timed only).  Returns qwen2-0.5b's row."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_bidir as fb
    cases = (("llada-8b training", 8, 128, 32, 32, 128, torch.bfloat16,
              None, None),
             ("qwen2-0.5b training", 8, 128, 14, 2, 64, torch.bfloat16,
              None, None),
             ("D 256 window 2048 kv_valid", 4, 256, 10, 1, 256,
              torch.bfloat16, 2048, (256, 128, 77, 1)),
             ("f32 route, a row with no valid key", 3, 40, 6, 2, 64,
              torch.float32, 7, (40, 0, 13)))
    rows = {}
    for what, B, S, Hq, Hkv, D, dt, win, lens in cases:
        q, o_grad = (torch.randn(B, S, Hq, D, generator=gen, device=DEVICE)
                     .to(dt) for _ in range(2))
        kk, v = (torch.randn(B, S, Hkv, D, generator=gen, device=DEVICE)
                 .to(dt) for _ in range(2))
        valid = None
        if lens is not None:
            valid = torch.arange(S, device=DEVICE)[None, :] < torch.tensor(
                lens, device=DEVICE)[:, None]
        args = (q, kk, v, o_grad, valid, win, 0)
        got = fb.flash_bidir_bwd(*args)
        again = fb.flash_bidir_bwd(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash_bidir_bwd {what}: two launches differ")
        ref = fb.flash_bidir_bwd_plain(*(t.float() for t in args[:4]),
                                       valid, win, 0)
        errs = []
        if dt == torch.float32:
            for n, g, r in zip("qkv", got, ref):
                err = float((g - r).abs().max())
                errs.append(err)
                require(bool(torch.isfinite(g).all()) and
                        err <= 1e-4 * float(r.abs().max()),
                        f"flash_bidir_bwd {what}: d{n} beyond 1e-4 of "
                        f"max|d{n}| ({err:.3g})")
            dead = ~valid.any(1)
            require(not got[0][dead].any() and not got[1][dead].any(),
                    f"flash_bidir_bwd {what}: dq/dk nonzero on a row "
                    f"with no valid key")
            note = "within 1e-4 of max|grad|"
        else:
            plain = fb.flash_bidir_bwd_plain(*args)
            worst = 0.0
            for n, g, p, r in zip("qkv", got, plain, ref):
                e_k = float(((g.float() - r).abs() - bf16_ulp(r)).max())
                e_p = float((p.float() - r).abs().max())
                errs.append(float((g.float() - r).abs().max()))
                worst = max(worst, e_k / e_p)
                require(e_k <= 2 * e_p, f"flash_bidir_bwd {what}: d{n} "
                        f"error {e_k:.3g} beyond one bf16 ulp, over 2x the "
                        f"plain bf16 version's {e_p:.3g}")
            note = (f"error beyond one bf16 ulp at most {worst:.3f}x the "
                    f"plain bf16 version's")
        fn = lambda: fb.flash_bidir_bwd(*args)  # noqa: E731
        n_pairs = attn_mask_pairs(B, S, S, valid, win)
        es = q.element_size()
        n_keys = B * S if valid is None else int(valid.sum())
        b_ms, b_by = bound(3 * q.numel() * es + 2 * n_keys * Hkv * D * es
                           + 2 * kk.numel() * es
                           + (0 if valid is None else valid.numel()),
                           8.0 * Hq * D * n_pairs,
                           BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        row = dict(max_abs_err=max(errs), device_ms=kernel_ms(fn, 20, what),
                   ms=time_ms(fn, 20),
                   plain_ms=time_ms(lambda: fb.flash_bidir_bwd_plain(*args),
                                    5),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if dt == torch.bfloat16:
            G = Hq // Hkv
            qt = q.transpose(1, 2).detach().requires_grad_()
            kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                      .detach().requires_grad_() for t in (kk, v))
            mask = None if valid is None else fb._mask(B, S, S, valid, win,
                                                       0, DEVICE)
            dot = o_grad.transpose(1, 2)
            lib_f = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
            lib_fb = lambda: lib_f().backward(dot)  # noqa: E731
            row["library_ms"] = time_ms(lib_fb, 20) - time_ms(lib_f, 20)
        rows[what] = row
        lib = ("n/a (SDPA's masked row is NaN)" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        log(f"flash_bidir_bwd {what} (B {B}, S {S}, {Hq} q heads on {Hkv}, "
            f"D {D}, {str(dt).replace('torch.', '')}, window {win}, kv_valid "
            f"{lens}): {note}, max abs err {max(errs):.3g}, two launches "
            f"bit for bit; device {row['device_ms']:.4f} ms (a graph of 20 "
            f"calls), CUDA events {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{'bf16 tensor-core' if dt == torch.bfloat16 else 'f32'} peak), "
            f"{row['device_ms'] / b_ms:.0f}x; SDPA backward {lib}")
    return rows["qwen2-0.5b training"]


def check_no_backward_guard(gen) -> None:
    """The four kernels without a backward refuse inputs that require grad
    while grad mode is on (their output would cut the graph), and
    flash_bidir refuses BAOS calibration under autograd; each still runs
    under torch.no_grad()."""
    from repro_torch.kernels import baos_mx_quant as bmq
    from repro_torch.kernels import flash_bidir as fb
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.kernels import topk_mask as tk

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    h, w = randn(16, 256), randn(256, 1024)
    z = randn(16, 1024)
    conf = randn(4, 16, dtype=torch.float32)
    mask = torch.ones(4, 16, dtype=torch.bool, device=DEVICE)
    k = torch.full((4,), 3, dtype=torch.int32, device=DEVICE)
    x = randn(2, 32, 4, 64)
    center = torch.zeros(2, 1, 4, 64, device=DEVICE)
    scale = torch.ones(2, 1, 4, 64, device=DEVICE)
    calls = {
        "fused_head_sampling": (lambda a: fhs.fused_head_sampling(a, w), h),
        "stablemax_sampling": (lambda a: sms.stablemax_sampling(a), z),
        "topk_mask": (lambda a: tk.topk_mask(a, mask, k), conf),
        "baos_mx_quant": (lambda a: bmq.baos_mx_quant(a, center, scale), x)}
    for name, (call, arg) in calls.items():
        try:
            call(arg.detach().requires_grad_())
        except RuntimeError as e:
            require("no backward" in str(e), f"{name}: {e}")
        else:
            raise Failure(f"{name} ran on an input that requires grad")
        with torch.no_grad():
            call(arg.detach().requires_grad_())
    q, kv = randn(2, 8, 4, 64).requires_grad_(), randn(2, 8, 2, 64)
    cal = torch.ones(2, 2, 64, device=DEVICE)
    try:
        fb.flash_bidir(q, kv, kv, fk=cal, fv=cal, cv=cal)
    except NotImplementedError:
        pass
    else:
        raise Failure("flash_bidir took BAOS calibration under autograd")
    torch.cuda.synchronize()
    log("no-backward guard: fused_head_sampling, stablemax_sampling, "
        "topk_mask and baos_mx_quant raise on inputs that require grad "
        "(and run under no_grad); flash_bidir refuses BAOS under autograd")


def check_audio_vlm_shapes(gen) -> None:
    """The shapes phase 9's models first give two kernels, each against
    its plain version with its bound and its library call: flash_bidir's
    cross-attention (4, 96, 16 heads of D 64) on 1,500 encoder frames with
    no mask and the encoder's self-attention (4, 1500, 16, 64), both
    whisper-medium's (24 calls a forward each); stablemax_sampling at
    (64, 51865) and (64, 92553) bf16 (whisper-medium's and internvl2-26b's
    legacy heads), rows that are not 16-byte aligned (the scalar route)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device=DEVICE).to(torch.bfloat16)

    frames_kv = rand(4, 1500, 16, 64), rand(4, 1500, 16, 64)
    attn_row(rand(4, 96, 16, 64), *frames_kv, None,
             "whisper-medium cross-attention flash_bidir (4, 96, 16, 64) on "
             "(4, 1500, 16, 64), no mask", 24)
    attn_row(rand(4, 1500, 16, 64), *frames_kv, None,
             "whisper-medium encoder flash_bidir (4, 1500, 16, 64) on "
             "itself, no mask", 24)
    for name, V in (("whisper-medium", 51865), ("internvl2-26b", 92553)):
        zl = rand(64, V) * 3
        require(zl.stride(0) * 2 % 16 != 0, f"(64, {V}) rows are aligned")
        stablemax_row(zl, V - 1, name)


def check_head_ragged(gen) -> None:
    """The bf16 route at a vocabulary that is not a multiple of 8, on heads
    stored by pad_head (rows padded to padded_vocab(V) once, nothing copied
    per call): minicpm-2b's head (d 2304, V 122753) at the engine's 64
    rows, and (R 3, d 64, V 1003).  Every fmt, T 0 and 0.8 against the
    plain version (check_head: the near-tie rule, conf 1e-2, at most 1% of
    rows); at fmt none and bf16, greedy, against the f32 route on the same
    values (a differing token must be a near-tie of the f32 logits; mxfp8
    and Gumbel scores are not compared across routes: the f32 route's
    logits are not rounded to bf16, and mxfp8's 3-bit grid turns that
    0.2% into a whole grid step).  Then the time at minicpm-2b's shape
    against its byte bound and torch.matmul's."""
    from repro_torch.core import sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    n_diff = n_rows = 0
    for widths, R in ((MINICPM, 64), (dict(d=64, V=1003, mask_id=1002), 3)):
        d, V, mid = widths["d"], widths["V"], widths["mask_id"]
        w = fhs.pad_head(random_head(widths, gen))
        require(w.stride(0) == fhs.padded_vocab(V) and w.shape == (d, V),
                f"pad_head of V {V}: stride {w.stride(0)}")
        h = torch.randn(R, d, generator=gen, device=DEVICE).to(torch.bfloat16)
        for fmt in ALL_FMTS:
            for temperature in (0.0, 0.8):
                nd, err = check_head(h, w, mid, fmt, temperature, 1234)
                n_diff, n_rows = n_diff + nd, n_rows + R
                log(f"fused_head bf16 padded d={d} V={V} (row stride "
                    f"{w.stride(0)}) R={R} {fmt} T={temperature}: rows "
                    f"differing from plain {nd}/{R}, conf max abs err "
                    f"{err:.3g}")
        hf, wf = h.float(), w.float()
        for fmt in ("none", "bf16"):
            kw = dict(fmt=fmt, suppress_id=mid)
            _, tok_b = fhs.fused_head_sampling(h, w, **kw)
            _, tok_f = fhs.fused_head_sampling(hf, wf, **kw)
            rows = torch.nonzero(tok_b != tok_f).flatten().tolist()
            if rows:
                z = head_logits_f32(hf[rows], wf, fmt, mid)
                require(all(near_ties(z, tok_b[rows], 0.0, 0, rows)),
                        f"fused head V {V} {fmt}: the bf16 and f32 routes "
                        f"differ off a near-tie in rows {rows}")
            log(f"fused_head V={V} {fmt} greedy: bf16 route vs f32 route "
                f"rows differing {len(rows)}/{R} (near-ties)")
        if widths is MINICPM:
            main = (h, w)
        del w, wf
    require(n_diff <= 0.01 * n_rows,
            f"fused head, padded vocab: {n_diff}/{n_rows} rows differ (> 1%)")
    h, w = main
    R, d = h.shape
    V = w.shape[1]
    kw = dict(fmt="mxfp8_e4m3", suppress_id=MINICPM["mask_id"])
    b_ms, b_by = bound(R * d * 2 + d * V * 2 + R * 8, 2.0 * R * d * V,
                       BF16_FLOPS)
    log(f"fused_head bf16 padded ({R}, {d}) @ ({d}, {V}) mxfp8 greedy: "
        f"{time_ms(lambda: fhs.fused_head_sampling(h, w, **kw), 20):.4f} ms "
        f"(CUDA events), device time (profiler) "
        f"{device_ms(lambda: fhs.fused_head_sampling(h, w, **kw), 20):.4f} "
        f"ms, plain {time_ms(lambda: fhs.fused_head_stable_max(h, w, kw['fmt'], suppress_id=kw['suppress_id']), 3):.3f}"
        f" ms, bound {b_ms:.4f} ms ({b_by}); torch.matmul(h, w) "
        f"{time_ms(lambda: torch.matmul(h, w), 20):.4f} ms (device "
        f"{device_ms(lambda: torch.matmul(h, w), 20):.4f} ms)")


def check_attn_head_dims(gen) -> None:
    """flash_bidir at head dims past the 32/64/128 of the main path:
    D 256 at recurrentgemma-2b's attention layout (10 query heads on 1 KV
    head, window 2048, kv_valid), with and without BAOS; D 16 and D 96
    (the 32- and 128-wide tiles, predicated loads); each bf16 within one
    bf16 ulp + 1e-6 of the plain version; the f32 route at D 256 and 96
    within 1e-5 of max|out|.  Then D 256's time against its bound and
    scaled_dot_product_attention's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_bidir as fb
    cases = ((2, 128, 128, 10, 1, 256, False, 2048, (128, 61)),
             (2, 128, 128, 10, 1, 256, True, 2048, (128, 61)),
             (3, 80, 80, 10, 1, 256, False, 9, (80, 0, 33)),
             (4, 96, 96, 8, 2, 16, True, None, (96, 48, 37, 1)),
             (4, 96, 96, 12, 4, 96, False, None, (96, 48, 37, 1)),
             (2, 64, 64, 6, 3, 96, True, 5, (64, 20)))
    for B, S, Sk, Hq, Hkv, D, baos, win, lens in cases:
        q = torch.randn(B, S, Hq, D, generator=gen, device=DEVICE)
        kk = torch.randn(B, Sk, Hkv, D, generator=gen, device=DEVICE)
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=DEVICE)
        valid = torch.arange(Sk, device=DEVICE)[None, :] < torch.tensor(
            lens, device=DEVICE)[:, None]
        cal = [None] * 3
        if baos:
            cal = [torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.randn(B, Hkv, D, generator=gen, device=DEVICE)]
        what = (f"B={B} Sq={S} Skv={Sk} Hq={Hq} Hkv={Hkv} D={D} baos={baos} "
                f"window={win} kv_valid lengths {lens}")
        qb, kb, vb = q.bfloat16(), kk.bfloat16(), v.bfloat16()
        got = fb.flash_bidir(qb, kb, vb, valid, *cal, window=win)
        want = fb.flash_bidir_plain(qb, kb, vb, valid, *cal, window=win)
        err = (got.float() - want.float()).abs()
        excess = float((err - bf16_ulp(want)).max())
        log(f"flash_bidir bf16 {what} (route {fb.route(D, qb.dtype)}): max "
            f"abs err {float(err.max()):.3g}, beyond one bf16 ulp "
            f"{excess:.3g}")
        require(excess <= 1e-6, f"flash_bidir bf16 {what}: beyond one bf16 "
                                f"ulp + 1e-6")
        if D in (256, 96) and not baos:
            got = fb.flash_bidir(q, kk, v, valid, *cal, window=win)
            want = fb.flash_bidir_plain(q, kk, v, valid, *cal, window=win)
            e32 = float((got - want).abs().max())
            log(f"flash_bidir f32 {what}: max abs err {e32:.3g} (max |out| "
                f"{float(want.abs().max()):.3g})")
            require(e32 <= 1e-5 * float(want.abs().max()),
                    f"flash_bidir f32 {what}: beyond 1e-5 of max|out|")
    B, S, Hq, Hkv, D = 4, 256, 10, 1, 256
    q = torch.randn(B, S, Hq, D, generator=gen, device=DEVICE).bfloat16()
    kk = torch.randn(B, S, Hkv, D, generator=gen, device=DEVICE).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=gen, device=DEVICE).bfloat16()
    valid = torch.arange(S, device=DEVICE)[None, :] < torch.tensor(
        (256, 128, 77, 1), device=DEVICE)[:, None]
    n_keys = int(valid.sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * n_keys * Hkv * D * 2
                       + valid.numel(), 4.0 * Hq * S * n_keys * D, BF16_FLOPS)
    qt = q.transpose(1, 2)
    kt = kk.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    mask = valid[:, None, None, :]
    fn = lambda: fb.flash_bidir(q, kk, v, valid, window=2048)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    log(f"flash_bidir bf16 (4, 256, 10, 1, 256) window 2048 kv_valid: "
        f"{time_ms(fn, 50):.4f} ms (CUDA events), device time (profiler) "
        f"{device_ms(fn, 50):.4f} ms, plain "
        f"{time_ms(lambda: fb.flash_bidir_plain(q, kk, v, valid, window=2048), 10):.4f}"
        f" ms, bound {b_ms:.4f} ms ({b_by}); scaled_dot_product_attention "
        f"(K/V repeated to 10 heads beforehand) {time_ms(lib, 50):.4f} ms "
        f"(device {device_ms(lib, 50):.4f} ms)")


def check_topk(gen) -> dict:
    """topk_mask against its plain version with 0 positions differing: the
    main path's (4, 16), (8, 64), and L 1, 16, 33, 64 at R 3, 5, 7, 6 (not
    multiples of 4); each with exact ties, a row with nothing masked, k
    past L and k as int32 and as int64; bool in, bool out.  Then: a top-k
    of the sampling stage is one launch (no casts around it); the empty
    kernel's device time, the floor of any launch; the kernel's device
    time, its host time per call, and its bound."""
    from repro_torch.core import sampling
    from repro_torch.kernels import topk_mask as tk
    for R, L in ((4, 16), (8, 64), (3, 1), (5, 16), (7, 33), (6, 64),
                 (3, 65), (5, 128), (7, 256), (6, 1000)):
        for k_dtype in (torch.int32, torch.int64):
            conf = torch.rand(R, L, generator=gen, device=DEVICE)
            conf[:, ::3] = 0.5
            conf[1] = 0.25
            mask = torch.rand(R, L, generator=gen, device=DEVICE) < 0.7
            mask[R - 1] = False
            k = torch.randint(0, L + 2, (R,), generator=gen,
                              device=DEVICE).to(k_dtype)
            k[0] = L // 2
            got = tk.topk_mask(conf, mask, k)
            want = tk.topk_mask_plain(conf, mask, k)
            n_bad = int((got != want).sum())
            log(f"topk_mask ({R}, {L}) k {k_dtype} route {tk.route(L)}: "
                f"{n_bad} positions differ ({got.dtype} out)")
            require(got.dtype == torch.bool and n_bad == 0,
                    f"topk_mask ({R}, {L}) k {k_dtype} differs from plain")
            if (R, L, k_dtype) == (4, 16, torch.int32):
                main = (conf, mask, k)
    conf, mask, k = main
    per_call = device_kernels(
        lambda: sampling.topk_transfer_mask(conf, mask, k), 20)
    log(f"topk_transfer_mask on f32 conf, bool mask, int32 k: "
        f"{sum(n for _, n in per_call.values()):g} kernel launches per call "
        f"({', '.join(per_call)})")
    require(sum(n for _, n in per_call.values()) == 1,
            "a top-k of the sampling stage launches more than one kernel")
    check_topk_cta(gen)
    R, L = conf.shape
    b_ms, b_by = bound(R * L * (4 + 1 + 1) + R * 4, float(R * L * L),
                       F32_FLOPS)
    floor_dev = device_ms(lambda: tk.empty_launch(DEVICE), 200)
    floor_ev = time_ms(lambda: tk.empty_launch(DEVICE), 200)
    dev_ms = device_ms(lambda: tk.topk_mask(conf, mask, k), 200)
    h_ms = host_ms(lambda: tk.topk_mask(conf, mask, k), 200)
    log(f"topk_mask (4, 16) device time (profiler) {dev_ms:.5f} ms per "
        f"call, host time {h_ms:.5f} ms per call; bound {b_ms:.3g} ms ({b_by}); empty kernel (the "
        f"floor of one launch) {floor_dev:.5f} ms device, {floor_ev:.5f} ms "
        f"per launch back to back (CUDA events)")
    return dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: tk.topk_mask(conf, mask, k), 200),
        plain_ms=time_ms(lambda: tk.topk_mask_plain(conf, mask, k), 50),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_topk_cta(gen) -> None:
    """The CTA route (L > 64) at llama3.2-3b's block of 128 on 4 rows:
    one launch per top-k of the sampling stage, device time against the
    empty kernel's and the bound, host time per call; and at (64, 1000),
    a long row that streams through two shared-memory tiles' worth of
    positions."""
    from repro_torch.core import sampling
    from repro_torch.kernels import topk_mask as tk
    for R, L in ((4, 128), (64, 1000)):
        conf = torch.rand(R, L, generator=gen, device=DEVICE)
        mask = torch.rand(R, L, generator=gen, device=DEVICE) < 0.7
        k = torch.full((R,), L // 8, dtype=torch.int32, device=DEVICE)
        require(torch.equal(tk.topk_mask(conf, mask, k),
                            tk.topk_mask_plain(conf, mask, k)),
                f"topk_mask ({R}, {L}) differs from plain")
        per_call = device_kernels(
            lambda: sampling.topk_transfer_mask(conf, mask, k), 20)
        n_launch = sum(n for _, n in per_call.values())
        require(n_launch == 1, f"topk ({R}, {L}): {n_launch} launches per "
                               f"top-k")
        b_ms, b_by = bound(R * L * (4 + 1 + 1) + R * 4, float(R * L * L),
                           F32_FLOPS)
        log(f"topk_mask ({R}, {L}) route {tk.route(L)}: 1 launch per top-k "
            f"({', '.join(per_call)}); device time (profiler) "
            f"{device_ms(lambda: tk.topk_mask(conf, mask, k), 200):.5f} ms "
            f"per call, back to back (CUDA events) "
            f"{time_ms(lambda: tk.topk_mask(conf, mask, k), 200):.5f} ms, "
            f"host time {host_ms(lambda: tk.topk_mask(conf, mask, k), 200):.5f}"
            f" ms, plain {time_ms(lambda: tk.topk_mask_plain(conf, mask, k), 20):.4f}"
            f" ms; bound {b_ms:.3g} ms ({b_by}); library: none "
            f"(torch.topk is not stable)")


def check_seed_tensor(h, w, mid) -> None:
    """Both sampling kernels read the seed from device memory: at T 0.8 a
    tick_seed computed on the device from a device tick counter gives the
    tokens and conf, bit for bit, of the same seed passed as an int."""
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    s_int = diffusion.tick_seed(7, 5)
    s_dev = diffusion.tick_seed(7, torch.tensor([5], device=DEVICE))
    require(int(s_dev) == s_int, "tick_seed on the device differs")
    z = sampling.head_logits(h, w)
    for fmt in ALL_FMTS:
        kw = dict(fmt=fmt, suppress_id=mid, temperature=0.8)
        for what, fn, x in (("fused head", fhs.fused_head_sampling, (h, w)),
                            ("stablemax", sms.stablemax_sampling, (z,))):
            c1, t1 = fn(*x, seed=s_int, **kw)
            c2, t2 = fn(*x, seed=s_dev, **kw)
            require(torch.equal(t1, t2) and torch.equal(c1, c2),
                    f"{what} {fmt} T=0.8: a device seed differs from the "
                    f"int seed")
    log("seed from device memory (tick_seed of a device tick counter): "
        "fused head and stablemax at T=0.8 equal the int seed's tokens and "
        "conf bit for bit in every fmt")


def check_exp2() -> None:
    """Which integers e in [-127, 127] torch.exp2 maps exactly to 2^e on the
    card (2^e built on the host; torch.ldexp beside it).  The kernels
    multiply by the exact inverse 2^-e only where exp2f, which torch.exp2
    calls, gives 2^e, and divide elsewhere; on the H100 that is e = -127,
    whose 2^e is subnormal.  Fails if exp2 misses a normal power of two."""
    import numpy as np
    e = np.arange(-127, 128)
    exact = torch.from_numpy(np.ldexp(np.float32(1), e).astype(np.float32))
    et = torch.from_numpy(e.astype(np.float32)).to(DEVICE)
    got = torch.exp2(et).cpu()
    ld = torch.ldexp(torch.ones_like(et), et).cpu()
    off = (got.view(torch.int32) != exact.view(torch.int32)).numpy()
    log(f"exp2 exactness: torch.exp2 differs from 2^e at e in "
        f"{e[off].tolist()} (there {got[off].tolist()} for "
        f"{exact[off].tolist()}); torch.ldexp(1, e) at "
        f"{e[(ld.view(torch.int32) != exact.view(torch.int32)).numpy()].tolist()}")
    require(bool((e[off] < -126).all()),
            f"torch.exp2 misses a normal power of two at e in "
            f"{e[off & (e >= -126)].tolist()}")


def baos_edge_blocks(gen, B, S, H, D, dtype):
    """x (B, S, H, D) of dtype whose 32-blocks along D are, in turn, all
    zero, at the top exponent (amax 3.385e38: e = 128 clips to 127 for the
    integer formats), at the bottom (amax <= 1.3e-39, subnormal values: e
    clips to -127), and ordinary; with identity calibration the smoothed
    values are x itself."""
    shape = (B, S, H, D // 32, 32)
    x = torch.randn(*shape, generator=gen, device=DEVICE)
    sign = torch.where(torch.rand(*shape, generator=gen, device=DEVICE)
                       < 0.5, -1.0, 1.0)
    top = sign * 3.385e38 * (0.5 + 0.5 * torch.rand(
        *shape, generator=gen, device=DEVICE))
    top[..., 0] = 3.385e38
    kinds = (torch.arange(D // 32, device=DEVICE) % 4)[:, None]
    x = torch.where(kinds == 0, 0.0, x)
    x = torch.where(kinds == 1, top, x)
    x = torch.where(kinds == 2, x.clamp(-1, 1) * 1.3e-39, x)
    return x.reshape(B, S, H, D).to(dtype)


def check_baos(gen) -> dict:
    """baos_mx_quant bit for bit against the plain version in each KV
    format (every format of core/mx: mxint4, mxint8, mxfp8_e4m3,
    mxfp6_e3m2, mxfp4_e2m1, bf16 and none, each timed): at the warm tick's
    shape, K of (4, 96, 32, 128) bf16 (G = 4 * 32
    channel groups) with per-channel offsets and spreads and its minmax
    calibration, on the bf16 and f32 routes; blocks of zeros and at both
    exponent extremes; D 32 with a ragged row run; recurrentgemma-2b's one
    KV head of D 256 at (4, 96) (timed) and (16, 384); a slice of a
    longer cache at odd B and S offsets; and x and out at addresses that
    are not 16-byte aligned (the scalar route)."""
    from repro_torch.core import baos
    from repro_torch.kernels import baos_mx_quant as bq
    check_exp2()
    B, S, H, D = 4, 96, 32, 128
    x = (torch.randn(B, S, H, D, generator=gen, device=DEVICE)
         * (torch.rand(1, 1, H, D, generator=gen, device=DEVICE) * 8 + 0.2)
         + torch.randn(1, 1, H, D, generator=gen, device=DEVICE) * 3
         ).bfloat16()
    cal = baos.calibrate(x, x, baos.BAOSConfig())
    c, f = cal.k_center, cal.k_scale

    def same(xx, cc, ff, what, out=None):
        for fmt in baos.KV_FORMATS:
            got = bq.baos_mx_quant(xx, cc, ff, fmt, out=out)
            want = bq.baos_mx_quant_plain(xx, cc, ff, fmt)
            n_bad = int((got != want).sum())
            log(f"baos_mx_quant {fmt} {what}: {n_bad} of {got.numel()} "
                f"values differ from plain")
            require(n_bad == 0, f"baos_mx_quant {fmt} {what} differs from "
                                f"plain")

    same(x, c, f, "(4, 96, 32, 128) bf16")
    same(x.float(), c, f, "(4, 96, 32, 128) f32")
    for dtype in (torch.bfloat16, torch.float32):
        xe = baos_edge_blocks(gen, 2, 10, 4, 128, dtype)
        ident = baos.identity_calib(2, 4, 128, DEVICE)
        same(xe, ident.k_center, ident.k_scale,
             f"(2, 10, 4, 128) {dtype} zero / top / bottom / ordinary blocks")
    x32 = torch.randn(3, 50, 8, 32, generator=gen, device=DEVICE) * 4
    cal32 = baos.calibrate(x32, x32, baos.BAOSConfig())
    same(x32.bfloat16(), cal32.k_center, cal32.k_scale, "(3, 50, 8, 32) bf16")
    # recurrentgemma-2b's K/V (one KV head of D 256) at the engine's warm
    # tick and at Table 6's
    for shape in ((4, 96, 1, 256), (16, 384, 1, 256)):
        xr = (torch.randn(*shape, generator=gen, device=DEVICE)
              * (torch.rand(1, 1, 1, 256, generator=gen, device=DEVICE) * 8
                 + 0.2)
              + torch.randn(1, 1, 1, 256, generator=gen, device=DEVICE) * 3
              ).bfloat16()
        calr = baos.calibrate(xr, xr, baos.BAOSConfig())
        same(xr, calr.k_center, calr.k_scale, f"{shape} bf16")
        if shape[0] == 4:
            args = (xr, calr.k_center, calr.k_scale, "mxint4")
            rb_ms, rb_by = bound(2 * xr.numel() * 2 + 2 * 256 * 4 * 4,
                                 5.0 * xr.numel(), F32_FLOPS)
            r_dev = device_ms(lambda: bq.baos_mx_quant(*args), 50)
            r_ms = time_ms(lambda: bq.baos_mx_quant(*args), 200)
            r_plain = time_ms(lambda: bq.baos_mx_quant_plain(*args), 20)
            log(f"baos_mx_quant mxint4 {shape} bf16 (recurrentgemma-2b's "
                f"warm tick): device time (profiler) {r_dev:.4f} ms per "
                f"call, CUDA events {r_ms:.4f} ms, plain {r_plain:.4f} ms, "
                f"bound {rb_ms:.4f} ms ({rb_by})")
    cache = torch.zeros(B + 2, 2 * S + 3, H, D, dtype=torch.bfloat16,
                        device=DEVICE)
    for fmt in baos.KV_FORMATS:
        cache.zero_()
        bq.baos_mx_quant(x, c, f, fmt, out=cache[1:1 + B, 41:41 + S])
        seg = cache[1:1 + B, 41:41 + S]
        rest = cache.clone()
        rest[1:1 + B, 41:41 + S] = 0
        require(torch.equal(seg, bq.baos_mx_quant_plain(x, c, f, fmt))
                and not bool(rest.any()),
                f"baos_mx_quant {fmt} into a cache slice at B offset 1, S "
                f"offset 41 differs from plain")
    log("baos_mx_quant into a cache slice at B offset 1, S offset 41: equal "
        "to plain in each KV format, nothing else written")
    buf = torch.empty(2 * x.numel() + 1, dtype=torch.bfloat16, device=DEVICE)
    xu = buf[1:1 + x.numel()].view(x.shape)
    xu.copy_(x)
    ou = buf[x.numel() + 1:].view(x.shape)
    same(xu, c, f, "(4, 96, 32, 128) bf16, x and out not 16-byte aligned",
         out=ou)
    b_ms, b_by = bound(2 * x.numel() * 2 + 2 * c.numel() * 4,
                       5.0 * x.numel(), F32_FLOPS)
    by_fmt = {}
    for fmt in baos.KV_FORMATS:
        by_fmt[fmt] = dict(
            device_ms=device_ms(lambda: bq.baos_mx_quant(x, c, f, fmt), 50),
            ms=time_ms(lambda: bq.baos_mx_quant(x, c, f, fmt), 200),
            plain_ms=time_ms(lambda: bq.baos_mx_quant_plain(x, c, f, fmt),
                             20))
        log(f"baos_mx_quant {fmt} (4, 96, 32, 128) bf16: device time "
            f"(profiler) {by_fmt[fmt]['device_ms']:.4f} ms per call, "
            f"CUDA events {by_fmt[fmt]['ms']:.4f} ms, plain "
            f"{by_fmt[fmt]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
    main = by_fmt["mxint4"]
    return dict(
        max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        ms_by_fmt={k: v["ms"] for k, v in by_fmt.items()},
        plain_ms_by_fmt={k: v["plain_ms"] for k, v in by_fmt.items()})


def check_stablemax_case(z, fmt, temperature, mid, what):
    """stablemax_sampling vs its plain version on logits z: tokens equal
    except at near-ties (at most 1% of rows), conf within 1e-2 relative.
    Returns the max abs conf error on agreeing rows."""
    from repro_torch.kernels import stablemax_sampling as sms
    R = z.shape[0]
    kw = dict(fmt=fmt, suppress_id=mid, temperature=temperature, seed=4321)
    conf_k, tok_k = sms.stablemax_sampling(z, **kw)
    conf_p, tok_p = sms.stable_max_plain(
        z, fmt, temperature=temperature, seed=4321, suppress_id=mid)
    same = tok_k == tok_p
    diff_rows = torch.nonzero(~same).flatten().tolist()
    if diff_rows:
        zq = quantized_f32(z[diff_rows], fmt, mid)
        require(all(near_ties(zq, tok_k[diff_rows], temperature, 4321,
                              diff_rows)),
                f"stablemax {what} {fmt} T={temperature}: tokens differ off "
                f"a near-tie in rows {diff_rows}")
    err = (conf_k - conf_p).abs()[same]
    rel = err / conf_p.abs()[same]
    log(f"stablemax_sampling {what} {fmt} T={temperature}: rows differing "
        f"{len(diff_rows)}/{R}, conf max abs err {float(err.max()):.3g}, "
        f"max rel {float(rel.max()):.3g}")
    require(bool((rel <= 1e-2).all()),
            f"stablemax {what} {fmt} T={temperature}: conf rel err "
            f"{float(rel.max()):.3g} > 1e-2")
    require(len(diff_rows) <= 0.01 * R,
            f"stablemax {what} {fmt} T={temperature}: {len(diff_rows)} rows "
            f"differ (> 1%)")
    return float(err.max())


def check_stablemax(gen) -> dict:
    """stablemax_sampling at the unfused tick's shape, R = 64 rows of
    llada-8b logits (V = 126464, made by the head from random hidden
    states), bf16 and f32; and (3, 1003) bf16, whose rows are not 16-byte
    aligned and whose last MX block is ragged (the scalar route), with an
    exact tie across the first vocab-range boundary and a larger suppressed
    logit just past it; fmt none, bf16 and mxfp8, greedy and T = 0.8."""
    from repro_torch.core import sampling
    from repro_torch.kernels import _build
    from repro_torch.kernels import stablemax_sampling as sms
    R, d, V, mid = 64, LLADA["d"], LLADA["V"], LLADA["mask_id"]
    h = torch.randn(R, d, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn(d, V, generator=gen, device=DEVICE)
         * (2.0 / (d + V)) ** 0.5 * 8).to(torch.bfloat16)
    z = sampling.head_logits(h, w)
    del w
    zs = torch.randn(3, 1003, generator=gen, device=DEVICE) * 3
    edge, _ = sms.vocab_plan(1003, 3, _build.sm_count(zs.device))
    zs[:, edge - 1] = zs[:, edge] = 20.0
    zs[:, edge + 3] = 30.0
    zs[1, 1002] = 25.0
    cases = ((z, mid, f"({R}, {V}) bf16"),
             (z.float(), mid, f"({R}, {V}) f32"),
             (zs.bfloat16(), edge + 3, f"(3, 1003) bf16, tie at columns "
                                       f"{edge - 1}/{edge}"))
    for zz, sup, what in cases:
        for fmt in ALL_FMTS:
            for temperature in (0.0, 0.8):
                err = check_stablemax_case(zz, fmt, temperature, sup, what)
                if zz is z and fmt == "mxfp8_e4m3" and temperature == 0.0:
                    max_err = err
    kw = dict(fmt="mxfp8_e4m3", suppress_id=mid)
    b_ms, b_by = bound(z.numel() * 2 + R * 8, 4.0 * z.numel(), F32_FLOPS)
    per_kernel = device_ms_by_kernel(lambda: sms.stablemax_sampling(z, **kw),
                                     20)
    log(f"stablemax_sampling mxfp8 greedy device time (profiler) "
        f"{sum(per_kernel.values()):.4f} ms per call ("
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in per_kernel.items())
        + f"), bound {b_ms:.4f} ms; softmax + max "
        f"{device_ms(lambda: torch.max(torch.softmax(z, -1), -1), 20):.4f}"
        f" ms; plan {sms.vocab_plan(V, R, _build.sm_count(z.device))}")
    return dict(
        max_abs_err=max_err,
        ms=time_ms(lambda: sms.stablemax_sampling(z, **kw), 50),
        plain_ms=time_ms(lambda: sms.stable_max_plain(
            z, "mxfp8_e4m3", suppress_id=mid), 10),
        library_ms=time_ms(lambda: torch.max(torch.softmax(z, dim=-1),
                                             dim=-1), 50),
        bound_ms=b_ms, bound_by=b_by)


def check_sampling_formats(gen) -> dict:
    """Phase 10's kernel cases, run with phase 2: the fused head at
    (64, 4096, 126464) bf16 and stablemax_sampling at (64, 126464) bf16
    (logits the head makes) in each MX format the two kernels learnt with
    phase 10 (NEW_FMTS), greedy and T 0.8, against their plain versions
    (check_head, check_stablemax_case: tokens equal off near-ties, at most
    1% of rows, conf 1e-2), each timed greedy: device ms (kernel_ms, a
    graph of 20 calls), CUDA events back to back, the plain version's, the
    bound, and the library call's device ms (torch.matmul for the head,
    softmax + max for Stable-Max).  Returns {kernel: {fmt: row}}."""
    from repro_torch.core import sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    R, d, V, mid = 64, LLADA["d"], LLADA["V"], LLADA["mask_id"]
    w = random_head(LLADA, gen)
    h = torch.randn(R, d, generator=gen, device=DEVICE).to(torch.bfloat16)
    z = sampling.head_logits(h, w)
    hb_ms, hb_by = bound(R * d * 2 + d * V * 2 + R * 8, 2.0 * R * d * V,
                         BF16_FLOPS)
    zb_ms, zb_by = bound(z.numel() * 2 + R * 8, 4.0 * z.numel(), F32_FLOPS)
    head_lib = kernel_ms(lambda: torch.matmul(h, w), 20, "torch.matmul")
    sm_lib = kernel_ms(lambda: torch.max(torch.softmax(z, -1), -1), 20,
                       "softmax + max")
    out = {"fused_head_sampling": {}, "stablemax_sampling": {}}
    for fmt in NEW_FMTS:
        head_err, sm_err = [], []
        for temperature in (0.0, 0.8):
            nd, err = check_head(h, w, mid, fmt, temperature, 1234)
            require(nd <= 0.01 * R, f"fused head {fmt} T={temperature}: "
                                    f"{nd}/{R} rows differ (> 1%)")
            log(f"fused_head bf16 ({R}, {d}) @ ({d}, {V}) {fmt} "
                f"T={temperature}: rows differing {nd}/{R}, conf max abs "
                f"err {err:.3g}")
            head_err.append(err)
            sm_err.append(check_stablemax_case(z, fmt, temperature, mid,
                                               f"({R}, {V}) bf16"))
        kw = dict(fmt=fmt, suppress_id=mid)
        fh = lambda: fhs.fused_head_sampling(h, w, **kw)  # noqa: E731
        sm = lambda: sms.stablemax_sampling(z, **kw)  # noqa: E731
        rows = (
            ("fused_head_sampling", fh, lambda: fhs.fused_head_stable_max(
                h, w, fmt, suppress_id=mid), 3, max(head_err), hb_ms, hb_by,
             head_lib, "torch.matmul"),
            ("stablemax_sampling", sm, lambda: sms.stable_max_plain(
                z, fmt, suppress_id=mid), 10, max(sm_err), zb_ms, zb_by,
             sm_lib, "softmax + max"))
        for name, fn, plain, n_plain, err, b_ms, b_by, lib, lib_name in rows:
            row = dict(max_abs_err=err,
                       device_ms=kernel_ms(fn, 20, f"{name} {fmt}"),
                       ms=time_ms(fn, 20), plain_ms=time_ms(plain, n_plain),
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            out[name][fmt] = row
            log(f"{name} {fmt} greedy at the main shape: device "
                f"{row['device_ms']:.4f} ms (a graph of 20 calls), CUDA "
                f"events, back to back {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{row['device_ms'] / b_ms:.2f}x; {lib_name} device "
                f"{lib:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3: one-slot generate at full size, sampling held against plain
# ---------------------------------------------------------------------------

def check_sampling(hid, w, fmt, mid, m_idx, k, totals, logit_scale=1.0):
    """The fused head on one step's active-block hidden states (L, d)
    against its plain version; ``totals`` counts sampled tokens, those
    differing and the near-ties among them.  Returns (conf, tokens)."""
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import topk_mask as tk
    conf_k, tok_k = fhs.fused_head_sampling(hid, w, fmt=fmt, suppress_id=mid,
                                            logit_scale=logit_scale)
    conf_p, tok_p = fhs.fused_head_stable_max(hid, w, fmt, suppress_id=mid,
                                              logit_scale=logit_scale)
    diff = torch.nonzero((tok_k != tok_p) & m_idx[0]).flatten()
    totals[0] += int(m_idx.sum())
    totals[1] += len(diff)
    if len(diff):
        z = head_logits_f32(hid[diff], w, fmt, mid, logit_scale)
        totals[2] += sum(near_ties(z, tok_k[diff], 0.0, 0, diff.tolist()))
    tr_k = tk.topk_mask(conf_k[None], m_idx, k)
    require(torch.equal(tr_k, tk.topk_mask_plain(conf_k[None], m_idx, k)),
            "e2e: top-k transfer mask differs from plain")
    return tr_k, tok_k


def check_sampling_logits(z, fmt, mid, m_idx, k, totals):
    """stablemax_sampling on one step's active-block logits (L, V) (the
    legacy head of a model without head_mode) against its plain version;
    ``totals`` as in check_sampling.  Returns (transfer, tokens)."""
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.kernels import topk_mask as tk
    conf_k, tok_k = sms.stablemax_sampling(z, fmt=fmt, suppress_id=mid)
    _, tok_p = sms.stable_max_plain(z, fmt, suppress_id=mid)
    diff = torch.nonzero((tok_k != tok_p) & m_idx[0]).flatten()
    totals[0] += int(m_idx.sum())
    totals[1] += len(diff)
    if len(diff):
        zq = quantized_f32(z[diff], fmt, mid)
        totals[2] += sum(near_ties(zq, tok_k[diff], 0.0, 0, diff.tolist()))
    tr_k = tk.topk_mask(conf_k[None], m_idx, k)
    require(torch.equal(tr_k, tk.topk_mask_plain(conf_k[None], m_idx, k)),
            "e2e: top-k transfer mask differs from plain")
    return tr_k, tok_k


def check_step_sampling(model, params, feats, dcfg, m_idx, k, totals):
    """One step's sampling on its active-block feats against plain: the
    fused head on hidden states (L, d), or for a model without head_mode
    Stable-Max on its logits (L, V)."""
    from repro_torch.core import diffusion
    cfg = model.cfg
    if diffusion.head_feed_mode(model, dcfg) == "logits":
        return check_sampling_logits(feats, dcfg.sampling.fmt, cfg.mask_id,
                                     m_idx, k, totals)
    return check_sampling(feats, params["lm_head"], dcfg.sampling.fmt,
                          cfg.mask_id, m_idx, k, totals, cfg.logit_scale)


def phase_e2e(model, params, gen, fwd_kw=None, prompt_len: int = 16,
              gen_len: int = 32) -> None:
    """One-slot generate in mode none, stepped through tick_forward and
    tick_sample with each step's sampling held against plain; then
    generate(megatick_k=4), equal to it, or with forward kwargs
    (``fwd_kw``: cross_kv, image_embeds of batch 1) its refusal."""
    from repro_torch.core import diffusion
    cfg = model.cfg
    fwd_kw = fwd_kw or {}
    dcfg = diffusion.DiffusionConfig(gen_length=gen_len, block_length=16,
                                     steps_per_block=8)
    prompt = torch.randint(0, cfg.vocab - 200, (1, prompt_len),
                           generator=gen, device=DEVICE)
    state = diffusion.init_state(model, prompt, dcfg, seed=7)
    L, mid = dcfg.block_length, cfg.mask_id
    totals = [0, 0, 0]
    t0 = time.perf_counter()
    while not state.done:
        x, bs = state.x, state.block_start
        feats, _ = diffusion.tick_forward(model, params, x, None, None, None,
                                          dcfg, **fwd_kw)
        k = state.ks[:, state.step_in_block].to(DEVICE)
        tr_k, tok_k = check_step_sampling(model, params, feats[0, bs:bs + L],
                                          dcfg, x[:, bs:bs + L] == mid, k,
                                          totals)
        x_new, _, _ = diffusion.tick_sample(
            params, feats, x, torch.tensor([bs], device=DEVICE), k,
            diffusion.tick_seed(state.seed, state.ticks), dcfg, mid, model)
        require(torch.equal(x_new[0, bs:bs + L][tr_k[0]], tok_k[tr_k[0]]),
                "e2e: tick_sample committed other tokens than sampled")
        state = diffusion.advance(state, x_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(not bool((state.x == mid).any()), "e2e: mask ids left")
    log(f"e2e {cfg.name} generate mode none (1 x {state.x.shape[1]}, "
        f"{state.ticks} ticks, {dt:.3f} s): sampled tokens differing from "
        f"plain {totals[1]}/{totals[0]}, of which near-ties {totals[2]}")
    require(totals[1] == totals[2],
            "e2e: a sampled token differs off a near-tie")
    if fwd_kw:
        try:
            diffusion.generate(model, params, prompt, dcfg, seed=7,
                               megatick_k=4, **fwd_kw)
        except ValueError as e:
            log(f"e2e {cfg.name} generate(megatick_k=4) with "
                f"{sorted(fwd_kw)} refused, as in JAX: {e}")
            return
        raise Failure(f"e2e {cfg.name}: generate(megatick_k=4) took "
                      f"{sorted(fwd_kw)}")
    t0 = time.perf_counter()
    out = diffusion.generate(model, params, prompt, dcfg, seed=7,
                             megatick_k=4)
    torch.cuda.synchronize()
    log(f"e2e {cfg.name} generate mode none megatick_k=4 (graphed): "
        f"{time.perf_counter() - t0:.3f} s, tokens equal to the stepped "
        f"run: {bool(torch.equal(out, state.x))}")
    require(torch.equal(out, state.x),
            "e2e: generate(megatick_k=4) differs from the stepped run")


def stepped_run(model, params, prompt, dcfg, jit_steps, quant=None,
                seed=7):
    """One generation through step(), timed step by step (each step ends
    in a device sync): (tokens, per-step wall ms, total s, peak GiB, launch
    counts).  The graphed run decodes into its step entry's cache, as
    generate() does; the counts are zeroed just before the run."""
    from repro_torch.core import diffusion
    from repro_torch.kernels import _build
    B, P = prompt.shape
    cache = None
    if jit_steps and dcfg.cache_mode != "none":
        cache = diffusion.step_graphs(model, dcfg, model.cfg.mask_id, quant,
                                      B, P + dcfg.gen_length).cache
    state = diffusion.init_state(model, prompt, dcfg, seed=seed, cache=cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    walls = []
    t0 = time.perf_counter()
    while not state.done:
        t = time.perf_counter()
        state = diffusion.step(model, params, state, jit_steps=jit_steps,
                               quant=quant)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    total = time.perf_counter() - t0
    return (state.x, walls, total,
            torch.cuda.max_memory_allocated() / 2 ** 30,
            dict(_build.launch_counts))


def eager_vs_graphed(model, params, prompt, dcfg, what, expected,
                     quant=None, tps=None) -> dict:
    """``dcfg`` through step() eager (jit_steps=False) and graphed, then a
    second graphed call through generate() itself: equal tokens, no mask
    id left, each run launching exactly ``expected``, and the second
    graphed call capturing no graph.  Logs each run's step wall median and
    p84, tokens/s, peak memory, launches, the graphs captured and the
    memory their pools hold.  Returns the launch counts of the three
    runs, summed; each run's tokens/s goes into ``tps`` when given."""
    import numpy as np
    from repro_torch.core import diffusion
    from repro_torch.kernels import _build
    B, P = prompt.shape
    n_tok = B * dcfg.gen_length
    diffusion.clear_step_graphs()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    total_counts = {}
    outs = {}
    for jit_steps in (False, True):
        x, walls, secs, peak, counts = stepped_run(model, params, prompt,
                                                   dcfg, jit_steps, quant)
        name = "graphed K=1" if jit_steps else "eager K=1"
        p50, p84 = np.percentile(np.array(walls), [50, 84])
        extra = ""
        if jit_steps:
            g = diffusion.step_graphs(model, dcfg, model.cfg.mask_id, quant,
                                      B, P + dcfg.gen_length)
            cache_gib = sum(t.numel() * t.element_size()
                            for t in (g.cache or {}).values()) / 2 ** 30
            added = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
            extra = (f" (its first steps capture), {g.captures} graphs "
                     f"captured ({len(g._steps)} graphed steps); memory the "
                     f"step entry adds: {added:.2f} GiB reserved, of which "
                     f"its static cache {cache_gib:.2f} GiB and graph pools "
                     f"and buffers {added - cache_gib:.2f} GiB")
        log(f"{what} {name}: {len(walls)} steps, step wall ms median "
            f"{p50:.2f} p84 {p84:.2f}, {n_tok / secs:.1f} tokens/s "
            f"({secs:.3f} s), peak memory {peak:.2f} GiB, launches "
            f"{counts}{extra}")
        require(not bool((x == model.cfg.mask_id).any()),
                f"{what} {name}: mask ids left")
        expect_launches(counts, expected, f"{what} {name}")
        outs[name] = x
        if tps is not None:
            tps[name] = n_tok / secs
        for k, n in counts.items():
            total_counts[k] = total_counts.get(k, 0) + n
    require(torch.equal(outs["eager K=1"], outs["graphed K=1"]),
            f"{what}: graphed tokens differ from eager")
    g = diffusion.step_graphs(model, dcfg, model.cfg.mask_id, quant, B,
                              P + dcfg.gen_length)
    captures0 = g.captures
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = diffusion.generate(model, params, prompt, dcfg, seed=7,
                             jit_steps=True, quant=quant)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    log(f"{what} graphed K=1, second call through generate(): {secs:.3f} s, "
        f"{n_tok / secs:.1f} tokens/s, {g.captures - captures0} graphs "
        f"captured, tokens equal to eager: {bool(torch.equal(out, outs['eager K=1']))}")
    require(g.captures == captures0,
            f"{what}: the second graphed generate() captured "
            f"{g.captures - captures0} graphs")
    require(torch.equal(out, outs["eager K=1"]),
            f"{what}: the second graphed generate() differs from eager")
    if tps is not None:
        tps["graphed, second generate()"] = n_tok / secs
    for k, n in counts.items():
        total_counts[k] = total_counts.get(k, 0) + n
    return total_counts


# the paper's Table 6 H100 tokens/s (B 16, gen 256, block 64, 16 steps),
# by (arch, cache mode): benchmarks/table6_end2end.py:16-33
PAPER_H100_TPS = {("llada-8b", "none"): 126, ("llada-8b", "prefix"): 180,
                  ("llada-8b", "dual"): 500,
                  ("llada-moe-7b-a1b", "none"): 466,
                  ("llada-moe-7b-a1b", "prefix"): 656,
                  ("llada-moe-7b-a1b", "dual"): 1279}


def phase_table6(model, params, gen, with_quant: bool = True) -> dict:
    """The model at the paper's Table 6 shape (B 16, prompt 128, gen 256,
    block 64, 16 steps per block) in cache mode none, prefix + BAOS and
    dual + BAOS (mxint4 KV), eager K=1 against graphed K=1; then, with
    ``with_quant``, dual + BAOS at Table 6's operating point,
    QuantPolicy(enabled=True) (MXINT4 weights, MXINT8 activations) with
    bf16 sampling, whose sampling is also held against the plain functions
    on the same (fake-quantized) hidden states at a warm and a refine step,
    at the model's depth in DEPTH_CUTS.  Returns the launch counts of
    every run."""
    from repro_torch.core import baos, diffusion, sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.models import layers
    from repro_torch.models.registry import build_model
    cfg = model.cfg
    B, P = 16, 128
    prompt = torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                           device=DEVICE)
    shape = dict(gen_length=256, block_length=64, steps_per_block=16)
    kv = baos.BAOSConfig(enabled=True, kv_format="mxint4")
    total = {}
    runs = (("none", diffusion.DiffusionConfig(**shape), None),
            ("prefix + BAOS", diffusion.DiffusionConfig(
                cache_mode="prefix", baos=kv, **shape), None),
            ("dual + BAOS", diffusion.DiffusionConfig(
                cache_mode="dual", baos=kv, **shape), None),
            ("dual + BAOS + QuantPolicy, bf16 sampling",
             diffusion.DiffusionConfig(
                 cache_mode="dual", baos=kv,
                 sampling=sampling.SamplingConfig(fmt="bf16"), **shape),
             layers.QuantPolicy(enabled=True)))
    for name, dcfg, quant in runs[:None if with_quant else -1]:
        if quant is not None and cfg.name in DEPTH_CUTS:
            cfg = cut_depth(cfg, DEPTH_CUTS[cfg.name])
            model = build_model(cfg, DEVICE)
            params = dict(params, layers=params["layers"][:cfg.n_layers])
        expected = path_kernels(model, dcfg, dcfg.cache_mode != "none")
        tps = {}
        counts = eager_vs_graphed(model, params, prompt, dcfg,
                                  f"table6 {cfg.name} ({cfg.n_layers} "
                                  f"layers, B {B}, prompt {P}, gen 256, "
                                  f"block 64, 16 steps) {name}",
                                  expected, quant, tps)
        if quant is None:
            profile_steps(model, params, prompt, dcfg,
                          f"table6 {cfg.name} {name}")
        paper = PAPER_H100_TPS.get((cfg.name, dcfg.cache_mode))
        if quant is None and paper is not None:
            log(f"table6 {cfg.name} {name}: tokens/s "
                + ", ".join(f"{k} {v:.1f}" for k, v in tps.items())
                + f"; the paper's H100 row for mode {dcfg.cache_mode}: "
                f"{paper} (its number, not the port's)")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    if not with_quant:
        diffusion.clear_step_graphs()
        return total
    # the quantized run's sampling against plain on the same hidden states
    dcfg, quant = runs[-1][1:]
    state = diffusion.init_state(model, prompt[:4], dcfg, seed=7)
    L, mid, V = dcfg.block_length, cfg.mask_id, cfg.vocab
    w = quant.weights(fhs.head_storage(params["lm_head"]))[:, :V]
    totals = [0, 0, 0]
    for _ in range(2):                  # the warm step, then a refine step
        feats = diffusion.step_forward(model, params, state, quant)
        bs = state.block_start
        hq = quant.acts(feats)
        for r in range(feats.shape[0]):
            m_idx = state.x[r:r + 1, bs:bs + L] == mid
            k = state.ks[r:r + 1, state.step_in_block].to(DEVICE)
            check_sampling(hq[r], w, "bf16", mid, m_idx, k, totals)
        state = diffusion.advance(state, diffusion.commit_block(
            model, params, state, feats, quant))
    log(f"table6 QuantPolicy sampling (warm and refine step, 4 rows): "
        f"sampled tokens differing from plain {totals[1]}/{totals[0]}, of "
        f"which near-ties {totals[2]}")
    require(totals[1] == totals[2],
            "table6 QuantPolicy: a sampled token differs off a near-tie")
    diffusion.clear_step_graphs()
    return total


# depth cuts that keep the whole script inside its time limit: llada-8b's
# QuantPolicy Table 6 run (~75 s at full depth; its other runs stay at
# full depth), moonshot-v1-16b-a3b and llada-moe-7b-a1b in phase 7,
# internvl2-26b and whisper-medium's decoder in phase 9, recurrentgemma-2b
# (2 triples + the 2-layer tail) and mamba2-130m in phase 8.  With phase 11
# the script took 994.8 s, then 1,229.5 s on a slower host (the host-bound
# eager paths ran 1.2-1.9x longer), before the last four cuts.  With
# phase 14 (four ranks, ~80 s) and 13c's tensor-parallel steps (~20 s) it
# took 1,162.1 s, so every cut here was cut again (recurrentgemma-2b: one
# triple + the 2-layer tail; whisper-medium's encoder keeps its 24).  With
# phase 14's recurrent families and phase 12b's paged runs it took 975.5 s
# on the H100 (80 GB HBM3, 700 W) of the 1,000 s it aims at, so
# llada-moe-7b-a1b went from 4 to 2 layers and whisper-medium's decoder
# from 6 to 4 (and PHASE12B_LAYERS from 8 to 4).  With the sampled decode
# checks, phase 12d and the analysis checks it took 1,047.8 s on a host
# whose unchanged phases ran 1.2-1.4x longer than before, so llada-8b's
# QuantPolicy run went from 8 to 4 layers, moonshot-v1-16b-a3b from 12 to
# 6, internvl2-26b from 6 to 4 and mamba2-130m from 4 to 2
# (recurrentgemma-2b stays at its least depth, 3k + 2 layers for k = 1).
DEPTH_CUTS = {"llada-8b": 4, "moonshot-v1-16b-a3b": 6,
              "internvl2-26b": 4, "llada-moe-7b-a1b": 2,
              "whisper-medium": 4, "recurrentgemma-2b": 5,
              "mamba2-130m": 2}


def cut_depth(cfg, n_layers: int, why: str = "for the script's time limit"):
    """``cfg`` with its first ``n_layers`` layers (the cut logged), or
    ``cfg`` itself when it has no more."""
    if n_layers >= cfg.n_layers:
        return cfg
    log(f"{cfg.name}: depth cut from {cfg.n_layers} to {n_layers} layers "
        f"{why}")
    return dataclasses.replace(cfg, n_layers=n_layers)


DENSE_CONFIGS = ("llama3.2-3b", "minicpm-2b", "codeqwen1.5-7b")
# room left beside a model's weights for its runs (cache, activations,
# graph pools) before its depth is cut
HEADROOM_GIB = 12.0


def profile_steps(model, params, prompt, dcfg, name, n: int = 16) -> None:
    """profile_ticks over n graphed step() calls from a fresh state (the
    step graphs already captured): in a cached mode one block's worth, a
    warm step and refine steps; the GEMM rate only in mode none, where
    every step is the same forward."""
    from repro_torch.core import diffusion
    B, P = prompt.shape
    cache = None
    if dcfg.cache_mode != "none":
        cache = diffusion.step_graphs(model, dcfg, model.cfg.mask_id, None,
                                      B, P + dcfg.gen_length).cache
    box = [diffusion.init_state(model, prompt, dcfg, seed=7, cache=cache)]

    def step():
        box[0] = diffusion.step(model, params, box[0])

    flops = (forward_gemm_flops(model.cfg, B, P + dcfg.gen_length)
             if dcfg.cache_mode == "none" else None)
    profile_ticks(step, name, flops, n)


def phase_configs(gen, archs=DENSE_CONFIGS) -> dict:
    """Further configs ``archs`` at full width with seeded random weights,
    one model at a time (each freed before the next): llama3.2-3b through
    generate() in cache mode none with a block of 128 (topk_mask's CTA
    route on the path), B 4, prompt 64, gen 256, eager against graphed;
    the others through the engine on path warm, eager K=1 against graphed
    K=1 (tokens, CommitEvents, launch counts): minicpm-2b (V 122753: the
    fused head's padded bf16 route on the path), codeqwen1.5-7b (QKV bias,
    full MHA, V 92416), and the MoE configs qwen2-moe-a2.7b (60 experts
    top-4, 4 shared, QKV bias, V 151936) and moonshot-v1-16b-a3b (64
    top-6, 2 shared, V 163840); minicpm-2b's and the MoE configs' sampling
    held tick by tick against the plain version at the engine's rows.  A
    model whose weights leave less than HEADROOM_GIB of the card free runs
    at the depth that leaves it (logged).  Returns the launch counts of
    every run."""
    import gc
    import numpy as np
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.kernels import topk_mask as tk
    from repro_torch.models.registry import build_model
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    common = ("flash_bidir", "fused_head_sampling", "topk_mask")
    for arch in archs:
        cfg = base.get_config(arch)
        cfg = fit_depth(cut_depth(cfg, DEPTH_CUTS.get(arch, cfg.n_layers)))
        model = build_model(cfg, DEVICE)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        torch.cuda.synchronize()
        w = params["lm_head"]
        log(f"{arch} params: {cfg.param_count() / 1e9:.2f} B, init "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB; LM head "
            f"{tuple(w.shape)} stored with row stride {w.stride(0)}")
        if arch == "llama3.2-3b":
            dcfg = diffusion.DiffusionConfig(gen_length=256, block_length=128,
                                             steps_per_block=16)
            require(tk.route(dcfg.block_length) == "cta",
                    "llama3.2-3b block 128 does not take the CTA route")
            prompt = torch.randint(0, cfg.vocab - 200, (4, 64),
                                   generator=gen, device=DEVICE)
            add(eager_vs_graphed(
                model, params, prompt, dcfg, "llama3.2-3b generate none "
                "(B 4, prompt 64, gen 256, block 128, 16 steps)", common))
        else:
            dcfg = diffusion.DiffusionConfig(block_length=16,
                                             steps_per_block=8)
            rs = np.random.RandomState(1)
            trace = [(rs.randint(0, cfg.vocab - 200,
                                 size=(rs.randint(16, 33),)).astype(np.int32),
                      int(rs.choice([32, 48, 64]))) for _ in range(8)]
            runs = {}
            for vname, vcfg in VARIANTS[:2]:
                eng, keys, tick_ms, counts, _ = engine_run(
                    model, params, dcfg, "warm", trace, True, **vcfg)
                p50, p84 = np.percentile(np.array(tick_ms), [50, 84])
                s = eng.metrics.summary()
                what = f"{arch} engine warm {vname}"
                log(f"{what}: {len(eng.completed)} requests, "
                    f"{eng.ticks_total} ticks, tick wall ms median "
                    f"{p50:.2f} p84 {p84:.2f}, {s['tokens_per_s']:.1f} "
                    f"tokens/s, max memory "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                    f"launches {counts}")
                require(len(eng.completed) == len(trace),
                        f"{what}: requests missing")
                for c in eng.completed:
                    require(not bool((c.tokens == cfg.mask_id).any()),
                            f"{what}: request {c.uid} left mask ids")
                expect_launches(counts, common, what)
                runs[vname] = dict(
                    tokens={c.uid: c.tokens.tolist() for c in eng.completed},
                    events=keys, counts=counts, ticks=eng.ticks_total)
                add(counts)
                del eng
            ref, got = runs["eager K=1"], runs["graphed K=1"]
            for key in ("tokens", "events", "counts", "ticks"):
                require(got[key] == ref[key],
                        f"{arch} engine warm graphed K=1: {key} differ from "
                        f"eager K=1")
            log(f"{arch} engine warm: graphed K=1 equals eager K=1 in tokens, "
                f"{len(ref['events'])} CommitEvents, {ref['ticks']} ticks "
                f"and launch counts")
            if arch == "minicpm-2b" or cfg.family == "moe":
                check_ticks_sampling(model, params, gen)
        del model, params, w
        diffusion.clear_step_graphs()
        gc.collect()
        torch.cuda.empty_cache()
    return total


def fit_depth(cfg):
    """``cfg``, or with fewer layers if its bf16 weights would leave less
    than HEADROOM_GIB of the card free (the cut is logged)."""
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    per_layer = (cfg.param_count() - 2 * cfg.vocab * cfg.d_model) \
        / cfg.n_layers * 2 / 2 ** 30
    fixed = 2 * cfg.vocab * cfg.d_model * 2 / 2 ** 30
    need = fixed + cfg.n_layers * per_layer + HEADROOM_GIB
    log(f"{cfg.name}: {cfg.param_count() * 2 / 2 ** 30:.2f} GiB of bf16 "
        f"weights, {free:.2f} GiB free on the card")
    if need <= free:
        return cfg
    depth = int((free - HEADROOM_GIB - fixed) // per_layer)
    require(depth >= 1, f"{cfg.name}: not one layer fits")
    return cut_depth(cfg, depth, f"to leave {HEADROOM_GIB} GiB free")


def check_ticks_sampling(model, params, gen, dcfg=None) -> None:
    """Each tick's sampling at the engine's rows (4 slots of 16 positions,
    mode none, full recompute) against the plain version on the same
    hidden states, with the model's logit_scale, in ``dcfg``'s sampling
    format, head path and strategy (default: mxfp8, fused, stablemax):
    the kernel call the tick makes (the fused head on the (64, d) block,
    or on the unfused head stablemax_sampling on its (64, V) logits)
    against its plain version, tokens equal off near-ties; then the tick's
    commit: its transfer must be the plain top-k of the tick's selection
    key (the kernel's conf, or under strategy 'random' the documented
    draw, sampling.random_select of the tick seed), and the committed
    tokens the sampled ones."""
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.kernels import topk_mask as tk
    cfg = model.cfg
    dcfg = dcfg or diffusion.DiffusionConfig(gen_length=32, block_length=16,
                                             steps_per_block=8)
    prompt = torch.randint(0, cfg.vocab - 200, (4, 24), generator=gen,
                           device=DEVICE)
    state = diffusion.init_state(model, prompt, dcfg, seed=7)
    L, mid, w = dcfg.block_length, cfg.mask_id, params["lm_head"]
    fmt, scale = dcfg.sampling.fmt, cfg.logit_scale
    head = diffusion.head_feed_mode(model, dcfg)
    B = prompt.shape[0]
    totals = [0, 0, 0]
    while not state.done:
        x, bs = state.x, state.block_start
        feats, _ = diffusion.tick_forward(model, params, x, None, None, None,
                                          dcfg)
        k = state.ks[:, state.step_in_block].to(DEVICE)
        seed = diffusion.tick_seed(state.seed, state.ticks)
        # the block gathered as tick_sample gathers it: the same product
        rows = torch.arange(B, device=DEVICE)[:, None]
        hid = feats[rows, bs + torch.arange(L, device=DEVICE)]
        m_idx = x[:, bs:bs + L] == mid
        if head == "fused":
            h2 = hid.reshape(B * L, -1)
            conf_k, tok_k = fhs.fused_head_sampling(
                h2, w, fmt=fmt, suppress_id=mid, logit_scale=scale)
            _, tok_p = fhs.fused_head_stable_max(
                h2, w, fmt, suppress_id=mid, logit_scale=scale)
        else:
            h2 = None
            z = sampling.head_logits(hid, w, logit_scale=scale)
            z = z.reshape(B * L, -1)
            conf_k, tok_k = sms.stablemax_sampling(z, fmt=fmt,
                                                   suppress_id=mid)
            _, tok_p = sms.stable_max_plain(z, fmt, suppress_id=mid)
        diff = torch.nonzero((tok_k != tok_p) & m_idx.reshape(-1)).flatten()
        totals[0] += int(m_idx.sum())
        totals[1] += len(diff)
        if len(diff):
            zq = (head_logits_f32(h2[diff], w, fmt, mid, scale)
                  if h2 is not None else quantized_f32(z[diff], fmt, mid))
            totals[2] += sum(near_ties(zq, tok_k[diff], 0.0, 0,
                                       diff.tolist()))
        select = conf_k.reshape(B, L)
        if dcfg.sampling.strategy == "random":
            select = sampling.random_select(seed, (B, L), DEVICE)
        want = tk.topk_mask_plain(select, m_idx, k)
        x_new, _, _ = diffusion.tick_sample(
            params, feats, x, torch.full((B,), bs, device=DEVICE), k, seed,
            dcfg, mid, model)
        new = x_new[:, bs:bs + L]
        require(torch.equal(new != x[:, bs:bs + L], want),
                f"{cfg.name} {fmt} {head} {dcfg.sampling.strategy}: the "
                f"tick's transfer differs from the plain top-k of its key")
        require(torch.equal(new[want], tok_k.reshape(B, L)[want]),
                f"{cfg.name}: tick_sample committed other tokens than "
                f"sampled")
        state = diffusion.advance(state, x_new)
    require(not bool((state.x == mid).any()), f"{cfg.name}: mask ids left")
    log(f"{cfg.name} ticks at 4 x 16 rows (V {cfg.vocab}, logit_scale "
        f"{scale:.4f}, head row stride {w.stride(0)}, {head} head, {fmt}, "
        f"strategy {dcfg.sampling.strategy}): sampled tokens differing "
        f"from plain {totals[1]}/{totals[0]}, of which near-ties "
        f"{totals[2]}; every transfer the plain top-k of its key")
    require(totals[1] == totals[2],
            f"{cfg.name}: a sampled token differs off a near-tie")


def expect_launches(counts, expected, what):
    """Each kernel the path runs launched at least once, the others never."""
    for name, n in counts.items():
        if name in expected:
            require(n > 0, f"{what}: kernel {name} never launched")
        else:
            require(n == 0, f"{what}: kernel {name} launched {n} times on a "
                            f"path that does not run it")


def phase_cached(model, params, gen, cache_mode, fwd_kw=None,
                 prompt_len: int = 16, gen_len: int = 32) -> dict:
    """generate() in a cached mode with BAOS on (the tests/test_system.py
    setting: minmax, mxint4 KV, mxfp8 sampling), once through the entry
    point and once stepped with checks; the two must give the same
    tokens.  ``fwd_kw`` (batch 1) reaches every forward of both.  Returns
    the entry point's launch counts."""
    from repro_torch.core import baos, diffusion
    from repro_torch.kernels import _build
    from repro_torch.kernels import baos_mx_quant as bq
    cfg = model.cfg
    fwd_kw = fwd_kw or {}
    dcfg = diffusion.DiffusionConfig(
        gen_length=gen_len, block_length=16, steps_per_block=8,
        cache_mode=cache_mode,
        baos=baos.BAOSConfig(enabled=True, variant="minmax",
                             kv_format="mxint4"))
    prompt = torch.randint(0, cfg.vocab - 200, (1, prompt_len),
                           generator=gen, device=DEVICE)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = diffusion.generate(model, params, prompt, dcfg, seed=7, **fwd_kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    what = f"generate {cache_mode} + BAOS"
    expect_launches(counts, path_kernels(model, dcfg, True), what)
    require(not bool((out == cfg.mask_id).any()), f"{what}: mask ids left")

    state = diffusion.init_state(model, prompt, dcfg, seed=7)
    L, mid = dcfg.block_length, cfg.mask_id
    totals = [0, 0, 0]
    while not state.done:
        feats = diffusion.step_forward(model, params, state, **fwd_kw)
        if state.ticks == 0 and "k" in state.cache:
            # the first attention layer of the first warm step: its K/V
            # recomputed, their calibration and plain smooth_quantize vs
            # the cache
            k0, v0 = first_attn_kv(model, params, state.x,
                                   fwd_kw.get("image_embeds"))
            cal = baos.calibrate(k0, v0, dcfg.baos)
            c = state.cache
            require(all(torch.equal(c[n][0], t)
                        for n, t in zip(cal._fields, cal)),
                    f"{what}: first attention layer's calibration differs "
                    f"from plain")
            for name, x0, cn, sn in (("k", k0, "k_center", "k_scale"),
                                     ("v", v0, "v_center", "v_scale")):
                want = bq.baos_mx_quant_plain(x0, c[cn][0], c[sn][0],
                                              "mxint4")
                n_bad = int((c[name][0] != want).sum())
                log(f"{what}: warm step first attention layer's {name} "
                    f"cache {tuple(want.shape)} vs plain smooth_quantize: "
                    f"{n_bad} of {want.numel()} differ")
                require(n_bad == 0, f"{what}: first attention layer's "
                                    f"{name} cache differs")
        bs = state.block_start
        m_idx = state.x[:, bs:bs + L] == mid
        k = state.ks[:, state.step_in_block].to(DEVICE)
        tr_k, tok_k = check_step_sampling(model, params, feats[0], dcfg,
                                          m_idx, k, totals)
        x = diffusion.commit_block(model, params, state, feats)
        require(torch.equal(x[0, bs:bs + L][tr_k[0]], tok_k[tr_k[0]]),
                f"{what}: the commit differs from the sampled tokens")
        state = diffusion.advance(state, x)
    torch.cuda.synchronize()
    log(f"e2e {cfg.name} {what} (1 x {out.shape[1]}, {state.ticks} steps, "
        f"{dt:.3f} s through generate()): sampled tokens differing from "
        f"plain {totals[1]}/{totals[0]}, of which near-ties {totals[2]}; "
        f"launches {counts}")
    require(totals[1] == totals[2],
            f"{what}: a sampled token differs off a near-tie")
    require(torch.equal(state.x, out),
            f"{what}: the stepped run differs from generate()")
    return counts


def first_attn_kv(model, params, tokens, image_embeds=None):
    """K/V (B, S, Hkv, D) of the model's first attention layer (the
    hybrid's: triple 0's, after its two rec sub-layers), recomputed from
    ``tokens`` (the vlm's with ``image_embeds`` spliced) outside the
    forward at positions 0..S-1."""
    from repro_torch.models import transformer
    cfg = model.cfg
    x = (model.embed(params, tokens, image_embeds) if cfg.family == "vlm"
         else transformer.embed(params, cfg, tokens))
    if cfg.family == "hybrid":
        tp = params["triples"][0]
        for name in ("rec1", "rec2"):
            x = model._rec_sub(x, tp[name])[0]
        ln, w = tp["attn"]["ln1"], tp["attn"]["temporal"]
    else:
        w = params["layers"][0]
        ln = w["ln1"]
    h = transformer.apply_norm(x, ln, cfg)
    pos = torch.arange(tokens.shape[1], device=DEVICE)
    return transformer.qkv(h, w, cfg, pos)[1:]


# ---------------------------------------------------------------------------
# phase 4: the serving engine on each path
# ---------------------------------------------------------------------------

def path_kernels(model, dcfg, cached: bool) -> tuple:
    """The port kernels a forward + sampling of ``model`` under ``dcfg``
    launches: topk_mask; the fused head, or stablemax_sampling on the
    unfused head and for a model without head_mode (the legacy head);
    flash_bidir where the model attends (not the SSM); baos_mx_quant with
    BAOS on a KV cache (``cached``: engine mode warm, generate's modes
    dual and prefix; the SSM's state takes core/mx instead)."""
    from repro_torch.core import diffusion
    head = diffusion.head_feed_mode(model, dcfg)
    names = {"topk_mask", "fused_head_sampling" if head == "fused"
             else "stablemax_sampling"}
    if model.cfg.family != "ssm":
        names.add("flash_bidir")
        if cached and dcfg.baos.enabled:
            names.add("baos_mx_quant")
    return tuple(sorted(names))


def engine_paths(model):
    """(name, engine mode, DiffusionConfig, kernels the path runs): warm,
    none, warm+baos, and for a model with head_mode warm on the unfused
    head."""
    from repro_torch.core import baos, diffusion
    base = dict(block_length=16, steps_per_block=8)
    paths = [("warm", "warm", diffusion.DiffusionConfig(**base)),
             ("none", "none", diffusion.DiffusionConfig(**base)),
             ("warm+baos", "warm", diffusion.DiffusionConfig(
                 baos=baos.BAOSConfig(enabled=True, kv_format="mxint4"),
                 **base))]
    if model.supports_head_mode:
        paths.append(("warm-unfused", "warm", diffusion.DiffusionConfig(
            head_path="unfused", **base)))
    return [(name, mode, dcfg, path_kernels(model, dcfg, mode == "warm"))
            for name, mode, dcfg in paths]


VARIANTS = (("eager K=1", dict(jit_steps=False)),
            ("graphed K=1", dict(jit_steps=True)),
            ("graphed K=8", dict(jit_steps=True, megatick_k=8)))


def engine_trace(cfg):
    """The engine trace: 8 requests, prompts 16-32, generations 32-64."""
    import numpy as np
    rs = np.random.RandomState(0)
    return [(rs.randint(0, cfg.vocab - 200, size=(rs.randint(16, 33),))
             .astype(np.int32), int(rs.choice([32, 48, 64])))
            for _ in range(8)]


def graph_step(eng):
    """The engine's graphed step (its K=1 tick or its megatick's), or None
    when its ticks run eagerly."""
    from repro_torch.core import graphs
    step = (eng._tick_fn if eng._megatick_fn is None
            else eng._megatick_fn._step)
    return step if isinstance(step, graphs.GraphedStep) else None


# the graphs each graphed engine of phase 4 (and 4b) captured over its
# run, by kind, for the static-analysis gate's capture bound
# (``phase_analysis``)
ENGINE_CAPTURES = {}


def engine_run(model, params, dcfg, mode, trace, sinks, **cfg):
    """One engine over ``trace`` to the end: (engine, commit-event keys,
    wall ms of each denoising tick, launch counts of the run, graphs
    captured by warmup()).  A tick() call that ran n ticks (a megastep)
    gives each of them 1/n of its wall time.  The counts are zeroed after
    warmup, just before the run."""
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(model, params, dcfg,
                        EngineConfig(num_slots=4, max_seq_len=96, mode=mode,
                                     **cfg))
    eng.warmup()
    step = graph_step(eng)
    captures0 = 0 if step is None else step.captures
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    events = []
    for p, g in trace:
        eng.submit(Request(prompt=p, gen_length=g),
                   on_commit=events.append if sinks else None)
    tick_ms = []
    while eng.pending:
        t0, n0 = time.perf_counter(), eng.ticks_total
        eng.tick()                           # ends in a device sync
        n = eng.ticks_total - n0
        tick_ms += [(time.perf_counter() - t0) * 1e3 / n] * n
    torch.cuda.synchronize()
    if step is not None:       # ANL-RECAPTURE reads phase 4's captures
        kind = "tick" if eng._megatick_fn is None else "megatick"
        ENGINE_CAPTURES.setdefault(kind, []).append(step.captures)
    return (eng, event_keys(events), tick_ms, dict(_build.launch_counts),
            captures0)


def event_keys(events):
    """The CommitEvents' fields but ``now`` (wall clock)."""
    return [(e.uid, e.tick, e.block_idx, e.step_in_block, e.masks_left,
             e.done, e.positions.tolist(), e.tokens.tolist())
            for e in events]


def phase_engine(model, params, slowfast: bool = True, names=None,
                 variants=VARIANTS, extra=None):
    """Each path through the eager K=1 engine (as in earlier runs), the
    graphed K=1 engine and the graphed megatick (K=8), or ``variants``:
    each must finish every request with no mask id left and launch
    exactly its kernels; the graphed runs must give the eager run's
    tokens, per-request ticks, CommitEvents (a second run of each with
    streaming sinks) and ticks_total, and its launch counts (K=8: plus
    those of the ticks run after a stop); with ``slowfast``, path warm
    also on the SlowFast(0) trace.  ``extra``: EngineConfig fields of
    every run (``fwd_kw``).  Returns (launch counts, per path its runs,
    launches per tick and graphed device busy ms per tick)."""
    import numpy as np
    from repro_torch.kernels import _build
    cfg = model.cfg
    trace = engine_trace(cfg)
    launches = {name: 0 for name in _build.COUNTED}
    paths = {}
    variants = [(vname, {**vcfg, **(extra or {})})
                for vname, vcfg in variants]
    for name, mode, dcfg, expected in engine_paths(model):
        if names is not None and name not in names:
            continue
        runs, halves, stage = {}, None, None
        for vname, vcfg in variants:
            what = f"engine path={name} {vname}"
            eng, _, tick_ms, counts, _ = engine_run(
                model, params, dcfg, mode, trace, False, **vcfg)
            done = eng.completed
            s = eng.metrics.summary()
            p50, p84 = np.percentile(np.array(tick_ms), [50, 84])
            mt = eng._megatick_fn
            log(f"{what}: {len(done)} requests, {eng.ticks_total} ticks, "
                f"tick wall ms median {p50:.2f} p84 {p84:.2f}, "
                f"{s['tokens_per_s']:.1f} tokens/s, request latency median "
                f"{s['latency_p50_s']:.3f} s, max memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"host syncs per tick {eng.host_waits / eng.ticks_total:.3f}"
                f" (waits on a tick with one more in flight "
                f"{0 if mt is None else mt.event_waits / eng.ticks_total:.3f}"
                f"), host_syncs_elided {eng.host_syncs_elided}, ticks after "
                f"a stop {0 if mt is None else mt.ticks_wasted}, launches "
                f"{counts}")
            require(len(done) == len(trace), f"{what}: requests missing")
            for c in done:
                require(len(c.tokens) == c.prompt_len + c.gen_length and
                        not bool((c.tokens == cfg.mask_id).any()),
                        f"{what}: request {c.uid} left mask ids")
            expect_launches(counts, expected, what)
            step = graph_step(eng)
            if step is not None:             # graphed: every tick replayed
                require(step.replays >= eng.ticks_total,
                        f"{what}: {step.replays} graph replays for "
                        f"{eng.ticks_total} ticks")
            for kname, n in counts.items():
                launches[kname] += n
            _, keys, sink_ms, _, _ = engine_run(model, params, dcfg, mode,
                                                trace, True, **vcfg)
            runs[vname] = dict(
                tokens={c.uid: c.tokens.tolist() for c in done},
                ticks={c.uid: c.ticks for c in done}, events=keys,
                ticks_total=eng.ticks_total, counts=counts, p50=p50,
                sink_p50=float(np.median(sink_ms)),
                elided=eng.host_syncs_elided,
                wasted=0 if mt is None else mt.ticks_wasted)
            if vname == "eager K=1":
                halves = phase_tick_breakdown(eng, model, params, dcfg, name)
                if name == "warm":
                    stage = phase_sampling_stage(eng, model, params, dcfg)
            del eng
        ref = runs["eager K=1"]
        per_tick = {}
        for kname, n in ref["counts"].items():
            require(n % ref["ticks_total"] == 0,
                    f"engine {name}: {kname} launched {n} times in "
                    f"{ref['ticks_total']} ticks, not the same per tick")
            per_tick[kname] = n // ref["ticks_total"]
        for vname in list(runs)[1:]:
            run, what = runs[vname], f"engine path={name} {vname}"
            for key in ("tokens", "ticks", "events", "ticks_total"):
                require(run[key] == ref[key],
                        f"{what}: {key} differ from the eager K=1 run")
            want = {k: n + run["wasted"] * per_tick[k]
                    for k, n in ref["counts"].items()}
            require(run["counts"] == want,
                    f"{what}: launch counts {run['counts']} != eager "
                    f"{ref['counts']} + {run['wasted']} ticks after a stop")
        k8 = runs.get("graphed K=8")
        require(k8 is None or k8["elided"] > ref["elided"],
                f"engine {name}: the megatick elided no host sync")
        log(f"engine path={name}: {' and '.join(list(runs)[1:])} equal "
            f"eager K=1 in tokens, per-request ticks, "
            f"{len(ref['events'])} CommitEvents and ticks_total "
            f"({ref['ticks_total']}); launches per tick {per_tick}")
        busy = {}
        for vname, vcfg in variants[1:]:
            busy[vname] = profile_engine(model, params, dcfg, mode, trace,
                                         f"{name} {vname}", vcfg, per_tick)
        log(f"engine path={name}: device idle share of the unprofiled tick "
            f"wall median (1 - profiled busy / median): " + ", ".join(
                f"{v} {(1 - busy[v] / runs[v]['p50']) * 100:.1f}%"
                for v in busy))
        if k8 is not None:
            log(f"engine path={name} graphed K=8: {k8['wasted']} ticks ran "
                f"after a stop, {k8['wasted'] * busy['graphed K=1']:.3f} ms "
                f"of device time")
        if name == "warm" and slowfast:
            check_slowfast_megatick(model, params, dcfg, mode, trace,
                                    per_tick, busy["graphed K=1"])
        paths[name] = dict(runs=runs, per_tick=per_tick, busy=busy,
                           halves=halves, sampling_stage=stage)
    return launches, paths


def check_slowfast_megatick(model, params, dcfg, mode, trace, per_tick,
                            busy_ms) -> None:
    """SlowFast at threshold 0 (a block finishes the tick after its first
    commit) stops megasteps at releases that fall inside them, so ticks
    run after a stop: eager K=1, graphed K=1 and graphed K=8 must give the
    same tokens, ticks, early exits and CommitEvents, K=1 the eager run's
    launch counts and K=8 those plus the launches of its wasted ticks.
    Prints each run's tick wall and tokens/s: whether the megatick pays
    where stops fall inside megasteps."""
    import numpy as np
    from repro_torch.serving import SlowFastPolicy
    runs = {}
    for vname, vcfg in VARIANTS:
        eng, keys, tick_ms, counts, _ = engine_run(
            model, params, dcfg, mode, trace, True,
            policy=SlowFastPolicy(threshold=0.0), **vcfg)
        mt = eng._megatick_fn
        wasted = 0 if mt is None else mt.ticks_wasted
        p50, p84 = np.percentile(np.array(tick_ms), [50, 84])
        runs[vname] = dict(
            tokens=[c.tokens.tolist() for c in eng.completed],
            ticks_total=eng.ticks_total, exits=eng.policy.early_exits,
            events=keys, wasted=wasted, counts=counts)
        log(f"engine warm SlowFast(0) {vname}: {eng.ticks_total} ticks, "
            f"{eng.policy.early_exits} early exits, tick wall ms median "
            f"{p50:.2f} p84 {p84:.2f}, "
            f"{eng.metrics.summary()['tokens_per_s']:.1f} tokens/s, "
            f"{wasted} ticks after a stop"
            + ("" if mt is None else f" ({mt.ticks_run} enqueued), "
               f"{wasted * busy_ms:.3f} ms of device time"))
        del eng
    ref = runs["eager K=1"]
    for vname in ("graphed K=1", "graphed K=8"):
        run, what = runs[vname], f"engine warm SlowFast(0) {vname}"
        for key in ("tokens", "ticks_total", "exits", "events"):
            require(run[key] == ref[key],
                    f"{what}: {key} differ from eager K=1")
        want = {kn: n + run["wasted"] * per_tick[kn]
                for kn, n in ref["counts"].items()}
        require(run["counts"] == want,
                f"{what}: launch counts differ from eager K=1 plus the "
                f"ticks run after a stop")
    log(f"engine warm SlowFast(0): graphed K=1 and K=8 equal eager K=1 in "
        f"tokens, {len(ref['events'])} CommitEvents, {ref['ticks_total']} "
        f"ticks and {ref['exits']} early exits")


def profile_engine(model, params, dcfg, mode, trace, name, vcfg, per_tick,
                   n_ticks: int = 16) -> float:
    """torch.profiler over n_ticks denoising ticks of a graphed engine run
    (after 2 unprofiled ticks): wall and device busy per tick, the device's
    idle share, kernels per tick, and the device-time gap before each
    topk_mask launch (its start minus the end of the kernel before it).
    Each port kernel's launches inside the replayed graphs, as the profiler
    sees them on the card, must equal ``per_tick`` (the eager run's) times
    the graph replays, and the launch counts the replays added.  Returns
    the device busy ms per tick."""
    from torch.autograd import DeviceType
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(model, params, dcfg,
                        EngineConfig(num_slots=4, max_seq_len=96, mode=mode,
                                     **vcfg))
    eng.warmup()
    for p, g in trace:
        eng.submit(Request(prompt=p, gen_length=g))
    while eng.ticks_total < 2:
        eng.tick()
    torch.cuda.synchronize()
    n0 = eng.ticks_total
    step = graph_step(eng)
    replays0 = step.replays
    _build.reset_launch_counts()
    with profiled() as prof:
        t0 = time.perf_counter()
        while eng.ticks_total < n0 + n_ticks:
            eng.tick(max_ticks=n0 + n_ticks - eng.ticks_total)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n, replays = eng.ticks_total - n0, step.replays - replays0
    require(all(_build.launch_counts[r] == 0 for r in _build.ROUTES),
            f"profile {name}: a route launched without a mesh or a split "
            f"cache: {_build.launch_counts}")
    counted = {k: _build.launch_counts[k] for k in DEVICE_KERNEL}
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    seen = {k: sum(dev in kname for _, _, kname in kernels)
            for k, dev in DEVICE_KERNEL.items()}
    # the first device activity against the first graph launch on the host
    # (both on the profiler's clock): negative when the device's converted
    # timestamps run ahead of the host's
    launched = [e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CPU
                and e.name == "cudaGraphLaunch"]
    skew_ms = ((kernels[0][0] - min(launched)) / 1e3
               if kernels and launched else float("nan"))
    want = {k: per_tick[k] * replays for k in DEVICE_KERNEL}
    require(seen == want == counted,
            f"profile {name}: port kernels launched on the card in "
            f"{replays} graph replays {seen}, eager per tick x replays "
            f"{want}, counted by the replays {counted}; the first and last "
            f"device activities seen: "
            f"{[kname[:40] for _, _, kname in kernels[:3] + kernels[-6:]]}"
            f"; first device activity - first cudaGraphLaunch "
            f"{skew_ms:.3f} ms")
    busy_us = sum(end - start for start, end, _ in kernels)
    classes = {}
    for start, end, kname in kernels:
        cls = kernel_class(kname)
        classes[cls] = classes.get(cls, 0.0) + end - start
    gaps = [start - prev_end for (_, prev_end, _), (start, _, kname)
            in zip(kernels, kernels[1:]) if "topk_mask" in kname]
    # index_select, index_copy_ and advanced indexing (within "other"):
    # the paged tick's gathers and scatters add to these
    index_us = sum(end - start for start, end, kname in kernels
                   if "index" in kname.lower())
    log(f"profile path={name}, per tick over {n} ticks ({replays} graph "
        f"replays): wall {wall_us / n / 1e3:.3f} ms, device busy "
        f"{busy_us / n / 1e3:.3f} ms (idle "
        f"{max(0.0, 1 - busy_us / wall_us) * 100:.1f}%), "
        f"{len(kernels) / n:.0f} device activities per tick, port kernel "
        f"launches seen on the card {seen} (= eager per tick x replays); "
        f"gap before topk_mask mean {sum(gaps) / max(len(gaps), 1):.3f} us "
        f"over {len(gaps)} launches (min {min(gaps, default=0):.3f}, max "
        f"{max(gaps, default=0):.3f}); device ms per tick: "
        + ", ".join(f"{c} {us / n / 1e3:.4f}" for c, us in
                    sorted(classes.items(), key=lambda kv: -kv[1]))
        + f" (of other: indexing kernels {index_us / n / 1e3:.4f}); first "
        f"device activity - first cudaGraphLaunch {skew_ms:.3f} ms")
    return busy_us / n / 1e3


# ---------------------------------------------------------------------------
# phase 4b: the paged pool on each path
# ---------------------------------------------------------------------------

PAGED = dict(pool="paged", page_size=16)


def phase_paged(model, params, slot, names=("warm", "none", "warm+baos"),
                variants=VARIANTS, extras: bool = True) -> dict:
    """The engine trace of phase 4 through the paged pool (page 16) on
    paths ``names`` (warm, none and warm+baos), each in ``variants``
    (eager K=1, graphed K=1 and graphed K=8): tokens, per-request ticks,
    CommitEvents and ticks_total must equal the slot pool's run at the
    same settings (``slot``, from phase_engine), its launch counts too
    (K=8: up to each run's own ticks after a stop), and a graphed run must
    capture no graph after warmup().  Then, with ``extras``, a profile of
    the paged warm graphed K=1 tick against the slot tick's, the gather
    and scatter against their byte bound, preemption at full width and the
    prefix-heavy goodput case.  Returns the launch counts of the runs."""
    import numpy as np
    from repro_torch.kernels import _build
    cfg = model.cfg
    trace = engine_trace(cfg)
    launches = {name: 0 for name in _build.COUNTED}
    dcfgs, warm_eng = {}, None
    for name, mode, dcfg, expected in engine_paths(model):
        if name not in names:
            continue
        dcfgs[name] = dcfg
        ref, per_tick = slot[name]["runs"], slot[name]["per_tick"]
        walls = []
        for vname, vcfg in variants:
            what = f"paged engine path={name} {vname}"
            eng, keys, tick_ms, counts, captures0 = engine_run(
                model, params, dcfg, mode, trace, True, **vcfg, **PAGED)
            step = graph_step(eng)
            captured = 0 if step is None else step.captures - captures0
            mt = eng._megatick_fn
            wasted = 0 if mt is None else mt.ticks_wasted
            p50, p84 = np.percentile(np.array(tick_ms), [50, 84])
            st = eng.pool.stats()
            log(f"{what}: {len(eng.completed)} requests, {eng.ticks_total} "
                f"ticks, tick wall ms median {p50:.2f} p84 {p84:.2f} (slot "
                f"pool, same settings and sinks: {ref[vname]['sink_p50']:.2f}"
                f"), {eng.metrics.summary()['tokens_per_s']:.1f} tokens/s, "
                f"max memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"paged_io {eng.metrics.stage_s['paged_io'] * 1e3:.2f} ms "
                f"in all, peak pages in use (canvas + KV) "
                f"{st['peak_pages_in_use']}, {st['num_pages'] - 1} usable in "
                f"each store, graphs captured after warmup "
                f"{captured}, ticks after a stop {wasted}, launches {counts}")
            run = dict(tokens={c.uid: c.tokens.tolist()
                               for c in eng.completed},
                       ticks={c.uid: c.ticks for c in eng.completed},
                       events=keys, ticks_total=eng.ticks_total)
            for key, got in run.items():
                require(got == ref[vname][key],
                        f"{what}: {key} differ from the slot pool's")
            want = {k: n + (wasted - ref[vname]["wasted"]) * per_tick[k]
                    for k, n in ref[vname]["counts"].items()}
            require(counts == want,
                    f"{what}: launch counts {counts} != the slot pool's "
                    f"{ref[vname]['counts']} with {wasted} ticks after a "
                    f"stop for its {ref[vname]['wasted']}")
            expect_launches(counts, expected, what)
            require(captured == 0,
                    f"{what}: {captured} graphs captured after warmup()")
            for kname, n in counts.items():
                launches[kname] += n
            walls.append(f"{vname} {p50:.2f} vs {ref[vname]['sink_p50']:.2f}")
            if name == "warm" and vname == "graphed K=1":
                warm_eng = eng
            if name == "warm+baos" and vname == "graphed K=1":
                baos_run = run
            del eng
        log(f"paged engine path={name}: "
            f"{', '.join(v for v, _ in variants)} equal the slot pool's in "
            f"tokens, per-request ticks, "
            f"{len(ref['eager K=1']['events'])} CommitEvents, ticks_total "
            f"and launches; tick wall median ms paged vs slot: "
            + ", ".join(walls))
    if not extras:
        return launches
    busy = profile_engine(model, params, dcfgs["warm"], "warm", trace,
                          "paged warm graphed K=1",
                          dict(jit_steps=True, **PAGED),
                          slot["warm"]["per_tick"])
    log(f"paged warm graphed K=1: device busy {busy:.3f} ms a tick against "
        f"the slot pool's {slot['warm']['busy']['graphed K=1']:.3f} ms")
    check_page_io(warm_eng)
    del warm_eng
    for kname, n in check_preempt(model, params, dcfgs["warm+baos"], trace,
                                  baos_run).items():
        launches[kname] += n
    for kname, n in phase_goodput(model, params).items():
        launches[kname] += n
    return launches


def check_page_io(eng) -> None:
    """Device time of the paged tick's gather (pages -> dense views) and
    scatter (back) at the engine's shape, from the profiler, beside their
    byte bound: the gather reads each distinct page once and writes the
    dense views, the scatter reads them and writes each distinct page
    once (with distinct pages, 4 passes over the dense K, V and canvas).
    Once with every row on pages of its own, once with the second half of
    each row on the null page (repeated indices, as short rows and idle
    slots have), each kernel named."""
    from repro_torch.core import diffusion
    pool = eng.pool
    B, R = pool.canvas_table.shape
    flags = pool._paged_flags
    distinct = torch.arange(1, 1 + B * R, device=DEVICE).reshape(B, R)
    half_null = distinct.clone()
    half_null[:, R // 2:] = 0
    for what, table in (("distinct pages", distinct),
                        ("half on the null page", half_null)):
        rows = diffusion.gather_canvas_rows(pool.canvas_pages, table)
        dense = diffusion.gather_cache_rows(pool.cache, table, flags)

        def gather():
            diffusion.gather_canvas_rows(pool.canvas_pages, table)
            diffusion.gather_cache_rows(pool.cache, table, flags)

        def scatter():
            diffusion.scatter_canvas_rows(pool.canvas_pages, table, rows)
            diffusion.scatter_cache_rows(pool.cache, table, dense, flags)

        parts = {}
        for half, fn in (("gather", gather), ("scatter", scatter)):
            parts[half] = device_kernels(fn, 10)
        ms = {half: sum(t for t, _ in k.values())
              for half, k in parts.items()}
        dense_bytes = rows.numel() * rows.element_size() + sum(
            dense[n].numel() * dense[n].element_size()
            for n, paged in zip(sorted(pool.cache), flags) if paged)
        n_pages = int(table.unique().numel())
        moved = 2 * dense_bytes * (1 + n_pages / (B * R))
        bound_ms = moved / HBM_BPS * 1e3
        log(f"paged gather + scatter per tick, {what} ({B} x {R} entries, "
            f"{n_pages} pages of {pool.page_size}; dense K, V and canvas "
            f"{dense_bytes / 1e6:.1f} MB): gather {ms['gather']:.4f} ms + "
            f"scatter {ms['scatter']:.4f} ms = "
            f"{ms['gather'] + ms['scatter']:.4f} ms device, bound "
            f"{bound_ms:.4f} ms (bytes, {moved / 1e6:.1f} MB); kernels: "
            + "; ".join(
                f"{half} {name[:60]} x{n:g} {t:.4f} ms"
                for half, k in parts.items()
                for name, (t, n) in sorted(k.items(),
                                           key=lambda kv: -kv[1][0])))


def check_preempt(model, params, dcfg, trace, ref) -> dict:
    """Warm+BAOS, graphed K=1, paged: after tick 3 one request is
    preempted in the middle of its block (spilled to the host: canvas row,
    KV pages, calibration rows) and restores at the next admission; its
    tokens and every CommitEvent must equal the uninterrupted run's
    (``ref``), and no graph may be captured.  Prints the spill bytes and
    the spill and restore times.  Returns the run's launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(model, params, dcfg, EngineConfig(
        num_slots=4, max_seq_len=96, mode="warm", jit_steps=True, **PAGED))
    eng.warmup()
    captures0 = eng._tick_fn.captures
    restore_ms = []
    restore = eng.pool.restore

    def timed_restore(slot, sp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(slot, sp)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)

    eng.pool.restore = timed_restore
    _build.reset_launch_counts()
    events = []
    for p, g in trace:
        eng.submit(Request(prompt=p, gen_length=g), on_commit=events.append)
    while eng.pending:
        eng.tick()
        if eng.ticks_total == 3:
            victim = next(s for s in eng.slots
                          if s is not None and s.step_in_block > 0)
            uid = victim.request.uid
            where = f"block {victim.block_idx} step {victim.step_in_block}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            require(eng.preempt(uid), "preempt: the request is not live")
            spill_ms = (time.perf_counter() - t0) * 1e3
            nbytes = eng._preempted[uid][1].nbytes
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    st = eng.pool.stats()
    tokens = {c.uid: c.tokens.tolist() for c in eng.completed}
    what = "paged warm+baos graphed K=1 with a preemption"
    log(f"{what}: request {uid} spilled at {where}: {nbytes} bytes "
        f"to the host in {spill_ms:.3f} ms, restored in "
        f"{', '.join(f'{t:.3f}' for t in restore_ms)} ms (KV pages and "
        f"calibration rows; its canvas pages go up with the next flush); "
        f"preemptions {st['preemptions']}, restores {st['restores']}, "
        f"graphs captured after warmup "
        f"{eng._tick_fn.captures - captures0}, launches {counts}")
    require(st["preemptions"] == 1 and st["restores"] == 1,
            f"{what}: {st['preemptions']} preemptions, {st['restores']} "
            "restores")
    require(tokens == ref["tokens"], f"{what}: tokens differ from the "
                                     "uninterrupted run")
    require(event_keys(events) == ref["events"],
            f"{what}: CommitEvents differ from the uninterrupted run")
    require(eng._tick_fn.captures == captures0,
            f"{what}: graphs captured after warmup()")
    return counts


def phase_goodput(model, params) -> dict:
    """The prefix-heavy goodput case at an equal page budget (the JAX
    package's benchmarks/paged_cache.py goodput case at page 16, on real
    ticks): mode none, graphed K=1, block 16, 8 steps; 48 requests at
    t = 0 in two groups of 24 sharing a 64-token prompt (4 full pages),
    each generating 16 tokens (one private page); max_seq_len 80 (5 pages
    a row) and 20 pages for both pools: the slot pool's 4 slots, the paged
    pool's 12 slots with num_pages 20 (page 0 reserved).  Every request
    must complete with no mask id left.  Prints per pool tokens/s (over
    the run's wall time), latency median, tick wall median, peak pages in
    use, prefix hit rate and peak device memory.  Returns the launch
    counts of both runs."""
    import numpy as np
    from repro_torch.core import diffusion
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(block_length=16, steps_per_block=8)
    rs = np.random.RandomState(7)
    groups = [rs.randint(0, cfg.vocab - 200, size=(64,)).astype(np.int32)
              for _ in range(2)]
    n_req, gen, row_pages, budget = 48, 16, 5, 20
    total = {name: 0 for name in _build.COUNTED}
    rates = {}
    for pool, slots, extra in (("slot", budget // row_pages, {}),
                               ("paged", 12, dict(num_pages=budget))):
        gc.collect()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        eng = ServingEngine(model, params, dcfg, EngineConfig(
            num_slots=slots, max_seq_len=80, mode="none", jit_steps=True,
            pool=pool, page_size=16, **extra))
        eng.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        for i in range(n_req):
            eng.submit(Request(prompt=groups[i % 2].copy(), gen_length=gen))
        tick_ms = []
        t0 = time.perf_counter()
        while eng.pending:
            t = time.perf_counter()
            eng.tick()
            tick_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        for k, n in counts.items():
            total[k] += n
        what = f"goodput {pool} pool ({slots} slots)"
        require(len(eng.completed) == n_req, f"{what}: requests missing")
        for c in eng.completed:
            require(not bool((c.tokens == cfg.mask_id).any()),
                    f"{what}: request {c.uid} left mask ids")
        s = eng.metrics.summary()
        if pool == "paged":
            st = eng.pool.stats()
            pages, hit = st["peak_pages_in_use"], st["prefix_hit_rate"]
        else:
            pages, hit = eng.pool.peak_in_use * row_pages, 0.0
        rates[pool] = n_req * gen / wall
        log(f"{what}, {budget} pages of 16: {n_req} requests in {wall:.3f} s"
            f", {eng.ticks_total} ticks, {rates[pool]:.1f} tokens/s, "
            f"latency median {s['latency_p50_s']:.3f} s (engine clock), "
            f"tick wall median {np.median(tick_ms):.2f} ms, peak requests "
            f"in flight {eng.pool.peak_in_use}, peak pages in use {pages}, "
            f"prefix hit rate {hit:.3f}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
            f"allocated, of which the engine's pool, graphs and buffers "
            f"reserve {(torch.cuda.max_memory_reserved() - reserved0) / 2 ** 20:.1f}"
            f" MiB, launches {counts}")
        del eng
    log(f"goodput paged / slot at {budget} pages: "
        f"{rates['paged'] / rates['slot']:.3f}x")
    return total


# ---------------------------------------------------------------------------
# phase 6: serve -- breakdown timing, observability on the hot path, the
# HTTP frontend and the CLI at full width
# ---------------------------------------------------------------------------

SERVE_DIR = ROOT / "build" / "chip_smoke"


def record_stages(obs):
    """Wrap ``obs.tick`` so each tick's stage seconds are kept; returns the
    list they go into."""
    ticks = []
    tick = obs.tick

    def recording(stages, *args, **kw):
        ticks.append(dict(stages))
        return tick(stages, *args, **kw)

    obs.tick = recording
    return ticks


def run_record(eng, keys) -> dict:
    """What two runs of one trace must agree on."""
    done = eng.completed
    return dict(tokens={c.uid: c.tokens.tolist() for c in done},
                ticks={c.uid: c.ticks for c in done}, events=keys,
                ticks_total=eng.ticks_total)


BREAKDOWN_VARIANTS = (("eager", dict(jit_steps=False)),
                      ("graphed", dict(jit_steps=True)))


def phase_breakdown(model, params, slot_paths,
                    names=("warm", "warm+baos", "warm legacy fmt none"),
                    variants=BREAKDOWN_VARIANTS, extra=None) -> dict:
    """6a: the engine trace with EngineConfig(breakdown=True) on paths
    ``names``: warm (fused head, mxfp8), warm+baos and the Fig. 1 pair's
    reference side, warm on the legacy head at fmt none; each in
    ``variants`` (eager and graphed), equal to the plain engine's run of
    the path (tokens, per-request ticks, CommitEvents, ticks_total).
    Prints the stage medians and the sampling share sampling / (forward +
    sampling), and the graphed forward + sampling beside phase 4's graphed
    device busy and the CUDA-event times of the tick's halves (and, with
    the legacy path, the Fig. 1 pair).  ``extra``: EngineConfig fields of
    every run (``fwd_kw``).  Returns the launch counts."""
    import numpy as np
    from repro_torch.core import sampling
    from repro_torch.kernels import _build
    from repro_torch.obs import ServingObs
    trace = engine_trace(model.cfg)
    paths = {name: (mode, dcfg, expected)
             for name, mode, dcfg, expected in engine_paths(model)}
    mode, warm, expected = paths["warm"]
    legacy = dataclasses.replace(warm, head_path="legacy",
                                 sampling=sampling.SamplingConfig(fmt="none"))
    cases = [("warm", *paths["warm"]), ("warm+baos", *paths["warm+baos"]),
             ("warm legacy fmt none", "warm", legacy,
              path_kernels(model, legacy, True))]
    launches = {name: 0 for name in _build.COUNTED}
    shares = {}
    for name, mode, dcfg, expected in cases:
        if name not in names:
            continue
        if name in slot_paths:
            ref = slot_paths[name]["runs"]["eager K=1"]
        else:
            eng, keys, _, counts, _ = engine_run(model, params, dcfg, mode,
                                                 trace, True,
                                                 jit_steps=False,
                                                 **(extra or {}))
            ref = run_record(eng, keys)
            expect_launches(counts, expected, f"breakdown {name} plain")
            del eng
        for vname, vcfg in variants:
            what = f"breakdown {model.cfg.name} path={name} {vname}"
            obs = ServingObs().for_replica("replica-0")
            stages = record_stages(obs)
            eng, keys, tick_ms, counts, _ = engine_run(
                model, params, dcfg, mode, trace, True, breakdown=True,
                obs=obs, **vcfg, **(extra or {}))
            got = run_record(eng, keys)
            for key in ("tokens", "ticks", "events", "ticks_total"):
                require(got[key] == ref[key],
                        f"{what}: {key} differ from the plain engine's")
            expect_launches(counts, expected, what)
            for kname, n in counts.items():
                launches[kname] += n
            require(all(set(st) == {"host_prep", "forward", "sampling",
                                    "host_sync", "commit"}
                        for st in stages) and len(stages) == eng.ticks_total,
                    f"{what}: stage names {sorted(stages[0])}")
            med = {s: float(np.median([st[s] for st in stages])) * 1e3
                   for s in ("forward", "sampling", "host_prep",
                             "host_sync", "commit")}
            share = med["sampling"] / (med["forward"] + med["sampling"])
            shares[(name, vname)] = (med, share)
            log(f"{what}: {eng.ticks_total} ticks equal the plain engine's "
                f"(tokens, ticks, {len(keys)} CommitEvents); stage medians "
                f"ms: " + ", ".join(f"{s} {v:.3f}" for s, v in med.items())
                + f"; sampling share {share * 100:.2f}%; tick wall median "
                f"{float(np.median(tick_ms)):.2f} ms; host waits per tick "
                f"{eng.host_waits / eng.ticks_total:.3f}")
            del eng
        med, share = shares[(name, "graphed")]
        info = slot_paths.get(name)
        if info is not None:
            fwd_ev, smp_ev = info["halves"]
            log(f"breakdown {model.cfg.name} path={name}: graphed forward "
                f"+ sampling "
                f"{med['forward'] + med['sampling']:.3f} ms (host clock, "
                f"each ending in a device wait) against phase 4's graphed "
                f"K=1 device busy {info['busy']['graphed K=1']:.3f} ms and "
                f"the eager halves' CUDA-event times tick_forward "
                f"{fwd_ev:.3f} + tick_sample {smp_ev:.3f} ms")
    if "warm legacy fmt none" not in names:
        return launches
    head = slot_paths["warm"]["sampling_stage"]["legacy head product"]
    (fw, fs), (lw, ls) = (shares[("warm", "graphed")],
                          shares[("warm legacy fmt none", "graphed")])
    moved = (lw["sampling"] + head) / (lw["forward"] + lw["sampling"])
    log(f"Fig. 1 sampling share on the card (graphed): legacy head fmt none "
        f"{ls * 100:.2f}% (forward {lw['forward']:.3f}, sampling "
        f"{lw['sampling']:.3f} ms), fused head mxfp8 {fs * 100:.2f}% "
        f"(forward {fw['forward']:.3f}, sampling {fw['sampling']:.3f} ms); "
        f"the legacy forward holds the full-sequence head product, "
        f"{head:.3f} ms device (phase 4): charged to sampling, the legacy "
        f"share would be {moved * 100:.2f}% (the paper: up to 71% on its "
        f"reference path, under 10% fused)")
    return launches


def phase_obs(model, params) -> dict:
    """6b: the warm path graphed at K=1 and K=8, three ways: obs off,
    metrics + drift, and metrics + drift + trace + an event log.  Tokens,
    CommitEvents and host waits must be equal across the three; the event
    log must validate with every request terminal, the trace must
    validate, the /metrics tick counter must equal ticks_total and the
    committed-token counter the tokens generated, and the drift report
    must have ticks.  Prints each way's tick wall median.  Returns the
    launch counts."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.obs import (EventLog, ServingObs, TraceCollector,
                                 modeled_tick_stages, parse_exposition,
                                 read_events, validate_events,
                                 validate_trace)
    from repro_torch.sim.analytical import HostConfig
    trace = engine_trace(model.cfg)
    gen_tokens = sum(g for _, g in trace)
    name, mode, dcfg, expected = engine_paths(model)[0]
    launches = {k: 0 for k in _build.COUNTED}
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    for vname, vcfg in (("graphed K=1", dict(jit_steps=True)),
                        ("graphed K=8", dict(jit_steps=True,
                                             megatick_k=8))):
        runs = {}
        for way in ("obs off", "metrics + drift",
                    "metrics + drift + trace + event log"):
            what = f"obs path={name} {vname} {way}"
            root = obs = log_path = None
            if way != "obs off":
                root = ServingObs(trace=TraceCollector(
                    enabled="trace" in way))
                if "event log" in way:
                    log_path = SERVE_DIR / f"events-{vname[-3:]}.jsonl"
                    log_path.unlink(missing_ok=True)
                    root.set_event_log(EventLog(str(log_path)))
                obs = root.for_replica("replica-0")
                obs.set_drift_model(modeled_tick_stages(
                    model.cfg, dcfg, batch=4, prompt_len=32,
                    megatick_k=vcfg.get("megatick_k", 1),
                    host=HostConfig()),
                    host_stages=("dispatch", "device_sync"))
            eng, keys, tick_ms, counts, _ = engine_run(
                model, params, dcfg, mode, trace, True, obs=obs, **vcfg)
            expect_launches(counts, expected, what)
            for kname, n in counts.items():
                launches[kname] += n
            runs[way] = dict(run_record(eng, keys), waits=eng.host_waits,
                             p50=float(np.median(tick_ms)))
            if root is not None:
                m = parse_exposition(root.registry.expose())
                ticks = m["dllm_ticks_total"]['{replica="replica-0"}']
                toks = m["dllm_tokens_committed_total"][
                    '{replica="replica-0"}']
                require(ticks == eng.ticks_total and toks == gen_tokens,
                        f"{what}: /metrics ticks {ticks} tokens {toks}, "
                        f"engine {eng.ticks_total} ticks {gen_tokens} "
                        f"tokens")
                rep = obs.drift_report()
                require(rep["ticks"] > 0, f"{what}: drift saw no tick")
                detail = (f"; /metrics ticks {ticks:.0f}, tokens "
                          f"{toks:.0f}; drift scale {rep['scale']:.4g}")
                if "trace" in way:
                    validate_trace(root.trace.to_json())
                    root.events.close()
                    summary = validate_events(read_events(str(log_path)),
                                              require_terminal=True)
                    require(len(summary["uids"]) == len(trace),
                            f"{what}: event log has {summary['uids']}")
                    detail += (f"; trace valid ({len(root.trace.events())} "
                               f"events), event log valid "
                               f"({summary['records']} records)")
            else:
                detail = ""
            log(f"{what}: tick wall median {runs[way]['p50']:.3f} ms, host "
                f"waits {eng.host_waits}{detail}")
            del eng
        ref = runs["obs off"]
        for way, run in runs.items():
            for key in ("tokens", "ticks", "events", "ticks_total",
                        "waits"):
                require(run[key] == ref[key],
                        f"obs {vname} {way}: {key} differ from obs off")
        log(f"obs path={name} {vname}: tokens, {len(ref['events'])} "
            f"CommitEvents and {ref['waits']} host waits equal with obs "
            f"off and on; tick wall medians " + ", ".join(
                f"{way} {run['p50']:.3f}" for way, run in runs.items())
            + " ms")
    return launches


def phase_http(model, params) -> dict:
    """6c: build_frontend at full width on 127.0.0.1 (ephemeral port).  One
    slot in mode none: a streamed and a gathered request equal
    generate(cache_mode='none') bit for bit.  Four slots in mode warm,
    graphed, profile_ticks=4: 17 streamed requests on paused workers (16
    accepted, one answered 429), then served; each completes, its commit
    positions partition its generation region, its ticks increase and no
    mask id is left; a torch.profiler trace is written; then loadgen's 16
    requests (TTFT, tokens/s and latency printed) and a graceful drain
    that completes the work pending at shutdown.  Returns the launch
    counts."""
    import asyncio
    import numpy as np
    from repro_torch.core import diffusion
    from repro_torch.kernels import _build
    from repro_torch.obs import parse_exposition
    from repro_torch.serving.frontend import build_frontend, loadgen
    cfg = model.cfg
    launches = {k: 0 for k in _build.COUNTED}
    common = ("flash_bidir", "fused_head_sampling", "topk_mask")
    rs = np.random.RandomState(6)

    def count(what):
        counts = dict(_build.launch_counts)
        expect_launches(counts, common, what)
        for kname, n in counts.items():
            launches[kname] += n

    # one slot, mode none: the engine runs what generate runs
    dcfg = diffusion.DiffusionConfig(gen_length=32, block_length=16,
                                     steps_per_block=8)
    prompt = rs.randint(0, cfg.vocab - 200, size=(16,)).astype(np.int32)
    ref = diffusion.generate(model, params,
                             torch.as_tensor(prompt, device=DEVICE)[None],
                             dcfg)[0, 16:].tolist()
    diffusion.clear_step_graphs()

    async def one_slot():
        fe = build_frontend(model, params, dcfg, model_name="llada-8b",
                            num_slots=1, max_seq_len=48, mode="none")
        _build.reset_launch_counts()
        await fe.start()
        try:
            row = await loadgen.complete(fe.url, prompt.tolist(), 32)
            gathered = await loadgen.complete(fe.url, prompt.tolist(), 32,
                                              stream=False)
        finally:
            await fe.shutdown()
        return row, gathered

    t0 = time.perf_counter()
    row, gathered = asyncio.run(one_slot())
    count("http one slot")
    require(row["status"] == "ok" and gathered["status"] == "ok",
            f"http one slot: {row.get('status')} {gathered.get('status')}")
    require(row["token_ids"] == ref and gathered["token_ids"] == ref,
            "http one slot: the stream differs from generate()")
    require(row["ticks_monotone"] and sorted(row["positions"]) ==
            list(range(16, 48)), "http one slot: ticks or positions")
    log(f"http one slot (mode none, prompt 16, gen 32): streamed and "
        f"gathered tokens equal generate() bit for bit; {len(row['ticks'])} "
        f"commit events, TTFT {row['ttft_s'] * 1e3:.1f} ms, latency "
        f"{row['latency_s'] * 1e3:.1f} ms ({time.perf_counter() - t0:.1f} s "
        f"with set-up)")

    # four slots, mode warm, graphed
    _, mode, dcfg, _ = engine_paths(model)[0]
    dcfg = dataclasses.replace(dcfg, gen_length=64)
    reqs = [(rs.randint(0, cfg.vocab - 200, size=(rs.randint(16, 33),))
             .astype(np.int32), int(rs.choice([32, 48, 64])))
            for _ in range(17)]

    async def four_slots():
        fe = build_frontend(model, params, dcfg, model_name="llada-8b",
                            num_slots=4, max_seq_len=96, mode=mode,
                            max_queue=12, profile_ticks=4,
                            profile_dir=str(SERVE_DIR / "profile"))
        captures = [w.engine.graph_captures for w in fe.router.workers]
        _build.reset_launch_counts()
        await fe.start(start_workers=False)
        try:
            tasks = [asyncio.ensure_future(
                loadgen.complete(fe.url, p.tolist(), g)) for p, g in reqs]
            for _ in range(2000):
                if sum(t.done() for t in tasks) >= 1 and \
                        fe.router.load >= 16:
                    break
                await asyncio.sleep(0.005)
            fe.start_workers()
            rows = await asyncio.gather(*tasks)
            t1 = time.perf_counter()
            rep = await loadgen.run_load(
                fe.url, rate=20.0, n_requests=16, prompt_len=24,
                max_tokens=32, seed=1, scrape=True)
            t_load = time.perf_counter() - t1
            tail = [asyncio.ensure_future(
                loadgen.complete(fe.url, p.tolist(), g))
                for p, g in reqs[:6]]
            for _ in range(2000):
                if fe.router.load >= 6:
                    break
                await asyncio.sleep(0.005)
            pending = fe.router.load
            await fe.shutdown(drain=True)
            drained = await asyncio.gather(*tail)
            metrics = parse_exposition(fe.obs.registry.expose())
        except BaseException:
            await fe.shutdown(drain=False)
            raise
        return fe, rows, rep, t_load, pending, drained, metrics, captures

    t0 = time.perf_counter()
    fe, rows, rep, t_load, pending, drained, metrics, captures = \
        asyncio.run(four_slots())
    count("http four slots")
    shed = [r for r in rows if r["status"] == "shed"]
    ok = [r for r in rows if r["status"] == "ok"]
    require(len(shed) == 1 and shed[0].get("http") == 429 and len(ok) == 16,
            f"http four slots: {len(ok)} ok, {len(shed)} answered 429 "
            f"(want 16 and 1): {[r['status'] for r in rows]}")
    for (p, g), r in zip(reqs, rows):
        if r["status"] != "ok":
            continue
        require(r["ticks_monotone"] and cfg.mask_id not in r["token_ids"],
                "http four slots: ticks not monotone or a mask id left")
        require(sorted(r["positions"]) == list(range(len(p), len(p) + g)),
                "http four slots: commit positions do not partition the "
                "generation region")
    require(rep["completed"] == 16 and rep["errors"] == 0 and
            rep["shed"] == 0 and rep["ticks_monotone"],
            f"http loadgen: {rep}")
    require(all(r["status"] == "ok" for r in drained) and pending >= 6,
            f"http drain: {[r['status'] for r in drained]} of {pending}")
    eng = fe.router.workers[0].engine
    require([w.engine.graph_captures for w in fe.router.workers] ==
            captures, "http: a worker captured a graph")
    ticks = metrics["dllm_ticks_total"]['{replica="replica-0"}']
    require(ticks == eng.ticks_total, f"http /metrics ticks {ticks} != "
            f"{eng.ticks_total}")
    prof = fe.router.workers[0].profile_path
    require(prof is not None and Path(prof).stat().st_size > 0,
            "http: no torch.profiler trace written")
    log(f"http four slots (mode warm, graphed, max_queue 12): 16 of 17 "
        f"streamed requests accepted and complete, {len(shed)} answered "
        f"429; positions partition each generation region, ticks "
        f"increase, no mask id left; loadgen 16 requests at 20/s: TTFT "
        f"p50 {rep['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{rep['ttft_p99_s'] * 1e3:.1f} ms, {rep['goodput_tok_s']:.1f} "
        f"tokens/s, latency p50 {rep['latency_p50_s'] * 1e3:.1f} ms p99 "
        f"{rep['latency_p99_s'] * 1e3:.1f} ms over {t_load:.2f} s; drain "
        f"completed {len(drained)} pending requests; /metrics ticks "
        f"{ticks:.0f} = engine; torch.profiler trace {prof} "
        f"({Path(prof).stat().st_size / 2 ** 20:.1f} MiB); "
        f"{time.perf_counter() - t0:.1f} s with set-up")
    return launches


def phase_cli() -> None:
    """6d: ``python -m repro_torch.launch.serve --arch llada-8b --full`` as
    a subprocess on the engine path with --breakdown, a trace and an event
    log, and once with --legacy: each must exit 0, the trace and the log
    must validate, and ``python -m repro_torch.obs.logquery LOG
    --validate`` must exit 0.  Prints each run's summary lines."""
    from repro_torch.obs import read_events, validate_events, validate_trace
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    trace, events = SERVE_DIR / "cli-trace.json", SERVE_DIR / "cli.jsonl"
    events.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base_cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                "--arch", "llada-8b", "--full"]
    for what, extra in (("engine", ["--breakdown", "--trace-out",
                                    str(trace), "--event-log",
                                    str(events)]),
                        ("legacy", ["--legacy"])):
        t0 = time.perf_counter()
        r = subprocess.run(base_cmd + extra, cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        require(r.returncode == 0, f"cli {what}: exit {r.returncode}: "
                f"{r.stderr[-2000:]}")
        log(f"cli {what} ({' '.join(extra[:1]) or 'engine'}): exit 0 in "
            f"{time.perf_counter() - t0:.1f} s")
        for line in r.stdout.splitlines():
            log(f"  {line}")
    with open(trace) as f:
        validate_trace(json.load(f))
    summary = validate_events(read_events(str(events)),
                              require_terminal=True)
    q = subprocess.run([sys.executable, "-m", "repro_torch.obs.logquery",
                        str(events), "--validate"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    require(q.returncode == 0, f"cli logquery --validate: {q.stdout}"
            f"{q.stderr}")
    log(f"cli: trace valid, event log valid ({summary['records']} records,"
        f" {len(summary['uids'])} requests); logquery: {q.stdout.strip()}")


def phase_tick_breakdown(eng, model, params, dcfg, name) -> None:
    """Device time of the tick's two halves at the engine's shape, on the
    engine's final canvas (all slots idle: the work is the same).  Returns
    (tick_forward ms, tick_sample ms), CUDA events."""
    from repro_torch.core import diffusion
    cache = eng.pool.cache if eng.mode == "warm" else None
    B = eng.num_slots
    bs = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    k = torch.full((B,), 2, dtype=torch.int32, device=DEVICE)
    kw = eng.fwd_kw
    feats, _ = diffusion.tick_forward(model, params, eng.x, eng.kv_valid, bs,
                                      cache, dcfg, **kw)
    fwd = time_ms(lambda: diffusion.tick_forward(
        model, params, eng.x, eng.kv_valid, bs, cache, dcfg, **kw), 5)
    smp = time_ms(lambda: diffusion.tick_sample(
        params, feats, eng.x, bs, k, 0, dcfg, eng.mask_id, model), 10)
    log(f"tick breakdown path={name} ({B} x {eng.max_seq_len}): "
        f"tick_forward {fwd:.3f} ms, tick_sample {smp:.3f} ms")
    profile_ticks(lambda: diffusion.batched_tick(
        model, params, eng.x, eng.kv_valid, bs, k, 0, cache, dcfg,
        eng.mask_id, **kw), name, gemm_flops=forward_gemm_flops(
            model.cfg, *eng.x.shape))
    return fwd, smp


def forward_gemm_flops(cfg, B: int, S: int):
    """GEMM FLOPs of one forward over (B, S) of a transformer stack: per
    token the QKV and output projections and a dense layer's SwiGLU, or an
    MoE layer's router and shared experts; an MoE layer's expert products
    run over E·C capacity rows per dispatch group, empty slots included.
    None for the recurrent families and whisper's encoder-decoder (not
    modeled)."""
    from repro_torch.models import moe
    if cfg.family not in ("dense", "moe", "vlm"):
        return None
    d = cfg.d_model
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    per_token = 2 * d * (hq + hkv)
    grouped = 0
    if cfg.moe is None:
        per_token += 3 * d * cfg.d_ff
    else:
        m = cfg.moe
        per_token += d * m.num_experts + 3 * d * (
            m.d_ff_shared or m.num_shared_experts * m.d_ff_expert)
        G, T = (B, S) if m.group_dispatch and B > 1 else (1, B * S)
        grouped = G * m.num_experts * moe.capacity(T, m) * 3 * d \
            * m.d_ff_expert
    return 2.0 * cfg.n_layers * (B * S * per_token + grouped)


def phase_sampling_stage(eng, model, params, dcfg) -> None:
    """The sampling stage on each head path at the engine's shape (4 rows
    of 16-position blocks, R = 64): device time of tick_sample from the
    profiler (fused: the streamed head; unfused: the cuBLAS head on the
    (4, 16, d) slice, then Stable-Max on the stored logits; legacy: the
    slice of full-sequence logits, then Stable-Max; a model without
    head_mode has the legacy head only) and of the full-sequence head
    product the legacy forward adds, which must show device time.
    Returns {head path: device ms}, with the legacy head product's under
    "legacy head product"."""
    from repro_torch.core import diffusion
    from repro_torch.models import layers
    cfg = model.cfg
    B = eng.num_slots
    bs = torch.tensor([16, 20, 24, 32][:B], dtype=torch.int32,
                      device=DEVICE)
    k = torch.full((B,), 2, dtype=torch.int32, device=DEVICE)
    out_all, _ = diffusion.tick_forward(model, params, eng.x, eng.kv_valid,
                                        bs, None, dcfg, **eng.fwd_kw)
    if model.supports_head_mode:
        hidden, heads = out_all, ("fused", "unfused", "legacy")
    else:
        # the forward returns the logits; the product's time does not
        # depend on the hidden states' values
        hidden = torch.randn(*eng.x.shape, cfg.d_model, device=DEVICE,
                             dtype=cfg.torch_dtype)
        heads = ("legacy",)
    parts, out = [], {}
    for head_path in heads:
        d = dataclasses.replace(dcfg, head_path=head_path)
        feats = hidden
        if head_path == "legacy":
            feats = (layers.qdot(hidden, params["lm_head"])
                     if model.supports_head_mode else out_all)
        dev_ms = device_ms(lambda: diffusion.tick_sample(
            params, feats, eng.x, bs, k, 0, d, eng.mask_id, model), 10)
        ev_ms = time_ms(lambda: diffusion.tick_sample(
            params, feats, eng.x, bs, k, 0, d, eng.mask_id, model), 10)
        parts.append(f"{head_path} {dev_ms:.3f} ms device "
                     f"({ev_ms:.3f} ms CUDA events)")
        out[head_path] = dev_ms
    del feats, out_all
    head_ms = kernel_ms(lambda: layers.qdot(hidden, params["lm_head"]), 10,
                        "the legacy head product")
    out["legacy head product"] = head_ms
    log(f"sampling stage ({B} x 16 rows, V {cfg.vocab}): "
        f"tick_sample {', '.join(parts)}; legacy's full-sequence head "
        f"product in the forward ({B} x {eng.max_seq_len} rows) {head_ms:.3f}"
        f" ms device (a graph of 10 calls)")
    return out


def device_ms_by_kernel(fn, n: int) -> dict:
    """Device time per call of each kernel ``fn`` launches, from the
    profiler (its device time over n calls, / n), after one warm-up
    call."""
    return {k: ms for k, (ms, _) in device_kernels(fn, n).items()}


def device_kernels(fn, n: int) -> dict:
    """{kernel: (device ms, launches)} per call of ``fn`` from the profiler
    (over n calls, / n), after one warm-up call."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / n / 1e3, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def host_ms(fn, n: int) -> float:
    """Host time per call of ``fn`` (perf_counter over n calls, no sync
    inside the loop: the cost of enqueuing), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def device_ms(fn, n: int) -> float:
    """Device time per call of ``fn`` from the profiler: the sum over the
    kernels it launches."""
    return sum(device_ms_by_kernel(fn, n).values())


def kernel_ms(fn, n: int, what: str) -> float:
    """Device time per call of ``fn``: n calls captured in one CUDA graph
    (after a warm-up call), its replay timed with CUDA events, / n, so no
    host launch cost falls between the calls; the run fails unless it is
    above 0.  Late in a run the profiler records no device activity in a
    short window: llada-moe's legacy head product read 0.000 ms from it
    in whole runs of this script, as did phase 8's kernels and softmax +
    max."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, 5) / n
    del graph
    require(ms > 0, f"{what}: no device time")
    return ms


def kernel_class(name: str) -> str:
    """The kernel class a profiled device activity counts under."""
    key = name.lower()
    return ("flash_bidir" if "flash_bidir" in key else
            "baos_mx_quant" if "baos_mx_quant" in key else
            "stablemax_sampling" if "stablemax" in key else
            "fused_head" if "head_" in key else
            "topk_mask" if "topk_mask" in key else
            "gemm" if any(s in key for s in ("gemm", "nvjet", "xmma",
                                             "cutlass")) else
            "other")


def profile_ticks(tick, name: str, gemm_flops, n: int = 3) -> None:
    """torch.profiler over n ticks: device time per kernel class (device
    events only), the achieved GEMM rate (when ``gemm_flops``, a tick's
    GEMM FLOPs, is given), and the device's idle share of the wall time,
    which the profiler's own host cost inflates."""
    from torch.autograd import DeviceType
    tick()
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    classes, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue                 # host ops repeat their kernels' time
        cls = kernel_class(e.key)
        classes[cls] = classes.get(cls, 0.0) + us
        kernels.append((us, e.count // n, e.key[:70]))
    busy = sum(classes.values())
    parts = ", ".join(f"{c} {us / n / 1e3:.3f} ms"
                      for c, us in sorted(classes.items(),
                                          key=lambda kv: -kv[1]))
    launches = sum(calls for _, calls, _ in kernels)
    gemm_us = classes.get("gemm", 0.0) / n
    rate = ""
    if gemm_flops is not None and gemm_us:
        rate = (f", GEMMs {gemm_flops / 1e12:.2f} TFLOP at "
                f"{gemm_flops / (gemm_us * 1e-6) / 1e12:.0f} TFLOP/s")
    log(f"profile path={name}, per tick: wall {wall_us / n / 1e3:.3f} ms, "
        f"device busy {busy / n / 1e3:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall_us) * 100:.1f}%), {launches} "
        f"kernels{rate}: {parts}")
    for us, calls, kname in sorted(kernels, reverse=True)[:8]:
        log(f"  {us / n / 1e3:8.3f} ms/tick  {calls:4d} calls/tick  {kname}")


# ---------------------------------------------------------------------------
# phase 7: the MoE family
# ---------------------------------------------------------------------------

MOE_ARCH = "llada-moe-7b-a1b"
MOE_CONFIGS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")


def phase_moe(gen) -> dict:
    """7: llada-moe-7b-a1b at full width and 2 of its 24 layers (a
    ``DEPTH_CUTS`` cut for the script's time limit, logged; d 2048, 64
    experts top-2, bf16, seeded random weights) through generate (mode
    none stepped with each step's sampling held against plain, dual +
    BAOS and prefix + BAOS), the engine's four paths each eager K=1,
    graphed K=1 and K=8 (phase 4's checks), warm + BAOS with an mxfp4 KV
    cache (eager against graphed K=1), the paged pool on warm graphed K=1
    and K=8 (equal to the slot pool), breakdown on warm graphed (the MoE
    sampling share), the Table 6 shape in modes none, prefix + BAOS and
    dual + BAOS (eager against graphed, a second generate() capturing
    nothing), the batched dispatch against JAX's one-group algorithm per
    row, and the expert products' device time against their byte floors;
    then qwen2-moe-a2.7b and moonshot-v1-16b-a3b through the engine
    (phase_configs).  Returns the launch counts of the runs."""
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    t_phase = time.perf_counter()
    cfg = cut_depth(base.get_config(MOE_ARCH), DEPTH_CUTS[MOE_ARCH])
    model = build_model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"{MOE_ARCH} params: {cfg.param_count() / 1e9:.2f} B "
        f"({cfg.active_param_count() / 1e9:.2f} B read by one token), init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    phase_e2e(model, params, gen)
    for cache_mode in ("dual", "prefix"):
        phase_cached(model, params, gen, cache_mode)
    counts, slot_paths = phase_engine(model, params, slowfast=False)
    add(counts)
    add(check_kv_fp4(model, params))
    add(phase_paged(model, params, slot_paths, names=("warm",),
                    variants=VARIANTS[1:], extras=False))
    add(phase_breakdown(model, params, slot_paths, names=("warm",),
                        variants=BREAKDOWN_VARIANTS[1:]))
    add(phase_table6(model, params, gen, with_quant=False))
    check_moe_dispatch(model, params, gen)
    log(f"phase 7 {MOE_ARCH}: {time.perf_counter() - t_phase:.1f} s")
    del model, params, slot_paths
    diffusion.clear_step_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    add(phase_configs(gen, MOE_CONFIGS))
    log(f"phase 7 {', '.join(MOE_CONFIGS)}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 7 launches: {total}")
    return total


def check_kv_fp4(model, params) -> dict:
    """The engine trace on warm + BAOS with the KV cache in mxfp4_e2m1
    (baos_mx_quant's fp4 grid on the path): graphed K=1 equal to eager K=1
    in tokens, per-request ticks, CommitEvents, ticks_total and launch
    counts.  Returns the launch counts."""
    import numpy as np
    from repro_torch.core import baos, diffusion
    dcfg = diffusion.DiffusionConfig(
        block_length=16, steps_per_block=8,
        baos=baos.BAOSConfig(enabled=True, kv_format="mxfp4_e2m1"))
    trace = engine_trace(model.cfg)
    expected = ("flash_bidir", "topk_mask", "fused_head_sampling",
                "baos_mx_quant")
    runs, total = {}, {}
    for vname, vcfg in VARIANTS[:2]:
        what = f"engine {model.cfg.name} warm+baos mxfp4_e2m1 {vname}"
        eng, keys, tick_ms, counts, _ = engine_run(
            model, params, dcfg, "warm", trace, True, **vcfg)
        expect_launches(counts, expected, what)
        runs[vname] = dict(run_record(eng, keys), counts=counts)
        log(f"{what}: {eng.ticks_total} ticks, tick wall ms median "
            f"{float(np.median(tick_ms)):.2f}, "
            f"{eng.metrics.summary()['tokens_per_s']:.1f} tokens/s, "
            f"launches {counts}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        del eng
    ref, got = runs["eager K=1"], runs["graphed K=1"]
    for key in ("tokens", "ticks", "events", "ticks_total", "counts"):
        require(got[key] == ref[key],
                f"engine warm+baos mxfp4_e2m1 graphed K=1: {key} differ "
                f"from eager K=1")
    log(f"engine {model.cfg.name} warm+baos mxfp4_e2m1: graphed K=1 equals "
        f"eager K=1 in tokens, {len(ref['events'])} CommitEvents, "
        f"{ref['ticks_total']} ticks and launch counts")
    return total


def moe_one_group(x, topk_w, topk_e, p, mcfg):
    """JAX's one-group dispatch and combine (src/repro/models/moe.py
    _moe_tokens), written out for one group x (T, d) with its routing:
    (kept (token, expert) pairs, the expert buffer (E, C, d), the routed
    output (T, d)).  The plain reference of the port's batched dispatch."""
    from repro_torch.models import layers, moe
    T, d = x.shape
    K, E = mcfg.top_k, mcfg.num_experts
    C = moe.capacity(T, mcfg)
    P = T * K
    flat_e = topk_e.reshape(P)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=x.device),
                                side="left")
    pos = torch.arange(P, device=x.device) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    tok = order // K
    src = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    src[slot] = tok
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    expert_in = x_pad[src[:E * C]].reshape(E, C, d)
    h = layers.swiglu(torch.matmul(expert_in, p["w_gate"]),
                      torch.matmul(expert_in, p["w_up"]))
    expert_out = torch.matmul(h, p["w_down"])
    out_pad = torch.cat([expert_out.reshape(E * C, d), x.new_zeros(1, d)])
    pair = out_pad[slot][torch.argsort(order)].reshape(T, K, d)
    out = torch.sum(pair * topk_w[..., None].to(x.dtype), dim=1)
    kept = set(zip(tok[keep].tolist(), se[keep].tolist()))
    return kept, expert_in, out


def check_moe_dispatch(model, params, gen) -> None:
    """Each MoE layer's FFN input at the engine's shape (4 slots x 96, one
    forward over random tokens, taken from moe_ffn's calls): the batched
    dispatch (models/moe, one group per row) against moe_one_group run
    row by row on the same routing, the kept (token, expert) pairs equal
    and the output within one bf16 ulp; then the expert products (three
    GEMMs and the SwiGLU on each layer's dispatched buffer, every layer)
    timed on the card beside two byte floors: every expert's weights, and
    only the experts this forward's kept pairs use (the one-token top-k
    floor, K experts a layer, is printed too)."""
    from repro_torch.models import layers, moe
    cfg = model.cfg
    mcfg = cfg.moe
    B, S = 4, 96
    tokens = torch.randint(0, cfg.vocab - 200, (B, S), generator=gen,
                           device=DEVICE)
    inputs = []
    plain_ffn = moe.moe_ffn

    def recording_ffn(h, p, c, quant=None):
        inputs.append(h.clone())
        return plain_ffn(h, p, c, quant)

    moe.moe_ffn = recording_ffn
    try:
        model.forward(params, tokens, head_mode="hidden")
    finally:
        moe.moe_ffn = plain_ffn
    require(len(inputs) == cfg.n_layers, "moe_ffn ran on a layer count "
                                         f"{len(inputs)}")
    E, K, d, Fe = mcfg.num_experts, mcfg.top_k, cfg.d_model, \
        mcfg.d_ff_expert
    C = moe.capacity(S, mcfg)
    n_pairs = n_kept = 0
    worst = 0.0
    used, buffers = [], []
    for i, h in enumerate(inputs):
        p = params["layers"][i]["moe"]
        got, _ = moe.moe_ffn(h, p, mcfg)
        topk_w, topk_e, _ = moe.route(h, p["router"], mcfg)
        order, slot = moe.dispatch_slots(topk_e, mcfg, C)
        flat_e = topk_e.reshape(B, S * K)
        layer_used, ins = set(), []
        for r in range(B):
            kept = slot[r] < E * C
            pairs = set(zip((order[r][kept] // K).tolist(),
                            flat_e[r][order[r][kept]].tolist()))
            want_pairs, expert_in, want = moe_one_group(
                h[r], topk_w[r], topk_e[r], p, mcfg)
            require(pairs == want_pairs,
                    f"moe dispatch layer {i} row {r}: kept pairs differ "
                    f"from the one-group algorithm's")
            err = (got[r].float() - want.float()).abs()
            worst = max(worst, float((err - bf16_ulp(want)).max()))
            n_pairs, n_kept = n_pairs + S * K, n_kept + len(pairs)
            layer_used |= {e for _, e in pairs}
            ins.append(expert_in)
        used.append(len(layer_used))
        buffers.append((torch.stack(ins, 1).reshape(E, B * C, d), p))
    log(f"moe dispatch at the engine's shape ({B} x {S}, {cfg.n_layers} "
        f"layers, E {E}, top-{K}, C {C} per row): kept pairs equal the "
        f"one-group algorithm's row by row ({n_kept} of {n_pairs} kept); "
        f"output max error beyond one bf16 ulp {worst:.3g}")
    require(worst <= 0.0, "moe dispatch: output beyond one bf16 ulp of the "
                          "one-group algorithm's")

    def products():
        for xe, p in buffers:
            hh = layers.swiglu(torch.bmm(xe, p["w_gate"]),
                               torch.bmm(xe, p["w_up"]))
            torch.bmm(hh, p["w_down"])

    w_bytes = 3 * d * Fe * 2                    # one expert's weights
    act_bytes = 2 * B * C * d * 2 * E * cfg.n_layers
    ops = 2.0 * 3 * E * B * C * d * Fe * cfg.n_layers
    all_ms, all_by = bound(E * w_bytes * cfg.n_layers + act_bytes, ops,
                           BF16_FLOPS)
    used_ms, used_by = bound(sum(used) * w_bytes + act_bytes, ops,
                             BF16_FLOPS)
    topk_ms = K * w_bytes * cfg.n_layers / HBM_BPS * 1e3
    dev = device_ms(products, 5)
    log(f"moe expert products per forward at the engine's shape ({B} x {S}"
        f", {cfg.n_layers} layers, {E} x ({B * C}, {d}) @ ({d}, {Fe})): "
        f"device {dev:.3f} ms (profiler); floor reading every expert "
        f"{all_ms:.3f} ms ({all_by}); floor reading only the experts with "
        f"kept pairs ({sum(used) / cfg.n_layers:.1f} of {E} a layer) "
        f"{used_ms:.3f} ms ({used_by}); one token's top-{K} experts "
        f"{topk_ms:.3f} ms; {dev / all_ms:.2f}x the every-expert floor")


# ---------------------------------------------------------------------------
# phase 8: the recurrent families
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("recurrentgemma-2b", "mamba2-130m")


def phase_recurrent(gen, archs=RECURRENT_ARCHS) -> dict:
    """8: the recurrent families at full width with seeded random weights,
    at the depths of DEPTH_CUTS, one model at a time (each freed before the
    next); neither has head_mode, so every path samples on the legacy head
    (full-sequence logits, stablemax_sampling, topk_mask).
    recurrentgemma-2b (5 of its 26 layers: one (rec, rec, attn) triple and
    2 rec, d 2560, MQA 10 on 1 KV head of
    D 256, window 2048, V 256000): generate in mode none stepped with each
    step's sampling held against plain, dual + BAOS and prefix + BAOS
    through generate() and stepped; the engine paths warm, none and
    warm + BAOS eager K=1, graphed K=1 and K=8 (phase 4's checks); the
    paged pool on warm graphed K=1 and K=8; breakdown on warm graphed; the
    Table 6 shape in modes none, prefix + BAOS and dual + BAOS.
    mamba2-130m (2 of 24 layers, d 768, state 128, V 50280): generate in modes
    none, dual and prefix (BAOS on the state through core/mx), the engine
    paths warm and none.  Then per model the scans' device time
    (check_recurrent_ops).  Returns the launch counts of the runs."""
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    for arch in archs:
        t_phase = time.perf_counter()
        cfg = cut_depth(base.get_config(arch), DEPTH_CUTS[arch])
        model = build_model(cfg, DEVICE)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"{arch} params: init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        phase_e2e(model, params, gen)
        for cache_mode in ("dual", "prefix"):
            add(phase_cached(model, params, gen, cache_mode))
        hybrid = cfg.family == "hybrid"
        counts, slot_paths = phase_engine(
            model, params, slowfast=False,
            names=None if hybrid else ("warm", "none"))
        add(counts)
        if hybrid:
            add(phase_paged(model, params, slot_paths, names=("warm",),
                            variants=VARIANTS[1:], extras=False))
            add(phase_breakdown(model, params, slot_paths, names=("warm",),
                                variants=BREAKDOWN_VARIANTS[1:]))
            add(phase_table6(model, params, gen, with_quant=False))
        check_recurrent_ops(model, params, gen)
        log(f"phase 8 {arch}: {time.perf_counter() - t_phase:.1f} s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model, params, slot_paths
        diffusion.clear_step_graphs()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 8 launches: {total}")
    return total


def check_recurrent_ops(model, params, gen) -> None:
    """Device time per tick (profiler) of the work a recurrent model's
    tick adds or moves, at the engine's shape (4 x 96) and Table 6's
    (16 x 384): the RG-LRU scan over the model's rec layers
    (rglru.rglru_scan) or the SSD scan over its layers
    (ssm.ssd_chunked), each with its kernels per layer; for
    recurrentgemma-2b flash_bidir at D 256 in the warm tick's shape (MQA
    10 on 1, kv_valid, one call per attention layer) beside its bound and
    SDPA's time;
    stablemax_sampling at (64, V) beside its byte bound and softmax + max;
    the legacy head product (B·S, d) x (d, V) beside its bound."""
    import torch.nn.functional as F
    from repro_torch.models import layers, rglru, ssm
    cfg = model.cfg
    dt = cfg.torch_dtype

    def rand(*shape, dtype=dt):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    for B, S in ((4, 96), (16, 384)):
        if cfg.family == "hybrid":
            n_layers = 2 * (cfg.n_layers // 3) + 2
            D = cfg.d_rnn
            x = rand(B, S, D)
            r, i = torch.sigmoid(rand(B, S, D)), torch.sigmoid(rand(B, S, D))
            lam = torch.full((D,), 0.7, device=DEVICE)
            fn = lambda: rglru.rglru_scan(x, r, i, lam)  # noqa: E731
            what = f"RG-LRU scan ({B}, {S}, {D})"
            n_bytes = 3 * x.numel() * x.element_size() + x.numel() * 4
        else:
            n_layers = cfg.n_layers
            d_inner, hp, nh, ng, dn, _ = ssm.mamba_dims(cfg)
            xs, Bv, Cv = rand(B, S, nh, hp), rand(B, S, ng, dn), \
                rand(B, S, ng, dn)
            dtv = F.softplus(rand(B, S, nh, dtype=torch.float32))
            A = -torch.exp(torch.linspace(0.0, 2.77, nh, device=DEVICE))
            fn = lambda: ssm.ssd_chunked(xs, dtv, A, Bv, Cv)  # noqa: E731
            what = f"SSD scan ({B}, {S}, {nh} heads x {hp}, state {dn})"
            n_bytes = (xs.numel() + 2 * Bv.numel()) * xs.element_size() + \
                dtv.numel() * 4 + xs.numel() * 4 + \
                B * (S // ssm.SSD_CHUNK + 1) * nh * hp * dn * 4
        per = device_kernels(fn, 10)
        dev = sum(ms for ms, _ in per.values())
        calls = sum(c for _, c in per.values())
        require(dev > 0, f"{cfg.name} {what}: the profiler shows no device "
                         f"time")
        log(f"{cfg.name} {what}: device {dev:.4f} ms a layer "
            f"({calls:.0f} kernels), {dev * n_layers:.3f} ms a forward of "
            f"{n_layers} layers; CUDA events {time_ms(fn, 10):.4f} ms a "
            f"layer; byte floor (inputs read once, outputs written once) "
            f"{n_bytes / HBM_BPS * 1e3:.4f} ms a layer")
    B, S = 4, 96
    if cfg.family == "hybrid":
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q, kk, v = rand(B, S, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
        valid = torch.arange(S, device=DEVICE)[None, :] < torch.tensor(
            (96, 64, 48, 1), device=DEVICE)[:, None]
        attn_row(q, kk, v, valid, f"{cfg.name} flash_bidir D {D} at the "
                 f"warm tick's shape ({B}, {S}, {Hq} on {Hkv}, kv_valid)",
                 cfg.n_layers // 3)
    V = cfg.vocab
    # Table 6's legacy head rows (16 x 64): logits that end on a 2 MiB page
    # at V 256000, where a read one past the end faulted
    zl = rand(1024, V) * 3
    check_stablemax_case(zl, "mxfp8_e4m3", 0.0, cfg.mask_id,
                         f"(1024, {V}) bf16")
    stablemax_row(rand(64, V) * 3, cfg.mask_id, cfg.name)
    h = rand(B, S, cfg.d_model)
    head = lambda: layers.qdot(h, params["lm_head"])  # noqa: E731
    hb_ms, hb_by = bound((cfg.d_model * V + B * S * cfg.d_model
                          + B * S * V) * 2, 2.0 * B * S * cfg.d_model * V,
                         BF16_FLOPS)
    dev = kernel_ms(head, 10, f"{cfg.name} legacy head product")
    log(f"{cfg.name} legacy head product ({B * S}, {cfg.d_model}) x "
        f"({cfg.d_model}, {V}): device {dev:.4f} ms a tick (a graph of 10 "
        f"calls), CUDA events, back to back "
        f"{time_ms(head, 10):.4f} ms, bound {hb_ms:.4f} ms ({hb_by})")


# ---------------------------------------------------------------------------
# phase 9: the audio and vlm families
# ---------------------------------------------------------------------------

# phase 9's budget, stated before its first run: the whole script stays
# under 1,050 s of its 1,200 s limit
PHASE9_BUDGET_S = 150.0
# internvl2-26b's prompts: the 256 image positions and 32 of text
VLM_PROMPT = 288


def free() -> None:
    """Drop the step graphs and the card's cached memory (the caller has
    deleted its own references to a model)."""
    from repro_torch.core import diffusion
    diffusion.clear_step_graphs()
    gc.collect()
    torch.cuda.empty_cache()


def phase_audio_vlm(gen) -> dict:
    """9: the last two families, one model at a time, each freed before
    the next; neither has head_mode, so both sample on the legacy head.
    whisper-medium at full width (24 encoder layers and 4 of the 24
    decoder layers, DEPTH_CUTS; d 1024, 16 heads of D 64, V 51865): frames (4, 1500, 1024)
    from the seeded generator through encode + cross_kv (timed);
    generate with the cross K/V in mode none stepped (each step's
    sampling held against plain; generate(megatick_k=4) must refuse
    them), dual + BAOS and prefix + BAOS (phase 3's checks); the engine
    paths warm, none and warm + BAOS, eager K=1 and graphed K=1 with
    phase 4's checks and EngineConfig(fwd_kw={"cross_kv": ...}); the
    paged pool and the megatick refusing the kwargs; breakdown on warm
    graphed; ``serve --arch whisper-medium --full`` as a subprocess.
    internvl2-26b at full width (d 6144, 48 heads on 8 of D 128, V 92553;
    4 of its 48 layers, a ``DEPTH_CUTS`` cut, logged): generate with
    image embeddings (1, 256, 6144) over prompts of 288 (gen 64) in
    mode none stepped, dual + BAOS and prefix + BAOS; the engine text-only
    (as JAX's serve runs it) on paths warm and none, eager K=1, graphed
    K=1 and K=8, and the paged pool on warm graphed K=1; its graphed tick
    beside the time its bf16 weights take to read once.  Returns the
    launch counts of the runs."""
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    from repro_torch.serving import EngineConfig, ServingEngine
    total = {}
    t_start = time.perf_counter()

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    def load(arch):
        cfg = base.get_config(arch)
        if arch in DEPTH_CUTS:
            cfg = cut_depth(cfg, DEPTH_CUTS[arch])
        model = build_model(cfg, DEVICE)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _flat(params))
        log(f"{arch} params: {n / 1e9:.3f} B ({n * 2 / 2 ** 30:.2f} GiB "
            f"bf16), init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        return model, params, n

    # whisper-medium
    t_model = time.perf_counter()
    model, params, _ = load("whisper-medium")
    cfg = model.cfg
    frames = torch.randn(4, cfg.n_audio_ctx, cfg.d_model, generator=gen,
                         device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckv = model.cross_kv(params, model.encode(params, frames))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    again = time_ms(lambda: model.cross_kv(params, model.encode(params,
                                                                frames)), 3)
    log(f"whisper-medium encode + cross_kv of (4, {cfg.n_audio_ctx}, "
        f"{cfg.d_model}) frames: first call {first * 1e3:.1f} ms, then "
        f"{again:.2f} ms (CUDA events); cross K/V "
        f"{tuple(ckv[0].shape)} x 2, "
        f"{sum(t.numel() * 2 for t in ckv) / 2 ** 20:.0f} MiB")
    require(all(bool(torch.isfinite(t).all()) for t in ckv),
            "whisper-medium: cross K/V not finite")
    kw1 = {"cross_kv": tuple(t[:, :1].contiguous() for t in ckv)}
    phase_e2e(model, params, gen, kw1)
    for cache_mode in ("dual", "prefix"):
        add(phase_cached(model, params, gen, cache_mode, kw1))
    check_kwargs_in_place(model, params, gen, kw1, {
        "cross_kv": tuple(t[:, 1:2].contiguous() for t in ckv)})
    extra = {"fwd_kw": {"cross_kv": ckv}}
    counts, slot_paths = phase_engine(
        model, params, slowfast=False, names=("warm", "none", "warm+baos"),
        variants=VARIANTS[:2], extra=extra)
    add(counts)
    for refused in (PAGED, dict(megatick_k=8)):
        try:
            ServingEngine(model, params, diffusion.DiffusionConfig(),
                          EngineConfig(num_slots=4, max_seq_len=96,
                                       **extra, **refused))
        except ValueError as e:
            log(f"whisper-medium engine {refused} with cross_kv refused, as "
                f"in JAX: {e}")
        else:
            raise Failure(f"whisper-medium: the engine {refused} took "
                          f"cross_kv")
    add(phase_breakdown(model, params, slot_paths, names=("warm",),
                        variants=BREAKDOWN_VARIANTS[1:], extra=extra))
    del model, params, ckv, kw1, extra, slot_paths, frames
    free()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "whisper-medium", "--full", "--requests",
                        "1"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    require(r.returncode == 0, f"cli whisper-medium: exit {r.returncode}: "
            f"{r.stderr[-2000:]}")
    log(f"cli serve --arch whisper-medium --full: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in r.stdout.splitlines():
        log(f"  {line}")
    log(f"phase 9 whisper-medium: {time.perf_counter() - t_model:.1f} s")

    # internvl2-26b
    t_model = time.perf_counter()
    model, params, n_params = load("internvl2-26b")
    cfg = model.cfg
    image = torch.randn(1, cfg.n_image_tokens, cfg.d_model, generator=gen,
                        device=DEVICE).to(cfg.torch_dtype)
    kw1 = {"image_embeds": image}
    phase_e2e(model, params, gen, kw1, prompt_len=VLM_PROMPT, gen_len=64)
    for cache_mode in ("dual", "prefix"):
        add(phase_cached(model, params, gen, cache_mode, kw1,
                         prompt_len=VLM_PROMPT, gen_len=64))
    free()
    counts, slot_paths = phase_engine(model, params, slowfast=False,
                                      names=("warm", "none"))
    add(counts)
    add(phase_paged(model, params, slot_paths, names=("warm",),
                    variants=VARIANTS[1:2], extras=False))
    floor_ms = n_params * 2 / HBM_BPS * 1e3
    for name in ("warm", "none"):
        info = slot_paths[name]
        log(f"internvl2-26b engine path={name} graphed K=1: tick wall "
            f"median {info['runs']['graphed K=1']['p50']:.2f} ms, device "
            f"busy {info['busy']['graphed K=1']:.3f} ms, against "
            f"{floor_ms:.2f} ms to read its {n_params * 2 / 1e9:.1f} GB of "
            f"bf16 weights once")
    del model, params, image, kw1, slot_paths
    free()
    log(f"phase 9 internvl2-26b: {time.perf_counter() - t_model:.1f} s")
    dt = time.perf_counter() - t_start
    log(f"phase 9: {dt:.1f} s against its budget of {PHASE9_BUDGET_S:.0f} s"
        f"; launches {total}")
    return total


def phase_audio_vlm_process() -> dict:
    """Phase 9 in a process of its own (``phase9_main``): late in one
    process the profiler drops device activities (two whole runs of this
    script lost one flash_bidir launch of a 16-tick window there, while a
    fresh process saw every one), and the phase's engine profiles hold the
    kernels the card ran to the launch counts exactly.  Its output joins
    this log; returns its launch counts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c",
                        "import sys, chip_smoke; "
                        "sys.exit(chip_smoke.phase9_main())"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    counts = None
    for line in r.stdout.splitlines():
        if line.startswith(PHASE9_COUNTS):
            counts = json.loads(line[len(PHASE9_COUNTS):])
        else:
            log(line)
    require(r.returncode == 0 and counts is not None,
            f"phase 9 process: exit {r.returncode}: {r.stderr[-3000:]}")
    return counts


PHASE9_COUNTS = "phase 9 counts "


def phase9_main() -> int:
    """The body of phase 9's process: load the built kernels, run
    ``phase_audio_vlm`` and print its launch counts."""
    from repro_torch import device
    from repro_torch.kernels import _build
    device.resolve("cuda")
    _build.build()
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    try:
        counts = phase_audio_vlm(gen)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(PHASE9_COUNTS + json.dumps(counts), flush=True)
    return 0


def check_kwargs_in_place(model, params, gen, kw_a, kw_b) -> None:
    """The graphed steps read forward kwargs in place and key on their
    addresses: graphed generate() with kw_b's tensors (other frames)
    captures anew and equals the eager run with kw_b; kw_b's values copied
    into kw_a's tensors then replay kw_a's graphs (no capture) and give
    the same tokens (dual + BAOS, 1 x 48)."""
    from repro_torch.core import baos, diffusion
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(
        gen_length=32, block_length=16, steps_per_block=8, cache_mode="dual",
        baos=baos.BAOSConfig(enabled=True, kv_format="mxint4"))
    prompt = torch.randint(0, cfg.vocab - 200, (1, 16), generator=gen,
                           device=DEVICE)
    g = diffusion.step_graphs(model, dcfg, cfg.mask_id, None, 1, 48)
    out_a = diffusion.generate(model, params, prompt, dcfg, seed=7, **kw_a)
    n_a = g.captures
    out_b = diffusion.generate(model, params, prompt, dcfg, seed=7, **kw_b)
    n_b = g.captures
    want = diffusion.generate(model, params, prompt, dcfg, seed=7,
                              jit_steps=False, **kw_b)
    for name, value in kw_b.items():
        for dst, src in zip(kw_a[name], value):
            dst.copy_(src)
    again = diffusion.generate(model, params, prompt, dcfg, seed=7, **kw_a)
    log(f"{cfg.name} forward kwargs in the graphed steps: first frames "
        f"{n_a} graphs, other frames {n_b - n_a} new graphs (tokens equal "
        f"to eager: {bool(torch.equal(out_b, want))}, differ from the first"
        f" frames': {not bool(torch.equal(out_b, out_a))}), the other "
        f"frames copied in place: {g.captures - n_b} new graphs, tokens "
        f"equal: {bool(torch.equal(again, want))}")
    require(n_b > n_a and torch.equal(out_b, want),
            f"{cfg.name}: new forward kwargs replayed a stale graph")
    require(g.captures == n_b and torch.equal(again, want),
            f"{cfg.name}: forward kwargs written in place were not read")


# ---------------------------------------------------------------------------
# phase 10: every sampling format, the random strategy and the simulator
# ---------------------------------------------------------------------------

# the phase's target, stated before its first run on the card
PHASE10_BUDGET_S = 45.0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def no_plain():
    """The sampling kernels' plain versions raise while this is open: a
    run inside it computes its sampling on the kernels alone."""
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.kernels import topk_mask as tk

    def refuse(*_, **__):
        raise Failure("a plain sampling version ran on the card")

    names = ((fhs, "fused_head_stable_max"), (sms, "stable_max_plain"),
             (tk, "topk_mask_plain"), (fhs, "head_shard_partials_plain"),
             (sms, "stablemax_shard_partials_plain"))
    saved = [getattr(m, n) for m, n in names]
    for m, n in names:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)


def check_format_engine(model, params, fmt: str, head_path: str,
                        n_ticks: int = 16) -> dict:
    """The engine's warm path, graphed K=1, for n_ticks ticks of the engine
    trace at sampling format ``fmt`` on ``head_path``: exactly one launch
    of the path's sampling kernel (the fused head, or on the unfused head
    stablemax_sampling) and of topk_mask per tick, flash_bidir once per
    layer and tick, no other kernel, a graph replay per tick, and no plain
    version called.  Returns the launch counts."""
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(
        block_length=16, steps_per_block=8, head_path=head_path,
        sampling=sampling.SamplingConfig(fmt=fmt))
    eng = ServingEngine(model, params, dcfg,
                        EngineConfig(num_slots=4, max_seq_len=96,
                                     mode="warm", jit_steps=True))
    eng.warmup()
    for p, g in engine_trace(cfg):
        eng.submit(Request(prompt=p, gen_length=g))
    step = graph_step(eng)
    replays0 = step.replays
    _build.reset_launch_counts()
    with no_plain():
        for _ in range(n_ticks):
            eng.tick()
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    head = ("fused_head_sampling" if head_path == "fused"
            else "stablemax_sampling")
    want = {name: 0 for name in counts}
    want.update({head: n_ticks, "topk_mask": n_ticks,
                 "flash_bidir": n_ticks * cfg.n_layers})
    what = f"engine warm graphed K=1 {head_path} {fmt}"
    require(eng.ticks_total == n_ticks and
            step.replays - replays0 == n_ticks,
            f"{what}: {eng.ticks_total} ticks, "
            f"{step.replays - replays0} replays")
    require(counts == want, f"{what}: launches {counts} != {want}")
    log(f"{what}: {n_ticks} ticks, {n_ticks} graph replays, launches "
        f"{counts} (exactly one {head} and one topk_mask a tick; no plain "
        f"version ran)")
    del eng
    return counts


def check_random_engine(model, params) -> dict:
    """Strategy 'random' on the engine's warm path over the engine trace:
    eager K=1, graphed K=1 and graphed K=8 (the megatick) must finish every
    request with no mask id left and give equal tokens, per-request ticks,
    CommitEvents and ticks_total, launch exactly the path's kernels (K=8:
    plus the ticks run after a stop) and call no plain version.  Returns
    the summed launch counts."""
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import _build
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(
        block_length=16, steps_per_block=8,
        sampling=sampling.SamplingConfig(strategy="random"))
    trace = engine_trace(cfg)
    expected = path_kernels(model, dcfg, True)
    total = {name: 0 for name in _build.COUNTED}
    runs = {}
    for vname, vcfg in VARIANTS:
        what = f"engine warm random {vname}"
        with no_plain():
            eng, keys, tick_ms, counts, _ = engine_run(
                model, params, dcfg, "warm", trace, True, **vcfg)
        mt = eng._megatick_fn
        require(len(eng.completed) == len(trace),
                f"{what}: requests missing")
        for c in eng.completed:
            require(not bool((c.tokens == cfg.mask_id).any()),
                    f"{what}: request {c.uid} left mask ids")
        expect_launches(counts, expected, what)
        runs[vname] = dict(
            tokens={c.uid: c.tokens.tolist() for c in eng.completed},
            ticks={c.uid: c.ticks for c in eng.completed}, events=keys,
            ticks_total=eng.ticks_total, counts=counts,
            wasted=0 if mt is None else mt.ticks_wasted)
        for name, n in counts.items():
            total[name] += n
        log(f"{what}: {len(eng.completed)} requests, {eng.ticks_total} "
            f"ticks, tick wall median {sorted(tick_ms)[len(tick_ms) // 2]:.2f}"
            f" ms, ticks after a stop {runs[vname]['wasted']}, launches "
            f"{counts}")
        del eng
    ref = runs["eager K=1"]
    per_tick = {k: n // ref["ticks_total"] for k, n in ref["counts"].items()}
    for vname in list(runs)[1:]:
        run = runs[vname]
        for key in ("tokens", "ticks", "events", "ticks_total"):
            require(run[key] == ref[key], f"engine warm random {vname}: "
                                          f"{key} differ from eager K=1")
        want = {k: n + run["wasted"] * per_tick[k]
                for k, n in ref["counts"].items()}
        require(run["counts"] == want, f"engine warm random {vname}: "
                                       f"launches {run['counts']} != {want}")
    log(f"engine warm random: graphed K=1 and K=8 equal eager K=1 in "
        f"tokens, per-request ticks, {len(ref['events'])} CommitEvents and "
        f"ticks_total ({ref['ticks_total']})")
    return total


def check_random_generate(model, params, gen) -> dict:
    """generate() in cache mode dual with BAOS (mxint4 KV) under strategy
    'random': graphed (step graphs) equal to eager, no mask id left,
    exactly the path's kernels launched.  Returns the graphed run's
    launch counts."""
    from repro_torch.core import baos, diffusion, sampling
    from repro_torch.kernels import _build
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(
        gen_length=32, block_length=16, steps_per_block=8,
        cache_mode="dual", baos=baos.BAOSConfig(enabled=True,
                                                 kv_format="mxint4"),
        sampling=sampling.SamplingConfig(strategy="random"))
    prompt = torch.randint(0, cfg.vocab - 200, (1, 16), generator=gen,
                           device=DEVICE)
    what = "generate dual + BAOS, strategy random"
    _build.reset_launch_counts()
    with no_plain():
        out = diffusion.generate(model, params, prompt, dcfg, seed=5)
        torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    eager = diffusion.generate(model, params, prompt, dcfg, seed=5,
                               jit_steps=False)
    greedy = diffusion.generate(model, params, prompt, dataclasses.replace(
        dcfg, sampling=sampling.SamplingConfig()), seed=5)
    require(torch.equal(out, eager), f"{what}: graphed differs from eager")
    require(not bool((out == cfg.mask_id).any()), f"{what}: mask ids left")
    expect_launches(counts, path_kernels(model, dcfg, True), what)
    log(f"{what}: graphed equals eager ({out.shape[1]} tokens, no mask "
        f"id), {int((out != greedy).sum())} tokens differ from the "
        f"stablemax strategy's; launches {counts}")
    diffusion.clear_step_graphs()
    return counts


def check_traces(model, params, stage_ms: dict, card: str) -> None:
    """sim/trace.capture_tick_trace of llada-8b on the meta device at the
    engine's shape (B 4, s_tot 96, L 16) and Table 6's (B 16, s_tot 384,
    L 64), head paths fused, unfused and legacy, cache modes none and
    warm (dual): an eager tick on the card with a Tracer active must
    record the same op list.  Each trace simulated (sim/cycle.simulate at
    the paper's NPU point): its sampling stage in µs a tick beside the
    card's tick_sample at the same shape (CUDA events; at the engine's
    shape also phase 4's profiler device time ``stage_ms``).  Printed, not
    claimed."""
    from repro_torch.core import diffusion
    from repro_torch.sim import cycle, trace
    cfg = model.cfg
    mid, V = cfg.mask_id, cfg.vocab
    for B, S, L, shape in ((4, 96, 16, "engine"), (16, 384, 64, "Table 6")):
        x = torch.randint(0, V - 200, (B, S), generator=torch.Generator(
            device=DEVICE).manual_seed(B), device=DEVICE, dtype=torch.int32)
        x[:, S - L:] = mid
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=DEVICE)
        bs = torch.full((B,), S - L, dtype=torch.int32, device=DEVICE)
        k = torch.full((B,), 2, dtype=torch.int32, device=DEVICE)
        for head_path in ("fused", "unfused", "legacy"):
            for cache_mode in ("none", "dual"):
                dcfg = diffusion.DiffusionConfig(
                    gen_length=L, block_length=L, steps_per_block=8,
                    cache_mode=cache_mode, head_path=head_path)
                t0 = time.perf_counter()
                cap = trace.capture_tick_trace(model, dcfg, B=B, s_tot=S)
                t_cap = time.perf_counter() - t0
                cache = (model.init_cache(B, S) if cache_mode != "none"
                         else None)
                tracer = trace.Tracer()
                diffusion.batched_tick(model, params, x, kv_valid, bs, k, 0,
                                       cache, dcfg, mid, tracer=tracer)
                torch.cuda.synchronize()
                got = [o.to_dict() for o in tracer.finish().ops]
                what = f"trace {shape} {head_path} cache={cache_mode}"
                require(got == [o.to_dict() for o in cap.ops],
                        f"{what}: the tick on the card recorded other ops "
                        f"than the meta capture")
                del cache
                sim = cycle.simulate(cap)
                stages = {n: round(c) for n, c in sim.stage_cycles().items()}
                line = (f"{what}: {len(cap)} ops, meta capture "
                        f"{t_cap:.2f} s, equal to the card's traced eager "
                        f"tick; simulated NPU (paper §6.2 point) "
                        f"{sim.time_s * 1e6:.2f} us a tick, stage cycles "
                        f"{stages}, HBM {sim.hbm_bytes / 1e6:.2f} MB, SRAM "
                        f"peak {sim.sram_peak_bytes / 1e6:.3f} MB")
                if cache_mode == "none":
                    feats, _ = diffusion.tick_forward(
                        model, params, x, kv_valid, bs, None, dcfg)
                    ev = time_ms(lambda: diffusion.tick_sample(
                        params, feats, x, bs, k, 0, dcfg, mid, model), 10)
                    del feats
                    line += (f"; the card's tick_sample {ev * 1e3:.1f} us "
                             f"(CUDA events)")
                    if shape == "engine":
                        line += (f", {stage_ms[head_path] * 1e3:.1f} us "
                                 f"device (phase 4's profiler)")
                log(line + f" [{card}]")
        del x, kv_valid
        torch.cuda.empty_cache()


def phase_formats_random_sim(model, params, gen, stage_ms: dict) -> dict:
    """Phase 10 on llada-8b (the model of phases 3-6): the sampling formats
    end to end (check_format_engine at mxint4 on the fused head and mxint8
    on the unfused head; check_ticks_sampling in both), the random
    strategy (check_random_engine, check_ticks_sampling, check_random_
    generate) and the trace and simulator at full width (check_traces).
    Returns the launch counts of its engine and generate runs."""
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    card = card_line()
    launches = {name: 0 for name in _build.COUNTED}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    base = dict(gen_length=32, block_length=16, steps_per_block=8)
    for fmt, head_path in (("mxint4", "fused"), ("mxint8", "unfused")):
        add(check_format_engine(model, params, fmt, head_path))
        check_ticks_sampling(model, params, gen, diffusion.DiffusionConfig(
            head_path=head_path, sampling=sampling.SamplingConfig(fmt=fmt),
            **base))
    add(check_random_engine(model, params))
    check_ticks_sampling(model, params, gen, diffusion.DiffusionConfig(
        sampling=sampling.SamplingConfig(strategy="random"), **base))
    add(check_random_generate(model, params, gen))
    check_traces(model, params, stage_ms, card)
    dt = time.perf_counter() - t0
    log(f"phase 10: {dt:.1f} s against its budget of {PHASE10_BUDGET_S:.0f}"
        f" s [{card}]; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the training path
# ---------------------------------------------------------------------------

# the phase's target, stated before its first run on the card
PHASE11_BUDGET_S = 75.0
TRAIN_ARCH = "qwen2-0.5b"
PHASE11_COUNTS = "phase 11 counts "


@contextlib.contextmanager
def plain_attention():
    """Check-only switch: attention runs its plain PyTorch version, forward
    and backward under autograd, instead of the kernels."""
    from repro_torch.kernels import flash_bidir as fb
    saved = fb.flash_bidir
    fb.flash_bidir = fb.flash_bidir_plain
    try:
        yield
    finally:
        fb.flash_bidir = saved


def check_train_step(gen) -> dict:
    """(a) One train step of qwen2-0.5b at full width and depth (seeded
    random weights, bf16) at JAX's train.py defaults (B 8, S 128): the
    loss and every parameter's gradient through the kernels (flash_bidir
    forward, flash_bidir_bwd backward, once per layer each), the same step
    with attention's plain version under autograd, and an f32 reference
    (the same weights and draw in f32, plain attention).  Gates: loss
    relative difference <= 1e-3; every leaf's gradient nonzero where
    plain's is (at most 1e-4 of a leaf's elements may round to zero on one
    side only); per leaf, cosine(kernels, plain) >= 0.999 where the plain
    bf16 route itself reaches 0.999 against f32.  Where it does not (the
    query and key projections of the deeper layers at random weights:
    their gradients are differences of near-equal terms, fixed by bf16
    rounding only to 0.987-0.997), two bf16 routes cannot agree to 0.999
    either, and the kernels' cosine against f32 must be at least plain's
    less 0.005.  Returns the step's launch counts."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    cfg = base.get_config(TRAIN_ARCH)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=8, seed=0))
    tokens = torch.from_numpy(corpus.batch(0)).to(DEVICE, torch.int64)

    def loss_grads(model, params):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = diffusion.masked_diffusion_loss(
            model, params, tokens, diffusion.step_generator(0, 0, DEVICE))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def timed(model, params):
        loss_grads(model, params)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = loss_grads(model, params)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_build.launch_counts)

    model = build_model(cfg, DEVICE)
    params = model.init(seed=0)
    names = [k for k, _ in tree_lib.flatten_with_paths(params)]
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), DEVICE)
    params32 = tree_lib.tree_map(lambda p: p.detach().float(), params)
    with plain_attention():
        _, grads32 = loss_grads(model32, params32)
    del params32
    (loss_k, grads_k), wall_k, counts = timed(model, params)
    want = {n: 0 for n in counts}
    want.update(flash_bidir=cfg.n_layers, flash_bidir_bwd=cfg.n_layers)
    require(counts == want, f"train step launches {counts}, want {want}")
    with plain_attention():
        (loss_p, grads_p), wall_p, plain_counts = timed(model, params)
    require(not any(plain_counts.values()),
            f"plain attention launched {plain_counts}")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.reshape(1, -1), b.reshape(1, -1)))

    worst_kp, worst_f32, n_f32 = (2.0, ""), (2.0, ""), 0
    for name, gk, gp, g32 in zip(names, grads_k, grads_p, grads32):
        gk, gp = gk.float(), gp.float()
        lost = int(((gp != 0) & (gk == 0)).sum())
        require(not (gp.any() and not gk.any()),
                f"train step: the gradient of {name} is zero through the "
                f"kernels and not through plain attention")
        require(lost <= 1e-4 * gp.numel(),
                f"train step: {name} has {lost} zero gradients where plain "
                f"attention's are nonzero")
        if not gp.any():
            continue
        c_kp, c_k32, c_p32 = cos(gk, gp), cos(gk, g32), cos(gp, g32)
        if c_p32 >= 0.999:
            worst_kp = min(worst_kp, (c_kp, name))
            require(c_kp >= 0.999, f"train step: {name} cosine(kernels, "
                                   f"plain) {c_kp:.6f} < 0.999")
        else:
            n_f32 += 1
            worst_f32 = min(worst_f32, (c_k32 - c_p32, name))
            require(c_k32 >= c_p32 - 0.005,
                    f"train step: {name} cosine to f32 {c_k32:.6f} through "
                    f"the kernels, {c_p32:.6f} through plain attention")
    log(f"phase 11a: {TRAIN_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.n_heads} q heads on "
        f"{cfg.n_kv_heads}, V {cfg.vocab}, {cfg.dtype}), B 8 x S 128, loss "
        f"and {len(names)} gradients: kernels loss {float(loss_k):.6f} in "
        f"{wall_k * 1e3:.1f} ms (flash_bidir and flash_bidir_bwd "
        f"{cfg.n_layers} launches each), plain attention under autograd "
        f"{float(loss_p):.6f} in {wall_p * 1e3:.1f} ms; loss relative "
        f"difference {rel:.3g}; worst cosine(kernels, plain) "
        f"{worst_kp[0]:.6f} ({worst_kp[1]}) over the {len(names) - n_f32} "
        f"leaves plain fixes to 0.999 of f32; on the other {n_f32} the "
        f"kernels' cosine to f32 less plain's is at worst "
        f"{worst_f32[0]:+.6f} ({worst_f32[1]})")
    require(rel <= 1e-3, f"train step loss differs by {rel:.3g} (> 1e-3)")
    del grads_p, grads32
    # where the step's time goes: the loss and gradients by kernel class
    # (profiler), then AdamW over every parameter (CUDA events)
    by_class = {}
    for name, (ms, _) in device_kernels(lambda: loss_grads(model, params),
                                        2).items():
        key = name.lower()
        cls = ("flash_bidir_bwd" if "flash_bidir_bwd" in key else
               kernel_class(name))
        by_class[cls] = by_class.get(cls, 0.0) + ms
    opt_cfg = adamw.OptConfig(lr=3e-4, schedule="cosine")
    state = adamw.init_state(params)
    opt_ms = time_ms(lambda: adamw.apply_updates(params, grads_k, state,
                                                 opt_cfg), 3)
    log(f"phase 11a: the kernels' loss and gradients, device ms by class "
        f"(profiler): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1]))
        + f" ({sum(by_class.values()):.2f} in all); AdamW over "
        f"{sum(p.numel() for p in tree_lib.leaves(params)) / 1e6:.1f} M "
        f"parameters in {len(names)} leaves {opt_ms:.2f} ms (CUDA events)")
    del params, grads_k, state
    free()
    return counts


def check_train_run() -> dict:
    """(b) 20 steps through launch/train.main at full size, a checkpoint
    every 5 and a failure injected at step 7: restarts=1 and every loss
    finite; a --resume from the step-15 checkpoint replays steps 16-20
    with bit-identical losses.  Returns the run's launch counts."""
    import shutil
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    root = SERVE_DIR / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--arch", TRAIN_ARCH, "--full", "--device", DEVICE, "--steps",
              "20", "--batch", "8", "--seq", "128", "--ckpt-every", "5"]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    first = train.main(common + ["--ckpt-dir", str(root / "a"),
                                 "--inject-failure-at", "7"])
    t_first = time.perf_counter() - t0
    losses = first["losses"]
    require(first["restarts"] == 1, f"restarts={first['restarts']}")
    require(len(losses) == 22 and all(map(math.isfinite, losses)),
            f"20 steps with a restart gave losses {losses}")
    (root / "b").mkdir(parents=True)
    os.replace(root / "a" / "step_00000015", root / "b" / "step_00000015")
    shutil.rmtree(root / "a")
    ckpt_bytes = sum(f.stat().st_size
                     for f in (root / "b" / "step_00000015").iterdir())
    t0 = time.perf_counter()
    again = train.main(common + ["--ckpt-dir", str(root / "b"), "--resume"])
    t_again = time.perf_counter() - t0
    # keep the step-15 checkpoint for phase 13c's elastic restore (it
    # deletes it); the resumed run's step 20 goes
    shutil.rmtree(root / "b" / "step_00000020", ignore_errors=True)
    require(again["losses"] == losses[-5:],
            f"resumed steps 16-20 {again['losses']} != {losses[-5:]}")
    steps = sorted(first["step_s"][1:])
    med = steps[len(steps) // 2]
    log(f"phase 11b: 20 steps with a failure at step 7: restarts=1, 22 "
        f"losses finite ({losses[0]:.4f} -> {losses[-1]:.4f}), {t_first:.1f}"
        f" s with 5 checkpoints of "
        f"{ckpt_bytes / 2 ** 30:.2f} GiB; resumed from step 15: "
        f"steps 16-20 bit for bit, {t_again:.1f} s; step wall median "
        f"{med * 1e3:.2f} ms (steps 2-22), {8 * 128 / med:.0f} tokens/s, "
        f"peak memory {(first['peak_bytes'] or 0) / 2 ** 30:.2f} GiB")
    return dict(_build.launch_counts)


def check_packed_quarot(gen) -> None:
    """(c) Table 5's storage at llada-8b's cache shape (4, 96, 32, 128)
    bf16: unpack(pack(x)) equals mx_fake_quant(x) bit for bit in mxint4
    and mxint8, the packed bytes equal packed_bytes; QuaRot keeps QKᵀ
    within 1e-5 of max|QKᵀ| (f32, TF32 off)."""
    from repro_torch.core import mx, packed, quarot
    shape = (4, 96, 32, 128)
    x = (torch.randn(shape, generator=gen, device=DEVICE) * torch.rand(
        1, 1, 32, 128, generator=gen, device=DEVICE) * 4).bfloat16()
    for fmt in ("mxint4", "mxint8"):
        p = packed.pack(x, fmt)
        same = torch.equal(packed.unpack(p, dtype=torch.bfloat16),
                           mx.mx_fake_quant(x, fmt))
        fn = lambda: packed.unpack(packed.pack(x, fmt),  # noqa: E731
                                   dtype=torch.bfloat16)
        log(f"phase 11c: packed {fmt} {shape} bf16: unpack(pack(x)) == "
            f"mx_fake_quant(x) bit for bit: {same}; {p.nbytes} bytes "
            f"(packed_bytes {packed.packed_bytes(shape, fmt)}, "
            f"{packed.compression_ratio(shape, fmt):.2f}x below bf16); "
            f"pack + unpack {time_ms(fn, 5):.3f} ms (CUDA events)")
        require(same, f"packed {fmt}: unpack(pack(x)) != mx_fake_quant(x)")
        require(p.nbytes == packed.packed_bytes(shape, fmt),
                f"packed {fmt}: {p.nbytes} bytes")
    q, k = (torch.randn(shape, generator=gen, device=DEVICE)
            for _ in range(2))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s_r = torch.einsum("bqhd,bkhd->bhqk", quarot.rotate(q), quarot.rotate(k))
    err = float((s_r - s).abs().max())
    log(f"phase 11c: QuaRot (Hadamard 128, seed 0) Q_r K_rᵀ against QKᵀ at "
        f"{shape} f32: max abs err {err:.3g} (max |QKᵀ| "
        f"{float(s.abs().max()):.3g})")
    require(err <= 1e-5 * float(s.abs().max()),
            "QuaRot moved QKᵀ beyond 1e-5 of its largest value")


def phase_train(gen) -> dict:
    """Phase 11: (a) the train step against plain attention, phase 13a
    (the step builder's train step), (b) the 20-step run with a failure
    and a resume, (c) packed storage and QuaRot.  Returns the launch
    counts of (a), 13a and (b)."""
    t0 = time.perf_counter()
    counts = check_train_step(gen)
    t13 = time.perf_counter()
    for name, n in check_steps_train().items():
        counts[name] += n
    t13 = time.perf_counter() - t13
    for name, n in check_train_run().items():
        counts[name] += n
    check_packed_quarot(gen)
    dt = time.perf_counter() - t0 - t13
    log(f"phase 11: {dt:.1f} s against its budget of {PHASE11_BUDGET_S:.0f}"
        f" s (phase 13a's {t13:.1f} s apart)")
    return counts


def phase_train_process() -> dict:
    """Phase 11 in a process of its own, as phase 9: it loads a model of
    its own, and its launch counts and profiles start clean.  Its output
    joins this log; returns its launch counts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c",
                        "import sys, chip_smoke; "
                        "sys.exit(chip_smoke.phase11_main())"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    counts = None
    for line in r.stdout.splitlines():
        if line.startswith(PHASE11_COUNTS):
            counts = json.loads(line[len(PHASE11_COUNTS):])
        elif not note_phase13(line):
            log(line)
    require(r.returncode == 0 and counts is not None,
            f"phase 11 process: exit {r.returncode}: {r.stderr[-3000:]}")
    return counts


def phase11_main() -> int:
    """The body of phase 11's process."""
    from repro_torch import device
    from repro_torch.kernels import _build
    device.resolve("cuda")
    _build.build()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    try:
        counts = phase_train(gen)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(PHASE11_COUNTS + json.dumps(counts), flush=True)
    return 0

# ---------------------------------------------------------------------------
# the two kernel routes of phase 12 (in phase 2) and phase 12
# ---------------------------------------------------------------------------

def route_a_case(h, w_full, n: int, shard: int, suppress_id, what: str):
    """Route A on shard ``shard`` of ``n`` of the head w_full (d, V) padded
    by pad_head_for_mesh, against its plain version: m and the global
    index equal, s within 1e-6 relative.  Returns (shard, kwargs, max abs
    err of s, max relative err of s)."""
    from repro_torch.core import sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    V = w_full.shape[1]
    wp = sampling.pad_head_for_mesh(w_full, n)
    vloc = wp.shape[1] // n
    ws = wp[:, shard * vloc:(shard + 1) * vloc].contiguous()
    kw = dict(fmt="mxfp8_e4m3", col_offset=shard * vloc, col_limit=V,
              suppress_id=suppress_id)
    m_k, i_k, s_k = fhs.head_shard_partials(h, ws, **kw)
    m_p, i_p, s_p = fhs.head_shard_partials_plain(h, ws, **kw)
    torch.cuda.synchronize()
    err = (s_k - s_p).abs()
    rel = float((err / s_p.clamp(min=1e-30)).max())
    log(f"route A {what}: shard {shard} of {n}, V_loc {vloc}, "
        f"{fhs.shard_columns(vloc, shard * vloc, V)} valid columns: m "
        f"differs in {int((m_k != m_p).sum())} rows, the index in "
        f"{int((i_k != i_p).sum())}, s max rel err {rel:.3g}")
    require(torch.equal(m_k, m_p) and torch.equal(i_k, i_p),
            f"route A {what}: m or the global index differ from plain")
    require(rel <= 1e-6, f"route A {what}: s rel err {rel:.3g} > 1e-6")
    return ws, kw, float(err.max()), rel


def check_route_a(gen) -> dict:
    """Route A, the fused head's vocab-shard entry (the SPMD tick's head):
    llada-8b's head on 2 shards, shard 1, at (64, 4096) bf16 mxfp8 greedy
    (the engine tick's rows), and padded heads: V 1003 on 2 shards (shard
    1 holds 491 valid columns of 512) and V 257 on 4 (shard 3 is pad
    only), each against its plain version; its device time (a graph of
    20) beside its byte bound, the plain version's and torch.matmul on the
    shard."""
    from repro_torch.kernels import fused_head_sampling as fhs
    d = LLADA["d"]
    for V, n, shard, R in ((1003, 2, 1, 24), (257, 4, 3, 8), (257, 4, 0, 8)):
        w = random_head(dict(d=d, V=V), gen)
        h = torch.randn(R, d, generator=gen, device=DEVICE).bfloat16()
        route_a_case(h, w, n, shard, V - 1, f"({R}, {d}) @ ({d}, {V})")
    w = random_head(LLADA, gen)
    h = torch.randn(64, d, generator=gen, device=DEVICE).bfloat16()
    what = f"(64, {d}) @ llada-8b's head"
    ws, kw, err, rel = route_a_case(h, w, 2, 1, LLADA["mask_id"], what)
    del w
    R, vloc = h.shape[0], ws.shape[1]
    b_ms, b_by = bound(R * d * 2 + d * vloc * 2 + R * 12,
                       2.0 * R * d * vloc, BF16_FLOPS)
    fn = lambda: fhs.head_shard_partials(h, ws, **kw)  # noqa: E731
    lib = lambda: torch.matmul(h, ws)  # noqa: E731
    row = dict(max_abs_err=err, device_ms=kernel_ms(fn, 20, "route A"),
               ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: fhs.head_shard_partials_plain(
                   h, ws, **kw), 3),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=kernel_ms(lib, 20, "route A torch.matmul"))
    log(f"route A {what}, shard 1 of 2 ({d}, {vloc}) bf16 mxfp8: device "
        f"{row['device_ms']:.4f} ms (a graph of 20 calls; partials + "
        f"merge), CUDA events, back to back {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{row['device_ms'] / b_ms:.2f}x; torch.matmul on the shard device "
        f"{row['library_ms']:.4f} ms")
    return row


# recurrentgemma-2b's vocabulary and mask id (the route C shapes)
RGEMMA = dict(V=256000, mask_id=255999)


def route_c_case(z, n: int, shard: int, fmt: str, suppress_id, what: str):
    """Route C on shard ``shard`` of ``n`` of the logits z (R, V), V / n a
    multiple of 32, against its plain version (sampling.local_partials
    with global indices): m equal and the global index equal (off a
    near-tie of the quantized shard, at most 1% of rows), s within 1e-2
    relative (the kernel's exponentials are ex2.approx, as
    stablemax_sampling's).  Returns (shard logits, kwargs, max abs err of
    s, max relative err of s)."""
    from repro_torch.kernels import stablemax_sampling as sms
    R, V = z.shape
    vloc = V // n
    zs = z[:, shard * vloc:(shard + 1) * vloc].contiguous()
    kw = dict(fmt=fmt, col_offset=shard * vloc, suppress_id=suppress_id)
    m_k, i_k, s_k = sms.stablemax_shard_partials(zs, **kw)
    m_p, i_p, s_p = sms.stablemax_shard_partials_plain(zs, **kw)
    torch.cuda.synchronize()
    diff = torch.nonzero(i_k != i_p).flatten().tolist()
    if diff:
        from repro_torch.core import mx, sampling
        zq = mx.mx_fake_quant(zs[diff], fmt).float()
        if 0 <= suppress_id - shard * vloc < vloc:
            zq[:, suppress_id - shard * vloc] = sampling.NEG_INF
        require(all(near_ties(zq, i_k[diff] - shard * vloc, 0.0, 0, diff)),
                f"route C {what}: the index differs off a near-tie in rows "
                f"{diff}")
    same = i_k == i_p
    err = (s_k - s_p).abs()[same]
    rel = float((err / s_p[same].clamp(min=1e-30)).max())
    log(f"route C {what}: shard {shard} of {n}, V_loc {vloc}, {fmt}: m "
        f"differs in {int((m_k != m_p).sum())} rows, the index in "
        f"{len(diff)}, s max rel err {rel:.3g}")
    require(torch.equal(m_k[same], m_p[same]) and len(diff) <= 0.01 * R,
            f"route C {what}: m or the global index differ from plain")
    require(rel <= 1e-2, f"route C {what}: s rel err {rel:.3g} > 1e-2")
    return zs, kw, float(err.max()), rel


def check_route_c(gen) -> dict:
    """Route C, Stable-Max's vocab-shard entry (the decode step's sampling
    over a vocab-sharded head of a model without a head mode):
    recurrentgemma-2b's logits (64, 256000) bf16 on 2 shards (shard 1
    holds the mask id; shard 0 does not) in every sampling format, an f32
    shard of 4, and (3, 1024) on 2 with a tie across the shards'
    boundary and a suppressed larger logit, each against its plain
    version; at (64, 128000) bf16 mxfp8 its device time (a graph of 20)
    beside its byte bound, the plain version's and softmax + max on the
    shard."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import stablemax_sampling as sms
    R, V, mid = 64, RGEMMA["V"], RGEMMA["mask_id"]
    z = (torch.randn(R, V, generator=gen, device=DEVICE) * 3).bfloat16()
    for fmt in ALL_FMTS:
        for shard in (0, 1):
            route_c_case(z, 2, shard, fmt, mid, f"({R}, {V}) bf16")
    route_c_case(z.float(), 4, 3, "mxfp8_e4m3", mid, f"({R}, {V}) f32")
    zs = torch.randn(3, 1024, generator=gen, device=DEVICE) * 3
    zs[:, 511] = zs[:, 512] = 20.0
    zs[:, 515] = 30.0
    for shard in (0, 1):
        route_c_case(zs.bfloat16(), 2, shard, "mxfp8_e4m3", 515,
                     "(3, 1024) bf16, tie at columns 511/512")
    what = f"({R}, {V}) bf16 shard 1 of 2"
    zl, kw, err, rel = route_c_case(z, 2, 1, "mxfp8_e4m3", mid, what)
    del z
    vloc = zl.shape[1]
    b_ms, b_by = bound(zl.numel() * 2 + R * 12, 4.0 * zl.numel(), F32_FLOPS)
    fn = lambda: sms.stablemax_shard_partials(zl, **kw)  # noqa: E731
    lib = lambda: torch.max(torch.softmax(zl, -1), -1)  # noqa: E731
    row = dict(max_abs_err=err, device_ms=kernel_ms(fn, 20, "route C"),
               ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: sms.stablemax_shard_partials_plain(
                   zl, "mxfp8_e4m3", col_offset=vloc, suppress_id=mid), 5),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=kernel_ms(lib, 20, "route C softmax + max"))
    log(f"route C {what} mxfp8 greedy: device {row['device_ms']:.4f} ms "
        f"(a graph of 20 calls; partials + merge), CUDA events, back to "
        f"back {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {row['device_ms'] / b_ms:.2f}x; softmax "
        f"+ max on the shard device {row['library_ms']:.4f} ms; plan "
        f"{sms.vocab_plan(vloc, R, _build.sm_count(zl.device))}")
    return row


# the sampled shard entries' phase-2 point: T and the global row of row 0
SAMPLED_T, SAMPLED_ROW0 = 0.8, 192


def sampled_case(kern, plain, z_of, col0: int, what: str, s_rel: float):
    """A sampled shard entry (route A or C) against its plain version, both
    called already: (m, idx, s, best, z_at) each.  m equal; the global
    index equal off a near-tie of the Gumbel scores (at most 1% of rows;
    ``z_of(rows)`` gives those rows' quantized f32 logits of the shard);
    on agreeing rows best and z_at equal and s within ``s_rel``
    relative.  Returns (max abs err of s, max relative err of s)."""
    m_k, i_k, s_k, b_k, z_k = kern
    m_p, i_p, s_p, b_p, z_p = plain
    torch.cuda.synchronize()
    diff = torch.nonzero(i_k != i_p).flatten().tolist()
    R = m_k.shape[0]
    if diff:
        require(all(near_ties(z_of(diff), i_k[diff] - col0, SAMPLED_T, 4321,
                              [SAMPLED_ROW0 + r for r in diff], col0)),
                f"{what}: the index differs off a near-tie in rows {diff}")
    same = i_k == i_p
    err = (s_k - s_p).abs()[same]
    rel = float((err / s_p[same].clamp(min=1e-30)).max())
    log(f"{what}: m differs in {int((m_k != m_p).sum())} rows, the index "
        f"in {len(diff)}, best in {int((b_k != b_p)[same].sum())} of the "
        f"agreeing rows, z_at in {int((z_k != z_p)[same].sum())}, s max rel "
        f"err {rel:.3g}")
    require(torch.equal(m_k, m_p) and len(diff) <= 0.01 * R and
            torch.equal(b_k[same], b_p[same]) and
            torch.equal(z_k[same], z_p[same]),
            f"{what}: m, best or z_at differ from plain")
    require(rel <= s_rel, f"{what}: s rel err {rel:.3g} > {s_rel}")
    return float(err.max()), rel


def check_sampled_routes(gen):
    """The sampled decode step's shard entries at T 0.8 and a row offset
    (SAMPLED_ROW0: the noise drawn at global rows), bf16 mxfp8 with a seed
    tensor: route A on llada-8b's head, shard 1 of 2 ((64, 4096) @ (4096,
    63232)), and route C on recurrentgemma-2b's logits, shard 1 of 2 ((64,
    128000)), each against its plain version (``sampled_case``); first the
    single-device fused head and Stable-Max at the same row offset against
    theirs.  Each entry's device time (a graph of 20) beside its bound,
    the plain version's and the greedy row's library call (torch.matmul on
    the shard; softmax + max).  Returns the two kernel-table rows."""
    from repro_torch.core import sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    seed = sampling.seed_tensor(4321, DEVICE)
    T, row0, fmt = SAMPLED_T, SAMPLED_ROW0, "mxfp8_e4m3"
    d, R, V, mid = LLADA["d"], 64, LLADA["V"], LLADA["mask_id"]
    w = random_head(LLADA, gen)
    h = torch.randn(R, d, generator=gen, device=DEVICE).bfloat16()
    # the single-device entries at a row offset
    kw = dict(suppress_id=mid, temperature=T, seed=seed, row_offset=row0)
    conf_k, tok_k = fhs.fused_head_sampling(h, w, fmt=fmt, **kw)
    conf_p, tok_p = fhs.fused_head_stable_max(h, w, fmt, **kw)
    diff = torch.nonzero(tok_k != tok_p).flatten().tolist()
    if diff:
        require(all(near_ties(head_logits_f32(h[diff], w, fmt, mid),
                              tok_k[diff], T, 4321,
                              [row0 + r for r in diff])),
                f"fused head at row offset {row0}: tokens differ off a "
                f"near-tie in rows {diff}")
    same = tok_k == tok_p
    rel = float(((conf_k - conf_p).abs() / conf_p.abs())[same].max())
    log(f"fused_head bf16 ({R}, {d}) @ llada-8b's head {fmt} T={T} row "
        f"offset {row0}: rows differing {len(diff)}/{R}, conf max rel err "
        f"{rel:.3g}")
    require(len(diff) <= 0.01 * R and rel <= 1e-2,
            f"fused head at row offset {row0} differs from plain")
    # route A, sampled
    wp = sampling.pad_head_for_mesh(w, 2)
    vloc = wp.shape[1] // 2
    ws = wp[:, vloc:].contiguous()
    del w, wp
    kwa = dict(fmt=fmt, col_offset=vloc, col_limit=V, suppress_id=mid,
               temperature=T, seed=seed, row_offset=row0)
    what = f"route A sampled ({R}, {d}) @ ({d}, {vloc}) shard 1 of 2"
    err_a, _ = sampled_case(
        fhs.head_shard_partials(h, ws, **kwa),
        fhs.head_shard_partials_plain(h, ws, **kwa),
        lambda rows: head_logits_f32(h[rows], ws, fmt, mid - vloc), vloc,
        what, 1e-6)
    b_ms, b_by = bound(R * d * 2 + d * vloc * 2 + R * 20,
                       2.0 * R * d * vloc, BF16_FLOPS)
    fn = lambda: fhs.head_shard_partials(h, ws, **kwa)  # noqa: E731
    row_a = dict(max_abs_err=err_a, device_ms=kernel_ms(fn, 20, what),
                 ms=time_ms(fn, 20),
                 plain_ms=time_ms(lambda: fhs.head_shard_partials_plain(
                     h, ws, **kwa), 3),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=kernel_ms(lambda: torch.matmul(h, ws), 20,
                                      "route A sampled torch.matmul"))
    log(f"{what} bf16 {fmt} T={T}: device {row_a['device_ms']:.4f} ms (a "
        f"graph of 20 calls; partials + merge), CUDA events, back to back "
        f"{row_a['ms']:.4f} ms, plain {row_a['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {row_a['device_ms'] / b_ms:.2f}x; "
        f"torch.matmul on the shard {row_a['library_ms']:.4f} ms")
    del ws, h
    # Stable-Max at a row offset, then route C, sampled
    Vr, mid_r = RGEMMA["V"], RGEMMA["mask_id"]
    z = (torch.randn(R, Vr, generator=gen, device=DEVICE) * 3).bfloat16()
    for zz, tag in ((z, "bf16"), (z[:3, :1003].float(), "f32 (3, 1003)")):
        k_c, k_t = sms.stablemax_sampling(zz.contiguous(), fmt=fmt,
                                          suppress_id=17, temperature=T,
                                          seed=seed, row_offset=row0)
        p_c, p_t = sms.stable_max_plain(zz.contiguous(), fmt, suppress_id=17,
                                        temperature=T, seed=seed,
                                        row_offset=row0)
        diff = torch.nonzero(k_t != p_t).flatten().tolist()
        if diff:
            require(all(near_ties(quantized_f32(zz[diff], fmt, 17),
                                  k_t[diff], T, 4321,
                                  [row0 + r for r in diff])),
                    f"stablemax at row offset {row0} {tag}: tokens differ "
                    f"off a near-tie in rows {diff}")
        same = k_t == p_t
        rel = float(((k_c - p_c).abs() / p_c.abs())[same].max())
        log(f"stablemax_sampling {tag} {fmt} T={T} row offset {row0}: "
            f"rows differing {len(diff)}/{zz.shape[0]}, conf max rel err "
            f"{rel:.3g}")
        require(len(diff) <= 0.01 * zz.shape[0] and rel <= 1e-2,
                f"stablemax at row offset {row0} {tag} differs from plain")
    vr = Vr // 2
    zl = z[:, vr:].contiguous()
    del z
    kwc = dict(fmt=fmt, col_offset=vr, suppress_id=mid_r, temperature=T,
               seed=seed, row_offset=row0)
    what = f"route C sampled ({R}, {vr}) shard 1 of 2"
    err_c, _ = sampled_case(
        sms.stablemax_shard_partials(zl, **kwc),
        sms.stablemax_shard_partials_plain(zl, **kwc),
        lambda rows: quantized_f32(zl[rows], fmt, mid_r - vr), vr, what,
        1e-2)
    # per logit: the greedy row's 4 f32 operations, then the draw's two
    # logarithms, a division and an addition
    b_ms, b_by = bound(zl.numel() * 2 + R * 20, 8.0 * zl.numel(), F32_FLOPS)
    fn = lambda: sms.stablemax_shard_partials(zl, **kwc)  # noqa: E731
    row_c = dict(max_abs_err=err_c, device_ms=kernel_ms(fn, 20, what),
                 ms=time_ms(fn, 20),
                 plain_ms=time_ms(lambda: sms.stablemax_shard_partials_plain(
                     zl, **kwc), 5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=kernel_ms(
                     lambda: torch.max(torch.softmax(zl, -1), -1), 20,
                     "route C sampled softmax + max"))
    log(f"{what} bf16 {fmt} T={T}: device {row_c['device_ms']:.4f} ms (a "
        f"graph of 20 calls; partials + merge), CUDA events, back to back "
        f"{row_c['ms']:.4f} ms, plain {row_c['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {row_c['device_ms'] / b_ms:.2f}x; "
        f"softmax + max on the shard {row_c['library_ms']:.4f} ms")
    return row_a, row_c


def check_route_b(gen) -> dict:
    """Route B, flash_bidir over the cache and a second K/V source: the
    split refine's shape on llada-8b, q (16, 64, 32, 128) over a 384-key
    cache (its stale copy of the block at 128..191 masked) and the 64-key
    active buffer, with BAOS; a window, a masked buffer key and GQA at a
    small shape; the f32 route.  Each within one bf16 ulp + 1e-6 of its
    plain version (f32: 1e-5 of max |out|).  Its device time beside its
    bound, the plain version's and SDPA on the concatenated K/V."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_bidir as fb

    def case(B, Sq, Skv, Hq, Hkv, D, off, win, dtype, valid2_cut):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
        q, kk, v = r(B, Sq, Hq, D), r(B, Skv, Hkv, D), r(B, Skv, Hkv, D)
        k2, v2 = r(B, Sq, Hkv, D), r(B, Sq, Hkv, D)
        pos = torch.arange(Skv, device=DEVICE)
        valid = ~((pos >= off) & (pos < off + Sq))[None].expand(B, Skv)
        valid = valid.contiguous()
        valid2 = None
        if valid2_cut:
            valid2 = (torch.arange(Sq, device=DEVICE)[None] < Sq - 3
                      ).expand(B, Sq).contiguous()
        cal = [torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
               torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
               torch.randn(B, Hkv, D, generator=gen, device=DEVICE)]
        args = (q, kk, v, valid, *cal)
        kw = dict(window=win, q_offset=off, extra_kv=(k2, v2, valid2))
        got = fb.flash_bidir(*args, **kw)
        want = fb.flash_bidir_plain(*args, **kw)
        err = (got.float() - want.float()).abs()
        what = (f"route B {str(dtype).replace('torch.', '')} q ({B}, {Sq}, "
                f"{Hq}, {D}) on {Hkv} KV heads over {Skv} + {Sq} keys, block "
                f"at {off}, window {win}, buffer keys masked "
                f"{3 if valid2_cut else 0}")
        if dtype == torch.bfloat16:
            excess = float((err - bf16_ulp(want)).max())
            log(f"{what}: max abs err {float(err.max()):.3g}, beyond one "
                f"bf16 ulp {excess:.3g}")
            require(excess <= 1e-6, f"{what}: beyond one bf16 ulp + 1e-6")
        else:
            top = float(want.abs().max())
            log(f"{what}: max abs err {float(err.max()):.3g} (max |out| "
                f"{top:.3g})")
            require(float(err.max()) <= 1e-5 * top,
                    f"{what}: beyond 1e-5 of max |out|")
        return args, kw, float(err.max())

    case(2, 16, 80, 8, 2, 64, 32, 9, torch.bfloat16, True)
    case(2, 16, 80, 8, 2, 64, 32, 9, torch.float32, True)
    args, kw, err = case(16, 64, 384, 32, 32, 128, 128, None,
                         torch.bfloat16, False)
    q, kk, v, valid = args[:4]
    k2, v2, _ = kw["extra_kv"]
    B, Sq, Hq, D = q.shape
    n_keys = int(valid.sum()) + B * Sq
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * n_keys * kk.shape[2] * D * 2
                       + valid.numel() + 3 * B * kk.shape[2] * D * 4,
                       4.0 * Hq * Sq * n_keys * D, BF16_FLOPS)
    qt = q.transpose(1, 2)
    kt = torch.cat([kk, k2], 1).transpose(1, 2)
    vt = torch.cat([v, v2], 1).transpose(1, 2)
    mask = torch.cat([valid, torch.ones((B, Sq), dtype=torch.bool,
                                        device=DEVICE)], 1)[:, None, None]
    fn = lambda: fb.flash_bidir(*args, **kw)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    row = dict(max_abs_err=err, device_ms=kernel_ms(fn, 20, "route B"),
               ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: fb.flash_bidir_plain(*args, **kw),
                                5),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=kernel_ms(lib, 20, "route B sdpa"))
    log(f"route B at the split refine's shape: device {row['device_ms']:.4f}"
        f" ms a call (a graph of 20), CUDA events, back to back "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {row['device_ms'] / b_ms:.1f}x; "
        f"scaled_dot_product_attention on the concatenated K/V device "
        f"{row['library_ms']:.4f} ms")
    return row


def phase_mesh(model, params, slot_paths) -> dict:
    """Phase 12a: llada-8b on a (1, 1) mesh, a one-rank NCCL group in this
    process: the engine's warm and none paths eager K=1, graphed K=1 and
    graphed K=8 (the tick, collectives included, one CUDA graph), each
    equal to phase 4's run of the same path without a mesh in tokens,
    per-request ticks, CommitEvents and ticks; every tick run exactly one
    launch of route A and one of topk_mask, the single-device head never,
    and no plain version.  Returns the launch counts."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    mesh = mesh_lib.make_debug_mesh(1, 1, DEVICE)
    require(mesh.backend == "nccl" and mesh.capturable,
            f"a one-rank mesh on the card runs {mesh.backend}, not NCCL")
    log(f"phase 12a: {mesh}")
    trace = engine_trace(model.cfg)
    launches = {name: 0 for name in _build.COUNTED}
    paths = {name: (mode, dcfg) for name, mode, dcfg, _ in
             engine_paths(model)}
    for name in ("warm", "none"):
        mode, dcfg = paths[name]
        per_tick = slot_paths[name]["per_tick"]
        for vname, vcfg in VARIANTS:
            what = f"mesh (1, 1) engine path={name} {vname}"
            ref = slot_paths[name]["runs"][vname]
            with no_plain():
                eng, keys, tick_ms, counts, _ = engine_run(
                    model, params, dcfg, mode, trace, True, mesh=mesh,
                    **vcfg)
            done = eng.completed
            require({c.uid: c.tokens.tolist() for c in done} ==
                    ref["tokens"], f"{what}: tokens differ without a mesh")
            require({c.uid: c.ticks for c in done} == ref["ticks"],
                    f"{what}: per-request ticks differ")
            require(keys == ref["events"], f"{what}: CommitEvents differ")
            require(eng.ticks_total == ref["ticks_total"],
                    f"{what}: ticks differ")
            mt = eng._megatick_fn
            n_run = eng.ticks_total + (0 if mt is None else mt.ticks_wasted)
            want = {k: 0 for k in counts}
            want.update(fused_head_sampling_shard=n_run, topk_mask=n_run,
                        flash_bidir=per_tick["flash_bidir"] * n_run)
            require(counts == want, f"{what}: launches {counts} != {want}")
            step = graph_step(eng)
            p50 = float(np.median(tick_ms))
            log(f"{what}: equal to the run without a mesh ({len(done)} "
                f"requests, {eng.ticks_total} ticks, {len(keys)} "
                f"CommitEvents); {n_run} ticks run, one route A and one "
                f"topk_mask launch each, no plain version; tick wall median "
                f"{p50:.2f} ms (without a mesh {ref['sink_p50']:.2f}); graph "
                f"replays {0 if step is None else step.replays}")
            for k, n in counts.items():
                launches[k] += n
            del eng
    mesh_lib.destroy()
    log(f"phase 12a: {time.perf_counter() - t0:.1f} s")
    return launches


TABLE6 = dict(B=16, prompt=128, gen=256, block=64, steps=16)


def phase_split_cache(model, params, gen) -> dict:
    """Phase 12c: llada-8b generate in dual mode + BAOS mxint4 at Table
    6's shape through the split cache (``init_cache(act_len=64)``, as JAX's
    tests/test_split_cache.py sets it): one refine's logits within 5% of
    the largest logit of the unified cache's; generate eager and graphed
    (twice: the second captures nothing), graphed equal to eager, no mask
    id left, each refine launching route B once a layer and the warm
    steps flash_bidir; step wall and tokens/s.  Returns the launch counts
    of the eager and the second graphed run."""
    import functools
    from repro_torch.core import baos, diffusion
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    cfg = model.cfg
    B, P, G, L, T = (TABLE6[k] for k in ("B", "prompt", "gen", "block",
                                         "steps"))
    dcfg = diffusion.DiffusionConfig(
        gen_length=G, block_length=L, steps_per_block=T, cache_mode="dual",
        baos=baos.BAOSConfig(enabled=True, kv_format="mxint4"))
    prompt = torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    x = torch.cat([prompt, torch.full((B, G), cfg.mask_id, device=DEVICE,
                                      dtype=torch.int32)], 1)
    # JAX's bound is for its test's KV format, mxint8; mxint4 (the
    # generate runs') is printed beside it
    for fmt in ("mxint8", "mxint4"):
        dc = dataclasses.replace(dcfg, baos=baos.BAOSConfig(
            enabled=True, kv_format=fmt))
        logits = {}
        for split in (False, True):
            cache = model.init_cache(B, P + G, act_len=L if split else None)
            diffusion.warm_step(model, params, x, cache, P, dc)
            lg, _ = diffusion.refine_step(model, params, x, cache, P, dc)
            logits[split] = lg.float()
            del cache, lg
        err = float((logits[True] - logits[False]).abs().max())
        top = float(logits[False].abs().max())
        del logits
        log(f"split cache, BAOS {fmt}: one refine's logits (B {B}, L {L}) "
            f"max abs err {err:.4g} against the unified cache's, "
            f"{err / top * 100:.2f}% of the largest logit {top:.4g}"
            + (" (bound 5%)" if fmt == "mxint8" else ""))
        require(fmt != "mxint8" or err < 0.05 * top,
                "split cache: a refine's logits beyond 5% of the unified "
                "cache's largest logit")
    n_steps = (G // L) * T
    want_split = (G // L) * (T - 1) * cfg.n_layers
    orig = model.init_cache
    diffusion.clear_step_graphs()
    model.init_cache = functools.partial(orig, act_len=L)
    runs, total = {}, {name: 0 for name in _build.COUNTED}
    try:
        for name, jit in (("eager", False), ("graphed, capturing", True),
                          ("graphed", True)):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = diffusion.generate(model, params, prompt, dcfg,
                                     jit_steps=jit)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(_build.launch_counts)
            runs[name] = out
            what = f"split cache generate dual + BAOS mxint4 {name}"
            require(not bool((out[:, P:] == cfg.mask_id).any()),
                    f"{what}: mask ids left")
            if name != "graphed, capturing":
                require(counts["flash_bidir_split"] == want_split and
                        counts["flash_bidir"] == (G // L) * cfg.n_layers,
                        f"{what}: launches {counts}")
                for k, n in counts.items():
                    total[k] += n
            graphs = diffusion.step_graphs(model, dcfg, cfg.mask_id, None,
                                           B, P + G)
            log(f"{what}: step wall {dt / n_steps * 1e3:.2f} ms, "
                f"{B * G / dt:.1f} tokens/s ({n_steps} steps, {dt:.2f} s), "
                f"graphs captured {graphs.captures}, launches {counts}")
        require("k_act" in graphs.cache, "split cache: the graphed steps' "
                                         "cache has no active buffer")
        for name in ("graphed, capturing", "graphed"):
            require(torch.equal(runs[name], runs["eager"]),
                    f"split cache generate {name} != eager")
    finally:
        model.init_cache = orig
        diffusion.clear_step_graphs()
    log(f"phase 12c: {time.perf_counter() - t_phase:.1f} s")
    return total


PHASE12B_ARG = "--phase12b"
PHASE12B_COUNTS = "phase 12b counts "
PHASE12B_LAYERS = 4


def phase_mesh_ranks() -> dict:
    """Phase 12b's job, with phase 13c: two ranks sharing the card,
    launched by torch.distributed.run (``phase12b_main`` in each).  Rank 0's output
    joins this log; returns the launch counts of both ranks' mesh runs
    (summed by rank 0)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2",
                        str(ROOT / "chip_smoke.py"), PHASE12B_ARG],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    total = None
    for line in r.stdout.splitlines():
        if line.startswith(PHASE12B_COUNTS):
            total = json.loads(line[len(PHASE12B_COUNTS):])
        elif not note_phase13(line):
            log(line)
    require(r.returncode == 0 and total is not None,
            f"phase 12b job: exit {r.returncode}: {job_errors(r.stderr)}")
    log(f"phase 12b + 13c (two ranks, their own job): "
        f"{time.perf_counter() - t0:.1f} s")
    return total


class CollectiveClock:
    """Wall ms spent in torch.distributed's all_reduce and all_gather,
    each call between two device syncs (so the work queued before it is
    not counted), while ``on``."""

    def __init__(self):
        import torch.distributed as dist
        self.ms, self._saved = 0.0, {}
        for name in ("all_reduce", "all_gather"):
            fn = getattr(dist, name)
            self._saved[name] = fn
            setattr(dist, name, self._timed(fn))

    def _timed(self, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def close(self):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def record_ticks(model, params, dcfg, trace, **cfg):
    """The one-rank engine (warm, eager, no mesh; ``cfg`` more
    EngineConfig fields) over ``trace``, with each tick's inputs (canvas,
    kv_valid, block starts, k) and output canvas on the host.  Returns
    (completed tokens by uid, the records)."""
    from repro_torch.core import diffusion
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(model, params, dcfg, EngineConfig(
        num_slots=4, max_seq_len=96, mode="warm", jit_steps=False, **cfg))
    eng.warmup()
    recs, inner = [], diffusion.batched_tick

    def tick(model_, params_, x, kv_valid, bs, k, *a, **kw):
        out = inner(model_, params_, x, kv_valid, bs, k, *a, **kw)
        recs.append(tuple(t.to("cpu", copy=True)
                          for t in (x, kv_valid, bs, k, out[0])))
        return out

    diffusion.batched_tick = tick
    try:
        done = eng.run([Request(prompt=p, gen_length=g) for p, g in trace])
    finally:
        diffusion.batched_tick = inner
    return {c.uid: c.tokens.tolist() for c in done}, recs


def live_canvas(x, kv_valid):
    """The canvas at the positions of rows bound to a request (whose
    kv_valid spans more than the one key an idle row keeps), -1
    elsewhere: an idle row's canvas is not a result, and the two pools
    hold it differently (the paged pool maps it to the null page)."""
    kv_valid = kv_valid.to(x.device)
    live = kv_valid & (kv_valid.sum(1, keepdim=True) > 1)
    return torch.where(live, x, -1)


def near_tie_divergence(model, params, dcfg, rec, got) -> list:
    """At the first tick where a mesh run's canvas ``got`` differs from
    the one-rank run's (``rec``: that tick's inputs and output): each
    differing position, which must lie in its row's active block and be
    a near-tie of the one-rank run's quantized f32 logits: two committed
    tokens whose logits lie within 1e-2 of the row's largest, or a
    position committed by one run and not the other whose confidence lies
    within 1e-2 relative of the top-k boundary.  Returns [(row, position,
    kind)]."""
    from repro_torch.core import diffusion
    x, kv, bs, k, want = (t.to(DEVICE) for t in rec)
    want, got = live_canvas(want, kv), live_canvas(got.to(DEVICE), kv)
    B, S = x.shape
    L, mid = dcfg.block_length, model.cfg.mask_id
    cache = model.init_cache(B, S)
    feats, _ = diffusion.tick_forward(model, params, x, kv, bs, cache, dcfg)
    cols = bs.long()[:, None] + torch.arange(L, device=DEVICE)
    rows = torch.arange(B, device=DEVICE)[:, None]
    h = feats[rows, cols].reshape(B * L, -1)
    z = head_logits_f32(h, params["lm_head"], dcfg.sampling.fmt,
                        mid).view(B, L, -1)
    conf = 1.0 / torch.exp(z - z.amax(-1, keepdim=True)).sum(-1)
    out = []
    for i, p in torch.nonzero(got != want).tolist():
        l = p - int(bs[i])
        require(0 <= l < L, f"mesh run: position {p} of row {i} differs "
                            f"outside the active block")
        a, b = int(want[i, p]), int(got[i, p])
        if a != mid and b != mid:
            zmax = float(z[i, l].max())
            ok = abs(float(z[i, l, a] - z[i, l, b])) <= 1e-2 * abs(zmax)
            kind = "token"
        else:
            masked = x[i, cols[i]] == mid
            n_commit = int(masked.sum()) - int(
                (want[i, cols[i]] == mid).sum())
            kth = float(conf[i][masked].sort(descending=True).values[
                max(n_commit, 1) - 1])
            ok = abs(float(conf[i, l]) - kth) <= 1e-2 * kth
            kind = "transfer"
        require(ok, f"mesh run: row {i} position {p} differs off a "
                    f"near-tie ({kind})")
        out.append((i, p, kind))
    return out


def mesh_engine_run(model, params, dcfg, trace, mesh, **cfg):
    """The warm engine over ``mesh`` (eager; ``cfg`` more EngineConfig
    fields) on ``trace``, the sampling kernels alone (``no_plain``):
    (engine, each tick's canvas on the host (``live_canvas``), tick walls
    ms, each tick's collective ms, launch counts)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    eng = ServingEngine(model, params, dcfg, EngineConfig(
        num_slots=4, max_seq_len=96, mode="warm", mesh=mesh,
        jit_steps=False, **cfg))
    eng.warmup()
    _build.reset_launch_counts()
    for p, g in trace:
        eng.submit(Request(prompt=p, gen_length=g))
    clock = CollectiveClock()
    snaps, coll, wall = [], [], []
    try:
        with no_plain():
            while eng.pending:
                clock.ms = 0.0
                t0 = time.perf_counter()
                eng.tick()
                wall.append((time.perf_counter() - t0) * 1e3)
                coll.append(clock.ms)
                snaps.append(live_canvas(eng.x, eng.kv_valid).cpu())
    finally:
        clock.close()
    return eng, snaps, wall, coll, dict(_build.launch_counts)


def phase12b_main() -> int:
    """One rank of phase 12b (torch.distributed.run, two ranks on the one
    card): meshes (1, 2) and (2, 1) over gloo, llada-8b at full width and
    PHASE12B_LAYERS layers, the engine's warm path eager on the slot pool
    and on the paged pool (PAGED: each rank gathers, ticks and scatters
    its data shard's slots), each tick's canvas against the one-rank run's
    (rank 0; the one-rank paged run's canvases equal its slot run's), any
    difference a recorded near-tie, and the paged run's canvases equal
    the slot run's on the same mesh; per tick one route A and one
    topk_mask launch and no plain version; each tick's collective time;
    then phase 13c (``phase13c``).  Prints its launch counts."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import device
    from repro_torch.configs import base
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.registry import build_model
    device.resolve(DEVICE)
    _build.build()
    try:
        meshes = [mesh_lib.make_debug_mesh(1, 2, DEVICE),
                  mesh_lib.make_debug_mesh(2, 1, DEVICE)]
        rank = meshes[0].rank
        say = log if rank == 0 else (lambda *a: None)
        for mesh in meshes:
            require(mesh.backend == "gloo" and not mesh.capturable,
                    f"{mesh}: two ranks on one card must run gloo")
        say(f"phase 12b: {meshes[0]} and {meshes[1]} (rank 0's view): "
            f"gloo, the ranks share the card, so the ticks run eagerly")
        cfg = base.get_config("llada-8b")
        if rank == 0:
            cfg = cut_depth(cfg, PHASE12B_LAYERS, "for two ranks sharing "
                            "the card and the script's time limit")
        else:
            cfg = dataclasses.replace(cfg, n_layers=PHASE12B_LAYERS)
        model = build_model(cfg, meshes[0].device)
        params = model.init(seed=0)
        dcfg = [d for n, _, d, _ in engine_paths(model) if n == "warm"][0]
        trace = engine_trace(cfg)
        if rank == 0:
            ref_tokens, recs = record_ticks(model, params, dcfg, trace)
            paged_tokens, paged_recs = record_ticks(model, params, dcfg,
                                                    trace, **PAGED)
            require(paged_tokens == ref_tokens and len(paged_recs) ==
                    len(recs) and all(
                        torch.equal(a[1], b[1]) and torch.equal(
                            live_canvas(a[4], a[1]), live_canvas(b[4], b[1]))
                        for a, b in zip(recs, paged_recs)),
                    "phase 12b: the one-rank paged run's canvases differ "
                    "from its slot run's")
            say(f"phase 12b: the one-rank run: {len(recs)} ticks, the "
                f"paged pool's canvases equal the slot pool's (live rows)")
        dist.barrier()
        total = {name: 0 for name in _build.COUNTED}
        for mesh in meshes:
            slot_snaps = None
            for pool, cfg_pool in (("slot", {}), ("paged", PAGED)):
                what = (f"mesh {tuple(mesh.shape.values())} engine "
                        f"path=warm {pool} pool eager")
                eng, snaps, wall, coll, counts = mesh_engine_run(
                    model, params, dcfg, trace, mesh, **cfg_pool)
                n = eng.ticks_total
                require(counts["fused_head_sampling_shard"] == n and
                        counts["topk_mask"] == n and
                        counts["fused_head_sampling"] == 0,
                        f"{what}: launches {counts} for {n} ticks")
                for c in eng.completed:
                    require(not bool((c.tokens[c.prompt_len:] ==
                                      cfg.mask_id).any()),
                            f"{what}: request {c.uid} left mask ids")
                for k, v in counts.items():
                    total[k] += v
                if pool == "slot":
                    slot_snaps = snaps
                else:
                    require(len(snaps) == len(slot_snaps) and all(
                        torch.equal(a, b) for a, b in zip(snaps,
                                                          slot_snaps)),
                            f"{what}: a canvas differs from the slot "
                            f"pool's on the same mesh")
                if rank == 0:
                    ties, first = [], None
                    for t, (rec, got) in enumerate(zip(recs, snaps)):
                        if not torch.equal(live_canvas(rec[4], rec[1]),
                                           got):
                            first = t
                            ties = near_tie_divergence(model, params, dcfg,
                                                       rec, got)
                            break
                    same = {c.uid: c.tokens.tolist()
                            for c in eng.completed} == ref_tokens
                    require(first is not None or (same and len(snaps) ==
                                                  len(recs)),
                            f"{what}: the runs differ with no differing "
                            f"tick")
                    say(f"{what}: {n} ticks, every canvas equal to the "
                        f"one-rank run's" if first is None else
                        f"{what}: {n} ticks; the canvases first differ at "
                        f"tick {first}, at recorded near-ties {ties} (the "
                        f"runs part there; every request still finishes)")
                    say(f"{what}: "
                        + ("every canvas equal to the slot pool's on this "
                           "mesh; " if pool == "paged" else "")
                        + f"tick wall median {np.median(wall):.2f} ms, "
                        f"collectives per tick median {np.median(coll):.3f}"
                        f" ms, max {max(coll):.3f} ms (all_reduce + "
                        f"all_gather between device syncs); launches "
                        f"{counts}")
                del eng
                dist.barrier()
        for k, v in phase12d(meshes[1], rank, say, model, params,
                             dcfg).items():
            total[k] += v
        free()
        for k, v in phase13c(meshes, rank, say, model, params).items():
            total[k] += v
        # both ranks' counts, summed on the host over gloo, printed once
        names = sorted(total)
        both = torch.tensor([total[k] for k in names], dtype=torch.int64)
        dist.all_reduce(both)
        total = dict(zip(names, both.tolist()))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    if rank == 0:
        print(PHASE12B_COUNTS + json.dumps(total), flush=True)
    mesh_lib.destroy()
    return 0


# phase 12d's load: requests, prompt and generation lengths, and the rate
PHASE12D = dict(n=16, prompt=32, gen=32, rate=50.0, slots=4)


def phase12d(mesh, rank: int, say, model, params, dcfg) -> dict:
    """Phase 12d, in phase 12b's two-rank job: ``serve --http``'s frontend
    (``build_frontend(mesh=(2, 1))``, gloo, eager ticks) for phase 12b's
    llada-8b (full width, PHASE12B_LAYERS layers), warm path.  Rank 0
    serves on 127.0.0.1 and ``loadgen.run_load`` sends PHASE12D's streamed
    requests, then two gathered ones, then a graceful drain; rank 1
    follows rank 0's engine calls (serving/frontend/router.MeshFollower).
    Gates: every request completes with no mask id left; each rank's
    tokens and ticks per request equal rank 0's, bit for bit; rank 0's
    tokens equal the one-rank frontend's (``build_frontend`` with no mesh,
    graphed, as phase 6c runs it) on the same prompts; a tick launches one
    route A and one topk_mask on each rank.  Prints TTFT p50, tokens/s and
    the control broadcast's ms per tick.  Returns this rank's launch
    counts."""
    import asyncio

    import numpy as np
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.serving.frontend import build_frontend, loadgen
    t0 = time.perf_counter()
    P, G = PHASE12D["prompt"], PHASE12D["gen"]
    cfg = model.cfg

    def serve(m):
        done = {}

        def on_complete(c):
            done[tuple(c.tokens[:c.prompt_len].tolist())] = (
                c.tokens.tolist(), int(c.ticks))
        fe = build_frontend(model, params, dcfg, model_name=cfg.name,
                            replicas=1, num_slots=PHASE12D["slots"],
                            max_seq_len=P + G, mode="warm",
                            max_queue=4 * PHASE12D["n"], mesh=m,
                            on_complete=on_complete)
        if m is not None and m.rank != 0:
            _build.reset_launch_counts()
            fe.run()
            w = fe.workers[0]
            return done, None, w.engine.ticks_total, dict(
                _build.launch_counts), None

        async def go():
            await fe.start()
            try:
                rep = await loadgen.run_load(
                    fe.url, rate=PHASE12D["rate"], n_requests=PHASE12D["n"],
                    prompt_len=P, max_tokens=G, seed=12)
                rs = np.random.RandomState(13)
                rows = await asyncio.gather(*[loadgen.complete(
                    fe.url, rs.randint(0, cfg.vocab - 200, size=(P,))
                    .tolist(), G, stream=False) for _ in range(2)])
            finally:
                await fe.shutdown(drain=True)
            return rep, rows
        _build.reset_launch_counts()
        rep, rows = asyncio.run(go())
        counts = dict(_build.launch_counts)
        w = fe.router.workers[0]
        require(rep["completed"] == PHASE12D["n"] and all(
            r["status"] == "ok" for r in rows),
            f"phase 12d: {rep['completed']} of {PHASE12D['n']} requests "
            f"completed, gathered {[r['status'] for r in rows]}")
        return done, rep, w.engine.ticks_total, counts, w.control

    done, rep, ticks, counts, ctl = serve(mesh)
    every = [None] * mesh.size
    dist.all_gather_object(every, (done, ticks, counts))
    if rank == 0:
        for r, (d, t, c) in enumerate(every):
            require(d == done and t == ticks,
                    f"phase 12d: rank {r}'s tokens or ticks differ from "
                    f"rank 0's ({t} ticks vs {ticks})")
            require(c["fused_head_sampling_shard"] == t and
                    c["topk_mask"] == t and c["fused_head_sampling"] == 0,
                    f"phase 12d: rank {r} launched {c} in {t} ticks")
        for toks, _ in done.values():
            require(cfg.mask_id not in toks[P:],
                    "phase 12d: a request left mask ids")
        ref, _, _, _, _ = serve(None)
        differ = [k for k in done if ref.get(k, (None,))[0] != done[k][0]]
        require(set(ref) == set(done) and not differ,
                f"phase 12d: rank 0's tokens differ from the one-rank "
                f"frontend's in {len(differ)} of {len(done)} requests")
        say(f"phase 12d: serve --http over {mesh} (gloo, eager): "
            f"{len(done)} requests ({PHASE12D['n']} streamed at "
            f"{PHASE12D['rate']:g} req/s, 2 gathered; prompt {P}, gen {G}, "
            f"{PHASE12D['slots']} slots) completed, no mask left; every "
            f"rank's tokens and ticks per request equal rank 0's; rank 0's "
            f"tokens equal the one-rank frontend's; {ticks} ticks, each one "
            f"route A and one topk_mask launch on each rank; TTFT p50 "
            f"{rep['ttft_p50_s'] * 1e3:.1f} ms, p99 "
            f"{rep['ttft_p99_s'] * 1e3:.1f} ms, goodput "
            f"{rep['goodput_tok_s']:.1f} tokens/s; the control broadcast "
            f"{ctl.seconds * 1e3 / max(ticks, 1):.3f} ms per tick "
            f"({ctl.records} records, {ctl.seconds * 1e3:.1f} ms in all, "
            f"{ctl.seconds * 1e3 / max(ctl.records, 1):.3f} ms each); "
            f"{card_line()}; {time.perf_counter() - t0:.1f} s")
    dist.barrier()
    return counts


def kernel_attrs() -> list:
    """(library, kernel, static shared bytes, registers, dynamic shared
    bytes of its largest launch) of every instantiation each library
    launches: cudaFuncGetAttributes through the library's
    ``<name>_kernel_attrs``."""
    import ctypes
    from repro_torch.kernels import _build
    out = []
    for lib in _build.KERNELS:
        count = _build.function(lib, f"{lib}_kernel_count", [])
        attrs = _build.function(lib, f"{lib}_kernel_attrs", [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
            + [ctypes.POINTER(ctypes.c_int)] * 3)
        for i in range(count()):
            name = ctypes.c_char_p()
            st, regs, dyn = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = attrs(i, ctypes.byref(name), ctypes.byref(st),
                        ctypes.byref(regs), ctypes.byref(dyn))
            require(err == 0, f"{lib}: cudaFuncGetAttributes of entry {i} "
                              f"failed ({err})")
            label = name.value.decode()
            if label.startswith("(") and label.endswith(")"):
                label = label[1:-1]
            out.append((lib, label, st.value, regs.value, dyn.value))
    return out


def phase_analysis(mesh) -> None:
    """The static-analysis gate's card-only checks (repro_torch.analysis):
    every kernel instantiation's shared memory per block (static, from
    cudaFuncGetAttributes, plus the dynamic request of its largest
    launch) at most sm_90's 232,448 bytes and equal to ANL-SMEM-BUDGET's
    figure (analysis/registry.smem_specs), instantiation for
    instantiation; then ANL-RECAPTURE: the graphs phase 4's graphed
    engines captured over their traces, and the representative engine
    shape trace (graph_audit.recapture_trace: mixed k_req, both stop
    flags, fresh seeds, the megatick alone and on ``mesh``, the K=1 tick
    at two batch shapes), each within registry.RECAPTURE_BOUNDS."""
    from repro_torch.analysis import graph_audit, registry, smem_budget
    t0 = time.perf_counter()
    got = kernel_attrs()
    want = {(sp.library, sp.kernel): sp for sp in registry.smem_specs()}
    require(sorted(want) == sorted((lib, k) for lib, k, *_ in got),
            "ANL-SMEM-BUDGET: the attribute tables and the registry list "
            "different instantiations")
    worst = (0, "")
    for lib, k, st, regs, dyn in got:
        sp = want[(lib, k)]
        require(st == sp.static_bytes and dyn == sp.dynamic_bytes,
                f"ANL-SMEM-BUDGET: {lib}::{k} has {st} + {dyn} B of "
                f"shared memory on the card, the registry states "
                f"{sp.static_bytes} + {sp.dynamic_bytes}")
        require(st + dyn <= registry.SMEM_LIMIT_BYTES,
                f"ANL-SMEM-BUDGET: {lib}::{k} needs {st + dyn} B")
        worst = max(worst, (st + dyn, f"{lib}::{k}"))
    vs, _ = smem_budget.check_smem()
    require(not vs, f"ANL-SMEM-BUDGET: {vs}")
    log(f"analysis: shared memory per block of {len(got)} kernel "
        f"instantiations (cudaFuncGetAttributes + the launch's dynamic "
        f"request) equal to ANL-SMEM-BUDGET's, each <= "
        f"{registry.SMEM_LIMIT_BYTES} B; the largest {worst[1]} "
        f"{worst[0]} B; " + "; ".join(
            f"{lib}::{k} {st}+{dyn} B {regs} regs"
            for lib, k, st, regs, dyn in got))
    engines = {kind: max(n) for kind, n in ENGINE_CAPTURES.items()}
    require(engines, "ANL-RECAPTURE: phase 4 ran no graphed engine")
    vs = graph_audit.recapture_violations(engines)
    require(not vs, f"ANL-RECAPTURE: phase 4's engines: {vs}")
    vs, info = graph_audit.check_recapture(DEVICE, mesh)
    require(info["run"] and not vs, f"ANL-RECAPTURE: {vs or info}")
    log(f"analysis: ANL-RECAPTURE: phase 4's graphed engines captured at "
        f"most {engines} graphs each ({sum(map(len, ENGINE_CAPTURES.values()))}"
        f" engines); the representative shape trace "
        f"{info['captures']}; bounds {info['bounds']}; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the step builders (launch/steps.py) on the card and over a mesh
# ---------------------------------------------------------------------------

# the phase's target, seconds (13a + 13b + 13c), stated before its first
# run on the card
PHASE13_BUDGET_S = 60.0
# qwen2-0.5b's depth in the two-rank train step (two f32 copies and a
# one-rank reference on one card, and gloo moves every gradient through
# the host)
PHASE13C_LAYERS = 4
# the checkpoint phase 11b keeps for phase 13c's elastic restore
TRAIN_CKPT, TRAIN_CKPT_STEP = SERVE_DIR / "train_ckpt" / "b", 15
# a sub-phase run in another process prints its seconds on a line that
# starts so; the main process gathers them into PHASE13_S
PHASE13_SECONDS = "phase 13 seconds "
PHASE13_S = {}


def note_phase13(line: str) -> bool:
    """Whether ``line`` is a sub-phase's seconds (then kept in
    PHASE13_S)."""
    if line.startswith(PHASE13_SECONDS):
        PHASE13_S.update(json.loads(line[len(PHASE13_SECONDS):]))
        return True
    return False


@contextlib.contextmanager
def all_plain():
    """Check-only switch: every kernel wrapper of a tick runs its plain
    PyTorch version on the card (attention, BAOS, Stable-Max, top-k)."""
    from repro_torch.kernels import baos_mx_quant as bmq
    from repro_torch.kernels import flash_bidir as fb
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.kernels import topk_mask as tk

    def baos(x, center, scale, fmt="mxint4", out=None):
        y = bmq.baos_mx_quant_plain(x, center, scale, fmt)
        return y if out is None else out.copy_(y)

    def stablemax(logits, *, fmt="none", suppress_id=None, temperature=0.0,
                  seed=0, row_offset=0):
        return sms.stable_max_plain(logits, fmt, temperature=temperature,
                                    seed=seed, suppress_id=suppress_id,
                                    row_offset=row_offset)

    swaps = ((fb, "flash_bidir", fb.flash_bidir_plain),
             (bmq, "baos_mx_quant", baos),
             (sms, "stablemax_sampling", stablemax),
             (tk, "topk_mask", tk.topk_mask_plain))
    saved = [getattr(m, n) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), f in zip(swaps, saved):
            setattr(m, n, f)


def clone_tree(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.tree_map(lambda t: t.detach().clone()
                             if isinstance(t, torch.Tensor) else t, tree)


def train_batch(cfg):
    """JAX's train.py defaults, B 8 x S 128: batch 0 of the corpus."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=128,
                                        global_batch=8, seed=0))
    return torch.from_numpy(corpus.batch(0)).to(DEVICE, torch.int32)


def check_steps_train() -> dict:
    """Phase 13a, in phase 11's process: qwen2-0.5b at full width and
    depth, B 8 x S 128, bf16.  ``build_step(train)`` equals
    ``launch/train.make_train_step`` on the same draw bit for bit (the
    loss and every updated parameter); with ``loss_chunk=64`` the loss is
    within 1e-6 relative; the same step on a (1, 1) NCCL mesh equals no
    mesh bit for bit; ``compressed_psum`` over that mesh's data axis on
    the step's full gradients (the second call, whose error state is the
    first's residual): each leaf dequant(quant(g + e)) and the error (g +
    e) - that, bit for bit, and its time.  Each step launches
    flash_bidir and flash_bidir_bwd once a layer.  Returns the launch
    counts."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, train
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, compress
    t_phase = time.perf_counter()
    cfg = base.get_config(TRAIN_ARCH)
    model = build_model(cfg, DEVICE)
    tokens = train_batch(cfg)
    opt = train.opt_config(TRAIN_ARCH, 20, 3e-4)
    shape = base.ShapeConfig("train", 128, 8, "train")
    params0 = model.init(seed=0)
    mesh = mesh_lib.make_debug_mesh(1, 1, DEVICE)
    require(mesh.backend == "nccl", f"{mesh} does not run NCCL")
    counts = {name: 0 for name in _build.COUNTED}
    runs = {}
    for name in ("make_train_step", "build_step", "build_step, mesh (1, 1)"):
        params = clone_tree(params0)
        state = adamw.init_state(params)
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "make_train_step":
            met = train.make_train_step(model, opt, 0)(params, state, tokens,
                                                       0)
        else:
            step, _ = steps.build_step(
                model, shape, opt_cfg=opt,
                mesh=mesh if "mesh" in name else None)
            _, _, met = step(params, state, tokens, 0, {})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = dict(_build.launch_counts)
        want = {k: 0 for k in c}
        want.update(flash_bidir=cfg.n_layers, flash_bidir_bwd=cfg.n_layers)
        require(c == want, f"phase 13a {name}: launches {c}, want {want}")
        for k, n in c.items():
            counts[k] += n
        runs[name] = (float(met["loss"]), params, dt)
        del state
    ref_loss, ref_params, _ = runs["make_train_step"]
    for name in ("build_step", "build_step, mesh (1, 1)"):
        loss, p, dt = runs[name]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(p), tree_lib.leaves(ref_params)))
        log(f"phase 13a: {name} train step of {TRAIN_ARCH} (B 8 x S 128): "
            f"loss {loss:.7f} against make_train_step's {ref_loss:.7f}, "
            f"every updated parameter equal: {same}; {dt * 1e3:.1f} ms "
            f"(the first call of its kind)")
        require(loss == ref_loss and same,
                f"phase 13a: {name} differs from make_train_step")
    del runs, ref_params, p
    free()
    met, grads = steps.build_grad_fn(model)(params0, tokens, 0, {})
    met_c, _ = steps.build_grad_fn(model, policy=steps.ServePolicy(
        loss_chunk=64))(params0, tokens, 0, {})
    rel = abs(float(met_c["loss"]) - float(met["loss"])) / abs(
        float(met["loss"]))
    log(f"phase 13a: loss_chunk=64 loss {float(met_c['loss']):.7f}, "
        f"unchunked {float(met['loss']):.7f}, relative difference "
        f"{rel:.3g} (bound 1e-6)")
    require(rel <= 1e-6, f"phase 13a: the chunked loss differs by {rel:.3g}")
    _build.reset_launch_counts()
    grads = tree_lib.unflatten(params0, [g.detach() for g in grads])
    axis = mesh.axis("data")
    _, err = compress.compressed_psum(grads, axis,
                                      compress.init_error(params0))
    red, new_err = compress.compressed_psum(grads, axis, err)
    worst = 0
    for g, e, r, ne in zip(tree_lib.leaves(grads), tree_lib.leaves(err),
                           tree_lib.leaves(red), tree_lib.leaves(new_err)):
        gf = g.float() + e
        q, sc = compress._quant_int8(gf)
        deq = compress._dequant_int8(q, sc, gf.shape)
        require(torch.equal(r, deq) and torch.equal(ne, gf - deq),
                "phase 13a: compressed_psum over (1, 1) is not "
                "dequant(quant(g + e)) with the residual as its error")
        worst = max(worst, float((gf - deq).abs().max() / sc.max()))
    n = sum(g.numel() for g in tree_lib.leaves(grads))
    ms = time_ms(lambda: compress.compressed_psum(grads, axis, err), 3)
    log(f"phase 13a: compressed_psum over {mesh}'s data axis on the step's "
        f"{len(tree_lib.leaves(grads))} gradient leaves ({n / 1e6:.1f} M "
        f"values): each leaf dequant(quant(g + e)), the error the residual, "
        f"bit for bit; largest |residual| / scale {worst:.3f} (at most "
        f"0.5); {ms:.2f} ms a call (CUDA events, one NCCL all_reduce of "
        f"{n * 4 / 2 ** 20:.0f} MiB)")
    mesh_lib.destroy()
    del params0, grads, red, new_err, err
    free()
    dt = time.perf_counter() - t_phase
    log(f"phase 13a: {dt:.1f} s")
    print(PHASE13_SECONDS + json.dumps({"13a": dt}), flush=True)
    return counts


def step_near_ties(z, err, before, got, want, k, mid) -> list:
    """Where a decode step's block ``got`` differs from the plain run's
    ``want`` (both (B, L), from the block ``before``): each position must
    be a near-tie of the plain run's quantized f32 logits ``z`` (B, L, V),
    given ``err`` (B,), each row's largest difference between the two
    runs' logits (their forwards differ: attention's kernel against its
    plain version, 32 bf16 layers deep): two committed tokens whose
    logits lie within 2 err + 1e-2 of the row's largest logit of each
    other, or a position committed by one run and not the other whose
    confidence lies within 2 (e^(2 err) - 1) + 1e-2 relative of the
    row's k-th (a confidence moves by at most e^(2 err) - 1 relative when
    every logit moves by err).  Returns [(row, position, kind)]."""
    conf = 1.0 / torch.exp(z - z.amax(-1, keepdim=True)).sum(-1)
    out = []
    for i, l in torch.nonzero(got != want).tolist():
        a, b = int(want[i, l]), int(got[i, l])
        e = float(err[i])
        if a != mid and b != mid:
            zmax = float(z[i, l].max())
            ok = abs(float(z[i, l, a] - z[i, l, b])) <= 2 * e + 1e-2 * abs(
                zmax)
            kind = "token"
        else:
            masked = before[i] == mid
            kth = float(conf[i][masked].sort(descending=True).values[
                int(k[i]) - 1])
            ok = abs(float(conf[i, l]) - kth) <= (
                2 * math.expm1(2 * e) + 1e-2) * kth
            kind = "transfer"
        require(ok, f"decode step: row {i} position {l} differs off a "
                    f"near-tie ({kind})")
        out.append((i, l, kind))
    return out


def phase_steps_serve(model, params, gen) -> dict:
    """Phase 13b, beside phase 12c: llada-8b at full width and depth,
    ``build_step(prefill)`` then ``build_step(decode)`` at Table 6's
    shape (B 16, s_tot 384, block 64 at 128) under ``ServePolicy()``
    (dual, BAOS mxint4, sampling mxfp8) and ``ServePolicy(split_cache=
    True)``.  The decode step's canvas equals ``diffusion.refine_step`` +
    ``sampling.sampling_step`` on the same prefilled cache with every
    kernel replaced by its plain version, tokens equal off recorded
    near-ties; exact launches a step (prefill: flash_bidir once and
    baos_mx_quant twice a layer, K and V; decode: flash_bidir once and
    baos_mx_quant twice a layer, or with the split cache route B once a
    layer, then one stablemax_sampling and one topk_mask), no plain
    version; ms a step.  Against the plain sampling stage on the step's
    own logits the canvas is equal off 1e-2 near-ties; against the whole
    plain refine the near-tie rule (``step_near_ties``) widens by the two
    forwards' measured difference of the quantized logits, and their raw
    logits must lie within 5% of the largest (JAX's split-cache bound,
    phase 12c).  Returns the launch counts."""
    import numpy as np
    from repro_torch.configs import base
    from repro_torch.core import diffusion, sampling
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    t_phase = time.perf_counter()
    cfg = model.cfg
    nl, mid = cfg.n_layers, cfg.mask_id
    B, P, G, L = (TABLE6[k] for k in ("B", "prompt", "gen", "block"))
    S = P + G
    prompt = torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    x = torch.cat([prompt, torch.full((B, G), mid, device=DEVICE,
                                      dtype=torch.int32)], 1)
    total = {name: 0 for name in _build.COUNTED}
    for split in (False, True):
        policy = steps.ServePolicy(split_cache=split)
        dcfg = steps.make_dcfg(cfg, base.ShapeConfig(
            "decode", S, B, "decode", block_length=L), policy)
        k = torch.full((B,), L // policy.steps_per_block, device=DEVICE,
                       dtype=torch.int32)
        pre, _ = steps.build_step(model, base.ShapeConfig(
            "prefill", S, B, "prefill", block_length=L), policy)
        dec, _ = steps.build_step(model, base.ShapeConfig(
            "decode", S, B, "decode", block_length=L), policy)
        what = f"phase 13b: {'split' if split else 'unified'} cache"
        cache = model.init_cache(B, S, L if split else None)
        want_pre = {n: 0 for n in _build.COUNTED}
        want_pre.update(flash_bidir=nl, baos_mx_quant=2 * nl)
        want_dec = {n: 0 for n in _build.COUNTED}
        want_dec.update(stablemax_sampling=1, topk_mask=1)
        want_dec.update({"flash_bidir_split": nl} if split else
                        {"flash_bidir": nl, "baos_mx_quant": 2 * nl})
        with no_plain():
            _build.reset_launch_counts()
            logits, cache = pre(params, x, cache, P, {})
            c = dict(_build.launch_counts)
            require(c == want_pre, f"{what} prefill launches {c}")
            ref_cache, ker_cache = clone_tree(cache), clone_tree(cache)
            _build.reset_launch_counts()
            x1, cache = dec(params, x, cache, P, k, 0, {})
            c2 = dict(_build.launch_counts)
            require(c2 == want_dec, f"{what} decode launches {c2}")
            # the decode step's own logits, for the near-tie rule
            lk, _ = diffusion.refine_step(model, params, x, ker_cache, P,
                                          dcfg)
        for counts in (c, c2):
            for n, v in counts.items():
                total[n] += v
        blk = x[:, P:P + L]
        seed = diffusion.tick_seed(0, 0)
        with all_plain():
            # the sampling stage on the decode step's own logits, then the
            # whole refine + sampling with every kernel plain
            xs, _ = sampling.sampling_step(lk, blk, mid, k, dcfg.sampling,
                                           seed)
            lg, _ = diffusion.refine_step(model, params, x, ref_cache, P,
                                          dcfg)
            xa, _ = sampling.sampling_step(lg, blk, mid, k, dcfg.sampling,
                                           seed)
        require(torch.equal(x1[:, :P], x[:, :P]) and
                torch.equal(x1[:, P + L:], x[:, P + L:]),
                f"{what}: the decode step wrote outside the block")
        raw = float((lk.float() - lg.float()).abs().max())
        top = float(lg.float().abs().max())
        require(raw <= 0.05 * top,
                f"{what}: the kernels' refine logits lie {raw} from plain's "
                f"(5% of the largest logit {top})")
        fmt = dcfg.sampling.fmt
        z = quantized_f32(lg.float().reshape(B * L, -1), fmt,
                          mid).view(B, L, -1)
        zk = quantized_f32(lk.float().reshape(B * L, -1), fmt,
                           mid).view(B, L, -1)
        live = z > sampling.NEG_INF
        err = torch.where(live, (zk - z).abs(), 0.0).amax((1, 2))
        own = step_near_ties(zk, torch.zeros_like(err), blk, x1[:, P:P + L],
                             xs, k, mid)
        ties = step_near_ties(z, err, blk, x1[:, P:P + L], xa, k, mid)
        del lg, lk, z, zk, live, ref_cache, ker_cache
        n_commit = int((x1[:, P:P + L] != mid).sum())
        require(n_commit == B * int(k[0]), f"{what}: {n_commit} tokens "
                                           f"committed, want {B * int(k[0])}")
        walls = {}
        for name, fn in (("prefill", lambda: pre(params, x, cache, P, {})),
                         ("decode", lambda: dec(params, x, cache, P, k, 0,
                                                {}))):
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[name] = float(np.median(ts))
        log(f"{what} (B {B}, s_tot {S}, block {L} at {P}, dual + BAOS "
            f"mxint4, mxfp8): prefill launches {c}, decode launches {c2}, "
            f"no plain version; the canvas equal to the plain sampling "
            f"stage's on the step's own logits"
            + (f" but at {len(own)} near-ties {own}" if own else "")
            + f"; the refine's logits within {raw:.4g} of plain's "
            f"({raw / top:.2%} of the largest, {top:.4g}; bound 5%), "
            f"{float(err.max()):.4g} after the {fmt} quantization; the "
            f"canvas equal to refine_step + sampling_step with every kernel "
            f"plain" + (f" but at {len(ties)} recorded near-ties of that "
                        f"difference {ties}" if ties else "")
            + f"; {B * int(k[0])} tokens committed; step wall median of 3: "
            f"prefill {walls['prefill']:.2f} ms, decode "
            f"{walls['decode']:.2f} ms")
        del cache, logits, x1
    free()
    PHASE13_S["13b"] = time.perf_counter() - t_phase
    log(f"phase 13b: {PHASE13_S['13b']:.1f} s")
    return total


def phase13c(meshes, rank: int, say, model, params) -> dict:
    """Phase 13c, in phase 12b's two-rank job (gloo, two ranks sharing the
    card): (i) llada-8b prefill + decode on mesh (1, 2), the
    tensor-parallel body against one rank (``tp_serve_check``); (i') the
    sampled decode step (T 0.8, strategies stablemax and random) on (1, 2)
    and (2, 1) against one rank on the whole batch
    (``tp_sampled_check``); (ii)
    qwen2-0.5b
    in f32 at PHASE13C_LAYERS layers (``cut_depth``), B 8 x S 128: the
    train step on mesh (2, 1) against one rank on the same global batch,
    the loss within 1e-5 relative, every gradient leaf within 1e-5 of its
    largest value, every parameter within 2 x lr + 1e-6 (PERF.md), both
    ranks holding the same parameters; (iii) llada-8b (phase 12b's model,
    PHASE12B_LAYERS layers) prefill + decode at Table 6's shape on (2, 1): the gathered
    canvas and cache equal to one rank's bit for bit; (iv)
    ``compressed_psum`` over the two ranks of each rank's own gradients:
    within each block's int8 half-step of the plain mean; (v) the elastic
    restore of phase 11's qwen2-0.5b checkpoint under (1, 2) and (2, 1)
    placements: each rank's shard equals the slice of the full leaf, bit
    for bit; bytes read per rank and ms.  Returns this rank's launch
    counts."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import sharding
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpointing
    from repro_torch.configs import base
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw, compress
    t_phase = time.perf_counter()
    wide, mesh = meshes
    data = mesh.axis("data")
    counts = {n: 0 for n in _build.COUNTED}
    # (i) llada-8b prefill + decode on (1, 2): the tensor-parallel body
    cfg4 = cut_depth(model.cfg, PHASE14_LAYERS, "for an f32 copy beside "
                     "phase 12b's model") if rank == 0 else \
        dataclasses.replace(model.cfg, n_layers=min(PHASE14_LAYERS,
                                                    model.cfg.n_layers))
    for n, v in tp_serve_check(wide, cfg4, say, "phase 13c").items():
        counts[n] += v
    free()
    dist.barrier()
    # (i') the sampled decode step on (1, 2) (route A) and (2, 1) (the
    # single-device head at the data shard's row offset)
    for m in (wide, mesh):
        for n, v in tp_sampled_check(m, cfg4, say, "phase 13c").items():
            counts[n] += v
        free()
        dist.barrier()

    # (iii) llada-8b prefill + decode on (2, 1) against one rank
    cfg = model.cfg
    B, P, G, L = (TABLE6[k] for k in ("B", "prompt", "gen", "block"))
    S = P + G
    gen = torch.Generator(device=mesh.device).manual_seed(13)
    x = torch.cat([torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                                 device=mesh.device, dtype=torch.int32),
                   torch.full((B, G), cfg.mask_id, device=mesh.device,
                              dtype=torch.int32)], 1)
    k = torch.full((B,), 8, device=mesh.device, dtype=torch.int32)
    policy = steps.ServePolicy()
    pre_s = base.ShapeConfig("prefill", S, B, "prefill", block_length=L)
    dec_s = base.ShapeConfig("decode", S, B, "decode", block_length=L)
    r0, r1 = mesh.rows(B)
    res = {}
    # each rank runs the one-rank step too and holds its own rows to it
    for name, m in (("one rank", None), ("mesh (2, 1)", mesh)):
        inp = {"x": x, "k": k, "cache": model.init_cache(B, S)}
        if m is not None:
            inp = {"x": x[r0:r1], "k": k[r0:r1],
                   "cache": model.init_cache(r1 - r0, S)}
        pre, _ = steps.build_step(model, pre_s, policy, mesh=m)
        dec, _ = steps.build_step(model, dec_s, policy, mesh=m)
        _build.reset_launch_counts()
        with no_plain():
            _, cache = pre(params, inp["x"], inp["cache"], P, {})
            x1, cache = dec(params, inp["x"], cache, P, inp["k"], 0, {})
        if m is not None:
            for n, v in _build.launch_counts.items():
                counts[n] += v
        res[name] = (x1, cache)
    (xa, ca), (xb, cb) = res["one rank"], res["mesh (2, 1)"]
    same = torch.tensor([int(torch.equal(xa[r0:r1], xb)), int(all(
        torch.equal(ca[n][:, r0:r1], cb[n]) for n in ca))],
        device=mesh.device)
    same = mesh_lib.all_reduce(same, "min", data)
    say(f"phase 13c: llada-8b ({cfg.n_layers} layers) prefill + decode at "
        f"Table 6's shape on {mesh}: every rank's rows of the canvas equal "
        f"to one rank's {bool(same[0])}, of every cache leaf "
        f"{bool(same[1])}")
    require(bool(same.all()),
            "phase 13c: the (2, 1) decode step differs from one rank's")
    del res, xa, ca, xb, cb
    free()
    dist.barrier()

    # (ii) qwen2-0.5b f32 train step on (2, 1) against one rank
    tcfg = base.get_config(TRAIN_ARCH)
    if rank == 0:
        tcfg = cut_depth(tcfg, PHASE13C_LAYERS, "for two f32 copies and a "
                         "reference on one card and gloo's host-staged "
                         "gradients")
    else:
        tcfg = dataclasses.replace(tcfg, n_layers=min(PHASE13C_LAYERS,
                                                      tcfg.n_layers))
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    tmodel = build_model(tcfg, mesh.device)
    tokens = train_batch(tcfg).to(mesh.device)
    opt = adamw.OptConfig()
    shape = base.ShapeConfig("train", 128, 8, "train")
    out = {}
    for name, m in (("one rank", None), ("mesh (2, 1)", mesh)):
        if m is None and rank != 0:
            continue
        p = tmodel.init(seed=0)
        tok = tokens if m is None else tokens[slice(*m.rows(8))]
        met, grads = steps.build_grad_fn(tmodel, mesh=m)(p, tok, 0, {})
        step, _ = steps.build_step(tmodel, shape, opt_cfg=opt, mesh=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, met1 = step(p, adamw.init_state(p), tok, 0, {})
        torch.cuda.synchronize()
        out[name] = (float(met["loss"]), grads, p, float(met1["lr"]),
                     time.perf_counter() - t0)
    # every rank holds the same parameters: bit-level checksums gathered
    sums = torch.stack([t.view(torch.int32).to(torch.int64).sum()
                        for t in tree_lib.leaves(out["mesh (2, 1)"][2])])
    both = [torch.empty_like(sums) for _ in range(2)]
    dist.all_gather(both, sums, group=data.group)
    if rank == 0:
        (l1, g1, p1, lr, t1), (l2, g2, p2, _, t2) = (
            out["one rank"], out["mesh (2, 1)"])
        rel = abs(l2 - l1) / abs(l1)
        gerr = max(float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30) for a, b in zip(g2, g1))
        diffs = [(a.detach() - b.detach()).abs() for a, b in zip(
            tree_lib.leaves(p2), tree_lib.leaves(p1))]
        perr = max(float(d.max()) for d in diffs)
        moved = sum(int((d > 1e-6).sum()) for d in diffs)
        say(f"phase 13c: {TRAIN_ARCH} f32 ({tcfg.n_layers} layers) train "
            f"step, B 8 x S 128, on {mesh} against one rank: loss {l2:.7f} "
            f"vs {l1:.7f} (relative {rel:.3g}, bound 1e-5); worst gradient "
            f"leaf error / its largest value {gerr:.3g} (bound 1e-5); "
            f"largest parameter difference {perr:.3g} (bound 2 x lr + 1e-6 "
            f"= {2 * lr + 1e-6:.3g}), {moved} elements beyond 1e-6; both "
            f"ranks' parameters equal: {torch.equal(both[0], both[1])}; "
            f"step wall {t2 * 1e3:.1f} ms on the mesh, {t1 * 1e3:.1f} ms "
            f"on one rank (first calls)")
        require(rel <= 1e-5 and gerr <= 1e-5 and perr <= 2 * lr + 1e-6
                and torch.equal(both[0], both[1]),
                "phase 13c: the (2, 1) train step is off one rank's")

    # (iv) compressed_psum over the two ranks of each rank's own gradients
    p = tmodel.init(seed=0)
    _, local = steps.build_grad_fn(tmodel)(
        p, tokens[slice(*mesh.rows(8))], 0, {})
    local = tree_lib.unflatten(p, [g.detach() for g in local])
    err = compress.init_error(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red, _ = compress.compressed_psum(local, data, err)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ok, worst = True, 0.0
    for g, r in zip(tree_lib.leaves(local), tree_lib.leaves(red)):
        plain = mesh_lib.all_reduce(g.float(), "sum", data) / 2
        _, sc = compress._quant_int8(g.float())
        half = torch.repeat_interleave(sc[:, 0] / 2, compress.BLOCK)[
            :g.numel()].view(g.shape)
        half = mesh_lib.all_reduce(half, "sum", data) / 2
        off = (r - plain).abs()
        # the half-step, and 4 f32 ulp of the value for the sums' rounding
        ok &= bool((off <= half + plain.abs() * 2.0 ** -21).all())
        worst = max(worst, float((off / half.clamp(min=1e-30)).max()))
    say(f"phase 13c: compressed_psum over {mesh}'s data axis (two ranks' "
        f"own gradients, {sum(g.numel() for g in tree_lib.leaves(local)) / 1e6:.1f}"
        f" M values): within each block's int8 half-step of the plain "
        f"mean ({ok}; worst |error| / half-step {worst:.3f}); {ms:.1f} ms "
        f"(host wall, gloo)")
    require(ok, "phase 13c: compressed_psum beyond the int8 half-step")
    del out, p, local, red, err, tmodel
    free()
    dist.barrier()

    # (v) the elastic restore of phase 11's checkpoint
    ccfg = base.get_config(TRAIN_ARCH)
    meta_model = build_model(ccfg, "meta")
    meta = meta_model.init()
    manifest = json.loads((TRAIN_CKPT / f"step_{TRAIN_CKPT_STEP:08d}" /
                           "manifest.json").read_text())
    files = {m["key"]: m for m in manifest["leaves"]}
    for m in (wide, mesh):
        with sharding.use_context(m, launch_sharding.make_rules(ccfg, m)):
            pl = launch_sharding.tree_shardings(meta_model.param_specs(),
                                                meta, m)
        pls = {"params": pl, "opt_state": {
            "m": pl, "v": pl, "step": launch_sharding.replicated(m)}}
        like = {"params": tree_lib.tree_map(
            lambda t: torch.empty(0, dtype=t.dtype, device=m.device), meta),
            "opt_state": {"m": tree_lib.tree_map(
                lambda t: torch.empty(0, dtype=torch.float32,
                                      device=m.device), meta),
                "v": tree_lib.tree_map(
                lambda t: torch.empty(0, dtype=torch.float32,
                                      device=m.device), meta),
                "step": 0}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = checkpointing.restore(TRAIN_CKPT, TRAIN_CKPT_STEP, like,
                                       shardings=pls)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_bytes, n_cut, same = 0, 0, True
        flat_pl = dict(tree_lib.flatten_with_paths(pls))
        for key, leaf in tree_lib.flatten_with_paths(got):
            # the full leaf through a memory map: the chunk below reads
            # only this rank's slice of it
            arr = np.load(TRAIN_CKPT / f"step_{TRAIN_CKPT_STEP:08d}" /
                          files[key]["file"], mmap_mode="r")
            if not isinstance(leaf, torch.Tensor):
                same &= leaf == int(arr)
                continue
            n_bytes += leaf.numel() * leaf.element_size()
            full = torch.from_numpy(arr.view(np.int16) if files[key][
                "dtype"] == "bfloat16" else arr)    # shares the map
            want = full
            for dim, ax in enumerate(flat_pl[key].spec):
                if ax is not None:
                    want = want.chunk(m.shape[ax], dim)[m.axis(ax).index]
            n_cut += want.numel() < full.numel()
            got_bits = (leaf.view(torch.int16) if leaf.dtype ==
                        torch.bfloat16 else leaf)
            same &= torch.equal(got_bits.cpu(), want)
        say(f"phase 13c: elastic restore of {TRAIN_ARCH}'s step-"
            f"{TRAIN_CKPT_STEP} checkpoint onto {m} (rank {rank}): "
            f"{len(files)} leaves, {n_cut} cut to this rank's shard, each "
            f"equal to the slice of the full leaf: {same}; "
            f"{n_bytes / 2 ** 30:.3f} GiB read on this rank in {ms:.0f} ms")
        require(same, f"phase 13c: the restore onto {m} differs from the "
                      f"full leaves' slices on rank {rank}")
        del got
        free()
    dist.barrier()
    if rank == 0:
        import shutil
        shutil.rmtree(TRAIN_CKPT.parent, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    say(f"phase 13c: {dt:.1f} s")
    if rank == 0:
        print(PHASE13_SECONDS + json.dumps({"13c": dt}), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 14: the tensor-parallel body (models/tp.py) over |model| > 1
# ---------------------------------------------------------------------------

# the phase's target, seconds, stated before its first run on the card
# stated before each run that changes the phase: 60 s for the transformer
# checks; 110 s with the recurrent families' (mamba2-130m on (1, 4),
# recurrentgemma-2b on (2, 2)); 130 s with their sampled decode steps
PHASE14_BUDGET_S = 130.0
PHASE14_ARG = "--phase14"
PHASE14_COUNTS = "phase 14 counts "
PHASE14_SECONDS = "phase 14 seconds "
# The tensor-parallel checks hold the sharded body to one rank on f32
# copies of the models (as 13c's train step does) with the BAOS cache in
# format none (smoothed, not MX-rounded).  At full width a quantized cache
# parts the two runs chaotically: an element at a rounding edge flips one
# grid step, attention reads it, and the next layer's calibration moves
# (llada-8b, mxint4: in bf16 at 8 layers 11.7% of the cached elements one
# or two steps apart, the logits 0.98% of the largest; in f32 0.12% at 8
# layers on (1, 2), 0.25% at 4 on (2, 2); PERF.md), which hides the body
# behind the rounding.  The CPU tests hold mxint4 to one grid step, 1 in
# 10^3 (tests/test_torch_tp_steps.py).  Phase 14's llada-8b depth: four
# ranks each hold an f32 copy for the one-rank reference beside their
# shards.
PHASE14_LAYERS = 4
# qwen2-0.5b's depth in phase 14b: 24 until the recurrent families joined
# the phase
PHASE14B_LAYERS = 8
# the recurrent families' depths in phase 14 (DEPTH_CUTS'): recurrentgemma-
# 2b's one (rec, rec, attn) triple and its two tail layers
PHASE14_RECURRENT = ("mamba2-130m", "recurrentgemma-2b")
TP_POLICY_FMT = "none"
# f32 sums in another order over up to 24 full-width layers: the prefill
# logits within 1e-4 of the largest; the cached K/V, each run's read back
# through its own calibration (x_s * f + c), within 1e-4 of each
# channel's largest value (``kv_channel_err``); the calibration within
# 1e-4 of each leaf's largest value
TP_LOGITS_BOUND, TP_KV_BOUND, TP_CALIB_BOUND = 1e-4, 1e-4, 1e-4
# The served configuration through the body (``tp_served_check``): bf16
# weights and ServePolicy() (dual, the BAOS cache in mxint4, mxfp8
# sampling), the kernels' tensor-core routes.  Two bf16 runs part at the
# cache's rounding edges, so, as phase 11 holds its bf16 gradients to an
# f32 reference, the mesh run's distance from an f32 run of the same
# weights and policy may be at most TP_BF16_RATIO times the one-rank bf16
# run's (RMS over the rank's rows, relative to the f32 run's RMS): the
# prefill logits, the prefilled K/V (each read back through its own
# calibration) and the calibration; the decode canvas equals the one-rank
# bf16 run's off recorded near-ties.
TP_BF16_RATIO = 2.0


def kv_channel_err(got, want) -> float:
    """The largest difference of two runs' K/V (L, B, S, H, D) relative to
    its channel's scale: per (layer, head, channel), the largest |got -
    want| over rows and positions divided by the largest |want| there (at
    least 1e-3 of the leaf's largest, for a channel near zero)."""
    diff = (got - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    scale = torch.clamp(scale, min=1e-3 * float(scale.max()))
    return float((diff / scale).max())


def _rel_rms(got, want) -> float:
    """||got - want|| / ||want|| over every element, in f32."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want) /
                 torch.linalg.vector_norm(want))


def _gather_placed(t, placement, mesh):
    """A rank's shard under ``placement`` gathered whole over ``mesh``."""
    from repro_torch.launch import mesh as mesh_lib
    for dim, ax in enumerate(placement.spec):
        if ax is not None:
            t = mesh_lib.all_gather(t, dim, mesh.axis(ax))
    return t


def _rows_of_data(t, placement, mesh):
    """``t`` gathered over ``model`` only (this data rank's rows whole)."""
    from repro_torch.launch import mesh as mesh_lib
    for dim, ax in enumerate(placement.spec):
        if ax == "model":
            t = mesh_lib.all_gather(t, dim, mesh.axis("model"))
    return t


def tp_serve_check(mesh, cfg, say, what: str) -> dict:
    """``build_step(prefill)`` then ``build_step(decode)`` under
    ``ServePolicy()`` with the BAOS cache in TP_POLICY_FMT (dual, BAOS
    smoothing, mxfp8 sampling) at Table 6's shape over ``mesh`` (|model| >
    1), on an f32 copy of ``cfg`` (seeded; the f32 routes of the kernels):
    each rank's parameters and cache only its shards
    (launch/sharding.place / local_like), the tensor-parallel body,
    against the one-rank steps on the rank's rows with every parameter:
    the prefill's logits within TP_LOGITS_BOUND of the largest, the
    prefilled cache's K/V (unsmoothed) within TP_KV_BOUND of each
    channel's largest value and every other leaf (the calibration, the
    recurrent states and conv rows) within TP_CALIB_BOUND of the leaf's
    largest value,
    the decode canvas equal off recorded near-ties (``step_near_ties``,
    given the two refines' logit difference), every ``model`` rank's
    canvas equal, a step's launches the one-rank step's with the head's
    route for the mesh's (route A from hidden states or route C from the
    ssm and hybrid families' logit columns where a vocab shard is whole
    MX blocks, else the head gathered), and no plain version; the steps'
    ms and their collectives' ms (gloo between ranks sharing a card: the
    collectives and the parity, not a speed-up).  Returns this rank's
    launch counts of the mesh steps."""
    import numpy as np
    from repro_torch import sharding
    from repro_torch import tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.core import baos as baos_lib
    from repro_torch.core import diffusion, mx
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models import tp as tp_lib
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, mesh.device)
    params = model.init(seed=0)
    nl, mid = cfg.n_layers, cfg.mask_id
    n_model = mesh.shape["model"]
    B, P, G, L = (TABLE6[k] for k in ("B", "prompt", "gen", "block"))
    S = P + G
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.cat([torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                                 device=dev, dtype=torch.int32),
                   torch.full((B, G), mid, device=dev, dtype=torch.int32)],
                  1)
    policy = steps.ServePolicy(baos=baos_lib.BAOSConfig(
        enabled=True, kv_format=TP_POLICY_FMT))
    k = torch.full((B,), L // policy.steps_per_block, device=dev,
                   dtype=torch.int32)
    pre_s = base.ShapeConfig("prefill", S, B, "prefill", block_length=L)
    dec_s = base.ShapeConfig("decode", S, B, "decode", block_length=L)
    dcfg = steps.make_dcfg(cfg, dec_s, policy)
    r0, r1 = mesh.rows(B)
    xr, kr = x[r0:r1], k[r0:r1]
    specs = steps.input_specs(model, dec_s, policy)
    with sharding.use_context(mesh, launch_sharding.make_rules(cfg, mesh)):
        pls = steps.input_shardings(model, dec_s, mesh, specs, policy)
    head_sharded = cfg.vocab % n_model == 0
    whole_blocks = (cfg.vocab // n_model) % mx.MX_BLOCK == 0
    hidden = getattr(model, "supports_head_mode", True)
    route = ("stablemax_sampling" if not head_sharded else
             "fused_head_sampling_shard" if hidden and whole_blocks else
             "fused_head_sampling" if hidden else
             "stablemax_sampling_shard" if whole_blocks else
             "stablemax_sampling")
    head_what = {"fused_head_sampling_shard": "route A",
                 "stablemax_sampling_shard": "route C",
                 "fused_head_sampling": "the head gathered",
                 "stablemax_sampling": "the head gathered" if head_sharded
                 else "a replicated head"}[route]

    # one rank, on this rank's rows
    pre1, _ = steps.build_step(model, pre_s, policy)
    dec1, _ = steps.build_step(model, dec_s, policy)
    with no_plain():
        _build.reset_launch_counts()
        lg1, c1 = pre1(params, xr, model.init_cache(r1 - r0, S), P, {})
        want_pre = dict(_build.launch_counts)
        c1_pre = clone_tree(c1)
        _build.reset_launch_counts()
        x_ref, _ = dec1(params, xr, c1, P, kr, 0, {})
        want_dec = dict(_build.launch_counts)
    require(want_dec["stablemax_sampling"] == 1,
            f"{what}: the one-rank decode launched {want_dec}")
    want_dec["stablemax_sampling"] = 0
    want_dec[route] += 1
    lk1, _ = diffusion.refine_step(model, params, xr, clone_tree(c1_pre), P,
                                   dcfg)
    del c1

    # the mesh: this rank's shards only
    mine = launch_sharding.place(params, pls["params"])
    meta = build_model(cfg, "meta").init_cache(B, S)
    cache = launch_sharding.local_like(
        meta, pls["cache"], lambda path: 1.0 if path.endswith("_scale")
        else 0.0, device=dev)
    own = sum(t.numel() * t.element_size() for t in
              tree_lib.leaves(mine) + tree_lib.leaves(cache))
    pre, _ = steps.build_step(model, pre_s, policy, mesh=mesh)
    dec, _ = steps.build_step(model, dec_s, policy, mesh=mesh)
    total = {n: 0 for n in _build.COUNTED}
    with no_plain():
        _build.reset_launch_counts()
        lg, cache = pre(mine, xr, cache, P, {})
        c_pre = dict(_build.launch_counts)
        require(c_pre == want_pre, f"{what}: {mesh} prefill launches "
                                   f"{c_pre}")
        tp_pre = clone_tree(cache)
        _build.reset_launch_counts()
        x1, cache = dec(mine, xr, cache, P, kr, 0, {})
        c_dec = dict(_build.launch_counts)
        require(c_dec == want_dec, f"{what}: {mesh} decode launches "
                                   f"{c_dec}")
    for c in (c_pre, c_dec):
        for n, v in c.items():
            total[n] += v
    # the mesh refine's logits, gathered over model, for the near-tie rule
    kv_cache = "k" in tp_pre
    with tp_lib.use(tp_lib.Parallel(
            model=mesh.axis("model"),
            cache_seq=kv_cache and tp_pre["k"].shape[2] != S)):
        lk, _ = diffusion.refine_step(model, mine, xr, clone_tree(tp_pre),
                                      P, dcfg)
    if lk.shape[-1] != cfg.vocab:
        lk = mesh_lib.all_gather(lk, -1, mesh.axis("model"))
    if lg.shape[-1] != cfg.vocab:
        lg = mesh_lib.all_gather(lg, -1, mesh.axis("model"))

    top = float(lg1.float().abs().max())
    raw = float((lg.float() - lg1.float()).abs().max())
    kv, calib = 0.0, 0.0
    got = {n: _rows_of_data(t, pls["cache"][n], mesh).float()
           for n, t in tp_pre.items()}
    for name in got:
        if name in ("k", "v"):
            raw_of = [c[name].float() * c[f"{name}_scale"] +
                      c[f"{name}_center"] for c in (got, c1_pre)]
            kv = max(kv, kv_channel_err(*raw_of))
            del raw_of
            continue
        want = c1_pre[name].float()
        calib = max(calib, float((got[name] - want).abs().max()) / max(
            float(want.abs().max()), 1e-30))
    del got
    require(raw <= TP_LOGITS_BOUND * top and kv <= TP_KV_BOUND and
            calib <= TP_CALIB_BOUND,
            f"{what}: {mesh}: prefill logits {raw:.4g} from one rank's "
            f"(largest {top:.4g}), the cached K/V {kv:.4g}, the other "
            f"cache leaves {calib:.3g}")
    fmt = dcfg.sampling.fmt
    z = quantized_f32(lk1.float().reshape((r1 - r0) * L, -1), fmt,
                      mid).view(r1 - r0, L, -1)
    zk = quantized_f32(lk.float().reshape((r1 - r0) * L, -1), fmt,
                       mid).view(r1 - r0, L, -1)
    live = z > -1e29
    err = torch.where(live, (zk - z).abs(), 0.0).amax((1, 2))
    ties = step_near_ties(z, err, xr[:, P:P + L], x1[:, P:P + L],
                          x_ref[:, P:P + L], kr, mid)
    require(torch.equal(x1[:, :P], xr[:, :P]) and
            torch.equal(x1[:, P + L:], xr[:, P + L:]),
            f"{what}: the decode step wrote outside the block")
    every = mesh_lib.all_gather(x1[None], 0, mesh.axis("model"))
    require(bool((every == every[:1]).all()),
            f"{what}: the model ranks' canvases differ")
    del z, zk, live, lk, lk1, lg, lg1
    # ms a step and its collectives' ms: the prefill once more, the decode
    # the median of 3 (gloo moves every partial sum through the host)
    walls, colls = {}, {}
    for name, fn, n in (("prefill", lambda: pre(mine, xr, clone_tree(
            tp_pre), P, {}), 1), ("decode", lambda: dec(
                mine, xr, clone_tree(tp_pre), P, kr, 0, {}), 3)):
        ts, cs = [], []
        clock = CollectiveClock()
        try:
            for _ in range(n):
                clock.ms = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                cs.append(clock.ms)
        finally:
            clock.close()
        walls[name], colls[name] = float(np.median(ts)), float(np.median(cs))
    cache_what = ("no KV cache" if not kv_cache else "a head-parallel "
                  "cache" if tp_pre["k"].shape[3] != cfg.n_kv_heads else
                  "a context-parallel cache")
    say(f"{what}: {cfg.name} f32 ({nl} layers, BAOS cache format "
        f"{TP_POLICY_FMT}) prefill + decode at Table 6's "
        f"shape (B {B}, s_tot {S}, block {L} at {P}) on {mesh} (rank 0's "
        f"view; {cache_what}, {head_what}): "
        f"{own / 2 ** 30:.2f} GiB of parameter and cache shards on this "
        f"rank; prefill launches {c_pre}, decode launches {c_dec}, no plain "
        f"version; the prefill logits within {raw:.4g} of one rank's "
        f"({raw / top:.3g} of the largest, bound {TP_LOGITS_BOUND:g}), "
        + (f"the prefilled K/V unsmoothed within {kv:.3g} of their "
           f"channel's largest (bound {TP_KV_BOUND:g}), " if kv_cache
           else "")
        + f"the other cache leaves within {calib:.3g} of their largest "
        f"(bound {TP_CALIB_BOUND:g}); the "
        f"decode canvas equal to one "
        f"rank's" + (f" but at {len(ties)} recorded near-ties {ties}"
                     if ties else "")
        + f", every model rank's canvas equal; ms a step (the prefill's "
        f"second call, the decode's median of 3; {card_line()}): prefill {walls['prefill']:.2f} (collectives "
        f"{colls['prefill']:.2f}), decode {walls['decode']:.2f} "
        f"(collectives {colls['decode']:.2f}); ranks share the card over "
        f"gloo, so these show the collectives and the parity, not a "
        f"speed-up")
    del mine, cache, tp_pre, c1_pre, params, model
    return total


# the sampled decode step's policies over a mesh: (name, T, strategy)
SAMPLED_POLICIES = (("T 0.8", 0.8, "stablemax"), ("random", 0.8, "random"))


def sampled_near_ties(z, err, T, seed, row0, before, got, want, k,
                      mid) -> list:
    """``step_near_ties`` for a sampled decode step: z (R, L, V) the
    one-rank run's quantized f32 logits of this rank's rows, whose first
    row is global flattened row ``row0`` (the noise's row), ``err`` (R,)
    each row's largest logit difference between the runs.  Two committed
    tokens whose Gumbel scores z/T + g lie within 2 err / T + 1e-2 of the
    position's largest score of each other, or a position committed by
    one run and not the other whose confidence (that of the sampled
    token) lies within 2 (e^(2 err) - 1) + 1e-2 relative of the row's
    k-th.  The scores are drawn for the differing rows only.  Returns
    [(row, position, kind)]."""
    from repro_torch.core import sampling
    R, L, V = z.shape
    cols = torch.arange(V, device=z.device)[None, :]
    out = []
    for i in sorted({i for i, _ in torch.nonzero(got != want).tolist()}):
        rows = row0 + i * L + torch.arange(L, device=z.device)[:, None]
        sc = z[i] / T + sampling.counter_gumbel(seed, rows, cols)
        tok = sc.argmax(-1, keepdim=True)
        m = z[i].amax(-1, keepdim=True)
        conf = (torch.exp(z[i].gather(-1, tok) - m) /
                torch.exp(z[i] - m).sum(-1, keepdim=True))[:, 0]
        e = float(err[i])
        for l in torch.nonzero(got[i] != want[i]).flatten().tolist():
            a, b = int(want[i, l]), int(got[i, l])
            if a != mid and b != mid:
                top = float(sc[l].max())
                ok = abs(float(sc[l, a] - sc[l, b])) <= 2 * e / T + \
                    1e-2 * abs(top)
                kind = "token"
            else:
                masked = before[i] == mid
                kth = float(conf[masked].sort(descending=True).values[
                    int(k[i]) - 1])
                ok = abs(float(conf[l]) - kth) <= (
                    2 * math.expm1(2 * e) + 1e-2) * kth
                kind = "transfer"
            require(ok, f"sampled decode step: row {i} position {l} "
                        f"differs off a near-tie ({kind})")
            out.append((i, l, kind))
        del sc, conf
    return out


def tp_sampled_check(mesh, cfg, say, what: str) -> dict:
    """The sampled decode step over ``mesh`` (each of SAMPLED_POLICIES:
    T 0.8 with strategy stablemax, and strategy random) against the
    one-rank step on the whole batch, f32 copies as ``tp_serve_check``'s,
    at Table 6's shape: this rank's block of the mesh's canvas equal to
    the one-rank canvas's rows off recorded near-ties
    (``sampled_near_ties``: the noise is drawn at global rows and
    columns, so a difference can come only from the two forwards'
    logits), every ``model`` rank's canvas equal, the launches the
    one-rank step's with the head's sampled route for the mesh's, and no
    plain version.  Returns this rank's launch counts of the mesh
    decodes."""
    from repro_torch import sharding
    from repro_torch.configs import base
    from repro_torch.core import baos as baos_lib
    from repro_torch.core import diffusion, mx
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models import tp as tp_lib
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, mesh.device)
    params = model.init(seed=0)
    mid, n_model = cfg.mask_id, mesh.shape["model"]
    B, P, G, L = (TABLE6[k] for k in ("B", "prompt", "gen", "block"))
    S, dev = P + G, mesh.device
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.cat([torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                                 device=dev, dtype=torch.int32),
                   torch.full((B, G), mid, device=dev, dtype=torch.int32)],
                  1)
    r0, r1 = mesh.rows(B)
    head_sharded = cfg.vocab % n_model == 0
    whole_blocks = (cfg.vocab // n_model) % mx.MX_BLOCK == 0
    hidden = getattr(model, "supports_head_mode", True)
    route = ("stablemax_sampling" if not head_sharded else
             "fused_head_sampling_shard_sampled" if hidden and whole_blocks
             else "fused_head_sampling" if hidden else
             "stablemax_sampling_shard_sampled" if whole_blocks else
             "stablemax_sampling")
    if n_model == 1:
        route = "stablemax_sampling"
    total = {n: 0 for n in _build.COUNTED}
    seed = diffusion.tick_seed(0, 0)        # the step's draw at seed 0
    notes = []
    for name, T, strategy in SAMPLED_POLICIES:
        policy = steps.ServePolicy(
            baos=baos_lib.BAOSConfig(enabled=True, kv_format=TP_POLICY_FMT),
            sampling=dataclasses.replace(steps.ServePolicy().sampling,
                                         temperature=T, strategy=strategy))
        k = torch.full((B,), L // policy.steps_per_block, device=dev,
                       dtype=torch.int32)
        pre_s = base.ShapeConfig("prefill", S, B, "prefill", block_length=L)
        dec_s = base.ShapeConfig("decode", S, B, "decode", block_length=L)
        dcfg = steps.make_dcfg(cfg, dec_s, policy)
        # one rank, on the whole batch (the noise of rows r0.. is drawn
        # where the mesh's rank draws it)
        pre1, _ = steps.build_step(model, pre_s, policy)
        dec1, _ = steps.build_step(model, dec_s, policy)
        axes = diffusion.cache_batch_axes(model, S)
        with no_plain():
            _, c1 = pre1(params, x, model.init_cache(B, S), P, {})
            # this rank's rows of the prefilled cache, for the refine below
            c1_pre = {n: t.narrow(axes[n], r0, r1 - r0).clone()
                      for n, t in c1.items()}
            x_ref, _ = dec1(params, x, c1, P, k, 0, {})
        del c1
        free()
        # the mesh: this rank's shards only
        specs = steps.input_specs(model, dec_s, policy)
        with sharding.use_context(mesh, launch_sharding.make_rules(cfg,
                                                                   mesh)):
            pls = steps.input_shardings(model, dec_s, mesh, specs, policy)
        mine = launch_sharding.place(params, pls["params"])
        meta = build_model(cfg, "meta").init_cache(B, S)
        cache = launch_sharding.local_like(
            meta, pls["cache"], lambda path: 1.0 if path.endswith("_scale")
            else 0.0, device=dev)
        pre, _ = steps.build_step(model, pre_s, policy, mesh=mesh)
        dec, _ = steps.build_step(model, dec_s, policy, mesh=mesh)
        xr, kr = x[r0:r1], k[r0:r1]
        with no_plain():
            _, cache = pre(mine, xr, cache, P, {})
            tp_pre = clone_tree(cache)
            _build.reset_launch_counts()
            x1, cache = dec(mine, xr, cache, P, kr, 0, {})
            c_dec = dict(_build.launch_counts)
        require(c_dec[route] == 1 and c_dec["topk_mask"] == 1,
                f"{what} {name}: {mesh} decode launches {c_dec}")
        for n_, v in c_dec.items():
            total[n_] += v
        # the two runs' refine logits on this rank's rows, for the
        # near-tie rule
        lk1 = diffusion.refine_step(model, params, xr, c1_pre, P, dcfg)[0]
        with tp_lib.use(tp_lib.Parallel(
                model=mesh.axis("model"),
                cache_seq="k" in tp_pre and tp_pre["k"].shape[2] != S)
                if n_model > 1 else None):
            lk = diffusion.refine_step(model, mine, xr, clone_tree(tp_pre),
                                       P, dcfg)[0]
        if lk.shape[-1] != cfg.vocab:
            lk = mesh_lib.all_gather(lk, -1, mesh.axis("model"))
        fmt = dcfg.sampling.fmt
        z = quantized_f32(lk1.float().reshape((r1 - r0) * L, -1), fmt,
                          mid).view(r1 - r0, L, -1)
        zk = quantized_f32(lk.float().reshape((r1 - r0) * L, -1), fmt,
                           mid).view(r1 - r0, L, -1)
        err = torch.where(z > -1e29, (zk - z).abs(), 0.0).amax((1, 2))
        ties = sampled_near_ties(z, err, T, seed, r0 * L, xr[:, P:P + L],
                                 x1[:, P:P + L], x_ref[r0:r1, P:P + L], kr,
                                 mid)
        require(torch.equal(x1[:, :P], xr[:, :P]) and
                torch.equal(x1[:, P + L:], xr[:, P + L:]),
                f"{what} {name}: the decode step wrote outside the block")
        require(not torch.equal(x_ref[r0:r1, P:P + L], xr[:, P:P + L]),
                f"{what} {name}: the one-rank step committed nothing")
        if n_model > 1:
            every = mesh_lib.all_gather(x1[None], 0, mesh.axis("model"))
            require(bool((every == every[:1]).all()),
                    f"{what} {name}: the model ranks' canvases differ")
        notes.append(f"{name}: equal to one rank's" + (
            f" but at {len(ties)} recorded near-ties {ties}" if ties
            else "") + f" (largest logit difference {float(err.max()):.3g})")
        del mine, cache, tp_pre, c1_pre, z, zk, lk, lk1
        free()
    say(f"{what}: {cfg.name} f32 ({cfg.n_layers} layers) sampled decode "
        f"at Table 6's shape on {mesh} (rank {mesh.rank}'s rows "
        f"{r0}..{r1}, the noise at global rows from {r0 * L}; the head's "
        f"route: {route}): " + "; ".join(notes)
        + f"; every model rank's canvas equal; launches {total}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB on "
        f"this rank; {time.perf_counter() - t0:.1f} s")
    del params, model
    return total


def tp_served_check(mesh, cfg, say, what: str) -> dict:
    """``build_step(prefill)`` then ``build_step(decode)`` over ``mesh``
    (|model| > 1) in the served configuration: ``cfg``'s bf16 weights
    (seeded) under ``ServePolicy()`` (dual, BAOS mxint4 cache, mxfp8
    sampling) at Table 6's shape, each rank holding its shards only.  On
    this rank's rows, an f32 run of the same weights and policy is the
    reference; the mesh run's distance from it (prefill logits, prefilled
    K/V read back through each run's calibration, the calibration; RMS
    relative to the reference's) at most TP_BF16_RATIO times the one-rank
    bf16 run's; the decode canvas equal to the one-rank bf16 run's off
    recorded near-ties (``step_near_ties``), every ``model`` rank's canvas
    equal; exact launches a step and no plain version.  Returns this
    rank's launch counts of the mesh steps."""
    from repro_torch import sharding
    from repro_torch import tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.core import diffusion, mx
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models import tp as tp_lib
    from repro_torch.models.registry import build_model
    nl, mid = cfg.n_layers, cfg.mask_id
    n_model = mesh.shape["model"]
    B, P, G, L = (TABLE6[k] for k in ("B", "prompt", "gen", "block"))
    S = P + G
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.cat([torch.randint(0, cfg.vocab - 200, (B, P), generator=gen,
                                 device=dev, dtype=torch.int32),
                   torch.full((B, G), mid, device=dev, dtype=torch.int32)],
                  1)
    policy = steps.ServePolicy()
    k = torch.full((B,), L // policy.steps_per_block, device=dev,
                   dtype=torch.int32)
    pre_s = base.ShapeConfig("prefill", S, B, "prefill", block_length=L)
    dec_s = base.ShapeConfig("decode", S, B, "decode", block_length=L)
    r0, r1 = mesh.rows(B)
    xr, kr = x[r0:r1], k[r0:r1]
    head_sharded = cfg.vocab % n_model == 0
    route_a = head_sharded and (cfg.vocab // n_model) % mx.MX_BLOCK == 0

    def kv_of(c):
        return {n: c[n].float() * c[f"{n}_scale"] + c[f"{n}_center"]
                for n in ("k", "v")}

    # one rank on this rank's rows: the f32 reference, then bf16
    runs = {}
    params = None
    for dt in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg, dtype=dt), dev)
        if params is None:
            params = model.init(seed=0)
        else:
            params = tree_lib.tree_map(lambda t: t.to(torch.bfloat16),
                                       params)
        pre1, _ = steps.build_step(model, pre_s, policy)
        dec1, _ = steps.build_step(model, dec_s, policy)
        with no_plain():
            lg1, c1 = pre1(params, xr, model.init_cache(r1 - r0, S), P, {})
            c_pre = clone_tree(c1)
            x1, _ = dec1(params, xr, c1, P, kr, 0, {})
        runs[dt] = (lg1.float(), kv_of(c_pre), {
            n: c_pre[n].float() for n in c_pre if n not in ("k", "v")}, x1)
        if dt == "bfloat16":
            dcfg = steps.make_dcfg(model.cfg, dec_s, policy)
            lk1, _ = diffusion.refine_step(model, params, xr,
                                           clone_tree(c_pre), P, dcfg)
        del c1, c_pre
    free()

    # the mesh: this rank's shards of the bf16 weights only
    specs = steps.input_specs(model, dec_s, policy)
    with sharding.use_context(mesh, launch_sharding.make_rules(
            model.cfg, mesh)):
        pls = steps.input_shardings(model, dec_s, mesh, specs, policy)
    mine = launch_sharding.place(params, pls["params"])
    del params
    cache = launch_sharding.local_like(
        build_model(model.cfg, "meta").init_cache(B, S), pls["cache"],
        lambda path: 1.0 if path.endswith("_scale") else 0.0, device=dev)
    pre, _ = steps.build_step(model, pre_s, policy, mesh=mesh)
    dec, _ = steps.build_step(model, dec_s, policy, mesh=mesh)
    want_pre = {n: 0 for n in _build.COUNTED}
    want_pre.update(flash_bidir=nl, baos_mx_quant=2 * nl)
    want_dec = dict(want_pre, topk_mask=1)
    want_dec["fused_head_sampling_shard" if route_a else
             "fused_head_sampling" if head_sharded
             else "stablemax_sampling"] = 1
    with no_plain():
        _build.reset_launch_counts()
        lg, cache = pre(mine, xr, cache, P, {})
        c_pre = dict(_build.launch_counts)
        require(c_pre == want_pre, f"{what}: {mesh} bf16 prefill launches "
                                   f"{c_pre}")
        tp_pre = clone_tree(cache)
        _build.reset_launch_counts()
        xt, cache = dec(mine, xr, cache, P, kr, 0, {})
        c_dec = dict(_build.launch_counts)
        require(c_dec == want_dec, f"{what}: {mesh} bf16 decode launches "
                                   f"{c_dec}")
    total = {n: c_pre[n] + c_dec[n] for n in _build.COUNTED}
    with tp_lib.use(tp_lib.Parallel(model=mesh.axis("model"),
                                    cache_seq=tp_pre["k"].shape[2] != S)):
        lk, _ = diffusion.refine_step(model, mine, xr, clone_tree(tp_pre),
                                      P, dcfg)
    if lk.shape[-1] != cfg.vocab:
        lk = mesh_lib.all_gather(lk, -1, mesh.axis("model"))
    if lg.shape[-1] != cfg.vocab:
        lg = mesh_lib.all_gather(lg, -1, mesh.axis("model"))
    got = {n: _rows_of_data(t, pls["cache"][n], mesh).float()
           for n, t in tp_pre.items()}
    runs["mesh"] = (lg.float(), kv_of(got), {
        n: got[n] for n in got if n not in ("k", "v")}, xt)
    del got, tp_pre, cache, mine

    # each bf16 run's distance from the f32 reference
    err = {}
    for name, base_ in (("bfloat16", "float32"), ("mesh", "float32"),
                        ("mesh", "bfloat16")):
        (lgr, kvr, calr, _), ref = runs[name], runs[base_]
        err[name, base_] = (
            _rel_rms(lgr, ref[0]),
            max(_rel_rms(kvr[n], ref[1][n]) for n in ("k", "v")),
            max(_rel_rms(calr[n], ref[2][n]) for n in ref[2]))
    err["bfloat16"], err["mesh"] = err["bfloat16", "float32"], \
        err["mesh", "float32"]
    ratios = [m / max(o, 1e-30) for m, o in zip(err["mesh"],
                                                err["bfloat16"])]
    fmt = dcfg.sampling.fmt
    z = quantized_f32(lk1.float().reshape((r1 - r0) * L, -1), fmt,
                      mid).view(r1 - r0, L, -1)
    zk = quantized_f32(lk.float().reshape((r1 - r0) * L, -1), fmt,
                       mid).view(r1 - r0, L, -1)
    live = z > -1e29
    lerr = torch.where(live, (zk - z).abs(), 0.0).amax((1, 2))
    x_one = runs["bfloat16"][3]
    ties = step_near_ties(z, lerr, xr[:, P:P + L], xt[:, P:P + L],
                          x_one[:, P:P + L], kr, mid)
    require(torch.equal(xt[:, :P], xr[:, :P]) and
            torch.equal(xt[:, P + L:], xr[:, P + L:]),
            f"{what}: the bf16 decode step wrote outside the block")
    every = mesh_lib.all_gather(xt[None], 0, mesh.axis("model"))
    require(bool((every == every[:1]).all()),
            f"{what}: the model ranks' bf16 canvases differ")
    off_f32 = [int((runs[n][3] != runs["float32"][3]).sum())
               for n in ("bfloat16", "mesh")]
    names = ("logits", "K/V", "calibration")
    say(f"{what}: {cfg.name} bf16 ({nl} layers) under ServePolicy() (dual, "
        f"BAOS mxint4, sampling {fmt}) prefill + decode at Table 6's shape "
        f"on {mesh} (rank 0's view; "
        f"{'route A' if route_a else 'the head gathered' if head_sharded else 'a replicated head'}); "
        f"prefill launches {c_pre}, decode launches {c_dec}, no plain "
        f"version; RMS distance from the f32 run of the same weights "
        f"(relative), one-rank bf16 / mesh / ratio (bound "
        f"{TP_BF16_RATIO:g}): " + "; ".join(
            f"{nm} {a:.4g} / {b:.4g} / {r:.3g}" for nm, a, b, r in zip(
                names, err["bfloat16"], err["mesh"], ratios))
        + "; the mesh run from the one-rank bf16 run: " + ", ".join(
            f"{nm} {d:.4g}" for nm, d in zip(names, err["mesh",
                                                        "bfloat16"]))
        + f"; the decode canvas equal to the one-rank bf16 run's"
        + (f" but at {len(ties)} recorded near-ties {ties}" if ties else "")
        + f", every model rank's equal; block tokens off the f32 run's: "
        f"one-rank bf16 {off_f32[0]}, mesh {off_f32[1]} of "
        f"{(r1 - r0) * L} ({card_line()})")
    require(all(r <= TP_BF16_RATIO for r in ratios),
            f"{what}: the bf16 mesh run is {ratios} times as far from the "
            f"f32 reference as one rank's (logits, K/V, calibration)")
    del runs, lk, lk1, z, zk, lg
    return total


def tp_train_check(mesh, rank: int, say, arch: str = TRAIN_ARCH,
                   layers: int = PHASE13C_LAYERS,
                   what: str = "phase 14c") -> dict:
    """``arch`` (qwen2-0.5b) in f32 at ``layers`` layers (``cut_depth``),
    B 8 x S 128, full width: the train step over ``mesh`` (|model| > 1,
    each rank holding its parameter and optimizer shards) against one rank
    on the same global batch: the loss within 1e-5 relative, every
    gathered gradient leaf within 1e-5 of its largest value (mamba's in
    JAX's layout, a stack per name, as tests/test_torch_tp_steps.py
    holds them: its per-head f32 scalars' gradients cancel), every
    gathered parameter within 2 x lr + 1e-6, every rank's loss equal;
    exact launches (flash_bidir and its backward once an attention layer)
    and ms.  Returns this rank's launch counts."""
    from repro_torch import sharding
    from repro_torch import tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    tcfg = base.get_config(arch)
    tcfg = cut_depth(tcfg, layers, "for an f32 reference beside four "
                     "ranks' shards on one card") if rank == 0 else \
        dataclasses.replace(tcfg, n_layers=min(layers, tcfg.n_layers))
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    model = build_model(tcfg, mesh.device)
    nl = tcfg.n_layers
    tokens = train_batch(tcfg).to(mesh.device)
    opt = adamw.OptConfig()
    shape = base.ShapeConfig("train", 128, 8, "train")
    specs = steps.input_specs(model, shape)
    with sharding.use_context(mesh, launch_sharding.make_rules(tcfg, mesh)):
        pls = steps.input_shardings(model, shape, mesh, specs)["params"]
    ref = None
    if rank == 0:
        p = model.init(seed=0)
        met, grads = steps.build_grad_fn(model)(p, tokens, 0, {})
        step, _ = steps.build_step(model, shape, opt_cfg=opt)
        _, _, met1 = step(p, adamw.init_state(p), tokens, 0, {})
        ref = (float(met["loss"]), [g.detach() for g in grads], p,
               float(met1["lr"]))
        del grads
    mine = launch_sharding.place(model.init(seed=0), pls)
    tok = tokens[slice(*mesh.rows(8))]
    _build.reset_launch_counts()
    met, grads = steps.build_grad_fn(model, mesh=mesh)(mine, tok, 0, {})
    c_grad = dict(_build.launch_counts)
    step, _ = steps.build_step(model, shape, opt_cfg=opt, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    _, _, met2 = step(mine, adamw.init_state(mine), tok, 0, {})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c_step = dict(_build.launch_counts)
    n_attn = {"ssm": 0, "hybrid": nl // 3}.get(tcfg.family, nl)
    want = {n: 0 for n in _build.COUNTED}
    want.update(flash_bidir=n_attn, flash_bidir_bwd=n_attn)
    require(c_grad == want and c_step == want,
            f"{what}: train launches {c_grad}, {c_step}")
    leaves = tree_lib.leaves(pls)
    g_all = [_gather_placed(g.detach(), pl, mesh)
             for g, pl in zip(grads, leaves)]
    p_all = [_gather_placed(t.detach(), pl, mesh)
             for t, pl in zip(tree_lib.leaves(mine), leaves)]
    losses = mesh_lib.all_gather(met["loss"].reshape(1), 0,
                                 mesh.axis("model"))
    require(bool((losses == losses[0]).all()),
            f"{what}: the model ranks' losses differ")
    if rank == 0:
        l1, g1, p1, lr = ref
        l2 = float(met["loss"])
        rel = abs(l2 - l1) / abs(l1)
        names = [pth for pth, _ in tree_lib.flatten_with_paths(p1)]
        if tcfg.family == "ssm":
            names = ["/".join(q for q in pth.split("/") if not q.isdigit())
                     for pth in names]
        top, worst = {}, {}
        for n, b in zip(names, g1):
            top[n] = max(top.get(n, 0.0), float(b.abs().max()))
        for n, a, b in zip(names, g_all, g1):
            worst[n] = max(worst.get(n, 0.0), float((a - b).abs().max()))
        gerr = max(worst[n] / max(top[n], 1e-30) for n in top)
        perr = max(float((a - b.detach()).abs().max())
                   for a, b in zip(p_all, tree_lib.leaves(p1)))
        own = sum(t.numel() * t.element_size()
                  for t in tree_lib.leaves(mine))
        say(f"{what}: {arch} f32 ({nl} layers) train step, B 8 x "
            f"S 128, on {mesh} (rank 0's view; {own / 2 ** 30:.3f} GiB of "
            f"parameter shards on this rank) against one rank: loss "
            f"{l2:.7f} vs {l1:.7f} (relative {rel:.3g}, bound 1e-5); worst "
            f"gradient leaf error / its largest value {gerr:.3g} (bound "
            f"1e-5); largest parameter difference {perr:.3g} (bound 2 x lr "
            f"+ 1e-6 = {2 * lr + 1e-6:.3g}); launches a step {c_step}; "
            f"step wall {ms:.1f} ms (first call; {card_line()}; four ranks "
            f"share the card over gloo)")
        require(rel <= 1e-5 and gerr <= 1e-5 and perr <= 2 * lr + 1e-6,
                f"{what}: the train step is off one rank's")
    del mine, grads, g_all, p_all, ref
    total = {n: c_grad[n] + c_step[n] for n in _build.COUNTED}
    return total


def job_errors(stderr: str) -> str:
    """A rank job's failure: every rank's ``chip_smoke: FAILED`` line and
    exception line (a rank's own error can lie far above the end of the
    job's stderr, which the other ranks fill when it dies), then the
    end of stderr."""
    lines = [ln for ln in stderr.splitlines()
             if "chip_smoke: FAILED" in ln or ln.startswith((
                 "[rank", "torch.OutOfMemoryError", "RuntimeError"))
             and ("Error" in ln or "FAILED" in ln)]
    return "\n".join(lines[:40]) + "\n...\n" + stderr[-2000:]


def phase_tp_ranks() -> dict:
    """Phase 14's job: four ranks sharing the card, launched by
    torch.distributed.run (``phase14_main`` in each); rank 0's output joins
    this log.  Returns the four ranks' launch counts, summed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "4",
                        str(ROOT / "chip_smoke.py"), PHASE14_ARG],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    total = None
    for line in r.stdout.splitlines():
        if line.startswith(PHASE14_COUNTS):
            total = json.loads(line[len(PHASE14_COUNTS):])
        else:
            log(line)
    require(r.returncode == 0 and total is not None,
            f"phase 14 job: exit {r.returncode}: {job_errors(r.stderr)}")
    log(f"phase 14 (four ranks, their own job): "
        f"{time.perf_counter() - t0:.1f} s against its budget of "
        f"{PHASE14_BUDGET_S:.0f} s")
    return total


def phase14_main() -> int:
    """One rank of phase 14 (torch.distributed.run, four ranks on the one
    card, gloo), f32 copies: (a) llada-8b at full width, PHASE14_LAYERS
    layers, prefill + decode on (2, 2) (a head-parallel cache, route A);
    (b) qwen2-0.5b at full width, PHASE14B_LAYERS layers, prefill +
    decode on (1, 4) (two KV heads: a context-parallel cache, ``wk``'s
    shards half a head, q, k and v gathered); (c) qwen2-0.5b's f32 train
    step on (2, 2); each against one rank (``tp_serve_check``,
    ``tp_train_check``); after (a), (a')
    llada-8b in bf16 under ServePolicy() on (2, 2) (``tp_served_check``);
    then the recurrent families at full width and DEPTH_CUTS' depths:
    (d) mamba2-130m prefill + decode on (1, 4) (six SSD heads a rank: 24
    divide; in_proj's 3,352 columns gathered; the head gathered, 12,570
    columns a rank splitting MX blocks) and its train step on (1, 4);
    (e) recurrentgemma-2b prefill + decode on (2, 2) (the RG-LRU's gates
    row-parallel, MQA with a context-parallel cache, route C on 128,000
    columns a rank); after each of (d) and (e) the sampled decode step on
    its mesh (``tp_sampled_check``: the gathered head, route C).  Prints
    its launch counts (the ranks' sum)."""
    import torch.distributed as dist
    from repro_torch import device
    from repro_torch.configs import base
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    device.resolve(DEVICE)
    _build.build()
    t_phase = time.perf_counter()
    try:
        square = mesh_lib.make_debug_mesh(2, 2, DEVICE)
        row = mesh_lib.make_debug_mesh(1, 4, DEVICE)
        rank = square.rank
        say = log if rank == 0 else (lambda *a: None)
        for mesh in (square, row):
            require(mesh.backend == "gloo",
                    f"{mesh}: four ranks on one card must run gloo")
        total = {n: 0 for n in _build.COUNTED}

        def add(counts):
            for n, v in counts.items():
                total[n] += v

        cfg = base.get_config("llada-8b")
        cfg = cut_depth(cfg, PHASE14_LAYERS, "for four ranks sharing the "
                        "card, each with an f32 one-rank reference") \
            if rank == 0 else dataclasses.replace(
                cfg, n_layers=min(PHASE14_LAYERS, cfg.n_layers))
        add(tp_serve_check(square, cfg, say, "phase 14a"))
        free()
        dist.barrier()
        add(tp_served_check(square, cfg, say, "phase 14a"))
        free()
        dist.barrier()
        qcfg = base.get_config("qwen2-0.5b")
        qcfg = cut_depth(qcfg, PHASE14B_LAYERS, "for the script's time "
                         "limit (phase 14 runs the recurrent families "
                         "too)") if rank == 0 else dataclasses.replace(
            qcfg, n_layers=min(PHASE14B_LAYERS, qcfg.n_layers))
        add(tp_serve_check(row, qcfg, say, "phase 14b"))
        free()
        dist.barrier()
        add(tp_train_check(square, rank, say))
        free()
        for arch, mesh, tag in zip(PHASE14_RECURRENT, (row, square),
                                   ("phase 14d", "phase 14e")):
            dist.barrier()
            rcfg = base.get_config(arch)
            rcfg = cut_depth(rcfg, DEPTH_CUTS[arch], "for four ranks "
                             "sharing the card, each with an f32 one-rank "
                             "reference") if rank == 0 else \
                dataclasses.replace(rcfg, n_layers=min(DEPTH_CUTS[arch],
                                                       rcfg.n_layers))
            add(tp_serve_check(mesh, rcfg, say, tag))
            free()
            dist.barrier()
            add(tp_sampled_check(mesh, rcfg, say, tag))
            free()
        dist.barrier()
        add(tp_train_check(row, rank, say, "mamba2-130m",
                           DEPTH_CUTS["mamba2-130m"], "phase 14d"))
        free()
        names = sorted(total)
        both = torch.tensor([total[n] for n in names], dtype=torch.int64)
        dist.all_reduce(both)
        total = dict(zip(names, both.tolist()))
        dt = time.perf_counter() - t_phase
        say(f"phase 14: {dt:.1f} s in its job (budget "
            f"{PHASE14_BUDGET_S:.0f} s)")
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    if rank == 0:
        print(PHASE14_COUNTS + json.dumps(total), flush=True)
    mesh_lib.destroy()
    return 0


def dryrun_line() -> None:
    """The dry run's llada-8b decode_32k cell at (16, 16), traced on meta
    tensors (launch/dryrun.py): no card time."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llada-8b", "decode_32k")
    require(rec["status"] == "ok", f"dry run: {rec}")
    log(f"dry run (meta tensors, {time.perf_counter() - t0:.1f} s): "
        f"llada-8b decode_32k at 16x16, per device: "
        f"{rec['flops_per_device']:.4g} FLOPs, "
        f"{rec['bytes_per_device']:.4g} bytes (eager per-op), "
        f"{rec['collective_bytes_per_device']:.4g} collective bytes, "
        f"params {rec['param_bytes_per_device'] / 2 ** 30:.3f} GiB, cache "
        f"{rec['cache_bytes_per_device'] / 2 ** 30:.3f} GiB; roofline "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                    rec["roofline"].items())
        + f" (the H100's published peaks); bottleneck {rec['bottleneck']}")


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for sub in tree for t in _flat(sub)]


def attn_row(q, kk, v, valid, what: str, n_layers: int) -> dict:
    """flash_bidir on q (B, Sq, Hq, D) over kk/v (B, Skv, Hkv, D) bf16
    (``valid`` (B, Skv) or None) against its plain version (within one
    bf16 ulp + 1e-6), its device time (a graph of 20 calls) beside its
    bound, the plain version's and SDPA's (K/V repeated beforehand);
    ``n_layers`` calls a tick.  Returns the row's numbers."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_bidir as fb
    B, Sq, Hq, D = q.shape
    Skv, Hkv = kk.shape[1], kk.shape[2]
    n_keys = B * Skv if valid is None else int(valid.sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * n_keys * Hkv * D * 2
                       + (0 if valid is None else valid.numel()),
                       4.0 * Hq * Sq * n_keys * D, BF16_FLOPS)
    got = fb.flash_bidir(q, kk, v, valid)
    want = fb.flash_bidir_plain(q, kk, v, valid)
    err = (got.float() - want.float()).abs()
    excess = float((err - bf16_ulp(want)).max())
    require(excess <= 1e-6, f"{what}: beyond one bf16 ulp + 1e-6")
    qt = q.transpose(1, 2)
    kt = kk.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    mask = None if valid is None else valid[:, None, None, :]
    fn = lambda: fb.flash_bidir(q, kk, v, valid)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    row = dict(max_abs_err=float(err.max()),
               device_ms=kernel_ms(fn, 20, what), ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: fb.flash_bidir_plain(q, kk, v,
                                                             valid), 5),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=kernel_ms(lib, 20, f"{what} sdpa"))
    log(f"{what}, within one bf16 ulp of plain (max abs err "
        f"{row['max_abs_err']:.3g}): device {row['device_ms']:.4f} ms a call "
        f"(a graph of 20 calls), {row['device_ms'] * n_layers:.3f} ms for "
        f"{n_layers} calls; CUDA events, back to back {row['ms']:.4f} ms; "
        f"plain {row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
        f"{row['device_ms'] / b_ms:.1f}x; scaled_dot_product_attention "
        f"device {row['library_ms']:.4f} ms")
    return row


def stablemax_row(zl, mid: int, who: str) -> dict:
    """stablemax_sampling mxfp8 greedy on logits zl (R, V) against its
    plain version (check_stablemax_case), its device time (a graph of 20
    calls) beside its byte bound, the plain version's and softmax + max's.
    Returns the row's numbers."""
    from repro_torch.kernels import stablemax_sampling as sms
    R, V = zl.shape
    what = f"({R}, {V}) {str(zl.dtype).replace('torch.', '')}"
    err = check_stablemax_case(zl, "mxfp8_e4m3", 0.0, mid, what)
    kw = dict(fmt="mxfp8_e4m3", suppress_id=mid)
    b_ms, b_by = bound(zl.numel() * zl.element_size() + R * 8,
                       4.0 * zl.numel(), F32_FLOPS)
    fn = lambda: sms.stablemax_sampling(zl, **kw)  # noqa: E731
    lib = lambda: torch.max(torch.softmax(zl, -1), -1)  # noqa: E731
    row = dict(max_abs_err=err,
               device_ms=kernel_ms(fn, 20, f"{who} stablemax_sampling"),
               ms=time_ms(fn, 20),
               plain_ms=time_ms(lambda: sms.stable_max_plain(zl, **kw), 20),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=kernel_ms(lib, 20, "softmax + max"))
    log(f"{who} stablemax_sampling mxfp8 greedy {what}: conf max abs err "
        f"{err:.3g}; device {row['device_ms']:.4f} ms (a graph of 20 "
        f"calls), CUDA events, back to back {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{row['device_ms'] / b_ms:.1f}x; softmax + max device "
        f"{row['library_ms']:.4f} ms")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import device
        from repro_torch.configs import base
        from repro_torch.kernels import _build
        from repro_torch.models.registry import build_model
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    device.resolve("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    try:
        t0 = time.perf_counter()
        logs = _build.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line:
                    log(f"  {name}: {line.strip()}")
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        kernels = phase_kernels(gen)

        cfg = base.get_config("llada-8b")
        model = build_model(cfg, DEVICE)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"llada-8b params: {cfg.param_count() / 1e9:.2f} B, init "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        phase_e2e(model, params, gen)
        for cache_mode in ("dual", "prefix"):
            phase_cached(model, params, gen, cache_mode)
        launches, slot_paths = phase_engine(model, params)
        for name, n in phase_paged(model, params, slot_paths).items():
            launches[name] += n
        for name, n in phase_table6(model, params, gen).items():
            launches[name] += n
        t0 = time.perf_counter()
        for counts in (phase_breakdown(model, params, slot_paths),
                       phase_obs(model, params), phase_http(model, params)):
            for name, n in counts.items():
                launches[name] += n
        log(f"phase 6a-6c: {time.perf_counter() - t0:.1f} s")
        for name, n in phase_formats_random_sim(
                model, params, gen,
                slot_paths["warm"]["sampling_stage"]).items():
            launches[name] += n
        t12 = time.perf_counter()
        for counts in (phase_mesh(model, params, slot_paths),
                       phase_split_cache(model, params, gen)):
            for name, n in counts.items():
                launches[name] += n
        t12 = time.perf_counter() - t12
        from repro_torch.launch import mesh as mesh_lib
        phase_analysis(mesh_lib.make_debug_mesh(1, 1, DEVICE))
        for name, n in phase_steps_serve(model, params, gen).items():
            launches[name] += n
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        for name, n in phase_configs(gen).items():
            launches[name] += n
        t0 = time.perf_counter()
        phase_cli()
        log(f"phase 6d: {time.perf_counter() - t0:.1f} s")
        for name, n in phase_moe(gen).items():
            launches[name] += n
        t0 = time.perf_counter()
        for name, n in phase_recurrent(gen).items():
            launches[name] += n
        log(f"phase 8: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, n in phase_audio_vlm_process().items():
            launches[name] += n
        log(f"phase 9 (its own process): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, n in phase_train_process().items():
            launches[name] += n
        log(f"phase 11 (its own process): {time.perf_counter() - t0:.1f} s")
        # phase 12b's two-rank job, after phase 11: its phase 13c restores
        # the checkpoint phase 11 keeps
        t0 = time.perf_counter()
        for name, n in phase_mesh_ranks().items():
            launches[name] += n
        t12 += time.perf_counter() - t0 - PHASE13_S.get("13c", 0.0)
        for name, n in phase_tp_ranks().items():
            launches[name] += n
        dryrun_line()
        log(f"phase 12: {t12:.1f} s (budget {PHASE12_BUDGET_S} s)")
        t13 = sum(PHASE13_S.values())
        log(f"phase 13: {t13:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(PHASE13_S.items()))
            + f") against its budget of {PHASE13_BUDGET_S:.0f} s")
        require(sorted(PHASE13_S) == ["13a", "13b", "13c"],
                f"phase 13 ran only {sorted(PHASE13_S)}")
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    rows = [dict(name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/"
                        f"{_build.ROUTES.get(name, name)}.cu",
                 replaces=REPLACES[name], launches=launches[name],
                 **kernels[name]) for name in _build.COUNTED]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [PHASE12B_ARG]:      # a rank of phase 12b's job
        sys.exit(phase12b_main())
    if sys.argv[1:] == [PHASE14_ARG]:       # a rank of phase 14's job
        sys.exit(phase14_main())
    sys.exit(main())
