"""Analytical performance model (paper §4.1), a copy of
src/repro/sim/analytical.py on the port's ``models/config.ModelConfig``:
the drift baseline of ``obs/drift.modeled_tick_stages`` and the stage
models the cycle simulator (sim/cycle.py) is cross-validated against.

A hardware-derived per-instruction latency library, an
instruction-granularity roofline ``T_op = max(T_cmp, T_mem)``, per-phase
memory strategies for blocked diffusion (warm vs refine), and the
diffusion sampling engine model.  The numbers are the paper's NPU at its
§6.2 operating point, not an H100's: the drift monitor calibrates them
to measured seconds by one scale factor.

Latency library cycle counts follow paper Table 3 (RTL-calibrated):
V_* pipelined throughput + the -6-cycle pipeline-fill structural term the
paper identifies; GEMM tiles cost (1 + BLEN) cycles pipelined.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.sim.isa import BYTES, ISA

# ---------------------------------------------------------------------------
# Hardware configuration (paper §6.2 operating point by default)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HWConfig:
    blen: int = 64                 # systolic sub-array dim (BLEN x BLEN PEs)
    mlen: int = 512                # K-slice width
    vlen: int = 2048               # vector lanes
    grid: int = 4                  # Matrix Unit grid replication (§3.1.2:
    #                                "replicates this structure as a grid")
    freq: float = 1e9              # 1 GHz (ASAP7 synthesis point)
    hbm_stacks: int = 4
    hbm_bw_per_stack: float = 409.5e9   # bytes/s (819 GB/s per 2 stacks)
    vsram_bw: float = 2048e9       # on-chip vector port bound
    pipeline_fill: int = 6         # paper Table 3 structural overhead
    # energy model (7nm-class constants, calibrated so Table-6 tok/J
    # ratios vs the A6000 rows land near the paper's x18-x23 band)
    e_mac_int8: float = 0.6e-12    # J per int8 MAC incl. local movement
    e_vec_op: float = 1.2e-12      # J per vector lane-op
    e_hbm_byte: float = 6.0e-12    # J per HBM byte
    p_static: float = 12.0         # W

    @property
    def hbm_bw(self) -> float:
        return self.hbm_stacks * self.hbm_bw_per_stack

    @property
    def pes(self) -> int:
        return self.blen * self.blen * max(1, self.mlen // self.blen) \
            * self.grid

    @property
    def peak_macs(self) -> float:
        return self.pes * self.freq


# paper Table 3 single-instruction pipelined cycle counts — derived from
# the ISA table (sim/isa.py), as in the JAX package, so the two can never
# disagree on a latency (retuning happens in exactly one table)
LATENCY_LIB: Dict[str, int] = {
    name: instr.lat for name, instr in ISA.items()
    if instr.engine in ("vector", "scalar")}


@dataclasses.dataclass
class Cost:
    """Per-op roofline (paper §4.1): T_op = max(T_cmp, T_mem) applied at
    instruction granularity; composing ops SUMS the per-op maxima
    (``t_roof``), keeping the cmp/mem components for diagnostics."""
    t_cmp: float = 0.0
    t_mem: float = 0.0
    macs: float = 0.0
    vec_ops: float = 0.0
    hbm_bytes: float = 0.0
    t_roof: float = -1.0

    def __post_init__(self):
        if self.t_roof < 0:
            self.t_roof = max(self.t_cmp, self.t_mem)

    @property
    def t(self) -> float:
        return self.t_roof

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.t_cmp + o.t_cmp, self.t_mem + o.t_mem,
                    self.macs + o.macs, self.vec_ops + o.vec_ops,
                    self.hbm_bytes + o.hbm_bytes,
                    t_roof=self.t_roof + o.t_roof)

    def energy(self, hw: HWConfig) -> float:
        return (self.macs * hw.e_mac_int8 + self.vec_ops * hw.e_vec_op +
                self.hbm_bytes * hw.e_hbm_byte + hw.p_static * self.t)


# ---------------------------------------------------------------------------
# GEMM (systolic Matrix Unit, paper §3.1.2)
# ---------------------------------------------------------------------------

def gemm(M: int, K: int, N: int, hw: HWConfig, *, w_bytes: float = 0.5,
         act_bytes: float = 1.0, stream_weights: bool = True) -> Cost:
    """Output-stationary tiled GEMM: tiles of BLEN x BLEN over MLEN K-slices."""
    tiles = (math.ceil(M / hw.blen) * math.ceil(N / hw.blen)
             * math.ceil(K / hw.mlen))
    cycles = math.ceil(tiles / hw.grid) * (1 + hw.blen) + hw.pipeline_fill
    t_cmp = cycles / hw.freq
    bytes_ = M * K * act_bytes + (K * N * w_bytes if stream_weights else 0.0) \
        + M * N * 2.0  # bf16 writeback
    return Cost(t_cmp=t_cmp, t_mem=bytes_ / hw.hbm_bw,
                macs=float(M) * K * N, hbm_bytes=bytes_)


def vector_pass(n_elements: float, hw: HWConfig, instr: str = "V_ADD_VV",
                bytes_per_elt: float = 2.0, from_hbm: bool = True) -> Cost:
    calls = math.ceil(n_elements / hw.vlen)
    cycles = calls * LATENCY_LIB.get(instr, 7) + hw.pipeline_fill
    b = n_elements * bytes_per_elt if from_hbm else 0.0
    return Cost(t_cmp=cycles / hw.freq,
                t_mem=b / hw.hbm_bw if from_hbm
                else n_elements * bytes_per_elt / hw.vsram_bw,
                vec_ops=n_elements, hbm_bytes=b)


# ---------------------------------------------------------------------------
# Diffusion sampling engine (paper §3.2, Alg. 2)
# ---------------------------------------------------------------------------

def sampling_stage(B: int, L: int, V: int, hw: HWConfig, *,
                   v_chunk: Optional[int] = None, fmt: str = "mxfp8_e4m3",
                   two_pass: bool = True) -> Cost:
    """Per-diffusion-step sampling over Z (B, L, V).

    ``two_pass=True`` is the paper-faithful engine (V_RED_MAX_IDX pass then
    V_EXP_V+V_RED_SUM pass -> logits streamed twice when V_chunk < V);
    ``two_pass=False`` models the fused single-pass kernel.
    """
    bpe = BYTES[fmt]
    v_chunk = v_chunk or V
    rows = B * L
    n = rows * V

    passes = 2 if (two_pass and v_chunk < V) else 1
    # Phase 1: stream logits, max+idx (and exp+sum)
    c = Cost()
    c += vector_pass(n, hw, "V_RED_MAX_IDX", bpe)          # max+idx stream
    if passes == 2:
        c += vector_pass(n, hw, "V_EXP_V", bpe)            # re-stream
    else:
        c += vector_pass(n, hw, "V_EXP_V", 0.0, from_hbm=False)
    c += vector_pass(n, hw, "V_RED_SUM", 0.0, from_hbm=False)
    # Phase 2: scalar write-back (L FP + L Int per sequence)
    c += vector_pass(2.0 * rows, hw, "S_ST", 4.0, from_hbm=False)
    # Phase 3: map + streaming top-k over L entries
    c += vector_pass(rows, hw, "S_MAP_V_FP", 0.0, from_hbm=False)
    c += vector_pass(rows, hw, "V_TOPK_MASK_PER_ELT", 0.0, from_hbm=False)
    # Phase 4: integer masked update (2x V_SELECT_INT)
    c += vector_pass(2.0 * rows, hw, "V_SELECT_INT", 0.0, from_hbm=False)
    return c


def reference_sampling_stage(B: int, L: int, V: int, hw: HWConfig, *,
                             fmt: str = "fp64") -> Cost:
    """The *reference software* sampling path (paper Fig. 1 baseline):
    materializes the full softmax probability tensor (Eq. 2) instead of
    Stable-Max — exp pass, sum pass, divide+write pass, argmax pass, and a
    top-k sort pass, each streaming (B, L, V) at ``fmt`` width.  FP64
    additionally runs the vector unit at 1/4 lane throughput (64-bit lanes).
    The paper has it at up to 71% of end-to-end latency on the MoE
    dual-cache configuration."""
    bpe = BYTES[fmt]
    slow = 4.0 if fmt in ("fp64", "none") else (1.0 if bpe <= 2 else 2.0)
    n = float(B) * L * V
    c = Cost()
    c += vector_pass(n, hw, "V_EXP_V", bpe) * slow            # exp(z)
    c += vector_pass(n, hw, "V_RED_SUM", 0.0, from_hbm=False) * slow
    c += vector_pass(n, hw, "V_ADD_VV", 2 * bpe) * slow       # p=e/sum, write
    c += vector_pass(n, hw, "V_RED_MAX_IDX", bpe) * slow      # argmax read
    c += vector_pass(n, hw, "V_RED_MAX", bpe) * slow          # top-k/sort pass
    c += vector_pass(2.0 * B * L, hw, "V_SELECT_INT", 0.0, from_hbm=False)
    return c


def fused_head_sampling_stage(B: int, L: int, V: int, d: int, hw: HWConfig,
                              *, w_bytes: float = 0.5, act_bytes: float = 2.0
                              ) -> Cost:
    """Fused LM-head + Stable-Max stage (docs/fused_sampling.md).

    The head GEMM streams (TILE_R x CHUNK_V) logit tiles through VMEM
    straight into the online (m, argmax, exp-sum) reduction, so the only
    HBM traffic is the (B*L, d) hidden read + the (d, V) weight stream —
    O(B*L*d + d*V) instead of the unfused O(B*L*V) logits write/read (plus
    the same weight stream).  Vector work is unchanged from the single-pass
    engine; it just sources logits from VMEM — which is why, unlike
    ``unfused_head_sampling_stage``, no sampling-precision ``fmt`` enters
    the byte count."""
    rows = B * L
    n = float(rows) * V
    g = gemm(rows, d, V, hw, w_bytes=w_bytes, act_bytes=act_bytes)
    bytes_ = rows * d * act_bytes + d * V * w_bytes    # no M*N writeback
    c = Cost(t_cmp=g.t_cmp, t_mem=bytes_ / hw.hbm_bw, macs=g.macs,
             hbm_bytes=bytes_)
    c += vector_pass(n, hw, "V_RED_MAX_IDX", 0.0, from_hbm=False)
    c += vector_pass(n, hw, "V_EXP_V", 0.0, from_hbm=False)
    c += vector_pass(n, hw, "V_RED_SUM", 0.0, from_hbm=False)
    c += vector_pass(2.0 * rows, hw, "S_ST", 4.0, from_hbm=False)
    c += vector_pass(rows, hw, "S_MAP_V_FP", 0.0, from_hbm=False)
    c += vector_pass(rows, hw, "V_TOPK_MASK_PER_ELT", 0.0, from_hbm=False)
    c += vector_pass(2.0 * rows, hw, "V_SELECT_INT", 0.0, from_hbm=False)
    return c


def sharded_fused_head_sampling_stage(B: int, L: int, V: int, d: int,
                                      hw: HWConfig, *, model_shards: int = 1,
                                      data_shards: int = 1,
                                      w_bytes: float = 0.5,
                                      act_bytes: float = 2.0) -> Cost:
    """*Per-chip* cost of the SPMD fused head + Stable-Max tick over a
    (data, model) mesh (core/diffusion.get_spmd_tick_fn).

    The data axis shards the B*L sampled rows; the model axis shards the
    (d, V) head columns.  Each chip streams its own (d, V/n_model) shard
    through the online reduction — per-chip sampling HBM traffic drops from
    O(R*d + d*V) to O(R_loc*d + d*V/n_model), i.e. the dominant weight
    stream shrinks linearly in the model-axis size.  The combine is one
    pmax + psum + pmin of three R_loc-length partial vectors ((m, idx, S)
    per row), charged here as interconnect bytes — vanishing next to the
    head stream."""
    B_loc = -(-B // data_shards)
    vloc = -(-V // model_shards)
    # per-chip view == the unsharded fused stage at (B_loc, vloc) — delegate
    # so the two models can never drift (ratio_vs_1 baselines on equality)
    c = fused_head_sampling_stage(B_loc, L, vloc, d, hw, w_bytes=w_bytes,
                                  act_bytes=act_bytes)
    if model_shards > 1:
        combine_bytes = 2.0 * 3 * B_loc * L * 4.0   # send+recv x (m, idx, S)
        c += Cost(t_mem=combine_bytes / hw.hbm_bw, hbm_bytes=combine_bytes)
    return c


def unfused_head_sampling_stage(B: int, L: int, V: int, d: int,
                                hw: HWConfig, *, fmt: str = "mxfp8_e4m3",
                                w_bytes: float = 0.5, act_bytes: float = 2.0,
                                logit_rows: Optional[int] = None,
                                two_pass: bool = False) -> Cost:
    """The unfused comparison point: head GEMM writes ``logit_rows`` x V
    logits back to HBM (bf16), then the sampling engine streams the B*L
    active rows back in at the sampling precision.  ``logit_rows`` defaults
    to B*L (the block-sliced fallback); the pre-fusion serving tick
    materialized the *full-sequence* B*S rows — pass that to model it."""
    rows = logit_rows if logit_rows is not None else B * L
    c = gemm(rows, d, V, hw, w_bytes=w_bytes, act_bytes=act_bytes)
    c += sampling_stage(B, L, V, hw, fmt=fmt, v_chunk=4096,
                        two_pass=two_pass)
    return c


def sampling_sram_footprint(B: int, L: int, V: int, v_chunk: int,
                            vlen: int) -> Dict[str, float]:
    """Paper Eq. 4-6 (bytes; vector/FP entries bf16 = 2B, int = 4B)."""
    if v_chunk < V:
        vec = 3 * B * L + v_chunk
    else:
        r = 1
        vec = 3 * B * L + V * L * r
    return {"vector_sram": vec * 2.0,
            "fp_sram": max(L, vlen) * 2.0,
            "int_sram": 2 * B * L * 4.0}


# ---------------------------------------------------------------------------
# Transformer forward (paper Alg. 1) per phase
# ---------------------------------------------------------------------------

def transformer_pass(cfg: ModelConfig, B: int, seg: int, s_tot: int,
                     hw: HWConfig, *, kv_resident: bool = False,
                     w_bytes: float = 0.5, kv_bytes: float = 0.5,
                     logits_rows: Optional[int] = None) -> Cost:
    """One forward over a segment of ``seg`` tokens attending to s_tot KV."""
    d = cfg.d_model
    hq = cfg.n_heads * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head
    M = B * seg
    c = Cost()
    for _ in range(cfg.n_layers):
        c += gemm(M, d, hq + 2 * hkv, hw, w_bytes=w_bytes)        # QKV
        # bidirectional attention: QK^T + PV over full s_tot
        kv_ctx = min(s_tot, cfg.window or s_tot)
        att_bytes = 0.0 if kv_resident else \
            2 * B * kv_ctx * hkv * kv_bytes
        qk = gemm(M, cfg.d_head, kv_ctx, hw, w_bytes=0.0,
                  stream_weights=False)
        qk = Cost(qk.t_cmp * cfg.n_heads, att_bytes / hw.hbm_bw,
                  qk.macs * cfg.n_heads, 0.0, att_bytes)
        c += qk
        pv = gemm(M, kv_ctx, cfg.d_head, hw, w_bytes=0.0,
                  stream_weights=False)
        c += Cost(pv.t_cmp * cfg.n_heads, 0.0, pv.macs * cfg.n_heads, 0, 0)
        c += vector_pass(M * kv_ctx * cfg.n_heads / 8, hw, "V_EXP_V", 0.0,
                         from_hbm=False)                          # softmax
        c += gemm(M, hq, d, hw, w_bytes=w_bytes)                  # O proj
        if cfg.moe is not None:
            m = cfg.moe
            c += gemm(M, d, m.num_experts, hw, w_bytes=w_bytes)   # router
            c += gemm(M * m.top_k, d, m.d_ff_expert, hw, w_bytes=w_bytes) * 1
            c += gemm(M * m.top_k, d, m.d_ff_expert, hw, w_bytes=w_bytes)
            c += gemm(M * m.top_k, m.d_ff_expert, d, hw, w_bytes=w_bytes)
            fs = m.d_ff_shared or m.num_shared_experts * m.d_ff_expert
            if fs:
                c += gemm(M, d, 2 * fs, hw, w_bytes=w_bytes)
                c += gemm(M, fs, d, hw, w_bytes=w_bytes)
        else:
            mult = 3 if cfg.ffn in ("swiglu", "geglu") else 2
            c += gemm(M, d, cfg.d_ff, hw, w_bytes=w_bytes)
            if mult == 3:
                c += gemm(M, d, cfg.d_ff, hw, w_bytes=w_bytes)
            c += gemm(M, cfg.d_ff, d, hw, w_bytes=w_bytes)
        c += vector_pass(2 * M * d, hw, "V_ADD_VV", 0.0, from_hbm=False)
    rows = logits_rows if logits_rows is not None else M
    if rows:        # rows == 0: head fused into the sampling stage
        c += gemm(rows, d, cfg.vocab, hw, w_bytes=w_bytes)        # LM head
    return c


# Cost scaling helper for MoE gemm replication above
def _scale(c: Cost, f: float) -> Cost:
    return Cost(c.t_cmp * f, c.t_mem * f, c.macs * f, c.vec_ops * f,
                c.hbm_bytes * f, t_roof=c.t_roof * f)
Cost.__mul__ = lambda self, f: _scale(self, f)          # noqa: E305


# ---------------------------------------------------------------------------
# Blocked diffusion end-to-end (paper §4.1 per-phase strategy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class E2EResult:
    total_s: float
    model_s: float
    sampling_s: float
    energy_j: float
    tokens: int

    @property
    def tps(self) -> float:
        return self.tokens / self.total_s

    @property
    def tok_per_j(self) -> float:
        return self.tokens / self.energy_j

    @property
    def sampling_frac(self) -> float:
        return self.sampling_s / self.total_s


def model_side_cost(cfg: ModelConfig, hw: HWConfig, *, B: int, prompt: int,
                    gen_len: int, block_len: int, steps: int,
                    cache_mode: str = "dual", w_bytes: float = 0.5,
                    kv_bytes: float = 0.5, logits_rows: int = 0) -> Cost:
    """Transformer-phase cost of one blocked-diffusion decode (warm +
    refinement forwards per block, paper §4.1) *without* the sampling
    stage.  ``end_to_end`` composes this with an analytical sampling
    engine; sim/cycle.end_to_end_cycle composes it with the trace-driven
    cycle simulator (which carries its own head work, hence
    ``logits_rows=0`` there)."""
    n_blocks = gen_len // block_len
    s_tot = prompt + gen_len
    model = Cost()
    for _ in range(n_blocks):
        if cache_mode == "none":
            for _ in range(steps):
                model += transformer_pass(cfg, B, s_tot, s_tot, hw,
                                          w_bytes=w_bytes, kv_bytes=kv_bytes,
                                          logits_rows=logits_rows)
        else:
            model += transformer_pass(cfg, B, s_tot, s_tot, hw,
                                      w_bytes=w_bytes, kv_bytes=kv_bytes,
                                      logits_rows=logits_rows)       # warm
            seg = block_len if cache_mode == "dual" else \
                (s_tot - prompt)  # prefix mode recomputes block+suffix
            for _ in range(steps - 1):
                model += transformer_pass(
                    cfg, B, seg, s_tot, hw, kv_resident=(cache_mode == "dual"),
                    w_bytes=w_bytes, kv_bytes=kv_bytes,
                    logits_rows=logits_rows)
    return model


def end_to_end(cfg: ModelConfig, hw: HWConfig, *, B: int, prompt: int,
               gen_len: int, block_len: int, steps: int,
               cache_mode: str = "dual", sampling_fmt: str = "bf16",
               w_bytes: float = 0.5, kv_bytes: float = 0.5,
               two_pass_sampling: bool = True,
               sampling_engine: str = "dart",
               v_chunk: Optional[int] = None,
               model_shards: int = 1, data_shards: int = 1) -> E2EResult:
    """T_block = T_warm(L_tot) + (steps-1) * T_refine(L)  (paper §4.1).

    ``sampling_engine='fused'`` models the fused LM-head + Stable-Max path:
    the head GEMM leaves the model pass (logits_rows=0) and its streamed
    cost is charged to the sampling stage instead.  ``'sharded'`` is the
    per-chip SPMD variant: the sampling stage sees only this chip's
    (B/data_shards) rows x (V/model_shards) head columns (the model pass is
    still charged globally — forward TP is out of scope here).

    Every family gets the dense-shaped estimate, as in the JAX package:
    it holds no recurrent scan and no encoder or cross-attention."""
    n_blocks = gen_len // block_len
    lrows = 0 if sampling_engine in ("fused", "sharded") else B * block_len
    model = model_side_cost(cfg, hw, B=B, prompt=prompt, gen_len=gen_len,
                            block_len=block_len, steps=steps,
                            cache_mode=cache_mode, w_bytes=w_bytes,
                            kv_bytes=kv_bytes, logits_rows=lrows)
    samp = Cost()
    for _ in range(n_blocks):
        for _ in range(steps):
            if sampling_engine == "reference":
                samp += reference_sampling_stage(B, block_len, cfg.vocab, hw,
                                                 fmt=sampling_fmt)
            elif sampling_engine == "fused":
                samp += fused_head_sampling_stage(
                    B, block_len, cfg.vocab, cfg.d_model, hw,
                    w_bytes=w_bytes)
            elif sampling_engine == "sharded":
                samp += sharded_fused_head_sampling_stage(
                    B, block_len, cfg.vocab, cfg.d_model, hw,
                    model_shards=model_shards, data_shards=data_shards,
                    w_bytes=w_bytes)
            else:
                samp += sampling_stage(B, block_len, cfg.vocab, hw,
                                       fmt=sampling_fmt, v_chunk=v_chunk,
                                       two_pass=two_pass_sampling)
    total = model.t + samp.t
    energy = (model + samp).energy(hw)
    return E2EResult(total, model.t, samp.t, energy, B * gen_len)


# ---------------------------------------------------------------------------
# Host overhead model (megatick amortization, docs/megatick.md)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostConfig:
    """Per-*dispatch* host-side overhead, outside the NPU roofline.

    The device-side stage models above charge zero host time — correct for
    the paper's NPU operating point but not for a Python serving loop,
    where every executable launch pays a fixed tax: argument flattening +
    dispatch (``dispatch_s``) and the result fetch / ``block_until_ready``
    sync (``sync_s``).  A K-tick megastep pays each **once per megastep**,
    so the per-tick charge is the per-dispatch cost divided by K — the
    amortization BENCH_megatick measures and DriftMonitor models.

    Defaults are the order of magnitude a smoke-scale CPU engine measures
    for a jitted tick dispatch; pass measured values for tighter bands.
    """

    dispatch_s: float = 2e-4
    sync_s: float = 1e-4
    # paged-pool bookkeeping flush (staged canvas page uploads + dirty
    # block-table refreshes) per dispatch; only charged when the engine
    # runs the paged backend
    page_io_s: float = 5e-5


def host_overhead_per_tick(host: HostConfig,
                           megatick_k: int = 1,
                           paged: bool = False) -> Dict[str, float]:
    """Modeled per-tick host stage seconds under K-tick megastepping.

    Returns ``{"dispatch": s, "device_sync": s}`` (plus ``"paged_io"``
    with ``paged=True``) — the same stage names the engine's tick-path
    timers record, so the dict can be merged directly into a
    :func:`repro_torch.obs.drift.modeled_tick_stages` baseline.  All entries
    are per-dispatch costs amortized over the K fused ticks (the paged
    flush runs once per megastep: tables are constant across it).
    """
    if megatick_k < 1:
        raise ValueError(f"megatick_k must be >= 1, got {megatick_k}")
    out = {"dispatch": host.dispatch_s / megatick_k,
           "device_sync": host.sync_s / megatick_k}
    if paged:
        out["paged_io"] = host.page_io_s / megatick_k
    return out
