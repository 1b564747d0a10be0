"""Cycle-level simulator of the paper's sampling datapath, a port of
src/repro/sim/cycle.py (pure Python over ``isa`` and ``trace``; it gives
the JAX package's floats, not just close ones).

Executes an instruction trace recorded from the port's tick
(sim/trace.py) against a parameterized NPU (sim/isa.NPUConfig).  Where
sim/analytical.py sums closed-form per-op rooflines, this simulator walks
the actual op stream with a decoupled-pipeline timing model:

  * per-engine clocks (vector / scalar / matrix / HBM / net): an op issues
    when its engine frees AND its upstream producers finish;
  * decoupled access/execute: HBM reads prefetch back-to-back on the burst
    engine (never blocked by compute), so a chunked stream double-buffers
    naturally -- compute for chunk c overlaps the read of chunk c+1;
  * compute ops wait on the latest memory finish preceding them in program
    order plus the latest finish of their upstream compute engine
    (matrix feeds vector feeds scalar -- the sampling datapath's dataflow);
  * HBM bursts carry a storage format: bytes = elems * BYTES[fmt], and MX
    formats additionally pass the block-decode unit at
    ``mx_decode_width`` elements/cycle (cheap bytes can become
    decode-bound);
  * SRAM allocations are replayed with an in-place-reuse allocator:
    peak footprint, reuse count, and capacity overflow are reported.

Cross-validation: ``CROSSVAL_BAND`` is the agreed cycle-count band vs the
analytical stage models.  The cycle simulator sits *below* the analytical
sum-of-maxima because it overlaps engines the closed form serializes (GEMM
streaming under the vector reductions is the point of the fused path),
and *above* it on chunked streams because every chunk pays its pipeline
fill.  The times are the modeled NPU's, not the H100's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.sim import isa
from repro_torch.sim.trace import Trace, capture_sampling_trace

# Documented cycle-vs-analytical agreement bands (ratio = cycle_t /
# analytical_t) per head path, the JAX package's (docs/cycle_sim.md
# derives them); the tests assert simulated points stay inside.
CROSSVAL_BAND: Dict[str, tuple] = {
    "fused": (0.35, 1.25),
    "unfused": (0.6, 1.4),
    "legacy": (0.6, 1.4),
    "sharded": (0.4, 1.3),
    "engine": (0.7, 1.3),     # bare sampling engine (no head), table4 block
}

_UPSTREAM = {"matrix": (), "vector": ("matrix",), "scalar": ("vector",),
             "net": ("vector", "scalar")}


@dataclasses.dataclass
class StageStats:
    cycles: float = 0.0            # stage makespan
    start: float = math.inf
    end: float = 0.0
    busy: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    net_bytes: float = 0.0
    ops: int = 0


@dataclasses.dataclass
class SimResult:
    cycles: float
    npu: isa.NPUConfig
    stages: Dict[str, StageStats]
    hbm_bytes: float
    net_bytes: float
    macs: float
    vec_ops: float
    sram_peak_bytes: float
    sram_reuses: int
    sram_overflow_bytes: float
    n_ops: int

    @property
    def time_s(self) -> float:
        return self.cycles / self.npu.freq

    @property
    def sram_ok(self) -> bool:
        return self.sram_overflow_bytes == 0.0

    @property
    def energy_j(self) -> float:
        n = self.npu
        return (self.macs * n.e_mac_int8 + self.vec_ops * n.e_vec_op +
                (self.hbm_bytes + self.net_bytes) * n.e_hbm_byte +
                n.p_static * self.time_s)

    def stage_cycles(self) -> Dict[str, float]:
        return {k: v.cycles for k, v in self.stages.items()}


def _gemm_cycles(shape, npu: isa.NPUConfig) -> float:
    M, K, N = shape
    tiles = (math.ceil(M / npu.blen) * math.ceil(N / npu.blen)
             * math.ceil(K / npu.mlen))
    return math.ceil(tiles / npu.grid) * (1 + npu.blen) + npu.pipeline_fill


def _vector_cycles(op, npu: isa.NPUConfig) -> float:
    lat = isa.ISA[op.op].lat
    calls = math.ceil(op.elems / npu.vlen)
    issue = calls * lat
    # banked-SRAM port bound: f32 operand stream through the vector SRAM
    port = op.elems * 4.0 / npu.sram_bytes_per_cycle
    return max(issue, port) + npu.pipeline_fill


def _scalar_cycles(op, npu: isa.NPUConfig) -> float:
    lat = isa.ISA[op.op].lat
    return math.ceil(op.elems / npu.vlen) * lat + npu.pipeline_fill


def _hbm_cycles(op, npu: isa.NPUConfig) -> float:
    burst = op.bytes / npu.hbm_bytes_per_cycle
    if isa.is_mx(op.fmt):
        burst = max(burst, op.elems / npu.mx_decode_width)
    return burst


class _SramAllocator:
    """Replay SRAM_ALLOC/SRAM_FREE with an exact-fit free pool so repeated
    per-chunk buffers (weight slab, logit tile) register as in-place reuse
    instead of fresh footprint."""

    def __init__(self, capacity: float):
        self.capacity = capacity
        self.live: Dict[str, float] = {}
        self.free_pool: Dict[float, int] = {}
        self.live_bytes = 0.0
        self.peak = 0.0
        self.reuses = 0
        self.overflow = 0.0

    def alloc(self, name: str, nbytes: float) -> None:
        if name in self.live:           # rebind without free: in-place
            self.reuses += 1
            return
        if self.free_pool.get(nbytes, 0) > 0:
            self.free_pool[nbytes] -= 1
            self.reuses += 1
        self.live[name] = nbytes
        self.live_bytes += nbytes
        self.peak = max(self.peak, self.live_bytes)
        if self.live_bytes > self.capacity:
            self.overflow = max(self.overflow,
                                self.live_bytes - self.capacity)

    def free(self, name: str) -> None:
        nbytes = self.live.pop(name, 0.0)
        self.live_bytes -= nbytes
        if nbytes:
            self.free_pool[nbytes] = self.free_pool.get(nbytes, 0) + 1


def simulate(trace: Trace, npu: Optional[isa.NPUConfig] = None) -> SimResult:
    """Execute ``trace`` cycle-by-op on ``npu`` (defaults to the paper
    §6.2 operating point)."""
    npu = npu or isa.NPUConfig()
    clocks: Dict[str, float] = {}
    last_mem_finish = 0.0        # latest HBM/net finish in program order
    engine_last_finish: Dict[str, float] = {}
    sram = _SramAllocator(npu.sram_bytes)
    stages: Dict[str, StageStats] = {}
    hbm_bytes = net_bytes = macs = vec_ops = 0.0
    end_time = 0.0
    n_anon = 0

    def stage_of(name: str) -> StageStats:
        if name not in stages:
            stages[name] = StageStats()
        return stages[name]

    for op in trace:
        eng = op.engine
        st = stage_of(op.stage)
        st.ops += 1
        if eng == "sram":
            if op.op == "SRAM_ALLOC":
                n_anon += not op.note
                sram.alloc(op.note or f"anon{n_anon}", op.bytes)
            else:
                sram.free(op.note or "")
            continue
        if eng == "marker":
            continue

        if eng == "hbm":
            cyc = _hbm_cycles(op, npu)
            start = clocks.get("hbm", 0.0)
            if op.op == "HBM_WR":       # writeback waits for its producer
                start = max(start, max(engine_last_finish.values(),
                                       default=0.0))
            hbm_bytes += op.bytes
        elif eng == "net":
            cyc = npu.net_lat_cycles + \
                2.0 * op.bytes / npu.net_bytes_per_cycle   # send + recv
            start = max(clocks.get("net", 0.0),
                        max((engine_last_finish.get(e, 0.0)
                             for e in _UPSTREAM["net"]), default=0.0),
                        last_mem_finish)
            net_bytes += 2.0 * op.bytes
        else:                           # compute: matrix / vector / scalar
            if eng == "matrix":
                cyc = _gemm_cycles(op.shape, npu)
                M, K, N = op.shape
                macs += float(M) * K * N
            elif eng == "vector":
                cyc = _vector_cycles(op, npu)
                vec_ops += op.elems
            else:
                cyc = _scalar_cycles(op, npu)
            start = max(clocks.get(eng, 0.0), last_mem_finish,
                        max((engine_last_finish.get(e, 0.0)
                             for e in _UPSTREAM.get(eng, ())), default=0.0))

        end = start + cyc
        clocks[eng] = end
        if eng in ("hbm", "net"):
            last_mem_finish = end
        else:
            engine_last_finish[eng] = end
        st.start = min(st.start, start)
        st.end = max(st.end, end)
        st.cycles = st.end - st.start
        st.busy[eng] = st.busy.get(eng, 0.0) + cyc
        if eng == "hbm":
            st.hbm_bytes += op.bytes
        if eng == "net":
            st.net_bytes += 2.0 * op.bytes
        end_time = max(end_time, end)

    return SimResult(cycles=end_time, npu=npu, stages=stages,
                     hbm_bytes=hbm_bytes, net_bytes=net_bytes, macs=macs,
                     vec_ops=vec_ops, sram_peak_bytes=sram.peak,
                     sram_reuses=sram.reuses,
                     sram_overflow_bytes=sram.overflow,
                     n_ops=len(trace))


# ---------------------------------------------------------------------------
# Cross-validation against the analytical stage models
# ---------------------------------------------------------------------------


def crossval_sampling(*, B: int, L: int, V: int, d: int,
                      fmt: str = "mxfp8_e4m3", head_path: str = "fused",
                      chunk_v: int = 4096, model_shards: int = 1,
                      seq_len: Optional[int] = None, hw=None,
                      mask_id: int = 0) -> Dict[str, float]:
    """Capture the sampling-stage trace for ``head_path``, simulate it, and
    compare against the matching sim/analytical stage model.  Returns the
    numbers the agreement tests read (JAX's keys)."""
    from repro_torch.sim import analytical

    hw = hw or analytical.HWConfig()
    npu = isa.NPUConfig.from_hw(hw)
    tr = capture_sampling_trace(
        B=B, L=L, V=V, d=d, fmt=fmt, head_path=head_path, chunk_v=chunk_v,
        model_shards=model_shards, seq_len=seq_len, mask_id=mask_id)
    sim = simulate(tr, npu)
    if head_path == "fused":
        ana = analytical.fused_head_sampling_stage(B, L, V, d, hw)
    elif head_path == "sharded":
        ana = analytical.sharded_fused_head_sampling_stage(
            B, L, V, d, hw, model_shards=model_shards)
    elif head_path == "unfused":
        ana = analytical.unfused_head_sampling_stage(B, L, V, d, hw, fmt=fmt)
    elif head_path == "engine":
        ana = analytical.sampling_stage(B, L, V, hw, fmt=fmt)
    else:
        ana = analytical.unfused_head_sampling_stage(
            B, L, V, d, hw, fmt=fmt, logit_rows=B * (seq_len or L))
    band = CROSSVAL_BAND[head_path]
    ratio = sim.time_s / ana.t
    return {
        "head_path": head_path, "B": B, "L": L, "V": V, "d": d, "fmt": fmt,
        "model_shards": model_shards, "trace_ops": len(tr),
        "cycles": sim.cycles, "time_us": sim.time_s * 1e6,
        "analytical_us": ana.t * 1e6, "ratio_vs_analytical": ratio,
        "band": list(band), "within_band": band[0] <= ratio <= band[1],
        "hbm_bytes": sim.hbm_bytes, "analytical_hbm_bytes": ana.hbm_bytes,
        "net_bytes": sim.net_bytes,
        "sram_peak_bytes": sim.sram_peak_bytes,
        "sram_reuses": sim.sram_reuses, "sram_ok": sim.sram_ok,
        "stage_cycles": sim.stage_cycles(),
    }


# ---------------------------------------------------------------------------
# Hybrid end-to-end: analytical transformer phases + cycle-simulated
# sampling stage (the paper's methodology — the GEMM-phase model is
# RTL-calibrated closed-form, the sampling engine is simulated).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CycleE2EResult:
    total_s: float
    model_s: float
    sampling_s: float
    energy_j: float
    tokens: int
    sampling_sim: SimResult

    @property
    def tps(self) -> float:
        return self.tokens / self.total_s

    @property
    def tok_per_j(self) -> float:
        return self.tokens / self.energy_j

    @property
    def sampling_frac(self) -> float:
        return self.sampling_s / self.total_s


def end_to_end_cycle(cfg, hw=None, *, B: int, prompt: int, gen_len: int,
                     block_len: int, steps: int, cache_mode: str = "dual",
                     head_path: str = "fused", fmt: str = "mxfp8_e4m3",
                     chunk_v: int = 4096, model_shards: int = 1,
                     data_shards: int = 1, w_bytes: float = 0.5,
                     kv_bytes: float = 0.5,
                     trace: Optional[Trace] = None) -> CycleE2EResult:
    """Blocked-diffusion end-to-end on the cycle simulator: the per-step
    sampling stage is simulated from a captured trace (shape-dependent
    only, so one capture serves every hardware point of a DSE sweep via
    ``trace=``); transformer phases use the analytical per-phase model
    with the head GEMM removed (it lives in the fused/sharded stream)."""
    from repro_torch.sim import analytical

    hw = hw or analytical.HWConfig()
    npu = isa.NPUConfig.from_hw(hw)
    seq_len = prompt + gen_len
    # every captured sampling trace carries its own head work (fused
    # stream chunks / unfused block GEMM / legacy full-sequence GEMM via
    # emit_legacy_head), so the transformer side always runs headless
    model_cost = analytical.model_side_cost(
        cfg, hw, B=B, prompt=prompt, gen_len=gen_len, block_len=block_len,
        steps=steps, cache_mode=cache_mode, w_bytes=w_bytes,
        kv_bytes=kv_bytes, logits_rows=0)
    if trace is None:
        trace = capture_sampling_trace(
            B=B, L=block_len, V=cfg.vocab, d=cfg.d_model, fmt=fmt,
            head_path=head_path, chunk_v=chunk_v, model_shards=model_shards,
            data_shards=data_shards,
            seq_len=seq_len if head_path == "legacy" else None)
    sim = simulate(trace, npu)
    n_steps = (gen_len // block_len) * steps
    samp_s = sim.time_s * n_steps
    energy = model_cost.energy(hw) + sim.energy_j * n_steps
    return CycleE2EResult(
        total_s=model_cost.t + samp_s, model_s=model_cost.t,
        sampling_s=samp_s, energy_j=energy, tokens=B * gen_len,
        sampling_sim=sim)
