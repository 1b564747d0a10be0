"""Instruction set + NPU configuration of the cycle-level simulator, a
copy of src/repro/sim/isa.py.

The trace-driven simulator (sim/cycle.py) executes instruction streams
recorded from the port's tick (sim/trace.py).  This module is the shared
vocabulary: every ``TraceOp.op`` names an :class:`Instr` here, each bound to
an execution engine and (for vector/scalar ops) the paper Table 3
RTL-calibrated pipelined cycle count -- the latency library
sim/analytical.py uses too, so the two simulators can be cross-validated
without retuning constants.  The numbers describe the paper's NPU, not the
H100 the port runs on.

Engines
  vector   VLEN-lane vector unit (reductions, exp, select, top-k mask)
  scalar   scalar/FP sidecar (reciprocal, map, scalar stores)
  matrix   systolic Matrix Unit (BLEN x BLEN tiles over MLEN K-slices)
  hbm      HBM burst engine (decoupled access/execute; MX decode in-line)
  net      inter-chip collective port (vocab-sharded combine)
  sram     SRAM/VMEM allocator meta-ops (zero time; footprint accounting)
  marker   zero-cost annotations (e.g. the opaque transformer forward)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# ---------------------------------------------------------------------------
# Storage formats (bytes / element); the analytical model imports this
# table.  As in the JAX package it has no mxfp6_e3m2 and no short aliases
# ("fp8", "int4"): a trace in those formats records, and simulating it
# raises KeyError, as JAX's does.
# ---------------------------------------------------------------------------

BYTES: Dict[str, float] = {
    "mxint4": 0.5, "mxint8": 1.0, "mxfp8_e4m3": 1.0, "mxfp4_e2m1": 0.5,
    "bf16": 2.0, "fp32": 4.0, "int32": 4.0, "fp64": 8.0, "none": 8.0,
    "bool": 1.0,
}


def fmt_bytes(fmt: str) -> float:
    return BYTES[fmt]


def is_mx(fmt: str) -> bool:
    """MX formats pass through the block decode unit on the HBM path."""
    return fmt.startswith("mx")


# Row tile of the Pallas fused-head kernel (src/repro/kernels/
# fused_head_sampling.py, tile_r): the per-grid-step logit tile staged in
# the NPU's SRAM is (TILE_R, chunk_v).  The trace describes that NPU, not
# the port's CUDA kernel, whose tiles are its own.
TILE_R = 8


# ---------------------------------------------------------------------------
# Instruction set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Instr:
    name: str
    engine: str          # vector | scalar | matrix | hbm | net | sram | marker
    lat: int = 0         # pipelined cycles per VLEN-wide call (vector/scalar)


_INSTRS = [
    # vector unit (paper Table 3 pipelined cycle counts)
    Instr("V_ADD_VV", "vector", 7),
    Instr("V_EXP_V", "vector", 7),
    Instr("V_RED_MAX", "vector", 4),
    Instr("V_RED_MAX_IDX", "vector", 4),
    Instr("V_RED_SUM", "vector", 20),
    Instr("V_TOPK_MASK_PER_ELT", "vector", 1),
    Instr("V_SELECT_INT", "vector", 2),
    # counter-based Gumbel draw (hash + u + -log(-log u)): three fused
    # vector passes' worth of work per element
    Instr("V_GUMBEL", "vector", 21),
    # scalar / FP sidecar
    Instr("S_RECIP", "scalar", 4),
    Instr("S_ST", "scalar", 1),
    Instr("S_MAP_V_FP", "scalar", 2),
    # matrix unit: one op = a full (M, K, N) GEMM, costed by the tiled
    # output-stationary formula (shape carries (M, K, N))
    Instr("GEMM_TILE", "matrix"),
    # HBM bursts (shape = logical tensor, fmt sets bytes + MX decode)
    Instr("HBM_RD", "hbm"),
    Instr("HBM_WR", "hbm"),
    # inter-chip collectives (the vocab-sharded Stable-Max combine)
    Instr("COLL_PMAX", "net"),
    Instr("COLL_PSUM", "net"),
    Instr("COLL_PMIN", "net"),
    # SRAM allocator meta-ops (zero time)
    Instr("SRAM_ALLOC", "sram"),
    Instr("SRAM_FREE", "sram"),
    # zero-cost markers (e.g. the transformer forward, costed externally by
    # the analytical model in the hybrid end-to-end)
    Instr("XU_FORWARD", "marker"),
]

ISA: Dict[str, Instr] = {i.name: i for i in _INSTRS}


# ---------------------------------------------------------------------------
# NPU configuration (the simulator's design-space knobs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NPUConfig:
    """Parameterized sampling-datapath NPU for the cycle simulator.

    Matches sim/analytical.HWConfig at the paper §6.2 operating point by
    default (``NPUConfig.from_hw`` bridges the two), plus the knobs the
    closed-form model cannot express: SRAM banking/porting, MX decode
    width, and the collective port.
    """
    vlen: int = 2048               # vector lanes
    blen: int = 64                 # systolic sub-array dim
    mlen: int = 512                # K-slice width
    grid: int = 4                  # Matrix Unit grid replication
    freq: float = 1e9              # Hz
    hbm_bw: float = 4 * 409.5e9    # bytes/s (4-stack point)
    pipeline_fill: int = 6         # structural fill per issued op group
    # SRAM hierarchy: capacity bound + banked port bandwidth that can
    # throttle vector issue when lanes outrun the banks
    sram_bytes: int = 32 * 2 ** 20
    sram_banks: int = 32
    sram_port_bytes: int = 256     # bytes/bank/cycle
    # MX block decode unit on the HBM path (elements/cycle); narrow widths
    # turn cheap-byte formats into decode-bound streams
    mx_decode_width: int = 4096
    # collective port for the vocab-sharded combine
    net_bw: float = 4 * 409.5e9    # bytes/s
    net_lat_cycles: int = 64       # per-collective launch overhead
    # energy constants (same 7nm-class calibration as HWConfig)
    e_mac_int8: float = 0.6e-12
    e_vec_op: float = 1.2e-12
    e_hbm_byte: float = 6.0e-12
    p_static: float = 12.0

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw / self.freq

    @property
    def net_bytes_per_cycle(self) -> float:
        return self.net_bw / self.freq

    @property
    def sram_bytes_per_cycle(self) -> float:
        return float(self.sram_banks * self.sram_port_bytes)

    @classmethod
    def from_hw(cls, hw, **overrides) -> "NPUConfig":
        """Build from a sim/analytical.HWConfig (duck-typed: no import)."""
        kw = dict(vlen=hw.vlen, blen=hw.blen, mlen=hw.mlen, grid=hw.grid,
                  freq=hw.freq, hbm_bw=hw.hbm_bw,
                  pipeline_fill=hw.pipeline_fill, net_bw=hw.hbm_bw,
                  e_mac_int8=hw.e_mac_int8, e_vec_op=hw.e_vec_op,
                  e_hbm_byte=hw.e_hbm_byte, p_static=hw.p_static)
        kw.update(overrides)
        return cls(**kw)
