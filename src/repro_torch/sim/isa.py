"""Instruction set of the analytical model: a copy of the part of
src/repro/sim/isa.py that ``sim/analytical.py`` reads (the storage-format
widths ``BYTES`` and the ISA table with the paper Table 3 pipelined cycle
counts).  The cycle simulator's ``NPUConfig`` and trace capture are not
ported (ROADMAP.md, Queue 1 item 14).

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
# table.
# ---------------------------------------------------------------------------

BYTES: Dict[str, float] = {
    "mxint4": 0.5, "mxint8": 1.0, "mxfp8_e4m3": 1.0, "mxfp4_e2m1": 0.5,
    "bf16": 2.0, "fp32": 4.0, "int32": 4.0, "fp64": 8.0, "none": 8.0,
    "bool": 1.0,
}


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
