"""On-chip memory budgets, the port's counterpart of
src/repro/analysis/sram_budget.py, in two halves.

The NPU half (the paper's design point, on ``sim/``):

  * ``ANL-SRAM-BUDGET`` - each NPU kernel's per-grid-step working set
    (double-buffered in/out blocks + scratch, ``registry.kernel_specs``)
    must fit ``sim.isa.NPUConfig``'s SRAM at production LLaDA-8B scale:
    the paper's claim that vocab-wide logits never leave on-chip memory.
  * ``ANL-SRAM-XVAL`` - the static fused-head footprint, in the trace's
    modeled storage formats, must agree with the ``sim.cycle`` exact-fit
    allocator's peak over a production sampling trace captured on meta
    tensors, within ``registry.SRAM_CROSSVAL_BAND``.

The Hopper half (the port's kernels on the H100):

  * ``ANL-SMEM-BUDGET`` - every CUDA kernel instantiation's shared memory
    per block (static arrays + the dynamic request of its largest launch,
    ``registry.smem_specs``) must fit sm_90's opt-in limit of 232,448
    bytes.  chip_smoke.py holds each figure against
    ``cudaFuncGetAttributes`` on the card.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis import registry
from repro_torch.analysis.report import Allowlist, PassResult, Violation


def check_budgets(specs: Optional[List[registry.KernelSpec]] = None,
                  sram_bytes: Optional[int] = None) -> tuple:
    """(violations, per-kernel footprint table) of the NPU half."""
    from repro_torch.sim import isa

    cap = isa.NPUConfig().sram_bytes if sram_bytes is None else sram_bytes
    specs = registry.kernel_specs() if specs is None else specs
    violations: List[Violation] = []
    table = {}
    for spec in specs:
        total = spec.total_bytes
        table[spec.name] = {
            "point": spec.point,
            "buffers": spec.footprint(),
            "total_bytes": total,
            "capacity_bytes": cap,
            "utilization": round(total / cap, 4),
        }
        if total > cap:
            biggest = max(spec.footprint().items(), key=lambda kv: kv[1])
            violations.append(Violation(
                "ANL-SRAM-BUDGET", spec.name,
                f"per-grid-step working set {total} B exceeds SRAM "
                f"capacity {cap} B at {spec.point} "
                f"(largest buffer: {biggest[0]}={biggest[1]} B)"))
    return violations, table


def static_stream_peak(B: int, L: int, V: int, d: int,
                       chunk_v: int = 4096) -> int:
    """Fused-head stream peak in the trace's modeled storage formats:
    carry (3, R) fp32 + one live (d, chunk) weight slab
    (``sampling.TRACE_W_FMT``) + one (TILE_R, chunk) fp32 logit tile, the
    buffers ``core/sampling._emit_head_stream`` allocates and frees."""
    from repro_torch.core import sampling
    from repro_torch.sim import isa

    R = B * L
    chunk, _ = sampling._chunk_grid(V, chunk_v)
    w = isa.BYTES[sampling.TRACE_W_FMT]
    f32 = isa.BYTES["fp32"]
    return int(3 * R * f32 + d * chunk * w + isa.TILE_R * chunk * f32)


def crossval_allocator(B: int = 8, L: int = 32, V: int = 126464,
                       d: int = 4096) -> tuple:
    """(violations, info): a production-scale fused sampling trace
    captured on meta tensors (no weight allocated), the allocator's peak
    band-compared with ``static_stream_peak``."""
    from repro_torch.sim import cycle, isa, trace

    tr = trace.capture_sampling_trace(B=B, L=L, V=V, d=d,
                                      head_path="fused")
    sim = cycle.simulate(tr, isa.NPUConfig())
    static = static_stream_peak(B, L, V, d)
    lo, hi = registry.SRAM_CROSSVAL_BAND
    ratio = static / sim.sram_peak_bytes if sim.sram_peak_bytes else 0.0
    violations: List[Violation] = []
    if not (lo <= ratio <= hi):
        violations.append(Violation(
            "ANL-SRAM-XVAL", "fused_head_sampling",
            f"static stream peak {static} B vs allocator peak "
            f"{sim.sram_peak_bytes:.0f} B (ratio {ratio:.3f} outside "
            f"[{lo}, {hi}]): kernel accounting and sim emission hooks "
            f"have diverged"))
    if not sim.sram_ok:
        violations.append(Violation(
            "ANL-SRAM-XVAL", "fused_head_sampling",
            f"allocator overflowed by {sim.sram_overflow_bytes:.0f} B on "
            f"the production trace: the streamed head no longer fits "
            f"SRAM"))
    info = {"static_peak_bytes": static,
            "allocator_peak_bytes": sim.sram_peak_bytes,
            "ratio": round(ratio, 4),
            "band": [lo, hi],
            "sram_ok": sim.sram_ok,
            "point": {"B": B, "L": L, "V": V, "d": d}}
    return violations, info


def check_smem(specs: Optional[List[registry.SmemSpec]] = None,
               limit: int = registry.SMEM_LIMIT_BYTES) -> tuple:
    """(violations, table) of the Hopper half: each instantiation's
    static + dynamic shared memory per block against ``limit``."""
    specs = registry.smem_specs() if specs is None else specs
    violations: List[Violation] = []
    table = {}
    for s in specs:
        key = f"{s.library}::{s.kernel}"
        table[key] = {"static_bytes": s.static_bytes,
                      "dynamic_bytes": s.dynamic_bytes,
                      "total_bytes": s.total_bytes}
        if s.total_bytes > limit:
            violations.append(Violation(
                "ANL-SMEM-BUDGET", key,
                f"{s.total_bytes} B of shared memory per block ({s.static_bytes}"
                f" static + {s.dynamic_bytes} dynamic) exceeds sm_90's "
                f"{limit} B"))
    return violations, table


def run(allow: Allowlist, crossval: bool = True) -> PassResult:
    violations, table = check_budgets()
    vs, smem = check_smem()
    violations.extend(vs)
    info = {"kernels": table, "smem": smem,
            "smem_limit_bytes": registry.SMEM_LIMIT_BYTES}
    if crossval:
        vs, xv = crossval_allocator()
        violations.extend(vs)
        info["crossval"] = xv
    kept, suppressed = allow.filter(violations)
    return PassResult("smem_budget", kept, suppressed, info=info,
                      checked=len(table) + len(smem))
