"""The port's static-analysis gate, the counterpart of src/repro/analysis.

Four passes over ``src/repro_torch/`` check the invariants the port's
design rests on, which runtime benchmarks catch only late and noisily:

  * ``graph_audit``  - every registered entry point traced on meta
    tensors at smoke scale: no host read or value-shaped op inside it, its
    cross-device copies within budget, its canvas or cache in place where
    it declares so, collectives only on declared mesh axes, and (on a
    card) a bound on the CUDA graphs captured over a representative engine
    shape trace.
  * ``smem_budget``  - the NPU kernels' on-chip footprint against
    ``sim.isa.NPUConfig``'s SRAM, cross-checked against ``sim.cycle``'s
    allocator; every CUDA kernel instantiation's shared memory per block
    against sm_90's 227 KB.
  * ``hotpath_lint`` - AST rules: host syncs inside registered hot paths,
    ``time.time()`` where ``perf_counter`` is required, draws from torch's
    global generator, bare ``assert`` in library code, serialization or
    file I/O in event-emit paths.
  * ``locks``        - lock discipline over the threaded serving/obs
    modules: fields written both with and without their lock, and
    lock-order cycles.

Run ``python -m repro_torch.analysis --check`` (the gate); entry points,
hot paths and budgets live in :mod:`repro_torch.analysis.registry`;
reviewed exceptions go in ``allowlist.txt`` next to this file.
"""
from repro_torch.analysis.report import Allowlist, PassResult, Violation

__all__ = ["Allowlist", "PassResult", "Violation"]
