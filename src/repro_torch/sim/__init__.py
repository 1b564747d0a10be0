"""Performance simulators of the port: the closed-form analytical model
(``sim.analytical``, the drift monitor's baseline) and the trace-driven
cycle-level NPU model (``sim.isa`` / ``sim.trace`` / ``sim.cycle``), over
instruction streams the port's tick records."""
from repro_torch.sim.isa import BYTES, ISA, NPUConfig          # noqa: F401
from repro_torch.sim.trace import (Trace, TraceOp, Tracer,     # noqa: F401
                                   capture_sampling_trace,
                                   capture_tick_trace)
from repro_torch.sim.cycle import (CROSSVAL_BAND, SimResult,   # noqa: F401
                                   crossval_sampling, end_to_end_cycle,
                                   simulate)
