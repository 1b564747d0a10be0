"""Live model-vs-measured drift monitor (docs/observability.md).

The JAX package cross-validates its cycle simulator against the
analytical stage models *offline*.  This module turns that into a live, scrapeable
invariant: feed the measured per-stage engine tick seconds in, compare
them against ``sim/analytical``'s prediction for the same model/serving
config, and export a per-stage ``measured / modeled`` drift gauge.

Measured host seconds and modeled NPU seconds live on different absolute
scales (a CPU smoke tick is ~10^3x the modeled 1 GHz NPU tick), so the
raw ratio would only measure the hardware gap.  The monitor therefore
*calibrates*: a running scale factor ``s = measured_total / modeled_total``
divides every per-stage ratio, making the drift gauge a pure **shape**
check — ``drift(stage) = (measured_stage / modeled_stage) / s``.  A value
of 1.0 means the stage consumes exactly the share of the tick the
analytical model predicts; drift > 1 means the stage is slower *relative
to the rest of the tick* than modeled (e.g. host dispatch overhead
attributed to that stage).  When measured equals modeled exactly the
scale is 1 and every ratio is exactly 1.0 (pinned in tests/test_obs.py).

On paper-point NPU hardware the calibrated ratios should sit inside the
JAX package's ``sim.cycle.CROSSVAL_BAND``; on a CPU dev host the forward/sampling
split differs from the modeled NPU split, so ``HOST_DRIFT_BAND`` is the
(wide, documented) band the JAX package's ``benchmarks/check_bench.py``
gates.  ``modeled_tick_stages`` reads the port's copy of the analytical
model (``repro_torch.sim.analytical``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

# Acceptable calibrated-drift band on a host CPU (no NPU): the measured
# forward:sampling split of a smoke-scale CPU tick vs the analytical NPU
# model.  Wide by design — the gate exists to catch *attribution* bugs
# (a stage suddenly 10x off its modeled share: lost timer, dead stage,
# double-charged work), not to re-validate the model (that is the JAX
# package's CROSSVAL_BAND, asserted on simulated cycles).
HOST_DRIFT_BAND = (0.05, 20.0)


def modeled_tick_stages(model_cfg, dcfg, *, batch: int, prompt_len: int,
                        hw=None, model_shards: int = 1,
                        data_shards: int = 1, megatick_k: int = 1,
                        host=None, paged: bool = False) -> Dict[str, float]:
    """Per-*tick* modeled stage seconds for a serving engine config.

    Uses ``sim.analytical.end_to_end`` on the fused (or sharded) head path
    — the predictions the cycle simulator is cross-validated against —
    and divides by the total number of denoising steps, since the engine
    charges each tick one denoising step for every active slot.  Returns
    ``{"forward": s, "sampling": s, "tick": s}`` where ``tick`` is the
    roofline total (what a non-breakdown engine can compare against).

    When ``host`` (a ``sim.analytical.HostConfig``) is given, the dict also
    carries the host-domain stages ``dispatch`` and ``device_sync`` at
    their K-amortized per-tick cost (``host_overhead_per_tick``): one
    dispatch + one sync per megastep, divided over ``megatick_k`` ticks.
    ``paged=True`` additionally models the paged pool's per-dispatch
    flush as a ``paged_io`` host stage (the engine times its
    ``pool.flush()`` under the same name).  Host stages live on host
    wall-clock, not the modeled NPU clock — hand them to
    ``DriftMonitor(..., host_stages=...)`` so they are excluded from the
    hardware-scale calibration and tracked as raw ratios.
    """
    from repro_torch.sim import analytical

    hw = hw or analytical.HWConfig()
    engine = "sharded" if model_shards > 1 or data_shards > 1 else "fused"
    res = analytical.end_to_end(
        model_cfg, hw, B=batch, prompt=prompt_len, gen_len=dcfg.gen_length,
        block_len=dcfg.block_length, steps=dcfg.steps_per_block,
        cache_mode=dcfg.cache_mode,
        sampling_engine=engine, model_shards=model_shards,
        data_shards=data_shards)
    n_ticks = (dcfg.gen_length // dcfg.block_length) * dcfg.steps_per_block
    out = {"forward": res.model_s / n_ticks,
           "sampling": res.sampling_s / n_ticks,
           "tick": res.total_s / n_ticks}
    if host is not None:
        out.update(analytical.host_overhead_per_tick(host, megatick_k,
                                                     paged=paged))
    return out


@dataclasses.dataclass
class _StageState:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class DriftMonitor:
    """Accumulates measured per-stage seconds against a modeled baseline.

    ``observe(stage, seconds)`` on the tick path is two float adds; ratio
    computation happens at scrape time.  Stages without a modeled entry
    are tracked but report no drift (ratio ``None``).
    """

    def __init__(self, modeled: Mapping[str, float],
                 calibrate: bool = True,
                 host_stages: Iterable[str] = ()):
        bad = {k: v for k, v in modeled.items() if v <= 0}
        if bad:
            raise ValueError(f"modeled stage seconds must be > 0: {bad}")
        self.modeled = dict(modeled)
        self.calibrate = calibrate
        # Host-domain stages (dispatch, device_sync under megatick): their
        # modeled seconds are host wall-clock already, so they must not
        # participate in the measured/modeled hardware-scale fit — they
        # report *raw* measured/modeled ratios instead of calibrated ones.
        self.host_stages = frozenset(host_stages)
        self._stages: Dict[str, _StageState] = {}

    def observe(self, stage: str, seconds: float) -> None:
        st = self._stages.get(stage)
        if st is None:
            st = self._stages[stage] = _StageState()
        st.total_s += seconds
        st.count += 1

    def observe_tick(self, stage_seconds: Mapping[str, float]) -> None:
        for stage, s in stage_seconds.items():
            self.observe(stage, s)

    @property
    def scale(self) -> float:
        """Hardware scale: measured/modeled summed over stages both sides
        know (1.0 when not calibrating or nothing measured yet)."""
        if not self.calibrate:
            return 1.0
        meas = mod = 0.0
        for stage, st in self._stages.items():
            m = self.modeled.get(stage)
            if m is not None and st.count and stage not in self.host_stages:
                meas += st.mean
                mod += m
        return meas / mod if mod > 0 and meas > 0 else 1.0

    def ratios(self) -> Dict[str, Optional[float]]:
        """Calibrated per-stage drift ``(measured/modeled)/scale``; ``None``
        for stages with no model or no measurements.  Host stages skip the
        hardware-scale division (both sides are host wall-clock)."""
        s = self.scale
        out: Dict[str, Optional[float]] = {}
        for stage, st in self._stages.items():
            m = self.modeled.get(stage)
            if m is None or not st.count or s <= 0:
                out[stage] = None
            elif stage in self.host_stages:
                out[stage] = st.mean / m
            else:
                out[stage] = st.mean / m / s
        return out

    def report(self) -> dict:
        """Snapshot for /v1/stats, benchmarks and the drift gauge."""
        return {
            "scale": self.scale,
            "host_stages": sorted(self.host_stages),
            "ticks": max((st.count for st in self._stages.values()),
                         default=0),
            "modeled_s": dict(self.modeled),
            "measured_mean_s": {k: st.mean
                                for k, st in self._stages.items()},
            "drift": self.ratios(),
        }
