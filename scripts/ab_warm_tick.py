#!/usr/bin/env python3
"""Time the serving engine's warm path, graphed K=1, on llada-8b at full
width (seeded random weights), with a given checkout's code: twice, each
time the median unprofiled tick wall over a 64-tick run (4 slots x 96
positions, 8 requests, block 16, 8 steps: chip_smoke.py's engine trace)
and the profiler's device busy per tick over 16 ticks.

    python3 scripts/ab_warm_tick.py ROOT

ROOT is a checkout (this repository, or another commit unpacked with
``git archive`` into a directory .gitignore lists); its own chip_smoke.py
and src/ are imported, and its kernels built into ROOT/build/.  Two
versions compare only on one card, in turns (parent, change, change,
parent), e.g. on the card:

    for r in parent . . parent; do python3 scripts/ab_warm_tick.py $r; done
"""
import sys

root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)

import numpy as np  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch import device  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

device.resolve("cuda")
cfg = base.get_config("llada-8b")
model = build_model(cfg, "cuda")
params = model.init(seed=0)
rs = np.random.RandomState(0)
trace = [(rs.randint(0, cfg.vocab - 200, size=(rs.randint(16, 33),))
          .astype(np.int32), int(rs.choice([32, 48, 64]))) for _ in range(8)]
dcfg = diffusion.DiffusionConfig(block_length=16, steps_per_block=8)
per_tick = {"fused_head_sampling": 1, "topk_mask": 1, "flash_bidir": 32,
            "baos_mx_quant": 0, "stablemax_sampling": 0}
for rep in range(2):
    eng, _, tick_ms, _ = cs.engine_run(model, params, dcfg, "warm", trace,
                                       False, jit_steps=True)
    del eng
    busy = cs.profile_engine(model, params, dcfg, "warm", trace,
                             f"{root} warm graphed K=1", dict(jit_steps=True),
                             per_tick)
    print(f"AB {root} rep {rep}: tick wall median "
          f"{float(np.median(tick_ms)):.3f} ms, device busy {busy:.3f} ms",
          flush=True)
