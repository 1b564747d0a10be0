"""AdamW, its LR schedules (MiniCPM's WSD, cosine, const) and global-norm
clipping, ported from src/repro/optim/adamw.py with JAX's arithmetic and
dtypes: the schedule in f32, clipping by the global norm of the f32
gradients, f32 moments, bias correction, and the decoupled decay applied
on an f32 copy of each parameter, rounded back to its dtype.

The state is ``{"m", "v"}`` (trees of f32 tensors shaped like the
parameters) and ``"step"``, a Python int.  ``apply_updates`` works in
place: it writes the new parameters into the parameter tensors and the
new moments into the state's tensors (under ``torch.no_grad``), and
returns the same objects, so a train step holds one copy of each.
Gradient compression over a mesh axis is optim/compress.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    schedule: str = "wsd"        # wsd | cosine | const
    warmup_steps: int = 100
    stable_steps: int = 800
    decay_steps: int = 100
    min_lr_ratio: float = 0.1


def schedule_lr(step: int, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step``, an f32 scalar on the CPU, computed
    as JAX computes it in f32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        total = cfg.warmup_steps + cfg.stable_steps + cfg.decay_steps
        t = torch.clamp((s - cfg.warmup_steps) /
                        max(total - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.lr * warm * (cfg.min_lr_ratio +
                                (1 - cfg.min_lr_ratio) * cos)
    if cfg.schedule != "wsd":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    # WSD (MiniCPM): warmup -> stable -> exponential decay tail
    decay_start = cfg.warmup_steps + cfg.stable_steps
    t = torch.clamp((s - decay_start) / max(cfg.decay_steps, 1), 0.0, 1.0)
    decay = cfg.min_lr_ratio ** t
    return cfg.lr * warm * torch.where(s < decay_start, 1.0, decay)


def init_state(params) -> Dict[str, Any]:
    """Zero f32 moments beside each parameter, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_lib.tree_map(zeros, params),
            "v": tree_lib.tree_map(zeros, params), "step": 0}


def global_norm(tree, axis=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum of
    squares.  Over a tensor-parallel mesh, ``sharded`` flags the leaves
    that hold this rank's shard along ``axis`` (launch/mesh.Axis, the
    ``model`` axis): their sums of squares are summed over ``axis``, the
    replicated leaves' counted once."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_lib.leaves(tree)]
    if axis is None or axis.size == 1 or not sharded or not any(sharded):
        return torch.sqrt(sum(sq))
    from repro_torch.launch import mesh as mesh_lib
    own = mesh_lib.all_reduce(sum(q for q, s in zip(sq, sharded) if s),
                              "sum", axis)
    return torch.sqrt(own + sum((q for q, s in zip(sq, sharded) if not s),
                                torch.zeros_like(own)))


@torch.no_grad()
def apply_updates(params, grads, state: Dict[str, Any], cfg: OptConfig,
                  axis=None, sharded=None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``state`` (see the
    module's note).  ``axis``/``sharded``: a tensor-parallel mesh's
    ``model`` axis and the flags of the leaves sharded over it, for the
    clipping norm (``global_norm``).  Returns (params, state, {"lr",
    "grad_norm"})."""
    step = state["step"] + 1
    lr = schedule_lr(step, cfg)
    gnorm = global_norm(grads, axis, sharded)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    # 1 - b^step in f32, as JAX's b ** step.astype(f32); as Python floats
    # they hold the f32 values exactly
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** float(step))
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** float(step))
    lr_f = float(lr)
    for p, g, m, v in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                          tree_lib.leaves(state["m"]),
                          tree_lib.leaves(state["v"])):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        pf = p.to(torch.float32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * pf
        p.copy_((pf - lr_f * u).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
