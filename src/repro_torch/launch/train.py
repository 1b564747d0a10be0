"""Training driver of the port, a copy of src/repro/launch/train.py: LLaDA
masked-diffusion pretraining with checkpoints, fault tolerance and the
LR schedules (WSD for minicpm, cosine otherwise).  It runs on the card
unless ``--device cpu`` asks for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu

Flags as in JAX, plus ``--device`` (default cuda: without a card the
command raises).  Each step draws its mask from a generator seeded by
(seed, step) (core/diffusion.step_generator) and reads batch ``step`` of
the synthetic corpus, so a run resumed or restarted from a checkpoint
replays its steps bit for bit.  Attention's gradient on the card is the
hand-written backward (kernels/flash_bidir.py); every other op is
PyTorch's autograd.  ``--ckpt-dir`` defaults to build/train_ckpt under
the repository root.  On the card the last lines give the median step
wall, tokens/s and the peak device memory.
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import base as configs
from repro_torch.core import diffusion
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FaultInjector, RuntimeConfig,
                                                 TrainRuntime)

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda: without a "
                         "card the command raises; --device cpu runs the "
                         "plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def opt_config(arch: str, steps: int, lr: float) -> adamw.OptConfig:
    """JAX's train.py schedule for ``steps`` steps."""
    return adamw.OptConfig(
        lr=lr, schedule="wsd" if "minicpm" in arch else "cosine",
        warmup_steps=max(2, steps // 10), stable_steps=max(2, steps // 2),
        decay_steps=max(1, steps // 3))


def loss_and_grads(model, params, tokens, gen=None,
                   fwd_kw_of: Optional[Callable[[Dict], Dict]] = None,
                   **loss_kw) -> Tuple[Dict, List[torch.Tensor]]:
    """The masked-diffusion loss and every parameter's gradient
    (torch.autograd.grad; zeros for a leaf the loss does not reach), the
    gradients in ``tree.leaves(params)`` order.  ``fwd_kw_of(params)``
    gives forward kwargs computed under autograd (the audio family's
    encoder); ``loss_kw`` go to ``masked_diffusion_loss``.
    -> (metrics, grads)."""
    leaves = tree_lib.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    fwd_kw = fwd_kw_of(params) if fwd_kw_of is not None else {}
    loss, metrics = diffusion.masked_diffusion_loss(
        model, params, tokens, gen, **loss_kw, **fwd_kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return metrics, [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]


def make_train_step(model, opt_cfg: adamw.OptConfig, seed: int):
    """step(params, opt_state, tokens, step) -> metrics: the loss and
    every parameter's gradient (``loss_and_grads``), then AdamW in
    place.  The MoE family adds its aux loss at weight 0.01, as JAX's
    driver does.  launch/steps.build_train_step is the same step with
    JAX's step-builder inputs and an optional data mesh."""
    aux_weight = 0.01 if model.cfg.moe is not None else 0.0

    def train_step(params, opt_state, tokens, step: int) -> Dict:
        gen = diffusion.step_generator(seed, step, tokens.device)
        metrics, grads = loss_and_grads(model, params, tokens, gen,
                                        aux_weight=aux_weight)
        _, _, stats = adamw.apply_updates(params, grads, opt_state, opt_cfg)
        return {**metrics, **stats}

    return train_step


def main(argv=None) -> Dict:
    """Run the driver; returns {"losses", "step_s", "restarts",
    "stragglers", "peak_bytes" (None off the card)}."""
    args = build_parser().parse_args(argv)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, args.device)
    dev = model.device
    opt_cfg = opt_config(args.arch, args.steps, args.lr)
    params = model.init(seed=args.seed)
    opt_state = adamw.init_state(params)
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M",
          flush=True)

    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    train_step = make_train_step(model, opt_cfg, args.seed)

    def step_fn(state, batch, step):
        tokens = torch.from_numpy(batch).to(device=dev, dtype=torch.int64)
        metrics = train_step(state["params"], state["opt_state"], tokens,
                             step)
        return {"state": state, "metrics": metrics}

    rt_cfg = RuntimeConfig(ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    injector = (FaultInjector([args.inject_failure_at])
                if args.inject_failure_at is not None else None)
    rt = TrainRuntime(rt_cfg, {"params": params, "opt_state": opt_state},
                      step_fn, injector)
    if args.resume:
        rt.try_resume()

    losses: List[float] = []
    step_s: List[float] = []

    def on_metrics(step, metrics, dt):
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(dt)
        if step % 5 == 0 or step == 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1000:7.1f} ms",
                  flush=True)

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rt.run(lambda step: Prefetcher(corpus.iter_from(step)), args.steps,
           on_metrics)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    print(f"done: {args.steps} steps in {time.perf_counter()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"restarts={rt.restarts} stragglers={len(rt.straggler_events)}",
          flush=True)
    if on_card:
        med = statistics.median(step_s)
        print(f"{torch.cuda.get_device_name(dev)}: step wall median "
              f"{med * 1e3:.2f} ms, {args.batch * args.seq / med:.0f} "
              f"tokens/s, peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
    return {"losses": losses, "step_s": step_s, "restarts": rt.restarts,
            "stragglers": len(rt.straggler_events), "peak_bytes": peak}


if __name__ == "__main__":
    main()
