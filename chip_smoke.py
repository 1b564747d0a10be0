#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  -- nvcc builds every kernel of src/repro_torch/kernels/csrc
               into build/repro_torch/ (one process per source, in
               parallel);
  2. kernels -- each kernel against its plain PyTorch version on the card
               at the main path's shapes, with its time, the plain
               version's, a one-call PyTorch yardstick's and its bound;
  3. e2e    -- llada-8b at full width (32 layers, d 4096, bf16, seeded
               random weights), one-slot generate stepped through
               tick_forward and tick_sample, each tick's sampling held
               against the plain functions on the same hidden states;
  4. engine -- ServingEngine in modes warm and none (4 slots, 8 requests,
               prompts 16-32, generations 32-64, block 16, 8 steps); every
               request must finish with no mask id left, and each kernel
               must have launched on each path (launch counts zeroed just
               before a path runs, read just after).
Prints the kernels JSON line, the card's name and power limit, and last
the {"ok": true, ...} line.  Exits non-zero without a result when there is
no CUDA device or the port is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, f32
# FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

LLADA = dict(d=4096, V=126464, mask_id=126336)
QWEN2 = dict(d=896, V=151936, mask_id=151935)


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Failure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def head_logits_f32(h, w, fmt, suppress_id):
    """The plain version's quantized f32 logits, for the near-tie rule."""
    from repro_torch.core import mx, sampling
    z = mx.mx_fake_quant(sampling.head_logits(h, w), fmt).float()
    z[:, suppress_id] = sampling.NEG_INF
    return z


def check_head(widths, temperature, seed, gen, fmt="mxfp8_e4m3", R=64):
    """Kernel vs plain at R rows; returns (rows that differ, rows,
    max abs conf error on agreeing rows, inputs)."""
    from repro_torch.kernels import fused_head_sampling as fhs
    d, V, mid = widths["d"], widths["V"], widths["mask_id"]
    h = torch.randn(R, d, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn(d, V, generator=gen, device=DEVICE)
         * (2.0 / (d + V)) ** 0.5 * 8).to(torch.bfloat16)
    kw = dict(fmt=fmt, suppress_id=mid, temperature=temperature, seed=seed)
    conf_k, tok_k = fhs.fused_head_sampling(h, w, **kw)
    conf_p, tok_p = fhs.fused_head_stable_max(
        h, w, fmt, suppress_id=mid, temperature=temperature, seed=seed)
    torch.cuda.synchronize()
    same = tok_k == tok_p
    diff_rows = torch.nonzero(~same).flatten().tolist()
    if diff_rows:
        z = head_logits_f32(h[diff_rows], w, fmt, mid)
        zk = z.gather(1, tok_k[diff_rows].long()[:, None])[:, 0]
        zmax = z.amax(-1)
        near = ((zmax - zk).abs() <= 1e-2 * zmax.abs()).tolist()
        require(all(near), f"fused head d={d}: tokens differ off a near-tie "
                           f"in rows {diff_rows}")
    err = (conf_k - conf_p).abs()[same]
    rel = (err / conf_p.abs()[same])
    require(bool((rel <= 1e-2).all()),
            f"fused head d={d}: conf rel err {float(rel.max()):.3g} > 1e-2")
    return len(diff_rows), R, float(err.max()), (h, w, kw)


def phase_kernels(gen) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_bidir as fb
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import topk_mask as tk
    out = {}

    # fused head: llada widths greedy (the main path) and T > 0, qwen2
    n_diff = n_rows = 0
    head_err = 0.0
    for widths, temperature in ((LLADA, 0.0), (LLADA, 0.8), (QWEN2, 0.0)):
        nd, nr, err, inputs = check_head(widths, temperature, 1234, gen)
        n_diff, n_rows = n_diff + nd, n_rows + nr
        log(f"fused_head d={widths['d']} V={widths['V']} T={temperature}: "
            f"rows differing {nd}/{nr}, conf max abs err {err:.3g}")
        if widths is LLADA and temperature == 0.0:
            main_inputs, head_err = inputs, err
    require(n_diff <= 0.01 * n_rows,
            f"fused head: {n_diff}/{n_rows} rows differ (> 1%)")
    h, w, kw = main_inputs
    R, d = h.shape
    V = w.shape[1]
    b_ms, b_by = bound(R * d * 2 + d * V * 2 + R * 8, 2.0 * R * d * V,
                       BF16_FLOPS)
    out["fused_head_sampling"] = dict(
        max_abs_err=head_err,
        ms=time_ms(lambda: fhs.fused_head_sampling(h, w, **kw), 20),
        plain_ms=time_ms(lambda: fhs.fused_head_stable_max(
            h, w, kw["fmt"], suppress_id=kw["suppress_id"]), 5),
        library_ms=time_ms(lambda: torch.matmul(h, w), 20),
        bound_ms=b_ms, bound_by=b_by)

    # top-k: main path (4, 16) and (8, 64), ties forced
    for R, L in ((4, 16), (8, 64)):
        conf = torch.rand(R, L, generator=gen, device=DEVICE)
        conf[:, ::3] = 0.5
        conf[1] = 0.25
        mask = torch.rand(R, L, generator=gen, device=DEVICE) < 0.7
        k = torch.randint(0, L + 1, (R,), generator=gen, device=DEVICE)
        k[0] = L // 2
        got, want = tk.topk_mask(conf, mask, k), tk.topk_mask_plain(conf,
                                                                  mask, k)
        n_bad = int((got != want).sum())
        log(f"topk_mask ({R}, {L}): {n_bad} positions differ")
        require(n_bad == 0, f"topk_mask ({R}, {L}) differs from plain")
        if (R, L) == (4, 16):
            main_topk = (conf, mask, k)
    conf, mask, k = main_topk
    R, L = conf.shape
    b_ms, b_by = bound(R * L * (4 + 1 + 1) + R * 4, float(R * L * L),
                       F32_FLOPS)
    out["topk_mask"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: tk.topk_mask(conf, mask, k), 200),
        plain_ms=time_ms(lambda: tk.topk_mask_plain(conf, mask, k), 50),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # attention: main path (warm tick: ragged kv_valid), GQA, BAOS + window
    for (B, S, Hq, Hkv, D, baos, win) in ((4, 96, 32, 32, 128, False, None),
                                         (4, 96, 14, 2, 64, False, None),
                                         (2, 80, 32, 32, 128, True, 17)):
        q = torch.randn(B, S, Hq, D, generator=gen, device=DEVICE).bfloat16()
        kk = torch.randn(B, S, Hkv, D, generator=gen, device=DEVICE).bfloat16()
        v = torch.randn(B, S, Hkv, D, generator=gen, device=DEVICE).bfloat16()
        lens = torch.tensor([S, S // 2, 37, 1][:B], device=DEVICE)
        valid = torch.arange(S, device=DEVICE)[None, :] < lens[:, None]
        cal = [None] * 3
        if baos:
            cal = [torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.rand(B, Hkv, D, generator=gen, device=DEVICE) + 0.5,
                   torch.randn(B, Hkv, D, generator=gen, device=DEVICE)]
        got = fb.flash_bidir(q, kk, v, valid, *cal, window=win)
        want = fb.flash_bidir_plain(q, kk, v, valid, *cal, window=win)
        err = (got.float() - want.float()).abs()
        tol = 2e-2 + 2e-2 * want.float().abs()
        log(f"flash_bidir B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} baos={baos} "
            f"window={win}: max abs err {float(err.max()):.3g}")
        require(bool((err <= tol).all()),
                f"flash_bidir {(B, S, Hq, Hkv, D)} outside atol/rtol 2e-2")
        if Hq == 32 and not baos:
            main_attn = (q, kk, v, valid, float(err.max()))
    q, kk, v, valid, attn_err = main_attn
    B, S, Hq, D = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    sdpa_mask = valid[:, None, None, :]
    b_ms, b_by = bound(4 * q.numel() * 2 + valid.numel(),
                       4.0 * B * Hq * S * S * D, BF16_FLOPS)
    out["flash_bidir"] = dict(
        max_abs_err=attn_err,
        ms=time_ms(lambda: fb.flash_bidir(q, kk, v, valid), 50),
        plain_ms=time_ms(lambda: fb.flash_bidir_plain(q, kk, v, valid), 20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask), 50),
        bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------------------
# phase 3: one-slot generate at full size, sampling held against plain
# ---------------------------------------------------------------------------

def phase_e2e(model, params, gen) -> None:
    from repro_torch.core import diffusion
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import topk_mask as tk
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(gen_length=32, block_length=16,
                                     steps_per_block=8)
    prompt = torch.randint(0, cfg.vocab - 200, (1, 16), generator=gen,
                           device=DEVICE)
    state = diffusion.init_state(model, prompt, dcfg, seed=7)
    L, mid, w = dcfg.block_length, cfg.mask_id, params["lm_head"]
    fmt = dcfg.sampling.fmt
    n_tok = n_diff = n_near = 0
    t0 = time.perf_counter()
    while not state.done:
        x, bs = state.x, state.block_start
        feats, _ = diffusion.tick_forward(model, params, x, None, None, dcfg)
        k = state.ks[:, state.step_in_block].to(DEVICE)
        hid = feats[0, bs:bs + L]
        m_idx = x[:, bs:bs + L] == mid
        conf_k, tok_k = fhs.fused_head_sampling(hid, w, fmt=fmt,
                                                suppress_id=mid)
        conf_p, tok_p = fhs.fused_head_stable_max(hid, w, fmt,
                                                  suppress_id=mid)
        diff = torch.nonzero((tok_k != tok_p) & m_idx[0]).flatten()
        n_tok += int(m_idx.sum())
        n_diff += len(diff)
        if len(diff):
            z = head_logits_f32(hid[diff], w, fmt, mid)
            zk = z.gather(1, tok_k[diff].long()[:, None])[:, 0]
            n_near += int(((z.amax(-1) - zk).abs()
                           <= 1e-2 * z.amax(-1).abs()).sum())
        tr_k = tk.topk_mask(conf_k[None], m_idx, k)
        require(torch.equal(tr_k, tk.topk_mask_plain(conf_k[None], m_idx, k)),
                "e2e: top-k transfer mask differs from plain")
        x_new, _, _ = diffusion.tick_sample(
            params, feats, x, torch.tensor([bs], device=DEVICE), k,
            diffusion.tick_seed(state.seed, state.ticks), dcfg, mid, model)
        require(torch.equal(x_new[0, bs:bs + L][tr_k[0]], tok_k[tr_k[0]]),
                "e2e: tick_sample committed other tokens than sampled")
        state = dataclasses.replace(state, x=x_new)
        state = _next_step(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(not bool((state.x == mid).any()), "e2e: mask ids left")
    log(f"e2e llada-8b generate (1 x {state.x.shape[1]}, {state.ticks} "
        f"ticks, {dt:.3f} s): sampled tokens differing from plain "
        f"{n_diff}/{n_tok}, of which near-ties {n_near}")
    require(n_diff == n_near, "e2e: a sampled token differs off a near-tie")


def _next_step(state):
    """The counters diffusion.step advances after its tick."""
    t = state.step_in_block + 1
    block_idx = state.block_idx
    if t == state.dcfg.steps_per_block:
        t, block_idx = 0, block_idx + 1
    return dataclasses.replace(state, ticks=state.ticks + 1,
                               block_idx=block_idx, step_in_block=t)


# ---------------------------------------------------------------------------
# phase 4: the serving engine, modes warm and none
# ---------------------------------------------------------------------------

def phase_engine(model, params) -> dict:
    import numpy as np
    from repro_torch.core import diffusion
    from repro_torch.kernels import _build
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = model.cfg
    dcfg = diffusion.DiffusionConfig(block_length=16, steps_per_block=8)
    rs = np.random.RandomState(0)
    trace = [(rs.randint(0, cfg.vocab - 200, size=(rs.randint(16, 33),))
              .astype(np.int32), int(rs.choice([32, 48, 64])))
             for _ in range(8)]
    launches = {name: 0 for name in _build.KERNELS}
    for mode in ("warm", "none"):
        eng = ServingEngine(model, params, dcfg,
                            EngineConfig(num_slots=4, max_seq_len=96,
                                         mode=mode))
        eng.warmup()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        for p, g in trace:
            eng.submit(Request(prompt=p, gen_length=g))
        tick_s = []
        while eng.pending:
            t0 = time.perf_counter()
            eng.tick()                       # ends in a device sync
            tick_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        done = eng.completed
        s = eng.metrics.summary()
        p50, p84 = np.percentile(np.array(tick_s) * 1e3, [50, 84])
        log(f"engine mode={mode}: {len(done)} requests, {len(tick_s)} "
            f"ticks, tick wall ms median {p50:.2f} p84 {p84:.2f}, "
            f"{s['tokens_per_s']:.1f} tokens/s, request latency median "
            f"{s['latency_p50_s']:.3f} s, max memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {counts}")
        require(len(done) == len(trace), f"engine {mode}: requests missing")
        for c in done:
            require(len(c.tokens) == c.prompt_len + c.gen_length and
                    not bool((c.tokens == cfg.mask_id).any()),
                    f"engine {mode}: request {c.uid} left mask ids")
        for name, n in counts.items():
            require(n > 0, f"engine {mode}: kernel {name} never launched")
            launches[name] += n
        phase_tick_breakdown(eng, model, params, dcfg, mode)
    return launches


def phase_tick_breakdown(eng, model, params, dcfg, mode) -> None:
    """Device time of the tick's two halves at the engine's shape, on the
    engine's final canvas (all slots idle: the work is the same)."""
    from repro_torch.core import diffusion
    cache = eng.pool.cache if mode == "warm" else None
    B = eng.num_slots
    bs = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    k = torch.full((B,), 2, dtype=torch.int32, device=DEVICE)
    feats, _ = diffusion.tick_forward(model, params, eng.x, eng.kv_valid,
                                      cache, dcfg)
    fwd = time_ms(lambda: diffusion.tick_forward(
        model, params, eng.x, eng.kv_valid, cache, dcfg), 5)
    smp = time_ms(lambda: diffusion.tick_sample(
        params, feats, eng.x, bs, k, 0, dcfg, eng.mask_id, model), 10)
    log(f"tick breakdown mode={mode} ({B} x {eng.max_seq_len}): "
        f"tick_forward {fwd:.3f} ms, tick_sample {smp:.3f} ms")
    cfg = model.cfg
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    layer_weights = cfg.n_layers * (2 * cfg.d_model * (hq + hkv)
                                    + 3 * cfg.d_model * cfg.d_ff)
    profile_ticks(lambda: diffusion.batched_tick(
        model, params, eng.x, eng.kv_valid, bs, k, 0, cache, dcfg,
        eng.mask_id), mode, gemm_flops=2.0 * eng.x.numel() * layer_weights)


def profile_ticks(tick, mode: str, gemm_flops: float, n: int = 3) -> None:
    """torch.profiler over n ticks: device time per kernel class (device
    events only), the achieved GEMM rate, and the device's idle share of
    the wall time, which the profiler's own host cost inflates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    classes, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue                 # host ops repeat their kernels' time
        name = e.key.lower()
        cls = ("flash_bidir" if "flash_bidir" in name else
               "fused_head" if "head_" in name else
               "topk_mask" if "topk_mask" in name else
               "gemm" if any(s in name for s in ("gemm", "nvjet", "xmma",
                                                 "cutlass")) else
               "other")
        classes[cls] = classes.get(cls, 0.0) + us
        kernels.append((us, e.count // n, e.key[:70]))
    busy = sum(classes.values())
    parts = ", ".join(f"{c} {us / n / 1e3:.3f} ms"
                      for c, us in sorted(classes.items(),
                                          key=lambda kv: -kv[1]))
    launches = sum(calls for _, calls, _ in kernels)
    gemm_us = classes.get("gemm", 0.0) / n
    gemm_tflops = gemm_flops / (gemm_us * 1e-6) / 1e12 if gemm_us else 0.0
    log(f"profile mode={mode}, per tick: wall {wall_us / n / 1e3:.3f} ms, "
        f"device busy {busy / n / 1e3:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall_us) * 100:.1f}%), {launches} "
        f"kernels, GEMMs {gemm_flops / 1e12:.2f} TFLOP at "
        f"{gemm_tflops:.0f} TFLOP/s: {parts}")
    for us, calls, name in sorted(kernels, reverse=True)[:8]:
        log(f"  {us / n / 1e3:8.3f} ms/tick  {calls:4d} calls/tick  {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import device
        from repro_torch.configs import base
        from repro_torch.kernels import _build
        from repro_torch.models.registry import build_model
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    device.resolve("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    try:
        t0 = time.perf_counter()
        logs = _build.build()
        log(f"build: {time.perf_counter() - t0:.2f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line:
                    log(f"  {name}: {line.strip()}")
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        kernels = phase_kernels(gen)

        cfg = base.get_config("llada-8b")
        model = build_model(cfg, DEVICE)
        t0 = time.perf_counter()
        params = model.init(seed=0)
        torch.cuda.synchronize()
        log(f"llada-8b params: {cfg.param_count() / 1e9:.2f} B, init "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        phase_e2e(model, params, gen)
        launches = phase_engine(model, params)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    sources = {"fused_head_sampling": "src/repro/kernels/"
               "fused_head_sampling.py:134",
               "topk_mask": "src/repro/kernels/topk_mask.py:44",
               "flash_bidir": "src/repro/kernels/flash_bidir.py:78"}
    rows = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/kernels/csrc/{name}.cu",
                 replaces=sources[name], launches=launches[name],
                 **kernels[name]) for name in _build.KERNELS]
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
