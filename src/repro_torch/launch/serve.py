"""Serving entry point of the port, a copy of src/repro/launch/serve.py:
the continuous-batching dLLM engine (default), the legacy
one-batch-at-a-time loop (``--legacy``), or the online streaming HTTP
frontend (``--http PORT``).  It runs on the card unless ``--device cpu`` asks for the CPU.

Engine path: packs requests into batch slots over a KV slot pool and
advances all of them with one forward + Stable-Max sampling call per tick
(repro_torch.serving); prints slot occupancy, p50/p99 request latency, and
the per-stage breakdown with ``--breakdown``.  For the audio family
(whisper-medium) the engine and the legacy loop feed every forward the
encoder's cross-attention K/V of frames drawn from a seeded generator
(the stub frontend), as JAX's serve does; the vlm family (internvl2-26b)
serves text only, as in JAX.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 32 --gen-len 64 --block-len 16 --steps 8

HTTP path: boots ``--replicas`` independent engines behind the
least-loaded/round-robin router and serves the OpenAI-style streaming API
until interrupted (Ctrl-C drains gracefully):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --http 8080 --replicas 2 --slots 4 --max-seq-len 128 --mode none

``--mesh D,M`` serves over a (data, model) mesh (launch/mesh.py): the
slots shard over data, the LM head's columns over model.  A (1, 1) mesh
runs in this process; a larger one runs one process per rank:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch llada-8b --mesh 1,2 --mode none

Ranks that share a card talk through gloo, whose collectives a CUDA graph
cannot capture, so their engine ticks eagerly (printed with the mesh).
``--http`` under a mesh of more than one rank is refused: the frontend's
submissions would have to reach every rank (ROADMAP.md, Queue 3).

Flags as in JAX, with these differences: ``--device`` (default cuda)
picks the card or the CPU; ``--compilation-cache-dir`` names XLA's
persistent cache, which the port does not have, and is refused;
``--profile-ticks`` writes torch.profiler traces.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as configs
from repro_torch.core import baos as baos_lib
from repro_torch.core import diffusion
from repro_torch.core import sampling as sampling_lib
from repro_torch.models.registry import build_model
from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                 get_policy)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llada-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda: without a "
                         "card the command raises; --device cpu runs the "
                         "plain PyTorch path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--block-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cache", default="dual",
                    choices=["none", "prefix", "dual"])
    ap.add_argument("--kv-format", default="mxint4")
    ap.add_argument("--sampling-fmt", default="mxfp8_e4m3")
    ap.add_argument("--no-baos", action="store_true")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    # engine path
    ap.add_argument("--legacy", action="store_true",
                    help="one synchronous generate() batch per request")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine batch slots (default: --batch)")
    ap.add_argument("--mode", default="warm", choices=["warm", "none"],
                    help="engine tick mode: pooled warm step / full recompute")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "sgf", "sjf", "slowfast"])
    ap.add_argument("--slowfast-threshold", type=float, default=0.9)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve over a (data, model) mesh, e.g. --mesh "
                         "1,2: one process per rank under python -m "
                         "torch.distributed.run (1,1 needs none)")
    ap.add_argument("--mixed", action="store_true",
                    help="vary request prompt/gen lengths across the trace")
    ap.add_argument("--breakdown", action="store_true",
                    help="time forward vs sampling stages per tick (Fig. 1)")
    ap.add_argument("--pool", default="slot", choices=["slot", "paged"],
                    help="cache backend: contiguous per-slot rows, or the "
                         "paged block pool with radix-tree prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page for --pool paged")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page budget for --pool paged (default: "
                         "enough for every slot plus the null page)")
    ap.add_argument("--megatick", type=int, default=1, metavar="K",
                    help="run up to K engine ticks per megastep on the "
                         "device (one host sync per megastep); "
                         "incompatible with --breakdown")
    ap.add_argument("--compilation-cache-dir", default=None, metavar="DIR",
                    help="XLA's persistent compilation cache (JAX only): "
                         "refused here; the kernels build into the "
                         "repository's build/repro_torch/")
    # online streaming frontend
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the streaming HTTP API on this port "
                         "(0 = ephemeral) instead of an offline trace")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent engine replicas behind the router")
    ap.add_argument("--route", default="least_loaded",
                    choices=["rr", "least_loaded"])
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-replica queued-request bound beyond free "
                         "slots (default: 2x slots); excess gets 429")
    ap.add_argument("--max-queue-wait", type=float, default=None,
                    help="shed queued requests waiting longer than this "
                         "many seconds")
    ap.add_argument("--max-seq-len", type=int, default=0,
                    help="engine canvas length for --http "
                         "(default: prompt-len + gen-len)")
    # observability
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON timeline "
                         "(tick stages, request lifecycle, router hops) "
                         "on exit; works for both the offline engine "
                         "path and --http")
    ap.add_argument("--profile-ticks", type=int, default=0, metavar="N",
                    help="wrap the first N ticks of each replica in a "
                         "torch.profiler trace (--http path)")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler output dir (default: the "
                         "repository's build/dllm-profile)")
    ap.add_argument("--no-drift", dest="drift", action="store_false",
                    help="disable the live model-vs-measured drift monitor")
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="append-only JSONL structured event log: one "
                         "record per request lifecycle edge (read it with "
                         "python -m repro_torch.obs.logquery)")
    ap.add_argument("--slo-classes", default=None, metavar="JSON",
                    help="SLO tier overrides merged onto the defaults, "
                         'e.g. \'{"interactive": {"ttft_deadline_s": '
                         "1.0}}'")
    return ap


def make_dcfg(args) -> diffusion.DiffusionConfig:
    return diffusion.DiffusionConfig(
        gen_length=args.gen_len, block_length=args.block_len,
        steps_per_block=args.steps, cache_mode=args.cache,
        sampling=sampling_lib.SamplingConfig(fmt=args.sampling_fmt),
        baos=baos_lib.BAOSConfig(enabled=not args.no_baos,
                                 kv_format=args.kv_format))


def audio_frames(cfg, batch: int, device) -> torch.Tensor:
    """The stub audio frontend's frame embeddings (batch, n_audio_ctx,
    d_model) f32, standard normal from a generator seeded 1 (JAX's serve
    draws ``jax.random.normal(PRNGKey(1), ...)``)."""
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randn((batch, cfg.n_audio_ctx, cfg.d_model), generator=gen,
                       device=device)


def _fwd_kw(cfg, model, params, batch: int, frames=None) -> dict:
    """The forward kwargs of ``batch`` rows: for the audio family the
    cross-attention K/V of ``frames`` (default ``audio_frames``), encoded
    once; none for the others."""
    kw = {}
    if cfg.family == "audio":
        if frames is None:
            frames = audio_frames(cfg, batch, model.device)
        frames = torch.as_tensor(frames, device=model.device)
        kw["cross_kv"] = model.cross_kv(params, model.encode(params, frames))
    return kw


def run_legacy(args, cfg, model, params, dcfg, mesh=None) -> None:
    fwd_kw = _fwd_kw(cfg, model, params, args.batch)
    jit = _jit_steps(model, mesh)
    if mesh is not None:
        # once, so generate() finds the head already sharded
        params = diffusion.place_spmd_params(params, mesh)
    rs = np.random.RandomState(args.seed)
    total_tokens = 0
    t_total = 0.0
    for req in range(args.requests):
        # the synthetic prompts come from the seeded host stream; each
        # batch samples from its own counter-Gumbel seed
        prompt = torch.as_tensor(
            rs.randint(0, cfg.vocab - 2, size=(args.batch, args.prompt_len)),
            dtype=torch.int32, device=model.device)
        t0 = time.perf_counter()
        out = diffusion.generate(model, params, prompt, dcfg,
                                 seed=args.seed + req,
                                 megatick_k=args.megatick, mesh=mesh,
                                 jit_steps=jit, **fwd_kw)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        dt = time.perf_counter() - t0
        tag = "warmup+build" if req == 0 else "steady"
        gen_tokens = args.batch * args.gen_len
        if req > 0:
            total_tokens += gen_tokens
            t_total += dt
        print(f"request {req}: {gen_tokens} tokens in {dt:.2f}s "
              f"({gen_tokens/dt:.1f} tok/s) [{tag}]")
        masks_left = int((out[:, args.prompt_len:] == cfg.mask_id).sum())
        if masks_left:
            raise RuntimeError(f"{masks_left} positions left masked")
    if t_total > 0:
        print(f"steady-state TPS: {total_tokens / t_total:.1f} "
              f"(cache={args.cache}, baos={not args.no_baos}, "
              f"kv={args.kv_format}, sampling={args.sampling_fmt})")


def make_requests(args, cfg, seed: int) -> list:
    """Synthetic single-sequence requests; --mixed draws per-request
    prompt/gen lengths (gen stays a multiple of block_len)."""
    rs = np.random.RandomState(seed)
    n = args.requests * args.batch
    reqs = []
    for _ in range(n):                    # submit() auto-assigns uids
        if args.mixed:
            p_len = int(rs.randint(max(4, args.prompt_len // 2),
                                   args.prompt_len + 1))
            n_blocks = int(rs.randint(1, args.gen_len // args.block_len + 1))
            g_len = n_blocks * args.block_len
        else:
            p_len, g_len = args.prompt_len, args.gen_len
        prompt = rs.randint(0, cfg.vocab - 2, size=(p_len,)).astype(np.int32)
        reqs.append(Request(prompt=prompt, gen_length=g_len))
    return reqs


def make_obs(args, cfg, dcfg, num_slots: int, max_seq: int):
    """Root ServingObs for the offline engine path: tracing on iff
    --trace-out, drift armed unless --no-drift (the analytical model gives
    every family its dense-shaped estimate, as in JAX).  The drift
    baseline includes the host dispatch/device_sync stages at their
    K-amortized cost."""
    from repro_torch.obs import EventLog, ServingObs, TraceCollector
    from repro_torch.obs.drift import modeled_tick_stages
    from repro_torch.sim.analytical import HostConfig

    obs = ServingObs(trace=TraceCollector(enabled=bool(args.trace_out)))
    if args.slo_classes is not None:
        obs.set_slo_classes(args.slo_classes)
    if args.event_log:
        obs.set_event_log(EventLog(args.event_log))
    if args.drift:
        paged = args.pool == "paged"
        modeled = modeled_tick_stages(
            cfg, dcfg, batch=num_slots,
            prompt_len=max(1, max_seq - dcfg.gen_length),
            megatick_k=args.megatick, host=HostConfig(), paged=paged)
        obs.set_drift_model(modeled, host_stages=(
            "dispatch", "device_sync") + (("paged_io",) if paged else ()))
    return obs


def _finish_obs(args, obs) -> None:
    if args.trace_out:
        obs.trace.save(args.trace_out)
        print(f"wrote trace ({len(obs.trace.events())} events, "
              f"{obs.trace.dropped} dropped) to {args.trace_out}")
    ev = getattr(obs, "events", None)
    if ev is not None:
        st = ev.stats()
        ev.close()
        if st["path"]:
            print(f"wrote event log ({st['emitted']} records, "
                  f"{st['dropped']} dropped) to {st['path']}")
    rep = obs.drift_report()
    if rep is not None and rep["ticks"]:
        drift = {k: (round(v, 3) if v is not None else None)
                 for k, v in rep["drift"].items()}
        print(f"drift (calibrated measured/modeled, scale "
              f"{rep['scale']:.3g}): {drift}")


def _policy(args):
    return (get_policy("slowfast", threshold=args.slowfast_threshold)
            if args.policy == "slowfast" else get_policy(args.policy))


def run_engine(args, cfg, model, params, dcfg, mesh=None) -> None:
    num_slots = args.slots or args.batch
    max_seq = args.prompt_len + args.gen_len
    policy = _policy(args)
    reqs = make_requests(args, cfg, args.seed)
    fwd_kw = _fwd_kw(cfg, model, params, num_slots)
    obs = make_obs(args, cfg, dcfg, num_slots, max_seq)

    eng = ServingEngine(model, params, dcfg, EngineConfig(
        num_slots=num_slots, max_seq_len=max_seq, mode=args.mode,
        policy=policy, seed=args.seed, breakdown=args.breakdown,
        fwd_kw=fwd_kw, obs=obs, megatick_k=args.megatick, pool=args.pool,
        page_size=args.page_size, num_pages=args.num_pages, mesh=mesh,
        jit_steps=_jit_steps(model, mesh)))
    eng.warmup()    # build and capture off-clock
    completed = eng.run(reqs)
    for c in completed[: min(8, len(completed))]:
        print(f"request {c.uid}: P={c.prompt_len} gen={c.gen_length} "
              f"ticks={c.ticks} latency={c.latency*1e3:.1f}ms")
    if len(completed) != len(reqs):
        raise RuntimeError(f"engine dropped requests: {len(completed)} "
                           f"completed of {len(reqs)}")
    for c in completed:
        n_masked = int((c.tokens[c.prompt_len:] == cfg.mask_id).sum())
        if n_masked:
            raise RuntimeError(f"request {c.uid}: {n_masked} masks left")
    print(f"engine: slots={num_slots} mode={args.mode} "
          f"policy={policy.name} pool={eng.pool.stats()} "
          f"device={model.device}"
          + (f" mesh={mesh.shape} rank={mesh.rank}" if mesh is not None
             else ""))
    print(eng.metrics.format_summary())
    _finish_obs(args, obs)


def run_http(args, cfg, model, params, dcfg, mesh=None) -> None:
    """Boot the online streaming frontend and serve until interrupted.
    Over a mesh of more than one rank (under torch.distributed.run) rank 0
    binds the HTTP port and serves; every other rank follows its engine
    calls (serving/frontend/router.MeshFollower) and returns when rank 0
    drains, or raises ``MeshAborted`` (a non-zero exit) when it aborts."""
    import asyncio

    from repro_torch.obs import ServingObs, TraceCollector
    from repro_torch.serving.frontend import build_frontend, serve_forever

    max_seq = args.max_seq_len or (args.prompt_len + args.gen_len)
    obs = ServingObs(trace=TraceCollector(enabled=bool(args.trace_out)))
    frontend = build_frontend(
        model, params, dcfg, model_name=args.arch,
        replicas=args.replicas, num_slots=args.slots or args.batch,
        max_seq_len=max_seq, mode=args.mode, strategy=args.route,
        max_queue=args.max_queue, max_queue_wait=args.max_queue_wait,
        policy=_policy(args), mesh=mesh, host=args.host, port=args.http,
        seed=args.seed, obs=obs, breakdown=args.breakdown,
        drift=args.drift, profile_ticks=args.profile_ticks,
        profile_dir=args.profile_dir, megatick_k=args.megatick,
        pool=args.pool, page_size=args.page_size, num_pages=args.num_pages,
        event_log=args.event_log, slo_classes=args.slo_classes)
    if mesh is not None and mesh.rank != 0:
        # rank 0 serves HTTP; this rank makes the same engine calls
        import signal
        print(f"rank {mesh.rank} follows rank 0's frontend (port "
              f"{args.http}) over {len(frontend.workers)} replica(s)",
              flush=True)
        # an interrupt stops rank 0, whose drain then ends this rank
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        frontend.run()
        return
    try:
        asyncio.run(serve_forever(frontend))
    except KeyboardInterrupt:
        pass
    finally:
        for w in frontend.router.workers:
            print(f"--- {w.name} ---")
            print(w.engine.metrics.format_summary())
            rep_obs = w.engine.obs
            if rep_obs is not None and rep_obs.drift is not None:
                r = rep_obs.drift_report()
                if r["ticks"]:
                    drift = {k: (round(v, 3) if v is not None else None)
                             for k, v in r["drift"].items()}
                    print(f"drift (scale {r['scale']:.3g}): {drift}")
        _finish_obs(args, obs)


def _jit_steps(model, mesh) -> bool:
    """Graphed ticks, unless the mesh's collectives cannot be captured
    (gloo, where ranks share a card): then the ticks run eagerly, and the
    mesh line says so."""
    return mesh is None or mesh.capturable or model.device.type != "cuda"


def make_mesh_arg(spec: str, device):
    """'--mesh D,M' -> this process's rank of a (data, model) mesh."""
    from repro_torch.launch import mesh as mesh_lib
    try:
        data, model_ax = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects DATA,MODEL integers, got {spec!r}")
    try:
        mesh = mesh_lib.make_debug_mesh(data, model_ax, device)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")
    print(f"mesh: {mesh} ({'graphed' if mesh.capturable else 'eager'} "
          f"ticks: {mesh.backend} collectives "
          f"{'can' if mesh.capturable else 'cannot'} be captured)")
    return mesh


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.compilation_cache_dir is not None:
        raise SystemExit("--compilation-cache-dir names XLA's persistent "
                         "compilation cache, which the port does not have; "
                         "its kernels build once into the repository's "
                         "build/repro_torch/")
    if args.legacy and args.http is not None:
        raise SystemExit("--legacy and --http are mutually exclusive "
                         "(the legacy loop has no online frontend)")
    if args.mesh and args.legacy and args.cache != "none":
        raise SystemExit("--mesh --legacy requires --cache none")
    mesh = make_mesh_arg(args.mesh, args.device) if args.mesh else None
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, args.device if mesh is None else mesh.device)
    params = model.init(args.seed)
    dcfg = make_dcfg(args)
    try:
        if args.legacy:
            run_legacy(args, cfg, model, params, dcfg, mesh)
        elif args.http is not None:
            run_http(args, cfg, model, params, dcfg, mesh)
        else:
            run_engine(args, cfg, model, params, dcfg, mesh)
    finally:
        if mesh is not None and mesh.size > 1:
            from repro_torch.launch import mesh as mesh_lib
            mesh_lib.destroy()


if __name__ == "__main__":
    main()
