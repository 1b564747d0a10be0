"""Rank bodies of tests/test_torch_spmd.py.  ``spawn`` starts one process
per rank (the spawn start method), each joins a gloo group over a
``file://`` store in the test's tmp_path and runs one job; rank 0 pickles
the job's result for the test.  Every process is joined with a deadline,
so a hung collective fails the test instead of running out its clock.
Imports torch and the port only (no JAX in the ranks)."""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

V_HEAD, V_LOGITS, D, R = 257, 256, 32, 8
FMTS = ("none", "mxfp8_e4m3", "mxint4")
SHARDS = (1, 2, 4)
SUPPRESS = (None, V_HEAD - 1, 100)
PROMPT = (4, 12)


def combine_inputs():
    """hidden (R, D), head (D, V_HEAD), stored logits (R, V_LOGITS) and
    per-shard partials (4, R) x 3, from one numpy seed."""
    rs = np.random.RandomState(0)
    h = rs.randn(R, D).astype(np.float32)
    w = (rs.randn(D, V_HEAD) * 0.1).astype(np.float32)
    logits = (rs.randn(R, V_LOGITS) * 3).astype(np.float32)
    pm = rs.randn(4, R).astype(np.float32)
    pm[1, :3] = pm[0, :3]                       # ties across shards
    pi = rs.randint(0, 1000, size=(4, R)).astype(np.int32)
    ps = rs.uniform(1, 50, size=(4, R)).astype(np.float32)
    return h, w, logits, (pm, pi, ps)


def serve_requests(vocab: int):
    """JAX's tests/test_spmd.py requests: 4 of mixed lengths."""
    rs = np.random.RandomState(3)
    return [(1 + i, rs.randint(0, vocab - 2, size=(8 + 2 * i,)).astype(
        np.int32), 8 * (1 + i % 2)) for i in range(4)]


def _job_combine(rank: int, world: int) -> dict:
    from repro_torch.core import sampling
    from repro_torch.launch import mesh as mesh_lib
    h, w, logits, (pm, pi, ps) = combine_inputs()
    groups = {n: dist.new_group(list(range(n))) for n in SHARDS}
    out = {}
    for n in SHARDS:
        if rank >= n:
            continue
        axis = mesh_lib.Axis("model", n, rank, groups[n])
        wp = sampling.pad_head_for_mesh(torch.from_numpy(w), n)
        vloc = wp.shape[1] // n
        shard = wp[:, rank * vloc:(rank + 1) * vloc]
        for fmt in FMTS:
            for sup in SUPPRESS:
                conf, idx = sampling.sharded_fused_head_stable_max(
                    torch.from_numpy(h), shard, axis, fmt, suppress_id=sup,
                    col_limit=V_HEAD)
                out["head", n, fmt, sup] = (conf.numpy(), idx.numpy())
            lv = V_LOGITS // n
            conf, idx = sampling.sharded_stable_max(
                torch.from_numpy(logits[:, rank * lv:(rank + 1) * lv]), axis,
                fmt)
            out["logits", n, fmt] = (conf.numpy(), idx.numpy())
        conf, idx = sampling.combine_partials(
            torch.from_numpy(pm[rank]), torch.from_numpy(pi[rank]),
            torch.from_numpy(ps[rank]), axis)
        out["partials", n] = (conf.numpy(), idx.numpy())
    return out


def serve_results(mesh=None) -> dict:
    """generate and the engine (modes none and warm, K 1 and 4) on the
    smoke llada-8b, over ``mesh`` (None: the single-device path)."""
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = base.get_config("llada-8b", smoke=True)
    mdl = build_model(cfg, "cpu")
    params = mdl.init(0)
    out = {"mesh": None if mesh is None else (
        mesh.shape, mesh.backend, mesh.coords)}
    dcfg = diffusion.DiffusionConfig(gen_length=16, block_length=8,
                                     steps_per_block=4)
    prompt = torch.randint(0, cfg.vocab - 2, PROMPT,
                           generator=torch.Generator().manual_seed(1))
    for k in (1, 4):
        out["generate", k] = diffusion.generate(
            mdl, params, prompt, dcfg, seed=7, mesh=mesh,
            megatick_k=k).numpy()
    reqs = serve_requests(cfg.vocab)
    for mode in ("none", "warm"):
        dc = diffusion.DiffusionConfig(
            gen_length=16, block_length=8, steps_per_block=4,
            cache_mode="dual" if mode == "warm" else "none")
        for k in (1, 4):
            eng = ServingEngine(mdl, params, dc, EngineConfig(
                num_slots=2, max_seq_len=32, mode=mode, mesh=mesh,
                megatick_k=k))
            events = []
            for uid, p, g in reqs:
                eng.submit(Request(uid=uid, prompt=p, gen_length=g),
                           on_commit=lambda ev: events.append(
                               (ev.uid, ev.tick, ev.block_idx,
                                ev.step_in_block, ev.positions.tolist(),
                                ev.tokens.tolist(), ev.done)))
            done = eng.run()
            out["engine", mode, k] = (
                {c.uid: c.tokens.tolist() for c in done},
                {c.uid: c.ticks for c in done}, eng.ticks_total, events)
    return out


def _job_serve(rank: int, world: int, data: int, model: int) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    return serve_results(mesh_lib.make_debug_mesh(data, model, "cpu"))


JOBS = {"combine": _job_combine, "serve": _job_serve}


def run_rank(rank: int, world: int, store: str, job: str, out: str,
             kwargs: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        res = JOBS[job](rank, world, **kwargs)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp_path, timeout: float = 150.0,
          **kwargs):
    """Run ``job`` on ``world`` ranks; rank 0's result.  Each process is
    joined against one deadline and killed past it (the test fails)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tag = f"{job}-{world}-{'-'.join(map(str, kwargs.values()))}"
    store, out = tmp_path / f"{tag}.store", tmp_path / f"{tag}.pkl"
    procs = [ctx.Process(target=run_rank, args=(r, world, str(store), job,
                                                str(out), kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"{job}: ranks {hung} still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{job}: rank exit codes {codes}"
    with open(out, "rb") as f:
        return pickle.load(f)
