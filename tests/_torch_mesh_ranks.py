"""Rank bodies of tests/test_torch_spmd.py, test_torch_compress.py and
test_torch_steps.py.  ``spawn`` starts one process
per rank (the spawn start method), each joins a gloo group over a
``file://`` store in the test's tmp_path and runs one job; rank 0 pickles
the job's result for the test.  Every process is joined with a deadline,
so a hung collective fails the test instead of running out its clock.
Imports torch and the port only (no JAX in the ranks)."""
from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# compressed_psum (tests/test_torch_compress.py)
# ---------------------------------------------------------------------------

COMPRESS_N = (1, 2, 4)
COMPRESS_SHAPES = {"a": (300,), "b": (2, 256), "c": (3, 5, 7)}


def compress_inputs(n: int):
    """Per-rank gradient and error trees (n of each), from one numpy seed:
    leaves of 300 (not a multiple of 256), 2 x 256 and 3 x 5 x 7."""
    rs = np.random.RandomState(5 + n)
    grads = [{k: (rs.randn(*s) * 3).astype(np.float32)
              for k, s in COMPRESS_SHAPES.items()} for _ in range(n)]
    errs = [{k: (rs.randn(*s) * 1e-2).astype(np.float32)
             for k, s in COMPRESS_SHAPES.items()} for _ in range(n)]
    return grads, errs


def _job_compress(rank: int, world: int) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import compress
    groups = {n: dist.new_group(list(range(n))) for n in COMPRESS_N}
    out = {}
    for n in COMPRESS_N:
        if rank >= n:
            continue
        grads, errs = compress_inputs(n)
        axis = mesh_lib.Axis("pod", n, rank, groups[n])
        red, err = compress.compressed_psum(
            {k: torch.from_numpy(v) for k, v in grads[rank].items()}, axis,
            {k: torch.from_numpy(v) for k, v in errs[rank].items()})
        every = [None] * n
        dist.all_gather_object(every, ({k: v.numpy() for k, v in red.items()},
                                       {k: v.numpy() for k, v in err.items()}),
                               group=groups[n])
        out[n] = every
    return out


# ---------------------------------------------------------------------------
# the step builders over a data mesh (tests/test_torch_steps.py)
# ---------------------------------------------------------------------------

STEP_B, STEP_S, STEP_L, STEP_BS = 4, 32, 8, 16


def step_shape(kind: str):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(kind, STEP_S, STEP_B, kind, block_length=STEP_L)


def step_inputs(cfg):
    """Tokens (train), the canvas (prefix, the block and the rest masked)
    and k, from one numpy seed."""
    rs = np.random.RandomState(11)
    tokens = rs.randint(0, cfg.vocab - 2, size=(STEP_B, STEP_S))
    x = rs.randint(0, cfg.vocab - 2, size=(STEP_B, STEP_S))
    x[:, STEP_BS:] = cfg.mask_id
    k = np.array([2, 3, 1, 4], np.int32)
    return tokens.astype(np.int32), x.astype(np.int32), k


def _gather(t: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The data ranks' ``t`` concatenated along ``dim``."""
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.all_gather_rows(t.movedim(dim, 0).contiguous(),
                                    axis).movedim(0, dim)


def _job_steps(rank: int, world: int) -> dict:
    """Mesh (2, 1): the train step (f32 smoke llada-8b) and the prefill +
    decode steps (ServePolicy(), and split_cache for decode) on each
    rank's shards, gathered over data, beside rank 0's single-device run
    on the full inputs; mesh (1, 2) must refuse every kind."""
    from repro_torch import sharding, tree as tree_lib
    from repro_torch.configs import base
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    mesh = mesh_lib.make_debug_mesh(2, 1, "cpu")
    wide = mesh_lib.make_debug_mesh(1, 2, "cpu")
    data = mesh.axis("data")
    cfg = base.get_config("llada-8b", smoke=True)
    model = build_model(cfg, "cpu")
    out = {}
    moe = build_model(base.get_config("llada-moe-7b-a1b", smoke=True), "cpu")
    hot = steps.ServePolicy(sampling=dataclasses.replace(
        steps.ServePolicy().sampling, temperature=0.8))
    for kind, mdl, m, policy in (
            ("train", model, wide, None), ("prefill", model, wide, None),
            ("decode", model, wide, None), ("moe train", moe, mesh, None),
            ("hot decode", model, mesh, hot)):
        try:
            steps.build_step(mdl, step_shape(kind.split()[-1]), policy,
                             mesh=m)
            out["refused", kind] = None
        except NotImplementedError as e:
            out["refused", kind] = str(e)
    tokens, x, k = (torch.from_numpy(a) for a in step_inputs(cfg))
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2)

    def placed(shape, policy=None):
        specs = steps.input_specs(model, shape, policy)
        with sharding.use_context(mesh, launch_sharding.make_rules(cfg,
                                                                   mesh)):
            return steps.input_shardings(model, shape, mesh, specs, policy)

    # train: rank 0's single-device step, then every rank's mesh step
    shape = step_shape("train")
    flat = lambda tree: torch.cat([t.detach().reshape(-1)  # noqa: E731
                                   for t in tree_lib.leaves(tree)])
    if rank == 0:
        params = model.init(seed=0)
        grad_fn = steps.build_grad_fn(model)
        met, grads = grad_fn(params, tokens, 3, {})
        step, _ = steps.build_step(model, shape, opt_cfg=opt)
        params, _, met1 = step(params, adamw.init_state(params), tokens, 3,
                               {})
        out["train", "single"] = (float(met["loss"]),
                                  [g.numpy() for g in grads],
                                  flat(params).numpy(), float(met1["lr"]))
    params = model.init(seed=0)
    full = {"params": params, "opt_state": adamw.init_state(params),
            "tokens": tokens, "seed": 3, "extras": {}}
    mine = steps.shard_inputs(full, placed(shape))
    assert mine["tokens"].shape[0] == STEP_B // 2
    met, grads = steps.build_grad_fn(model, mesh=mesh)(
        mine["params"], mine["tokens"], 3, {})
    step, _ = steps.build_step(model, shape, opt_cfg=opt, mesh=mesh)
    new, _, _ = step(mine["params"], mine["opt_state"], mine["tokens"], 3,
                     {})
    both = _gather(flat(new)[None], 0, data)
    out["train", "mesh"] = (float(met["loss"]), [g.numpy() for g in grads],
                            both[0].numpy())
    out["train", "ranks equal"] = bool(torch.equal(both[0], both[1]))

    # prefill, then decode from its cache
    for split in (False, True):
        policy = steps.ServePolicy(split_cache=split)
        act = STEP_L if split else None
        pre, dec = step_shape("prefill"), step_shape("decode")
        params = model.init(seed=0)
        res = {}
        for name in ("single", "mesh"):
            m = None if name == "single" else mesh
            fp, _ = steps.build_step(model, pre, policy, mesh=m)
            fd, _ = steps.build_step(model, dec, policy, mesh=m)
            inp = {"params": params, "x": x,
                   "cache": model.init_cache(STEP_B, STEP_S, act),
                   "block_start": STEP_BS, "k": k, "seed": 5, "extras": {}}
            if m is not None:
                inp = steps.shard_inputs(inp, placed(dec, policy))
            logits, cache = fp(inp["params"], inp["x"], inp["cache"],
                               STEP_BS, {})
            x1, cache = fd(inp["params"], inp["x"], cache, STEP_BS,
                           inp["k"], 5, {})
            if m is not None:
                logits, x1 = _gather(logits, 0, data), _gather(x1, 0, data)
                cache = {n: _gather(t, 1, data) for n, t in cache.items()}
            res[name] = (logits.numpy(), x1.numpy(),
                         {n: t.numpy() for n, t in cache.items()})
        out["serve", split] = res
    return out


JOBS = {"combine": _job_combine, "serve": _job_serve,
        "compress": _job_compress, "steps": _job_steps}


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
