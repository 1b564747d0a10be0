"""Rank bodies of tests/test_torch_spmd.py, test_torch_compress.py,
test_torch_steps.py, test_torch_tp_steps.py, test_torch_paged_mesh.py and
test_torch_sampled_mesh.py.  ``spawn`` starts one process
per rank (the spawn start method), each joins a gloo group over a
``file://`` store in the test's tmp_path and runs one job; rank 0 pickles
the job's result for the test.  Every process is joined with a deadline,
so a hung collective fails the test instead of running out its clock.
Imports torch and the port only (no JAX in the ranks)."""
from __future__ import annotations

import dataclasses
import hashlib
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


def step_shape(kind: str, block: int = STEP_L):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(kind, STEP_S, STEP_B, kind, block_length=block)


def step_block(cfg) -> int:
    """The steps' block length: mamba's segments are whole SSD chunks
    (models/ssm.SSD_CHUNK, 16), so its block is the canvas's second half."""
    return 16 if cfg.family == "ssm" else STEP_L


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
    on the full inputs; the MoE steps (``tp_run``, its aux the global
    batch's); what once was refused and now builds: sampled decoding over
    |data| > 1 or a vocab-sharded head, the ssm steps over |model| > 1."""
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
    hot = steps.ServePolicy(sampling=dataclasses.replace(
        steps.ServePolicy().sampling, temperature=0.8))
    ssm = build_model(base.get_config("mamba2-130m", smoke=True), "cpu")
    v256 = build_model(tp_config("llada-8b v256"), "cpu")
    for kind, mdl, m, policy in (
            ("ssm train", ssm, wide, None), ("ssm decode", ssm, wide, None),
            ("hot decode", model, mesh, hot),
            ("hot sharded-head decode", v256, wide, hot)):
        try:
            steps.build_step(mdl, step_shape(kind.split()[-1]), policy,
                             mesh=m)
            out["refused", kind] = None
        except NotImplementedError as e:
            out["refused", kind] = str(e)
    out["moe"] = tp_run("llada-moe-7b-a1b", mesh)
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


# ---------------------------------------------------------------------------
# the tensor-parallel body (tests/test_torch_tp_steps.py)
# ---------------------------------------------------------------------------

# smoke configs (f32); "v256": the vocab cut to 256, so the embedding, the
# loss and the decode step's head shard over ``model`` (every smoke config
# has V = 257, which no |model| > 1 divides; the recurrent families then
# sample through route C, shards of 128 and 64); "v320": shards of 160 and
# 80, the second not a whole number of MX blocks, so the recurrent decode
# step gathers the head; "h32": mamba's head dim 32, four SSD heads, so at
# |model| = 4 every leaf shards (in_proj's 292 columns, the state's
# heads); "e6": six experts, which
# |model| = 4 does not divide, so the experts' hidden dim shards instead;
# "f66": an expert hidden dim of 66, which |model| = 4 does not divide
# either, so at |model| = 4 the experts stay whole on every rank while
# the shared experts (hidden 128) shard
TP_CASES = ("llada-8b", "llada-8b v256", "qwen2-0.5b", "llada-moe-7b-a1b",
            "qwen2-moe-a2.7b e6", "qwen2-moe-a2.7b e6 f66",
            "whisper-medium", "internvl2-26b", "mamba2-130m",
            "mamba2-130m h32", "mamba2-130m v320", "recurrentgemma-2b",
            "recurrentgemma-2b v256")
TP_LR = 1e-3


def tp_config(case: str):
    from repro_torch.configs import base
    arch, *opts = case.split()
    cfg = base.get_config(arch, smoke=True)
    for opt in opts:
        if opt[0] == "v":
            cfg = dataclasses.replace(cfg, vocab=int(opt[1:]))
    if "h32" in opts:
        cfg = dataclasses.replace(cfg, ssm_head_dim=32)
    if cfg.mask_id >= cfg.vocab:
        cfg = dataclasses.replace(cfg, mask_token_id=cfg.vocab - 1)
    if "e6" in opts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=6))
    if "f66" in opts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=66))
    return cfg


def tp_params(model):
    """Seeded parameters with every norm and bias moved off its constant
    init by a numpy draw (a bias added twice, or a norm applied to the
    wrong shard, then shows)."""
    from repro_torch import tree as tree_lib
    params = model.init(seed=0)
    rs = np.random.RandomState(17)
    for path, t in tree_lib.flatten_with_paths(params):
        if t.dim() == 1 or path.endswith(("/b", "/w")):
            t.add_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32)
                                    * 0.1).to(t.dtype))
    return params


def tp_extras(cfg, kind: str) -> dict:
    """The audio family's frames or encoder K/V and the vlm family's
    image, full batch, from numpy."""
    rs = np.random.RandomState(21)
    ex = {}
    if cfg.family == "audio":
        if kind in ("train", "prefill"):
            ex["audio_embeds"] = torch.from_numpy(rs.randn(
                STEP_B, cfg.n_audio_ctx, cfg.d_model).astype(np.float32))
        else:
            kv = (cfg.n_layers, STEP_B, cfg.n_audio_ctx, cfg.n_kv_heads,
                  cfg.d_head)
            ex["cross_kv"] = tuple(torch.from_numpy(
                rs.randn(*kv).astype(np.float32)) for _ in range(2))
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        ex["image_embeds"] = torch.from_numpy(rs.randn(
            STEP_B, cfg.n_image_tokens, cfg.d_model).astype(np.float32))
    return ex


def tp_run(case: str, mesh=None) -> dict:
    """One case's train, prefill and decode (unified and split) steps on
    the full inputs (no mesh), or on this rank's shards of them over
    ``mesh``, with every output gathered whole (numpy)."""
    from repro_torch import sharding, tree as tree_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    cfg = tp_config(case)
    model = build_model(cfg, "cpu")
    tokens, x, k = (torch.from_numpy(a) for a in step_inputs(cfg))
    opt = adamw.OptConfig(lr=TP_LR, warmup_steps=2)
    out = {}

    def placed(shape, policy=None):
        specs = steps.input_specs(model, shape, policy)
        with sharding.use_context(mesh, launch_sharding.make_rules(cfg,
                                                                   mesh)):
            return steps.input_shardings(model, shape, mesh, specs, policy)

    def whole(t, pl):
        """``t`` (this rank's shard under ``pl``) gathered whole."""
        if mesh is None or not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        for dim, ax in enumerate(pl.spec):
            if ax is not None:
                t = mesh_lib.all_gather(t, dim, mesh.axis(ax))
        return t

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in tree_lib.leaves(tree)
                   if isinstance(t, torch.Tensor))

    def equal_over_model(t):
        """Whether every ``model`` rank holds the same ``t``."""
        if mesh is None:
            return True
        both = mesh_lib.all_gather(t.detach().reshape(1, -1), 0,
                                   mesh.axis("model"))
        return bool((both == both[:1]).all())

    # train: the gradients, then one AdamW step
    shape = step_shape("train")
    params = tp_params(model)
    full = {"params": params, "opt_state": adamw.init_state(params),
            "tokens": tokens, "seed": 3, "extras": tp_extras(cfg, "train")}
    if mesh is None:
        mine, pls = full, None
    else:
        pls = placed(shape)
        mine = steps.shard_inputs(full, pls)
        mine["params"] = launch_sharding.place(params, pls["params"])
        mine["opt_state"] = adamw.init_state(mine["params"])
        out["bytes"] = (nbytes(mine["params"]), nbytes(mine["opt_state"]))
    met, grads = steps.build_grad_fn(model, mesh=mesh)(
        mine["params"], mine["tokens"], 3, mine["extras"])
    gpl = [None] * len(grads) if pls is None else \
        tree_lib.leaves(pls["params"])
    out["train"] = (float(met["loss"]), float(met["aux"]),
                    [whole(g, p).numpy() for g, p in zip(grads, gpl)])
    out["train equal"] = equal_over_model(torch.stack(
        [met["loss"], met["aux"]]))
    fresh = launch_sharding.place(tp_params(model), pls["params"]) \
        if pls is not None else tp_params(model)
    step, _ = steps.build_step(model, shape, opt_cfg=opt, mesh=mesh)
    new, _, met1 = step(fresh, adamw.init_state(fresh), mine["tokens"], 3,
                        mine["extras"])
    out["train step"] = (float(met1["grad_norm"]), np.concatenate(
        [whole(t.detach(), p).reshape(-1).numpy() for t, p in zip(
            tree_lib.leaves(new), gpl)]))

    # prefill, then decode from its cache, unified and split
    for split in (False, True):
        policy = steps.ServePolicy(split_cache=split)
        act = STEP_L if split else None
        pre, dec = (step_shape(kind, step_block(cfg))
                    for kind in ("prefill", "decode"))
        inp = {"params": tp_params(model), "x": x,
               "cache": model.init_cache(STEP_B, STEP_S, act),
               "extras": tp_extras(cfg, "prefill")}
        dex = {"k": k, "extras": tp_extras(cfg, "decode")}
        if mesh is not None:
            pls, dpl = placed(pre, policy), placed(dec, policy)
            meta = build_model(cfg, "meta").init_cache(STEP_B, STEP_S, act)
            inp = steps.shard_inputs(inp, pls)
            inp["params"] = launch_sharding.place(tp_params(model),
                                                  pls["params"])
            inp["cache"] = launch_sharding.local_like(
                meta, pls["cache"],
                lambda path: 1.0 if path.endswith("_scale") else 0.0)
            dex = steps.shard_inputs(dex, dpl)
            out["cache bytes", split] = nbytes(inp["cache"])
        fp, _ = steps.build_step(model, pre, policy, mesh=mesh)
        fd, _ = steps.build_step(model, dec, policy, mesh=mesh)
        logits, cache = fp(inp["params"], inp["x"], inp["cache"], STEP_BS,
                           inp["extras"])
        x1, cache = fd(inp["params"], inp["x"], cache, STEP_BS, dex["k"], 5,
                       dex["extras"])
        if mesh is not None:
            lpl = sharding.Placement(mesh, sharding.PartitionSpec(
                "data", None,
                "model" if logits.shape[-1] != cfg.vocab else None))
            out["decode equal", split] = equal_over_model(x1)
            logits = whole(logits, lpl)
            x1 = whole(x1, pls["x"])
            cache = {n: whole(t, pls["cache"][n]) for n, t in cache.items()}
        out["serve", split] = (logits.numpy(), x1.numpy(),
                               {n: t.numpy() for n, t in cache.items()})
    return out


TP_QUANT_CASES = ("llada-8b", "qwen2-moe-a2.7b e6")


def tp_quant_forward(case: str, mesh=None):
    """The forward's logits (no cache) under ``QuantPolicy(enabled=True)``
    on the canvas, whole (numpy): on one rank, or over ``mesh`` inside the
    tensor-parallel body on this rank's shards (where a row-parallel shard
    is not a multiple of the MX block, its input and weight gathered)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models import layers, tp as tp_lib
    from repro_torch.models.registry import build_model
    cfg = tp_config(case)
    model = build_model(cfg, "cpu")
    _, x, _ = step_inputs(cfg)
    quant = layers.QuantPolicy(enabled=True)
    params, ctx = tp_params(model), None
    if mesh is not None:
        params = launch_sharding.place(params, steps.param_placements(
            model, mesh))
        ctx = tp_lib.Parallel(model=mesh.axis("model"))
    with torch.no_grad(), tp_lib.use(ctx):
        logits, _ = model.forward(params, torch.from_numpy(x), quant=quant)
    if logits.shape[-1] != cfg.vocab:
        logits = mesh_lib.all_gather(logits, -1, mesh.axis("model"))
    return logits.numpy()


def _job_tp(rank: int, world: int, data: int, model: int,
            cases: tuple) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_debug_mesh(data, model, "cpu")
    out = {case: tp_run(case, mesh) for case in cases}
    out["quant"] = {case: tp_quant_forward(case, mesh)
                    for case in TP_QUANT_CASES}
    return out


# ---------------------------------------------------------------------------
# the paged pool under a mesh (tests/test_torch_paged_mesh.py)
# ---------------------------------------------------------------------------

def paged_trace(vocab: int):
    """tests/test_torch_paged.py's trace: two requests share a two-page
    prompt, then a 12- and an 8-token prompt; gens 8 and 16."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab - 2, size=(16,)).astype(np.int32)
    prompts = [shared, shared.copy(),
               rs.randint(0, vocab - 2, size=(12,)).astype(np.int32),
               rs.randint(0, vocab - 2, size=(8,)).astype(np.int32)]
    return [(p, 8 * (1 + i % 2)) for i, p in enumerate(prompts)]


def _paged_serve(engine, trace, preempt_at=None):
    """Tokens, per-request ticks and CommitEvent keys of ``trace`` through
    ``engine``; with ``preempt_at`` the newest live request is preempted
    after that many ticks."""
    from repro_torch.serving import Request
    events = []
    for prompt, gen in trace:
        engine.submit(Request(prompt=prompt.copy(), gen_length=gen),
                      on_commit=lambda e: events.append(
                          (e.uid, e.tick, e.block_idx, e.step_in_block,
                           e.masks_left, e.done, e.positions.tolist(),
                           e.tokens.tolist())))
    engine.warmup()
    ticks = 0
    while engine.pending:
        if not engine.tick():
            break
        ticks += 1
        if ticks == preempt_at:
            live = [s.request.uid for s in engine.slots if s is not None]
            assert engine.preempt(live[-1])
    done = sorted(engine.completed, key=lambda c: c.uid)
    return ({c.uid: c.tokens.tolist() for c in done},
            {c.uid: c.ticks for c in done}, events)


def paged_results(mesh=None) -> dict:
    """The smoke llada-8b engine on the paged pool over ``mesh`` (None:
    one rank), beside the slot pool on the same mesh: JAX's
    tests/test_paged_cache.py mesh case (mode none, three requests of 8 +
    8 on two slots of 16), then ``paged_trace`` (a shared prefix) in modes
    none and warm at K 1 and the megatick (K 4), and warm with a preempt
    after two ticks (restored into whichever slot frees first)."""
    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = base.get_config("llada-8b", smoke=True)
    mdl = build_model(cfg, "cpu")
    params = mdl.init(0)

    def engine(pool, mode, k=1, **kw):
        dc = diffusion.DiffusionConfig(
            gen_length=16, block_length=8, steps_per_block=4,
            cache_mode="dual" if mode == "warm" else "none")
        return ServingEngine(mdl, params, dc, EngineConfig(
            num_slots=2, mode=mode, pool=pool, mesh=mesh, megatick_k=k,
            page_size=8, seed=0, **{"max_seq_len": 32, **kw}))

    out = {}
    rs = np.random.RandomState(60)
    jax_case = [(rs.randint(0, cfg.vocab - 2, size=(8,)).astype(np.int32),
                 8) for _ in range(3)]
    for pool in ("paged", "slot"):
        out["jax case", pool] = _paged_serve(
            engine(pool, "none", max_seq_len=16), jax_case)
        for mode in ("none", "warm"):
            for k in (1, 4):
                eng = engine(pool, mode, k)
                out[mode, k, pool] = _paged_serve(eng, paged_trace(
                    cfg.vocab))
                if pool == "paged":
                    out["stats", mode, k] = eng.pool.stats()
    trace = [(p, 16) for p, _ in paged_trace(cfg.vocab)[:3]]
    eng = engine("paged", "warm")
    out["preempt"] = _paged_serve(eng, trace, preempt_at=2)
    st = eng.pool.stats()
    out["preempt stats"] = (st["preemptions"], st["restores"])
    out["preempt base"] = _paged_serve(engine("paged", "warm"), trace)
    return out


# ---------------------------------------------------------------------------
# the sampled decode step over a mesh (tests/test_torch_sampled_mesh.py)
# ---------------------------------------------------------------------------

# "v256": route A (llada-8b) or route C (recurrentgemma-2b) at |model| 2;
# llada-8b's V 257: the head replicated on every ``model`` rank; "v288":
# mamba's shards of 144 columns split MX blocks, so its head is gathered
SAMPLED_CASES = ("llada-8b v256", "llada-8b", "recurrentgemma-2b v256",
                 "mamba2-130m v288")
# (name, temperature, strategy): the greedy step beside the sampled ones
SAMPLED_POLICIES = (("greedy", 0.0, "stablemax"), ("hot", 0.8, "stablemax"),
                    ("random", 0.8, "random"), ("random-cold", 0.0, "random"))


def sampled_run(case: str, mesh=None) -> dict:
    """Prefill, then one decode step under each of ``SAMPLED_POLICIES``,
    on the full inputs (no mesh) or on this rank's shards over ``mesh``:
    the canvas gathered whole (numpy) and, over a mesh, whether every
    ``model`` rank holds the same canvas."""
    from repro_torch import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as launch_sharding
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    cfg = tp_config(case)
    model = build_model(cfg, "cpu")
    _, x, k = (torch.from_numpy(a) for a in step_inputs(cfg))
    pre, dec = (step_shape(kind, step_block(cfg))
                for kind in ("prefill", "decode"))
    out = {}
    for name, temp, strategy in SAMPLED_POLICIES:
        policy = steps.ServePolicy(sampling=dataclasses.replace(
            steps.ServePolicy().sampling, temperature=temp,
            strategy=strategy))
        inp = {"params": tp_params(model), "x": x,
               "cache": model.init_cache(STEP_B, STEP_S), "extras": {}}
        kk = k
        if mesh is not None:
            specs = {kind: steps.input_specs(model, shp, policy)
                     for kind, shp in (("pre", pre), ("dec", dec))}
            with sharding.use_context(mesh, launch_sharding.make_rules(
                    cfg, mesh)):
                pls = steps.input_shardings(model, pre, mesh, specs["pre"],
                                            policy)
                dpl = steps.input_shardings(model, dec, mesh, specs["dec"],
                                            policy)
            meta = build_model(cfg, "meta").init_cache(STEP_B, STEP_S)
            inp = steps.shard_inputs(inp, pls)
            inp["params"] = launch_sharding.place(tp_params(model),
                                                  pls["params"])
            inp["cache"] = launch_sharding.local_like(
                meta, pls["cache"],
                lambda path: 1.0 if path.endswith("_scale") else 0.0)
            kk = steps.shard_inputs({"k": k}, {"k": dpl["k"]})["k"]
        fp, _ = steps.build_step(model, pre, policy, mesh=mesh)
        fd, _ = steps.build_step(model, dec, policy, mesh=mesh)
        _, cache = fp(inp["params"], inp["x"], inp["cache"], STEP_BS, {})
        x1, _ = fd(inp["params"], inp["x"], cache, STEP_BS, kk, 5, {})
        if mesh is not None:
            both = mesh_lib.all_gather(x1.reshape(1, -1), 0,
                                       mesh.axis("model"))
            out["model equal", name] = bool((both == both[:1]).all())
            x1 = _gather(x1, 0, mesh.axis("data"))
        out[name] = x1.numpy()
    return out


def sampled_partials_inputs():
    """hidden (R, D), head (D, V_HEAD) and stored logits (R, V_LOGITS),
    from one numpy seed, for the sampled shard partials."""
    rs = np.random.RandomState(5)
    h = rs.randn(R, D).astype(np.float32)
    w = (rs.randn(D, V_HEAD) * 0.3).astype(np.float32)
    logits = (rs.randn(R, V_LOGITS) * 3).astype(np.float32)
    return h, w, logits


SAMPLED_SEED, SAMPLED_ROW0 = 1234, 40


def _job_sampled_combine(rank: int, world: int) -> dict:
    """The sampled shard partials' plain versions of 1, 2 and 4 shards,
    merged by ``sampling.combine_partials`` over a gloo group: (conf,
    token) of the fused head's (route A) and of stored logits' (route
    C), at T 0.8, a row offset and every format of ``FMTS``."""
    from repro_torch.core import sampling
    from repro_torch.kernels import fused_head_sampling as fhs
    from repro_torch.kernels import stablemax_sampling as sms
    from repro_torch.launch import mesh as mesh_lib
    h, w, logits = (torch.from_numpy(a) for a in sampled_partials_inputs())
    groups = {n: dist.new_group(list(range(n))) for n in SHARDS}
    kw = dict(temperature=0.8, seed=SAMPLED_SEED, row_offset=SAMPLED_ROW0)
    out = {}
    for n in SHARDS:
        if rank >= n:
            continue
        axis = mesh_lib.Axis("model", n, rank, groups[n])
        wp = sampling.pad_head_for_mesh(w, n)
        vloc = wp.shape[1] // n
        for fmt in FMTS:
            for sup in SUPPRESS:
                parts = fhs.head_shard_partials_plain(
                    h, wp[:, rank * vloc:(rank + 1) * vloc], fmt,
                    col_offset=rank * vloc, col_limit=V_HEAD,
                    suppress_id=sup, **kw)
                conf, idx = sampling.combine_partials(*parts[:3], axis,
                                                      *parts[3:])
                out["head", n, fmt, sup] = (conf.numpy(), idx.numpy())
            lv = V_LOGITS // n
            parts = sms.stablemax_shard_partials_plain(
                logits[:, rank * lv:(rank + 1) * lv], fmt,
                col_offset=rank * lv, suppress_id=100, **kw)
            conf, idx = sampling.combine_partials(*parts[:3], axis,
                                                  *parts[3:])
            out["logits", n, fmt] = (conf.numpy(), idx.numpy())
    return out


def _job_sampled(rank: int, world: int, data: int, model: int) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_debug_mesh(data, model, "cpu")
    return {case: sampled_run(case, mesh) for case in SAMPLED_CASES}


# ---------------------------------------------------------------------------
# serve --http over a mesh (tests/test_torch_frontend_mesh.py)
# ---------------------------------------------------------------------------

FRONT_PROMPT, FRONT_GEN = 16, 16


def frontend_prompts(vocab: int, n: int = 8):
    """Distinct prompts (lists of ids) from one numpy seed."""
    rs = np.random.RandomState(31)
    return [rs.randint(0, vocab - 2, size=(FRONT_PROMPT,)).tolist()
            for _ in range(n)]


def frontend_flow(mesh=None, abort: bool = False) -> dict:
    """The HTTP frontend of the smoke llada-8b (2 slots, max_queue 1,
    max_queue_wait 0) on this rank of ``mesh`` (None: one process).  Rank
    0 serves: with its workers paused, four requests of which one is
    answered 429; the workers start, two are admitted and the third is
    shed by its deadline; then three pairs of requests, each pair one
    streamed and one gathered; then a graceful drain.  Every other rank
    follows.  Returns {"rows": rank 0's (prompt index, result) pairs in
    the order the requests were sent,
    "done": {prompt index: (tokens, ticks)} of this rank's engine,
    "ticks_total", "control": (records, seconds)}.  With ``abort``
    rank 0's engine refuses its first submission with an error, which
    crashes its worker."""
    import asyncio

    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model
    from repro_torch.serving.frontend import build_frontend, loadgen
    cfg = base.get_config("llada-8b", smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    dcfg = diffusion.DiffusionConfig(gen_length=FRONT_GEN, block_length=8,
                                     steps_per_block=4)
    prompts = frontend_prompts(cfg.vocab)
    index = {tuple(p): i for i, p in enumerate(prompts)}
    done = {}

    def on_complete(c):
        key = index[tuple(c.tokens[:c.prompt_len].tolist())]
        done[key] = (c.tokens.tolist(), int(c.ticks))

    fe = build_frontend(model, params, dcfg, model_name="llada-8b",
                        replicas=1, num_slots=2,
                        max_seq_len=FRONT_PROMPT + FRONT_GEN, mode="none",
                        max_queue=1, max_queue_wait=0.0, mesh=mesh,
                        on_complete=on_complete)
    if mesh is not None and mesh.rank != 0:
        fe.run()                  # raises MeshAborted if rank 0 aborts
        w = fe.workers[0]
        return {"done": done, "ticks_total": w.engine.ticks_total,
                "follower_ticks": w.ticks}
    if abort:
        eng = fe.router.workers[0].engine

        def refuse(*a, **kw):
            raise RuntimeError("injected submit failure")
        eng.submit = refuse

    worker = fe.router.workers[0]

    async def settle():
        """Until the worker's load snapshot shows every slot free: a
        client sees its last commit before the worker refreshes it."""
        while worker.accepting and (worker.free_slots < 2 or worker.queued):
            await asyncio.sleep(0.01)

    async def go():
        await fe.start(start_workers=False)
        rows = []

        async def one(i, stream=True):
            at = len(rows)
            rows.append((i, None))
            rows[at] = (i, await loadgen.complete(
                fe.url, prompts[i], FRONT_GEN, stream=stream, timeout=60.0))
        try:
            first = [asyncio.ensure_future(one(i, stream=i % 2 == 0))
                     for i in range(4)]
            while sum(t.done() for t in first) < 1:
                await asyncio.sleep(0.01)
            fe.start_workers()
            await asyncio.gather(*first)
            for i in (4, 6, 0):
                await settle()
                await asyncio.gather(one(i), one(i + 1 if i else 3,
                                                  stream=False))
        finally:
            await fe.shutdown(drain=True)
        return rows

    rows = asyncio.run(go())
    w = fe.router.workers[0]
    ctl = w.control
    return {"rows": rows, "done": done, "ticks_total": w.engine.ticks_total,
            "control": None if ctl is None else (ctl.records, ctl.seconds)}


def _job_frontend(rank: int, world: int, data: int, model: int,
                  abort: bool = False) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_debug_mesh(data, model, "cpu")
    res = frontend_flow(mesh, abort)
    if abort:                 # the followers raised: rank 0's alone
        return res
    every = [None] * world
    dist.all_gather_object(every, res)
    return {"ranks": every}


def _job_paged(rank: int, world: int, data: int, model: int) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    return paged_results(mesh_lib.make_debug_mesh(data, model, "cpu"))


JOBS = {"combine": _job_combine, "serve": _job_serve,
        "compress": _job_compress, "steps": _job_steps, "tp": _job_tp,
        "paged": _job_paged, "sampled": _job_sampled,
        "frontend": _job_frontend,
        "sampled_combine": _job_sampled_combine}


def run_rank(rank: int, world: int, store: str, job: str, out: str,
             kwargs: dict, timeout: float = 150.0) -> None:
    import datetime
    torch.set_num_threads(1)
    # a collective that waits past the job's deadline raises in its rank
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        res = JOBS[job](rank, world, **kwargs)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, tmp_path, timeout: float = 150.0,
          codes=None, **kwargs):
    """Run ``job`` on ``world`` ranks; rank 0's result.  Each process is
    joined against one deadline and killed past it (the test fails); the
    ranks' exit codes must be ``codes`` (default all 0)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    # the kwargs hashed: a long case list would overflow a file name
    tag = f"{job}-{world}-" + hashlib.sha1(
        repr(sorted(kwargs.items())).encode()).hexdigest()[:12]
    store, out = tmp_path / f"{tag}.store", tmp_path / f"{tag}.pkl"
    procs = [ctx.Process(target=run_rank, args=(r, world, str(store), job,
                                                str(out), kwargs, timeout))
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
    got = [p.exitcode for p in procs]
    want = [0] * world if codes is None else list(codes)
    assert got == want, f"{job}: rank exit codes {got}, want {want}"
    with open(out, "rb") as f:
        return pickle.load(f)
