"""Step builders, ported from src/repro/launch/steps.py: one step function
per shape kind, the stand-ins of its inputs (meta tensors, no allocation)
and their placements on a mesh.

Kinds:
  train   -> the LLaDA masked-diffusion loss, every gradient, AdamW.
  prefill -> the warm step: a full-sequence bidirectional forward, BAOS
             calibration, the smoothed and quantized KV cache written,
             the active block's logits.
  decode  -> the serve step: ONE refinement of the active block against
             the KV cache (over the split cache's active buffer with
             ``ServePolicy(split_cache=True)``), Stable-Max sampling and
             the top-k commit, the block written back into the canvas.

``build_step(..., mesh=)`` is the counterpart of ``jax.jit(step,
in_shardings=input_shardings(...))`` on a (data, model) mesh
(launch/mesh.py): rows shard over ``data``, and over ``model`` the
parameters, the KV cache and the optimizer state as JAX's rules place
them (launch/sharding.make_rules: heads, MLP, experts and vocab; the
cache by head or by sequence).  The port is multi-controller, so each
rank's step takes and returns its own shards (``shard_inputs`` cuts full
inputs by ``input_shardings``; launch/sharding.place allocates only the
shards) and runs the tensor-parallel body on them (models/tp.py), where
GSPMD partitions JAX's step.  Prefill and decode run on the rank's rows
alone (BAOS calibration and the cache are per row); prefill returns the
rank's vocab columns of the logits where the head is vocab-sharded, and
decode samples over such a head through ``sampling.combine_partials``,
so every ``model`` rank commits the same tokens (greedy or sampled: the
noise is drawn at the global row and column, so a sampled decode on any
mesh commits what one device commits): the transformer
families stream the block's hidden states through the fused head's
vocab-shard entry (route A); the ssm and hybrid families, which have no
head mode, reduce their stored logit columns with Stable-Max's
vocab-shard entry (route C).  Where a shard is not a whole number of MX
blocks the head is gathered over ``model`` first.  The train step draws
the global batch's mask and keeps its rows, divides the loss by the
global B * S (the MoE aux is the global batch's), sums the gradients
over ``data`` before AdamW, and clips by the norm of the whole gradient
(the sharded leaves' squares summed over ``model``), so every rank
applies the same update.

JAX seeds each step with ``fold_in(PRNGKey(0), seed)``; the port draws
the train step's mask from ``diffusion.step_generator(0, seed)`` and
samples with ``diffusion.tick_seed(0, seed)`` (ROADMAP.md, Queue 3,
"Randomness").  Tests hand the train step JAX's own draw (``draw=``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding as shlib
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import baos as baos_lib
from repro_torch.core import diffusion
from repro_torch.core.mx import MX_BLOCK
from repro_torch.core import sampling as sampling_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as launch_sharding
from repro_torch.launch import train as train_lib
from repro_torch.models import tp as tp_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    cache_mode: str = "dual"
    baos: baos_lib.BAOSConfig = baos_lib.BAOSConfig(
        enabled=True, kv_format="mxint4")
    sampling: sampling_lib.SamplingConfig = sampling_lib.SamplingConfig(
        fmt="mxfp8_e4m3")
    steps_per_block: int = 8
    split_cache: bool = False     # the replicated active-block KV buffer
    loss_chunk: int = 0           # chunked CE reduction (train)


def make_dcfg(cfg: ModelConfig, shape: ShapeConfig,
              policy: ServePolicy) -> diffusion.DiffusionConfig:
    return diffusion.DiffusionConfig(
        gen_length=shape.block_length, block_length=shape.block_length,
        steps_per_block=policy.steps_per_block, cache_mode=policy.cache_mode,
        sampling=policy.sampling, baos=policy.baos)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extra_inputs(cfg: ModelConfig, batch: int, kind: str) -> Dict[str, Any]:
    """The stub frontends' inputs, as meta tensors: the audio family's
    frames (train, prefill) or encoder K/V (decode), the vlm family's
    image (train, prefill)."""
    ex: Dict[str, Any] = {}
    if cfg.family == "audio":
        if kind in ("train", "prefill"):
            ex["audio_embeds"] = _meta((batch, cfg.n_audio_ctx, cfg.d_model),
                                       torch.bfloat16)
        else:
            kv = (cfg.n_layers, batch, cfg.n_audio_ctx, cfg.n_kv_heads,
                  cfg.d_head)
            ex["cross_kv"] = (_meta(kv, cfg.torch_dtype),
                              _meta(kv, cfg.torch_dtype))
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        ex["image_embeds"] = _meta((batch, cfg.n_image_tokens, cfg.d_model),
                                   torch.bfloat16)
    return ex


def _extra_shardings(ex: Dict[str, Any], mesh) -> Dict[str, Any]:
    def spec(x):
        if isinstance(x, tuple):
            return tuple(spec(e) for e in x)
        names = ("batch",) + (None,) * (x.dim() - 1)
        if x.dim() == 5:   # stacked cross-kv
            names = ("layers", "batch", None, "kv_heads", "head_dim")
        return shlib.Placement(mesh, shlib.spec_for(names, tuple(x.shape)))
    return {k: spec(v) for k, v in ex.items()}


def _fwd_extras(model, extras: Dict[str, Any], kind: str,
                params) -> Dict[str, Any]:
    """The extra *inputs* as forward kwargs, inside the step: the audio
    family encodes its frames here in train and prefill (under autograd
    in train, as JAX differentiates through the encoder)."""
    cfg = model.cfg
    kw = {}
    if cfg.family == "audio":
        if kind in ("train", "prefill"):
            enc = model.encode(params, extras["audio_embeds"])
            kw["cross_kv"] = model.cross_kv(params, enc)
        else:
            kw["cross_kv"] = extras["cross_kv"]
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        kw["image_embeds"] = extras["image_embeds"]
    return kw


def _axes(mesh) -> Tuple[Optional[mesh_lib.Axis], Optional[mesh_lib.Axis]]:
    """The mesh's ``data`` and ``model`` axes (None without a mesh, and
    ``model`` None at |model| = 1); raises for a mesh shape, which has no
    ranks."""
    if mesh is None:
        return None, None
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh {mesh!r} is not a launch/mesh.Mesh (a mesh "
                        "shape has no ranks to run a step on)")
    if mesh.shape["model"] == 1:
        return mesh.axis("data"), None
    return mesh.axis("data"), mesh.axis("model")


def param_placements(model, mesh):
    """The parameters' ``sharding.Placement`` tree on ``mesh`` under JAX's
    rules (launch/sharding.make_rules)."""
    meta = build_model(model.cfg, "meta").init()
    with shlib.use_context(mesh, launch_sharding.make_rules(model.cfg,
                                                            mesh)):
        return launch_sharding.tree_shardings(model.param_specs(), meta,
                                              mesh)


def _sharded_flags(model, mesh) -> list:
    """Per parameter leaf (``tree.leaves`` order): whether ``model``
    shards it."""
    return ["model" in launch_sharding.spec_axes(p.spec)
            for p in tree_lib.leaves(param_placements(model, mesh))]


def _context(model_ax, data=None, cache=None, x=None):
    """The tensor-parallel body's ``models/tp.Parallel`` for a step: the
    cache is context-parallel when its sequence dim is shorter than the
    canvas's."""
    if model_ax is None:
        return tp_lib.Parallel(data=data) if data is not None else None
    seq = cache is not None and "k" in cache and \
        cache["k"].shape[2] != x.shape[1]
    return tp_lib.Parallel(model=model_ax, data=data, cache_seq=seq)


def _block_cols(block_start, L: int, device) -> torch.Tensor:
    """The active block's columns: ``block_start`` an int or a one-element
    tensor."""
    start = (block_start.reshape(()).to(device=device, dtype=torch.int64)
             if isinstance(block_start, torch.Tensor) else int(block_start))
    return start + torch.arange(L, device=device)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def build_grad_fn(model, aux_weight: float = 0.01,
                  policy: Optional[ServePolicy] = None, mesh=None):
    """The train step's loss and gradients: ``grad_fn(params, tokens,
    seed, extras, draw=None) -> (metrics, grads)`` (grads in
    ``tree.leaves(params)`` order).  ``tokens`` are this rank's rows;
    ``draw``, if given, is the *global* batch's ``(noisy, mask, t)``, else
    it is drawn from ``diffusion.step_generator(0, seed)`` for the global
    batch; either way the rank keeps its rows.  Over a data mesh the
    gradients are summed over ``data`` (in f32, cast back to each leaf's
    dtype) and the metrics are global."""
    cfg = model.cfg
    loss_chunk = policy.loss_chunk if policy and policy.loss_chunk else None
    data, model_ax = _axes(mesh)
    ctx = _context(model_ax, data)
    aux = aux_weight if cfg.moe is not None else 0.0

    def grad_fn(params, tokens: torch.Tensor, seed: int, extras: Dict,
                draw=None):
        B, S = tokens.shape
        n = 1 if data is None else data.size
        r0, r1 = (0, B) if data is None else mesh.rows(B * n)
        if draw is None:
            gen = diffusion.step_generator(0, seed, tokens.device)
            full = torch.zeros((B * n, S), dtype=tokens.dtype,
                               device=tokens.device)
            _, mask, t = diffusion.forward_mask(gen, full, cfg.mask_id)
            mask, t = mask[r0:r1], t[r0:r1]
            draw = (torch.where(mask, cfg.mask_id, tokens), mask, t)
        else:
            draw = tuple(d[r0:r1] for d in draw)
        valid = None
        if cfg.family == "vlm" and cfg.n_image_tokens:
            pos = torch.arange(S, device=tokens.device)
            valid = (pos >= cfg.n_image_tokens).expand(B, S)
        with tp_lib.use(ctx):
            metrics, grads = train_lib.loss_and_grads(
                model, params, tokens, aux_weight=aux, valid=valid,
                loss_chunk=loss_chunk, draw=draw, axis=data,
                fwd_kw_of=lambda p: _fwd_extras(model, extras, "train", p))
        if data is not None:
            flat = mesh_lib.all_reduce(torch.cat(
                [g.reshape(-1).to(torch.float32) for g in grads]), "sum",
                data)
            out, at = [], 0
            for g in grads:
                out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
                at += g.numel()
            grads = out
        return metrics, grads

    return grad_fn


def build_train_step(model, opt_cfg: adamw.OptConfig,
                     aux_weight: float = 0.01,
                     policy: Optional[ServePolicy] = None, mesh=None):
    """``train_step(params, opt_state, tokens, seed, extras, draw=None)
    -> (params, opt_state, metrics)``: ``build_grad_fn``'s loss and
    gradients, then AdamW in place (launch/train.make_train_step's
    arithmetic), clipping by the whole gradient's norm over a
    tensor-parallel mesh."""
    grad_fn = build_grad_fn(model, aux_weight, policy, mesh)
    _, model_ax = _axes(mesh)
    sharded = _sharded_flags(model, mesh) if model_ax is not None else None

    def train_step(params, opt_state, tokens, seed, extras, draw=None):
        metrics, grads = grad_fn(params, tokens, seed, extras, draw)
        _, _, stats = adamw.apply_updates(params, grads, opt_state, opt_cfg,
                                          model_ax, sharded)
        return params, opt_state, {**metrics, **stats}

    return train_step


def build_prefill_step(model, dcfg: diffusion.DiffusionConfig, mesh=None):
    """``prefill_step(params, x, cache, block_start, extras) -> (logits of
    the active block, cache)``: ``diffusion.warm_step``, the cache
    rewritten in place; over |model| > 1 the logits are this rank's
    vocab columns where the head is vocab-sharded."""
    _, model_ax = _axes(mesh)

    @torch.no_grad()
    def prefill_step(params, x, cache, block_start, extras):
        with tp_lib.use(_context(model_ax, cache=cache, x=x)):
            kw = _fwd_extras(model, extras, "prefill", params)
            return diffusion.warm_step(model, params, x, cache, block_start,
                                       dcfg, **kw)

    return prefill_step


def build_serve_step(model, dcfg: diffusion.DiffusionConfig, mesh=None):
    """``serve_step(params, x, cache, block_start, k, seed, extras) ->
    (x, cache)``: ``diffusion.refine_step`` over the active block, then
    ``sampling.sampling_step`` on its logits (k[b] tokens committed in
    row b), the block written into a new canvas.  Over |model| > 1 with a
    vocab-sharded head ``_sample_sharded`` runs the sharded head: on the
    refine's hidden states where the model has a head mode, else on its
    logit columns.  It samples on any mesh (temperature > 0, strategy
    'random') as one device does: every noise draw is indexed by the
    global row (this data shard's first flattened row onward) and the
    global vocab column, as GSPMD partitions JAX's draw over the global
    logits."""
    cfg = model.cfg
    data, model_ax = _axes(mesh)
    s = dcfg.sampling
    L = dcfg.block_length
    head_mode = getattr(model, "supports_head_mode", True)

    @torch.no_grad()
    def serve_step(params, x, cache, block_start, k, seed, extras):
        sharded = model_ax is not None and \
            params["lm_head"].shape[-1] != cfg.vocab
        if sharded and not head_mode and \
                params["lm_head"].shape[-1] % MX_BLOCK:
            # the logit columns would split MX blocks: the head gathered
            params = {**params, "lm_head": mesh_lib.all_gather(
                params["lm_head"], 1, model_ax)}
            sharded = False
        with tp_lib.use(_context(model_ax, cache=cache, x=x)):
            kw = _fwd_extras(model, extras, "decode", params)
            feats, cache = diffusion.refine_step(
                model, params, x, cache, block_start, dcfg,
                head_mode="hidden" if sharded and head_mode else "logits",
                **kw)
        cols = _block_cols(block_start, L, x.device)
        xb = x.index_select(1, cols)
        seed = diffusion.tick_seed(0, seed)
        # the global flattened (B * L) row of this rank's first row
        row0 = 0 if data is None else data.index * xb.shape[0] * L
        if sharded:
            xa = _sample_sharded(feats, params["lm_head"], xb, k, cfg, s,
                                 seed, model_ax, hidden=head_mode,
                                 row_offset=row0)
        else:
            xa, _ = sampling_lib.sampling_step(feats, xb, cfg.mask_id, k, s,
                                               seed, row0)
        return x.index_copy(1, cols, xa.to(x.dtype)), cache

    return serve_step


def _sample_sharded(feats, w_loc, xb, k, cfg: ModelConfig, s, seed, axis,
                    hidden: bool = True, row_offset: int = 0):
    """The decode step's sampling over a vocab-sharded head.  From the
    block's hidden states (B, L, d) (``hidden``): where each shard's
    width is a multiple of the MX block, the fused head's vocab-shard
    entry (route A) and ``sampling.combine_partials`` (the same tokens on
    every ``model`` rank); otherwise the head gathered over ``model`` and
    the single-device fused head.  From this rank's logit columns
    (B, L, V / |model|), whose width the caller made a multiple of the MX
    block: Stable-Max's vocab-shard entry (route C) and the combine.
    ``row_offset`` is the global flattened row of the block's first row,
    where a sampled step draws its noise."""
    from repro_torch.kernels import fused_head_sampling as fhs
    if not hidden:
        xa, _, _ = sampling_lib.sharded_sampling_step_full(
            feats, xb, cfg.mask_id, k, s, seed, axis=axis,
            row_offset=row_offset)
        return xa
    scale = float(cfg.logit_scale)
    if w_loc.shape[-1] % MX_BLOCK == 0:
        xa, _, _ = sampling_lib.sharded_fused_sampling_step_full(
            feats, w_loc, xb, cfg.mask_id, k, s, seed, axis=axis,
            logit_scale=scale, col_limit=int(cfg.vocab),
            row_offset=row_offset)
        return xa
    w = fhs.pad_head(mesh_lib.all_gather(w_loc, 1, axis))
    xa, _, _ = sampling_lib.fused_sampling_step_full(
        feats, w, xb, cfg.mask_id, k, s, seed, logit_scale=scale,
        row_offset=row_offset)
    return xa


# ---------------------------------------------------------------------------
# Input specs + placements per (arch, shape)
# ---------------------------------------------------------------------------

def _act_len(shape: ShapeConfig, policy: Optional[ServePolicy]):
    return (shape.block_length
            if (policy and policy.split_cache and shape.kind != "train")
            else None)


def input_specs(model, shape: ShapeConfig,
                policy: Optional[ServePolicy] = None) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every step input (no allocation), with
    the shapes and dtypes of JAX's ``eval_shape`` specs; the parameter and
    optimizer trees in the port's layout.  AdamW's ``step`` stands as an
    int32 scalar, as JAX keeps it."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    meta = build_model(cfg, "meta")
    params = meta.init()
    specs: Dict[str, Any] = {"params": params}
    extras = _extra_inputs(cfg, B, shape.kind)
    if shape.kind == "train":
        opt = adamw.init_state(params)
        opt["step"] = _meta((), torch.int32)
        specs["opt_state"] = opt
        specs["tokens"] = _meta((B, S), torch.int32)
        specs["seed"] = _meta((), torch.uint32)
    else:
        specs["x"] = _meta((B, S), torch.int32)
        specs["cache"] = meta.init_cache(B, S, _act_len(shape, policy))
        specs["block_start"] = _meta((), torch.int32)
        if shape.kind == "decode":
            specs["k"] = _meta((B,), torch.int32)
            specs["seed"] = _meta((), torch.uint32)
    specs["extras"] = extras
    return specs


def input_shardings(model, shape: ShapeConfig, mesh,
                    specs: Dict[str, Any],
                    policy: Optional[ServePolicy] = None) -> Dict[str, Any]:
    """``sharding.Placement`` trees of ``input_specs``'s, under the active
    rules (``sharding.use_context(mesh, launch/sharding.make_rules(cfg,
    mesh))``)."""
    rep = launch_sharding.replicated(mesh)
    out: Dict[str, Any] = {
        "params": launch_sharding.tree_shardings(
            model.param_specs(), specs["params"], mesh)}
    tok = shlib.Placement(mesh, shlib.spec_for(
        ("batch", "seq"), (shape.global_batch, shape.seq_len)))
    if shape.kind == "train":
        out["opt_state"] = {
            "m": out["params"], "v": out["params"], "step": rep}
        out["tokens"] = tok
        out["seed"] = rep
    else:
        out["x"] = tok
        out["cache"] = launch_sharding.tree_shardings(
            model.cache_specs(_act_len(shape, policy)), specs["cache"],
            mesh)
        out["block_start"] = rep
        if shape.kind == "decode":
            out["k"] = shlib.Placement(mesh, shlib.spec_for(
                ("batch",), (shape.global_batch,)))
            out["seed"] = rep
    out["extras"] = _extra_shardings(specs["extras"], mesh)
    return out


def shard_inputs(inputs: Dict[str, Any], shardings: Dict[str, Any],
                 coords=None) -> Dict[str, Any]:
    """Full step inputs (keys of ``input_specs``) cut to the shards of the
    rank at ``coords`` (default this rank) under ``input_shardings``'s
    placements; numbers (a seed, a block start) pass as they are."""
    def cut(x, placement):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return shlib.local_shard(x, placement, coords)
    return {k: tree_lib.tree_map(cut, v, shardings[k])
            for k, v in inputs.items()}


def build_step(model, shape: ShapeConfig,
               policy: Optional[ServePolicy] = None,
               opt_cfg: Optional[adamw.OptConfig] = None, mesh=None):
    """Returns (step_fn, ordered arg names) for the shape kind; with
    ``mesh`` the step of one rank of it, on that rank's shards."""
    policy = policy or ServePolicy()
    if shape.kind == "train":
        fn = build_train_step(model, opt_cfg or adamw.OptConfig(),
                              policy=policy, mesh=mesh)
        return fn, ("params", "opt_state", "tokens", "seed", "extras")
    dcfg = make_dcfg(model.cfg, shape, policy)
    if shape.kind == "prefill":
        return build_prefill_step(model, dcfg, mesh), \
            ("params", "x", "cache", "block_start", "extras")
    fn = build_serve_step(model, dcfg, mesh)
    return fn, ("params", "x", "cache", "block_start", "k", "seed", "extras")
