"""dLLM transformer, dense or MoE (also the decoder of the audio family
and the backbone of the vlm family), ported from
src/repro/models/transformer.py, and the helpers the recurrent families
share with it (``embed``, ``apply_norm``, ``cache_attention``,
``head_logits``, ``rows``).

Parameters are plain dicts: ``embed`` (V, d), ``layers`` (a list of
per-layer dicts ``ln1, ln2, wq, wk, wv, wo, [bq, bk, bv]`` and the FFN:
``w_gate, w_up, w_down`` (SwiGLU), ``w_in, b_in, w_out, b_out`` (GELU),
or for an MoE model the JAX ``moe`` subtree, models/moe.py; with
cross-attention also ``ln_x`` and ``xattn`` ``{wq, wk, wv, wo}``),
``final_norm`` and ``lm_head`` (d, V) -- the JAX layout, with the layer
stack split into a list and not an ``nn.Linear`` (which would store the
head transposed).  A norm is its weight (d,) for RMSNorm, and JAX's
``{"w", "b"}`` for LayerNorm (``norm="ln"``).

``forward`` runs a segment of tokens at positions ``seg_start + r``.
Without a cache it is the full recompute (like the JAX forward it then
attends over every position and ignores ``kv_valid``).  With one, it
writes the segment's K/V into the cache at ``seg_start`` -- smoothed and
MX-quantized by the BAOS kernel when BAOS is on -- and attends over the
whole cache through ``kv_valid``: the warm step (the whole sequence,
``calibrate=True``) and the refine steps of cache modes dual and prefix (a
block or block + suffix, reading the stored calibration).  The JAX
forward returns a new cache instead; writing in place saves the copy, and
is the write-back the paper describes.

``forward(embeds=...)`` takes the segment's embeddings in place of its
tokens (the vlm family's image splice, models/vlm.py), and
``forward(cross_kv=(k, v))`` adds a cross-attention sublayer to every
layer over the stacked encoder K/V (n_layers, B, S_enc, Hkv, D) (the
audio family, models/whisper.py): no RoPE, no mask, after the
self-attention residual and before ``ln2``.

``seg_start`` (and the start of ``logits_slice``) may also be a device
tensor of one element: the block start a captured CUDA graph reads from
memory (core/diffusion's graphed steps).  The segment's K/V are then
scattered into the cache at that start (``index_copy_``) instead of
written through a slice, with the same values, and attention reads the
start from device memory to place the window and the causal mask.

``attn_mode`` (the config's, or ``forward(attn_mode=)``): "bidir", or
"causal" (a query attends to keys at its position and before), JAX's
mode for the hybrid/AR-baseline paths; every self-attention takes it
(no cache, warm, refine, the split cache's route B); cross-attention
stays bidirectional.  ``cfg.score_dtype`` "bfloat16" (JAX's bf16 scores,
in its chunks of ``cfg.attn_chunk`` on the plain version) reaches the
same self-attentions, the encoder's of the audio family too;
cross-attention keeps f32 scores, as JAX's does.  ``quant``, a
``layers.QuantPolicy``, fake-quantizes both operands of every GEMM,
the LM head's included, as the JAX forward does.

Inside a step over a mesh with |model| > 1 (launch/steps.py) the same
code runs the tensor-parallel body on this rank's shards: the products
through models/tp.py (``col``/``row``), attention on local heads or on
every head gathered (``attn_layout``), and a context-parallel cache
gathered per layer (``_context_parallel``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils import checkpoint

from repro_torch import device as device_lib
from repro_torch.core import baos as baos_lib
from repro_torch.kernels import flash_bidir, fused_head_sampling
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import tp as tp_lib
from repro_torch.models.config import ModelConfig

ROADMAP = "ROADMAP.md, Queue 3"
# a segment start: an int, or a one-element device tensor
SegStart = Union[int, torch.Tensor]


# this module's stacks (models/registry.py maps every family to its model)
FAMILIES = ("dense", "moe", "audio", "vlm")


# JAX's remat policies (transformer.forward's jax.checkpoint): "full"
# saves nothing, "dots" saves the matrix products' outputs
REMAT = ("none", "full", "dots")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a transformer config the port does not run: a norm
    outside (rms, ln) or an FFN outside (swiglu, gelu), names JAX never
    defines (it runs rms for any norm but "ln" and gelu for any FFN but
    "swiglu"); an attention mode outside (bidir, causal), a ``remat``
    outside ``REMAT`` or a ``score_dtype`` outside (float32, bfloat16)
    (ValueError: JAX takes any jnp dtype, but no config sets another).
    Attention takes any head dim.  A config of another family is not this
    module's stack (ValueError)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a transformer stack "
                         f"{FAMILIES}: build it with "
                         f"models/registry.build_model")
    if (cfg.family == "moe") != (cfg.moe is not None):
        raise ValueError(f"family {cfg.family!r} with moe={cfg.moe!r}")
    if cfg.norm not in ("rms", "ln") or cfg.ffn not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"norm={cfg.norm!r}, ffn={cfg.ffn!r}: names JAX does not define "
            f"({ROADMAP}); the port runs rms or ln / swiglu or gelu")
    flash_bidir.check_score_dtype(cfg.score_dtype)
    check_attn_mode(cfg.attn_mode)
    if cfg.remat not in REMAT:
        raise ValueError(f"remat {cfg.remat!r} not in {REMAT}")


ATTN_MODES = ("bidir", "causal")


def check_attn_mode(mode: str) -> None:
    if mode not in ATTN_MODES:
        raise ValueError(f"attn_mode {mode!r} not in {ATTN_MODES}")


def apply_norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """The config's norm, JAX's ``_apply_norm``: RMSNorm with weight ``p``,
    or LayerNorm with ``p`` = ``{"w", "b"}``."""
    if cfg.norm == "ln":
        return layers.layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return layers.rms_norm(x, p, cfg.norm_eps)


def norm_params(cfg: ModelConfig, d: int, device) -> Union[torch.Tensor,
                                                            Dict]:
    """A fresh norm: unit weight, and for LayerNorm a zero bias."""
    w = torch.ones((d,), dtype=cfg.torch_dtype, device=device)
    if cfg.norm == "ln":
        return {"w": w, "b": torch.zeros_like(w)}
    return w


def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      device: torch.device, cross_attn: bool = False
                      ) -> Dict:
    """One layer's seeded parameters (``init_params``'s distributions),
    with the cross-attention sublayer when ``cross_attn``."""
    dt = cfg.torch_dtype
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dt, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    lp = {"ln1": norm_params(cfg, d, device),
          "ln2": norm_params(cfg, d, device),
          "wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
          "wo": dense(hq, d)}
    if cfg.moe is not None:
        lp["moe"] = moe_lib.init_moe_params(gen, d, cfg.moe, dt, device)
    elif cfg.ffn == "swiglu":
        lp.update(w_gate=dense(d, ff), w_up=dense(d, ff),
                  w_down=dense(ff, d))
    else:
        lp.update(w_in=dense(d, ff), b_in=zeros(ff), w_out=dense(ff, d),
                  b_out=zeros(d))
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            lp[name] = zeros(n)
    if cross_attn:
        lp["ln_x"] = norm_params(cfg, d, device)
        lp["xattn"] = {"wq": dense(d, hq), "wk": dense(d, hkv),
                       "wv": dense(d, hkv), "wo": dense(hq, d)}
    return lp


def norm_specs(norm: str):
    """A norm's logical axes, in the port's layout: RMSNorm a plain
    tensor, LayerNorm ``{"w", "b"}``."""
    if norm == "ln":
        return {"w": ("embed",), "b": ("embed",)}
    return ("embed",)


def layer_param_specs(cfg: ModelConfig, cross_attn: bool = False) -> Dict:
    """One layer's logical axes, key for key ``init_layer_params``'s dict
    (JAX's ``layer_param_specs`` with attn and mlp flattened into the
    layer, as bridge.params_from_numpy lays them out)."""
    p = {"ln1": norm_specs(cfg.norm), "ln2": norm_specs(cfg.norm),
         "wq": ("embed", "heads"), "wk": ("embed", "heads"),
         "wv": ("embed", "heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        p.update(bq=("heads",), bk=("heads",), bv=("heads",))
    if cross_attn:
        p["ln_x"] = norm_specs(cfg.norm)
        p["xattn"] = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
                      "wv": ("embed", "heads"), "wo": ("heads", "embed")}
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_param_specs(cfg.moe)
    elif cfg.ffn == "swiglu":
        p.update(w_gate=("embed", "mlp"), w_up=("embed", "mlp"),
                 w_down=("mlp", "embed"))
    else:
        p.update(w_in=("embed", "mlp"), b_in=("mlp",),
                 w_out=("mlp", "embed"), b_out=("embed",))
    return p


def param_specs(cfg: ModelConfig, cross_attn: bool = False) -> Dict:
    """The logical axes of every parameter, a tree that zips with
    ``init_params``'s: each layer's dict in the ``layers`` list (the
    port's per-layer tensors have no ``layers`` dim)."""
    return {"embed": ("vocab", "embed"),
            "layers": [layer_param_specs(cfg, cross_attn)
                       for _ in range(cfg.n_layers)],
            "final_norm": norm_specs(cfg.norm),
            "lm_head": ("embed", "vocab")}


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                cross_attn: bool = False) -> Dict:
    """Seeded parameters with the JAX package's distributions (normal
    weights with std sqrt(2 / (d_in + d_out)), embeddings with std 0.02,
    unit norms, zero biases; models/moe.init_moe_params for the experts),
    each layer with a cross-attention sublayer when ``cross_attn``.
    The draws are torch's, not JAX's: for parity tests convert the JAX
    parameters with ``bridge``.  The LM head is stored with 16-byte rows
    for the fused head's bf16 route (kernels/fused_head_sampling.pad_head)."""
    check_supported(cfg)
    dev = device_lib.resolve(device)
    gen = layers.seeded_generator(dev, seed)
    d = cfg.d_model
    stack = [init_layer_params(gen, cfg, dev, cross_attn)
             for _ in range(cfg.n_layers)]
    return {"embed": layers.embed_init(gen, cfg.vocab, d, cfg.torch_dtype,
                                       dev),
            "layers": stack, "final_norm": norm_params(cfg, d, dev),
            "lm_head": fused_head_sampling.pad_head(layers.dense_init(
                gen, d, cfg.vocab, cfg.torch_dtype, dev))}


def init_cache(cfg: ModelConfig, batch: int, s_tot: int,
               device: Union[str, torch.device] = "cuda",
               act_len: Optional[int] = None) -> Dict:
    """Full-length KV buffers (n_layers, batch, s_tot, Hkv, D), zeroed, and
    the stacked BAOS calibration (n_layers, batch, 1, Hkv, D) f32: zero
    centers, unit scales.  ``act_len`` adds JAX's SPLIT layout:
    ``k_act``/``v_act`` (n_layers, batch, act_len, Hkv, D), the active
    block's smoothed but unquantized K/V, which a refine step writes in
    place of the full buffer (the paper's "active block stays in SRAM";
    see ``cache_attention``).  ``device`` comes before ``act_len`` here,
    as callers pass it by position."""
    dev = device_lib.resolve(device)
    shape = (cfg.n_layers, batch, s_tot, cfg.n_kv_heads, cfg.d_head)
    cal = (cfg.n_layers, batch, 1, cfg.n_kv_heads, cfg.d_head)

    def f32(fill):
        return torch.full(cal, fill, dtype=torch.float32, device=dev)

    cache = {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
             "k_center": f32(0.0), "k_scale": f32(1.0),
             "v_center": f32(0.0), "v_scale": f32(1.0)}
    if act_len is not None:
        act = (cfg.n_layers, batch, act_len, cfg.n_kv_heads, cfg.d_head)
        cache["k_act"] = torch.zeros(act, dtype=cfg.torch_dtype, device=dev)
        cache["v_act"] = torch.zeros(act, dtype=cfg.torch_dtype, device=dev)
    return cache


def cache_specs(cfg: ModelConfig, act_len: Optional[int] = None) -> Dict:
    """The logical axes of each cache leaf, JAX's ``cache_specs`` (the
    names launch/sharding's rules read)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    cal = ("layers", "batch", None, "kv_heads", "head_dim")
    spec = {"k": kv, "v": kv, "k_center": cal, "k_scale": cal,
            "v_center": cal, "v_scale": cal}
    if act_len is not None:
        act = ("layers", "batch", None, "kv_heads", "head_dim")
        spec["k_act"] = act
        spec["v_act"] = act
    return spec


def embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Token embeddings x embed_scale, in the activation dtype (under a
    vocab-sharded embedding, models/tp.embed's exact sum over
    ``model``)."""
    return (tp_lib.embed(params["embed"], tokens, cfg.vocab) *
            cfg.embed_scale).to(cfg.torch_dtype)


def cache_len(cache: Dict) -> int:
    """The KV cache's sequence length: ``cache["k"]``'s, times |model| for
    a context-parallel cache (models/tp.Parallel.cache_seq)."""
    s_tot = cache["k"].shape[2]
    ctx = tp_lib.current()
    if ctx is not None and ctx.cache_seq and tp_lib.model_axis():
        s_tot *= ctx.model.size
    return s_tot


def attn_layout(ap: Dict, cfg: ModelConfig) -> Tuple[bool, bool]:
    """(gather, part) of an attention sublayer's projections ``ap``
    (``wq wk wv wo``) under the tensor-parallel body (models/tp.py):
    ``gather`` when q, k and v do not all shard on whole heads (then each
    is gathered over ``model`` and attention runs on every head), ``part``
    when ``wo``'s rows are sharded (each rank then feeds it its columns
    of the attention output).  (False, True) without one."""
    axis = tp_lib.model_axis()
    if axis is None:
        return False, True
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    local = (cfg.n_kv_heads % axis.size == 0
             and ap["wq"].shape[1] != hq and ap["wk"].shape[1] != hkv
             and ap["wv"].shape[1] != hkv)
    return not local, ap["wo"].shape[0] != hq


def qkv(h: torch.Tensor, lp: Dict, cfg: ModelConfig,
        positions: torch.Tensor, quant=None, layout=(False, True)):
    """A layer's q (B, S, Hq, D) and k, v (B, S, Hkv, D) from its normed
    input, RoPE at ``positions``; under the tensor-parallel body this
    rank's heads, or every head when ``layout`` (``attn_layout``) says to
    gather."""
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gather, part = layout
    hin = tp_lib.copy_in(h)
    q, k, v = (tp_lib.col(h, lp[w], n * D, quant, lp.get(b), gather=gather,
                          part=part, hin=hin).reshape(B, S, -1, D)
               for w, b, n in (("wq", "bq", Hq), ("wk", "bk", Hkv),
                               ("wv", "bv", Hkv)))
    if cfg.rope_theta > 0:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(attn: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig,
             quant=None, layout=(False, True)) -> torch.Tensor:
    """The output projection of attention's (B, S, H, D) result: a
    row-parallel product under the tensor-parallel body, fed this rank's
    columns when every head ran on every rank."""
    B, S = attn.shape[:2]
    a = attn.reshape(B, S, -1)
    full = cfg.n_heads * cfg.d_head
    axis = tp_lib.model_axis()
    if axis is not None and layout[0] and layout[1]:
        r0, r1 = tp_lib.shard_range(full, wo.shape[0], axis)
        a = a[..., r0:r1]
    return tp_lib.row(a, wo, full, quant)


def ffn(h: torch.Tensor, lp: Dict, cfg: ModelConfig, quant=None
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's FFN on its normed input -> (out, aux): SwiGLU or the GELU
    MLP with biases (``jax.nn.gelu``'s tanh form between two biased
    products), aux None; or for an MoE layer models/moe.moe_ffn and its
    load-balance aux loss (an f32 scalar), which ``forward`` sums over
    the layers and returns with ``return_aux`` (the training loss,
    core/diffusion.masked_diffusion_loss)."""
    if cfg.moe is not None:
        return moe_lib.moe_ffn(h, lp["moe"], cfg.moe, quant)
    ff, hin = cfg.d_ff, tp_lib.copy_in(h)
    if cfg.ffn == "gelu":
        return tp_lib.row(layers.gelu(tp_lib.col(h, lp["w_in"], ff, quant,
                                                 lp["b_in"], hin=hin)),
                          lp["w_out"], ff, quant, lp["b_out"]), None
    return tp_lib.row(layers.swiglu(
        tp_lib.col(h, lp["w_gate"], ff, quant, hin=hin),
        tp_lib.col(h, lp["w_up"], ff, quant, hin=hin)),
        lp["w_down"], ff, quant), None


def cross_attention(x: torch.Tensor, lp: Dict, ck: torch.Tensor,
                    cv: torch.Tensor, cfg: ModelConfig, quant=None
                    ) -> torch.Tensor:
    """The cross-attention sublayer's residual branch: ``ln_x``, the query
    (no RoPE, no bias), bidirectional attention over every encoder frame
    of ck/cv (B, S_enc, Hkv, D) with no mask and f32 scores whatever
    ``cfg.score_dtype`` says (as in JAX), the output projection."""
    B, S, _ = x.shape
    Hq, D = cfg.n_heads, cfg.d_head
    ap = lp["xattn"]
    layout = attn_layout(ap, cfg)
    hx = apply_norm(x, lp["ln_x"], cfg)
    q = tp_lib.col(hx, ap["wq"], Hq * D, quant, gather=layout[0],
                   part=layout[1]).reshape(B, S, -1, D)
    out = layers.attention(q, ck, cv)
    return out_proj(out, ap["wo"], cfg, quant, layout)


def cache_attention(q, k, v, lcache: Dict, seg_start: SegStart, kv_valid,
                    cfg: ModelConfig, baos_cfg: baos_lib.BAOSConfig,
                    calibrate: bool, calib_mask,
                    act_start: Optional[SegStart] = None,
                    causal: bool = False, score_dtype: str = "float32"):
    """The cached branch of an attention layer (this module's and
    models/rglru.py's): (re)calibrate or read the stored calibration,
    write the segment's K/V into the cache at ``seg_start`` (through the
    BAOS kernel when enabled), attend over the whole cache.  The
    calibration is computed only with BAOS on: nothing reads it otherwise
    (the JAX forward computes and stores it either way).  A window no
    shorter than the cache masks nothing (|q - k| < s_tot <= window) and
    is dropped.  A tensor ``seg_start`` scatters the segment (a graph's
    block start), and attention reads it from device memory as its query
    offset.  ``causal``: JAX's causal mode.  ``score_dtype``: the
    transformer's ``cfg.score_dtype`` (the hybrid's attention keeps f32
    scores, as JAX's does), in JAX's chunks of ``cfg.attn_chunk``.

    A context-parallel cache (models/tp.Parallel.cache_seq: this rank's
    sequence slice of K/V) is gathered over ``model`` first; the step
    runs on the whole, and the rank keeps its slice of what was written.

    The split layout (``lcache`` holds ``k_act``/``v_act``, JAX's
    ``transformer._layer`` split branch): a refine step smooths its K/V
    with the stored calibration (no MX quantization) into the active
    buffer and leaves the full buffer as it is; attention spans the full
    buffer, without its stale copy of the block (``kv_valid & ~in_act``),
    and the active buffer, in one softmax (flash_bidir's route B).  A warm
    step writes the full buffer as always, then refreshes the active
    buffer from the rows just written at ``act_start`` (the block start;
    default ``seg_start``).

    Under autograd (grad mode on and q, k or v requiring grad: JAX's
    jax.grad through its forward with a cache) the step attends over
    differentiable values, as JAX's functional update does: the fresh
    calibration, the cache with the segment's rows scattered in out of
    place (``torch.slice_scatter`` / ``index_copy``), the split refine's
    active buffer as computed; the cache itself still receives the same
    values, detached, so the returned cache is the step's.  With grad off
    the writes are in place and capture-safe, as always."""
    ctx = tp_lib.current()
    if ctx is not None and ctx.cache_seq and tp_lib.model_axis() is not None:
        return _context_parallel(q, k, v, lcache, seg_start, kv_valid, cfg,
                                 baos_cfg, calibrate, calib_mask, act_start,
                                 ctx, causal, score_dtype)
    S = k.shape[1]
    window = cfg.window
    if window is not None and window >= lcache["k"].shape[1]:
        window = None
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    calib = None
    if baos_cfg.enabled:
        if calibrate:
            new = baos_lib.calibrate(k, v, baos_cfg, calib_mask)
            for name, t in zip(baos_lib.BAOSCalib._fields, new):
                lcache[name].copy_(t.detach())
        calib = new if calibrate and grad else baos_lib.BAOSCalib(
            *(lcache[name] for name in baos_lib.BAOSCalib._fields))
    on_device = isinstance(seg_start, torch.Tensor)
    if on_device:
        idx = start_of(seg_start) + torch.arange(S, device=k.device)
    if "k_act" in lcache and not calibrate:
        return _split_refine(q, k, v, lcache, seg_start, kv_valid, window,
                             calib, causal, score_dtype, cfg.attn_chunk,
                             grad)
    kv = {}
    for name, x in (("k", k), ("v", v)):
        center, scale = ((None, None) if calib is None else
                         (getattr(calib, f"{name}_center"),
                          getattr(calib, f"{name}_scale")))
        if calib is not None and (grad or on_device):
            x = baos_lib.smooth_quantize(x, center, scale, baos_cfg)
        if grad:
            kv[name] = (lcache[name].index_copy(1, idx, x) if on_device else
                        torch.slice_scatter(lcache[name], x, 1, seg_start,
                                            seg_start + S))
            lcache[name].copy_(kv[name].detach())
        elif on_device:
            lcache[name].index_copy_(1, idx, x)
        elif calib is None:
            lcache[name][:, seg_start:seg_start + S].copy_(x)
        else:
            baos_lib.smooth_quantize(
                x, center, scale, baos_cfg,
                out=lcache[name][:, seg_start:seg_start + S])
    if "k_act" in lcache:
        # the warm step refreshes the active buffer from the just-written
        # (smoothed, with BAOS quantized) rows at the block start
        start = seg_start if act_start is None else act_start
        L_act = lcache["k_act"].shape[1]
        for name in ("k", "v"):
            lcache[f"{name}_act"].copy_(rows(lcache[name], start, L_act))
    # the query offset places the window and the causal mask
    return layers.attention(q, kv.get("k", lcache["k"]),
                            kv.get("v", lcache["v"]), kv_valid,
                            window=window, baos_calib=calib,
                            q_offset=seg_start, causal=causal,
                            score_dtype=score_dtype, kv_chunk=cfg.attn_chunk)


def _context_parallel(q, k, v, lcache: Dict, seg_start, kv_valid, cfg,
                      baos_cfg, calibrate, calib_mask, act_start, ctx,
                      causal=False, score_dtype="float32"):
    """``cache_attention`` over a context-parallel cache: the layer's K/V
    gathered along the sequence over ``model``, the step on the whole
    (the calibration and the split cache's active buffer are replicated),
    then this rank's slice of the written K/V stored back."""
    axis = ctx.model
    whole = dict(lcache)
    for name in ("k", "v"):
        whole[name] = mesh_lib.all_gather(lcache[name], 1, axis)
    with tp_lib.use(dataclasses.replace(ctx, cache_seq=False)):
        out = cache_attention(q, k, v, whole, seg_start, kv_valid, cfg,
                              baos_cfg, calibrate, calib_mask, act_start,
                              causal, score_dtype)
    if calibrate or "k_act" not in lcache:     # the full buffer written
        s_loc = lcache["k"].shape[1]
        r0 = axis.index * s_loc
        for name in ("k", "v"):
            lcache[name].copy_(whole[name][:, r0:r0 + s_loc])
    return out


def _split_refine(q, k, v, lcache: Dict, seg_start: SegStart, kv_valid,
                  window, calib, causal=False, score_dtype="float32",
                  kv_chunk=flash_bidir.KV_CHUNK, grad: bool = False):
    """The split layout's refine (``cache_attention``): the segment, which
    must be the active block, smoothed into ``k_act``/``v_act``; attention
    over the full buffer less its copy of the block, and the buffer (with
    ``grad``, the buffer as computed, differentiable; the cache gets its
    values)."""
    B, S = k.shape[:2]
    L_act = lcache["k_act"].shape[1]
    if S != L_act:
        raise ValueError(
            f"a split-cache refine writes its {S}-long segment into an "
            f"active buffer of {L_act}: the segment must be the block "
            f"(cache mode dual)")
    act = {}
    for name, x, center, scale in (("k", k, "k_center", "k_scale"),
                                   ("v", v, "v_center", "v_scale")):
        if calib is not None:
            x = (x.to(torch.float32) - lcache[center]) / lcache[scale]
        if grad:
            act[name] = x.to(lcache[f"{name}_act"].dtype).contiguous()
            x = act[name].detach()
        lcache[f"{name}_act"].copy_(x)
    s_tot = lcache["k"].shape[1]
    pos = torch.arange(s_tot, device=k.device)
    start = start_of(seg_start)
    valid = ~((pos >= start) & (pos < start + L_act))
    valid = valid[None].expand(B, s_tot) if kv_valid is None \
        else kv_valid.to(torch.bool) & valid[None]
    return layers.attention(q, lcache["k"], lcache["v"],
                            valid.contiguous(), window=window,
                            baos_calib=calib, q_offset=seg_start,
                            extra_kv=(act.get("k", lcache["k_act"]),
                                      act.get("v", lcache["v_act"]), None),
                            causal=causal, score_dtype=score_dtype,
                            kv_chunk=kv_chunk)


def forward(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, seg_start: SegStart = 0,
            kv_valid: Optional[torch.Tensor] = None,
            baos_cfg: Optional[baos_lib.BAOSConfig] = None,
            calibrate: bool = False,
            calib_mask: Optional[torch.Tensor] = None,
            logits_slice: Optional[Tuple[int, int]] = None,
            head_mode: str = "logits", quant=None,
            cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            return_aux: bool = False, attn_mode: Optional[str] = None):
    """tokens (B, S) -- or their ``embeds`` (B, S, d) -- at positions
    seg_start + r -> (logits (B, S', V), or with ``head_mode='hidden'``
    the final-norm hidden states (B, S', d); the cache), S' = S or the
    ``logits_slice`` (start, length).  With ``cache``: ``baos_cfg`` (off
    by default), ``calibrate`` (recompute the calibration from this
    segment's K/V, restricted to ``calib_mask`` (B, S) when given) and
    ``kv_valid`` (B, s_tot).  ``quant``: a ``layers.QuantPolicy`` at every
    GEMM boundary (None: none).  ``cross_kv``: the stacked encoder K/V
    (n_layers, B, S_enc, Hkv, D) each, for the cross-attention
    sublayers.  ``return_aux``: return (logits, cache, aux), aux the MoE
    layers' load-balance losses summed over the layers (f32; 0 for a
    dense model), as JAX's forward returns it.  ``attn_mode`` overrides
    the config's for every self-attention, as in JAX.  With grad on,
    ``cfg.remat`` "full" or "dots" runs each layer through
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of its layer):
    "full" keeps only the layer's input and recomputes the rest in the
    backward, "dots" also keeps the matrix products' outputs
    (``_dots_policy``).  Under the tensor-parallel body the recompute
    reruns the layer's collectives, in the same order on every rank, and
    re-enters this call's ``tp.use`` context: it runs in the backward's
    thread (autograd's device worker for CUDA tensors), which does not
    see the caller's."""
    check_supported(cfg)
    mode = attn_mode or cfg.attn_mode
    check_attn_mode(mode)
    causal = mode == "causal"
    if head_mode not in ("logits", "hidden"):
        raise ValueError(f"unknown head_mode {head_mode!r}")
    baos_cfg = baos_cfg or baos_lib.BAOSConfig(enabled=False)
    B, S = (tokens if embeds is None else embeds).shape[:2]
    if cache is not None:
        s_tot = cache_len(cache)
        if not isinstance(seg_start, torch.Tensor) and \
                not 0 <= seg_start <= s_tot - S:
            raise ValueError(f"segment [{seg_start}, {seg_start + S}) does "
                             f"not fit a {s_tot}-long cache")
    x = embed(params, cfg, tokens) if embeds is None \
        else embeds.to(cfg.torch_dtype)
    positions = start_of(seg_start) + torch.arange(S, device=x.device)

    def layer(x, i, lp):
        h = apply_norm(x, lp["ln1"], cfg)
        layout = attn_layout(lp, cfg)
        q, k, v = qkv(h, lp, cfg, positions, quant, layout)
        if cache is None:
            attn = layers.attention(q, k, v, window=cfg.window,
                                    causal=causal,
                                    score_dtype=cfg.score_dtype,
                                    kv_chunk=cfg.attn_chunk)
        else:
            lcache = {name: t[i] for name, t in cache.items()}
            attn = cache_attention(
                q, k, v, lcache, seg_start, kv_valid, cfg, baos_cfg,
                calibrate, calib_mask,
                act_start=(logits_slice[0] if calibrate and logits_slice
                           else None), causal=causal,
                score_dtype=cfg.score_dtype)
        x = x + out_proj(attn, lp["wo"], cfg, quant, layout) * \
            cfg.residual_scale
        if cross_kv is not None:
            x = x + cross_attention(x, lp, cross_kv[0][i], cross_kv[1][i],
                                    cfg, quant) * cfg.residual_scale
        h2 = apply_norm(x, lp["ln2"], cfg)
        ff, aux_l = ffn(h2, lp, cfg, quant)
        return x + ff * cfg.residual_scale, aux_l

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    tp_ctx = tp_lib.current()

    def recomputable(x, i, lp):
        with tp_lib.use(tp_ctx):
            return layer(x, i, lp)

    aux = None
    for i, lp in enumerate(params["layers"]):
        if remat:
            x, aux_l = checkpoint.checkpoint(
                recomputable, x, i, lp, use_reentrant=False,
                context_fn=(_save_dots if cfg.remat == "dots"
                            else checkpoint.noop_context_fn))
        else:
            x, aux_l = layer(x, i, lp)
        if return_aux and aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
    x = apply_norm(x, params["final_norm"], cfg)
    if logits_slice is not None:
        x = rows(x, *logits_slice)
    out = x if head_mode == "hidden" else head_logits(x, params, cfg, quant)
    if not return_aux:
        return out, cache
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return out, cache, aux


# the products whose outputs remat="dots" saves (JAX's checkpoint_dots)
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save a matrix product's output, recompute every other op.  On the
    CPU and meta this saves the products inside attention's plain version
    too, as JAX saves its attention einsums; on the card attention is a
    kernel, not a product, and is recomputed (ROADMAP.md)."""
    if op in DOTS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def head_logits(x: torch.Tensor, params: Dict, cfg: ModelConfig, quant=None
                ) -> torch.Tensor:
    """The LM head product (B, S', V), times ``logit_scale`` (skipped at
    1.0, which leaves every value as it is); under the tensor-parallel
    body with a vocab-sharded head, this rank's (B, S', V / |model|)
    columns."""
    logits = tp_lib.col(x, params["lm_head"], cfg.vocab, quant)
    return logits if cfg.logit_scale == 1.0 else logits * cfg.logit_scale


def rows(x: torch.Tensor, start: SegStart, length: int) -> torch.Tensor:
    """x[:, start:start + length] for an int ``start``; for a one-element
    device tensor the same rows through ``index_select`` (what a captured
    graph reads from memory)."""
    if isinstance(start, torch.Tensor):
        return x.index_select(1, start_of(start) + torch.arange(
            length, device=x.device))
    return x[:, start:start + length]


def start_of(seg_start: SegStart):
    """A segment start as an int, or a device tensor's element 0 as an
    int64 scalar tensor (flash_bidir.offset_start)."""
    return flash_bidir.offset_start(seg_start)
