"""Dense dLLM transformer, ported from src/repro/models/transformer.py.

Parameters are plain dicts: ``embed`` (V, d), ``layers`` (a list of
per-layer dicts ``ln1, ln2, wq, wk, wv, wo, [bq, bk, bv], w_gate, w_up,
w_down``), ``final_norm`` (d,) and ``lm_head`` (d, V) -- the JAX layout,
with the layer stack split into a list and not an ``nn.Linear`` (which
would store the head transposed).

``forward`` covers the two shapes of the serving tick: ``cache=None``
(full recompute; like the JAX forward it then attends over every position
and ignores ``kv_valid``) and the full warm cache, whose K/V it rewrites
in place for the whole sequence before attending with ``kv_valid``.  The
JAX forward returns a new cache instead; in place saves the copy, and a
warm tick never reads a cache entry it has not just written.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

ROADMAP = "ROADMAP.md, Queue 1"


def check_dense(cfg: ModelConfig) -> None:
    """Raise for model features this slice of the port lacks."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet ({ROADMAP}); "
            "the port runs dense transformers")
    if cfg.norm != "rms" or cfg.ffn != "swiglu" or cfg.attn_mode != "bidir":
        raise NotImplementedError(
            f"norm={cfg.norm!r}, ffn={cfg.ffn!r}, attn_mode="
            f"{cfg.attn_mode!r} are not ported yet ({ROADMAP}); the port "
            "runs rms / swiglu / bidir")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Seeded parameters with the JAX package's distributions (normal
    weights with std sqrt(2 / (d_in + d_out)), embeddings with std 0.02,
    unit norms, zero biases).  The draws are torch's, not JAX's: for
    parity tests convert the JAX parameters with ``bridge``."""
    check_dense(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dt, dev)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    stack = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": ones(d), "ln2": ones(d),
              "wq": dense(d, hq), "wk": dense(d, hkv), "wv": dense(d, hkv),
              "wo": dense(hq, d),
              "w_gate": dense(d, ff), "w_up": dense(d, ff),
              "w_down": dense(ff, d)}
        if cfg.qkv_bias:
            for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
                lp[name] = torch.zeros((n,), dtype=dt, device=dev)
        stack.append(lp)
    return {"embed": layers.embed_init(gen, cfg.vocab, d, dt, dev),
            "layers": stack, "final_norm": ones(d),
            "lm_head": dense(d, cfg.vocab)}


def init_cache(cfg: ModelConfig, batch: int, s_tot: int,
               device: Union[str, torch.device] = "cuda") -> Dict:
    """Full-length KV buffers (n_layers, batch, s_tot, Hkv, D), zeroed."""
    dev = device_lib.resolve(device)
    shape = (cfg.n_layers, batch, s_tot, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Optional[Dict] = None,
            kv_valid: Optional[torch.Tensor] = None,
            logits_slice: Optional[Tuple[int, int]] = None,
            head_mode: str = "logits", quant=None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) -> (logits (B, S', V), or with ``head_mode='hidden'``
    the final-norm hidden states (B, S', d); the cache), S' = S or the
    ``logits_slice`` (start, length).  ``quant`` (the JAX QuantPolicy at
    the GEMM boundaries) must be None or disabled."""
    check_dense(cfg)
    if quant is not None and getattr(quant, "enabled", True):
        raise NotImplementedError(
            f"MX fake-quant at the GEMM boundaries (QuantPolicy) is not "
            f"ported yet ({ROADMAP})")
    if head_mode not in ("logits", "hidden"):
        raise ValueError(f"unknown head_mode {head_mode!r}")
    B, S = tokens.shape
    if cache is not None and cache["k"].shape[2] != S:
        raise NotImplementedError(
            f"a {S}-token segment into a {cache['k'].shape[2]}-long cache "
            f"(cache modes dual/prefix) is not ported yet ({ROADMAP}); the "
            "warm tick rewrites the whole cache")
    x = (F.embedding(tokens, params["embed"]) * cfg.embed_scale
         ).to(cfg.torch_dtype)
    positions = torch.arange(S, device=x.device)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for i, lp in enumerate(params["layers"]):
        h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = layers.qdot(h, lp["wq"], lp.get("bq")).reshape(B, S, Hq, D)
        k = layers.qdot(h, lp["wk"], lp.get("bk")).reshape(B, S, Hkv, D)
        v = layers.qdot(h, lp["wv"], lp.get("bv")).reshape(B, S, Hkv, D)
        if cfg.rope_theta > 0:
            q = layers.rope(q, positions, cfg.rope_theta)
            k = layers.rope(k, positions, cfg.rope_theta)
        if cache is None:
            attn = layers.attention(q, k, v, window=cfg.window)
        else:
            cache["k"][i].copy_(k)
            cache["v"][i].copy_(v)
            attn = layers.attention(q, cache["k"][i], cache["v"][i],
                                    kv_valid, window=cfg.window)
        x = x + layers.qdot(attn.reshape(B, S, Hq * D), lp["wo"]) * \
            cfg.residual_scale
        h2 = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        ffn = layers.qdot(layers.swiglu(layers.qdot(h2, lp["w_gate"]),
                                        layers.qdot(h2, lp["w_up"])),
                          lp["w_down"])
        x = x + ffn * cfg.residual_scale
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_slice is not None:
        start, length = logits_slice
        x = x[:, start:start + length]
    if head_mode == "hidden":
        return x, cache
    return layers.qdot(x, params["lm_head"]) * cfg.logit_scale, cache
