"""Parameters and caches of the JAX package (every family),
as numpy arrays, into the port's layout, and back.

The tests build parameters with the JAX ``init_params``, turn them into
numpy (``jax.tree.map(np.asarray, params)``) and hand them here, so both
packages run on identical weights; ``cache_from_numpy`` does the same for
a KV cache, so a step can start from the very cache state JAX produced,
and ``load_paged_pool`` for a paged pool's stores and block tables.
``params_to_numpy`` is the inverse of ``params_from_numpy`` (a tree of
the port's layout, parameters or their gradients, as JAX's stacked numpy
tree), and ``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry
AdamW's state, so the tests hold gradients and train steps to JAX's.
This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import fused_head_sampling
from repro_torch.models.config import ModelConfig


# leaves JAX keeps in f32 whatever the model's dtype
F32_LEAVES = ("A_log", "D", "dt_bias", "lam")


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX params (stacked on axis 0) -> the port's params (stacks split
    into lists of per-layer dicts), in ``cfg.dtype`` (``F32_LEAVES`` in
    f32) on ``device``; bf16 arrays pass through f32, exactly.  RMSNorms
    (JAX's ``{"w": ...}``) become plain tensors; LayerNorms stay
    ``{"w", "b"}``.

    * dense / moe / vlm: ``layers`` a list of dicts; a layer's ``attn``
      and a dense layer's ``mlp`` are flattened into it (``wq``...,
      ``w_gate``, ``w_up``, ``w_down``, or ``w_in``, ``b_in``,
      ``w_out``, ``b_out``); an MoE layer keeps JAX's ``moe`` subtree
      (the router (d, E), the stacked experts (E, d, F) / (E, F, d) and
      any ``shared`` experts with their ``gate_proj``).
    * audio: the decoder as above, each layer keeping ``ln_x`` and its
      ``xattn`` subtree, plus ``encoder``: ``layers`` (a list, as
      above), ``pos_embed`` and ``final_norm``.
    * ssm: ``layers`` a list of Mamba2 layer dicts (models/ssm.py).
    * hybrid: ``triples`` a list of ``{"rec1", "rec2", "attn"}`` and
      ``tail`` a list of 2 rec sub-layers (models/rglru.py).

    The LM head is stored with 16-byte rows for the fused head's bf16
    route (kernels/fused_head_sampling.pad_head).  ``dtype`` puts every
    leaf in that dtype instead (f32 for AdamW's moments)."""
    dev = device_lib.resolve(device)

    def t(a, name: str = "") -> torch.Tensor:
        dt = dtype or (torch.float32 if name in F32_LEAVES
                       else cfg.torch_dtype)
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def item(sub: Mapping, i: int) -> Dict:
        """Item i of a stacked subtree, norms as plain tensors."""
        return {k: (t(v["w"][i]) if isinstance(v, Mapping) and set(v) == {"w"}
                    else item(v, i) if isinstance(v, Mapping)
                    else t(v[i], k))
                for k, v in sub.items()}

    def norm(p: Mapping):
        return t(p["w"]) if set(p) == {"w"} else {k: t(v) for k, v in
                                                  p.items()}

    def stack(sub: Mapping, n: int):
        """A stacked transformer layer tree -> a list of n layer dicts,
        ``attn`` and ``mlp`` flattened into each."""
        out = []
        for i in range(n):
            lp = item(sub, i)
            lp.update(lp.pop("attn"))
            lp.update(lp.pop("mlp", {}))
            out.append(lp)
        return out

    out = {"embed": t(tree["embed"]),
           "final_norm": norm(tree["final_norm"]),
           "lm_head": fused_head_sampling.pad_head(t(tree["lm_head"]))}
    if cfg.family == "ssm":
        out["layers"] = [item(tree["layers"], i) for i in range(cfg.n_layers)]
        return out
    if cfg.family == "hybrid":
        nt = cfg.n_layers // 3
        out["triples"] = [item(tree["triples"], i) for i in range(nt)]
        out["tail"] = [item(tree["tail"], i) for i in range(2)]
        return out
    out["layers"] = stack(tree["layers"], cfg.n_layers)
    if cfg.family == "audio":
        enc = tree["encoder"]
        out["encoder"] = {"layers": stack(enc["layers"],
                                          cfg.n_encoder_layers),
                          "pos_embed": t(enc["pos_embed"]),
                          "final_norm": norm(enc["final_norm"])}
    return out


# the keys of JAX's norm subtrees ({"w"} RMSNorms become plain tensors in
# the port; LayerNorms stay {"w", "b"}), and the leaves params_from_numpy
# flattens out of a stacked transformer layer's "attn" and "mlp"
NORM_KEYS = ("ln1", "ln2", "ln_x", "norm", "gate_norm", "final_norm")
ATTN_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
MLP_KEYS = ("w_gate", "w_up", "w_down", "w_in", "b_in", "w_out", "b_out")


def params_to_numpy(params: Mapping, cfg: ModelConfig) -> Dict:
    """The port's params (or a tree of their gradients) -> JAX's layout as
    f32 numpy arrays: per-layer lists stacked on axis 0, ``attn`` and
    ``mlp`` nested again, RMSNorms as ``{"w": ...}``, the LM head as
    (d, V) without its 16-byte padding."""
    def a(x) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).contiguous().numpy()

    def norm(x):
        return ({"w": a(x)} if isinstance(x, torch.Tensor)
                else {n: a(t) for n, t in x.items()})

    def jax_item(sub: Mapping) -> Dict:
        """One layer dict in JAX's nesting, not yet stacked."""
        return {k: norm(v) if k in NORM_KEYS
                else jax_item(v) if isinstance(v, Mapping) else a(v)
                for k, v in sub.items()}

    def unflat(lp: Mapping) -> Dict:
        """A stacked transformer layer's item: attn and mlp nested."""
        out = jax_item(lp)
        out["attn"] = {k: out.pop(k) for k in ATTN_KEYS if k in out}
        mlp = {k: out.pop(k) for k in MLP_KEYS if k in out}
        if mlp:
            out["mlp"] = mlp
        return out

    def stack(items):
        if isinstance(items[0], Mapping):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    out = {"embed": a(params["embed"]),
           "final_norm": norm(params["final_norm"]),
           "lm_head": a(params["lm_head"])}
    if cfg.family == "ssm":
        out["layers"] = stack([jax_item(lp) for lp in params["layers"]])
        return out
    if cfg.family == "hybrid":
        out["triples"] = stack([jax_item(t) for t in params["triples"]])
        out["tail"] = stack([jax_item(t) for t in params["tail"]])
        return out
    out["layers"] = stack([unflat(lp) for lp in params["layers"]])
    if cfg.family == "audio":
        enc = params["encoder"]
        out["encoder"] = {
            "layers": stack([unflat(lp) for lp in enc["layers"]]),
            "pos_embed": a(enc["pos_embed"]),
            "final_norm": norm(enc["final_norm"])}
    return out


def opt_state_from_numpy(state: Mapping, cfg: ModelConfig,
                         device: Union[str, torch.device] = "cuda") -> Dict:
    """JAX's AdamW state ({"m", "v"} stacked like its params, "step") ->
    optim/adamw's: f32 moments in the port's layout, step an int."""
    return {"m": params_from_numpy(state["m"], cfg, device, torch.float32),
            "v": params_from_numpy(state["v"], cfg, device, torch.float32),
            "step": int(np.asarray(state["step"]))}


def opt_state_to_numpy(state: Mapping, cfg: ModelConfig) -> Dict:
    """optim/adamw's state -> JAX's layout (step an int32 array)."""
    return {"m": params_to_numpy(state["m"], cfg),
            "v": params_to_numpy(state["v"], cfg),
            "step": np.asarray(state["step"], np.int32)}


# cache leaves JAX keeps in f32: the BAOS calibration and the recurrent
# states
F32_CACHE = ("k_center", "k_scale", "v_center", "v_scale", "state",
             "rec_state", "tail_state")


def cache_from_numpy(tree: Mapping, cfg: ModelConfig,
                     device: Union[str, torch.device] = "cuda") -> Dict:
    """A JAX cache, as numpy arrays -> the port's, on ``device``, each leaf
    in the dtype JAX's ``init_cache`` gives it (``F32_CACHE`` in f32, the
    rest in ``cfg.dtype``).  Dense / moe: k, v (n_layers, B, s_tot, Hkv,
    D) and the four calibration arrays (n_layers, B, 1, Hkv, D); ssm:
    ``state`` and ``conv``; hybrid: k, v and the calibration over the
    triples plus ``rec_state``, ``rec_conv``, ``tail_state`` and
    ``tail_conv``.  A split cache's ``k_act``/``v_act`` (n_layers, B,
    act_len, Hkv, D) carry over as they are, in ``cfg.dtype``
    (``cache_to_numpy`` takes them back)."""
    dev = device_lib.resolve(device)
    out = {}
    for name, a in tree.items():
        dt = torch.float32 if name in F32_CACHE else cfg.torch_dtype
        out[name] = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            device=dev, dtype=dt)
    return out


def cache_to_numpy(cache: Mapping) -> Dict:
    """The port's cache -> JAX's, as f32 numpy arrays per leaf (the split
    layout's ``k_act``/``v_act`` included); ``cache_from_numpy`` inverts
    it up to the leaves' dtypes."""
    return {name: t.detach().to("cpu", torch.float32).numpy()
            for name, t in cache.items()}


def load_paged_pool(pool, canvas_pages, canvas_table, kv_table,
                    cache: Optional[Mapping] = None) -> None:
    """A JAX ``PagedCachePool``'s device state, as numpy arrays (its
    ``canvas_pages``, ``canvas_table``, ``kv_table`` and, with a cache, its
    page-store ``cache``), written in place into the port's
    ``serving.cache_pool.PagedCachePool`` ``pool`` of the same geometry:
    the stores, the device tables and their host mirrors.  The host-side
    bookkeeping (free lists, radix tree) is not carried: both pools reach
    the same bookkeeping through the same calls."""
    pool.canvas_pages.copy_(torch.from_numpy(
        np.asarray(canvas_pages, np.int32)))
    pool._canvas_np[:] = np.asarray(canvas_table)
    pool._kv_np[:] = np.asarray(kv_table)
    pool.canvas_table.copy_(pool._canvas_host)
    pool.kv_table.copy_(pool._kv_host)
    if cache is not None:
        for name, t in cache.items():
            dt = pool.cache[name].dtype
            pool.cache[name].copy_(torch.from_numpy(
                np.asarray(t, dtype=np.float32)).to(dt))
