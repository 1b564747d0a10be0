"""Parameters and caches of the JAX package (every family),
as numpy arrays, into the port's layout.

The tests build parameters with the JAX ``init_params``, turn them into
numpy (``jax.tree.map(np.asarray, params)``) and hand them here, so both
packages run on identical weights; ``cache_from_numpy`` does the same for
a KV cache, so a step can start from the very cache state JAX produced,
and ``load_paged_pool`` for a paged pool's stores and block tables.
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
                      device: Union[str, torch.device] = "cuda") -> Dict:
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
    route (kernels/fused_head_sampling.pad_head)."""
    dev = device_lib.resolve(device)

    def t(a, name: str = "") -> torch.Tensor:
        dt = torch.float32 if name in F32_LEAVES else cfg.torch_dtype
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
    ``tail_conv``."""
    if "k_act" in tree:
        raise NotImplementedError(
            "the split k_act/v_act cache layout is not ported yet "
            "(ROADMAP.md, Queue 1)")
    dev = device_lib.resolve(device)
    out = {}
    for name, a in tree.items():
        dt = torch.float32 if name in F32_CACHE else cfg.torch_dtype
        out[name] = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            device=dev, dtype=dt)
    return out


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
