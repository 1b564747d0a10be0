"""Parameters and KV caches of the JAX package, as numpy arrays, into the
port's layout.

The tests build parameters with the JAX ``init_params``, turn them into
numpy (``jax.tree.map(np.asarray, params)``) and hand them here, so both
packages run on identical weights; ``cache_from_numpy`` does the same for
a KV cache, so a step can start from the very cache state JAX produced.
This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import fused_head_sampling
from repro_torch.models.config import ModelConfig


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda") -> Dict:
    """JAX dense-transformer params (``layers`` stacked on axis 0) ->
    the port's params (``layers`` a list of per-layer dicts), in
    ``cfg.dtype`` on ``device``.  bf16 arrays pass through f32, exactly.
    The LM head is stored with 16-byte rows for the fused head's bf16 route
    (kernels/fused_head_sampling.pad_head)."""
    dev = device_lib.resolve(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            device=dev, dtype=cfg.torch_dtype)

    stack = tree["layers"]
    attn, mlp = stack["attn"], stack["mlp"]
    layers = []
    for i in range(cfg.n_layers):
        lp = {"ln1": t(stack["ln1"]["w"][i]), "ln2": t(stack["ln2"]["w"][i]),
              "wq": t(attn["wq"][i]), "wk": t(attn["wk"][i]),
              "wv": t(attn["wv"][i]), "wo": t(attn["wo"][i]),
              "w_gate": t(mlp["w_gate"][i]), "w_up": t(mlp["w_up"][i]),
              "w_down": t(mlp["w_down"][i])}
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                lp[name] = t(attn[name][i])
        layers.append(lp)
    return {"embed": t(tree["embed"]), "layers": layers,
            "final_norm": t(tree["final_norm"]["w"]),
            "lm_head": fused_head_sampling.pad_head(t(tree["lm_head"]))}


CACHE_KEYS = ("k", "v", "k_center", "k_scale", "v_center", "v_scale")


def cache_from_numpy(tree: Mapping, cfg: ModelConfig,
                     device: Union[str, torch.device] = "cuda") -> Dict:
    """A JAX dense-transformer KV cache (``init_cache`` layout: k, v
    (n_layers, B, s_tot, Hkv, D) and the four BAOS calibration arrays
    (n_layers, B, 1, Hkv, D)) -> the port's cache: k, v in ``cfg.dtype``,
    the calibration in f32, on ``device``."""
    if "k_act" in tree:
        raise NotImplementedError(
            "the split k_act/v_act cache layout is not ported yet "
            "(ROADMAP.md, Queue 1)")
    dev = device_lib.resolve(device)
    out = {}
    for name in CACHE_KEYS:
        dt = cfg.torch_dtype if name in ("k", "v") else torch.float32
        out[name] = torch.from_numpy(
            np.asarray(tree[name], dtype=np.float32)).to(device=dev, dtype=dt)
    return out
