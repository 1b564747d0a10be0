"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The tests build parameters with the JAX ``init_params``, turn them into
numpy (``jax.tree.map(np.asarray, params)``) and hand them here, so both
packages run on identical weights.  This module imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models.config import ModelConfig


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda") -> Dict:
    """JAX dense-transformer params (``layers`` stacked on axis 0) ->
    the port's params (``layers`` a list of per-layer dicts), in
    ``cfg.dtype`` on ``device``.  bf16 arrays pass through f32, exactly."""
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
            "lm_head": t(tree["lm_head"])}
