"""Mixture-of-Experts FFN with sort-based capacity dispatch, ported from
src/repro/models/moe.py.

Routing is JAX's: f32 router logits, softmax, top-k (renormalised when
``norm_topk_prob``) and the Switch load-balance aux.  Dispatch is the
sort-based formulation: each group's (token, expert) pairs sorted stably
by expert id, the first C = ceil(T·K / E) · capacity_factor pairs of each
expert kept and the rest dropped (their routed contribution is zero).
Groups are the batch rows when ``group_dispatch`` and B > 1 (JAX vmaps one
group per row), else one group of all B·S tokens.

All groups run in one batched pass with static shapes and no host sync,
so a CUDA graph can capture it: a stable argsort of the (G, S·K) expert
ids, a batched searchsorted for each expert's first pair, a sentinel slot
E·C per group that takes every dropped pair (its content is thrown away),
a gather into (G, E, C, d), the expert products as one batched GEMM over
E with each expert's G·C rows, and the combine through the inverse
permutation, times the top-k weights in x's dtype, summed over K.

The expert products are plain GEMMs that JAX computes outside any Pallas
kernel, so they stay on cuBLAS, as the dense FFN's do.  As in JAX, every
expert's weights are read each call, including experts that got no token.
Capacity is shared by every token of a group, the engine's idle-slot and
padding positions included, as in JAX.  ``torch.topk`` may order equal
router probabilities otherwise than ``lax.top_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import mx
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Field for field the JAX MoEConfig."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0              # total shared-expert hidden size
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True       # qwen-style renormalization
    router_aux_weight: float = 0.001
    # GShard-style grouped dispatch: sort and capacity per batch row
    group_dispatch: bool = True


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
                    dtype: torch.dtype, device: torch.device) -> Dict:
    """Seeded MoE parameters with the JAX package's distributions: the
    router (d, E), stacked experts w_gate/w_up (E, d, F) and w_down
    (E, F, d) with std sqrt(2 / (d + F)), and with shared experts their
    dense (d, Fs)/(Fs, d) matrices and gate_proj (d, 1)."""
    E, Fe = cfg.num_experts, cfg.d_ff_expert
    std = (2.0 / (d_model + Fe)) ** 0.5

    def stack(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype, device)

    p = {"router": dense(d_model, E), "w_gate": stack(E, d_model, Fe),
         "w_up": stack(E, d_model, Fe), "w_down": stack(E, Fe, d_model)}
    if cfg.num_shared_experts > 0:
        Fs = cfg.d_ff_shared or cfg.num_shared_experts * Fe
        p["shared"] = {"w_gate": dense(d_model, Fs),
                       "w_up": dense(d_model, Fs),
                       "w_down": dense(Fs, d_model),
                       "gate_proj": dense(d_model, 1)}
    return p


def moe_param_specs(cfg: MoEConfig) -> Dict:
    """The logical axes of ``init_moe_params``'s tree, JAX's
    ``moe_param_specs``."""
    p = {"router": ("embed", None),
         "w_gate": ("experts", "embed", "mlp"),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if cfg.num_shared_experts > 0:
        p["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed"),
                       "gate_proj": ("embed", None)}
    return p


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Per-expert capacity C of a group of ``tokens`` tokens, JAX's rule."""
    return max(1, int(-(-tokens * cfg.top_k // cfg.num_experts)
                      * cfg.capacity_factor))


def route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat (..., T, d) -> (top-k weights (..., T, K) f32, top-k experts
    (..., T, K), aux loss (...)): one group per leading index."""
    logits = torch.matmul(x_flat.to(torch.float32),
                          router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_e = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        topk_w = topk_w / torch.sum(topk_w, dim=-1, keepdim=True)
    # Switch-style load-balance aux: E * sum_e fraction_e * prob_e
    E = cfg.num_experts
    assign = F.one_hot(topk_e[..., 0], E).to(torch.float32)
    frac = torch.mean(assign, dim=-2)
    pmean = torch.mean(probs, dim=-2)
    aux = E * torch.sum(frac * pmean, dim=-1)
    return topk_w, topk_e, aux


def dispatch_slots(topk_e: torch.Tensor, cfg: MoEConfig, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """topk_e (G, T, K) -> (order (G, P), slot (G, P)), P = T·K: ``order``
    the stable sort of each group's flat expert ids, ``slot`` the buffer
    slot e·C + (rank within expert e) of each sorted pair, or the sentinel
    E·C where the expert's C slots are full (a dropped pair)."""
    G, T, K = topk_e.shape
    E, P = cfg.num_experts, T * K
    flat_e = topk_e.reshape(G, P)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)                  # sorted expert ids
    experts = torch.arange(E, device=se.device, dtype=se.dtype)
    starts = torch.searchsorted(se, experts.expand(G, E).contiguous(),
                                side="left")             # first pair of e
    pos = torch.arange(P, device=se.device) - torch.gather(starts, 1, se)
    slot = torch.where(pos < C, se * C + pos, E * C)
    return order, slot


def expert_weights(w: torch.Tensor, quant) -> torch.Tensor:
    """A stacked (E, K, N) expert weight under ``quant``: JAX vmaps
    ``quant.weights`` over E, so the MX blocks run along each matrix's
    contraction axis, axis 1 of the stack."""
    if quant is None or not quant.enabled:
        return w
    return mx.mx_fake_quant(w, quant.weight_fmt, axis=1)


def moe_ffn(x: torch.Tensor, params: Dict, cfg: MoEConfig, quant=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss, an f32 scalar: the mean of
    the groups')."""
    B, S, d = x.shape
    G, T = (B, S) if cfg.group_dispatch and B > 1 else (1, B * S)
    K, E = cfg.top_k, cfg.num_experts
    C = capacity(T, cfg)
    xg = x.reshape(G, T, d)
    topk_w, topk_e, aux = route(xg, params["router"], cfg)
    order, slot = dispatch_slots(topk_e, cfg, C)
    dev, dt = x.device, x.dtype

    # gather each slot's token: rows of x with a zero row T per group, the
    # source of empty slots; dropped pairs all write the sentinel slot E·C
    src = torch.full((G, E * C + 1), T, dtype=torch.int64, device=dev)
    src.scatter_(1, slot, order // K)
    x_pad = torch.cat([xg, torch.zeros((G, 1, d), dtype=dt, device=dev)], 1)
    rows = src[:, :E * C] + (T + 1) * torch.arange(G, device=dev)[:, None]
    expert_in = x_pad.reshape(G * (T + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, E, C, d)

    # expert SwiGLU: one batched GEMM over E, each expert's G·C rows
    xe = expert_in.transpose(0, 1).reshape(E, G * C, d)
    wg, wu, wd = (expert_weights(params[n], quant).to(dt)
                  for n in ("w_gate", "w_up", "w_down"))
    if quant is not None and quant.enabled:
        xe = quant.acts(xe)
    h = layers.swiglu(torch.bmm(xe, wg), torch.bmm(xe, wu))
    expert_out = torch.bmm(h, wd).reshape(E, G, C, d).transpose(0, 1)

    # combine: each pair's slot in its original (token, k) order (the
    # inverse permutation of the sort), the sentinel reading zeros
    out_pad = torch.cat([expert_out.reshape(G, E * C, d),
                         torch.zeros((G, 1, d), dtype=dt, device=dev)], 1)
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    rows = pair_slot + (E * C + 1) * torch.arange(G, device=dev)[:, None]
    pair = out_pad.reshape(G * (E * C + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, T, K, d)
    out = torch.sum(pair * topk_w[..., None].to(dt), dim=2)

    if cfg.num_shared_experts > 0:
        sp = params["shared"]
        hs = layers.swiglu(layers.qdot(xg, sp["w_gate"], quant),
                           layers.qdot(xg, sp["w_up"], quant))
        shared_out = layers.qdot(hs, sp["w_down"], quant)
        gate = torch.sigmoid(torch.matmul(xg.to(torch.float32),
                                          sp["gate_proj"].to(torch.float32)))
        out = out + shared_out * gate.to(dt)
    return out.reshape(B, S, d), torch.mean(aux)


def moe_flops_per_token(d_model: int, cfg: MoEConfig) -> int:
    """Active-parameter FLOPs/token for the roofline MODEL_FLOPS term."""
    routed = cfg.top_k * 3 * d_model * cfg.d_ff_expert
    shared = 3 * d_model * (cfg.d_ff_shared or
                            cfg.num_shared_experts * cfg.d_ff_expert)
    return 2 * (routed + shared + d_model * cfg.num_experts)
