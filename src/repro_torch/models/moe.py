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


def _global_aux(aux: torch.Tensor, probs_stats, cfg: MoEConfig, G: int,
                data) -> torch.Tensor:
    """The load-balance aux of the global batch when the batch is sharded
    over ``data`` (a train step over |data| > 1, models/tp.Parallel): with
    grouped dispatch each group is a batch row, so the aux is the mean of
    every rank's rows' (a sum over ``data`` under autograd); one group of
    all tokens sums its per-expert token counts and router probabilities
    over ``data`` before the product."""
    from repro_torch.launch import mesh as mesh_lib
    if cfg.group_dispatch:
        return mesh_lib.reduce_from(torch.sum(aux), data) / (G * data.size)
    counts, psum, T = probs_stats
    stats = mesh_lib.reduce_from(torch.cat([counts, psum], dim=-1), data)
    n = T * data.size
    frac, pmean = stats[..., :cfg.num_experts] / n, \
        stats[..., cfg.num_experts:] / n
    return torch.mean(cfg.num_experts * torch.sum(frac * pmean, dim=-1))


def _slot_tokens(xg: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
                 K: int, n_slots: int, s0: int, s1: int) -> torch.Tensor:
    """Buffer slots [s0, s1) of each group filled with their tokens: xg
    (G, T, d) -> (G, s1 - s0, d), rows of x with a zero row T per group
    the source of empty slots; dropped pairs all write the sentinel slot
    ``n_slots``."""
    G, T, d = xg.shape
    dev = xg.device
    src = torch.full((G, n_slots + 1), T, dtype=torch.int64, device=dev)
    src.scatter_(1, slot, order // K)
    x_pad = torch.cat([xg, torch.zeros((G, 1, d), dtype=xg.dtype,
                                       device=dev)], 1)
    rows = src[:, s0:s1] + (T + 1) * torch.arange(G, device=dev)[:, None]
    return x_pad.reshape(G * (T + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, s1 - s0, d)


def _pair_outputs(out: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
                  K: int, n_slots: int, s0: int) -> torch.Tensor:
    """Each (token, k) pair's row of the slot outputs: ``out`` (G, S, d)
    holds slots [s0, s0 + S), zeros stand for the other slots and the
    sentinel; each pair reads its slot in its original (token, k) order
    (the inverse permutation of the sort) -> (G, T, K, d)."""
    G, S, d = out.shape
    dev = out.device
    parts = [torch.zeros((G, s0, d), dtype=out.dtype, device=dev)] \
        if s0 else []
    parts += [out, torch.zeros((G, n_slots - s0 - S + 1, d),
                               dtype=out.dtype, device=dev)]
    out_pad = torch.cat(parts, 1)
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    rows = pair_slot + (n_slots + 1) * torch.arange(G, device=dev)[:, None]
    return out_pad.reshape(G * (n_slots + 1), d).index_select(
        0, rows.reshape(-1)).reshape(G, slot.shape[1] // K, K, d)


def moe_ffn(x: torch.Tensor, params: Dict, cfg: MoEConfig, quant=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss, an f32 scalar: the mean of
    the groups').  Under the tensor-parallel body (models/tp.py) with the
    experts sharded over ``model`` (``w_gate`` (E / |model|, d, F)) or
    their hidden dim (``(E, d, F / |model|)``), the routing and dispatch
    run whole on every rank, each rank computes its experts or its
    hidden slice of every expert, and the combine's f32 partial (zeros for
    pairs whose expert is elsewhere, plus the shared experts' row-parallel
    partial) is summed over ``model`` in f32.  The shared experts are
    column- then row-parallel wherever their weights are sharded."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import tp as tp_lib
    B, S, d = x.shape
    G, T = (B, S) if cfg.group_dispatch and B > 1 else (1, B * S)
    K, E, Fe = cfg.top_k, cfg.num_experts, cfg.d_ff_expert
    C = capacity(T, cfg)
    xg = x.reshape(G, T, d)
    topk_w, topk_e, aux = route(xg, params["router"], cfg)
    ctx = tp_lib.current()
    data = None if ctx is None else ctx.data
    if data is not None and data.size > 1:
        stats = None
        if not cfg.group_dispatch:
            probs = torch.softmax(torch.matmul(
                xg.to(torch.float32), params["router"].to(torch.float32)),
                dim=-1)
            counts = torch.sum(F.one_hot(topk_e[..., 0], E).to(
                torch.float32), dim=-2)
            stats = (counts, torch.sum(probs, dim=-2), T)
        aux = _global_aux(aux, stats, cfg, G, data)
    axis = tp_lib.model_axis()
    E_loc, F_loc = params["w_gate"].shape[0], params["w_gate"].shape[2]
    sharded = axis is not None and (E_loc != E or F_loc != Fe)
    e0, e1 = tp_lib.shard_range(E, E_loc, axis) if sharded else (0, E)
    order, slot = dispatch_slots(topk_e, cfg, C)
    dt, f32 = x.dtype, torch.float32
    quantized = quant is not None and quant.enabled

    # expert SwiGLU: one batched GEMM over this rank's experts, each
    # expert's G·C rows
    xin = mesh_lib.copy_to(xg, axis) if sharded else xg
    xe = _slot_tokens(xin, order, slot, K, E * C, e0 * C, e1 * C).reshape(
        G, E_loc, C, d).transpose(0, 1).reshape(E_loc, G * C, d)
    wg, wu, wd = (expert_weights(params[n], quant).to(dt)
                  for n in ("w_gate", "w_up", "w_down"))
    if quantized:
        xe = quant.acts(xe)
    h = layers.swiglu(torch.bmm(xe, wg), torch.bmm(xe, wu))
    whole = not sharded or F_loc == Fe
    if not sharded:
        expert_out = torch.bmm(h, wd)
    elif F_loc != Fe and quantized and F_loc % mx.MX_BLOCK:
        # MX blocks along F would straddle the shards: the whole product
        h = mesh_lib.gather(h, -1, axis, sum_grad=False)
        wd = expert_weights(mesh_lib.gather(params["w_down"], 1, axis,
                                            sum_grad=False), quant).to(dt)
        expert_out = torch.bmm(h, wd).to(f32)
        whole = True
    else:
        expert_out = torch.bmm(h.to(f32), wd.to(f32))
    expert_out = expert_out.reshape(E_loc, G, C, d).transpose(0, 1)
    pair = _pair_outputs(expert_out.reshape(G, E_loc * C, d), order, slot,
                         K, E * C, e0 * C)

    # combine: the pairs times their top-k weights, summed over K; on one
    # device in x's dtype, sharded as the f32 partial of this rank's pairs
    if sharded:
        w = mesh_lib.copy_to(topk_w, axis).to(dt).to(f32)
        out = torch.sum(pair * w[..., None], dim=2)
        if whole and E_loc == E:
            # a gathered product is whole on every rank: count it once
            out = torch.where(torch.full((), axis.index == 0,
                                         device=x.device),
                              out, torch.zeros((), dtype=f32,
                                               device=x.device))
    else:
        out = torch.sum(pair * topk_w[..., None].to(dt), dim=2)

    shared = None
    if cfg.num_shared_experts > 0:
        sp = params["shared"]
        Fs = cfg.d_ff_shared or cfg.num_shared_experts * Fe
        hin = tp_lib.copy_in(xg)
        hs = layers.swiglu(
            tp_lib.col(xg, sp["w_gate"], Fs, quant, hin=hin),
            tp_lib.col(xg, sp["w_up"], Fs, quant, hin=hin))
        gate = torch.sigmoid(torch.matmul(
            xg.to(f32), sp["gate_proj"].to(f32))).to(dt)
        if sharded and sp["w_down"].shape[0] != Fs and not (
                quantized and sp["w_down"].shape[0] % mx.MX_BLOCK):
            # one all-reduce for the routed and the shared partials
            out = out + tp_lib.partial(hs, sp["w_down"], quant) * \
                mesh_lib.copy_to(gate, axis).to(f32)
        else:
            shared = tp_lib.row(hs, sp["w_down"], Fs, quant) * gate
    if sharded:
        out = mesh_lib.reduce_from(out, axis).to(dt)
    if shared is not None:
        out = out + shared
    return out.reshape(B, S, d), torch.mean(aux)


def moe_flops_per_token(d_model: int, cfg: MoEConfig) -> int:
    """Active-parameter FLOPs/token for the roofline MODEL_FLOPS term."""
    routed = cfg.top_k * 3 * d_model * cfg.d_ff_expert
    shared = 3 * d_model * (cfg.d_ff_shared or
                            cfg.num_shared_experts * cfg.d_ff_expert)
    return 2 * (routed + shared + d_model * cfg.num_experts)
