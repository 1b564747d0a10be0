"""The tensor-parallel body: every family's products with their weights
sharded over a mesh's ``model`` axis, as JAX's GSPMD partitions
them from ``launch/sharding.make_rules``'s placements (heads, MLP,
experts and vocab over ``model``).

A step over a mesh with |model| > 1 (launch/steps.py) runs the model's
forward inside ``use(Parallel(...))``; the body then reads which leaves
are sharded from their shapes, a local dim short of the config's full
one.  The Megatron pair (launch/mesh.copy_to / reduce_from) keeps
autograd exact: a replicated tensor entering a sharded product passes
``copy_to`` (its gradient summed over ``model``), the partial sums
leaving one pass ``reduce_from``.  So every replicated leaf's gradient
comes out equal on every ``model`` rank.

  * column-parallel (``col``): q/k/v, the FFN's first products, the
    expert and shared-expert gate/up, the LM head: each rank's columns;
  * row-parallel (``row``): wo, the FFN's down product, the expert
    down product: the f32 partial, summed over ``model`` in f32, the
    replicated bias added once after the sum, one rounding (JAX's
    ``dot_general(preferred_element_type=f32)`` + bias + cast, whose f32
    partials GSPMD sums before the cast);
  * attention on local heads when q, k and v shard on whole heads
    (``n_kv_heads % |model| == 0``, which the head-parallel cache
    follows); otherwise the projections are gathered over ``model``,
    attention runs on every head on every rank, and ``wo`` takes the
    rank's column slice of its output;
  * the vocab-sharded embedding (``embed``): each rank looks up the ids
    of its range and puts zeros elsewhere, then one exact sum;
  * the vocab-parallel loss (``vocab_ce``): a global log-softmax over
    the ranks' logit columns;
  * the recurrent families' pieces (models/ssm.py, models/rglru.py): a
    row-sharded square gate whose output the rank keeps only its
    channels of (``row_gate``), an RMSNorm over a sharded channel dim
    (``rms_norm``), both through ``all_sum``.

``Parallel.cache_seq`` marks a context-parallel cache (``kv_seq`` on
``model``: each rank stores its sequence slice; models/transformer's
``cache_attention`` gathers a layer's K/V before attention).  ``data``,
in a train step over |data| > 1, is the axis the MoE load-balance aux
is averaged over (models/moe.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import mx
from repro_torch.launch import mesh as mesh_lib

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Parallel:
    """The body's mesh axes: ``model`` (None or size 1: no tensor
    parallelism), ``data`` (the train step's MoE aux), and whether the KV
    cache's sequence dim is sharded over ``model``."""
    model: Optional[mesh_lib.Axis] = None
    data: Optional[mesh_lib.Axis] = None
    cache_seq: bool = False


def current() -> Optional[Parallel]:
    return getattr(_state, "ctx", None)


def model_axis() -> Optional[mesh_lib.Axis]:
    """The active ``model`` axis when it has more than one rank, else
    None (the single-device body)."""
    ctx = current()
    if ctx is None or ctx.model is None or ctx.model.size == 1:
        return None
    return ctx.model


@contextlib.contextmanager
def use(ctx: Optional[Parallel]):
    old = current()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = old


def shard_range(full: int, local: int, axis: mesh_lib.Axis
                ) -> Tuple[int, int]:
    """[start, stop) of this rank's shard of a dim of ``full`` held as
    ``local`` (sharding.shard_slices's even split); (0, full) for a
    replicated dim."""
    if local == full:
        return 0, full
    if local * axis.size != full:
        raise ValueError(f"a dim of {full} held as {local} is not a "
                         f"{axis.size}-way shard")
    return axis.index * local, (axis.index + 1) * local


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) [or batched (E, R, K) @ (E, K, N)] with f32
    accumulation and an f32 result: both operands cast to f32 first."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def copy_in(h: torch.Tensor) -> torch.Tensor:
    """``h`` as the input of sharded products (launch/mesh.copy_to over
    ``model``; ``h`` itself without the body).  Made once for the
    products that share ``h``, so the backward sums their gradient in one
    all-reduce."""
    axis = model_axis()
    return h if axis is None else mesh_lib.copy_to(h, axis)


def col(h: torch.Tensor, w: torch.Tensor, full: int, quant=None,
        bias: Optional[torch.Tensor] = None, gather: bool = False,
        part: bool = True, hin: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """h (..., K) @ w (K, N_loc) (+ bias) where w holds this rank's
    columns of ``full``.  ``gather``: the whole (..., full) on every rank
    (the ranks' columns gathered over ``model``); ``part``: whether the
    ranks then use different parts of it (a row-parallel product
    follows), which decides the gradient (launch/mesh.gather).  A
    replicated w gives the whole product, and under ``part`` its gradient
    is summed over ``model``.  ``hin``: ``copy_in(h)``, when the caller
    shares one among several products."""
    from repro_torch.models import layers
    axis = model_axis()
    if axis is None:
        return layers.qdot(h, w, quant, bias)
    if w.shape[-1] == full:
        y = layers.qdot(h, w, quant, bias)
        return mesh_lib.copy_to(y, axis) if gather and part else y
    y = layers.qdot(mesh_lib.copy_to(h, axis) if hin is None else hin, w,
                    quant, bias)
    return mesh_lib.gather(y, -1, axis, sum_grad=part) if gather else y


def row(x: torch.Tensor, w: torch.Tensor, full: int, quant=None,
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K_loc) @ w (K_loc, N) where w holds this rank's rows of
    ``full``: the f32 partial summed over ``model``, ``bias`` (replicated)
    added once after the sum, one rounding to x's dtype.  Under an enabled
    ``quant`` whose MX blocks (32 along K) would straddle the shard
    boundary, the input and the weight are gathered first, so every block
    is the single device's, and the product runs whole on every rank."""
    from repro_torch.models import layers
    axis = model_axis()
    if axis is None or w.shape[0] == full:
        return layers.qdot(x, w, quant, bias)
    if quant is not None and quant.enabled and w.shape[0] % mx.MX_BLOCK:
        return layers.qdot(mesh_lib.gather(x, -1, axis, sum_grad=False),
                           mesh_lib.gather(w, 0, axis, sum_grad=False),
                           quant, bias)
    if quant is not None and quant.enabled:
        x, w = quant.acts(x), quant.weights(w)
    y = mesh_lib.reduce_from(_mm_f32(x, w), axis)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``model`` for ranks that then use different parts
    of the sum: the gradient is summed over ``model`` too (Megatron's g,
    then f)."""
    axis = model_axis()
    return mesh_lib.copy_to(mesh_lib.reduce_from(x, axis), axis)


def row_gate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             full: int) -> torch.Tensor:
    """x (..., K_loc) @ w (K_loc, full) + b, the RG-LRU's square gates
    (JAX's ("mlp", None) weight and ("mlp",) bias): the f32 partial summed
    over ``model``, this rank's ``b.shape[0]`` columns kept, ``b`` added in
    f32, one rounding to x's dtype (``layers.qdot``'s biased product)."""
    from repro_torch.models import layers
    axis = model_axis()
    if axis is None or w.shape[0] == full:
        return layers.qdot(x, w, None, b)
    c0, c1 = shard_range(full, b.shape[0], axis)
    y = all_sum(_mm_f32(x, w))[..., c0:c1]
    return (y + b.to(torch.float32)).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, full: int,
             eps: float) -> torch.Tensor:
    """``layers.rms_norm`` over a channel dim of ``full`` whose slice this
    rank holds (``w`` its weight's slice): the f32 sum of squares summed
    over ``model``."""
    from repro_torch.models import layers
    axis = model_axis()
    if axis is None or w.shape[0] == full:
        return layers.rms_norm(x, w, eps)
    xf = x.to(torch.float32)
    var = all_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) / full
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def partial(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """A row-parallel product's f32 partial, not yet summed (the MoE
    combine sums it with the routed experts' in one all-reduce)."""
    if quant is not None and quant.enabled:
        x, w = quant.acts(x), quant.weights(w)
    return _mm_f32(x, w)


# ---------------------------------------------------------------------------
# Vocab: the sharded embedding and the global log-softmax
# ---------------------------------------------------------------------------

def embed(w: torch.Tensor, tokens: torch.Tensor, vocab: int
          ) -> torch.Tensor:
    """The rows of ``tokens`` of an embedding whose rows (vocab) may be
    sharded over ``model``: each rank looks up the ids in its range,
    zeros elsewhere, and one sum over ``model`` (exact: one rank holds
    each id)."""
    axis = model_axis()
    if axis is None or w.shape[0] == vocab:
        return F.embedding(tokens, w)
    r0, r1 = shard_range(vocab, w.shape[0], axis)
    inside = (tokens >= r0) & (tokens < r1)
    local = torch.where(inside, tokens - r0, 0)
    e = torch.where(inside[..., None], F.embedding(local, w),
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return mesh_lib.reduce_from(e, axis)


def vocab_sharded(logits: torch.Tensor, vocab: int) -> bool:
    """Whether ``logits`` hold this rank's columns of a vocab-sharded
    head."""
    return model_axis() is not None and logits.shape[-1] != vocab


def vocab_ce(lf: torch.Tensor, tokens: torch.Tensor, vocab: int
             ) -> torch.Tensor:
    """Cross-entropy of f32 logits whose columns are this rank's shard of
    ``vocab``: the row max over ``model`` (no gradient), the sum of
    exponentials over ``model`` under autograd, the target's logit from
    the rank that holds it, summed over ``model``."""
    axis = model_axis()
    r0, r1 = shard_range(vocab, lf.shape[-1], axis)
    m = mesh_lib.max_over(torch.amax(lf, dim=-1), axis)
    se = mesh_lib.reduce_from(torch.sum(torch.exp(lf - m[..., None]),
                                        dim=-1), axis)
    tk = tokens.to(torch.int64)
    inside = (tk >= r0) & (tk < r1)
    g = torch.gather(lf, -1, torch.where(inside, tk - r0, 0)[..., None])
    gold = mesh_lib.reduce_from(torch.where(inside, g[..., 0], 0.0), axis)
    return torch.log(se) + m - gold
