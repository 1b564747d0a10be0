"""(data, model) meshes over torch.distributed, the port's counterpart of
src/repro/launch/mesh.py.

JAX runs a mesh from one host: ``shard_map`` hands each device its shard
and its collectives name an axis.  The port is multi-controller: one
process per rank, each holding its own copy of the replicated parameters
and its own shard of the rest, and a collective runs on the process group
of one mesh axis.  Ranks lie data-major, as ``jax.make_mesh((data,
model))`` lays out its devices: rank = d * n_model + m, so the ``model``
group of data coordinate d is ranks d * n_model .. d * n_model + n_model
- 1 and the ``data`` group of model coordinate m is ranks m, m + n_model,
...

The backend follows from the layout, and ``make_debug_mesh`` logs it:

  * NCCL when each rank has a card of its own;
  * gloo on the CPU, and when ranks share a card (NCCL refuses two ranks
    on one device).  gloo takes CUDA tensors for ``all_reduce`` and
    ``all_gather`` and stages them through the host.

NCCL's collectives can be captured in a CUDA graph and gloo's cannot
(``Mesh.capturable``): core/diffusion's graphed SPMD steps refuse a mesh
that is not capturable.  Nothing swaps a backend after a failure.

A (1, 1) mesh needs no launcher: with no process group yet,
``make_debug_mesh(1, 1)`` starts a one-rank group on a free localhost port
in this process.  A larger mesh runs one process per rank under
``python -m torch.distributed.run --nproc-per-node D*M``, which sets the
environment ``init_process_group`` reads; a test spawns its ranks itself
and initializes the group before it asks for a mesh.

``make_production_mesh`` gives JAX's production meshes, (16, 16) and
(2, 16, 16) with a ``pod`` axis, as ``MeshShape``s: axis names and sizes
that the sharding rules read (launch/sharding.py), with no ranks.

``Axis`` is what a collective names: the port's counterpart of JAX's
``axis_name`` inside ``shard_map`` (this rank's index along the axis, the
axis size and its process group).  An axis with no group describes a
per-chip view without collectives: sim/trace.capture_tick_trace records
the SPMD tick on meta tensors through it, and a collective on it computes
shapes only, on meta tensors, and raises on any other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import socket
import threading
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "model")
LOG = logging.getLogger(__name__)

_MESHES: Dict[Tuple, "Mesh"] = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: ``index`` along it of ``size``,
    and the process group its collectives run on (None: shapes only)."""
    name: str
    size: int
    index: int
    group: Optional[object] = None


class Mesh:
    """A (data, model) mesh of ``data * model`` ranks, this process one of
    them.  ``shape`` maps the axis names to their sizes, as a JAX mesh's
    does; ``coords`` are this rank's (data, model) coordinates;
    ``device`` the device its tensors live on; ``backend`` 'nccl' or
    'gloo'; ``world`` the group of all its ranks (None: the default
    group), on which ``agree_max`` runs.  Hashed by identity (the SPMD
    step caches key on it)."""

    axis_names = AXES

    def __init__(self, data: int, model: int, rank: int, backend: str,
                 device: torch.device, groups: Dict[str, object],
                 world: Optional[object] = None):
        self.shape = {"data": int(data), "model": int(model)}
        self.rank = int(rank)
        self.backend = backend
        self.device = device
        self.world = world
        self.coords = (self.rank // self.shape["model"],
                       self.rank % self.shape["model"])
        self._axes = {name: Axis(name, self.shape[name], idx, groups[name])
                      for name, idx in zip(AXES, self.coords)}

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def capturable(self) -> bool:
        """Whether its collectives can be captured in a CUDA graph."""
        return self.backend == "nccl"

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"mesh axes are {AXES}; got {name!r}")
        return self._axes[name]

    def rows(self, batch: int) -> Tuple[int, int]:
        """This rank's rows [r0, r1) of a batch sharded over ``data``."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"batch {batch} is not divisible by the data "
                             f"axis size {n}")
        per = batch // n
        return self.coords[0] * per, (self.coords[0] + 1) * per

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no ranks and no process group:
    the logical sharding rules read it (sharding.spec_for,
    launch/sharding.make_rules); no collective runs on it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """JAX's production meshes as shapes: one pod (data=16, model=16) = 256
    chips; multi-pod adds a leading ``pod`` axis, (pod=2, data=16,
    model=16) = 512 chips."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def data_axes(mesh) -> tuple:
    """The axes the batch shards over: ``pod`` and ``data``, those the mesh
    has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def shape_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A mesh shape with no process group, for the per-chip trace capture
    on meta tensors (rank 0's view: data and model index 0)."""
    return Mesh(data, model, 0, "none", torch.device("meta"),
                {name: None for name in AXES})


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(device: torch.device, local_world: int) -> str:
    """'nccl' when each of the ``local_world`` ranks of this host has a
    card of its own, else 'gloo' (the CPU, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _layout(device: Union[str, torch.device], world: int
            ) -> Tuple[torch.device, str, str]:
    """(this rank's device, backend, why) for a rank of a ``world``-rank
    job on ``device``'s type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo", f"{dev.type} tensors"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh of CPU processes")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank % n_cards)
    backend = choose_backend(dev, local_world)
    why = (f"{local_world} rank(s) on {n_cards} card(s): "
           + ("a card each" if backend == "nccl" else "ranks share a card"))
    return dev, backend, why


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: Union[str, torch.device] = "cuda") -> Mesh:
    """The (data, model) mesh of this process's job on ``device``'s type
    (default the card; 'cpu' for CPU processes).  Initializes the default
    process group when none exists: from the launcher's environment
    (``torch.distributed.run``), or for a (1, 1) mesh as a one-rank group
    on a free localhost port.  Raises when the job's world size is not
    data * model.  Made once per (data, model, device) in a process."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1; got ({data}, {model})")
    want = data * model
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", 1))
    if world != want:
        raise ValueError(
            f"a ({data}, {model}) mesh needs {want} processes, one per "
            f"rank; this job has {world}: launch it with python -m "
            f"torch.distributed.run --nproc-per-node {want}")
    dev, backend, why = _layout(device, world)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the process group runs {dist.get_backend()}, and {why} "
            f"needs {backend}")
    key = (data, model, str(dev))
    mesh = _MESHES.get(key)
    if mesh is None:
        rank = dist.get_rank()
        groups = _new_groups(data, model, rank)
        mesh = _MESHES[key] = Mesh(data, model, rank, backend, dev, groups)
        LOG.info("%r: %s (%s); CUDA graphs %s", mesh, backend, why,
                 "capture its collectives" if mesh.capturable
                 else "cannot capture its collectives")
    return mesh


def _new_groups(data: int, model: int, rank: int, **kw) -> Dict[str, object]:
    """This rank's ``model`` and ``data`` groups of a (data, model) mesh;
    every rank creates every group, in the same order."""
    model_groups = [dist.new_group([d * model + m for m in range(model)],
                                   **kw) for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)],
                                  **kw) for m in range(model)]
    return {"model": model_groups[rank // model],
            "data": data_groups[rank % model]}


def fork(mesh: Mesh, timeout: float) -> Mesh:
    """A mesh of the same ranks, coordinates, backend and device as
    ``mesh`` whose collectives (its axes' and ``agree_max``'s) run on
    process groups of its own, so two threads of one process can each
    drive an engine over the mesh without interleaving their collectives
    on one communicator (the HTTP frontend's replicas).  Every rank must
    call it, in the same order.  ``timeout`` (seconds) bounds each of its
    collectives: a rank that waits longer raises."""
    if not isinstance(mesh, Mesh) or mesh.backend == "none":
        raise ValueError(f"{mesh!r} has no process groups to fork: a mesh "
                         "shape has no ranks to run on")
    kw = {"timeout": datetime.timedelta(seconds=timeout)}
    data, model = mesh.shape["data"], mesh.shape["model"]
    groups = _new_groups(data, model, mesh.rank, **kw)
    world = dist.new_group(list(range(mesh.size)), **kw)
    return Mesh(data, model, mesh.rank, mesh.backend, mesh.device, groups,
                world)


def control_group(mesh: Mesh, timeout: float):
    """A gloo group of all of ``mesh``'s ranks, for host objects (the
    frontend's control broadcast), whose collectives raise after
    ``timeout`` seconds.  Every rank must call it, in the same order."""
    return dist.new_group(list(range(mesh.size)), backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout))


def destroy() -> None:
    """Tear down the process group and forget the meshes made on it."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives over one axis (the pmax / psum / pmin / all_gather of JAX's
# shard_map bodies)
# ---------------------------------------------------------------------------

_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM,
        "min": dist.ReduceOp.MIN}

_recorder = threading.local()


@contextlib.contextmanager
def record_collectives():
    """Record every collective this thread runs while inside: a list of
    (op, axis name, operand bytes), op 'all_reduce_<sum|max|min>' or
    'all_gather'.  Backward collectives are recorded too.  On an axis with
    no process group (meta tensors, launch/dryrun.py) nothing is
    communicated: the list is all there is."""
    old = getattr(_recorder, "log", None)
    _recorder.log = log = []
    try:
        yield log
    finally:
        _recorder.log = old


def _record(op: str, t: torch.Tensor, axis: Axis) -> None:
    log = getattr(_recorder, "log", None)
    if log is not None and axis.size > 1:
        log.append((op, axis.name, t.numel() * t.element_size()))


def _shapes_only(t: torch.Tensor, axis: Axis) -> bool:
    if axis.group is not None:
        return False
    if t.device.type != "meta":
        raise ValueError(f"axis {axis.name!r} has no process group: only "
                         "meta tensors (a trace capture) pass through it")
    return True


def all_reduce(t: torch.Tensor, op: str, axis: Axis) -> torch.Tensor:
    """``t`` reduced (max, sum or min) over ``axis``: a new tensor, the
    input unchanged.  No gradient flows through it (``reduce_from`` is the
    sum under autograd)."""
    _record(f"all_reduce_{op}", t, axis)
    if _shapes_only(t, axis):
        return t.detach().clone()
    out = t.detach().clone()
    dist.all_reduce(out, op=_OPS[op], group=axis.group)
    return out


def all_gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along dim 0, in axis
    order (a batch sharded over ``data`` made whole)."""
    return all_gather(t, 0, axis)


def all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in axis order, a
    contiguous tensor (no gradient; ``gather`` is the one under
    autograd)."""
    dim = dim % t.dim()
    t = t.detach()
    _record("all_gather", t, axis)
    if _shapes_only(t, axis):
        shape = list(t.shape)
        shape[dim] *= axis.size
        return t.new_empty(shape)
    flag = t.dtype == torch.bool          # gathered as bytes
    t = (t.to(torch.uint8) if flag else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if flag else out


# ---------------------------------------------------------------------------
# Collectives under autograd: the tensor-parallel body's (models/tp.py)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    axis backward (a replicated tensor entering a sharded product)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the sum over the axis forward, the identity
    backward (partial sums leaving a sharded product)."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The shards concatenated along ``dim`` forward; backward this rank's
    slice of the gradient, first summed over the axis when ``sum_grad``
    (the ranks used different parts of the whole) and not when every rank
    used the whole alike."""

    @staticmethod
    def forward(ctx, x, dim, axis, sum_grad):
        ctx.dim, ctx.axis, ctx.sum_grad = dim, axis, sum_grad
        ctx.n = x.shape[dim]
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = all_reduce(g, "sum", ctx.axis)
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None,
                None, None)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; backward the gradient summed over ``axis``."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over ``axis`` forward; identity backward."""
    return _ReduceFrom.apply(x, axis)


def gather(x: torch.Tensor, dim: int, axis: Axis,
           sum_grad: bool = True) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated along ``dim``, under
    autograd (see ``_Gather`` for ``sum_grad``)."""
    return _Gather.apply(x, dim % x.dim(), axis, sum_grad)


def max_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise max over ``axis``, with no gradient (a softmax's
    shift)."""
    return all_reduce(x.detach(), "max", axis)


def any_over(flag: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A bool tensor true where ``flag`` is true on any rank of ``axis``
    (JAX's psum of the flag over the axis, > 0)."""
    return all_reduce(flag.to(torch.int32), "sum", axis) > 0


def agree_max(value: float, mesh: Mesh) -> float:
    """The largest of every rank's ``value`` (a host float), over the
    whole mesh."""
    t = torch.full((1,), float(value), dtype=torch.float64,
                   device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.world)
    return float(t[0])
