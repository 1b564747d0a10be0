"""Logical-axis sharding rules, ported from src/repro/sharding.py.

Model code names each tensor dim by a *logical* axis ("batch", "seq",
"embed", ...); the launch layer binds logical names to mesh axes by rules
(launch/sharding.make_rules).  ``spec_for`` turns a tuple of logical names
into a ``PartitionSpec`` under the active (mesh, rules) context with JAX's
three rules: a mesh axis that does not divide the dim is dropped, a mesh
axis maps at most one dim of a tensor (the first dim wins), and trailing
``None``s are trimmed.  Any object with ``shape`` (a dict of axis sizes)
and ``axis_names`` is a mesh here: the runtime ``launch/mesh.Mesh`` and
the shape-only production meshes (``launch/mesh.make_production_mesh``).

The port is multi-controller (launch/mesh.py): each rank already holds
its own shard, so ``shard`` (JAX's ``with_sharding_constraint``) places
nothing and is the identity.  A ``Placement`` (JAX's ``NamedSharding``)
names a mesh and a spec, and ``local_shard`` cuts a full tensor to one
rank's shard under it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

_state = threading.local()


class PartitionSpec(tuple):
    """The mesh axis (a name, a tuple of names, or None) of each leading
    dim of a tensor; later dims are replicated.  A tuple, so it compares
    equal to JAX's ``PartitionSpec`` read as a tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _ctx():
    if not hasattr(_state, "mesh"):
        _state.mesh, _state.rules = None, {}
    return _state


def set_context(mesh, rules: Optional[Dict[str, object]] = None) -> None:
    s = _ctx()
    s.mesh, s.rules = mesh, dict(rules or {})


@contextlib.contextmanager
def use_context(mesh, rules: Optional[Dict[str, object]] = None):
    s = _ctx()
    old = (s.mesh, s.rules)
    set_context(mesh, rules)
    try:
        yield
    finally:
        s.mesh, s.rules = old


def current_mesh():
    return _ctx().mesh


def axis_size(mesh, axis) -> int:
    """The number of shards of a spec entry: 1 for None, the product of
    the sizes of a tuple of axes."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def spec_for(names: Sequence[Optional[str]],
             shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
    """Logical names -> PartitionSpec under the active rules.  With
    ``shape`` given, mesh axes that do not evenly divide the dim are
    dropped (replicated)."""
    s = _ctx()
    mesh, rules = s.mesh, s.rules
    out = []
    used = set()
    for i, n in enumerate(names):
        ax = rules.get(n) if n is not None else None
        if ax is not None and mesh is not None and shape is not None:
            if shape[i] % axis_size(mesh, ax) != 0:
                ax = None
        # a mesh axis may appear in at most one dim; first dim wins
        key = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        if ax is not None and used & set(key):
            ax = None
        if ax is not None:
            used |= set(key)
        out.append(ax)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def shard(x, *names: Optional[str]):
    """JAX's logical sharding constraint.  The identity: in the
    multi-controller port a rank's tensor already is its shard."""
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """A tensor's placement on a mesh (JAX's ``NamedSharding``): ``spec``
    gives the mesh axes that shard its leading dims."""
    mesh: object
    spec: PartitionSpec


def named_sharding(names: Sequence[Optional[str]],
                   shape: Optional[Tuple[int, ...]] = None
                   ) -> Optional[Placement]:
    s = _ctx()
    if s.mesh is None:
        return None
    return Placement(s.mesh, spec_for(names, shape))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a runtime mesh
    (``launch/mesh.Mesh.axis``); a shape-only mesh has none (ValueError)."""
    if not hasattr(mesh, "axis"):
        raise ValueError(f"{mesh!r} is a mesh shape with no ranks: pass the "
                         "coordinates of the shard to cut")
    return {name: mesh.axis(name).index for name in mesh.axis_names}


def shard_slices(shape: Sequence[int], placement: Placement,
                 coords: Optional[Mapping[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The slice of each dim of a full tensor of ``shape`` that the rank
    at ``coords`` (axis name -> index; default this rank's on the
    placement's mesh) holds.  A dim sharded over a tuple of axes is cut
    into their product's shards, the first axis the major one, as JAX
    lays them out."""
    mesh = placement.mesh
    coords = mesh_coords(mesh) if coords is None else coords
    out = []
    for i, n in enumerate(shape):
        ax = placement.spec[i] if i < len(placement.spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        names = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        idx = 0
        for a in names:
            idx = idx * mesh.shape[a] + int(coords[a])
        parts = axis_size(mesh, ax)
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {parts} shards over {ax!r}")
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def local_shard(x, placement: Placement,
                coords: Optional[Mapping[str, int]] = None):
    """The rank's shard of the full tensor (or array) ``x`` under
    ``placement``: a view of ``x`` (a copy only where the caller makes
    one)."""
    return x[shard_slices(tuple(x.shape), placement, coords)]
