"""Graph audit of every registered entry point, the port's counterpart of
src/repro/analysis/jaxpr_audit.py.  JAX audits the jaxpr of each jitted
entry; the port runs each entry once on meta tensors at smoke scale (no
weight is allocated) under a ``TorchDispatchMode`` that sees every aten op,
as launch/dryrun.py traces its cells, and once on the CPU for the in-place
rule.

Rules:

  * ``ANL-GRAPH-SYNC`` (JAX's CALLBACK) - an op that reads a tensor's
    value on the host inside an entry (``aten._local_scalar_dense``:
    ``.item()``, ``int()``/``float()``/``bool()`` of a tensor) or whose
    output shape depends on values (``registry.SYNC_OPS``): a host round
    trip per tick, and inside a CUDA graph capture an error.
  * ``ANL-GRAPH-TRANSFER`` - cross-device copies per call above the
    entry's ``max_h2d`` / ``max_d2h``: a new per-tick upload or fetch.
  * ``ANL-GRAPH-INPLACE`` (JAX's DONATE) - an entry that declares its
    canvas or cache in place returns a fresh allocation instead (checked on
    the CPU at smoke scale, by storage identity): a second canvas or cache
    per tick.
  * ``ANL-GRAPH-COLLECTIVE`` - a collective (launch/mesh.record_collectives)
    on an axis the entry does not declare.
  * ``ANL-RECAPTURE`` (JAX's RECOMPILE) - over the representative engine
    shape trace (mixed ``k_req``, both stop flags, fresh seeds, single and
    meshed megaticks, two live batch shapes) the graphed steps capture more
    CUDA graphs than ``registry.RECAPTURE_BOUNDS`` allows: some operand
    became part of a graph's key.  Graphs are captured only on a card: on
    the CPU the rule reports itself as not run, and chip_smoke.py runs it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.report import Allowlist, PassResult, Violation


def _tensors(obj) -> List:
    import torch
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    return []


def _mode():
    """A TorchDispatchMode that counts host reads, value-shaped ops and
    cross-device copies (a fresh class per call: the mode's base is
    imported lazily).  On meta tensors, which hold no values, a host read
    stands in as 0, a value-shaped op as an empty result and a copy off
    the meta device as an uninitialized tensor, so the trace goes on."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.syncs: Dict[str, int] = {}
            self.h2d = 0
            self.d2h = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            src = args[0] if args else None
            meta = isinstance(src, torch.Tensor) and src.device.type == "meta"
            if name == "index" and any(
                    i is not None and i.dtype in (torch.bool, torch.uint8)
                    for i in args[1]):
                name = "index(mask)"            # a boolean mask's nonzero
            if name in registry.SYNC_OPS:
                self.syncs[name] = self.syncs.get(name, 0) + 1
                if meta:
                    if name == "_local_scalar_dense":
                        return 0
                    if name == "index(mask)":
                        return src.new_empty((0,) + tuple(
                            src.shape[len(args[1]):]))
                    return torch.empty((0,) + ((src.dim(),)
                                               if name == "nonzero" else ()),
                                       dtype=torch.int64, device="meta")
            if name in ("_to_copy", "copy_"):
                frm = args[1] if name == "copy_" else src
                to = (args[0].device if name == "copy_" else
                      torch.device(kwargs.get("device") or frm.device))
                if isinstance(frm, torch.Tensor) and frm.device != to:
                    if frm.device.type == "cpu":
                        self.h2d += 1
                    elif to.type == "cpu":
                        self.d2h += 1
                    if frm.device.type == "meta":
                        if name == "copy_":
                            return args[0]
                        return torch.empty(
                            frm.shape, dtype=kwargs.get("dtype") or
                            frm.dtype, device=to)
            return func(*args, **kwargs)

    return _Audit()


def trace_entry(ep: registry.EntryPoint) -> Tuple[dict, list]:
    """Run ``ep`` once on meta tensors under the audit mode and the
    collective recorder: (counts, collectives)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    fn, args = ep.build("meta")
    mode = _mode()
    with torch.no_grad(), mesh_lib.record_collectives() as colls, mode:
        fn(*args)
    return ({"syncs": dict(mode.syncs), "h2d": mode.h2d, "d2h": mode.d2h},
            list(colls))


def check_inplace(ep: registry.EntryPoint) -> Tuple[List[Violation], dict]:
    """Run ``ep`` on the CPU at smoke scale; each declared (argnum,
    outnum) must come back as the argument's own storage."""
    import torch
    violations: List[Violation] = []
    fn, args = ep.build("cpu")
    with torch.no_grad():
        out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    info = {}
    for argnum, outnum in ep.inplace:
        a, o = _tensors(args[argnum]), _tensors(out[outnum])
        same = len(a) == len(o) and all(
            x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
            for x, y in zip(a, o))
        info[f"arg{argnum}->out{outnum}"] = same
        if not same:
            violations.append(Violation(
                "ANL-GRAPH-INPLACE", ep.name,
                f"output {outnum} is a fresh allocation, not argument "
                f"{argnum}'s storage: the in-place update was dropped, a "
                f"second canvas or cache per call is back"))
    return violations, info


def audit_entry(ep: registry.EntryPoint) -> Tuple[List[Violation], dict]:
    violations: List[Violation] = []
    counts, colls = trace_entry(ep)
    info: dict = dict(counts)
    if counts["syncs"]:
        violations.append(Violation(
            "ANL-GRAPH-SYNC", ep.name,
            f"host reads or value-shaped ops inside the entry point: "
            f"{counts['syncs']}"))
    if ep.kernel_only:
        return violations, info
    info["budget"] = {"max_h2d": ep.max_h2d, "max_d2h": ep.max_d2h}
    if counts["h2d"] > ep.max_h2d:
        violations.append(Violation(
            "ANL-GRAPH-TRANSFER", ep.name,
            f"{counts['h2d']} host-to-device copies per call exceed the "
            f"declared budget {ep.max_h2d}: a new per-tick upload"))
    if counts["d2h"] > ep.max_d2h:
        violations.append(Violation(
            "ANL-GRAPH-TRANSFER", ep.name,
            f"{counts['d2h']} device-to-host copies per call exceed the "
            f"declared budget {ep.max_d2h}: a new per-tick fetch"))
    axes = sorted({ax for _, ax, _ in colls})
    info["collectives"] = sorted({f"{op}@{ax}" for op, ax, _ in colls})
    stray = set(axes) - set(ep.mesh_axes)
    if stray:
        violations.append(Violation(
            "ANL-GRAPH-COLLECTIVE", ep.name,
            f"collectives over undeclared axes {sorted(stray)} (declared: "
            f"{sorted(ep.mesh_axes) or 'none'})"))
    if ep.inplace:
        vs, ip = check_inplace(ep)
        violations.extend(vs)
        info["inplace"] = ip
    return violations, info


# ---------------------------------------------------------------------------
# CUDA-graph capture bound
# ---------------------------------------------------------------------------

def recapture_violations(captures: Dict[str, int]) -> List[Violation]:
    """``captures`` (graphed step -> graphs captured over the replayed
    trace) against ``registry.RECAPTURE_BOUNDS``."""
    out = []
    for name, bound in registry.RECAPTURE_BOUNDS.items():
        n = captures.get(name)
        if n is not None and n > bound:
            out.append(Violation(
                "ANL-RECAPTURE", name,
                f"{n} CUDA graphs captured over the replayed engine trace "
                f"(bound {bound}): an operand became part of a graph's key"))
    return out


def recapture_trace(device="cuda", mesh=None) -> Dict[str, int]:
    """Replay the engine's per-megastep call shapes against fresh graphed
    steps of the smoke llada-8b on ``device`` and count their captures:
    mixed k_req depths, both stop flags and a fresh seed per call through
    the megatick (and, with ``mesh``, a capturable one-rank mesh, the
    meshed megatick), and the K=1 tick at two live batch shapes."""
    import numpy as np
    import torch

    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = registry._smoke(device)
    dev = torch.device(device)
    B, S = c["x"].shape
    sizes: Dict[str, int] = {}

    def mega_args(b, seed):
        x = torch.full((b, S), cfg.mask_id, dtype=torch.int32, device=dev)
        kv = torch.ones((b, S), dtype=torch.bool, device=dev)
        state = diffusion.megatick_state(
            np.full((b,), registry.SMOKE_PROMPT, np.int32),
            np.full((b,), 2, np.int32), dcfg, device=dev)
        return x, kv, state, seed

    fns = {"megatick": diffusion.Megatick(model, dcfg, cfg.mask_id, 4,
                                          jit_steps=True)}
    if mesh is not None:
        fns["megatick_mesh"] = diffusion.Megatick(
            model, dcfg, cfg.mask_id, 4, jit_steps=True, mesh=mesh)
    for name, fn in fns.items():
        p = params if name == "megatick" else \
            diffusion.place_spmd_params(params, mesh)
        x, kv, state, _ = mega_args(B, 0)
        for seed, (k_req, stop) in enumerate(
                [(1, False), (4, False), (2, True), (4, False)]):
            st = {n: t.clone() for n, t in state.items()}
            fn(p, x, kv, st, seed, k_req, stop, None, seed)
        sizes[name] = fn._step.captures
    tick = diffusion.get_tick_fn(model, dcfg, cfg.mask_id, jit_steps=True)
    for b in (B, 2 * B):                   # two live engine batch shapes
        x, kv, _, _ = mega_args(b, 7)
        bs = torch.full((b,), registry.SMOKE_PROMPT, dtype=torch.int32,
                        device=dev)
        k = torch.ones((b,), dtype=torch.int32, device=dev)
        seed = torch.zeros((1,), dtype=torch.int64, device=dev)
        for s in range(3):
            seed.fill_(s)
            tick(params, x, kv, bs, k, seed, None)
    sizes["tick"] = tick.captures
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return sizes


def check_recapture(device: Optional[str] = None, mesh=None
                    ) -> Tuple[List[Violation], dict]:
    """The ANL-RECAPTURE rule: on a card, ``recapture_trace`` against the
    bounds; without one (or on the CPU) the rule reports itself as not
    run, with the reason."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    bounds = dict(registry.RECAPTURE_BOUNDS)
    if torch.device(device).type != "cuda":
        return [], {"run": False, "bounds": bounds,
                    "reason": "CUDA graphs are captured only on a card; "
                              "chip_smoke.py runs this rule on the H100"}
    sizes = recapture_trace(device, mesh)
    return recapture_violations(sizes), {"run": True, "captures": sizes,
                                         "bounds": bounds}


def run(allow: Allowlist, recapture: bool = True) -> PassResult:
    violations: List[Violation] = []
    info: dict = {"entry_points": {}}
    eps = registry.entry_points()
    for ep in eps:
        vs, ep_info = audit_entry(ep)
        violations.extend(vs)
        info["entry_points"][ep.name] = ep_info
    if recapture:
        vs, rc = check_recapture()
        violations.extend(vs)
        info["recapture"] = rc
    kept, suppressed = allow.filter(violations)
    return PassResult("graph_audit", kept, suppressed, info=info,
                      checked=len(eps))
