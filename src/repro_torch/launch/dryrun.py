"""Dry run of the step builders at the production meshes, on meta tensors:
the port's counterpart of src/repro/launch/dryrun.py.

For each (arch x shape) cell this driver:
  1. takes the production mesh (16 x 16 single-pod, 2 x 16 x 16
     multi-pod; launch/mesh.make_production_mesh) and binds JAX's logical
     sharding rules for the arch (launch/sharding.make_rules);
  2. builds rank 0's step (launch/steps.build_step) over a shape-only
     mesh (launch/mesh.shape_mesh: no process group), with ``pod x data``
     as the data axis of the multi-pod mesh (32 ranks), and runs it once
     on meta tensors of rank 0's shard shapes: the tensor-parallel body
     (models/tp.py) on the kernels' plain versions, which compute shapes
     only there, and every collective recorded, not run
     (launch/mesh.record_collectives);
  3. records, per device: FLOPs (``torch.utils.flop_counter``: the
     matmul-class ops, attention's included), bytes (``_ByteCounter``:
     the input plus output bytes of every aten op but views, each kernel
     counted as one op of its own inputs and outputs), the collectives'
     bytes and counts by kind and axis, and the parameter and cache bytes
     from the placements (JAX's ``sharded_bytes``);
  4. derives the three roofline terms against one card's peaks,
       compute    = FLOPs / 989e12              [H100 SXM bf16 dense]
       memory     = bytes / 3.35e12             [H100 SXM HBM3]
       collective = collective bytes / 450e9    [NVLink 4, one direction]
     the bottleneck, ``model_flops_global`` (6 N D for train, 2 N_active D
     otherwise) and the useful-FLOPs ratio.

The peaks are NVIDIA's published figures for the H100 SXM at its 700 W
limit; a card set lower runs slower.  NVLink joins the cards of one host
only (8 at most), so at 256 or 512 cards the collective term is a lower
bound: traffic between hosts runs on the network, slower.  The bytes are
per eager op, not XLA's post-fusion "bytes accessed": the two drivers'
byte counts, and so their memory terms, are not comparable.  An eager
trace counts every layer, so the JAX driver's depth 1 / depth 2
extrapolation (XLA counts a loop body once) is not needed, and a
full-depth trace of the largest cell takes seconds.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json (git
ignores results/dryrun_torch/); nothing is written under results/dryrun/.
A cell whose step raises records ``status: "error"`` and the message.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod both] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as shlib
from repro_torch import tree as tree_lib
from repro_torch.configs import base as configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as launch_sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import build_model

PEAK_FLOPS = 989e12      # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s / card, NVLink 4, each direction
CARD = "H100 SXM 80GB, 700 W (published peaks)"

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

BYTES_NOTE = ("bytes_per_device sums the input and output bytes of every "
              "eager aten op but views (each kernel counted as one op of "
              "its inputs and outputs); it is not XLA's post-fusion "
              "'bytes accessed', and the two are not comparable")
COLLECTIVE_NOTE = ("collective_s divides by one card's NVLink rate; NVLink "
                   "spans one host, so at this many cards it is a lower "
                   "bound")

# the kernels' plain versions (module, function): the byte count takes
# each call as one op of its own inputs and outputs, as the kernel moves
KERNEL_PLAINS = (
    ("repro_torch.kernels.flash_bidir", "flash_bidir_plain"),
    ("repro_torch.kernels.flash_bidir", "flash_bidir_bwd_plain"),
    ("repro_torch.kernels.baos_mx_quant", "baos_mx_quant_plain"),
    ("repro_torch.kernels.fused_head_sampling", "fused_head_stable_max"),
    ("repro_torch.kernels.fused_head_sampling", "head_shard_partials_plain"),
    ("repro_torch.kernels.stablemax_sampling", "stable_max_plain"),
    ("repro_torch.kernels.topk_mask", "topk_mask_plain"),
)


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums the input plus output bytes of every aten op run under it,
    except views (which move nothing) and the ops inside a kernel's plain
    version (``kernel_scope``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.paused = threading.local()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(self.paused, "n", 0) == 0 and not _is_view(func):
            moved = _tensor_bytes(args) + _tensor_bytes(kwargs)
            if not func._schema.is_mutable:
                # an in-place or out= op writes into an operand counted
                # above; another writes its outputs
                moved += _tensor_bytes(out)
            self.bytes += moved
            self.ops += 1
        return out

    @contextlib.contextmanager
    def kernel_scope(self):
        """Patch the kernels' plain versions: each call counts its inputs
        and outputs once, and nothing inside it."""
        import importlib
        saved = []

        def wrap(fn):
            def call(*args, **kwargs):
                self.paused.n = getattr(self.paused, "n", 0) + 1
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self.paused.n -= 1
                if self.paused.n == 0:
                    self.bytes += _tensor_bytes(args) + \
                        _tensor_bytes(kwargs) + _tensor_bytes(out)
                    self.ops += 1
                return out
            return call

        for mod_name, name in KERNEL_PLAINS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(getattr(mod, name)))
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


def _is_view(func) -> bool:
    return any(a.alias_info is not None and not a.alias_info.is_write
               for a in func._schema.returns)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (inference), JAX's."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch * shape.block_length


VARIANTS = {
    # JAX's variants that change the port's trace: config / policy
    # overrides per cell
    "baseline": {},
    "split": {"policy": {"split_cache": True}},
    "losschunk": {"policy": {"loss_chunk": 512}},
    "split_losschunk": {"policy": {"split_cache": True, "loss_chunk": 512}},
    "padheads48": {"cfg": {"n_heads": 48, "n_kv_heads": 48}},
    "padheads48_split": {"cfg": {"n_heads": 48, "n_kv_heads": 48},
                         "policy": {"split_cache": True}},
    "padheads_g3": {"cfg": {"n_heads": 48, "n_kv_heads": 16}},
    "moe_global": {"moe": {"group_dispatch": False}},
}

# JAX's variants that set only what the port does not read (score_dtype,
# remat, attn_chunk: its attention is flash_bidir at every size, f32 inside
# the kernel): (the options, the variant whose trace they would repeat)
NOT_PORTED = {
    "bf16score": ("score_dtype", "baseline"),
    "split_bf16": ("score_dtype", "split"),
    "losschunk_bf16": ("score_dtype", "losschunk"),
    "remat": ("remat", "baseline"),
    "remat_bf16": ("remat and score_dtype", "baseline"),
    "bigchunk": ("attn_chunk", "baseline"),
    "padheads48_split_bf16": ("score_dtype", "padheads48_split"),
    "split_losschunk_bf16": ("score_dtype", "split_losschunk"),
}


def variant_config(arch: str, variant: str = "baseline"):
    """(config, policy) of a cell's variant."""
    if variant in NOT_PORTED:
        opts, same = NOT_PORTED[variant]
        raise ValueError(f"variant {variant!r}: the port has no {opts} "
                         f"option; it would trace as {same!r}")
    overrides = VARIANTS[variant]
    cfg = configs.get_config(arch)
    if overrides.get("cfg"):
        cfg = dataclasses.replace(cfg, **overrides["cfg"])
    if overrides.get("moe") and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **overrides["moe"]))
    return cfg, steps_lib.ServePolicy(**overrides.get("policy", {}))


def sharded_bytes(tree, placements, mesh) -> float:
    """Per-device bytes of ``tree``'s leaves under ``placements``, JAX's
    ``sharded_bytes``."""
    tot = 0.0
    for t, pl in zip(tree_lib.leaves(tree), tree_lib.leaves(placements)):
        if not isinstance(t, torch.Tensor):
            continue
        parts = 1
        for a in launch_sharding.spec_axes(pl.spec):
            parts *= mesh.shape[a]
        tot += t.numel() * t.element_size() / parts
    return tot


def _meta_local(tree, placements, coords):
    """Meta tensors of rank ``coords``'s shard shapes."""
    def cut(t, pl):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return torch.empty(launch_sharding.local_shape(t.shape, pl, coords),
                           dtype=t.dtype, device="meta")
    return tree_lib.tree_map(cut, tree, placements)


def trace_cell(cfg, shape, policy, mesh_shape: Tuple[int, ...]) -> dict:
    """One step of rank 0 on meta tensors over ``mesh_shape`` ((data,
    model) or (pod, data, model)): FLOPs, bytes and collectives per device,
    parameter and cache bytes, and the trace's wall seconds."""
    names = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    prod = mesh_lib.MeshShape(names, tuple(mesh_shape))
    n_data = 1
    for a in mesh_lib.data_axes(prod):
        n_data *= prod.shape[a]
    run_mesh = mesh_lib.shape_mesh(n_data, prod.shape["model"])
    model = build_model(cfg, "meta")
    specs = steps_lib.input_specs(model, shape, policy)
    with shlib.use_context(prod, launch_sharding.make_rules(cfg, prod)):
        pls = steps_lib.input_shardings(model, shape, prod, specs, policy)
    coords = {a: 0 for a in names}
    step_fn, arg_names = steps_lib.build_step(model, shape, policy,
                                              mesh=run_mesh)
    local = {k: _meta_local(specs[k], pls[k], coords) for k in arg_names
             if k not in ("seed", "block_start")}
    args = []
    for k in arg_names:
        if k in ("seed", "block_start"):
            args.append(0)
        elif k == "opt_state":
            args.append(dict(local[k], step=0))
        else:
            args.append(local[k])
    kw = {}
    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len
        kw["draw"] = (torch.empty((B, S), dtype=torch.int32, device="meta"),
                      torch.empty((B, S), dtype=torch.bool, device="meta"),
                      torch.empty((B, 1), dtype=torch.float32,
                                  device="meta"))
    counter = _ByteCounter()
    t0 = time.perf_counter()
    with mesh_lib.record_collectives() as colls, \
            FlopCounterMode(display=False) as flops, counter, \
            counter.kernel_scope():
        step_fn(*args, **kw)
    wall = time.perf_counter() - t0
    detail: Dict[str, Dict[str, float]] = {}
    for op, axis, nbytes in colls:
        d = detail.setdefault(f"{op}@{axis}", {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += nbytes
    return {
        "trace_s": wall,
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_per_device": float(counter.bytes),
        "aten_ops": counter.ops,
        "collective_bytes_per_device": float(sum(b for _, _, b in colls)),
        "collectives": detail,
        "collective_log": colls,
        "param_bytes_per_device": sharded_bytes(specs["params"],
                                                pls["params"], prod),
        "cache_bytes_per_device": (sharded_bytes(specs["cache"],
                                                 pls["cache"], prod)
                                   if "cache" in specs else 0.0),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             variant: str = "baseline",
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    """A cell's record (JAX's ``run_cell`` fields, with the port's
    peaks); ``mesh_shape`` overrides the production mesh."""
    cfg, policy = variant_config(arch, variant)
    shape = configs.SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = mesh_lib.make_production_mesh(multi_pod=multi_pod).sizes
    chips = 1
    for n in mesh_shape:
        chips *= n
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "x".join(map(str, mesh_shape)), "multi_pod": multi_pod,
           "kind": shape.kind, "chips": chips, "status": "error",
           "card": CARD}
    costs = trace_cell(cfg, shape, policy, tuple(mesh_shape))
    flops = costs["flops_per_device"]
    mf = model_flops(cfg, shape)
    costs.pop("collective_log")
    rec.update(costs)
    rec.update({
        "status": "ok",
        "roofline": {"compute_s": flops / PEAK_FLOPS,
                     "memory_s": costs["bytes_per_device"] / HBM_BW,
                     "collective_s": costs["collective_bytes_per_device"]
                     / LINK_BW},
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops * chips)) if flops else None,
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
                  "link_bytes_s": LINK_BW},
        "notes": [BYTES_NOTE, COLLECTIVE_NOTE],
    })
    terms = rec["roofline"]
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def cells(multi_pod_mode: str):
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[multi_pod_mode]
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        for shape in configs.applicable_shapes(cfg):
            for mp in pods:
                yield arch, shape, mp


def cell_tag(arch: str, shape: str, multi_pod: bool,
             variant: str = "baseline") -> str:
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    return tag if variant == "baseline" else f"{tag}__{variant}"


def run_and_record(arch: str, shape: str, multi_pod: bool,
                   variant: str = "baseline", out_dir: Path = RESULTS
                   ) -> dict:
    """``run_cell``, or on any exception the error record; written to
    ``out_dir``/<tag>.json."""
    t0 = time.perf_counter()
    try:
        rec = run_cell(arch, shape, multi_pod, variant=variant)
    except Exception as e:          # the cell's record says why
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "variant": variant, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_tag(arch, shape, multi_pod, variant)}.json"
     ).write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS) + sorted(NOT_PORTED))
    ap.add_argument("--out-dir", default=str(RESULTS))
    args = ap.parse_args(argv)
    if args.variant in NOT_PORTED:
        opts, same = NOT_PORTED[args.variant]
        ap.error(f"variant {args.variant}: the port has no {opts} option; "
                 f"it would trace as {same}")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    out_dir = Path(args.out_dir)
    todo = list(cells(args.multi_pod)) if args.all else [
        (args.arch, args.shape, args.multi_pod != "single")]
    for arch, shape, mp in todo:
        tag = cell_tag(arch, shape, mp, args.variant)
        out = out_dir / f"{tag}.json"
        if args.skip_existing and out.exists() and \
                json.loads(out.read_text()).get("status") == "ok":
            print(f"[skip] {tag}")
            continue
        print(f"[run ] {tag}", flush=True)
        rec = run_and_record(arch, shape, mp, args.variant, out_dir)
        print(f"[done] {tag}: {rec['status']} ({rec['wall_s']}s) "
              f"bottleneck={rec.get('bottleneck')}"
              + (f" {rec['error']}" if rec["status"] != "ok" else ""),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
