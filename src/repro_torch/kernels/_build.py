"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with nvcc for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` under
the repository root.  The hash covers the source, the shared header and the
flags, so an edited source rebuilds at its next use and an unchanged one
loads as it is.  Nothing here runs at import time: the CPU tests import
every module and have no nvcc.

Every kernel wrapper adds one to ``launch_counts[name]`` where it launches
its kernel, and nowhere else (``ROUTES`` name two entries counted apart
from their library's); ``chip_smoke.py`` zeroes the counts before it
drives the main path and reads them after.  A wrapper called while a CUDA
graph is captured launches nothing then: core/graphs.py takes the counts
the capture added back out and adds them at every replay instead.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("fused_head_sampling", "topk_mask", "flash_bidir",
           "baos_mx_quant", "stablemax_sampling", "flash_bidir_bwd")
# entries of those libraries counted apart, each named for its route: the
# fused head's vocab-shard entry (route A, the SPMD tick), attention over a
# second K/V source (route B, the split cache's refine) and Stable-Max's
# vocab-shard entry (route C, the decode step's sharded logit columns); a
# sampled launch of route A or C (temperature > 0: the Gumbel partials)
# counts apart from the greedy one; attention over the cache alone whose
# mask reads its query offset from device memory, causal attention and its
# backward, and attention with bf16 scores and its backward, whatever
# their route (kernels/flash_bidir.count_name); the cached forward's
# attention backward with BAOS, over route B's two sources or with a
# device query offset (kernels/flash_bidir.bwd_count_name); and the
# backward of baos_mx_quant, an entry of its library
ROUTES = {"fused_head_sampling_shard": "fused_head_sampling",
          "flash_bidir_split": "flash_bidir",
          "stablemax_sampling_shard": "stablemax_sampling",
          "fused_head_sampling_shard_sampled": "fused_head_sampling",
          "stablemax_sampling_shard_sampled": "stablemax_sampling",
          "flash_bidir_offset": "flash_bidir",
          "flash_bidir_causal": "flash_bidir",
          "flash_bidir_bwd_causal": "flash_bidir_bwd",
          "flash_bidir_bf16s": "flash_bidir",
          "flash_bidir_bwd_bf16s": "flash_bidir_bwd",
          "flash_bidir_bwd_baos": "flash_bidir_bwd",
          "flash_bidir_bwd_split": "flash_bidir_bwd",
          "flash_bidir_bwd_offset": "flash_bidir_bwd",
          "baos_mx_quant_bwd": "baos_mx_quant"}
COUNTED = KERNELS + tuple(ROUTES)
# no --use_fast_math: the MX exponent rule and the Gumbel log need the
# full-precision log2f/logf, and divisions must stay IEEE divisions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# devices whose tensors a wrapper sends to its kernel's plain version: the
# CPU, and meta, where the plain version computes shapes only (the trace
# capture of sim/trace.py); a CUDA tensor goes to the kernel or raises
PLAIN_DEVICES = ("cpu", "meta")

launch_counts: Dict[str, int] = {name: 0 for name in COUNTED}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counts: what a replayed CUDA graph launches,
    recorded once when it was captured (core/graphs.py)."""
    for name, n in delta.items():
        launch_counts[name] += n


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every source in ``names`` whose library is missing, one nvcc
    process per source, all started together.  Returns each compiler log
    (empty for a library that was already built); raises with the log of
    the first source that fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)      # atomic: a concurrent loader never
            #                           sees a half-written library
    if failed:
        raise RuntimeError(f"nvcc failed for {failed[0]}:\n{logs[failed[0]]}")
    return logs


def function(name: str, symbol: str, argtypes: Iterable) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name`` (built on
    first use), with its argument types set and an int (cudaError_t)
    result."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """The number of SMs of CUDA device ``dev`` (the kernels' grid plans)."""
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def ptr(t) -> Optional[int]:
    """A tensor's device address for a ``c_void_p`` argument; None -> null."""
    return None if t is None else t.data_ptr()


def refuse_grad(name: str, *tensors) -> None:
    """Raise where kernel ``name``, which has no backward, would cut an
    autograd graph: grad mode is on and one of ``tensors`` (None allowed)
    requires grad.  Its output would carry no ``grad_fn``, so a
    ``backward()`` through it would quietly skip it.  The wrappers call
    this on their kernel route only: on the CPU their plain versions stay
    differentiable."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            f"tensors that do not require grad")


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        lib = _libs[name]
        msg = getattr(lib, f"{name}_error_string")
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({msg(err).decode()})")
