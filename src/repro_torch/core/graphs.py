"""CUDA graphs of fixed-shape steps: the port's counterpart of ``jax.jit``.

The JAX package jits its serving tick (``EngineConfig.jit_steps``), so a
tick is one dispatch.  Eager PyTorch launches each of a tick's ~2,400
kernels from Python, and the host then sets the tick's time.
``GraphedStep`` captures a callable once into a ``torch.cuda.CUDAGraph``
and replays it: one launch from the host per step.

A graph bakes in every device address and every scalar argument of the
work it captured, so a graphed step runs against static buffers.  The
tensors it is called with are its inputs by address: the caller writes
new values into the same tensors (``copy_``, ``fill_``) between calls, and
reads the outputs (tensors the graph owns, overwritten by the next replay)
before calling again.  Keyword arguments (the forward's ``cross_kv`` and
``image_embeds``) are inputs in the same way, by name.  Dicts and lists
(parameters, a KV cache) are bound by identity: their tensors must not be
rebound.  A call whose tensors
differ in shape, type or address, or whose other arguments differ, is a
new step and is captured anew, as ``jax.jit`` traces a new shape.  Each
captured step holds on to the arguments it was captured with, so no other
object can take their address or identity while its graph exists.

The first call of each such step runs eagerly on the capture stream: it
builds and loads the kernels it reaches (kernels/_build.py) and lets the
libraries it calls set up, which a capture cannot.  The capture follows,
and every later call replays.  Its results are copied into the graph's
output tensors, so every call of a step, the first included, returns the
same tensors: a step that consumes another's output then sees one address
and captures once.  A capture that fails raises: nothing falls back to
eager.  Graphs given one ``pool`` (``torch.cuda.graph_pool_handle()``)
share its memory; they must then run one after another on one stream, as
the steps of one generation do.  The kernels' launch
counts (``_build.launch_counts``) count what runs on the card, so the
counts a capture adds are taken back out and added again at each replay.

Only CUDA tensors are graphed; with CPU tensors the step simply runs.
A graphed call raises while a trace is recorded (sim/trace.py): a replay
runs no Python, so it would record nothing; trace an eager call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.sim import trace as trace_lib


def _flat_tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _flat_tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _flat_tensors(o)]
    return []


def _key_of(arg) -> Hashable:
    """What a step's captured graph depends on in one argument."""
    if isinstance(arg, torch.Tensor):
        return ("tensor", arg.data_ptr(), tuple(arg.shape), arg.dtype,
                arg.device)
    if isinstance(arg, (dict, list)):
        return ("bound", id(arg))
    if isinstance(arg, tuple):
        return tuple(_key_of(a) for a in arg)
    return ("value", arg)


def _device_of(args) -> Optional[torch.device]:
    for t in _flat_tensors(list(args)):
        return t.device
    return None


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    args: tuple           # kept alive: the key holds their ids and addresses
    kw: dict
    outputs: Any
    launches: Dict[str, int]


class GraphedStep:
    """``fn`` captured as a CUDA graph per distinct call (see the module
    note) and replayed, its graphs in memory ``pool`` (None: a private pool
    each).  ``captures`` and ``replays`` count both."""

    def __init__(self, fn: Callable[..., Any], pool=None):
        self.fn = fn
        self.pool = pool
        self._graphs: Dict[Hashable, _Captured] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kw):
        dev = _device_of(args + tuple(kw.values()))
        if dev is None or dev.type != "cuda":
            return self.fn(*args, **kw)
        if trace_lib.is_active():
            raise RuntimeError("a trace is being recorded: a graphed step "
                               "records nothing at replay; trace an eager "
                               "call (jit_steps=False)")
        key = (tuple(_key_of(a) for a in args),
               tuple((name, _key_of(kw[name])) for name in sorted(kw)))
        cap = self._graphs.get(key)
        if cap is None:
            return self._run_and_capture(key, dev, args, kw)
        cap.graph.replay()
        _build.add_launch_counts(cap.launches)
        self.replays += 1
        return cap.outputs

    def _run_and_capture(self, key, dev: torch.device, args, kw):
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, main = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*args, **kw)       # eager: this call's results
        main.wait_stream(side)
        for t in _flat_tensors(out):
            t.record_stream(main)
        before = dict(_build.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            outputs = self.fn(*args, **kw)
        launches = {name: n - before[name]
                    for name, n in _build.launch_counts.items()}
        _build.launch_counts.update(before)  # captured, not launched
        self._graphs[key] = _Captured(graph, args, kw, outputs, launches)
        self.captures += 1
        for static, value in zip(_flat_tensors(outputs), _flat_tensors(out)):
            if static is not value:          # (an input returned as is)
                static.copy_(value)
        return outputs
