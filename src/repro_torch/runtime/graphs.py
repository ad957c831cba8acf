"""Captured serve steps: the port's counterpart of ``jax.jit`` and its cache.

The continuous-batching engine's fixed-shape steps (select, reuse, chunk
and the fused decode windows) are functions of no arguments that read
static device buffers: the step inputs the host writes before each call
(``StepGraphs.input`` / ``StepGraphs.set``), the serve state and the token
feed. On the card each is warmed up once on a side stream, then captured
once as a ``torch.cuda.CUDAGraph`` and replayed from then on: one host
launch a step instead of thousands. The replay reads and writes the very
buffers it captured, so

  * a step writes every state field it changes into the static buffers:
    the caches in place, and the few fields a step rebinds (the (B,)
    lengths, the selection and the importance) by a copy at the step's end
    (``snapshot`` / ``commit``);
  * a step's inputs are copied into their static buffers from the host,
    ``non_blocking``, and only when they changed;
  * ``ops.LAUNCHES`` counts a kernel where it is launched: a capture
    launches nothing (the counts it added are taken back and kept as the
    graph's delta), each replay launches the whole graph (its delta is
    added);
  * the kernels' per-stream counters (``ops._COUNTERS``, ``ops._SCHEDULES``)
    are made during the warm-up on the capture stream, not inside a
    capture, and kept alive as long as the graphs;
  * no graph is destroyed during a capture: the garbage collector runs
    before it and not during it.

Eager execution on the card happens only when asked for (``eager=True``);
the CPU, which has no graphs, always runs the steps eagerly. A capture or
a replay that fails raises.

Under a GSPMD layout the steps gather over the ranks of a mesh
(``runtime/collectives``): the decode, chunk and verify steps, the tiered
select step's digest and the migration's row move. NCCL collectives are
captured inside the graphs; each axis group's communicator is made by a
collective before the first capture (the streaming draft's own graphs
warm the same groups again). A gloo group cannot be captured: the steps of a mesh over gloo on
the card refuse to capture, and the caller asks for ``eager=True``.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.kernels import ops

# the state fields a step may rebind: small, copied into the static
# buffers at the step's end. The KV pages, the τ bounds, the page starts
# and the ring are written in place and never copied whole
REBINDABLE = ("length", "sel_idx", "importance")

# the input buffers' dtypes
_NUMPY = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32}


def _fields(state: dict):
    """(holder, key) of every tensor of a serve state, in a fixed order."""
    yield state, "length"
    for layer in state["layers"]:
        for key in layer:
            for f in dataclasses.fields(layer[key]):
                yield layer[key], f.name


def _get(holder, key):
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, value) -> None:
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


def snapshot(state: dict) -> List[tuple]:
    """The tensors of ``state`` before a step: (holder, key, tensor)."""
    return [(h, k, _get(h, k)) for h, k in _fields(state)]


def commit(before: List[tuple], new: dict) -> List[str]:
    """Write the state ``new`` a step returned into the tensors ``before``
    held (``snapshot`` of the static state), and point the static state
    back at them. Returns the names of the fields copied; a field outside
    ``REBINDABLE`` that the step did not write in place raises."""
    copied = []
    for (h, k, old), (hn, kn) in zip(before, _fields(new)):
        cur = _get(hn, kn)
        if cur is old:
            continue
        if k not in REBINDABLE:
            raise RuntimeError(f"a serve step replaced the state field {k!r}: it "
                               f"must write it in place")
        old.copy_(cur)
        _set(h, k, old)
        copied.append(k)
    return copied


class StepGraphs:
    """The engine's steps on one device, captured or eager.

    ``input(name, shape, dtype)`` makes a static input buffer (zeros: every
    lane inactive, so the warm-up is a no-op on the state); ``add(name,
    fn)`` registers a step, and on the card warms it up and captures it;
    ``set(name=array, ...)`` copies host arrays into the input buffers;
    ``run(name)`` replays the step (or calls it) and returns its output,
    which a later run of the same step overwrites."""

    def __init__(self, device, *, eager: bool = False, mesh=None):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda" and not eager
        if self.capture and mesh is not None and mesh.backend == "gloo":
            raise ValueError("the steps of a mesh over gloo cannot be captured as "
                             "CUDA graphs (gloo collectives run on the host): pass "
                             "eager=True, or use an NCCL group")
        if self.capture and mesh is not None and mesh.backend is not None:
            from repro_torch.runtime import collectives

            collectives.warm_up(mesh, self.device)
        self._inputs: Dict[str, list] = {}   # name -> [buffer, host copy]
        self._steps: Dict[str, tuple] = {}   # name -> (fn, graph, output, delta)
        self.captures: Dict[str, int] = {}
        self.replays: Dict[str, int] = {}
        self._stream = torch.cuda.Stream(self.device) if self.capture else None
        self._keep: list = []

    def input(self, name: str, shape, dtype) -> torch.Tensor:
        buf = torch.zeros(shape, dtype=dtype, device=self.device)
        self._inputs[name] = [buf, None]
        return buf

    def set(self, **arrays) -> None:
        """Copy host arrays into the named input buffers, each only when it
        differs from what the buffer holds. ``non_blocking``: a blocking
        copy from host memory would wait for the card's queue."""
        for name, a in arrays.items():
            entry = self._inputs[name]
            buf, last = entry
            a = np.ascontiguousarray(a, dtype=_NUMPY[buf.dtype])
            if last is not None and np.array_equal(last, a):
                continue
            a = a.copy()
            buf.copy_(torch.from_numpy(a), non_blocking=True)
            entry[1] = a

    def add(self, name: str, fn: Callable) -> None:
        self.replays[name] = 0
        if not self.capture:
            self._steps[name] = (fn, None, None, None)
            self.captures[name] = 0
            return
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            fn()  # warm-up: builds the kernels, makes the stream's counters
        cur.wait_stream(self._stream)
        self._keep += list(ops._COUNTERS.values()) + list(ops._SCHEDULES.values())
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        # a graph destroyed while this one captures invalidates the capture:
        # an older engine left in a reference cycle holds graphs that the
        # cyclic collector may free at any allocation (torch.cuda.graph no
        # longer collects first), so collect now and not again until the end
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        delta = {k: ops.LAUNCHES[k] - before[k] for k in before}
        ops.LAUNCHES.update(before)  # a capture launches nothing
        self._steps[name] = (fn, graph, out, delta)
        self.captures[name] = self.captures.get(name, 0) + 1

    def run(self, name: str):
        fn, graph, out, delta = self._steps[name]
        if graph is None:
            return fn()
        graph.replay()
        for k, n in delta.items():
            ops.LAUNCHES[k] += n
        self.replays[name] += 1
        return out
