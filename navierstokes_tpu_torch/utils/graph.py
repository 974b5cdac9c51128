"""A chunk of steps in one launch: the port's counterpart of ``bench.py``'s
``lax.scan`` loop (CHUNK steps in one jitted program, one device dispatch
per chunk).

``ChunkLoop(step_fn, state, n, device)`` advances ``state`` -- a tuple,
list or NamedTuple of tensors, nested as the step needs -- by ``n`` calls
``state = step_fn(state)`` each time :meth:`ChunkLoop.run` is called.

* **On a CUDA device** the constructor copies the state into static
  buffers, runs a warm-up step on a side stream of its own (so that every
  lazy first-use action -- a kernel's shared-memory opt-in, a plan cache,
  a scratch buffer -- happens outside the capture; the warm-up's result is
  dropped), and then captures ``n`` steps on that stream as one
  ``torch.cuda.CUDAGraph``, the copy of the last step's state back into
  the static buffers included.  :meth:`run` is one ``graph.replay()``.
  Coefficients that the step takes as Python numbers are baked into the
  graph, as ``lax.scan`` bakes them into its jitted body.  The graph and
  its private memory pool (every tensor the steps allocate) live as long
  as the loop object.
* **On the CPU**, asked for explicitly, :meth:`run` takes the ``n`` steps
  eagerly: the plain version of the graph.

A captured step must not read the device on the host (``item()``,
``float()`` of a tensor -- e.g. a solve with a residual tolerance).  The
capture runs under torch's sync debug mode ``"error"``, and the CPU loop
refuses ``aten._local_scalar_dense`` inside a chunk, so such a step raises
:class:`CaptureError` on both.  A failed capture raises; nothing falls
back to eager steps on the card.

The band kernels' launch counts (``cuda_band.LAUNCHES``) grow where a
wrapper launches a kernel, so on the card they count the launches of the
warm-up step and of the capture, never of a replay: the loop reports
``captured_launches`` (per chunk) and ``replays``.

The capture is traced (``utils/monitor.py``): the spans ``graph.warmup``
(the side-stream step), ``graph.record`` (the ``n`` steps enqueued under
capture) and ``graph.instantiate``, also kept as :attr:`warmup_seconds`,
:attr:`record_seconds` and :attr:`instantiate_seconds`
(:attr:`capture_seconds` is their sum plus the copies and the
synchronisations), and :attr:`nodes`, the captured graph's node count,
also added to the counter ``graph``/``nodes``.  While a profiler records,
:meth:`run` is a ``chunk.replay`` range.  :meth:`phase_ms` times the
phases of a step (``monitor.phase``) from marks in a second, short graph.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.utils import monitor


class CaptureError(RuntimeError):
    """A chunk of steps could not be captured (on the CPU: would not be)."""


_HOST_READ = ("a captured step must not read the device on the host "
              "(item(), float() or bool() of a tensor, a copy to the host): "
              "a solve with a residual tolerance (cg_rtol) does")


class _NoHostReads(TorchDispatchMode):
    """Raises on the op behind every scalar read of a tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise CaptureError(f"ChunkLoop: {_HOST_READ}")
        return func(*args, **(kwargs or {}))


def _storages(leaves):
    return {t.untyped_storage().data_ptr() for t in leaves}


@functools.lru_cache(maxsize=None)
def _cu_graph_get_nodes():
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


def _node_count(graph):
    """Nodes of a captured graph kept by torch (``keep_graph=True``), by
    ``cuGraphGetNodes`` of libcuda."""
    count = ctypes.c_size_t(0)
    err = _cu_graph_get_nodes()(graph.raw_cuda_graph(), None,
                                ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {err})")
    return int(count.value)


class PhaseTimes(NamedTuple):
    """:meth:`ChunkLoop.phase_ms`'s result: ``phases``, ``{phase: ms per
    step}``, and ``step_ms``, the marked steps' ms per step as a whole."""
    phases: dict
    step_ms: float


class ChunkLoop:
    """``n`` steps of ``step_fn`` per :meth:`run`: one CUDA graph replay on
    the card, ``n`` eager steps on the CPU.

    ``state`` is the initial state, on ``device`` (default: the card; the
    CPU only with ``device="cpu"``); ``step_fn(state)`` returns the next
    state with the same structure, shapes and dtypes.  :attr:`state` is
    the state after the last chunk: on the card the static buffers
    themselves, overwritten by the next :meth:`run`.
    """

    def __init__(self, step_fn, state, n, device=None):
        if int(n) < 1:
            raise ValueError(f"a chunk takes n >= 1 steps, got {n}")
        self.n = int(n)
        self.device = config.require_device(device)
        self.step_fn = step_fn
        leaves, self._spec = pytree.tree_flatten(state)
        for t in leaves:
            if not torch.is_tensor(t):
                raise TypeError(f"state leaves must be tensors, got "
                                f"{type(t).__name__}")
            if t.device.type != self.device.type:
                raise ValueError(f"state tensor on {t.device}, loop on "
                                 f"{self.device}")
        self._layout = [(t.shape, t.dtype) for t in leaves]
        self.replays = 0
        self.captured_launches = None
        self.capture_seconds = None
        self.warmup_seconds = self.record_seconds = None
        self.instantiate_seconds = self.nodes = None
        self.graph = None
        if self.device.type == "cuda":
            self._capture(leaves)
        else:
            self.state = state

    def _leaves_of(self, state):
        leaves, spec = pytree.tree_flatten(state)
        if spec != self._spec:
            raise ValueError(f"step_fn changed the state's structure: "
                             f"{spec} != {self._spec}")
        for got, (shape, dtype) in zip(leaves, self._layout):
            if got.shape != shape or got.dtype != dtype:
                raise ValueError(f"step_fn changed a state tensor from "
                                 f"{tuple(shape)} {dtype} to "
                                 f"{tuple(got.shape)} {got.dtype}")
        return leaves

    def _capture(self, leaves):
        t0 = time.perf_counter()
        dev = leaves[0].device if leaves else self.device
        with torch.cuda.device(dev):
            self._static = [t.clone() for t in leaves]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with monitor.span("graph.warmup") as warmup:
                with torch.cuda.stream(side):
                    self._leaves_of(self.step_fn(
                        pytree.tree_unflatten(self._static, self._spec)))
                side.synchronize()
            before = dict(cuda_band.LAUNCHES)
            with monitor.span("graph.record") as record:
                graph = self._captured(self._record_chunk, self.n, side)
            self.nodes = _node_count(graph)
            monitor.counters("graph", ("nodes",))["nodes"] += self.nodes
            with monitor.span("graph.instantiate") as instantiate:
                graph.instantiate()
            torch.cuda.synchronize()
        self.graph = graph
        self.captured_launches = {k: cuda_band.LAUNCHES[k] - before[k]
                                  for k in before}
        self.state = pytree.tree_unflatten(self._static, self._spec)
        self.warmup_seconds = warmup.seconds
        self.record_seconds = record.seconds
        self.instantiate_seconds = instantiate.seconds
        self.capture_seconds = time.perf_counter() - t0

    @staticmethod
    def _captured(body, n, stream):
        """The graph of what ``body()`` (``n`` steps) enqueues, captured on
        ``stream`` and kept, not yet instantiated; a capture that fails
        raises :class:`CaptureError`."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, stream=stream):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    body()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except RuntimeError as exc:
            raise CaptureError(
                f"ChunkLoop: capturing {n} steps on {stream.device} failed "
                f"({exc}); note that {_HOST_READ}") from exc
        return graph

    def _record_chunk(self):
        """``n`` steps from the static buffers, and the copy of the last
        step's state into them (the body of the capture)."""
        state = pytree.tree_unflatten(self._static, self._spec)
        for _ in range(self.n):
            state = self.step_fn(state)
        # a state tensor that is still an input buffer (n = 1: the old
        # state handed on) is read before any buffer is overwritten
        inputs = _storages(self._static)
        out = [t.clone() if t.untyped_storage().data_ptr() in inputs else t
               for t in self._leaves_of(state)]
        for dst, src in zip(self._static, out):
            dst.copy_(src)

    def run(self):
        """Advance the state by one chunk of ``n`` steps; returns
        :attr:`state`."""
        with monitor.annotate("chunk.replay"):
            if self.graph is not None:
                self.graph.replay()
            else:
                state = self.state
                with _NoHostReads():
                    for _ in range(self.n):
                        state = self.step_fn(state)
                self._leaves_of(state)
                self.state = state
        self.replays += 1
        return self.state

    def phase_ms(self, replays=3, steps=5):
        """Time of each phase of a step (``utils/monitor.phase``: the four
        phases of the step, ``amg.vcycle`` where the step has one) in ms
        per step, as a :class:`PhaseTimes`.

        On the card ``steps`` steps from copies of the current state are
        captured as a second graph with device marks on (a timing event at
        each phase boundary, an event node of the graph), which is
        replayed once (dropped) and then ``replays`` times, each between
        two events of its own (``step_ms``), and freed.  On the CPU
        ``replays`` chunks of ``steps`` eager steps from the same copies
        are timed by the host clock after one dropped chunk.  The loop's
        graph, state, counts and ``cuda_band.LAUNCHES`` are left as they
        were."""
        if self.graph is None:
            return self._phase_ms_eager(replays, steps)
        dev = self._static[0].device
        with torch.cuda.device(dev):
            inputs = [t.clone() for t in self._static]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())

            def body():
                state = pytree.tree_unflatten(inputs, self._spec)
                for _ in range(steps):
                    state = self.step_fn(state)

            launches = dict(cuda_band.LAUNCHES)
            with monitor.device_marks(dev) as marks:
                graph = self._captured(body, steps, side)
            cuda_band.LAUNCHES.update(launches)
            graph.instantiate()
            graph.replay()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            total, step_ms = {}, 0.0
            for _ in range(replays):
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                step_ms += start.elapsed_time(end)
                for name, ms in marks.ms().items():
                    total[name] = total.get(name, 0.0) + ms
            graph.reset()
        n = replays * steps
        return PhaseTimes({k: v / n for k, v in total.items()}, step_ms / n)

    def _phase_ms_eager(self, replays, steps):
        inputs = pytree.tree_map(torch.clone, self.state)

        def chunk():
            state = inputs
            for _ in range(steps):
                state = self.step_fn(state)

        chunk()
        with monitor.device_marks(self.device) as marks:
            t0 = time.perf_counter()
            for _ in range(replays):
                chunk()
            seconds = time.perf_counter() - t0
        n = replays * steps
        return PhaseTimes({k: v / n for k, v in marks.ms().items()},
                          1e3 * seconds / n)
