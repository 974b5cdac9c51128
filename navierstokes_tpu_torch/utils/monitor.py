"""Structured per-solve metrics and the port's tracing (counterpart of
``navierstokes_tpu/utils/monitor.py``, which has the first part only).

``SolverMonitor`` collects one record per solve -- iteration counts,
residuals, wall-clock -- and per time step, and serializes to JSON lines
for offline analysis.  Records may hold torch tensors: they are kept as
they are and read only when a record is asked for, so recording a residual
inside the step never waits for the device.

The tracing is one process-wide registry, read by the benchmark and by
``chip_smoke.py``:

* :func:`span` (and the decorator :func:`spanned`) -- host seconds of
  set-up- and capture-scale work (never per kernel), kept per name in
  :data:`SPANS`: ``count``, ``total`` and ``last``, the latest build
  (records made for one owner in a row add up).  While a
  ``torch.profiler`` records, a span is also a ``record_function``
  range, on the profiler's clock with the device's activity (and an NVTX
  range under ``emit_nvtx``).
* :func:`phase` -- a part of a step's device work.  With no profiler
  recording and no device marks on it is one shared null context and
  records nothing; under a profiler it is a ``record_function`` range;
  under :func:`device_marks` it marks its boundaries (timing CUDA events,
  which become event nodes of a graph being captured, or the host clock
  on the CPU).  The steps' phases are ``convection``,
  ``helmholtz``, ``poisson`` and ``correction``, covering a step whole;
  ``amg.vcycle`` runs inside ``poisson``.
* :func:`counters` -- named groups of integer counters in
  :data:`COUNTERS` that code increments in place
  (``cuda_band.LAUNCHES`` is the group ``"cuda_band.launches"``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
import weakref

import torch
from torch.autograd import profiler as _autograd_profiler


def _materialize(entry):
    """Convert lazily recorded tensors/arrays to plain floats.

    Hot-loop callers record device tensors without blocking (a per-step
    ``float()`` is a host-device synchronisation); the conversion happens
    here, at read time.
    """
    out = {}
    for key, val in entry.items():
        if hasattr(val, "ndim") and hasattr(val, "dtype"):
            if hasattr(val, "detach"):
                val = val.detach().cpu()
            out[key] = float(val) if val.ndim == 0 else \
                [float(v) for v in val]
        else:
            out[key] = val
    return out


class SolverMonitor:
    """Append-only event log attached to a solver instance."""

    def __init__(self):
        self.records = []

    def record(self, kind: str, **fields) -> None:
        entry = {"kind": kind, "wall_time": time.time()}
        entry.update(fields)
        self.records.append(entry)

    # -- convenience --------------------------------------------------------
    def nonlinear_solves(self):
        return [_materialize(r) for r in self.records
                if r["kind"] == "nonlinear_solve"]

    def total_iterations(self) -> int:
        return sum(r.get("iterations", 0) for r in self.nonlinear_solves())

    def last(self, kind: str = None):
        if kind is None:
            return _materialize(self.records[-1]) if self.records else None
        for r in reversed(self.records):
            if r["kind"] == kind:
                return _materialize(r)
        return None

    def summary(self) -> dict:
        solves = self.nonlinear_solves()
        if not solves:
            return {"nonlinear_solves": 0}
        return {
            "nonlinear_solves": len(solves),
            "total_iterations": self.total_iterations(),
            "mean_iterations": self.total_iterations() / len(solves),
            "max_final_residual": max(r.get("residual", 0.0)
                                      for r in solves),
        }

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for r in self.records:
                fh.write(json.dumps(_materialize(r)) + "\n")


class timed_region:
    """Context manager recording a wall-clock span into a monitor: a
    :func:`span` named ``label`` whose seconds also go into the monitor's
    ``"timing"`` record."""

    def __init__(self, monitor: SolverMonitor, label: str, **fields):
        self.monitor = monitor
        self.label = label
        self.fields = fields

    def __enter__(self):
        self._span = span(self.label)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self.monitor.record("timing", label=self.label,
                            seconds=self._span.seconds, **self.fields)
        return False


# ---------------------------------------------------------------------------
# the tracing registry
# ---------------------------------------------------------------------------

class SpanStats:
    """The record of one span name: ``count`` and ``total`` seconds over
    the process, and ``last``, the seconds of the latest build: records
    made in a row for one owner add up, any other record starts anew."""

    __slots__ = ("count", "total", "last", "_owner")

    def __init__(self):
        self.count, self.total, self.last = 0, 0.0, 0.0
        self._owner = None

    def add(self, seconds, owner):
        same = owner is not None and self._owner is not None \
            and self._owner() is owner
        self.count += 1
        self.total += seconds
        self.last = self.last + seconds if same else seconds
        self._owner = None if owner is None else weakref.ref(owner)


SPANS: dict[str, SpanStats] = {}
COUNTERS: dict[str, dict[str, int]] = {}
_OPEN: dict[str, int] = {}      # depth of each open span name
_NULL = contextlib.nullcontext()
_MARKS = None                   # the active PhaseMarks


def annotate(name):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


class span:
    """``with span(name, owner=None):`` adds the body's host seconds to
    ``SPANS[name]`` (a span nested in one of its own name counts once, in
    the outer one); ``owner`` is the object the work is for, so that the
    parts of one build add up in ``last``.  :attr:`seconds` holds the
    body's seconds after it."""

    __slots__ = ("name", "owner", "seconds", "_range", "_t0")

    def __init__(self, name, owner=None):
        self.name, self.owner, self.seconds = name, owner, None

    def __enter__(self):
        _OPEN[self.name] = _OPEN.get(self.name, 0) + 1
        self._range = annotate(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        depth = _OPEN.pop(self.name) - 1
        if depth:
            _OPEN[self.name] = depth
        else:
            SPANS.setdefault(self.name, SpanStats()).add(self.seconds,
                                                          self.owner)
        return False


def spanned(name, owner=None):
    """Decorator: every call of the function is a :func:`span` ``name``;
    ``owner(*args, **kwargs)``, if given, gives the span's owner."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            who = None if owner is None else owner(*args, **kwargs)
            with span(name, who):
                return fn(*args, **kwargs)
        return traced
    return wrap


def latest(name):
    """Seconds of the latest build of span ``name``, or None."""
    stats = SPANS.get(name)
    return None if stats is None else stats.last


def counters(group, names):
    """The counters of ``group`` (made at 0 for ``names`` on first use):
    a dict the counting code increments in place."""
    return COUNTERS.setdefault(group, dict.fromkeys(names, 0))


def reset():
    """Forget every span and zero every counter (in place)."""
    SPANS.clear()
    for group in COUNTERS.values():
        for name in group:
            group[name] = 0


class PhaseMarks:
    """Marks at the boundaries of every :func:`phase` entered while it is
    on (:func:`device_marks`): timing CUDA events recorded on the current
    stream (event nodes of a graph being captured), or host-clock readings
    on the CPU.  A phase entered at the top level right after another
    ended starts at that one's end mark (the steps' phases cover them
    whole, so a boundary takes one mark); a nested phase marks its own
    start and end."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []
        self._depth = 0
        self._end = None        # the last top-level phase's end mark

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event

    @contextlib.contextmanager
    def phase(self, name):
        top = self._depth == 0
        start = self._end if top and self._end is not None else \
            self._mark()
        self._end = None
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            end = self._mark()
            self.marks.append((name, start, end))
            self._end = end if top else None

    def ms(self):
        """``{phase: milliseconds}`` between each phase's marks, summed
        over its entries (on a card, once the marked work has run)."""
        out = {}
        for name, start, end in self.marks:
            ms = start.elapsed_time(end) if self.cuda else \
                1e3 * (end - start)
            out[name] = out.get(name, 0.0) + ms
        return out


@contextlib.contextmanager
def device_marks(device):
    """Turns marks at phase boundaries on for the body; yields the
    :class:`PhaseMarks` that holds them."""
    global _MARKS
    if _MARKS is not None:
        raise RuntimeError("device marks are already on")
    _MARKS = PhaseMarks(device)
    try:
        yield _MARKS
    finally:
        _MARKS = None


def phase(name):
    """Context of one phase of a step's device work: marked under
    :func:`device_marks`, a profiler range while a profiler records, else
    the shared null context."""
    if _MARKS is not None:
        return _MARKS.phase(name)
    return annotate(name)
