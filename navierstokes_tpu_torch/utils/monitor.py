"""Structured per-solve metrics (counterpart of
``navierstokes_tpu/utils/monitor.py``).

``SolverMonitor`` collects one record per solve -- iteration counts,
residuals, wall-clock -- and per time step, and serializes to JSON lines
for offline analysis.  Records may hold torch tensors: they are kept as
they are and read only when a record is asked for, so recording a residual
inside the step never waits for the device.
"""

from __future__ import annotations

import json
import time


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
    """Context manager recording a wall-clock span into a monitor."""

    def __init__(self, monitor: SolverMonitor, label: str, **fields):
        self.monitor = monitor
        self.label = label
        self.fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.monitor.record("timing", label=self.label,
                            seconds=time.perf_counter() - self._t0,
                            **self.fields)
        return False
