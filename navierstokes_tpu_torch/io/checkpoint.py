"""Checkpoint / resume of transient solver state (counterpart of
``navierstokes_tpu/io/checkpoint.py``).

The full restartable state -- solution ring, the projection solver's
velocity history and pressure increment, and the discrete-time
bookkeeping -- round-trips through a single ``.npz`` with the JAX
package's keys, so a file written by either package loads into the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(path: str, solver, time_stepping) -> None:
    data = {
        "current_time": time_stepping.current_time,
        "previous_time": time_stepping.previous_time,
        "next_time": time_stepping.next_time,
        "step_number": time_stepping.step_number,
    }
    # variable-step BDF coefficient state: without the lagged ratios and
    # the current alpha tables, the first step after a resume of a
    # variable-step run would recompute its weights from a ratio of 1
    if hasattr(time_stepping, "_ratios"):
        data["bdf_ratios"] = np.asarray(time_stepping._ratios)
        data["bdf_alpha_1"] = np.asarray(time_stepping._alpha[1])
        data["bdf_alpha_2"] = np.asarray(time_stepping._alpha[2])
        data["bdf_changed"] = np.asarray(
            [time_stepping._changed[1], time_stepping._changed[2]])
    for i, sol in enumerate(solver._solutions):
        data[f"solution_{i}"] = _to_numpy(sol)
    if hasattr(solver, "_phi"):
        # ProjectionSolver history: the BDF-2 velocity ring and the
        # pressure increment live outside ``_solutions``
        data["proj_u"] = _to_numpy(solver._u)
        data["proj_u_old"] = _to_numpy(solver._u_old)
        data["proj_u_old2"] = _to_numpy(solver._u_old2)
        data["proj_p"] = _to_numpy(solver._p)
        data["proj_phi"] = _to_numpy(solver._phi)
    np.savez(path, **data)


def load_checkpoint(path: str, solver, time_stepping) -> None:
    """Restore state saved by :func:`save_checkpoint` (same discretization)
    onto the solver's device in its dtype."""
    with np.load(path) as data:
        def dev(key):
            return torch.tensor(data[key], dtype=solver._dtype,
                                device=solver._device)

        solver._solutions = [dev(f"solution_{i}")
                             for i in range(len(solver._solutions))]
        if hasattr(solver, "_phi") and "proj_u" in data:
            solver._u = dev("proj_u")
            solver._u_old = dev("proj_u_old")
            solver._u_old2 = dev("proj_u_old2")
            solver._p = dev("proj_p")
            solver._phi = dev("proj_phi")
            solver._sync_state_from_canonical()
        ts = time_stepping
        ts._previous_time = float(data["previous_time"])
        ts._current_time = float(data["current_time"])
        ts._next_time = float(data["next_time"])
        ts._step_number = int(data["step_number"])
        if hasattr(ts, "_ratios") and "bdf_ratios" in data:
            ts._ratios = [float(r) for r in data["bdf_ratios"]]
            ts._alpha = {1: [float(a) for a in data["bdf_alpha_1"]],
                         2: [float(a) for a in data["bdf_alpha_2"]]}
            changed = data["bdf_changed"]
            ts._changed = {1: bool(changed[0]), 2: bool(changed[1])}
