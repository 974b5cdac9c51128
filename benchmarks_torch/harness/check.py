"""The comparison that decides ``correct``.

For each block that the window kept, the plain reference of the
configuration's problem (``problems/<problem>.py`` names it; float64)
runs the same number of steps from the block's input state as the program
left it, and the program's output is held against the reference's.  Two
numbers are read, each the worst over the kept blocks, and those the
workload gives a limit for are compared:

* ``du_gap`` = ||u_prog - u_ref|| / ||u_ref - u_in||, the 2-norm of the
  velocity difference over the 2-norm of the reference's change in the
  block;
* ``dp_gap``, the same for the pressure.

Relative to the change and not to the state, a step that returns its
input reads 1 however slowly the flow moves.  The problem's own guards
(``problems/<problem>.py::guards``) are compared as well, with
``finite``, on the state after the last block.

The control (``control_gaps``) puts the reference computed in bfloat16,
or the program's own step with TF32 matmuls, in the program's place."""

from __future__ import annotations

import math

import torch

from harness.spec import load_problem


def reference_step(cfg, wl, device, dtype=torch.float64, grid=None):
    problem = load_problem(cfg)
    solves = {k: tuple(v) for k, v in wl["reference_solves"].items()}
    return problem.reference_step(cfg, grid or problem.reference_grid(cfg),
                                  solves, dtype, device)


def _gap(got, want, start):
    change = torch.linalg.vector_norm(want - start)
    return float(torch.linalg.vector_norm(got - want) / change)


def block_gaps(ref, stepper, pair, outputs=None):
    """``(du_gap, dp_gap)`` of one kept block; ``outputs`` replaces the
    program's output state (the control)."""
    _, inp, out, _ = pair
    start = stepper.reference_state(inp)
    got = outputs if outputs is not None else stepper.reference_state(out)
    u, _, p, _ = ref.run(start, stepper.block_steps)
    u, p = u.double(), p.double()
    return (_gap(got[0].double(), u, start[0]),
            _gap(got[2].double(), p, start[2]))


def guards(cfg, stepper, state, steps):
    """``finite`` and the problem's guards on ``state`` (reference
    layout), ``steps`` steps from the initial state, as
    ``{name: value}``."""
    out = {"finite": float(bool(torch.isfinite(state[0]).all())
                           and bool(torch.isfinite(state[2]).all()))}
    out.update(load_problem(cfg).guards(cfg, stepper.lattice, state, steps))
    return out


def _worst(gaps):
    """The largest gap; NaN when any is NaN."""
    return max(gaps, key=lambda g: (math.isnan(g), g))


def _gaps(ref, stepper, pairs, names, outputs=None, rows=None):
    """The worst of each gap in ``names`` over ``pairs``; ``rows``, a
    list, receives ``[block, trajectory, du_gap, dp_gap]`` per block."""
    got = []
    for pair in pairs:
        du, dp = block_gaps(ref, stepper, pair,
                            None if outputs is None else outputs(pair))
        got.append((du, dp))
        if rows is not None:
            rows.append([pair[0], pair[3], du, dp])
    worst = {"du_gap": _worst([g[0] for g in got]),
             "dp_gap": _worst([g[1] for g in got])}
    return {k: worst[k] for k in names}


def compare(cfg, wl, stepper, pairs, device):
    """``(values, limits)`` of every compared number.  The gaps compared
    are those the workload gives limits for; the guards read the last kept
    block's output, ``pairs[-1][3]`` steps into its flow."""
    limits = dict(wl["limits"])
    limits.update(cfg["guards"])
    ref = reference_step(cfg, wl, device)
    values = _gaps(ref, stepper, pairs, wl["limits"])
    values.update(guards(cfg, stepper, stepper.reference_state(
        pairs[-1][2]), pairs[-1][3]))
    limits["finite"] = 1.0
    return values, limits


def program_gaps(cfg, wl, stepper, pairs, device, rows=None):
    """Both gaps of the program, compared or not (for ``control.py``)."""
    return _gaps(reference_step(cfg, wl, device), stepper, pairs,
                 ("du_gap", "dp_gap"), rows=rows)


def passed(values, limits):
    """Every number within its limit (``finite`` must equal 1)."""
    for name, value in values.items():
        if name == "finite":
            if value != 1.0:
                return False
        elif not value <= limits[name]:
            return False
    return True


def control_gaps(cfg, wl, stepper, pairs, device, rows=None):
    """The control's ``du_gap`` and ``dp_gap`` on the same blocks: the
    workload's ``control`` is ``bfloat16`` (the reference in bfloat16) or
    ``tf32`` (the program's step run eagerly with TF32 matmuls)."""
    kind = wl["control"]
    grid = load_problem(cfg).reference_grid(cfg)
    ref = reference_step(cfg, wl, device, grid=grid)
    if kind == "bfloat16":
        low = reference_step(cfg, wl, device, dtype=torch.bfloat16,
                             grid=grid)

        def outputs(pair):
            return low.run(stepper.reference_state(pair[1]),
                           stepper.block_steps)
    elif kind == "tf32":
        def outputs(pair):
            before = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return stepper.reference_state(stepper.run_eager(pair[1]))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = before
    else:
        raise ValueError(f"unknown control {kind!r}")
    return _gaps(ref, stepper, pairs, ("du_gap", "dp_gap"), outputs, rows)
