"""``ProjectionSolver.captured_step`` on the DFG 2D-2 mesh at resolution 1,
float64, on the CPU: the step that ``utils/graph.ChunkLoop`` captures on
the card, run here eagerly by the loop (which refuses host reads).

* Five captured steps equal five ``solve()`` steps bit for bit (u, u_old,
  p, phi), and the force they carry equals ``boundary_reaction_force``
  after the last one.  The step is 2^-8, so that the time levels and the
  ratio of successive steps are exact and ``solve()``'s weights are the
  constant-step ones that the captured step fixes.
* The capture refuses a residual tolerance (``cg_rtol``), an inflow
  declared as a function of the time (DFG 2D-3's pulsating one) and a
  solver that has not taken its first step.
* The counters of the AMG's V-cycles and of the unstructured operators'
  applies read what the step does: one V-cycle per Poisson iteration and
  one more, and every apply of the velocity operators and couplings."""

import numpy as np
import pytest
import torch

from navierstokes_tpu_torch.assembly.fastop import (AffineBand,
                                                    CirculantBand, GatherOp)
from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.mesh import channel_with_cylinder
from navierstokes_tpu_torch.solvers import ProjectionSolver
from navierstokes_tpu_torch.timestepping import BDFTimeStepping
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.graph import ChunkLoop

H = 4.1
DT = 2.0 ** -8
CG_ITERS = (40, 40, 20)


def steady_inflow(x):
    s = x[:, 1] / H
    return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)


def pulsating_inflow(x, t=0.0):
    """DFG 2D-3: the inflow scaled by sin(pi t / 8) (declared as the demo
    declares it; set-up evaluates it at t None)."""
    t = 0.0 if t is None else t
    return np.sin(np.pi * t / 8.0) * steady_inflow(x)


@pytest.fixture(scope="module")
def dfg_mesh():
    return channel_with_cylinder(1.0)


def dfg_solver(dfg_mesh, inflow=steady_inflow, **kw):
    mesh, markers, names = dfg_mesh
    ts = BDFTimeStepping(0.0, 1.0e6, desired_start_time_step=DT)
    solver = ProjectionSolver(mesh, markers, "standard", ts,
                              cg_iters=kw.pop("cg_iters", CG_ITERS),
                              cg_rtol=kw.pop("cg_rtol", None), device="cpu",
                              dtype=torch.float64, **kw)
    solver.set_boundary_conditions((
        (VelocityBCType.function, names["inlet"], inflow),
        (VelocityBCType.no_slip, names["cylinder"], None),
        (VelocityBCType.no_slip, names["upper wall"], None),
        (VelocityBCType.no_slip, names["lower wall"], None),
        (PressureBCType.constant, names["outlet"], 0.0)))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 0.01, "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    return solver, ts


def eager_step(solver, ts):
    ts.update_coefficients()
    solver.solve()
    ts.advance_time()
    solver.advance_time()


def test_captured_steps_equal_solve_bit_for_bit(dfg_mesh):
    solver, ts = dfg_solver(dfg_mesh)
    for _ in range(2):
        eager_step(solver, ts)
    cylinder = dfg_mesh[2]["cylinder"]
    step, state = solver.captured_step(cylinder, 2.0)
    assert len(state) == 5 and state[4].shape == (2,)
    loop = ChunkLoop(step, state, 5, device="cpu")
    loop.run()
    for _ in range(5):
        eager_step(solver, ts)
    u, u_old, p, phi, force = loop.state
    assert torch.equal(u, solver._u2)
    assert torch.equal(u_old, solver._u2_old)
    assert torch.equal(p, solver._p2)
    assert torch.equal(phi, solver._phi2)
    assert torch.equal(force, 2.0 * solver.boundary_reaction_force(cylinder))
    assert bool(torch.isfinite(force).all())


@pytest.mark.parametrize("case,match", [
    ("cg_rtol", "cg_rtol"),
    ("time_dependent_inflow", "function of the time"),
    ("before_the_first_step", "first step"),
])
def test_capture_refuses_what_it_cannot_fix(dfg_mesh, case, match):
    kw = {"cg_rtol": 1e-6} if case == "cg_rtol" else {}
    inflow = pulsating_inflow if case == "time_dependent_inflow" \
        else steady_inflow
    solver, _ = dfg_solver(dfg_mesh, inflow=inflow, **kw)
    with pytest.raises(ValueError, match=match):
        solver.captured_step(dfg_mesh[2]["cylinder"])


def test_counters_read_the_steps_work(dfg_mesh):
    """At resolution 1 the velocity operators and the couplings are
    AffineBands and the pressure Laplacian a CirculantBand (the band
    kernel, not counted).  A step applies M or K 2 h + m + 9 times
    (Helmholtz: two masses on the right-hand side, one Helmholtz operator
    on the Dirichlet values and one per CG iteration and the first
    residual, each an M and a K; correction: M u*, M on the Dirichlet
    values and m + 1 in its CG) and the couplings 3 dim times (the
    gradients of p and phi, the divergence); the Poisson solve runs one
    V-cycle per iteration and one for the first residual."""
    solver, ts = dfg_solver(dfg_mesh)
    eager_step(solver, ts)
    fast = solver._fast
    assert isinstance(fast.M, AffineBand) and isinstance(fast.K, AffineBand)
    assert isinstance(fast.L, CirculantBand)
    assert all(isinstance(op, (AffineBand, GatherOp))
               for op in fast.G + fast.D)
    step, state = solver.captured_step(dfg_mesh[2]["cylinder"])
    loop = ChunkLoop(step, state, 2, device="cpu")
    before = monitor.counter_values()
    loop.run()
    counted = monitor.counts_since(before)
    h, p, m = CG_ITERS
    assert counted["amg"] == {"vcycles": 2 * (p + 1)}
    applies = counted["fastop.applies"]
    assert applies["affine_band"] + applies["gather"] == \
        2 * ((2 * h + m + 9) + 3 * 2)
    monitor.restore_counters(before)
    assert monitor.counts_since(before)["amg"] == {"vcycles": 0}
