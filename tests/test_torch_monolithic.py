"""Port parity: the monolithic and fractional-step transient solvers
(solvers/bdf.py, solvers/theta.py, solvers/imex.py, solvers/ipcs.py).

CPU, float64.  Both packages march the lid-driven cavity 12x12 at Re 100
from rest for 5 steps of 0.02 (the theta case with a time-dependent body
force): the fully implicit BDF solver with a fresh host LU each Newton
iteration and with the frozen (modified-Newton) LU, whose refresh rule
refactors on this start; Crank-Nicolson and the fractional-step theta
scheme; the SBDF-2 and CNAB IMEX schemes; IPCS with the matrix-free
AMG-preconditioned defaults (incremental and phi-increment schemes) and
with an assembled host LU.  The solutions agree to 1e-9 of their largest
entry and every step takes the same number of Newton iterations.
"""

import numpy as np
import pytest
import torch

import navierstokes_tpu.fem.bcs as jax_bcs
import navierstokes_tpu.mesh as jax_mesh
import navierstokes_tpu.solvers as jax_solvers
import navierstokes_tpu.timestepping as jax_ts
import navierstokes_tpu_torch.fem.bcs as torch_bcs
import navierstokes_tpu_torch.mesh as torch_mesh
import navierstokes_tpu_torch.solvers as torch_solvers
import navierstokes_tpu_torch.timestepping as torch_ts

TOL = 1e-9
N_STEPS = 5

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: under several pytest workers on a
    shared CPU, torch's intra-op threads oversubscribe the cores and slow
    them tenfold.  One thread per worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def _force(x, t):
    return np.stack([np.zeros(len(x)), -np.sin(np.pi * (t or 0.0))
                     * x[:, 0]], axis=1)


CASES = {
    "bdf_host_lu": ("ImplicitBDFSolver", None,
                    dict(linear_solver="host_lu")),
    "bdf_frozen_lu": ("ImplicitBDFSolver", None,
                      dict(linear_solver="frozen_lu")),
    "theta_crank_nicolson": ("ThetaSolver", "CrankNicolson",
                             dict(linear_solver="host_lu")),
    "theta_fractional_step": ("ThetaSolver", "FractionalStep01",
                              dict(linear_solver="host_lu")),
    "imex_sbdf2": ("IMEXSolver", "SBDF2", dict(linear_solver="host_lu")),
    "imex_cnab": ("IMEXSolver", "CNAB", dict(linear_solver="host_lu")),
    "ipcs": ("IPCSSolver", None, {}),
    "ipcs_phi": ("IPCSSolver", None, dict(scheme="phi")),
    "ipcs_host_lu": ("IPCSSolver", None, dict(linear_solver="host_lu")),
}


def _run(pkg, case, **extra):
    mesh_mod, bcs, solvers, ts_mod = pkg
    cls_name, scheme, kw = CASES[case]
    mesh, markers = mesh_mod.hyper_cube(2, 12)
    M = mesh_mod.HyperCubeBoundaryMarkers
    if cls_name == "ThetaSolver":
        ts = ts_mod.GeneralThetaTimeStepping(
            0.0, 1.0, getattr(ts_mod.ThetaTimeSteppingType, scheme),
            desired_start_time_step=0.02)
    elif cls_name == "IMEXSolver":
        ts = ts_mod.IMEXTimeStepping(0.0, 1.0,
                                     getattr(ts_mod.IMEXType, scheme),
                                     desired_start_time_step=0.02)
    else:
        ts = ts_mod.BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.02)
    s = getattr(solvers, cls_name)(mesh, markers, "standard", ts, **kw,
                                   **extra)
    V = bcs.VelocityBCType
    s.set_boundary_conditions(((V.no_slip, M.left.value, None),
                               (V.no_slip, M.right.value, None),
                               (V.no_slip, M.bottom.value, None),
                               (V.constant, M.top.value, (1.0, 0.0))))
    coeffs = {"convective_term": 1.0, "viscous_term": 1.0 / 100.0,
              "pressure_term": 1.0}
    if case == "theta_crank_nicolson":
        coeffs["body_force_term"] = 1.0
        s.set_body_force(_force)
    s.set_equation_coefficients(coeffs)
    s.set_initial_conditions({"velocity": (0.0, 0.0)})
    for _ in range(N_STEPS):
        ts.update_coefficients()
        s.solve()
        ts.advance_time()
        s.advance_time()
    return s


def _newton_counts(solver):
    return [r["iterations"] for r in solver.monitor.records
            if r["kind"] == "nonlinear_solve"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match(case):
    j = _run((jax_mesh, jax_bcs, jax_solvers, jax_ts), case)
    t = _run((torch_mesh, torch_bcs, torch_solvers, torch_ts), case,
             device="cpu")
    want = np.asarray(j.solution)
    got = t.solution.numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert _newton_counts(t) == _newton_counts(j)
    if case == "bdf_frozen_lu":
        # one factorization at the start and at least one refresh
        assert t.lu_factorizations >= 2
    if case.startswith("ipcs"):
        assert len(_newton_counts(t)) == N_STEPS
