"""Port parity: the stationary solver (solvers/stationary.py) and
``StationaryProblem`` (problems/base.py).

CPU, float64, both packages on the same problem:

* the lid-driven cavity at Re 100 with the dense LU (8x8: the JAX dense
  solve dominates the file's time under several workers) and the host
  sparse LU (12x12): the same Picard and Newton counts, the solution to
  1e-9 of its largest entry, ||F||_2 <= 1e-10;
* the same cavity through the matrix-free PCD-FGMRES at 6x6 (restart
  cycles of 30 in both packages, ``NS_TPU_FGMRES_RESTART``: the default
  80 costs about a minute of CPU here): the same counts and linear
  iteration counts, the solution to 1e-8;
* pseudo-transient continuation on a 4x4 cavity to 1e-9;
* DFG 2D-1 at resolution 1 (the configuration of
  ``tests/test_dfg_benchmark.py``): c_D and c_L to 1e-9 of the JAX
  package's;
* a mirror of ``demo/cavity_flow.py`` at n = 10 as a ``StationaryProblem``
  to 1e-9.
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cylinder
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.problems import EquationCoefficientHandler as JaxCoeffs
from navierstokes_tpu.problems import StationaryProblem as JaxProblem
from navierstokes_tpu.solvers import StationarySolver as JaxSolver
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers as M,
                                         channel_with_cylinder, hyper_cube)
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             StationaryProblem)
from navierstokes_tpu_torch.solvers import StationarySolver
from navierstokes_tpu_torch.solvers.stationary import auto_linear_mode

H_DFG = 4.1

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: under several pytest workers on a
    shared CPU, torch's intra-op threads oversubscribe the cores and slow
    them tenfold.  One thread per worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def _jax_bcs(bcs):
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _cavity_pair(n, Re, **kw):
    mesh, markers, bcs = setups.lid_driven_cavity_setup(n)
    jmesh, jmarkers = jax_hyper_cube(2, n)
    t = StationarySolver(mesh, markers, device="cpu", **kw)
    j = JaxSolver(jmesh, jmarkers, **kw)
    t.set_boundary_conditions(bcs)
    j.set_boundary_conditions(_jax_bcs(bcs))
    coeffs = {"convective_term": 1.0, "viscous_term": 1.0 / Re,
              "pressure_term": 1.0}
    t.set_equation_coefficients(dict(coeffs))
    j.set_equation_coefficients(dict(coeffs))
    return t, j


def _records(solver, kind):
    return [r for r in solver.monitor.records if r["kind"] == kind]


def _assert_same_solve(t, j, tol):
    tr, jr = _records(t, "nonlinear_solve")[-1], \
        _records(j, "nonlinear_solve")[-1]
    for key in ("picard_iterations", "newton_iterations", "iterations"):
        assert tr.get(key) == jr.get(key), key
    assert tr["residual"] <= 1e-10
    assert _rel(t.solution, j.solution) <= tol


@pytest.mark.parametrize("mode,n", [("dense", 8), ("host_lu", 12)])
def test_cavity_direct_modes_match(mode, n):
    t, j = _cavity_pair(n, 100.0, linear_solver=mode)
    t.solve()
    j.solve()
    _assert_same_solve(t, j, 1e-9)
    assert t._pressure_pin_dof == j._pressure_pin_dof is not None


def test_cavity_pcd_mode_matches(monkeypatch):
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "30")
    t, j = _cavity_pair(6, 100.0, linear_solver="pcd")
    t.solve()
    j.solve()
    _assert_same_solve(t, j, 1e-8)
    lin = [[r["iterations"] for r in _records(s, "linear_solve")]
           for s in (t, j)]
    assert lin[0] == lin[1] and min(lin[0]) >= 30
    # the Krylov path gauges instead of pinning the pressure
    assert t._pressure_pin_dof is None and t._pressure_gauge_dof is not None


def test_solve_ptc_matches(monkeypatch):
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "10")
    t, j = _cavity_pair(4, 100.0, linear_solver="pcd")
    t.solve_ptc(tol=1e-6, sigma0=2.0)
    j.solve_ptc(tol=1e-6, sigma0=2.0)
    tr, jr = _records(t, "nonlinear_solve")[-1], \
        _records(j, "nonlinear_solve")[-1]
    assert tr["iterations"] == jr["iterations"]
    assert tr["linear_iterations"] == jr["linear_iterations"]
    assert tr["residual"] <= 1e-6
    assert _rel(t.solution, j.solution) <= 1e-9


def _dfg_pair():
    def inlet(x):
        s = x[:, 1] / H_DFG
        return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    mesh, markers, bm = channel_with_cylinder(resolution=1.0)
    jmesh, jmarkers, _ = jax_cylinder(resolution=1.0)
    bcs = ((VelocityBCType.function, bm["inlet"], inlet),
           (VelocityBCType.no_slip, bm["cylinder"], None),
           (VelocityBCType.no_slip, bm["upper wall"], None),
           (VelocityBCType.no_slip, bm["lower wall"], None))
    t = StationarySolver(mesh, markers, device="cpu")
    j = JaxSolver(jmesh, jmarkers)
    t.set_boundary_conditions(bcs)
    j.set_boundary_conditions(_jax_bcs(bcs))
    coeffs = {"convective_term": 1.0, "viscous_term": 1.0 / 20.0,
              "pressure_term": 1.0}
    for s in (t, j):
        s.set_equation_coefficients(dict(coeffs))
        s.solve()
    return t, j, bm["cylinder"]


def test_dfg_2d1_drag_lift_match():
    t, j, cyl = _dfg_pair()
    assert t._resolved_linear_mode() == "host_lu"
    _assert_same_solve(t, j, 1e-9)
    ft = 2.0 * np.asarray(t.boundary_reaction_force(cyl))
    fj = 2.0 * np.asarray(j.boundary_reaction_force(cyl))
    assert np.all(np.abs(ft - fj) <= 1e-9 * np.abs(fj)), (ft, fj)
    assert abs(ft[0] - 5.58) < 0.05 and abs(ft[1] - 0.0107) < 0.002


class _Cavity(StationaryProblem):
    """``demo/cavity_flow.py``'s problem."""

    def __init__(self, n, main_dir, **kw):
        super().__init__(main_dir, **kw)
        self._n_points = n
        self._problem_name = "Cavity"

    def setup_mesh(self):
        self._mesh, self._boundary_markers = hyper_cube(2, self._n_points)

    def set_boundary_conditions(self):
        self._bcs = ((VelocityBCType.no_slip, M.left.value, None),
                     (VelocityBCType.no_slip, M.right.value, None),
                     (VelocityBCType.no_slip, M.bottom.value, None),
                     (VelocityBCType.constant, M.top.value, (1.0, 0.0)))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=10.0)


class _JaxCavity(JaxProblem):
    def __init__(self, n, main_dir):
        super().__init__(main_dir)
        self._n_points = n
        self._problem_name = "Cavity"

    def setup_mesh(self):
        self._mesh, self._boundary_markers = jax_hyper_cube(2,
                                                            self._n_points)

    def set_boundary_conditions(self):
        _Cavity.set_boundary_conditions(self)
        self._bcs = _jax_bcs(self._bcs)

    def set_equation_coefficients(self):
        self._coefficient_handler = JaxCoeffs(Re=10.0)


def test_stationary_problem_mirrors_the_cavity_demo(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = _Cavity(10, str(tmp_path / "t"), device="cpu")
    j = _JaxCavity(10, str(tmp_path / "j"))
    t.solve_problem()
    j.solve_problem()
    got, want = t._get_solver().solution, j._get_solver().solution
    assert _rel(got, want) <= 1e-9
    assert t._get_solver()._resolved_linear_mode() == "dense"
    assert sorted(p.name for p in (tmp_path / "t" / "results").iterdir())


def test_linear_mode_policy_and_missing_multi_device():
    assert auto_linear_mode(4500, "cpu") == "dense"
    assert auto_linear_mode(4501, "cpu") == "host_lu"
    assert auto_linear_mode(4501, "cuda") == "pcd"
    assert auto_linear_mode(4501) == "pcd"
    mesh, markers, _ = setups.lid_driven_cavity_setup(2)
    # a device mesh makes the matrix-free PCD mode the default
    s = StationarySolver(mesh, markers, device="cpu",
                         device_mesh=["cpu", "cpu"])
    assert s._linear_solver == "pcd" and len(s._device_mesh) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StationarySolver(mesh, markers, device_mesh=["cuda:0", "cuda:1"])
