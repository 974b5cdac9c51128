"""Triply periodic 3D box through the spectral projection step
(counterpart of ``demo/periodic_box_3d.py``).

An ``InstationaryProblem`` on a periodic Kuhn-tetrahedralized cube, solved
by ``ProjectionSolver``, which detects the triply periodic structured
lattice and solves every linear system by exact block solves in Fourier
space (``structured/spectral.py``).

The initial condition is the unidirectional shear wave
u = (cos(2 pi y), 0, 0): divergence-free with (u.grad)u == 0, so it is
an exact Navier-Stokes solution decaying as e^{-nu g^2 t} -- the demo
prints the measured against the analytic amplitude at the end (the
convection runs; its contribution is zero to roundoff).

    python -m navierstokes_tpu_torch.demo.periodic_box_3d [--device D]
        [--dtype T]
"""

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.spaces import axis_periodic
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.solvers import ProjectionSolver

M = HyperCubeBoundaryMarkers
GAMMA = 2.0 * np.pi
RE = 100.0


class PeriodicBox3D(InstationaryProblem):
    def __init__(self, main_dir=None, n_points=16, **kw):
        super().__init__(main_dir, start_time=0.0, end_time=0.5,
                         desired_start_time_step=0.01, n_max_steps=100, **kw)
        self._problem_name = "PeriodicBox3D"
        self._n_points = n_points
        self._output_frequency = 0
        self._postprocessing_frequency = 0
        self.set_solver_class(ProjectionSolver)

    def setup_mesh(self):
        self._mesh, self._boundary_markers = hyper_cube(3, self._n_points)

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=RE)

    def set_initial_conditions(self):
        self._initial_conditions = {
            "velocity": lambda x: np.stack(
                [np.cos(GAMMA * x[:, 1]),
                 np.zeros(len(x)), np.zeros(len(x))], axis=1),
        }

    def set_boundary_conditions(self):
        self._bcs = ((PressureBCType.mean_value, None, 0.0),)

    def set_periodic_boundary_conditions(self):
        self._periodic_bcs = [axis_periodic(a) for a in range(3)]
        self._periodic_boundary_ids = (M.left.value, M.right.value,
                                       M.top.value, M.bottom.value,
                                       M.back.value, M.front.value)


def amplitude(problem):
    """``(max|u|, the analytic amplitude)`` at the problem's current time."""
    solver = problem._navier_stokes_solver
    u, _ = solver.space.split(solver.solution)
    amp = float(u.abs().max())
    t = problem._time_stepping.current_time
    return amp, float(np.exp(-(1.0 / RE) * GAMMA ** 2 * t))


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    problem = PeriodicBox3D(**placement(args, projection=True))
    problem.solve_problem()
    amp, expected = amplitude(problem)
    print(f"spectral path: {problem._navier_stokes_solver._step_kind}")
    print(f"max|u| = {amp:.8f}, analytic {expected:.8f} "
          f"(rel err {abs(amp - expected) / expected:.2e})")
    return problem


if __name__ == "__main__":
    main()
