"""Doubly periodic Taylor-Green vortex, BDF-2 monolithic (counterpart of
``demo/taylor_green_vortex.py``).

    python -m navierstokes_tpu_torch.demo.taylor_green_vortex [--device D]
        [--dtype T]
"""

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.spaces import axis_periodic
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.solvers import ImplicitBDFSolver

M = HyperCubeBoundaryMarkers
GAMMA = 2.0 * np.pi


class TaylorGreenVortex(InstationaryProblem):
    def __init__(self, main_dir=None, n_points=32, **kw):
        super().__init__(main_dir, start_time=0.0, end_time=1.0,
                         desired_start_time_step=0.01, n_max_steps=200, **kw)
        self._problem_name = "TaylorGreenVortex"
        self._n_points = n_points
        self._output_frequency = 10
        self._postprocessing_frequency = 0
        self.set_solver_class(ImplicitBDFSolver)

    def setup_mesh(self):
        self._mesh, self._boundary_markers = hyper_cube(2, self._n_points)

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=100.0)

    def set_initial_conditions(self):
        g = GAMMA
        self._initial_conditions = {
            "velocity": lambda x: np.stack(
                [np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                 -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])], axis=1),
            "pressure": lambda x: -0.25 * (np.cos(2 * g * x[:, 0])
                                           + np.cos(2 * g * x[:, 1])),
        }

    def set_boundary_conditions(self):
        self._bcs = ((PressureBCType.mean_value, None, 0.0),)

    def set_periodic_boundary_conditions(self):
        self._periodic_bcs = [axis_periodic(0), axis_periodic(1)]
        self._periodic_boundary_ids = (M.left.value, M.right.value,
                                       M.top.value, M.bottom.value)


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    taylor_green = TaylorGreenVortex(**placement(args, projection=False))
    taylor_green.solve_problem()
    return taylor_green


if __name__ == "__main__":
    main()
