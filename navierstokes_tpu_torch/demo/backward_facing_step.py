"""Backward-facing step at Re=50 (counterpart of
``demo/backward_facing_step.py``).

The inlet occupies y in [0.5, 1.0] (h=0.5, y0=0.5 as in the reference's
inlet profile); the mesh is the built-in generator replacing the gmsh
BackwardFacingStep.geo pipeline.

    python -m navierstokes_tpu_torch.demo.backward_facing_step [--device D]
        [--dtype T]
"""

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import backward_facing_step
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             StationaryProblem)


class BackwardFacingStepProblem(StationaryProblem):
    def __init__(self, main_dir=None, **kw):
        super().__init__(main_dir, **kw)
        self._problem_name = "BackwardFacingStep"

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._boundary_marker_map = \
            backward_facing_step()

    def set_boundary_conditions(self):
        h, y0 = 0.5, 0.5

        def inlet_velocity(x):
            s = (x[:, 1] - y0) / h
            return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

        self._bcs = ((VelocityBCType.function,
                      self._boundary_marker_map["inlet"], inlet_velocity),
                     (VelocityBCType.no_slip,
                      self._boundary_marker_map["walls"], None))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=50.0)

    def postprocess_solution(self):
        self._add_to_field_output(self._compute_pressure_gradient())
        self._add_to_field_output(self._compute_vorticity())


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    problem = BackwardFacingStepProblem(**placement(args, projection=False))
    problem.solve_problem()
    return problem


if __name__ == "__main__":
    main()
