"""Flow past a zero-thickness flat plate (counterpart of
``demo/blasius_flow.py``).

The plate is imposed as an internal no-slip constraint on interior facets.

    python -m navierstokes_tpu_torch.demo.blasius_flow [--device D]
        [--dtype T]
"""

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import blasius_plate
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             StationaryProblem)


class BlasiusFlowProblem(StationaryProblem):
    def __init__(self, main_dir=None, **kw):
        super().__init__(main_dir, **kw)
        self._problem_name = "BlasiusFlow"

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._boundary_marker_map = \
            blasius_plate()

    def set_boundary_conditions(self):
        def inlet_velocity(x):
            return np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)

        bm = self._boundary_marker_map
        self._bcs = ((VelocityBCType.function, bm["inlet"], inlet_velocity),
                     (VelocityBCType.no_normal_flux, bm["bottom"], None),
                     (VelocityBCType.no_normal_flux, bm["top"], None))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=200.0)

    def set_internal_constraints(self):
        self._internal_constraints = (
            (VelocityBCType.no_slip, self._boundary_marker_map["plate"],
             None),)

    def postprocess_solution(self):
        self._add_to_field_output(self._compute_pressure_gradient())
        self._add_to_field_output(self._compute_vorticity())


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    problem = BlasiusFlowProblem(**placement(args, projection=False))
    problem.solve_problem()
    return problem


if __name__ == "__main__":
    main()
