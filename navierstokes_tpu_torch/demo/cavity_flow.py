"""Lid-driven cavity at Re=10 (counterpart of ``demo/cavity_flow.py``).

    python -m navierstokes_tpu_torch.demo.cavity_flow [--device D] [--dtype T]
"""

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             StationaryProblem)


class CavityProblem(StationaryProblem):
    def __init__(self, n_points, main_dir=None, **kw):
        super().__init__(main_dir, **kw)
        self._n_points = n_points
        self._problem_name = "Cavity"

    def setup_mesh(self):
        self._mesh, self._boundary_markers = hyper_cube(2, self._n_points)

    def set_boundary_conditions(self):
        M = HyperCubeBoundaryMarkers
        self._bcs = ((VelocityBCType.no_slip, M.left.value, None),
                     (VelocityBCType.no_slip, M.right.value, None),
                     (VelocityBCType.no_slip, M.bottom.value, None),
                     (VelocityBCType.constant, M.top.value, (1.0, 0.0)))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=10.0)


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    cavity_flow = CavityProblem(25, **placement(args, projection=False))
    cavity_flow.solve_problem()
    return cavity_flow


if __name__ == "__main__":
    main()
