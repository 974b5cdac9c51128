"""Gravity-driven flow through an open cube (counterpart of
``demo/gravity_driven_flow.py``) with Bernoulli-potential and mass-flux
postprocessing.  As in the JAX demo, the Froude number comes from the
coefficient handler (the reference's postprocess reads an undefined
``self._Fr``).  The total boundary mass flux is printed and kept in
``mass_flux``.

    python -m navierstokes_tpu_torch.demo.gravity_driven_flow [--device D]
        [--dtype T]
"""

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers,
                                         extract_all_boundary_markers,
                                         open_hyper_cube)
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             StationaryProblem)

M = HyperCubeBoundaryMarkers


class GravityDrivenFlowProblem(StationaryProblem):
    def __init__(self, n_points, main_dir=None, **kw):
        super().__init__(main_dir, **kw)
        self._n_points = n_points
        self._problem_name = "OpenCube"
        self.mass_flux = None

    def setup_mesh(self):
        openings = (("bottom", (0.2, 0.0), 0.1),
                    ("left", (0.0, 0.5), 0.1),
                    ("right", (1.0, 0.7), 0.1),
                    ("bottom", (0.7, 0.0), 0.05),
                    ("top", (0.5, 1.0), 0.8))
        self._mesh, self._boundary_markers = open_hyper_cube(
            2, self._n_points, openings)
        self.write_boundary_markers()

    def set_boundary_conditions(self):
        self._bcs = ((VelocityBCType.no_slip, M.left.value, None),
                     (VelocityBCType.no_slip, M.right.value, None),
                     (VelocityBCType.no_slip, M.bottom.value, None),
                     (VelocityBCType.no_slip, M.top.value, None))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=200.0,
                                                               Fr=10.0)

    def set_body_force(self):
        self._body_force = (0.0, -1.0)

    def postprocess_solution(self):
        solver = self._get_solver()
        space = solver.space
        u = self._get_velocity()
        p = self._get_pressure()

        # Bernoulli potential Phi = |u|^2/2 + p + (g.x)/Fr^2 at vertices
        Fr = self._coefficient_handler.Fr
        uv = space.vertex_velocity(u)
        pv = space.vertex_pressure(p)
        potential_energy = self._mesh.points @ np.array(self._body_force)
        phi = 0.5 * np.sum(uv ** 2, axis=1) + pv \
            + potential_energy / Fr ** 2
        self._add_to_field_output(("Bernoulli potential", phi))
        self._add_to_field_output(self._compute_pressure_gradient())
        self._add_to_field_output(self._compute_vorticity())
        self._add_to_field_output(self._compute_stream_potential())

        # total mass flux over the whole boundary
        flux = 0.0
        for bid in extract_all_boundary_markers(self._mesh,
                                                self._boundary_markers):
            fids = self._boundary_markers.ids_with_value(bid)
            if len(fids) == 0:
                continue
            batch = solver.operator.facet_batch_device(
                space.facet_batch(fids))
            flux += float(solver.operator.boundary_velocity_flux(batch, u))
        self.mass_flux = flux
        print(f"Value of the total mass flux: {flux:6.2e}")


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    gravity_flow = GravityDrivenFlowProblem(
        50, **placement(args, projection=False))
    gravity_flow.solve_problem()
    return gravity_flow


if __name__ == "__main__":
    main()
