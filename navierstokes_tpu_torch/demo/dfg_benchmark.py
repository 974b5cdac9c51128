"""DFG 2D-2 cylinder benchmark at Re=100 (counterpart of
``demo/dfg_benchmark.py``), monolithic BDF-2.

Geometry nondimensionalized by the cylinder diameter: channel 22 x 4.1,
cylinder center (2, 2), diameter 1, mean inflow velocity 1 -> Re = 100 on
the diameter.  Drag/lift coefficients from the nodal reaction force on
the cylinder, c = 2 F (density 1, U_mean 1, D 1); Schafer-Turek reference
intervals: c_D in [3.22, 3.24], c_L in [0.99, 1.01], St in [0.295,
0.305].  As in the JAX demo, the viscosity comes from the coefficient
handler (the reference's postprocess reads an undefined ``self._Re``).

    python -m navierstokes_tpu_torch.demo.dfg_benchmark [--device D]
        [--dtype T]
"""

import os

import numpy as np

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.mesh import channel_with_cylinder
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.solvers import ImplicitBDFSolver


class DFGBenchmark2D2(InstationaryProblem):
    def __init__(self, main_dir=None, end_time=80.0, n_max_steps=16000,
                 resolution=1.0, **kw):
        super().__init__(main_dir, start_time=0.0, end_time=end_time,
                         desired_start_time_step=0.005,
                         n_max_steps=n_max_steps, **kw)
        self._problem_name = "DFGBenchmark2D2"
        self._resolution = resolution
        self._output_frequency = 50
        self._postprocessing_frequency = 1
        self.set_solver_class(ImplicitBDFSolver)
        self.coefficients = []

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._boundary_marker_map = \
            channel_with_cylinder(self._resolution)

    def set_initial_conditions(self):
        self._initial_conditions = {"velocity": (0.0, 0.0)}

    def set_boundary_conditions(self):
        h = 4.1

        def inlet_velocity(x):
            s = x[:, 1] / h
            return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

        bm = self._boundary_marker_map
        self._bcs = ((VelocityBCType.function, bm["inlet"], inlet_velocity),
                     (VelocityBCType.no_slip, bm["cylinder"], None),
                     (VelocityBCType.no_slip, bm["upper wall"], None),
                     (VelocityBCType.no_slip, bm["lower wall"], None))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=100.0)

    def postprocess_solution(self):
        solver = self._get_solver()
        cylinder_id = self._boundary_marker_map["cylinder"]
        # the nodal reaction force, as in the JAX demo (superconvergent
        # against the direct traction integral)
        force = solver.boundary_reaction_force(cylinder_id)
        drag_coeff = 2.0 * float(force[0])
        lift_coeff = 2.0 * float(force[1])
        t = self._time_stepping.next_time
        self.coefficients.append((t, drag_coeff, lift_coeff))
        if self._time_stepping.step_number % 50 == 0:
            print(f"t={t:8.3f}  c_D={drag_coeff:8.4f}  c_L={lift_coeff:8.4f}")


def main(argv=None):
    args = argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    dfg_benchmark = DFGBenchmark2D2(**placement(args, projection=False))
    dfg_benchmark.solve_problem()
    coeffs = np.asarray(dfg_benchmark.coefficients)
    os.makedirs(dfg_benchmark._results_dir, exist_ok=True)
    np.savetxt(os.path.join(dfg_benchmark._results_dir, "Coefficients.txt"),
               coeffs)
    return dfg_benchmark


if __name__ == "__main__":
    main()
