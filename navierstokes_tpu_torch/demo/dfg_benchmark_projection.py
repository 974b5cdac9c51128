"""DFG cylinder benchmarks through the Problem API on the projection path
(counterpart of ``demo/dfg_benchmark_projection.py``).

The template-method problem classes of ``dfg_benchmark.py``, solved with
``ProjectionSolver``.  Two configurations:

* ``DFGBenchmark2D2Projection`` -- steady inflow, Re=100 (Schafer-Turek
  2D-2): c_D in [3.22, 3.24], c_L in [0.99, 1.01], St in [0.295, 0.305];
* ``DFGBenchmark2D3Projection`` -- pulsating inflow amplitude
  sin(pi t / t_end) (2D-3): c_D,max in [2.93, 2.97], c_L,max in
  [0.47, 0.49].  Exercises the time-dependent BC path.

The reaction force on the cylinder stays on the device every step; the
series is read in one transfer by ``materialize_coefficients``.

    python -m navierstokes_tpu_torch.demo.dfg_benchmark_projection
        [2d2|2d3] [t_end] [resolution] [dt] [--device D] [--dtype T]
"""

import json
import os

import numpy as np
import torch

from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.mesh import channel_with_cylinder
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.solvers import ProjectionSolver

H = 4.1           # channel height (cylinder diameters)


class DFGBenchmark2D2Projection(InstationaryProblem):
    """Steady-inflow DFG 2D-2 on the projection path."""

    pulsating = False

    def __init__(self, main_dir=None, end_time=80.0, n_max_steps=16000,
                 resolution=1.8, dt=0.005, **kw):
        super().__init__(main_dir, start_time=0.0, end_time=end_time,
                         desired_start_time_step=dt,
                         n_max_steps=n_max_steps, **kw)
        self._problem_name = type(self).__name__
        self._resolution = resolution
        self._output_frequency = 0
        self._postprocessing_frequency = 1
        self._cfl_frequency = 200       # monitoring only (non-adaptive)
        self.set_solver_class(ProjectionSolver)
        self.coefficients = []
        self._force_series = []         # device tensors, read lazily

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._boundary_marker_map = \
            channel_with_cylinder(self._resolution)

    def set_initial_conditions(self):
        self._initial_conditions = {"velocity": (0.0, 0.0)}

    def _amplitude(self, t):
        if not self.pulsating:
            return 1.0
        return np.sin(np.pi * t / self._time_stepping.end_time)

    def set_boundary_conditions(self):
        def inlet_velocity(x, t=0.0):
            t = 0.0 if t is None else t
            s = x[:, 1] / H
            return self._amplitude(t) * np.stack(
                [6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

        bm = self._boundary_marker_map
        self._bcs = ((VelocityBCType.function, bm["inlet"], inlet_velocity),
                     (VelocityBCType.no_slip, bm["cylinder"], None),
                     (VelocityBCType.no_slip, bm["upper wall"], None),
                     (VelocityBCType.no_slip, bm["lower wall"], None),
                     (PressureBCType.constant, bm["outlet"], 0.0))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=100.0)

    def postprocess_solution(self):
        solver = self._get_solver()
        force = solver.boundary_reaction_force(
            self._boundary_marker_map["cylinder"])
        # the force stays on the device: a float() here would be a host
        # round trip per step; the series is read in one transfer
        self._force_series.append((self._time_stepping.next_time, force))
        if self._time_stepping.step_number % 200 == 0:
            t, force = self._force_series[-1]
            print(f"t={t:8.3f}  c_D={2 * float(force[0]):8.4f}  "
                  f"c_L={2 * float(force[1]):8.4f}", flush=True)

    def materialize_coefficients(self):
        """Convert the device-side force series to (t, c_D, c_L) rows."""
        if self._force_series:
            forces = torch.stack([f for _, f in self._force_series])
            forces = forces.cpu().numpy()
            times = [t for t, _ in self._force_series]
            self.coefficients = [(t, 2.0 * f[0], 2.0 * f[1])
                                 for t, f in zip(times, forces)]
            self._force_series = []
        return self.coefficients


class DFGBenchmark2D3Projection(DFGBenchmark2D2Projection):
    """Pulsating-inflow DFG 2D-3 (time-dependent Dirichlet data)."""

    pulsating = True


def summarize(coefficients, dt, window=20.0):
    series = np.asarray(coefficients)
    t_end = series[-1, 0]
    win = series[series[:, 0] > t_end - window]
    cd_max, cl_max = win[:, 1].max(), win[:, 2].max()
    cl = win[:, 2] - win[:, 2].mean()
    freqs = np.fft.rfftfreq(len(cl), d=dt)
    amp = np.abs(np.fft.rfft(cl))
    return {"cd_max": float(cd_max), "cl_max": float(cl_max),
            "strouhal": float(freqs[np.argmax(amp[1:]) + 1])}


def main(argv=None):
    ap = argument_parser(__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="2d3", choices=("2d2", "2d3"))
    ap.add_argument("t_end", nargs="?", type=float, default=80.0)
    ap.add_argument("resolution", nargs="?", type=float, default=1.8)
    ap.add_argument("dt", nargs="?", type=float, default=0.005)
    args = ap.parse_args(argv)
    cls = DFGBenchmark2D3Projection if args.which == "2d3" \
        else DFGBenchmark2D2Projection
    problem = cls(end_time=args.t_end,
                  n_max_steps=int(round(args.t_end / args.dt)),
                  resolution=args.resolution, dt=args.dt,
                  **placement(args, projection=True))
    problem.solve_problem()
    print(json.dumps(summarize(problem.materialize_coefficients(), args.dt)))
    os.makedirs(problem._results_dir, exist_ok=True)
    np.savetxt(os.path.join(problem._results_dir,
                            f"{problem._problem_name}_coefficients.txt"),
               np.asarray(problem.coefficients))
    return problem


if __name__ == "__main__":
    main()
