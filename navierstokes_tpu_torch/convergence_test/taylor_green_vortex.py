"""Temporal convergence study on the Taylor-Green vortex (counterpart of
``convergence_test/taylor_green_vortex.py``).

Fixed mesh, dt halved from 1.0 over the levels, L2(u)/L2(p) errors
against the analytic decay exp(-2 gamma^2 t / Re) at t = 1, a loglog plot
to PDF when matplotlib imports.  Expected: BDF-2 slope ~2 until the
spatial error floor.

    python -m navierstokes_tpu_torch.convergence_test.taylor_green_vortex
        [n_points] [levels] [bdf|projection] [--device D] [--dtype T]

(default n_points=128 and 6 levels; "bdf" = monolithic BDF-2 as the
reference study, "projection" = the projection path, spectral on this
torus.)  On the card it runs in float64 in both modes: the study measures
errors down to the spatial floor, below float32 roundoff.
"""

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.demo import argument_parser, placement
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.spaces import axis_periodic
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem)
from navierstokes_tpu_torch.solvers import (ImplicitBDFSolver,
                                            ProjectionSolver)

M = HyperCubeBoundaryMarkers
GAMMA = 2.0 * np.pi
RE = 100.0


def exact_velocity(x, t):
    decay = np.exp(-2.0 * GAMMA ** 2 * t / RE)
    return decay * np.stack([
        np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
        -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])], axis=1)


def exact_pressure(x, t):
    decay = np.exp(-4.0 * GAMMA ** 2 * t / RE)
    return -0.25 * decay * (np.cos(2 * GAMMA * x[:, 0])
                            + np.cos(2 * GAMMA * x[:, 1]))


class TaylorGreenVortex(InstationaryProblem):
    def __init__(self, time_step, n_points, solver_class=ImplicitBDFSolver,
                 **kw):
        super().__init__(start_time=0.0, end_time=1.0,
                         desired_start_time_step=time_step,
                         n_max_steps=100000, **kw)
        self._write_output = False
        self._problem_name = "TaylorGreenVortexConvergence"
        self._n_points = n_points
        self._output_frequency = 0
        self._postprocessing_frequency = 0
        self.set_solver_class(solver_class)

    def setup_mesh(self):
        self._mesh, self._boundary_markers = hyper_cube(2, self._n_points)

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=RE)

    def set_initial_conditions(self):
        self._initial_conditions = {
            "velocity": lambda x: exact_velocity(x, 0.0),
            "pressure": lambda x: exact_pressure(x, 0.0),
        }

    def set_boundary_conditions(self):
        self._bcs = ((PressureBCType.mean_value, None, 0.0),)

    def set_periodic_boundary_conditions(self):
        self._periodic_bcs = [axis_periodic(0), axis_periodic(1)]
        self._periodic_boundary_ids = (M.left.value, M.right.value,
                                       M.top.value, M.bottom.value)

    def compute_errors(self):
        solver = self._get_solver()
        u, p = solver.space.split(solver.solution)
        t = self._time_stepping.current_time
        err_u = solver.operator.l2_error_velocity(
            u, lambda x: exact_velocity(x, t))
        err_p = solver.operator.l2_error_pressure(
            p, lambda x: exact_pressure(x, t))
        return err_u, err_p


def main(n_points=128, levels=6, solver="bdf", *, device=None, dtype=None,
         solver_options=None):
    """Run the study; returns ``(time_steps, u_errors, p_errors)``.
    ``device`` None is the card (raises without one), ``dtype`` None is
    float64; ``solver_options`` go to the solver class."""
    config.require_device(device)
    dtype = torch.float64 if dtype is None else dtype
    solver_class = {"bdf": ImplicitBDFSolver,
                    "projection": ProjectionSolver}[solver]
    time_steps, u_errors, p_errors = [], [], []
    for i in range(levels):
        dt = 1.0 * 0.5 ** i
        problem = TaylorGreenVortex(dt, n_points, solver_class, device=device,
                                    dtype=dtype,
                                    solver_options=solver_options)
        problem.solve_problem()
        err_u, err_p = problem.compute_errors()
        time_steps.append(dt)
        u_errors.append(err_u)
        p_errors.append(err_p)
        print(f"dt = {dt:8.4f}: L2(u) = {err_u:.4e}, L2(p) = {err_p:.4e}",
              flush=True)

    orders = np.diff(-np.log2(u_errors))
    print("observed velocity orders:", np.round(orders, 2))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.loglog(time_steps, u_errors, "o-", label="L2 velocity error")
        ax.loglog(time_steps, p_errors, "s-", label="L2 pressure error")
        ref = np.array(time_steps)
        ax.loglog(ref, u_errors[0] * (ref / ref[0]) ** 2, "k--",
                  label="2nd order")
        ax.set_xlabel("time step size")
        ax.set_ylabel("L2 error at t = 1")
        ax.legend()
        ax.grid(True, which="both", alpha=0.3)
        fig.savefig("taylor_green_convergence.pdf")
        plt.close(fig)
        print("wrote taylor_green_convergence.pdf")
    except ImportError as exc:
        print("plot skipped:", exc)
    return time_steps, u_errors, p_errors


def cli(argv=None):
    """The command line: ``[n_points] [levels] [bdf|projection]`` and
    ``--device`` / ``--dtype`` (float64 by default, also on the card)."""
    ap = argument_parser(__doc__.splitlines()[0])
    ap.add_argument("n_points", nargs="?", type=int, default=128)
    ap.add_argument("levels", nargs="?", type=int, default=6)
    ap.add_argument("solver", nargs="?", default="bdf",
                    choices=("bdf", "projection"))
    args = ap.parse_args(argv)
    return main(args.n_points, args.levels, args.solver,
                **placement(args, projection=False))


if __name__ == "__main__":
    cli()
