"""Transient solver base: solution ring, initial conditions, per-step solve
(counterpart of ``navierstokes_tpu/solvers/transient.py``).

A ring of ``n_levels + 1`` mixed solution vectors rotated by
``advance_time``; initial conditions L2-projected onto the collapsed
subspaces and assigned to levels 0 and 1; per-step ``solve()`` = lazy
setup -> evaluate BC data at the next time level -> refresh scheme
coefficients if they changed -> solve the step -> mean-pressure shift when
a mean-value constraint is active.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.solvers.base import SolverBase
from navierstokes_tpu_torch.timestepping import BDFTimeStepping


class InstationarySolverBase(SolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None, *,
                 device=None, dtype=None):
        super().__init__(mesh, boundary_markers, form_convective_term,
                         form_viscous_term, device=device, dtype=dtype)
        if tol is None:
            tol = config.default_tol(self._dtype)
        assert tol > 0.0 and max_iter > 0
        assert isinstance(time_stepping, BDFTimeStepping) or hasattr(
            time_stepping, "n_levels")
        self._time_stepping = time_stepping
        self._tol = tol
        self._maxiter = max_iter
        self._linear_solver = linear_solver
        self._solutions = None
        self._setup_done = False

    # -- lifecycle ----------------------------------------------------------
    def _n_levels(self) -> int:
        n = self._time_stepping.n_levels
        return n() if callable(n) else n

    def _setup_function_spaces(self):
        self._setup_space()
        self._solutions = [self._zeros(self._space.n_dofs)
                           for _ in range(self._n_levels() + 1)]

    def _zeros(self, n) -> torch.Tensor:
        return torch.zeros(n, dtype=self._dtype, device=self._device)

    def _setup_problem(self):
        if self._solutions is None:
            self._setup_function_spaces()
        self._setup_operator()
        self._compile_boundary_conditions()
        self._setup_scheme()
        self._setup_done = True

    def _setup_scheme(self):
        """Hook for scheme-specific setup (matrices, sub-operators)."""

    def _solve_time_step(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    def _update_time_stepping_coefficients(self):
        """Pull fresh alpha/dt from the time-stepping object."""
        self._next_step_size = self._time_stepping.get_next_step_size()
        self._alpha = tuple(self._time_stepping.coefficients(1))

    # -- initial conditions -------------------------------------------------
    def set_initial_conditions(self, initial_conditions: dict):
        assert isinstance(initial_conditions, dict)
        assert "velocity" in initial_conditions
        if self._solutions is None:
            self._setup_function_spaces()
        if self._operator is None:
            self._setup_operator()
        op = self._operator
        space = self._space

        vel = initial_conditions["velocity"]
        u0_nodal = space.interpolate_velocity(vel, t=None)
        u0 = op.project_velocity(values_at_unodes=u0_nodal)

        if "pressure" in initial_conditions:
            p0_nodal = space.interpolate_pressure(
                initial_conditions["pressure"], t=None)
            p0 = op.project_pressure(values_at_pnodes=p0_nodal)
        else:
            p0 = self._zeros(space.n_pnodes)

        x0 = space.join(u0, p0)
        self._solutions[0] = x0
        self._solutions[1] = x0

    # -- stepping -----------------------------------------------------------
    def advance_time(self):
        """Rotate the solution ring (newest stays in slot 0)."""
        for i in range(len(self._solutions) - 1, 0, -1):
            self._solutions[i] = self._solutions[i - 1]

    def solve(self):
        """Advance the solution by one time step."""
        if not self._setup_done:
            self._setup_problem()

        next_time = self._time_stepping.next_time

        if (not hasattr(self, "_alpha")
                or self._time_stepping.coefficients_changed(1)):
            self._update_time_stepping_coefficients()

        self._solve_time_step(next_time)

        if self._mean_pressure_value is not None:
            self._shift_mean_pressure()

    def _shift_mean_pressure(self):
        """Project the pressure onto the prescribed mean value.

        With nodal P1 the L2 projection of (p - c) is exactly the nodal
        shift.
        """
        u, p = self._space.split(self._solutions[0])
        mean = self._operator.mean_pressure(p)
        shift = mean - self._mean_pressure_value
        p = p - shift
        self._solutions[0] = self._space.join(u, p)

    @property
    def solution(self):
        return self._solutions[0]
