"""Generalized theta-scheme solver, including the 3-substep
fractional-step theta (counterpart of
``navierstokes_tpu/solvers/theta.py``).

Per substep s with tableau (theta1, theta2, theta3, theta4), substep size
k_s and substep interval [t_s, t_{s+1}]:

  M (u_{s+1} - u_s)/k_s + theta1 A(u_{s+1}) + theta2 A(u_s)
      + grad p_{s+1} + incompressibility(u_{s+1})
      = theta3 f(t_{s+1}) + theta4 f(t_s)

with A = convective + viscous (+ Coriolis) and f the body force -- the
one-step theta family (John 2016, Tables 7.1/7.2): Backward Euler
(1,0,0,1), Crank-Nicolson (.5,.5,.5,.5), and the strongly A-stable
fractional-step variants.  Each substep is a Newton solve.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.solvers.stationary import solver_linear_step
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.timestepping import GeneralThetaTimeStepping


def _is_field(a):
    return torch.is_tensor(a) and a.ndim == 3


class ThetaSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None, *,
                 device=None, dtype=None):
        assert isinstance(time_stepping, GeneralThetaTimeStepping)
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter, form_viscous_term,
                         linear_solver, device=device, dtype=dtype)

    def _update_time_stepping_coefficients(self):
        self._time_stepping.update_coefficients()
        self._theta = self._time_stepping.theta
        self._substep_sizes = list(self._time_stepping.intermediate_timesteps)
        self._substep_times = [list(row) for row
                               in self._time_stepping.intermediate_times]

    def solve(self):
        if not self._setup_done:
            self._setup_problem()
        self._update_time_stepping_coefficients()

        x = self._solutions[0]
        for s in range(self._time_stepping.n_steps):
            x = self._solve_substep(x, s)
        self._solutions[0] = x

        if self._mean_pressure_value is not None:
            self._shift_mean_pressure()

    def _solve_substep(self, x_old, s):
        op = self._operator
        space = self._space
        th1, th2, th3, th4 = self._theta[s]
        k_s = self._substep_sizes[s]
        t_start = self._substep_times[0][s]
        t_end = self._substep_times[1][s]
        # the tableau weights multiply the FULL step k (they satisfy
        # theta1 + theta2 = k_s / k); normalize to the substep so that the
        # discrete pressure stays physical
        k_full = self._time_stepping.get_next_step_size()
        scale = k_full / k_s
        th1, th2, th3, th4 = (scale * th1, scale * th2,
                              scale * th3, scale * th4)

        base = self._scalars()

        # explicit side: theta2 * A(u_old), pre-scattered velocity image
        u_old, _ = space.split(x_old)
        expl_scalars = dict(base)
        expl_scalars["cc"] = th2 * base["cc"]
        expl_scalars["cv"] = th2 * base["cv"]
        expl_scalars["cp"] = 0.0
        expl_scalars["accel0"] = 0.0
        if "cor" in base:
            expl_scalars["cor"] = th2 * base["cor"]
        extra_ru = (op.velocity_operator_image(u_old, expl_scalars)
                    if th2 != 0.0 else None)

        # theta-weighted body forces / Euler sources at both substep ends
        src_new = self._momentum_source(t=t_end)
        src_old = self._momentum_source(t=t_start)
        source_q = None
        if _is_field(src_new) or _is_field(src_old):
            source_q = th3 * src_new + th4 * src_old
        # acceleration history: -(1/k_s) M u_old enters via quad values
        hist = -(1.0 / k_s) * op.u_at_quad(u_old)
        source_q = hist if source_q is None else source_q + hist

        tract = self._traction_extra_ru(t=t_end)
        if tract is not None:
            extra_ru = tract if extra_ru is None else extra_ru + tract

        imp_scalars = dict(base)
        imp_scalars["cc"] = th1 * base["cc"]
        imp_scalars["cv"] = th1 * base["cv"]
        imp_scalars["accel0"] = 1.0 / k_s
        if "cor" in base:
            imp_scalars["cor"] = th1 * base["cor"]

        bc_values = self._bc_values(t=t_end)
        x = self._apply_bc_values_to_x(x_old, t=t_end)

        def residual_norm(xv):
            return float(torch.linalg.vector_norm(op.residual(
                xv, bc_values, imp_scalars, source_q, extra_ru)))

        res = residual_norm(x)
        res0 = res
        for _ in range(self._maxiter):
            if res <= max(self._tol, 1.0e1 * self._tol * res0):
                break
            r = op.residual(x, bc_values, imp_scalars, source_q, extra_ru)

            dx = solver_linear_step(self, op, space, x, imp_scalars,
                                    source_q, -r)
            x = x + dx
            res = residual_norm(x)
        else:
            raise RuntimeError(
                f"theta substep Newton did not converge: {res:.3e}")
        self._store_residual_context(imp_scalars, source_q, extra_ru)
        return x
