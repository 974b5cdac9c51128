"""IMEX (implicit-explicit) multistep solver: CNAB / mCNAB / CNLF / SBDF2
(counterpart of ``navierstokes_tpu/solvers/imex.py``).

Per step with weights alpha (time derivative), beta (explicit convection
extrapolation), gamma (implicit/explicit viscous splitting):

  M sum_i alpha_i u_{n+1-i} / k
    + gamma0 Av(u_{n+1}) + gamma1 Av(u_n) + gamma2 Av(u_{n-1})
    + beta0 N(u_n) + beta1 N(u_{n-1})
    + grad p_{n+1} + incompressibility(u_{n+1}) = f

with Av the viscous (+Coriolis) operator and N the convective one.  The
implicit system is *linear* in (u_{n+1}, p_{n+1}): one sparse solve per
step, no Newton iteration.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.solvers.stationary import solver_linear_step
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.timestepping import IMEXTimeStepping


class IMEXSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None, *,
                 device=None, dtype=None):
        assert isinstance(time_stepping, IMEXTimeStepping)
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter, form_viscous_term,
                         linear_solver, device=device, dtype=dtype)

    def _update_time_stepping_coefficients(self):
        ts = self._time_stepping
        self._next_step_size = ts.get_next_step_size()
        self._alpha = tuple(ts.alpha)
        self._beta = tuple(ts.beta)
        self._gamma = tuple(ts.gamma)

    def solve(self):
        if not self._setup_done:
            self._setup_problem()
        if (not hasattr(self, "_alpha")
                or self._time_stepping.coefficients_changed):
            self._update_time_stepping_coefficients()
        self._solve_time_step(self._time_stepping.next_time)
        if self._mean_pressure_value is not None:
            self._shift_mean_pressure()

    def _solve_time_step(self, next_time):
        op = self._operator
        space = self._space
        k = self._next_step_size
        alpha, beta, gamma = self._alpha, self._beta, self._gamma
        base = self._scalars()

        # explicit contributions, pre-scattered onto the velocity block
        extra_ru = None

        def add_image(u_level, cc_w, cv_w, cor_w):
            nonlocal extra_ru
            if cc_w == 0.0 and cv_w == 0.0:
                return
            sc = dict(base)
            sc["cc"] = cc_w * base["cc"]
            sc["cv"] = cv_w * base["cv"]
            sc["cp"] = 0.0
            sc["accel0"] = 0.0
            if "cor" in base:
                sc["cor"] = cor_w * base["cor"]
            img = op.velocity_operator_image(u_level, sc)
            extra_ru = img if extra_ru is None else extra_ru + img

        u_n, _ = space.split(self._solutions[1])
        u_nm1, _ = space.split(self._solutions[2]) \
            if len(self._solutions) > 2 else (u_n, None)
        # beta-extrapolated convection at levels n, n-1 (explicit);
        # gamma-weighted viscous history (implicit-explicit splitting)
        add_image(u_n, beta[0], gamma[1], gamma[1])
        add_image(u_nm1, beta[1], gamma[2], gamma[2])

        # BDF-like history in the time-derivative term
        history = None
        for i in (1, 2):
            if i >= len(self._solutions) or alpha[i] == 0.0:
                continue
            u_i, _ = space.split(self._solutions[i])
            term = (alpha[i] / k) * op.u_at_quad(u_i)
            history = term if history is None else history + term
        source_q = self._momentum_source(t=next_time, extra_quad=history)

        tract = self._traction_extra_ru(t=next_time)
        if tract is not None:
            extra_ru = tract if extra_ru is None else extra_ru + tract

        imp = dict(base)
        imp["cc"] = 0.0                      # convection fully explicit
        imp["cv"] = gamma[0] * base["cv"]
        imp["accel0"] = alpha[0] / k
        if "cor" in base:
            imp["cor"] = gamma[0] * base["cor"]

        bc_values = self._bc_values(t=next_time)
        x = self._apply_bc_values_to_x(self._solutions[0], t=next_time)

        # the implicit problem is linear: a single Newton step is exact
        r = op.residual(x, bc_values, imp, source_q, extra_ru)

        dx = solver_linear_step(self, op, space, x, imp, source_q, -r)
        x = x + dx
        res = float(torch.linalg.vector_norm(op.residual(
            x, bc_values, imp, source_q, extra_ru)))
        if not res <= max(self._tol * 1e3, 1e-8):
            raise RuntimeError(f"IMEX linear solve residual too large: "
                               f"{res:.3e}")
        self._solutions[0] = x
        self._store_residual_context(imp, source_q, extra_ru)
