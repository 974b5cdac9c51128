"""Monolithic fully-implicit BDF solver (counterpart of
``navierstokes_tpu/solvers/bdf.py``).

The variable-step BDF acceleration ``sum_i alpha_i u_i / k`` joins the
stationary momentum/mass forms in one coupled Newton solve per step, with
tolerances abs = tol, rel = 10 * tol, and an error on non-convergence.
Setup happens once; per-step changes (dt, alpha, BC values at the new
time) enter as new coefficient values and data.
"""

from __future__ import annotations

import time

import torch

from navierstokes_tpu_torch.linalg.direct import HostSparseLU
from navierstokes_tpu_torch.solvers.stationary import solver_linear_step
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.timestepping import BDFTimeStepping


class ImplicitBDFSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None, *,
                 device=None, dtype=None):
        assert isinstance(time_stepping, BDFTimeStepping)
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter, form_viscous_term,
                         linear_solver, device=device, dtype=dtype)
        self._lu_cache = None
        self.lu_factorizations = 0

    def _frozen_lu(self, x, scalars, source_q):
        """Modified-Newton factorization cache (``linear_solver=
        "frozen_lu"``).

        For smooth transients (e.g. marching a saturated limit cycle) the
        Jacobian changes slowly, so one SuperLU factorization serves many
        iterations *and* many steps; the Newton loop invalidates the cache
        whenever the contraction rate degrades, which bounds the extra
        iterations the lagged Jacobian costs.
        """
        if self._lu_cache is None:
            csr = self._operator.jacobian_csr(x, scalars, source_q)
            self._lu_cache = HostSparseLU(csr)
            self.lu_factorizations += 1
        return self._lu_cache

    def _solve_time_step(self, next_time):
        op = self._operator
        space = self._space
        k = self._next_step_size
        alpha = self._alpha

        scalars = self._scalars()
        scalars["accel0"] = alpha[0] / k

        # BDF history: sum_{i>=1} (alpha_i / k) u_i at quadrature points
        history = None
        for i in range(1, len(alpha)):
            if alpha[i] == 0.0:
                continue
            u_i, _ = space.split(self._solutions[i])
            term = (alpha[i] / k) * op.u_at_quad(u_i)
            history = term if history is None else history + term
        source_q = self._momentum_source(t=next_time, extra_quad=history)

        bc_values = self._bc_values(t=next_time)
        extra_ru = self._traction_extra_ru(t=next_time)

        x = self._apply_bc_values_to_x(self._solutions[0], t=next_time)

        def residual_norm(xv):
            return float(torch.linalg.vector_norm(
                op.residual(xv, bc_values, scalars, source_q, extra_ru)))

        t0 = time.perf_counter()
        res = residual_norm(x)
        res0 = res
        tol = self._tol
        rtol = 1.0e1 * self._tol
        frozen = self._linear_solver == "frozen_lu"
        iterations = 0
        for iterations in range(1, self._maxiter + 1):
            if res <= max(tol, rtol * res0):
                iterations -= 1
                break
            r = op.residual(x, bc_values, scalars, source_q, extra_ru)

            if frozen:
                dx = self._frozen_lu(x, scalars, source_q).solve(-r)
            else:
                dx = solver_linear_step(self, op, space, x, scalars,
                                        source_q, -r)
            x = x + dx
            res_prev, res = res, residual_norm(x)
            if frozen and res > 0.4 * res_prev \
                    and res > max(tol, rtol * res0):
                # slow contraction of the modified-Newton iteration:
                # refresh the frozen factorization at the current iterate
                self._lu_cache = None
        else:
            raise RuntimeError(
                f"Newton iteration did not converge: residual {res:.3e}")

        self.monitor.record("nonlinear_solve", phase="bdf_step",
                            step=self._time_stepping.step_number,
                            time=next_time, iterations=iterations,
                            initial_residual=res0, residual=res,
                            seconds=time.perf_counter() - t0)
        self._solutions[0] = x
        self._store_residual_context(scalars, source_q, extra_ru)
