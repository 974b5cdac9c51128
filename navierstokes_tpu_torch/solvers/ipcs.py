"""Incremental pressure-correction (IPCS) fractional-step solver
(counterpart of ``navierstokes_tpu/solvers/ipcs.py``).

Three sub-solves per step on the collapsed subspaces,

  1. *diffusion* -- nonlinear velocity step for the intermediate velocity
     u*: BDF acceleration + convection + lagged pressure gradient +
     viscous term, Newton iteration;
  2. *projection* -- pressure Poisson
     (grad p, grad q) = (grad p_old, grad q) - (alpha0/k) (div u*, q)
     with pressure Dirichlet BCs;
  3. *velocity correction* -- mass solve
     (u, w) = (u*, w) - (k/alpha0) (grad(p - p_old), w) with velocity
     Dirichlet BCs.

With ``linear_solver=None`` (the default) step 1 is a matrix-free Newton:
the Jacobian action of the Dirichlet-masked residual inside GMRES,
preconditioned by a component-wise AMG V-cycle, and steps 2 and 3 are
AMG- / Jacobi-preconditioned CG.  An explicit ``linear_solver`` takes the
assembled velocity Jacobian instead.

``scheme`` selects the pressure-correction variant:

* ``"incremental"`` (default) -- the step above;
* ``"chorin"``      -- non-incremental: no lagged pressure in the
  diffusion step, pressure recomputed from scratch;
* ``"phi"``         -- increment form with pressure extrapolation
  eta = [2, -1] in the diffusion step and a separate increment field,
  p_{n+1} = p_n + phi.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch.assembly.operators import (PressurePoissonOperator,
                                                       VelocityOperator)
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu_torch.linalg.amg import (AMG, pressure_laplacian_scipy,
                                               velocity_stiffness_scipy)
from navierstokes_tpu_torch.linalg.krylov import gmres_solve, masked_spd_solve
from navierstokes_tpu_torch.solvers.stationary import solve_linear_system
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.timestepping import BDFTimeStepping


def _div(grad):
    return torch.diagonal(grad, dim1=2, dim2=3).sum(dim=-1)


class IPCSSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None,
                 scheme="incremental", *, device=None, dtype=None):
        assert isinstance(time_stepping, BDFTimeStepping)
        assert scheme in ("incremental", "chorin", "phi")
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter, form_viscous_term,
                         linear_solver, device=device, dtype=dtype)
        self._scheme = scheme

    # -- setup ---------------------------------------------------------------
    def _setup_function_spaces(self):
        super()._setup_function_spaces()
        space = self._space
        n = self._n_levels() + 1
        self._velocities = [self._zeros((space.n_unodes, space.dim))
                            for _ in range(n)]
        self._intermediate_velocity = self._zeros((space.n_unodes,
                                                   space.dim))
        self._pressure = self._zeros(space.n_pnodes)
        self._old_pressure = self._zeros(space.n_pnodes)
        self._older_pressure = self._zeros(space.n_pnodes)

    def _setup_scheme(self):
        space = self._space
        kw = dict(device=self._device, dtype=self._dtype)
        self._vel_operator = VelocityOperator(
            space, self._form_convective_term, self._form_viscous_term, **kw)
        self._poisson = PressurePoissonOperator(space, **kw)

        # split Dirichlet data onto the collapsed subspaces
        self._vel_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, self._velocity_bcs, ())
        self._vel_operator.set_bc_dofs(self._vel_dirichlet.dofs)
        self._pres_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, (), [
                bc for bc in self._pressure_bcs
                if bc[0] is not PressureBCType.mean_value])
        p_bc_ranks = (np.asarray(self._pres_dirichlet.dofs, dtype=np.int64)
                      - space.pressure_offset)
        if len(p_bc_ranks) == 0:
            # unconstrained pressure: pin one dof for solvability
            p_bc_ranks = np.array([0], dtype=np.int64)
            self._pressure_pinned = True
        else:
            self._pressure_pinned = False
        mask = np.zeros(space.n_pnodes, dtype=bool)
        mask[p_bc_ranks] = True
        self._p_bc_mask = torch.as_tensor(mask, device=self._device)
        self._p_bc_ranks = p_bc_ranks

        vmask = np.zeros(space.n_unodes * space.dim, dtype=bool)
        vmask[np.asarray(self._vel_dirichlet.dofs, dtype=np.int64)] = True
        self._v_bc_mask = torch.as_tensor(vmask, device=self._device)

        # AMG-CG for the SPD sub-solves, AMG-preconditioned GMRES
        # Newton-Krylov for the diffusion step; an explicit
        # ``linear_solver`` keeps the assembled path
        self._use_fast_linalg = self._linear_solver is None
        if self._use_fast_linalg:
            A_p = pressure_laplacian_scipy(space,
                                           dirichlet_dofs=p_bc_ranks)
            self._amg_p = AMG(A_p, **kw)
            dm, _ = self._operator.velocity_jacobi_diags()
            self._mass_diag_u = torch.repeat_interleave(dm, space.dim)
            self._u_bc_nodes = np.unique(
                np.asarray(self._vel_dirichlet.dofs, np.int64) // space.dim)
            self._amg_u = None
            self._amg_u_shift = None

    def _ensure_diffusion_amg(self, scalars):
        """Component-wise AMG hierarchy on K + (accel0/cv) M: the
        h-independent preconditioner basis for the diffusion-step
        Jacobian cv*(K + shift*M) (the recipe of MatrixFreePCD's velocity
        block).  Rebuilt only when the reaction shift leaves a 4x
        bucket."""
        shift = float(scalars["accel0"]) / float(scalars["cv"])
        if self._amg_u is None or not \
                (0.25 <= shift / self._amg_u_shift <= 4.0):
            Ku = velocity_stiffness_scipy(self._space, mass_shift=shift,
                                          dirichlet_dofs=self._u_bc_nodes)
            self._amg_u = AMG(Ku, device=self._device, dtype=self._dtype)
            self._amg_u_shift = shift

    def _newton_update(self, ustar, bc_values, scalars, p_diffusion,
                       source_q):
        """One Newton update of the diffusion step: the matrix-free
        Jacobian action of the BC-masked residual (identity rows at
        constrained dofs), AMG-preconditioned GMRES.  Returns ``(u_new,
        ||F(u_new)||, ||r + J dx||)`` with the norms as tensors."""
        vop = self._vel_operator
        amg_u = self._amg_u
        u_free = torch.where(self._v_bc_mask, 0.0, 1.0).to(self._dtype)
        dim = self._space.dim
        cv = scalars["cv"]

        def M_u(v):
            z = amg_u.apply(v.reshape(-1, dim)) / cv
            return u_free * z.reshape(-1) + (1.0 - u_free) * v

        r, Jmv = vop.linearize_at(ustar, bc_values, scalars, p_diffusion,
                                  source_q)
        dx = gmres_solve(Jmv, -r, tol=1e-6, restart=30, maxiter=4, M=M_u)
        lin_res = torch.linalg.vector_norm(r + Jmv(dx))
        u_new = ustar + dx
        res_new = torch.linalg.vector_norm(vop.residual(
            u_new, bc_values, scalars, p_diffusion, source_q))
        return u_new, res_new, lin_res

    def _project_and_correct(self, ustar2d, old_p, p_bc_full, v_bc_full, k,
                             alpha0):
        """Projection + velocity correction (both SPD masked-CG solves,
        AMG / Jacobi preconditioned when ``linear_solver`` is None)."""
        scheme = self._scheme
        op = self._operator
        vop = self._vel_operator
        pop = self._poisson
        fast = self._use_fast_linalg
        if not fast:
            cg_tol, cg_cap = 1e-14, None
        elif self._dtype == torch.float64:
            cg_tol, cg_cap = 1e-14, 10 * self._space.n_pnodes
        else:
            # 1e-14 relative is unreachable in f32: the CG would spin to
            # its cap
            cg_tol, cg_cap = 1e-6, 400

        rhs = -(alpha0 / k) * pop.rhs_scalar(_div(op.grad_u_at_quad(ustar2d)))
        if scheme == "incremental":
            rhs = rhs + pop.rhs_grad_dot_gradq(op.grad_p_at_quad(old_p))
        warm = old_p if fast and scheme == "incremental" else None
        sol, pres_res = masked_spd_solve(
            pop.stiffness_matvec, rhs, self._p_bc_mask, p_bc_full,
            tol=cg_tol, maxiter=cg_cap,
            M=self._amg_p.apply if fast else None, x0=warm)
        if scheme == "incremental":
            pressure = sol
            grad_correction = pressure - old_p
        elif scheme == "chorin":
            pressure = sol
            grad_correction = pressure
        else:  # phi increment
            pressure = old_p + sol
            grad_correction = sol

        grad_dp = op.grad_p_at_quad(grad_correction)
        rhs_u = vop.mass_rhs(op.u_at_quad(ustar2d) - (k / alpha0) * grad_dp)
        u_new, mass_res = masked_spd_solve(
            vop.mass_matvec, rhs_u, self._v_bc_mask, v_bc_full, tol=cg_tol,
            maxiter=cg_cap, diag=self._mass_diag_u if fast else None,
            x0=ustar2d.reshape(-1) if fast else None)
        return u_new, pressure, pres_res, mass_res

    def set_initial_conditions(self, initial_conditions):
        super().set_initial_conditions(initial_conditions)
        u0, p0 = self._space.split(self._solutions[0])
        self._velocities[0] = u0
        self._velocities[1] = u0
        self._intermediate_velocity = u0
        self._pressure = p0
        self._old_pressure = p0
        self._older_pressure = p0

    # -- stepping ------------------------------------------------------------
    def advance_time(self):
        super().advance_time()
        for i in range(len(self._velocities) - 1, 0, -1):
            self._velocities[i] = self._velocities[i - 1]
        self._older_pressure = self._old_pressure
        self._old_pressure = self._pressure

    def _vel_bc_values(self, t):
        return self._tensor(self._vel_dirichlet.values(t))

    def _solve_time_step(self, next_time):
        space = self._space
        vop = self._vel_operator
        k = self._next_step_size
        alpha = self._alpha

        scalars = self._scalars()
        scalars["accel0"] = alpha[0] / k

        # BDF history from the velocity ring
        history = None
        for i in range(1, len(alpha)):
            if alpha[i] == 0.0:
                continue
            term = (alpha[i] / k) * self._operator.u_at_quad(
                self._velocities[i])
            history = term if history is None else history + term
        source_q = self._momentum_source(t=next_time, extra_quad=history)

        # pressure entering the diffusion step, per variant
        if self._scheme == "chorin":
            p_diffusion = torch.zeros_like(self._old_pressure)
        elif self._scheme == "phi":
            # eta = [2, -1] extrapolation
            p_diffusion = 2.0 * self._old_pressure - self._older_pressure
        else:
            p_diffusion = self._old_pressure

        # (1) diffusion step: Newton for the intermediate velocity
        bc_values = self._vel_bc_values(next_time)
        ustar = self._intermediate_velocity.reshape(-1).index_copy(
            0, vop.bc_dofs, bc_values)

        def res_norm(uv):
            return float(torch.linalg.vector_norm(
                vop.residual(uv, bc_values, scalars, p_diffusion,
                             source_q)))

        res = res_norm(ustar)
        res0 = res
        newton_its = 0
        if self._use_fast_linalg:
            self._ensure_diffusion_amg(scalars)
        for _ in range(self._maxiter):
            if res <= max(self._tol, 1.0e1 * self._tol * res0):
                break
            if self._use_fast_linalg:
                ustar, res_dev, lin_res = self._newton_update(
                    ustar, bc_values, scalars, p_diffusion, source_q)
                res = float(res_dev)
                self.monitor.record("linear_solve", residual=lin_res,
                                    label="ipcs-diffusion-gmres")
            else:
                r = vop.residual(ustar, bc_values, scalars, p_diffusion,
                                 source_q)

                def provider(kind):
                    J = vop.jacobian_csr(ustar, scalars, p_diffusion,
                                         source_q)
                    return J.todense() if kind == "dense" else J

                dx = solve_linear_system(provider, -r, vop.n_dofs,
                                         self._linear_solver)
                ustar = ustar + dx
                res = res_norm(ustar)
            newton_its += 1
        else:
            raise RuntimeError(
                f"IPCS diffusion step did not converge: residual {res:.3e}")
        self.monitor.record("nonlinear_solve", phase="ipcs-diffusion",
                            iterations=newton_its, residual=res,
                            initial_residual=res0)
        self._intermediate_velocity = ustar.reshape(-1, space.dim)

        # (2)+(3) pressure projection (Poisson, SPD, masked CG) and
        # velocity correction (mass solve, SPD, masked CG)
        p_bc_full = self._zeros(space.n_pnodes)
        if not self._pressure_pinned and self._scheme != "phi":
            # "phi" solves for the increment: homogeneous data at the
            # pressure Dirichlet nodes
            p_bc_full[torch.as_tensor(self._p_bc_ranks,
                                      device=self._device)] = self._tensor(
                self._pres_dirichlet.values(next_time))
        v_bc_full = self._zeros(space.n_unodes * space.dim).index_copy(
            0, vop.bc_dofs, bc_values)

        u_new, self._pressure, pres_res, mass_res = \
            self._project_and_correct(self._intermediate_velocity,
                                      self._old_pressure, p_bc_full,
                                      v_bc_full, k, alpha[0])
        self.monitor.record("linear_solve", residual=pres_res,
                            label="ipcs-poisson-cg")
        self.monitor.record("linear_solve", residual=mass_res,
                            label="ipcs-mass-cg")
        self._velocities[0] = u_new.reshape(-1, space.dim)

        self._solutions[0] = space.join(self._velocities[0], self._pressure)

    def _shift_mean_pressure(self):
        mean = self._operator.mean_pressure(self._pressure)
        self._pressure = self._pressure - (mean - self._mean_pressure_value)
        self._solutions[0] = self._space.join(self._velocities[0],
                                              self._pressure)

    @property
    def solution(self):
        self._solutions[0] = self._space.join(self._velocities[0],
                                              self._pressure)
        return self._solutions[0]
