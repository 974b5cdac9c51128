"""Stationary Navier-Stokes solver: hybrid Picard -> Newton iteration
(counterpart of ``navierstokes_tpu/solvers/stationary.py``).

Picard iteration (hand-linearized convective term) to a coarse
tolerance, then Newton (exact Jacobian by forward-mode AD) to the final
tolerance, with the initial-residual tolerance correction and the final
residual assertion of the reference.

Linear solves: a dense LU on the device for validation sizes, SuperLU on
the host for larger systems on the CPU, and the matrix-free
PCD-preconditioned FGMRES on the card, where no sparse factorization
runs; ``linear_solver`` overrides the choice.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.linalg.direct import HostSparseLU, dense_solve
from navierstokes_tpu_torch.linalg.krylov import gmres, jacobi_preconditioner
from navierstokes_tpu_torch.parallel.comm import as_mesh
from navierstokes_tpu_torch.parallel.sharded_mixed import ShardedMixedOperator
from navierstokes_tpu_torch.solvers.base import SolverBase, _auto_linear_mode


def auto_linear_mode(n, device=None) -> str:
    """Default linear-solve strategy by size and device: a dense LU for
    validation sizes, host SuperLU on the CPU and PCD-preconditioned
    FGMRES on the card (``device`` None is the card)."""
    return _auto_linear_mode(n, torch.device(device or "cuda"))


def solve_linear_system(matrix_provider, rhs, n, mode=None):
    """Solve with a strategy from :func:`auto_linear_mode` (on ``rhs``'s
    device).

    ``matrix_provider(kind)`` returns the system matrix as kind
    'dense' | 'csr'.  Returns the solution of A x = rhs.  (The 'pcd' mode
    is handled by the solvers directly via :func:`pcd_linear_solve`,
    since it needs operator context beyond the matrix.)
    """
    if mode is None or mode == "pcd":
        mode = auto_linear_mode(n, rhs.device)
        if mode == "pcd":
            mode = "gmres"  # context-free fallback
    if mode == "frozen_lu":
        # ImplicitBDFSolver's modified-Newton cache; any other path that
        # reaches here wants the equivalent one-shot factorization
        mode = "host_lu"
    assert mode in ("dense", "host_lu", "csr", "gmres"), \
        f"unknown linear solver mode {mode!r}"
    if mode == "dense":
        return dense_solve(matrix_provider("dense"), rhs)
    if mode == "host_lu":
        return HostSparseLU(matrix_provider("csr")).solve(rhs)
    csr = matrix_provider("csr")
    M = jacobi_preconditioner(csr.diagonal())
    x, _ = gmres(csr, rhs, tol=1e-12, atol=1e-12, M=M)
    return x


def pcd_linear_solve(solver, operator, space, x, scalars, source_q, rhs,
                     picard, monitor=None):
    """Matrix-free PCD-FGMRES solve of J(x) dx = rhs.

    The :class:`MatrixFreePCD` context (AMG hierarchies, lumped mass) is
    built once per solver and reused across Newton iterations, time steps
    and Reynolds-continuation stages.
    """
    from navierstokes_tpu_torch.linalg.block_precond import MatrixFreePCD

    # the velocity-block AMG hierarchy folds a reaction shift ~ accel0/cv
    # into the scalar stiffness; rebuild (host-side, once) when the ratio
    # drifts by more than ~2x (transient steps with changing dt)
    accel0 = float(scalars.get("accel0", 0.0) or 0.0)
    shift = accel0 / float(scalars["cv"])
    bucket = (-1 if shift <= 0.0
              else int(round(math.log2(max(shift, 1e-30)))))
    # STEADY convective systems beyond Re ~ 200 get the grad-div /
    # augmented-Lagrangian Schur approximation (gamma = 0.3); transient
    # systems are mass-dominated -- the well-preconditioned regime -- and
    # keep gamma = 0.  NS_PCD_GRAD_DIV still overrides either way.
    gamma = 0.3 if (accel0 == 0.0 and float(scalars["cv"]) <= 1.0 / 200.0) \
        else 0.0
    ctx = getattr(solver, "_pcd_ctx", None)
    if ctx is None or ctx.op is not operator \
            or getattr(ctx, "_shift_bucket", -1) != bucket \
            or getattr(ctx, "_gamma_default", None) != gamma:
        ctx = MatrixFreePCD(operator,
                            helmholtz_shift=0.0 if bucket < 0
                            else 2.0 ** bucket,
                            grad_div=gamma)
        ctx._shift_bucket = bucket
        ctx._gamma_default = gamma
        solver._pcd_ctx = ctx
    # inexact-Newton forcing: Picard steps only need coarse updates; Newton
    # steps get eta = 1e-6 relative (enough to preserve the outer
    # contraction down to the 1e-10 contract) with an absolute floor tied
    # to the nonlinear target
    nl_tol = getattr(solver, "_tol", 1e-10)
    dx, res, its = ctx.solve(x, rhs, scalars, source_q, picard=picard,
                             tol=1e-3 if picard else 1e-6,
                             atol=0.01 * nl_tol)
    if monitor is not None:
        monitor.record("linear_solve", method="fgmres+pcd-matfree",
                       iterations=int(its), residual=float(res))
    return dx


def solver_linear_step(solver, operator, space, x, scalars, source_q, rhs,
                       picard=False):
    """Shared linear-step dispatch used by all monolithic solvers."""
    mode = solver._linear_solver or auto_linear_mode(space.n_dofs,
                                                     solver._device)
    if mode == "pcd":
        return pcd_linear_solve(solver, operator, space, x, scalars,
                                source_q, rhs, picard, solver.monitor)

    def provider(kind):
        if kind == "dense":
            return operator.jacobian_dense(x, scalars, source_q,
                                           picard=picard)
        return operator.jacobian_csr(x, scalars, source_q, picard=picard)

    return solve_linear_system(provider, rhs, space.n_dofs, mode)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x))


class StationarySolverBase(SolverBase):
    """Stationary solver with Picard->Newton continuation.

    ``device`` / ``dtype``: where and in which precision the state lives
    (default: the card, ``config.default_dtype``; the CPU only with
    ``device="cpu"``).  ``device_mesh`` (a ``parallel.comm.DeviceMesh`` or
    a plain sequence of devices) shards the residual and Jacobian sweeps
    over its shards' cells (``parallel/sharded_mixed.py``) and makes the
    matrix-free ``pcd`` mode the default linear solve; the state then
    lives on shard 0's device, which ``device`` must be if given.
    """

    def __init__(self, mesh, boundary_markers, form_convective_term="standard",
                 tol=None, maxiter=50, tol_picard=1e-2, maxiter_picard=10,
                 form_viscous_term="reduced", linear_solver=None,
                 device_mesh=None, *, device=None, dtype=None):
        device_mesh = as_mesh(device_mesh)
        if device_mesh is not None:
            if device is None:
                device = device_mesh.devices[0]
            elif torch.device(device) != device_mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's shard "
                                 f"0 ({device_mesh.devices[0]})")
            # the PCD mode is the only matrix-free linear path, so it
            # becomes the default
            if linear_solver is None:
                linear_solver = "pcd"
        super().__init__(mesh, boundary_markers, form_convective_term,
                         form_viscous_term, device=device, dtype=dtype)
        if tol is None:
            tol = config.default_tol(self._dtype)
        assert tol > 0.0 and tol_picard > 0.0
        assert maxiter > 0 and maxiter_picard > 0
        self._tol = tol
        self._tol_picard = tol_picard
        self._maxiter = maxiter
        self._maxiter_picard = maxiter_picard
        self._device_mesh = device_mesh
        self._linear_solver = linear_solver
        self._solution = None

    def _setup_problem(self):
        assert self._equation_coefficients is not None
        self._setup_space()
        self._setup_operator()
        if self._device_mesh is not None:
            self._operator = ShardedMixedOperator(self._operator,
                                                  self._device_mesh)
        self._compile_boundary_conditions()
        self._solution = torch.zeros(self._space.n_dofs, dtype=self._dtype,
                                     device=self._device)

    def _linear_step(self, x, scalars, source_q, bc_values, extra_ru, picard):
        """One linearized update: solve J dx = -F."""
        op = self._operator
        r = op.residual(x, bc_values, scalars, source_q, extra_ru)
        return solver_linear_step(self, op, self._space, x, scalars,
                                  source_q, -r, picard)

    def _residual_context(self):
        return (self._operator, self._scalars(), self._momentum_source(),
                self._bc_values(), self._traction_extra_ru())

    def solve(self):
        """Hybrid Picard->Newton solve."""
        if self._solution is None:
            self._setup_problem()

        op, scalars, source_q, bc_values, extra_ru = \
            self._residual_context()
        x = self._apply_bc_values_to_x(self._solution)

        def residual_norm(xv):
            return _norm(op.residual(xv, bc_values, scalars, source_q,
                                     extra_ru))

        residual = residual_norm(x)

        # tolerance correction: guarantee at least one Picard sweep even for
        # tiny initial residuals
        tol_picard = self._tol_picard
        if residual < tol_picard and residual > 0.0:
            order = math.floor(math.log10(residual))
            tol_picard = (residual / 10.0 ** order - 1.0) * 10.0 ** order

        t0 = time.perf_counter()
        res0 = residual

        print("Starting Picard iteration...")
        picard_its = 0
        for _ in range(self._maxiter_picard):
            if residual <= tol_picard:
                break
            dx = self._linear_step(x, scalars, source_q, bc_values, extra_ru,
                                   picard=True)
            x = x + dx
            residual = residual_norm(x)
            picard_its += 1

        print("Starting Newton iteration...")
        newton_its = 0
        for _ in range(self._maxiter):
            if residual <= self._tol:
                break
            dx = self._linear_step(x, scalars, source_q, bc_values, extra_ru,
                                   picard=False)
            # backtracking guard: an inexact (iterative) linear solve can
            # overshoot where an exact LU step never does -- halve the
            # step until the residual decreases (full steps are taken
            # whenever they work, preserving quadratic convergence)
            step = 1.0
            for _bt in range(5):
                trial = residual_norm(x + step * dx)
                if trial < residual or step < 0.1:
                    break
                step *= 0.5
            x = x + step * dx
            residual = trial
            newton_its += 1

        self.monitor.record("nonlinear_solve", phase="picard+newton",
                            iterations=picard_its + newton_its,
                            picard_iterations=picard_its,
                            newton_iterations=newton_its,
                            initial_residual=res0, residual=residual,
                            seconds=time.perf_counter() - t0)
        self._solution = self._gauge_pressure(x)
        self._store_residual_context(scalars, source_q, extra_ru)
        assert residual <= self._tol, "Newton iteration did not converge."

    def solve_ptc(self, tol=None, sigma0=20.0, sigma_min=1e-3,
                  maxiter=200, lin_tol=1e-3):
        """Pseudo-transient continuation (SER): the robust high-Re path.

        PTC iterates

            (sigma_k M + J(x_k)) dx = -F(x_k),   x += dx,

        shrinking sigma_k by the switched-evolution-relaxation rule
        sigma_{k+1} = sigma_k * ||F_k|| / ||F_{k-1}|| (clamped), which
        recovers Newton as sigma -> 0 while every linear system stays
        well-preconditioned by the matrix-free PCD.
        """
        from navierstokes_tpu_torch.linalg.block_precond import MatrixFreePCD

        if self._solution is None:
            self._setup_problem()
        if tol is None:
            tol = self._tol

        op, scalars, source_q, bc_values, extra_ru = \
            self._residual_context()
        x = self._apply_bc_values_to_x(self._solution)

        def res_norm(xv):
            return _norm(op.residual(xv, bc_values, scalars, source_q,
                                     extra_ru))

        t0 = time.perf_counter()
        res = res_norm(x)
        res_prev = res
        sigma = sigma0
        n_lin_total = 0
        # ONE preconditioner context for the whole sweep: the velocity AMG
        # hierarchy is built once at the geometric mean of the sigma range
        # (mass shifts only improve conditioning)
        shift0 = math.sqrt(sigma0 * sigma_min) / float(scalars["cv"])
        ctx = getattr(self, "_pcd_ctx", None)
        if ctx is None or ctx.op is not op or \
                getattr(ctx, "_shift_bucket", None) != ("ptc", sigma0):
            ctx = MatrixFreePCD(op, helmholtz_shift=shift0)
            ctx._shift_bucket = ("ptc", sigma0)
            self._pcd_ctx = ctx
        verbose = os.environ.get("NS_TPU_VERBOSE", "") == "1"
        k = 0
        for k in range(maxiter):
            if res <= tol:
                break
            r = op.residual(x, bc_values, scalars, source_q, extra_ru)
            scal_j = dict(scalars)
            scal_j["accel0"] = sigma
            dx, lres, its = ctx.solve(x, -r, scal_j, source_q,
                                      picard=False, tol=lin_tol,
                                      atol=0.01 * tol)
            n_lin_total += int(its)
            x_new = x + dx
            res_new = res_norm(x_new)
            if verbose:
                print(f"PTC step {k}: ||F|| = {res_new:.3e} "
                      f"(sigma {sigma:.2e}, {int(its)} lin its)")
            # accept descent; during the strongly-damped early phase also
            # accept bounded uphill moves (<= 2x)
            if res_new < res or (sigma >= 0.25 * sigma0
                                 and res_new <= 2.0 * res):
                # accept; SER shrink (clamped to x4 decrease per step)
                x = x_new
                res_prev, res = res, res_new
                sigma = max(sigma * max(res / max(res_prev, 1e-300), 0.25),
                            sigma_min)
            else:
                sigma = min(4.0 * sigma, 1e6)   # reject: strengthen mass
        self.monitor.record("nonlinear_solve", phase="ptc",
                            iterations=k, residual=res,
                            linear_iterations=n_lin_total,
                            seconds=time.perf_counter() - t0)
        self._solution = self._gauge_pressure(x)
        self._store_residual_context(scalars, source_q, extra_ru)
        assert res <= tol, f"PTC did not converge: {res:.3e}"

    def solve_refined(self, tol=1.0e-10, maxiter=30):
        """Mixed-precision solve: device Krylov in the solver's dtype +
        float64 host residual.

        After the device-precision :meth:`solve`, iterative refinement
        evaluates the true float64 residual on the host
        (``assembly/host_reference.py``), solves the correction with the
        matrix-free PCD machinery on the device, and accumulates the
        iterate in float64.  In float64 this is a no-op after the first
        residual check.

        When the device correction stops halving the residual (a direction
        below float32 resolution), refinement switches to corrections from
        the host float64 Newton Jacobian (exact central-difference element
        assembly, SciPy sparse LU).

        Returns the float64 solution (also stored as
        ``self.solution_f64``); ``self.solution`` keeps the device copy.
        """
        from scipy.sparse.linalg import splu

        from navierstokes_tpu_torch.assembly.host_reference import (
            jacobian_f64, residual_f64)
        from navierstokes_tpu_torch.linalg.block_precond import MatrixFreePCD

        if self._solution is None:
            self.solve()

        op = self._operator
        ctx = getattr(self, "_pcd_ctx", None)
        if ctx is None or ctx.op is not op:
            ctx = MatrixFreePCD(op)
            self._pcd_ctx = ctx

        scalars = self._scalars()
        source_q = self._momentum_source()
        source64 = (source_q.detach().cpu().numpy().astype(np.float64)
                    if torch.is_tensor(source_q) and source_q.ndim == 3
                    else 0.0)
        bcv64 = self._bc_values().cpu().numpy().astype(np.float64)

        x = self._solution.cpu().numpy().astype(np.float64)
        bc_dofs = np.asarray(self._bc_dofs_all)
        x[bc_dofs] = bcv64
        extra64 = self._traction_extra_ru_f64()
        kw = dict(form_convective_term=self._form_convective_term,
                  form_viscous_term=self._form_viscous_term)

        t0 = time.perf_counter()
        history = []
        lu = None
        n_lu = 0
        for k in range(maxiter):
            r = residual_f64(self._space, x, bc_dofs, bcv64, scalars,
                             source_q=source64, extra_ru=extra64, **kw)
            rn = float(np.linalg.norm(r))
            history.append(rn)
            if rn <= tol:
                break
            # stall detection: once the device correction stops halving
            # the residual, switch to host-f64 LU corrections
            stalled = (lu is not None
                       or (k >= 2 and rn > 0.5 * history[-2]))
            if stalled:
                if lu is None:
                    pin = self._pressure_pin_dof
                    if pin is None and self._pressure_gauge_dof is not None:
                        pin = self._pressure_gauge_dof
                    A = jacobian_f64(self._space, x, bc_dofs, scalars,
                                     pin_dof=pin, **kw)
                    lu = splu(A.tocsc())
                    n_lu += 1
                rhs = -r
                if self._pressure_pin_dof is None and \
                        self._pressure_gauge_dof is not None:
                    rhs = rhs.copy()
                    rhs[self._pressure_gauge_dof] = 0.0
                x = x + lu.solve(rhs)
                continue
            # normalize the correction solve: keeps the device Krylov in a
            # healthy dynamic range regardless of how small ||F|| gets
            dx, _, _ = ctx.solve(self._tensor(x), self._tensor(-r / rn),
                                 scalars, source_q, picard=False, tol=1e-4,
                                 atol=0.0)
            x = x + rn * dx.cpu().numpy().astype(np.float64)

        self.monitor.record(
            "mixed_precision_refinement", iterations=len(history) - 1,
            residual=history[-1], initial_residual=history[0],
            lu_factorizations=n_lu,
            seconds=time.perf_counter() - t0)
        assert history[-1] <= tol, \
            f"refinement stalled at ||F|| = {history[-1]:.3e}"
        if self._pressure_gauge_dof is not None and \
                self._pressure_pin_dof is None:
            x[self._space.n_velocity_dofs:] -= x[self._pressure_gauge_dof]
        self.solution_f64 = x
        self._solution = self._tensor(x)
        return x


StationarySolver = StationarySolverBase
