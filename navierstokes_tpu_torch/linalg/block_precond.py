"""Block (PCD) preconditioning for the monolithic saddle-point system
(counterpart of ``navierstokes_tpu/linalg/block_precond.py``).

The Newton/Picard Jacobian has the block form

    J = [ F  G ]      F: velocity convection-diffusion(-reaction)
        [ D  0 ]      G: pressure gradient, D: divergence

(with identity rows mixed in at Dirichlet dofs).  The PCD
(pressure-convection-diffusion, Kay/Loghin/Wathen) right preconditioner
approximates

    P^{-1} [r_u, r_p]:
        z_p = -S^{-1} r_p,   S^{-1} ~= Lp^{-1} Fp Mp^{-1}
        z_u = F^{-1} (r_u - G z_p)

where Lp / Mp are the pressure Laplacian / mass and
Fp = accel0 Mp + nu Lp + N_p(u) is the pressure-space
convection-diffusion operator.  Every sub-solve is a fixed sweep
(``tol = 0``), so applying the preconditioner reads nothing back from the
device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from navierstokes_tpu_torch.assembly.operators import (MixedOperator,
                                                       PressurePoissonOperator)
from navierstokes_tpu_torch.linalg.amg import (AMG, pressure_laplacian_scipy,
                                               pressure_mass_scipy,
                                               velocity_stiffness_scipy)
from navierstokes_tpu_torch.linalg.fgmres import fgmres_device
from navierstokes_tpu_torch.linalg.krylov import (bicgstab_solve, cg_solve,
                                                  gmres_solve)


class _BlockMasks:
    """Pressure and velocity masks of the constrained rows of a mixed
    operator: the preconditioners act as the identity there."""

    def _init_masks(self, mixed_op):
        space = mixed_op.space
        self.n_u = space.n_velocity_dofs
        self.n_p = space.n_pnodes
        dev, dt = mixed_op.device, mixed_op.dtype
        bc = np.asarray(mixed_op._bc_dofs_np)
        self.p_bc = bc[bc >= self.n_u] - self.n_u
        mask = np.zeros(self.n_p, dtype=bool)
        mask[self.p_bc] = True
        self.p_bc_mask = torch.as_tensor(mask, device=dev)
        self.p_free = torch.where(self.p_bc_mask, 0.0, 1.0).to(dt)
        self.enclosed = len(self.p_bc) == 0
        self.u_bc = bc[bc < self.n_u]
        vmask = np.zeros(self.n_u, dtype=bool)
        vmask[self.u_bc] = True
        self.u_free = torch.where(torch.as_tensor(vmask, device=dev),
                                  0.0, 1.0).to(dt)
        self.pop = PressurePoissonOperator(space, device=dev, dtype=dt)

    def _project(self, r):
        if self.enclosed:
            return r - torch.mean(r)
        return self.p_free * r


class PCDPreconditioner(_BlockMasks):
    """PCD application bound to a mixed operator + current state (the
    first-generation layer: fixed CG sweeps for Lp and Mp, a BiCGStab
    sweep for F, all through the given Jacobian matvec)."""

    def __init__(self, mixed_op: MixedOperator, J_matvec, *, visc, accel0,
                 u_current, f_iters=8, lp_iters=25, mp_iters=4):
        self._init_masks(mixed_op)
        self.J = J_matvec
        self.f_iters = f_iters
        self.lp_iters = lp_iters
        self.mp_iters = mp_iters
        self.u_q = mixed_op.u_at_quad(u_current)
        self.visc = visc
        self.accel0 = accel0
        self.apply = self._apply_impl

    # -- block applies through the full Jacobian ------------------------------
    def _F_apply(self, v):
        return self.J(torch.cat([v, v.new_zeros(self.n_p)]))[:self.n_u]

    def _G_apply(self, p):
        return self.J(torch.cat([p.new_zeros(self.n_u), p]))[:self.n_u]

    # -- pressure-space solves ---------------------------------------------
    def _lp_solve(self, r):
        r = self._project(r)

        def A(v):
            y = self.pop.stiffness_matvec(self._project(v))
            return self._project(y) + (1.0 - self.p_free) * v \
                if not self.enclosed else self._project(y)

        return self._project(cg_solve(A, r, tol=0.0, maxiter=self.lp_iters))

    def _mp_solve(self, r):
        return cg_solve(self.pop.mass_matvec, r, tol=0.0,
                        maxiter=self.mp_iters)

    def _fp_apply(self, p):
        return (self.accel0 * self.pop.mass_matvec(p)
                + self.visc * self.pop.stiffness_matvec(p)
                + self.pop.convection_matvec(p, self.u_q))

    # -- the preconditioner ------------------------------------------------
    def _apply_impl(self, r):
        r_u, r_p = r[:self.n_u], r[self.n_u:]
        # Schur approximation: S^{-1} ~= Lp^{-1} Fp Mp^{-1}
        z_p = -self._lp_solve(self._fp_apply(self._mp_solve(r_p)))
        z_p = torch.where(self.p_bc_mask, r_p, z_p)
        # velocity solve: F z_u = r_u - G z_p (inexact BiCGStab sweep)
        rhs = r_u - self._G_apply(z_p)
        z_u = bicgstab_solve(self._F_apply, rhs, tol=0.0,
                             maxiter=self.f_iters)
        z_u = self.u_free * z_u + (1.0 - self.u_free) * rhs
        return torch.cat([z_u, z_p])


class MatrixFreePCD(_BlockMasks):
    """Setup-once PCD solver for the monolithic Newton systems.

    - the Jacobian is never assembled: ``MixedOperator.linearize_at``
      provides the matvec (one residual-like sweep per application);
    - the pressure-Laplacian solve is an AMG V-cycle (h-independent
      quality; ``linalg/amg.py``) instead of a fixed CG sweep;
    - Mp^{-1} is a short lumped-preconditioned CG on the consistent mass;
    - the velocity block runs one GMRES(f_iters) sweep preconditioned by
      an AMG V-cycle on the scalar P2 stiffness applied to both velocity
      components at once (optionally mass-shifted via ``helmholtz_shift``
      ~ accel0/cv);
    - the outer solve is :func:`fgmres_device`: no host read inside a
      restart cycle.

    Setup cost (AMG hierarchies, the lumped mass) is paid once per space + BC
    configuration; the operators it is built from (pressure Laplacian and
    mass) do not change between Newton steps, time steps or Reynolds
    continuation steps.
    """

    def __init__(self, mixed_op: MixedOperator, *, f_iters=15, mp_iters=5,
                 restart=80, max_cycles=6, helmholtz_shift=0.0,
                 grad_div=0.0, amg_kwargs=None):
        # restart=80: GMRES(40) stagnates on convective Newton systems
        # from Re ~ 200; the basis holds 2 * 81 vectors of the system size
        restart = int(os.environ.get("NS_TPU_FGMRES_RESTART", restart))
        max_cycles = int(os.environ.get("NS_TPU_FGMRES_CYCLES", max_cycles))
        # drive the restart cycles one call each from the host (each call
        # warm-starts from the last)
        self.host_cycles = os.environ.get(
            "NS_TPU_FGMRES_HOST_CYCLES", "") == "1"

        # augmented-Lagrangian (grad-div) stabilization (Benzi &
        # Olshanskii 2006): gamma > 0 adds gamma * G Mp^{-1} D to the
        # velocity block of BOTH the system and the residual (same
        # discrete solution -- D u = 0 at convergence) and replaces the
        # PCD Schur sandwich with the AL approximation
        # S^{-1} ~= -(cv + gamma) Mp^{-1}, which is Re- and h-robust, at
        # the price of a stiffer velocity block and one extra Jacobian
        # application per matvec.
        self.grad_div = float(os.environ.get("NS_PCD_GRAD_DIV", grad_div))

        self.op = mixed_op
        space = mixed_op.space
        self.dim = space.dim
        self.f_iters = f_iters
        self.mp_iters = mp_iters
        self.restart = restart
        self.max_cycles = max_cycles
        self._init_masks(mixed_op)
        amg_kw = dict(amg_kwargs or {}, device=mixed_op.device,
                      dtype=mixed_op.dtype)

        # AMG on the pressure Laplacian (regularized if enclosed)
        if self.enclosed:
            K = pressure_laplacian_scipy(space)
            M = pressure_mass_scipy(space)
            shift = 1e-2 * (K.diagonal().mean() / M.diagonal().mean())
            A = pressure_laplacian_scipy(space, mass_shift=shift)
        else:
            A = pressure_laplacian_scipy(space, dirichlet_dofs=self.p_bc)
        self.amg = AMG(A, **amg_kw)

        # lumped pressure mass inverse (Mp^{-1} surrogate)
        pop = self.pop
        self.mp_lumped_inv = 1.0 / pop._scatter(
            torch.einsum("cq,qj->cj", pop.W, pop.N1))

        # component-wise AMG on the scalar P2 stiffness: the velocity-block
        # inner solve with plain Jacobi degrades as O(1/h); one V-cycle
        # per GMRES iteration keeps it h-independent.  ``helmholtz_shift``
        # ~ accel0/cv folds a reaction term into the hierarchy.
        u_bc_nodes = np.unique(self.u_bc // space.dim)
        Ku = velocity_stiffness_scipy(space, mass_shift=helmholtz_shift,
                                      dirichlet_dofs=u_bc_nodes)
        self.amg_u = AMG(Ku, **amg_kw)

    # -- preconditioner application ------------------------------------------
    def _apply(self, r, Jmv, u_q, scalars):
        n_u = self.n_u
        r_u, r_p = r[:n_u], r[n_u:]
        accel0 = scalars.get("accel0", 0.0)

        # Schur approximation: S^{-1} ~= Lp^{-1} Fp Mp^{-1}.  A short
        # lumped-preconditioned CG on the consistent mass (lumped-only
        # doubles the outer iteration count).
        mp = cg_solve(self.pop.mass_matvec, r_p, tol=0.0,
                      maxiter=self.mp_iters,
                      M=lambda v: self.mp_lumped_inv * v)
        if self.grad_div > 0.0:
            # AL Schur approximation: S^{-1} ~= -(cv + gamma) Mp^{-1}
            z_p = -(scalars["cv"] + self.grad_div) * self._project(mp)
        else:
            fp = (accel0 * self.pop.mass_matvec(mp)
                  + scalars["cv"] * self.pop.stiffness_matvec(mp)
                  + self.pop.convection_matvec(mp, u_q))
            z_p = -self._project(self.amg.apply(self._project(fp)))
        z_p = torch.where(self.p_bc_mask, r_p, z_p)

        # velocity solve: F z_u = r_u - G z_p
        zeros_u = r.new_zeros(n_u)
        zeros_p = r.new_zeros(self.n_p)
        rhs_u = r_u - Jmv(torch.cat([zeros_u, z_p]))[:n_u]

        def F_apply(v):
            return Jmv(torch.cat([v, zeros_p]))[:n_u]

        # one AMG V-cycle on the diffusion part for all components, scaled
        # by 1/cv (F ~ cv * (K + (accel0/cv) M)); constrained dofs pass
        # through
        def M_u(v):
            z = self.amg_u.apply(v.reshape(-1, self.dim))
            z = (z / scalars["cv"]).reshape(-1)
            return self.u_free * z + (1.0 - self.u_free) * v

        # one GMRES(f_iters) sweep: breakdown-free, unlike BiCGStab, whose
        # rho/omega divisions blow up on rough inputs
        z_u = gmres_solve(F_apply, rhs_u, tol=0.0, atol=0.0, maxiter=1,
                          restart=self.f_iters, M=M_u)
        z_u = self.u_free * z_u + (1.0 - self.u_free) * rhs_u
        return torch.cat([z_u, z_p])

    def _augment(self, jvp, rhs):
        """Wrap the Jacobian matvec and rhs with the grad-div term
        ``gamma * G Mp_lumped^{-1} D`` (composed from the system's own
        blocks, so BC/pin rows stay consistent: constrained u rows are
        masked, constrained/mean p rows are projected out)."""
        gamma = self.grad_div
        n_u = self.n_u
        zeros_u = rhs.new_zeros(n_u)

        def aug_u(r_p):
            q = gamma * self.mp_lumped_inv * self._project(r_p)
            return self.u_free * jvp(torch.cat([zeros_u, q]))[:n_u]

        def augmented(v):
            return torch.cat([v[:n_u] + aug_u(v[n_u:]), v[n_u:]])

        return (lambda v: augmented(jvp(v))), augmented(rhs)

    def _solve_once(self, x, rhs, x0, scalars, source_q, picard, tol, atol,
                    max_cycles):
        op = self.op
        _, jvp = op.linearize_at(x, scalars, source_q, picard=picard)
        u, _ = op.split(x)
        u_q = op.u_at_quad(u)
        if self.grad_div > 0.0:
            jvp, rhs = self._augment(jvp, rhs)
        return fgmres_device(jvp, lambda r: self._apply(r, jvp, u_q, scalars),
                             rhs, x0=x0, restart=self.restart, tol=tol,
                             atol=atol, max_cycles=max_cycles)

    def solve(self, x, rhs, scalars, source_q=0.0, *, picard=False,
              tol=1e-10, atol=1e-12, x0=None, max_cycles=None):
        """Solve J(x) dx = rhs; returns (dx, residual_norm, matvecs).

        ``max_cycles`` overrides the per-call restart-cycle budget; ``x0``
        warm-starts.
        """
        if x0 is None:
            x0 = torch.zeros_like(rhs)
        budget = max_cycles or self.max_cycles
        if not self.host_cycles:
            return self._solve_once(x, rhs, x0, scalars, source_q, picard,
                                    tol, atol, budget)
        # one restart cycle per call, warm-started across calls
        target = max(tol * float(torch.linalg.vector_norm(rhs)), atol)
        n_total = 0
        dx = x0
        for _ in range(budget):
            dx, res, its = self._solve_once(x, rhs, dx, scalars, source_q,
                                            picard, tol, atol, 1)
            n_total += int(its)
            if float(res) <= target:
                break
        return dx, res, n_total
