"""Domain-decomposed projection step over the halo-exchange layer
(``navierstokes_tpu/solvers/halo_step.py``).

The incremental pressure-correction scheme of ``solvers/fused_step.py``,
with every state vector partitioned over the shards of a
:class:`~navierstokes_tpu_torch.parallel.comm.DeviceMesh`: per-shard
memory is O(dofs/n + halo) and each matvec moves only the halo (the
exchanges inside :class:`~navierstokes_tpu_torch.parallel.halo.
HaloCellOperator`).

Layout: velocity and pressure vectors are
:class:`~navierstokes_tpu_torch.parallel.comm.Sharded` blocks in the
operator's partitioned numbering (``HaloCellOperator.pad_velocity``);
padding slots hold zeros and stay zero (padded cells carry zero
quadrature weight, and the mean and mask projections re-zero them).  A
dot product inside CG is the shards' local dots added in shard order
(where the JAX step leaves the all-reduce to XLA), so each shard holds
the same scalars and the step runs the same on every call.  Dirichlet
conditions use the SPD-preserving mask projection of the one-device
steps, the masks and values taken into the partitioned layout once at
build time.  Fixed-iteration solves (``cg_rtol`` None) read nothing from
the device.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.parallel.comm import (Sharded, sharded_dot,
                                                  sharded_sum)


def _where_nonzero(num, den):
    """num / den where den != 0, else 0 (the CG breakdown guard)."""
    return num.map(lambda n, d: torch.where(d.abs() > 0.0, n / d,
                                            torch.zeros_like(n)), den)


def _pcg(mesh, matvec, b, x0, iters, inv_diag=None, project=None,
         rtol=None):
    """Jacobi-preconditioned CG on Sharded vectors with the update order
    and zero-denominator guards of ``planar_step._pcg``: ``iters``
    iterations, or with ``rtol`` until ||r|| <= rtol ||b|| (one host read
    per iteration) with ``iters`` as the cap.  Returns (x, ||r||) with
    ||r|| on shard 0's device."""
    def precond(r):
        return r if inv_diag is None else inv_diag * r

    def norm(v):
        return torch.sqrt(sharded_dot(v, v, mesh)[0])

    r = b - matvec(x0)
    if project is not None:
        r = project(r)
    z = precond(r)
    x, p, rz = x0, z, sharded_dot(r, z, mesh)
    norm_b = None if rtol is None else float(norm(b))
    for _ in range(int(iters)):
        if rtol is not None and float(norm(r)) <= rtol * norm_b:
            break
        Ap = matvec(p)
        alpha = _where_nonzero(rz, sharded_dot(p, Ap, mesh))
        x = x + alpha * p
        r = r - alpha * Ap
        if project is not None:
            r = project(r)
        z = precond(r)
        rz_new = sharded_dot(r, z, mesh)
        beta = _where_nonzero(rz_new, rz)
        p = z + beta * p
        rz = rz_new
    return x, norm(r)


def _inv(d: Sharded):
    return d.map(lambda v: 1.0 / torch.where(v.abs() > 1e-30, v,
                                             torch.ones_like(v)))


def build_halo_projection_step(ops, *, visc, dt, cg_iters=(12, 45, 8),
                               vel_bc=None, pres_bc_mask=None,
                               conv_coeff=1.0, cg_rtol=None,
                               with_residuals=False):
    """Build ``step(u, u_old, p, phi, alpha, eta, ...)`` on partitioned
    state.

    ``ops``: a :class:`~navierstokes_tpu_torch.parallel.halo.
    HaloCellOperator`.  ``vel_bc=(mask, values)``: full-length space-layout
    ``(n_u,)`` mask and values (as for ``build_projection_step``), taken
    into the partitioned layout here; ``pres_bc_mask``: space layout
    ``(n_p,)``, None for enclosed flow (mean-free Poisson).  ``alpha``,
    ``eta`` and ``k`` are floats.  The step also takes ``bc_values``
    (partitioned, from ``ops.pad_velocity``), ``k`` and ``body_rhs``
    (partitioned).  With ``with_residuals`` it returns a fourth element,
    the (Helmholtz, Poisson, correction) residual norms on shard 0's
    device.
    """
    mesh = ops.mesh
    mass_u = ops.make_velocity_mass()
    helm = ops.make_velocity_helmholtz(visc)
    grad = ops.make_gradient()
    div = ops.make_divergence()
    stiff_p = ops.make_pressure_stiffness()
    conv = ops.make_convection_rhs(conv_coeff)
    diag_m, diag_k, diag_l = ops.diagonals()
    inv_diag_l = _inv(diag_l)
    inv_diag_m = _inv(diag_m)
    iters = tuple(int(i) for i in cg_iters)
    rtol = None if cg_rtol is None else float(cg_rtol)
    space, dtype, dev0 = ops.space, ops.dtype, ops.device
    visc, dt = float(visc), float(dt)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev0)

    # real-slot masks (1 at real nodes, 0 at padding)
    real_u = ops.pad_velocity(ones(space.n_velocity_dofs))
    real_p = ops.pad_pressure(ones(space.n_pnodes))
    n_real_p = float(space.n_pnodes)

    def free(padded, real):
        # padding slots stay "free", so the identity branch of the masked
        # operator cannot inject nonzeros there
        return padded.map(lambda f, r: torch.where(r > 0, f,
                                                   torch.ones_like(f)), real)

    if vel_bc is not None:
        mask = torch.as_tensor(vel_bc[0], device=dev0).to(torch.bool)
        v_free = free(ops.pad_velocity(torch.where(mask, 0.0, 1.0)
                                       .to(dtype)), real_u)
        v_vals_static = ops.pad_velocity(torch.as_tensor(
            vel_bc[1], dtype=dtype, device=dev0))
    if pres_bc_mask is not None:
        pmask = torch.as_tensor(pres_bc_mask, device=dev0).to(torch.bool)
        p_free = free(ops.pad_pressure(torch.where(pmask, 0.0, 1.0)
                                       .to(dtype)), real_p)

    def masked_u(A, v_vals):
        if vel_bc is None:
            return A, lambda b, x0: (b, x0)

        def A_masked(v):
            return v_free * A(v_free * v) + (1.0 - v_free) * v

        def fix_rhs(b, x0):
            g = (1.0 - v_free) * v_vals
            return v_free * (b - A(g)) + g, v_free * x0 + g

        return A_masked, fix_rhs

    if pres_bc_mask is None:
        def project_p(r):
            # mean over REAL nodes only; padding slots re-zeroed
            return (r - sharded_sum(r, mesh) / n_real_p) * real_p

        stiff_masked = stiff_p
    else:
        def project_p(r):
            return p_free * r * real_p

        def stiff_masked(v):
            return p_free * stiff_p(p_free * v) + (1.0 - p_free) * v

    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        a0, a1, a2 = (float(a) for a in alpha)
        k = dt if k is None else float(k)
        v_vals = None
        if vel_bc is not None:
            v_vals = v_vals_static if bc_values is None else bc_values

        # (1) velocity Helmholtz solve
        u_ext = float(eta[0]) * u + float(eta[1]) * u_old
        b = (-(a1 / k) * mass_u(u) - (a2 / k) * mass_u(u_old)
             - conv(u_ext) - grad(p))
        if body_rhs is not None:
            b = b + body_rhs
        inv_diag_h = _inv((a0 / k) * diag_m + visc * diag_k)
        H_m, fix = masked_u(lambda v: helm(v, a0 / k), v_vals)
        b, x0 = fix(b, u)
        u_star, res_h = _pcg(mesh, H_m, b, x0, iters[0],
                             inv_diag=inv_diag_h, rtol=rtol)

        # (2) incremental pressure Poisson (warm-started)
        rhs = project_p((a0 / k) * div(u_star))
        phi_new, res_p = _pcg(mesh, stiff_masked, rhs, project_p(phi),
                              iters[1], inv_diag=inv_diag_l,
                              project=project_p, rtol=rtol)

        # (3) velocity correction
        b_corr = mass_u(u_star) - (k / a0) * grad(phi_new)
        M_m, fix = masked_u(mass_u, v_vals)
        b_corr, x0 = fix(b_corr, u_star)
        u_new, res_m = _pcg(mesh, M_m, b_corr, x0, iters[2],
                            inv_diag=inv_diag_m, rtol=rtol)

        p_new = p + phi_new
        if pres_bc_mask is None:
            p_new = (p_new - sharded_sum(p_new, mesh) / n_real_p) * real_p
        if with_residuals:
            return u_new, p_new, phi_new, torch.stack([res_h, res_p, res_m])
        return u_new, p_new, phi_new

    return step
