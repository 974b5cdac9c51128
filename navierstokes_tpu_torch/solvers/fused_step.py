"""The cell-loop projection step (``navierstokes_tpu/solvers/fused_step.py``).

One incremental-pressure-correction step with explicitly extrapolated
convection, three Jacobi-preconditioned matrix-free CG solves whose
matvecs are the precomputed element-matrix applications of
``parallel/sharded.ShardedCellOperator``.  It is the step a mesh takes
when no banded format of ``assembly/fastop.py`` holds it.

Per step, for SBDF coefficients (a0, a1, a2), extrapolation (eta0, eta1)
and step size k:

  1. Helmholtz:  (a0/k M + nu K) u* = -(a1/k) M u_n - (a2/k) M u_{n-1}
                   - C(eta0 u_n + eta1 u_{n-1}) - G p_n
  2. Poisson:    L phi = (a0/k) D u*   (mean-free, or pinned where the
                 pressure is prescribed; warm-started from the last phi)
  3. Correction: M u_{n+1} = M u* - (k/a0) G phi,  p_{n+1} = p_n + phi

Vectors are the space's flat layouts (velocity node-major interleaved).
The step runs eagerly; with ``cg_rtol`` each CG iteration reads the
residual norm on the host once.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.linalg.pcg import guarded_inverse, pcg


def build_projection_step(space, ops, *, visc, dt, cg_iters=(12, 45, 8),
                          vel_bc=None, pres_bc_mask=None, conv_coeff=1.0,
                          cg_rtol=None, with_residuals=False):
    """Build ``step(u, u_old, p, phi, alpha, eta) -> (u_new, p_new, phi)``.

    ``ops``: a ShardedCellOperator providing the matvec factories.
    ``alpha = (a0, a1, a2)`` are the BDF weights, ``eta`` the convection
    extrapolation weights (floats or 0-d tensors).  ``phi`` is the
    previous pressure increment (zeros on the first step).

    Boundary conditions:
      * ``vel_bc=None``: fully periodic velocity (no masking);
        ``vel_bc=(mask, values)``: full-length (n_u,) boolean mask and
        value arrays applied to both velocity solves.
      * ``pres_bc_mask=None``: enclosed flow -- the Poisson solve runs
        mean-free; else an (n_p,) boolean mask where the pressure is
        prescribed (the increment vanishes there).

    ``cg_rtol`` switches the three CG solves from fixed iteration counts
    to a relative-residual stop with ``cg_iters`` as caps;
    ``with_residuals=True`` makes ``step`` return a fourth element, the
    final (Helmholtz, Poisson, correction) residual norms.

    The step also takes ``bc_values`` (per-step velocity Dirichlet data,
    full length), ``k`` (the step size; default ``dt``) and ``body_rhs``
    (a pre-assembled velocity load added to the momentum rhs).
    """
    mass_u = ops.make_velocity_mass()
    helm = ops.make_velocity_helmholtz(visc)
    grad = ops.make_gradient()
    div = ops.make_divergence()
    stiff_p = ops.make_pressure_stiffness()
    conv = ops.make_convection_rhs(conv_coeff)
    diag_m, diag_k, diag_l = ops.diagonals()
    dtype, device = diag_m.dtype, diag_m.device
    inv_diag_l = guarded_inverse(diag_l)
    inv_diag_m = guarded_inverse(diag_m)
    iters = tuple(int(i) for i in cg_iters)
    rtol = None if cg_rtol is None else float(cg_rtol)

    def free(mask):
        m = torch.as_tensor(mask, device=device).to(torch.bool)
        return torch.where(m, 0.0, 1.0).to(dtype)

    if vel_bc is not None:
        v_free = free(vel_bc[0])
        v_vals_static = torch.as_tensor(vel_bc[1], dtype=dtype,
                                        device=device)
    if pres_bc_mask is not None:
        p_free = free(pres_bc_mask)

    def masked_u(A, v_vals):
        """SPD-preserving Dirichlet projection of a velocity operator."""
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
            return r - r.mean()

        stiff_masked = stiff_p
    else:
        def project_p(r):
            return p_free * r

        def stiff_masked(v):
            return p_free * stiff_p(p_free * v) + (1.0 - p_free) * v

    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        a0, a1, a2 = alpha
        if k is None:
            k = dt
        v_vals = None
        if vel_bc is not None:
            v_vals = v_vals_static if bc_values is None else bc_values

        # (1) velocity Helmholtz solve
        u_ext = eta[0] * u + eta[1] * u_old
        b = (-(a1 / k) * mass_u(u) - (a2 / k) * mass_u(u_old)
             - conv(u_ext) - grad(p))
        if body_rhs is not None:
            b = b + body_rhs
        inv_diag_h = guarded_inverse((a0 / k) * diag_m + visc * diag_k)
        H_m, fix = masked_u(lambda v: helm(v, a0 / k), v_vals)
        b, x0 = fix(b, u)
        u_star, r_h = pcg(H_m, b, x0, iters[0], inv_diag=inv_diag_h,
                          rtol=rtol)

        # (2) incremental pressure Poisson (warm-started)
        rhs = project_p((a0 / k) * div(u_star))
        phi_new, r_p = pcg(stiff_masked, rhs, project_p(phi), iters[1],
                           inv_diag=inv_diag_l, project=project_p, rtol=rtol)

        # (3) velocity correction
        b_corr = mass_u(u_star) - (k / a0) * grad(phi_new)
        M_m, fix = masked_u(mass_u, v_vals)
        b_corr, x0 = fix(b_corr, u_star)
        u_new, r_m = pcg(M_m, b_corr, x0, iters[2], inv_diag=inv_diag_m,
                         rtol=rtol)

        p_new = p + phi_new
        if pres_bc_mask is None:
            p_new = p_new - p_new.mean()
        if with_residuals:
            return u_new, p_new, phi_new, torch.stack(
                [torch.linalg.vector_norm(r) for r in (r_h, r_p, r_m)])
        return u_new, p_new, phi_new

    return step
