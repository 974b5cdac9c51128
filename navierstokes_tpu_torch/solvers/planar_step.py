"""Projection step over the gather-free operator engine (counterpart of
``navierstokes_tpu/solvers/planar_step.py``).

Incremental pressure-correction scheme in the planar velocity layout
``(dim, n_unodes)``: extrapolated convection, a velocity Helmholtz solve,
an incremental pressure Poisson solve and a mass-matrix velocity
correction, each a Jacobi-PCG (the Poisson solve optionally preconditioned
by an AMG V-cycle, ``build_poisson_amg``).  With circulant operators, no
tolerance and no preconditioner, each solve is one launch of the CUDA
kernel ``cuda_band.circulant_pcg`` on CUDA tensors (its plain torch
version on CPU tensors); with a tolerance (``cg_rtol``) the loop runs in
torch and reads the residual norm on the host once per iteration.  Every
band matvec outside the whole-solve kernel goes through
``cuda_band.circulant_apply``.

State vectors live in the engine's permuted node numbering.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import (CirculantBand, PlanarOps,
                                                    combine_circulant,
                                                    conv_apply)
from navierstokes_tpu_torch.utils import monitor


def _pcg(matvec, b, x0, iters, inv_diag=None, project=None, rtol=None,
         precond_fn=None):
    """Preconditioned CG.  Returns ``(x, r)`` -- the residual vector; the
    caller takes its norm.

    ``precond_fn`` takes precedence over the Jacobi ``inv_diag``; its
    output is re-projected when a projector is active.  Dot products run
    over all planes of ``b`` jointly.  With ``rtol`` the loop stops once
    ||r|| <= rtol ||b|| (one host read of the norm per iteration).
    """

    def precond(r):
        if precond_fn is not None:
            z = precond_fn(r)
            return z if project is None else project(z)
        return r if inv_diag is None else inv_diag * r

    def vdot(a, c):
        return torch.sum(a * c)

    r = b - matvec(x0)
    if project is not None:
        r = project(r)
    z = precond(r)
    x, p, rz = x0, z, vdot(r, z)
    norm_b = None if rtol is None else float(torch.linalg.vector_norm(b))
    for _ in range(int(iters)):
        if rtol is not None and \
                float(torch.linalg.vector_norm(r)) <= rtol * norm_b:
            break
        Ap = matvec(p)
        denom = vdot(p, Ap)
        alpha = torch.where(denom.abs() > 0.0, rz / denom,
                            torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        if project is not None:
            r = project(r)
        z = precond(r)
        rz_new = vdot(r, z)
        beta = torch.where(rz.abs() > 0.0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x, r


def _inv(d):
    return 1.0 / torch.where(d.abs() > 1e-30, d, torch.ones_like(d))


def _step_core(ops: PlanarOps, masks, u, u_old, p, phi, alpha, eta,
               bc_values, k, body_rhs, *, visc, conv_coeff, cg_iters,
               cg_rtol, with_residuals, p_precond=None, rotational=False,
               conv_strided=None):
    """One projection step; returns (u, p, phi[, residual norms]).

    Its device work runs in four phases (``utils/monitor.phase``):
    ``convection``, ``helmholtz``, ``poisson`` and ``correction``."""
    v_free, v_vals_static, p_free = masks
    a0, a1, a2 = alpha
    mass_u = ops.M.apply
    fused_helm = isinstance(ops.M, CirculantBand) and \
        isinstance(ops.K, CirculantBand)

    def helm(v):
        return (a0 / k) * ops.M.apply(v) + visc * ops.K.apply(v)

    def _cg_fast(band_op, bvec, x0v, iters, inv_diag, maskv, meanfree):
        """Whole-solve PCG (``cuda_band.circulant_pcg``) when the solve
        admits it, else None and the caller runs ``_pcg``.  Identical math
        (same guards and update order)."""
        if cg_rtol is not None or not isinstance(band_op, CirculantBand):
            return None
        return cuda_band.circulant_pcg(band_op.band, band_op.offsets,
                                       bvec.contiguous(), x0v.contiguous(),
                                       inv_diag, maskv, iters, meanfree)

    def grad(q):
        return torch.stack([Gd.apply(q) for Gd in ops.G], dim=0)

    def div(v):
        acc = ops.D[0].apply(v[0])
        for d in range(1, len(ops.D)):
            acc = acc + ops.D[d].apply(v[d])
        return acc

    if v_free is not None:
        v_vals = v_vals_static if bc_values is None else bc_values

        def masked_u(A):
            def A_masked(v):
                return v_free * A(v_free * v) + (1.0 - v_free) * v

            def fix_rhs(b, x0):
                g = (1.0 - v_free) * v_vals
                return (v_free * (b - A(g)) + g, v_free * x0 + g)

            return A_masked, fix_rhs
    else:
        def masked_u(A):
            return A, lambda b, x0: (b, x0)

    if p_free is None:
        def project_p(r):
            return r - r.mean()

        stiff_masked = ops.L.apply
    else:
        def project_p(r):
            return p_free * r

        def stiff_masked(v):
            return p_free * ops.L.apply(p_free * v) + (1.0 - p_free) * v

    # (1) velocity Helmholtz solve.  The convection's two parts (the
    # extrapolation, conv_apply) keep their places among the right-hand
    # side's kernels, so that marking the phases leaves the kernel order
    # as it is: with the convection run first, the band applies took 12 %
    # less device time on the card
    with monitor.phase("helmholtz"):
        helm_op = None
        if fused_helm:
            # one fused band: halves the band traffic of every velocity-CG
            # iteration (the combine is paid once per step)
            helm_op = combine_circulant([(a0 / k, ops.M), (visc, ops.K)])
    with monitor.phase("convection"):
        u_ext = eta[0] * u + eta[1] * u_old
    with monitor.phase("helmholtz"):
        b = -(a1 / k) * mass_u(u) - (a2 / k) * mass_u(u_old)
    with monitor.phase("convection"):
        conv = conv_apply(ops, u_ext, conv_coeff, strided=conv_strided)
    with monitor.phase("helmholtz"):
        b = b - conv - grad(p)
        if body_rhs is not None:
            b = b + body_rhs
        inv_diag_h = _inv((a0 / k) * ops.diag_m + visc * ops.diag_k)
        H_m, fix = masked_u(helm if helm_op is None else helm_op.apply)
        b, x0 = fix(b, u)
        got = _cg_fast(helm_op, b, x0, cg_iters[0], inv_diag_h, v_free,
                       False)
        if got is None:
            got = _pcg(H_m, b, x0, cg_iters[0], inv_diag=inv_diag_h,
                       rtol=cg_rtol)
        u_star, r_h = got

    # (2) incremental pressure Poisson (warm-started)
    with monitor.phase("poisson"):
        rhs = project_p((a0 / k) * div(u_star))
        got = None if p_precond is not None else _cg_fast(
            ops.L, rhs, project_p(phi), cg_iters[1], _inv(ops.diag_l),
            p_free, p_free is None)
        if got is None:
            got = _pcg(stiff_masked, rhs, project_p(phi), cg_iters[1],
                       inv_diag=_inv(ops.diag_l), project=project_p,
                       rtol=cg_rtol, precond_fn=p_precond)
        phi_new, r_p = got

    # (3) velocity correction and pressure update
    with monitor.phase("correction"):
        b_corr = mass_u(u_star) - (k / a0) * grad(phi_new)
        M_m, fix = masked_u(mass_u)
        b_corr, x0 = fix(b_corr, u_star)
        got = _cg_fast(ops.M, b_corr, x0, cg_iters[2], _inv(ops.diag_m),
                       v_free, False)
        if got is None:
            got = _pcg(M_m, b_corr, x0, cg_iters[2],
                       inv_diag=_inv(ops.diag_m), rtol=cg_rtol)
        u_new, r_m = got

        p_new = p + phi_new
        if rotational:
            # rotational correction p += phi - nu div u* (Timmermans /
            # Guermond-Minev-Shen); div() returns -int(N1 div u), so the
            # nodal field solves Mp d = -div(u_star)
            d_nodal, _ = _pcg(ops.Mp.apply, -div(u_star),
                              torch.zeros_like(phi_new), cg_iters[2],
                              inv_diag=_inv(ops.diag_mp))
            corr = visc * d_nodal
            if p_free is not None:
                corr = p_free * corr
            p_new = p_new - corr
        if p_free is None:
            p_new = p_new - p_new.mean()
        if with_residuals:
            res = torch.stack([torch.linalg.vector_norm(r)
                               for r in (r_h, r_p, r_m)])
    if with_residuals:
        return u_new, p_new, phi_new, res
    return u_new, p_new, phi_new


def build_poisson_amg(fast, pres_bc_mask=None, **amg_kwargs):
    """AMG V-cycle preconditioner for the planar step's pressure Poisson,
    in the engine's permuted P1 numbering, on the engine's device.

    Fixed Jacobi-CG sweeps on the Poisson solve degrade as O(1/h) where an
    AMG V-cycle holds the iteration count h-independent.  Setup is
    host-side SciPy (once per mesh).

    ``pres_bc_mask``: permuted boolean mask of prescribed-pressure nodes
    (same convention as ``build_planar_projection_step``); ``None`` =
    enclosed flow: the unshifted semidefinite Laplacian, whose coarsest
    level is a pseudo-inverse while the outer CG's mean-free projection
    keeps everything in the SPD subspace.
    """
    import numpy as np

    from navierstokes_tpu_torch.linalg.amg import (AMG,
                                                   pressure_laplacian_scipy)

    perm = np.asarray(fast.permP)
    dofs = None
    if pres_bc_mask is not None:
        dofs = perm[np.where(np.asarray(pres_bc_mask))[0]]
    A = pressure_laplacian_scipy(fast.space, dirichlet_dofs=dofs)
    amg_kwargs.setdefault("dtype", fast.dtype)
    amg = AMG(A[perm][:, perm], device=fast.device, **amg_kwargs)

    # the V-cycle's level-0 matvec (smoother + residual) dominates its
    # cost; route it through the banded operator (the band kernel on the
    # card) instead of the gather table -- identical matrix
    if amg.levels:
        if pres_bc_mask is not None:
            m = torch.as_tensor(np.asarray(pres_bc_mask), device=fast.device)
            p_free = torch.where(m.to(torch.bool), 0.0, 1.0).to(
                amg.levels[0]["dinv"].dtype)

            def mv(v):
                return p_free * fast.L.apply(p_free * v) + (1.0 - p_free) * v
        else:
            mv = fast.L.apply

        class _Banded0:
            matvec = staticmethod(mv)

        amg.levels[0]["A"] = _Banded0()
    return amg


def build_planar_projection_step(fast, *, visc, dt, cg_iters=(12, 45, 8),
                                 vel_bc=None, pres_bc_mask=None,
                                 conv_coeff=1.0, cg_rtol=None,
                                 with_residuals=False,
                                 poisson_precond=None, rotational=False):
    """Build ``step(u, u_old, p, phi, alpha, eta, ...)`` (planar layout).

    ``fast``: a FastTaylorHood engine or a ``PlanarOps`` bundle.  Velocity
    states are ``(dim, n_unodes)``, pressures ``(n_pnodes,)``, all in the
    engine's permuted numbering and on its device.  ``alpha=(a0, a1, a2)``
    BDF weights and ``eta`` the convection extrapolation weights (floats
    or 0-d tensors).

    Boundary conditions (permuted numbering):
      * ``vel_bc=(mask, values)``: planar (dim, Nu) boolean mask + values;
        ``None`` = fully periodic.
      * ``pres_bc_mask``: (Np,) boolean where the pressure is prescribed;
        ``None`` = enclosed flow (mean-free Poisson solve).

    Optional keywords of the returned step: ``bc_values`` (per-step
    velocity Dirichlet data), ``k`` (step size; defaults to ``dt``),
    ``body_rhs`` (pre-assembled velocity load).

    ``poisson_precond``: ``None`` (Jacobi), ``"amg"`` (build an AMG
    V-cycle via :func:`build_poisson_amg`; needs the engine, not a bare
    ``PlanarOps``), or any callable ``r -> z`` in permuted pressure
    numbering.
    """
    if poisson_precond == "amg":
        if isinstance(fast, PlanarOps):
            raise TypeError("poisson_precond='amg' needs a FastTaylorHood "
                            "engine: a PlanarOps bundle carries no space")
        poisson_precond = build_poisson_amg(fast, pres_bc_mask).apply
    ops = fast if isinstance(fast, PlanarOps) else fast.ops
    dtype, device = ops.diag_m.dtype, ops.diag_m.device

    # contiguous: the masks go to the band kernels as they are
    def free(mask):
        m = torch.as_tensor(mask, device=device)
        return torch.where(m.to(torch.bool), 0.0, 1.0).to(dtype).contiguous()

    if vel_bc is not None:
        v_free = free(vel_bc[0])
        v_vals = torch.as_tensor(vel_bc[1], dtype=dtype,
                                 device=device).contiguous()
    else:
        v_free = v_vals = None
    p_free = None if pres_bc_mask is None else free(pres_bc_mask)
    masks = (v_free, v_vals, p_free)
    static = dict(visc=float(visc), conv_coeff=float(conv_coeff),
                  cg_iters=tuple(int(i) for i in cg_iters),
                  cg_rtol=None if cg_rtol is None else float(cg_rtol),
                  with_residuals=bool(with_residuals),
                  p_precond=poisson_precond, rotational=bool(rotational),
                  conv_strided=ops.conv_strided)

    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        return _step_core(ops, masks, u, u_old, p, phi, tuple(alpha),
                          tuple(eta), bc_values, float(dt) if k is None
                          else k, body_rhs, **static)

    step.ops = ops
    step.masks = masks
    step.static = static
    return step
