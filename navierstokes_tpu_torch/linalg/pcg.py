"""The plain preconditioned CG of the projection steps and the guarded
inverse of their Jacobi diagonals (``navierstokes_tpu/solvers/
planar_step.py``'s ``_pcg`` and ``_inv``).

The hand-written whole-solve kernels (``assembly/cuda_band.circulant_pcg``,
``assembly/cuda_amg.amg_pcg``) run this loop's update order and guards;
their plain versions are calls of :func:`pcg`.
"""

from __future__ import annotations

import torch


def pcg(matvec, b, x0, iters, inv_diag=None, project=None, rtol=None,
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


def guarded_inverse(d):
    """``1 / d``, with 1 in place of entries of ``d`` at most 1e-30 in
    magnitude."""
    return 1.0 / torch.where(d.abs() > 1e-30, d, torch.ones_like(d))
