"""Krylov solvers on torch tensors (counterpart of
``navierstokes_tpu/linalg/krylov.py``).

The conjugate-gradient solve of the SPD sub-problems (mass-matrix
projections, the AMG-preconditioned solve), its Jacobi preconditioner and
the Dirichlet-masked SPD solve are ported; ``bicgstab`` and ``gmres``
come with the Newton stack and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import torch


def _as_matvec(A):
    if hasattr(A, "matvec"):
        return A.matvec
    if callable(A):
        return A
    A = torch.as_tensor(A)
    return lambda x: A @ x


def jacobi_preconditioner(diag, floor=1e-30):
    """Inverse-diagonal preconditioner with a zero guard."""
    safe = torch.where(diag.abs() > floor, diag, torch.ones_like(diag))
    inv = 1.0 / safe
    return lambda x: inv * x


def cg(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients.  Returns ``(x, residual_norm)``.

    The loop and its stopping rule are those of
    ``jax.scipy.sparse.linalg.cg``: it iterates while
    ``||r||^2 > max(tol^2 ||b||^2, atol^2)`` and fewer than ``maxiter``
    (default ``10 * len(b)``) iterations ran.  The test reads ``||r||^2``
    on the host once per iteration.
    """
    mv = _as_matvec(A)
    if maxiter is None:
        maxiter = 10 * len(b)
    x = torch.zeros_like(b) if x0 is None else x0
    atol2 = max(float(tol) ** 2 * float(torch.sum(b * b)), float(atol) ** 2)

    r = b - mv(x)
    p = z = r if M is None else M(r)
    gamma = torch.sum(r * z)
    for _ in range(int(maxiter)):
        rs = gamma if M is None else torch.sum(r * r)
        if not float(rs) > atol2:
            break
        Ap = mv(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if M is None else M(r)
        gamma_new = torch.sum(r * z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return x, torch.linalg.vector_norm(b - mv(x))


def bicgstab(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    raise NotImplementedError(
        "krylov.bicgstab is not ported yet (ROADMAP item 13)")


def gmres(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, restart=60,
          M=None):
    raise NotImplementedError(
        "krylov.gmres is not ported yet (ROADMAP item 13)")


def masked_spd_solve(A_fn, b, bc_mask, bc_values, tol=1e-12, maxiter=None,
                     diag=None, M=None, x0=None):
    """Solve A x = b with Dirichlet constraints, preserving SPD structure.

    ``bc_mask``: (n,) bool, True at constrained dofs; ``bc_values``: full
    (n,) array carrying the constraint values at those dofs (other entries
    ignored).  Uses the projected operator

        A'(v) = free . A(free . v) + constrained . v

    with RHS  free . (b - A(g)) + constrained . g, then runs CG.

    ``diag``: Jacobi preconditioner from the operator diagonal; ``M``: an
    explicit preconditioner apply -- overrides ``diag``.  ``x0``: warm
    start (constrained entries are overwritten with the BC values).
    """
    mask = torch.as_tensor(bc_mask, device=b.device).to(torch.bool)
    free = torch.where(mask, 0.0, 1.0).to(b.dtype)
    g = torch.where(mask, torch.as_tensor(bc_values, dtype=b.dtype,
                                          device=b.device),
                    torch.zeros((), dtype=b.dtype, device=b.device))

    def masked(v):
        return free * A_fn(free * v) + (1.0 - free) * v

    rhs = free * (b - A_fn(g)) + g
    if M is None and diag is not None:
        one = torch.ones_like(diag)
        safe = torch.where(free > 0.0,
                           torch.where(diag.abs() > 1e-30, diag, one), one)
        inv = 1.0 / safe

        def M(v):  # noqa: F811
            return inv * v

    start = g if x0 is None else free * x0 + g
    return cg(masked, rhs, x0=start, tol=tol, maxiter=maxiter, M=M)
