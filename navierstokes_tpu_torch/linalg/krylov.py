"""Krylov solvers on torch tensors (counterpart of
``navierstokes_tpu/linalg/krylov.py``).

Only the conjugate-gradient solve of the SPD sub-problems (mass-matrix
projections, the AMG-preconditioned solve) is ported; ``bicgstab`` and
``gmres`` come with the Newton stack.
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
