"""Krylov solvers on torch tensors (counterpart of
``navierstokes_tpu/linalg/krylov.py``).

CG for the SPD sub-problems (pressure Poisson, mass matrices), BiCGStab
and restarted GMRES for nonsymmetric systems.  All accept a ``CSRMatrix``,
a dense matrix or a matvec callable.

The loops, updates and stopping rules are those of
``jax.scipy.sparse.linalg`` (``cg``, ``bicgstab``, ``gmres`` with
``solve_method="batched"``).  A loop whose stopping test can end it early
reads the test on the host once per iteration (once per restart cycle for
GMRES).  A fixed sweep (``tol = atol = 0``, as the block preconditioners
run them) never reads: every iteration runs, and one that the reference
would skip (an exactly zero residual, a breakdown) leaves the state as it
was, so the result is the reference's without a host synchronisation.
The ``*_solve`` functions return the solution alone; ``cg``, ``bicgstab``
and ``gmres`` add the final residual norm ``||b - A x||``.
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


def _identity(x):
    return x


def _norm(x):
    return torch.sqrt(torch.dot(x, x))


def _atol2(tol, atol, b):
    """``max(tol^2 ||b||^2, atol^2)`` as a Python float (no read of ``b``
    for a fixed sweep)."""
    if tol == 0:
        return float(atol) ** 2
    return max(float(tol) ** 2 * float(torch.sum(b * b)), float(atol) ** 2)


def _loop(cond, body, state, maxiter, fixed):
    """``while cond(state): state = body(state)``, at most ``maxiter``
    times.  ``cond`` gives a 0-d bool tensor; ``fixed`` runs every
    iteration and keeps the old state where ``cond`` is false instead of
    reading it."""
    for _ in range(int(maxiter)):
        active = cond(state)
        if not fixed:
            if not bool(active):
                break
            state = body(state)
            continue
        new = body(state)
        state = tuple(torch.where(active, a, b) for a, b in zip(new, state))
    return state


def jacobi_preconditioner(diag, floor=1e-30):
    """Inverse-diagonal preconditioner with a zero guard."""
    safe = torch.where(diag.abs() > floor, diag, torch.ones_like(diag))
    inv = 1.0 / safe
    return lambda x: inv * x


def cg_solve(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients: iterate while
    ``||r||^2 > max(tol^2 ||b||^2, atol^2)`` and fewer than ``maxiter``
    (default ``10 * len(b)``) iterations ran."""
    mv = _as_matvec(A)
    M = _identity if M is None else M
    if maxiter is None:
        maxiter = 10 * len(b)
    x = torch.zeros_like(b) if x0 is None else x0
    atol2 = _atol2(tol, atol, b)
    precond = M is not _identity

    r = b - mv(x)
    z = M(r)
    state = (x, r, z, torch.sum(r * z))

    def cond(state):
        _, r, _, gamma = state
        rs = torch.sum(r * r) if precond else gamma
        return rs.double() > atol2

    def body(state):
        x, r, p, gamma = state
        Ap = mv(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = torch.sum(r * z)
        return x, r, z + (gamma_new / gamma) * p, gamma_new

    return _loop(cond, body, state, maxiter, tol == 0 and atol == 0)[0]


def cg(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    """:func:`cg_solve`; returns ``(x, residual_norm)``."""
    x = cg_solve(A, b, x0, tol, atol, maxiter, M)
    return x, torch.linalg.vector_norm(b - _as_matvec(A)(x))


def bicgstab_solve(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None,
                   M=None):
    """Preconditioned BiCGStab with the breakdown exits of
    ``jax.scipy.sparse.linalg.bicgstab``."""
    mv = _as_matvec(A)
    M = _identity if M is None else M
    if maxiter is None:
        maxiter = 10 * len(b)
    x = torch.zeros_like(b) if x0 is None else x0
    atol2 = _atol2(tol, atol, b)

    r0 = b - mv(x)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)
    state = (x, r0, r0, one, one, one, r0, r0, k0)

    def cond(state):
        r, k = state[1], state[-1]
        return (torch.dot(r, r) > atol2) & (k < maxiter) & (k >= 0)

    def body(state):
        x, r, rhat, alpha, omega, rho, p, q, k = state
        rho_ = torch.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = mv(phat)
        alpha_ = rho_ / torch.dot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = torch.dot(s, s) < atol2
        shat = M(s)
        t = mv(shat)
        omega_ = torch.dot(t, s) / torch.dot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * phat,
                         x + (alpha_ * phat + omega_ * shat))
        r_ = torch.where(exit_early, s, s - omega_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        return x_, r_, rhat, alpha_, omega_, rho_, p_, q_, k_

    return _loop(cond, body, state, maxiter, tol == 0 and atol == 0)[0]


def bicgstab(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    """:func:`bicgstab_solve`; returns ``(x, residual_norm)``."""
    x = bicgstab_solve(A, b, x0, tol, atol, maxiter, M)
    return x, torch.linalg.vector_norm(b - _as_matvec(A)(x))


def _safe_normalize(x, thresh=None):
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0)


def _gmres_cycle(mv, M, b, x0, unit_residual, residual_norm, restart):
    """One restart of left-preconditioned GMRES: an Arnoldi basis of
    ``restart`` vectors (one classical Gram-Schmidt pass, as the
    reference's ``_iterative_classical_gram_schmidt`` with
    ``max_iterations=2`` runs), then the small least-squares problem by
    normal equations and Cholesky.  After a breakdown the remaining
    iterations leave the basis and H as the reference leaves them."""
    n = b.shape[0]
    eps = torch.finfo(b.dtype).eps
    V = b.new_zeros((restart + 1, n))
    V[0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(mv(V[k]))
        _, v_norm_0 = _safe_normalize(v)
        h = V @ v
        v = v - h @ V
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        h[k + 1] = v_norm_1
        V[k + 1] = torch.where(done, V[k + 1], unit_v)
        H[k] = torch.where(done, H[k], h)
        done = done | (v_norm_1 == 0.0)
    beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta[0] = residual_norm
    L, _ = torch.linalg.cholesky_ex(H @ H.T)
    y = torch.cholesky_solve((H @ beta)[:, None], L)[:, 0]
    x = x0 + y @ V[:-1]
    unit_residual, residual_norm = _safe_normalize(M(b - mv(x)))
    return x, unit_residual, residual_norm


def gmres_solve(A, b, x0=None, tol=1e-5, atol=0.0, restart=20,
                maxiter=None, M=None):
    """Restarted GMRES with the semantics of ``jax.scipy.sparse.linalg.
    gmres(..., solve_method="batched")``: restart cycles run while the
    preconditioned residual norm exceeds ``max(tol ||b||, atol)``, at most
    ``maxiter`` (default ``10 * len(b)``) of them."""
    mv = _as_matvec(A)
    M = _identity if M is None else M
    size = b.shape[0]
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    x = torch.zeros_like(b) if x0 is None else x0
    atol_ = torch.clamp(tol * _norm(b), min=atol)
    state = (x,) + _safe_normalize(M(b - mv(x)))

    def cond(state):
        return state[2] > atol_

    def body(state):
        return _gmres_cycle(mv, M, b, *state, restart)

    return _loop(cond, body, state, maxiter, tol == 0 and atol == 0)[0]


def gmres(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, restart=60,
          M=None):
    """:func:`gmres_solve` with ``maxiter`` defaulting to
    ``20 * max(1, len(b) // restart)``; returns ``(x, residual_norm)``."""
    if maxiter is None:
        maxiter = 20 * max(1, len(b) // restart)
    x = gmres_solve(A, b, x0, tol, atol, restart, maxiter, M)
    return x, torch.linalg.vector_norm(b - _as_matvec(A)(x))


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
