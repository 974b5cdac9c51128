"""Newton / Picard iteration loop (counterpart of
``navierstokes_tpu/linalg/newton.py``).

Host-controlled outer loop around residual/step callables with the
dolfin NewtonSolver convergence policy: absolute and relative (to the
initial residual) tolerances, a maximum iteration count, and optional
error-on-nonconvergence.  Each residual norm is one host read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class NewtonResult:
    x: object
    residual: float
    iterations: int
    converged: bool


def newton_solve(residual_fn, step_fn, x0, *, atol=1e-10, rtol=0.0,
                 maxiter=50, error_on_nonconvergence=True,
                 label="Newton") -> NewtonResult:
    """Iterate ``x <- x + step_fn(x)`` until ``||residual_fn(x)|| <= tol``.

    ``step_fn(x)`` returns the update (typically -J(x)^{-1} F(x) with the
    Jacobian of the caller's choice -- Newton or Picard).  Convergence is
    checked *before* the first update, like dolfin's NewtonSolver.
    """
    x = x0
    res0 = float(torch.linalg.vector_norm(residual_fn(x)))
    res = res0
    tol = max(atol, rtol * res0)
    iterations = 0
    if res <= tol:
        return NewtonResult(x, res, 0, True)
    for iterations in range(1, maxiter + 1):
        x = x + step_fn(x)
        res = float(torch.linalg.vector_norm(residual_fn(x)))
        if res <= max(atol, rtol * res0):
            return NewtonResult(x, res, iterations, True)
    if error_on_nonconvergence:
        raise RuntimeError(
            f"{label} iteration did not converge: residual {res:.3e} after "
            f"{iterations} iterations (atol {atol:.1e})")
    return NewtonResult(x, res, iterations, False)
