"""Flexible GMRES, right-preconditioned and restarted (counterpart of
``navierstokes_tpu/linalg/fgmres.py``).

The preconditioner may itself be an inexact, varying iterative solve --
the setting of block preconditioners like PCD, whose every application
runs inner sweeps.

``fgmres`` orchestrates the Arnoldi process from the host with modified
Gram-Schmidt (one host read per inner iteration).  ``fgmres_device``
keeps the basis on the device with batched CGS2 orthogonalization and
reads the host only between inner loops: once per restart cycle to solve
the small (m+1) x m least-squares problem with ``numpy.linalg.lstsq``
(SVD-based, as ``jnp.linalg.lstsq``; this host step stands in for the
reference's on-device solve because ``torch.linalg.lstsq`` on CUDA assumes
full rank), and once per cycle to read the residual norm its convergence
test needs.
"""

from __future__ import annotations

import numpy as np
import torch


def _norm(x):
    return torch.linalg.vector_norm(x)


def fgmres(matvec, b, M_apply=None, x0=None, tol=1e-10, atol=1e-12,
           restart=60, maxiter=300):
    """Solve A x = b with flexible right preconditioning.

    ``M_apply(v)`` approximates A^{-1} v and may vary between calls.
    Returns (x, final_residual_norm, total_iterations).
    """
    if M_apply is None:
        M_apply = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0

    b_norm = float(_norm(b))
    target = max(tol * b_norm, atol)
    total_its = 0

    r = b - matvec(x)
    res = float(_norm(r))

    while res > target and total_its < maxiter:
        m = min(restart, maxiter - total_its)
        V = [r / res]
        Z = []
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = res
        # Givens rotations
        cs = np.zeros(m)
        sn = np.zeros(m)
        k_used = 0
        for k in range(m):
            z = M_apply(V[k])
            w = matvec(z)
            Z.append(z)
            # modified Gram-Schmidt
            for i in range(k + 1):
                H[i, k] = float(torch.dot(V[i], w))
                w = w - H[i, k] * V[i]
            H[k + 1, k] = float(_norm(w))
            if H[k + 1, k] > 1e-300:
                V.append(w / H[k + 1, k])
            else:
                V.append(w)
            # apply accumulated rotations to the new column
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            if denom == 0.0:
                k_used = k + 1
                break
            cs[k] = H[k, k] / denom
            sn[k] = H[k + 1, k] / denom
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total_its += 1
            if abs(g[k + 1]) <= target:
                break
        # solve the small triangular system and update
        y = np.linalg.solve(H[:k_used, :k_used], g[:k_used])
        for i in range(k_used):
            x = x + float(y[i]) * Z[i]
        r = b - matvec(x)
        res = float(_norm(r))

    return x, res, total_its


def fgmres_device(matvec, M_apply, b, x0=None, *, restart=30, tol=1e-10,
                  atol=1e-12, max_cycles=20):
    """Restarted flexible GMRES with the basis on the device.

    Each cycle runs its full ``restart`` inner iterations (CGS2: two
    (m+1, n) products per iteration) with no host read; choose
    ``restart`` around the expected iteration count.  Cycles run while
    ``||b - A x|| > max(tol ||b||, atol)``, at most ``max_cycles``.

    Returns ``(x, residual_norm, matvec_count)`` with the count
    ``cycles * restart``, as the JAX package reports it.
    """
    n = b.shape[0]
    m = restart
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    b_norm, res = torch.stack([_norm(b), _norm(r)]).tolist()
    target = max(tol * b_norm, atol)
    steps = torch.arange(m + 1, device=b.device)

    cycles = 0
    while res > target and cycles < max_cycles:
        beta = _norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = r / torch.where(beta > 0.0, beta, 1.0)
        Z = b.new_zeros((m, n))
        H = b.new_zeros((m + 1, m))
        for k in range(m):
            z = M_apply(V[k])
            w = matvec(z)
            mask = (steps <= k).to(b.dtype)
            h1 = (V @ w) * mask                 # CGS pass 1
            w = w - h1 @ V
            h2 = (V @ w) * mask                 # CGS pass 2 (reorthogonalize)
            w = w - h2 @ V
            hk1 = _norm(w)
            V[k + 1] = w / torch.where(hk1 > 0.0, hk1, 1.0)
            H[:, k] = h1 + h2
            H[k + 1, k] = hk1
            Z[k] = z
        # host step: the (m+1) x m least-squares problem
        host = torch.cat([H.reshape(-1), beta.reshape(1)]).cpu().numpy()
        e1 = np.zeros(m + 1, dtype=host.dtype)
        e1[0] = host[-1]
        y, *_ = np.linalg.lstsq(host[:-1].reshape(m + 1, m), e1, rcond=None)
        x = x + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ Z
        r = b - matvec(x)
        res = float(_norm(r))
        cycles += 1
    return x, res, cycles * m
