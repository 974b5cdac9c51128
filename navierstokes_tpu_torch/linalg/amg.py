"""Smoothed-aggregation algebraic multigrid for SPD systems (counterpart of
``navierstokes_tpu/linalg/amg.py``).

Setup runs on the host (NumPy/SciPy f64, once per space); the V-cycle runs
on the device: every level's operator is a row-wise padded gather table
(``_DeviceCSR``) or a small dense matrix, smoothing is weighted Jacobi,
the transfers are an aggregation gather and a fixed-order segment sum, and
the coarsest level is a precomputed dense pseudo-inverse.  No step of the
cycle uses atomics, so it gives the same bits on every run.  ``apply``
takes one right-hand side (n,) or several as the columns of (n, k): one
V-cycle for all of them.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.segment import (SegmentSum,
                                                   ell_from_sorted_coo,
                                                   padded_row_sum, take_rows)


def _columns(v, x):
    """The (n,) vector ``v`` shaped to scale the rows of ``x``."""
    return v.view(v.shape + (1,) * (x.dim() - 1))


class _DeviceCSR:
    """Sparse level operator: a gather through the padded row table and a
    sum over each row's products in column order."""

    def __init__(self, sp_mat, dtype, device):
        coo = sp_mat.tocoo()
        order = np.lexsort((coo.col, coo.row))
        self.n_rows, self.n_cols = sp_mat.shape
        table, slots = ell_from_sorted_coo(coo.row[order], coo.col[order],
                                           self.n_rows, pad=self.n_cols)
        vals = np.zeros(table.size)
        vals[slots] = coo.data[order]
        self.cols = torch.as_tensor(table, device=device)
        self.vals = torch.tensor(vals.reshape(table.shape), dtype=dtype,
                                 device=device)

    def matvec(self, x):
        return padded_row_sum(self.cols, x, self.vals)


class _DeviceDense:
    """Small-level dense operator: one matmul per matvec."""

    def __init__(self, sp_mat, dtype, device):
        self.n_rows, self.n_cols = sp_mat.shape
        self.mat = torch.tensor(sp_mat.toarray(), dtype=dtype, device=device)

    def matvec(self, x):
        return self.mat @ x


def _aggregate(A, theta=0.08):
    """Greedy strength-based aggregation. Returns (n,) aggregate ids."""
    n = A.shape[0]
    d = np.abs(A.diagonal())
    d = np.where(d > 0.0, d, 1.0)
    C = A.tocoo()
    off = C.row != C.col
    strong = (np.abs(C.data) >
              theta * np.sqrt(d[C.row] * d[C.col])) & off
    S = sp.csr_matrix((np.ones(strong.sum()),
                       (C.row[strong], C.col[strong])), shape=(n, n))

    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    indptr, indices = S.indptr, S.indices
    # pass 1: roots whose strong neighborhood is untouched
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.all(agg[nbrs] == -1):
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    # pass 2: attach stragglers to a neighboring aggregate
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        owned = nbrs[agg[nbrs] != -1]
        if len(owned):
            agg[i] = agg[owned[0]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _lambda_max_dinv_a(A, n_iter=20, seed=0):
    """Power-iteration estimate of lambda_max(D^{-1} A) (host, NumPy)."""
    n = A.shape[0]
    dinv = 1.0 / np.where(np.abs(A.diagonal()) > 0, A.diagonal(), 1.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    lam = 1.0
    for _ in range(n_iter):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam == 0.0:
            return 1.0
        v = w / lam
    return float(lam)


class AMG:
    """Smoothed-aggregation V-cycle preconditioner for an SPD matrix.

    ``apply(r)`` approximates A^{-1} r.  Tensors live on ``device``
    (default: the card; the CPU only with ``device="cpu"``) in ``dtype``
    (default ``config.default_dtype(device)``).
    """

    @monitor.spanned("setup.amg")
    def __init__(self, A_scipy, *, dtype=None, device=None, max_levels=10,
                 coarse_size=200, theta=0.08, jacobi_weight=2.0 / 3.0,
                 pre_smooth=1, post_smooth=1, dense_level_cap=None):
        device = config.require_device(device)
        dtype = config.resolve_dtype(dtype, device)
        if dense_level_cap is None:
            dense_level_cap = int(os.environ.get("NS_AMG_DENSE_CAP", "768"))
        self.pre_smooth = pre_smooth
        self.post_smooth = post_smooth
        self.w = jacobi_weight

        A = sp.csr_matrix(A_scipy)
        self.levels = []   # per level: dict(A, dinv, agg, restrict, c, n_agg)
        while A.shape[0] > coarse_size and len(self.levels) < max_levels:
            agg, n_agg = _aggregate(A, theta)
            if n_agg >= A.shape[0]:    # aggregation stalled
                break
            P0 = sp.csr_matrix(
                (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
                shape=(A.shape[0], n_agg))
            lam = _lambda_max_dinv_a(A)
            dinv = 1.0 / np.where(np.abs(A.diagonal()) > 0,
                                  A.diagonal(), 1.0)
            Dinv = sp.diags(dinv)
            c = 4.0 / (3.0 * lam)
            P = sp.csr_matrix((sp.eye(A.shape[0]) - c * Dinv @ A) @ P0)
            # the transfers are never stored: P = (I - c D^-1 A) P0 and
            # R = P^T factor through this level's matvec plus a plain
            # aggregation gather / segment sum.  Levels at or below
            # ``dense_level_cap`` rows store A densely.
            dense = A.shape[0] <= dense_level_cap
            dinv_dev = torch.tensor(dinv, dtype=dtype, device=device)
            self.levels.append({
                "A": (_DeviceDense(A, dtype, device) if dense
                      else _DeviceCSR(A, dtype, device)),
                "dinv": dinv_dev,
                # the products the cycle applies, in its evaluation order
                "wdinv": self.w * dinv_dev,
                "cdinv": float(c) * dinv_dev,
                "agg": torch.as_tensor(agg, device=device),
                "restrict": SegmentSum(agg, n_agg, device),
                "c": float(c),
                "n_agg": int(n_agg),
            })
            A = sp.csr_matrix(sp.csr_matrix(P.T) @ A @ P)
        # coarsest: dense pseudo-inverse (handles the semidefinite
        # enclosed-flow Laplacian, where the constant is in the null space)
        self.coarse_inv = torch.tensor(
            np.linalg.pinv(A.toarray(), rcond=1e-10), dtype=dtype,
            device=device)
        self.n = A_scipy.shape[0]

    def _smooth(self, lvl, x, b, n_sweeps):
        wdinv = _columns(lvl["wdinv"], b)
        for _ in range(n_sweeps):
            x = x + wdinv * (b - lvl["A"].matvec(x))
        return x

    def _vcycle(self, k, b):
        if k == len(self.levels):
            return self.coarse_inv @ b
        lvl = self.levels[k]
        A, agg, c = lvl["A"], lvl["agg"], lvl["c"]
        dinv = _columns(lvl["dinv"], b)
        x = self._smooth(lvl, torch.zeros_like(b), b, self.pre_smooth)
        r = b - A.matvec(x)
        # R r = P0^T (I - c A D^-1) r  (A symmetric)
        rs = r - c * A.matvec(dinv * r)
        rc = lvl["restrict"](rs)
        xc = self._vcycle(k + 1, rc)
        # P xc = (I - c D^-1 A) P0 xc
        y = take_rows(xc, agg)
        x = x + (y - _columns(lvl["cdinv"], b) * A.matvec(y))
        return self._smooth(lvl, x, b, self.post_smooth)

    def apply(self, r):
        """One V-cycle: approximate A^{-1} r for r (n,) or each column of
        r (n, k).  Its device work is the phase ``amg.vcycle``."""
        with monitor.phase("amg.vcycle"):
            return self._vcycle(0, r)

    def solve(self, b, x0=None, tol=1e-12, maxiter=200):
        """AMG-preconditioned CG to tolerance."""
        from navierstokes_tpu_torch.linalg.krylov import cg

        A0 = self.levels[0]["A"] if self.levels else None
        mv = (A0.matvec if A0 is not None
              else lambda x: torch.linalg.solve(self.coarse_inv, x))
        return cg(mv, b, x0=x0, tol=tol, maxiter=maxiter, M=self.apply)


def symmetric_dirichlet(A_scipy, dofs):
    """Zero rows+columns at ``dofs`` and set unit diagonals (SPD-preserving)."""
    n = A_scipy.shape[0]
    keep = np.ones(n)
    keep[np.asarray(dofs, dtype=np.int64)] = 0.0
    K = sp.diags(keep)
    fix = sp.diags(1.0 - keep)
    return sp.csr_matrix(K @ A_scipy @ K + fix)


def pressure_laplacian_scipy(space, *, mass_shift=0.0, dirichlet_dofs=None):
    """Assemble the P1 pressure-space Laplacian as a host scipy CSR.

    ``mass_shift``: optional +shift*M regularization so AMG setup on the
    semidefinite enclosed-flow operator stays SPD (the device-side outer
    iteration still projects out the mean; the preconditioner only needs
    to be spectrally close).  ``dirichlet_dofs``: pressure dofs to pin
    (symmetric elimination, unit diagonal).
    """
    # host NumPy float64 whatever the device dtype: the hierarchy is built
    # once and must not inherit f32 storage precision
    Jinv = np.asarray(space.Jinv_q, dtype=np.float64)
    W = np.asarray(space.integration_weights(), dtype=np.float64)
    G1 = np.asarray(space.G1, dtype=np.float64)
    g1 = np.einsum("qia,cqae->cqie", G1, Jinv)
    K_c = np.einsum("cq,cqie,cqje->cij", W, g1, g1)
    if mass_shift:
        N1 = np.asarray(space.N1, dtype=np.float64)
        K_c = K_c + mass_shift * np.einsum("cq,qi,qj->cij", W, N1, N1)
    cd = np.asarray(space.cell_pnodes, dtype=np.int64)
    nloc = cd.shape[1]
    rows = np.repeat(cd, nloc, axis=1).reshape(-1)
    cols = np.tile(cd, (1, nloc)).reshape(-1)
    n = space.n_pnodes
    A = sp.csr_matrix((K_c.reshape(-1), (rows, cols)), shape=(n, n))
    if dirichlet_dofs is not None and len(dirichlet_dofs):
        A = symmetric_dirichlet(A, dirichlet_dofs)
    return A


def velocity_stiffness_scipy(space, *, mass_shift=0.0, dirichlet_dofs=None):
    """Scalar P2 stiffness (+shift*mass) as host scipy CSR (float64).

    One velocity component's diffusion operator: the AMG built on it
    preconditions the PCD velocity block component-wise (fixed Jacobi
    sweeps degrade as O(1/h); this keeps the block solve h-independent).
    ``dirichlet_dofs``: scalar u-node ranks to pin symmetrically.
    """
    Jinv = np.asarray(space.Jinv_q, dtype=np.float64)
    W = np.asarray(space.integration_weights(), dtype=np.float64)
    G2 = np.asarray(space.G2, dtype=np.float64)
    g2 = np.einsum("qia,cqae->cqie", G2, Jinv)
    K_c = np.einsum("cq,cqie,cqje->cij", W, g2, g2)
    if mass_shift:
        N2 = np.asarray(space.N2, dtype=np.float64)
        K_c = K_c + mass_shift * np.einsum("cq,qi,qj->cij", W, N2, N2)
    cd = np.asarray(space.cell_unodes, dtype=np.int64)
    nloc = cd.shape[1]
    rows = np.repeat(cd, nloc, axis=1).reshape(-1)
    cols = np.tile(cd, (1, nloc)).reshape(-1)
    n = space.n_unodes
    A = sp.csr_matrix((K_c.reshape(-1), (rows, cols)), shape=(n, n))
    if dirichlet_dofs is not None and len(dirichlet_dofs):
        A = symmetric_dirichlet(A, dirichlet_dofs)
    return A


def pressure_mass_scipy(space):
    W = np.asarray(space.integration_weights(), dtype=np.float64)
    N1 = np.asarray(space.N1, dtype=np.float64)
    M_c = np.einsum("cq,qi,qj->cij", W, N1, N1)
    cd = np.asarray(space.cell_pnodes, dtype=np.int64)
    nloc = cd.shape[1]
    rows = np.repeat(cd, nloc, axis=1).reshape(-1)
    cols = np.tile(cd, (1, nloc)).reshape(-1)
    n = space.n_pnodes
    return sp.csr_matrix(
        (M_c.reshape(-1), (rows, cols)), shape=(n, n))
