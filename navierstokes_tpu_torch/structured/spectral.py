"""Exact DFT block-diagonal solves + fused projection step (periodic).

Counterpart of ``navierstokes_tpu/structured/spectral.py``.  A stencil
over the class grids is block-circulant on the cell lattice, so the n-D
DFT block-diagonalizes it exactly: for each Fourier mode k the P2
operators become dense 2^dim x 2^dim complex blocks (one row/column per
node class -- 4x4 in 2D, 8x8 in 3D), the P1 Laplacian a scalar symbol.
The three linear solves of the incremental projection scheme (Helmholtz,
pressure Poisson, mass correction) are then *direct* solves with
machine-precision accuracy -- a stronger guarantee than the fixed CG
sweeps of the banded path.

The device code keeps the JAX module's layout so the two can be held
against each other function by function: spectral fields are split re/im
real pairs, the DFT is two cos/sin matrix products per axis, and the
Helmholtz solve (a0/k M + nu K) x = b is reduced at setup (host,
complex128) to a generalized eigenbasis per mode:

    (a M + nu K)^{-1} = P diag(1 / (a + nu lam)) P^H,
    P = L^{-H} Q,  M = L L^H,  L^{-1} K L^{-H} = Q diag(lam) Q^H

so the per-step device work is fixed precomputed block products plus one
elementwise divide by the scalar ``a`` -- variable time steps never
re-factorize.

Left behind as TPU artefacts:
  * ``NS_TPU_MATMUL_PRECISION`` / ``_PREC``: every product runs in full
    precision (``config`` turns TF32 off at import).
  * ``step.raw`` / ``step.big_arrays`` as arguments of a jitted function (a
    compile-transport workaround): the step closes over its tensors;
    :func:`spectral_ops_to_numpy` carries them across instead.
  * ``lax.scan`` chunks of steps: the port steps eagerly.

``shard_spectral_step`` waits for the multi-device slice and raises
``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.structured.grid import PeriodicStructuredTH
from navierstokes_tpu_torch.structured.ops import StructuredConvection

# the per-mode arrays that spectral_ops_to_numpy / _from_numpy carry
_SPLIT_ARRAYS = ("Mhat", "Khat", "Ghat", "Dhat", "P", "PH")
_REAL_ARRAYS = ("lam", "Linv")
# _cmatmul lowering when NS_TPU_BLOCK_APPLY is unset, in 2D and 3D alike: on
# an H100 the batched product of 8x8 blocks runs through a small-matrix
# GEMM kernel several times slower than the broadcast-multiply-sum, and
# with 4x4 blocks the two tie (PERF.md section 6)
_BLOCK_APPLY_DEFAULT = "vpu"


def _mm_axis(M, X, axis, add=None, alpha=1.0):
    """Apply matrix M (k, g) along ``axis`` of X: out[..., k, ...]; with
    ``add``, ``add += alpha * (M applied to X)`` in place, in one call.

    ``X`` (and ``add``) must be contiguous: the axis is reached by viewing
    X as (pre, g, post), so the result is contiguous in X's layout and
    nothing is permuted or copied."""
    shape = X.shape
    pre = int(np.prod(shape[:axis]))
    X3 = X.reshape(pre, shape[axis], -1)
    Mb = M.expand(pre, -1, -1)
    out_shape = shape[:axis] + (M.shape[0],) + shape[axis + 1:]
    if add is None:
        return torch.bmm(Mb, X3).reshape(out_shape)
    add.reshape(pre, M.shape[0], -1).baddbmm_(Mb, X3, alpha=alpha)
    return add


def _symbol(taps, shape, blk, n_uclass):
    """Fourier symbol of a tap set: S[k] = sum_s w(s) e^{+2 pi i k.s / N}.

    ``blk``: trailing block shape, e.g. (2^dim, 2^dim) for P2->P2 taps
    with scalar weights, (2^dim, d) for the gradient/divergence couplings
    (the class axis is whichever side is P2 -- output for the gradient,
    input for the divergence), () for the P1 Laplacian.
    """
    dim = len(shape)
    T = np.zeros(tuple(shape) + blk, dtype=np.complex128)
    for (co, ci), entries in taps.items():
        for s, w in entries:
            g = tuple(s[a] % shape[a] for a in range(dim))
            if blk == (n_uclass, n_uclass):
                T[g + (co, ci)] += w
            elif blk == ():
                T[g] += w
            else:                       # (2^dim, d) coupling: the P2 class
                T[g + (max(co, ci),)] += np.asarray(w)
    return np.conj(np.fft.fftn(T, axes=tuple(range(dim))))


class SplitC(NamedTuple):
    """A complex tensor as a (re, im) pair of real device tensors."""

    re: torch.Tensor
    im: torch.Tensor


class MatmulDFT:
    """n-D DFT over the grid axes as cos/sin matrix products.

    Operates on contiguous tensors with layout (a, *grid, d): grid axes
    are 1..dim inclusive.
    """

    def __init__(self, shape, dtype, device):
        def mats(n):
            k = np.arange(n)
            ang = 2.0 * np.pi * np.outer(k, k) / n
            return (torch.tensor(np.cos(ang), dtype=dtype, device=device),
                    torch.tensor(np.sin(ang), dtype=dtype, device=device))

        self.shape = tuple(shape)
        self.mats = [mats(n) for n in self.shape]

    def fwd(self, X):
        """Real (a, *grid, d) -> SplitC, numpy fft convention
        (e^{-2 pi i k g / N}): per axis multiply by C - iS."""
        re, im = X, None
        for i, (C, S) in enumerate(self.mats):
            ax = 1 + i
            if im is None:
                re, im = _mm_axis(C, re, ax), -_mm_axis(S, re, ax)
            else:
                re, im = (
                    _mm_axis(S, im, ax, add=_mm_axis(C, re, ax)),
                    _mm_axis(S, re, ax, add=_mm_axis(C, im, ax), alpha=-1.0))
        return SplitC(re, im)

    def inv_real(self, Z: SplitC):
        """Real part of the inverse n-D DFT of an (a, *grid, d) SplitC.

        Applies (C + iS)/N per axis; the imaginary part of the LAST axis
        apply is never used and never computed."""
        s = 1.0 / float(np.prod(self.shape))
        re, im = Z.re, Z.im
        last = len(self.mats) - 1
        for i, (C, S) in enumerate(self.mats):
            ax = 1 + i
            re_new = _mm_axis(S, im, ax, add=_mm_axis(C, re, ax), alpha=-1.0)
            if i < last:
                im = _mm_axis(S, re, ax, add=_mm_axis(C, im, ax))
            re = re_new
        return s * re


def _cmatmul(S, V: SplitC, mode=None):
    """Split-complex per-mode block apply: S (split symbol) times V, the
    contraction ``...ab,...bd->...ad``.

    A huge batch (one per Fourier mode) of tiny products --
    (2^dim x 2^dim) @ (2^dim x d) -- with two lowerings, named as in the
    JAX package: ``einsum`` is one batched matrix product over the modes,
    ``vpu`` an explicit broadcast-multiply-sum.  ``mode`` (else
    ``NS_TPU_BLOCK_APPLY``, else ``vpu``) picks one.
    """
    Sr, Si = S
    if mode is None:
        mode = os.environ.get("NS_TPU_BLOCK_APPLY", _BLOCK_APPLY_DEFAULT)
    if mode == "einsum":
        nb, nd = V.re.shape[-2:]
        A, B = Sr.reshape(-1, nb, nb), Si.reshape(-1, nb, nb)
        x, y = V.re.reshape(-1, nb, nd), V.im.reshape(-1, nb, nd)
        re = torch.baddbmm(torch.bmm(A, x), B, y, alpha=-1.0)
        im = torch.baddbmm(torch.bmm(A, y), B, x)
        return SplitC(re.reshape(V.re.shape), im.reshape(V.im.shape))
    if mode != "vpu":
        raise ValueError(f"NS_TPU_BLOCK_APPLY={mode!r}: expected 'vpu' or "
                         "'einsum'")

    def mm(A, X):
        return torch.sum(A[..., :, :, None] * X[..., None, :, :], dim=-2)

    re = mm(Sr, V.re) - mm(Si, V.im)
    im = mm(Sr, V.im) + mm(Si, V.re)
    return SplitC(re, im)


class SpectralOperators:
    """Precomputed Fourier symbols + eigenbases, all-real device tensors.

    Spectral velocity layout: SplitC of (*grid, 2^dim, d); pressure
    SplitC of (*grid).  Tensors are made on ``device`` (default: the card;
    the CPU only with ``device="cpu"``) in ``dtype`` (default
    ``config.default_dtype``).
    """

    def __init__(self, sgrid: PeriodicStructuredTH, dtype=None, device=None):
        self._init_layout(sgrid, dtype, device)
        shape, d, nc = self.shape, self.d, self.n_uclass

        blk = (nc, nc)
        Mh = _symbol(sgrid.taps_uu(sgrid.M_tau), shape, blk, nc)
        Kh = _symbol(sgrid.taps_uu(sgrid.K_tau), shape, blk, nc)
        # enforce Hermitian symmetry (symmetric real-space operators)
        Mh = 0.5 * (Mh + np.conj(np.swapaxes(Mh, -1, -2)))
        Kh = 0.5 * (Kh + np.conj(np.swapaxes(Kh, -1, -2)))
        self.Mhat = self._split(Mh)
        self.Khat = self._split(Kh)
        self.Ghat = self._split(
            _symbol(sgrid.taps_up(sgrid.G_tau), shape, (nc, d), nc))
        self.Dhat = self._split(
            _symbol(sgrid.taps_pu(sgrid.G_tau), shape, (nc, d), nc))

        # P1 Laplacian: symmetric stencil -> real symbol; pseudo-inverse
        # (the k=0 constant mode is the mean-pressure null space)
        Lh = _symbol(sgrid.taps_pp(sgrid.L_tau), shape, (), nc)
        if not np.abs(Lh.imag).max() < 1e-9 * np.abs(Lh.real).max():
            raise ValueError("the P1 Laplacian symbol is not real")
        Lr = Lh.real.copy()
        zero = (0,) * self.dim
        Lr[zero] = 1.0
        Linv = 1.0 / Lr
        Linv[zero] = 0.0
        self.Linv = self._real(Linv)

        # generalized eigenbasis of (M, K) per mode (host, complex128):
        # M = L L^H; B = L^-1 K L^-H = Q lam Q^H; P = L^-H Q
        Lc = np.linalg.cholesky(Mh)
        Lc_inv = np.linalg.inv(Lc)
        B = Lc_inv @ Kh @ np.conj(np.swapaxes(Lc_inv, -1, -2))
        B = 0.5 * (B + np.conj(np.swapaxes(B, -1, -2)))
        lam, Q = np.linalg.eigh(B)
        P = np.conj(np.swapaxes(Lc_inv, -1, -2)) @ Q
        self.P = self._split(P)                     # (*grid, 2^dim, 2^dim)
        self.PH = self._split(np.conj(np.swapaxes(P, -1, -2)))
        self.lam = self._real(np.maximum(lam, 0.0))

    def _init_layout(self, sgrid, dtype, device):
        self.sgrid = sgrid
        self.shape, self.d = sgrid.shape, sgrid.space.dim
        self.dim = len(self.shape)
        self.n_uclass = sgrid.n_uclass
        self.device = config.require_device(device)
        self.rdtype = config.resolve_dtype(dtype, self.device)
        self.dft = MatmulDFT(self.shape, self.rdtype, self.device)

    def _real(self, a):
        return torch.tensor(np.ascontiguousarray(a), dtype=self.rdtype,
                            device=self.device)

    def _split(self, z):
        return (self._real(np.real(z)), self._real(np.imag(z)))

    # -- transforms ----------------------------------------------------------
    # The DFT works on contiguous (a, *grid, d), the block applies on
    # contiguous (*grid, a, d): fwd_u and inv_u each copy re and im once
    # between the two layouts, and nothing else on the path permutes.
    def fwd_u(self, U):
        """Physical (2^dim, *grid, d) -> spectral SplitC (*grid, 2^dim, d)."""
        Z = self.dft.fwd(U.contiguous())
        perm = tuple(range(1, 1 + self.dim)) + (0, 1 + self.dim)
        return SplitC(Z.re.permute(perm).contiguous(),
                      Z.im.permute(perm).contiguous())

    def inv_u(self, Uh: SplitC):
        perm = (self.dim,) + tuple(range(self.dim)) + (self.dim + 1,)
        return self.dft.inv_real(SplitC(Uh.re.permute(perm).contiguous(),
                                        Uh.im.permute(perm).contiguous()))

    def fwd_p(self, P):
        Z = self.dft.fwd(P.contiguous()[None, ..., None])
        return SplitC(Z.re[0, ..., 0], Z.im[0, ..., 0])

    def inv_p(self, Ph: SplitC):
        Z = SplitC(Ph.re.contiguous()[None, ..., None],
                   Ph.im.contiguous()[None, ..., None])
        return self.dft.inv_real(Z)[0, ..., 0]

    # -- spectral operator applications --------------------------------------
    def mass(self, Uh: SplitC):
        return _cmatmul(self.Mhat, Uh)

    def stiffness(self, Uh: SplitC):
        return _cmatmul(self.Khat, Uh)

    def grad(self, Ph: SplitC):
        Gr, Gi = self.Ghat
        pr, pi = Ph.re[..., None, None], Ph.im[..., None, None]
        return SplitC(Gr * pr - Gi * pi, Gr * pi + Gi * pr)

    def div(self, Uh: SplitC):
        Dr, Di = self.Dhat
        re = (Dr * Uh.re - Di * Uh.im).sum(dim=(-2, -1))
        im = (Dr * Uh.im + Di * Uh.re).sum(dim=(-2, -1))
        return SplitC(re, im)

    def helmholtz_solve(self, accel0, visc, Bh: SplitC):
        """(accel0 M + visc K) Uh = Bh via the precomputed eigenbasis:
        Uh = P diag(1/(accel0 + visc lam)) P^H Bh.  ``accel0`` and ``visc``
        are Python floats."""
        t = _cmatmul(self.PH, Bh)
        scale = (1.0 / (accel0 + visc * self.lam))[..., None]
        return _cmatmul(self.P, SplitC(t.re * scale, t.im * scale))

    def mass_solve(self, Bh: SplitC):
        """M^{-1} = P P^H (the visc=0, accel0=1 eigen-solve)."""
        return _cmatmul(self.P, _cmatmul(self.PH, Bh))

    def poisson_solve(self, Rh: SplitC):
        return SplitC(self.Linv * Rh.re, self.Linv * Rh.im)


def _to_numpy(a):
    """Host copy of a torch tensor or any array-like (JAX arrays too)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def spectral_ops_to_numpy(ops) -> dict:
    """The symbol and eigenbasis arrays of a ``SpectralOperators`` as a
    dict of NumPy arrays: ``Mhat, Khat, Ghat, Dhat, P, PH`` as (re, im)
    pairs, ``lam`` and ``Linv``.

    ``ops`` is a SpectralOperators of either package: only these
    attributes are read, each through ``numpy.asarray``."""
    d = {name: tuple(_to_numpy(a) for a in getattr(ops, name))
         for name in _SPLIT_ARRAYS}
    d.update({name: _to_numpy(getattr(ops, name)) for name in _REAL_ARRAYS})
    return d


def spectral_ops_from_numpy(sgrid, d, dtype=None, device=None):
    """The port's ``SpectralOperators`` on ``sgrid`` with the arrays of
    :func:`spectral_ops_to_numpy`'s dict in place of its own host setup,
    on ``device`` (default: the card; the CPU only with ``device="cpu"``).
    """
    ops = SpectralOperators.__new__(SpectralOperators)
    ops._init_layout(sgrid, dtype, device)
    lead = tuple(ops.shape)
    for name in _SPLIT_ARRAYS:
        re, im = (np.asarray(a) for a in d[name])
        if re.shape != im.shape or re.shape[:ops.dim] != lead:
            raise ValueError(f"{name}: shapes {re.shape}/{im.shape} do not "
                             f"fit the grid {lead}")
        setattr(ops, name, (ops._real(re), ops._real(im)))
    for name in _REAL_ARRAYS:
        a = np.asarray(d[name])
        if a.shape[:ops.dim] != lead:
            raise ValueError(f"{name}: shape {a.shape} does not fit the "
                             f"grid {lead}")
        setattr(ops, name, ops._real(a))
    return ops


def build_spectral_projection_step(sgrid: PeriodicStructuredTH, *, visc,
                                   dt, dtype=None, device=None, ops=None):
    """Fused projection step on class grids with exact spectral solves.

    Returns ``(step, init_state, read_state)``:

      * ``state = step(state, alpha, eta, k=None)`` advances one SBDF step
        (``alpha=(a0,a1,a2)`` BDF weights, ``eta=(e0,e1)`` convection
        extrapolation, ``k`` the step size, default ``dt`` -- all Python
        floats, so a step builds no scalar tensor and never waits for the
        device); ``state = (U, U_old, Uh, Uh_old, Ph)``;
      * ``init_state(u_flat, u_old_flat, p_flat) -> state`` from flat host
        arrays;
      * ``read_state(state) -> (u_flat, p_flat)`` as flat NumPy arrays in
        the host layout.

    Tensors live on ``device`` (default: the card; the CPU only with
    ``device="cpu"``) in ``dtype``.  ``ops``: a ``SpectralOperators`` to
    step with (from :func:`spectral_ops_from_numpy`) instead of building
    one; its device and dtype are then the step's.
    """
    if ops is None:
        ops = SpectralOperators(sgrid, dtype=dtype, device=device)
    elif ops.sgrid is not sgrid:
        raise ValueError("ops were built on another class grid")
    dev, rdtype = ops.device, ops.rdtype
    conv = StructuredConvection(sgrid, dtype=rdtype, device=dev)
    zero_mode = (0,) * len(sgrid.shape)
    visc, dt = float(visc), float(dt)

    def axpy(a, X: SplitC, Y):
        if Y is None:
            return SplitC(a * X.re, a * X.im)
        return SplitC(torch.add(Y.re, X.re, alpha=a),
                      torch.add(Y.im, X.im, alpha=a))

    def step(state, alpha, eta, k=None):
        U, U_old, Uh, Uh_old, Ph = state
        a0, a1, a2 = alpha
        if k is None:
            k = dt

        # (1) Helmholtz: (a0/k M + nu K) u* = -(a1/k)M u - (a2/k)M u_old
        #                                     - C(extrapolated u) - G p
        U_ext = eta[0] * U + eta[1] * U_old
        Ch = ops.fwd_u(conv(U_ext))
        Bh = axpy(-(a1 / k), ops.mass(Uh), None)
        Bh = axpy(-(a2 / k), ops.mass(Uh_old), Bh)
        Bh = axpy(-1.0, Ch, Bh)
        Bh = axpy(-1.0, ops.grad(Ph), Bh)
        Ustar_h = ops.helmholtz_solve(a0 / k, visc, Bh)

        # (2) incremental pressure Poisson (exact, mean-free)
        Phi_h = ops.poisson_solve(axpy(a0 / k, ops.div(Ustar_h), None))

        # (3) velocity correction + pressure update
        Uh_new = axpy(-(k / a0), ops.mass_solve(ops.grad(Phi_h)), Ustar_h)
        # fresh sums, so zeroing the constant mode touches no tensor that
        # the old state still holds
        Ph_new = SplitC(Ph.re + Phi_h.re, Ph.im + Phi_h.im)
        Ph_new.re[zero_mode] = 0.0
        Ph_new.im[zero_mode] = 0.0

        U_new = ops.inv_u(Uh_new)
        return (U_new, U, Uh_new, Uh, Ph_new)

    def to_device(a):
        return torch.tensor(np.asarray(a), dtype=rdtype, device=dev)

    def init_state(u_flat, u_old_flat, p_flat):
        U = to_device(sgrid.u_to_grids(np.asarray(u_flat)))
        U_old = to_device(sgrid.u_to_grids(np.asarray(u_old_flat)))
        P = to_device(sgrid.p_to_grid(np.asarray(p_flat)))
        Ph = ops.fwd_p(P - P.mean())
        return (U, U_old, ops.fwd_u(U), ops.fwd_u(U_old), Ph)

    def read_state(state):
        U, _, _, _, Ph = state
        u_flat = sgrid.grids_to_u(_to_numpy(U))
        p_flat = sgrid.grid_to_p(_to_numpy(ops.inv_p(Ph)))
        return u_flat, p_flat

    step.ops = ops
    return step, init_state, read_state


def shard_spectral_step(step, sgrid, device_mesh, axis_name=None):
    """Slab-decompose a built spectral step over several devices: not
    ported yet (it comes with the multi-device slice)."""
    raise NotImplementedError(
        "shard_spectral_step is not ported yet: the slab-sharded spectral "
        "step comes with the multi-device slice")
