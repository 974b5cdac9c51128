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

``shard_spectral_step`` slab-decomposes a built step over the shards of
a device mesh, with the collectives written out (the JAX function leaves
them to GSPMD): the class grids are split along grid axis 1, the
convection reads a halo of its stencil's reach from the neighbouring
slabs, the DFT along that axis computes each shard's output rows from an
all-gather of the axis, and every per-mode solve is local.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.parallel.comm import (allgather, as_mesh,
                                                  ppermute)
from navierstokes_tpu_torch.structured import cuda_modal
from navierstokes_tpu_torch.structured.grid import (NotStructured,
                                                    PeriodicStructuredTH)
from navierstokes_tpu_torch.structured.ops import (StructuredConvection,
                                                   _roll)
from navierstokes_tpu_torch.utils import monitor

# the per-mode arrays that spectral_ops_to_numpy / _from_numpy carry
_SPLIT_ARRAYS = ("Mhat", "Khat", "Ghat", "Dhat", "P", "PH")
_REAL_ARRAYS = ("lam", "Linv")
# _cmatmul lowering when NS_TPU_BLOCK_APPLY is unset.  The knob picks the
# lowering of the plain chain, which runs on the CPU and mirrors the JAX
# package's two; on a card the per-mode work is cuda_modal's kernels
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
    are 1..dim inclusive.  The device work of each transform is the phase
    ``spectral.dft``.
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
        with monitor.phase("spectral.dft"):
            for i, (C, S) in enumerate(self.mats):
                ax = 1 + i
                if im is None:
                    re, im = _mm_axis(C, re, ax), -_mm_axis(S, re, ax)
                else:
                    re, im = (
                        _mm_axis(S, im, ax, add=_mm_axis(C, re, ax)),
                        _mm_axis(S, re, ax, add=_mm_axis(C, im, ax),
                                 alpha=-1.0))
        return SplitC(re, im)

    def inv_real(self, Z: SplitC):
        """Real part of the inverse n-D DFT of an (a, *grid, d) SplitC.

        Applies (C + iS)/N per axis; the imaginary part of the LAST axis
        apply is never used and never computed."""
        s = 1.0 / float(np.prod(self.shape))
        re, im = Z.re, Z.im
        last = len(self.mats) - 1
        with monitor.phase("spectral.dft"):
            for i, (C, S) in enumerate(self.mats):
                ax = 1 + i
                re_new = _mm_axis(S, im, ax, add=_mm_axis(C, re, ax),
                                  alpha=-1.0)
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

    @monitor.spanned("setup.engine",
                     owner=lambda self, sgrid, *a, **k: sgrid)
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


def _axpy(a, X: SplitC, Y):
    if Y is None:
        return SplitC(a * X.re, a * X.im)
    return SplitC(torch.add(Y.re, X.re, alpha=a),
                  torch.add(Y.im, X.im, alpha=a))


def _helmholtz_plain(ops, Ch, Uh, Uh_old, Ph, alpha, k, visc):
    """The Helmholtz phase's plain chain: u* of
    (a0/k M + nu K) u* = -(a1/k)M u - (a2/k)M u_old - C(extrapolated u)
    - G p."""
    a0, a1, a2 = alpha
    Bh = _axpy(-(a1 / k), ops.mass(Uh), None)
    Bh = _axpy(-(a2 / k), ops.mass(Uh_old), Bh)
    Bh = _axpy(-1.0, Ch, Bh)
    Bh = _axpy(-1.0, ops.grad(Ph), Bh)
    return ops.helmholtz_solve(a0 / k, visc, Bh)


def _poisson_plain(ops, Ustar_h, a0k):
    """The Poisson phase's plain chain: the incremental pressure (exact,
    mean-free)."""
    return ops.poisson_solve(_axpy(a0k, ops.div(Ustar_h), None))


def _correction_plain(ops, Ustar_h, Phi_h, Ph, ka0, has_zero_mode):
    """The correction phase's plain chain: velocity correction and
    pressure update."""
    Uh_new = _axpy(-ka0, ops.mass_solve(ops.grad(Phi_h)), Ustar_h)
    # fresh sums, so zeroing the constant mode touches no tensor that the
    # old state still holds
    Ph_new = SplitC(Ph.re + Phi_h.re, Ph.im + Phi_h.im)
    if has_zero_mode:
        # zero_() fills on the device; assigning a Python 0.0 to the
        # element would copy it from the host, which a CUDA graph refuses
        zero_mode = (0,) * ops.dim
        Ph_new.re[zero_mode].zero_()
        Ph_new.im[zero_mode].zero_()
    return Uh_new, Ph_new


def _modal_update(ops, Ch, Uh, Uh_old, Ph, alpha, k, visc, has_zero_mode):
    """The per-mode part of one step, from the spectral convection ``Ch``
    to (Uh_new, Ph_new); ``has_zero_mode``: ``ops`` holds the constant
    mode at its index 0, whose pressure is zeroed.  Its device work is
    the phases ``helmholtz``, ``poisson`` and (a first part of)
    ``correction``: on a card one kernel each (``cuda_modal``), on the
    CPU the plain chains ``_helmholtz_plain``, ``_poisson_plain`` and
    ``_correction_plain``."""
    a0 = alpha[0]
    if Uh.re.is_cuda:
        helmholtz, poisson, correction = (
            cuda_modal.helmholtz, cuda_modal.poisson, cuda_modal.correction)
    else:
        helmholtz, poisson, correction = (
            _helmholtz_plain, _poisson_plain, _correction_plain)
    with monitor.phase("helmholtz"):
        Ustar_h = SplitC(*helmholtz(ops, Ch, Uh, Uh_old, Ph, alpha, k, visc))
    with monitor.phase("poisson"):
        Phi_h = SplitC(*poisson(ops, Ustar_h, a0 / k))
    with monitor.phase("correction"):
        Uh_new, Ph_new = correction(ops, Ustar_h, Phi_h, Ph, k / a0,
                                    has_zero_mode)
    return SplitC(*Uh_new), SplitC(*Ph_new)


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
    visc, dt = float(visc), float(dt)

    def step(state, alpha, eta, k=None):
        U, U_old, Uh, Uh_old, Ph = state
        if k is None:
            k = dt
        with monitor.phase("convection"):
            U_ext = eta[0] * U + eta[1] * U_old
            Ch = ops.fwd_u(conv(U_ext))
        Uh_new, Ph_new = _modal_update(ops, Ch, Uh, Uh_old, Ph, alpha, k,
                                       visc, True)
        with monitor.phase("correction"):
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

    step.ops, step.conv, step.visc, step.dt = ops, conv, visc, dt
    return step, init_state, read_state


# ---------------------------------------------------------------------------
# several shards: the slab-sharded spectral step
# ---------------------------------------------------------------------------

def _slab(t, axis, s, w, dev):
    return t.narrow(axis, s * w, w).contiguous().to(dev, non_blocking=True)


def _slab_ops(ops, s, w, dev):
    """Shard ``s``'s view of ``ops``: every per-mode array restricted to
    the slab [s*w, (s+1)*w) of grid axis 1 (tensor axis 1), on ``dev``.
    The per-mode applies and solves read nothing else."""
    view = SpectralOperators.__new__(SpectralOperators)
    view.sgrid, view.shape, view.d = ops.sgrid, ops.shape, ops.d
    view.dim, view.n_uclass = ops.dim, ops.n_uclass
    view.device, view.rdtype = dev, ops.rdtype
    for name in _SPLIT_ARRAYS:
        setattr(view, name, tuple(_slab(a, 1, s, w, dev)
                                  for a in getattr(ops, name)))
    for name in _REAL_ARRAYS:
        setattr(view, name, _slab(getattr(ops, name), 1, s, w, dev))
    return view


class _SlabDFT:
    """``MatmulDFT`` on slabs of (a, *grid, d) split along tensor axis 2
    (grid axis 1): the other axes transform locally with the full
    matrices; along the split axis each shard all-gathers its input and
    multiplies by its own rows of the cos/sin matrices."""

    def __init__(self, dft, mesh, w):
        self.mesh, self.n = mesh, float(np.prod(dft.shape))
        self.mats = []
        for s, dev in enumerate(mesh.devices):
            per_axis = []
            for i, (C, S) in enumerate(dft.mats):
                if i == 1:
                    C, S = C[s * w:(s + 1) * w], S[s * w:(s + 1) * w]
                per_axis.append((C.contiguous().to(dev),
                                 S.contiguous().to(dev)))
            self.mats.append(per_axis)

    def _inputs(self, i, *xs):
        """Per axis i, the shard inputs: local, or all-gathered along the
        split axis."""
        if i != 1:
            return xs
        return tuple(None if x is None else allgather(x, self.mesh, 2)
                     for x in xs)

    def fwd(self, Xs):
        re, im = list(Xs), None
        for i in range(len(self.mats[0])):
            ax = 1 + i
            re_in, im_in = self._inputs(i, re, im)
            mats = [m[i] for m in self.mats]
            if im is None:
                re = [_mm_axis(C, x, ax) for (C, _), x in zip(mats, re_in)]
                im = [-_mm_axis(S, x, ax) for (_, S), x in zip(mats, re_in)]
            else:
                re, im = (
                    [_mm_axis(S, y, ax, add=_mm_axis(C, x, ax))
                     for (C, S), x, y in zip(mats, re_in, im_in)],
                    [_mm_axis(S, x, ax, add=_mm_axis(C, y, ax), alpha=-1.0)
                     for (C, S), x, y in zip(mats, re_in, im_in)])
        return [SplitC(r, m) for r, m in zip(re, im)]

    def inv_real(self, Zs):
        s = 1.0 / self.n
        re, im = [z.re for z in Zs], [z.im for z in Zs]
        last = len(self.mats[0]) - 1
        for i in range(last + 1):
            ax = 1 + i
            re_in, im_in = self._inputs(i, re, im)
            mats = [m[i] for m in self.mats]
            re_new = [_mm_axis(S, y, ax, add=_mm_axis(C, x, ax), alpha=-1.0)
                      for (C, S), x, y in zip(mats, re_in, im_in)]
            if i < last:
                im = [_mm_axis(S, x, ax, add=_mm_axis(C, y, ax))
                      for (C, S), x, y in zip(mats, re_in, im_in)]
            re = re_new
        return [s * r for r in re]


class _SlabConvection:
    """``StructuredConvection`` on slabs of (2^dim, *grid, d) split along
    tensor axis 2 (grid axis 1).

    The rolls along the split axis reach ``smin..smax`` columns (the local
    nodes' shifts), so each shard receives ``h = smax - smin`` columns
    from each neighbouring slab (periodic), evaluates the quadrature on
    its columns widened by the reach, and scatters back onto its own
    columns with no second exchange."""

    def __init__(self, conv, mesh, w):
        sg = conv.sgrid
        shift1 = sg.u_shift[..., 1]
        self.smin, self.smax = int(shift1.min()), int(shift1.max())
        self.h = self.smax - self.smin
        if self.h > w:
            raise NotStructured(f"slabs of {w} columns are narrower than "
                                f"the convection's reach ({self.h})")
        self.sgrid, self.mesh, self.w = sg, mesh, w
        # the quadrature's tables on each shard's device
        self.convs = {}
        for dev in mesh.physical_devices:
            c = StructuredConvection.__new__(StructuredConvection)
            c.sgrid, c.device, c.dtype = sg, dev, conv.dtype
            c.N2, c.g2_rows, c.WN = (t.to(dev) for t in
                                     (conv.N2, conv.g2_rows, conv.WN))
            self.convs[dev] = c

    def _widened(self, Us):
        """Each slab with h columns of its neighbours on both sides."""
        n, h, w = len(self.mesh), self.h, self.w
        if h == 0:
            return list(Us)
        left = ppermute([U.narrow(2, w - h, h) for U in Us],
                        [(s, (s + 1) % n) for s in range(n)], self.mesh)
        right = ppermute([U.narrow(2, 0, h) for U in Us],
                         [(s, (s - 1) % n) for s in range(n)], self.mesh)
        return [torch.cat([a, U, b], dim=2)
                for a, U, b in zip(left, Us, right)]

    @staticmethod
    def _other_axes(s):
        s = np.array(s)
        s[1] = 0
        return s

    def __call__(self, Us):
        sg, w = self.sgrid, self.w
        w_r = w + self.h
        out = []
        for s, Ue in enumerate(self._widened(Us)):
            conv = self.convs[self.mesh.devices[s]]
            u_loc = Ue.new_empty((sg.n_tau, sg.n_local_u, Ue.shape[1], w_r)
                                 + tuple(Ue.shape[3:]))
            for t in range(sg.n_tau):
                for l in range(sg.n_local_u):
                    sh = sg.u_shift[t, l]
                    u_loc[t, l] = _roll(Ue[sg.u_class[t, l]],
                                        self._other_axes(sh)).narrow(
                        1, int(sh[1]) - self.smin, w_r)
            R = conv.quadrature(u_loc)
            acc = R.new_zeros((sg.n_uclass,) + tuple(Us[s].shape[1:]))
            for t in range(sg.n_tau):
                for l in range(sg.n_local_u):
                    sh = sg.u_shift[t, l]
                    acc[int(sg.u_class[t, l])] += _roll(
                        R[t, l], -self._other_axes(sh)).narrow(
                        1, self.smax - int(sh[1]), w)
            out.append(acc)
        return out


def shard_spectral_step(step, sgrid, device_mesh, axis_name=None):
    """Slab-decompose a built spectral step over the shards of a device
    mesh.

    The class grids are split along grid axis 1 (tensor axis 2 of ``U``,
    axis 1 of the spectral fields and of every per-mode array): the
    convection exchanges a halo of its stencil's reach with the
    neighbouring slabs, the DFT along the split axis computes each
    shard's output rows from an all-gather of the axis, and the per-mode
    solves are local.  ``step`` is a step of
    :func:`build_spectral_projection_step` on ``sgrid``; ``device_mesh``
    a :class:`~navierstokes_tpu_torch.parallel.comm.DeviceMesh` or a
    plain sequence of devices (``axis_name`` names its axis).

    Returns ``(sharded_step, shard_state)``: ``shard_state`` splits an
    ``init_state`` result into one state per shard, and
    ``sharded_step(states, alpha, eta, k=None)`` advances them;
    ``sharded_step.gather_state(states)`` reassembles the whole state on
    the step's device (for its ``read_state``).

    Raises ``NotStructured`` when grid axis 1 does not divide into the
    shard count, or its slabs are narrower than the convection's reach.
    """
    mesh = as_mesh(device_mesh, axis_name or "shard")
    n = len(mesh)
    g1 = sgrid.shape[1]
    if g1 % n != 0:
        raise NotStructured(f"grid axis 1 ({g1}) not divisible by {n} "
                            "shards")
    w = g1 // n
    ops, visc, dt = step.ops, step.visc, step.dt
    conv = _SlabConvection(step.conv, mesh, w)
    dft = _SlabDFT(ops.dft, mesh, w)
    views = [_slab_ops(ops, s, w, dev) for s, dev in enumerate(mesh)]
    dim = ops.dim
    to_modes = tuple(range(1, 1 + dim)) + (0, 1 + dim)
    to_grids = (dim,) + tuple(range(dim)) + (dim + 1,)

    def fwd_u(Us):
        return [SplitC(Z.re.permute(to_modes).contiguous(),
                       Z.im.permute(to_modes).contiguous())
                for Z in dft.fwd(Us)]

    def inv_u(Uhs):
        return dft.inv_real([SplitC(Z.re.permute(to_grids).contiguous(),
                                    Z.im.permute(to_grids).contiguous())
                             for Z in Uhs])

    def sharded_step(states, alpha, eta, k=None):
        if k is None:
            k = dt
        with monitor.phase("convection"):
            U_ext = [eta[0] * st[0] + eta[1] * st[1] for st in states]
            Chs = fwd_u(conv(U_ext))
        updates = [_modal_update(view, Ch, st[2], st[3], st[4], alpha, k,
                                 visc, s == 0)
                   for s, (view, Ch, st) in enumerate(zip(views, Chs,
                                                          states))]
        with monitor.phase("correction"):
            U_new = inv_u([u[0] for u in updates])
        return [(Un, st[0], Uh, st[2], Ph)
                for Un, st, (Uh, Ph) in zip(U_new, states, updates)]

    # tensor axis of grid axis 1 in each state field
    axes = (2, 2, 1, 1, 1)

    def split(x, axis, s, dev):
        if isinstance(x, SplitC):
            return SplitC(_slab(x.re, axis, s, w, dev),
                          _slab(x.im, axis, s, w, dev))
        return _slab(x, axis, s, w, dev)

    def shard_state(state):
        return [tuple(split(x, a, s, dev) for x, a in zip(state, axes))
                for s, dev in enumerate(mesh)]

    def join(parts, axis):
        return torch.cat([p.to(ops.device) for p in parts], dim=axis)

    def gather_state(states):
        out = []
        for i, axis in enumerate(axes):
            parts = [st[i] for st in states]
            if isinstance(parts[0], SplitC):
                out.append(SplitC(join([p.re for p in parts], axis),
                                  join([p.im for p in parts], axis)))
            else:
                out.append(join(parts, axis))
        return tuple(out)

    sharded_step.gather_state = gather_state
    return sharded_step, shard_state
