"""Gather-free assembled-operator engine (counterpart of
``navierstokes_tpu/assembly/fastop.py``).

Assembly runs on the host in NumPy/SciPy f64, exactly as in the JAX
package; the device formats hold torch tensors:

* ``CirculantBand`` -- under a lexicographic node order the nonzero
  offsets ``(col - row) mod N`` of a periodic structured operator are few
  (P2 mass/stiffness 23 on a 2D torus, P1 Laplacian 9); the band is stored
  dense ``(n_offsets, N)`` and applied by the CUDA kernel of
  ``cuda_band.circulant_apply`` (plain torch for CPU tensors).
* ``AffineBand`` -- otherwise (operators of non-periodic boxes and of
  unstructured meshes, the rectangular velocity/pressure couplings), a
  block-window band: rows in blocks of 128, each block's columns inside a
  window whose start is affine in the block index (the reverse
  Cuthill-McKee order keeps the windows of unstructured meshes narrow);
  the apply is window construction by reshape/static slices plus one
  batched dense mat-vec (``torch.bmm``).
* ``GatherOp`` -- the rim couplings above ``NS_FASTOP_RIM_BYTES`` of band
  storage, as sorted COO applied by a padded row-wise gather.
* ``StencilCoupling`` -- the P2<->P1 gradient/divergence couplings on
  translation-class torus grids as a class-constant stencil.
* ``StridedConv`` -- the convection quadrature over translation classes
  of cells, as static slices of the wrap-padded parity phases.

The engine is dimension-agnostic, as the JAX one is: on 3D boxes the
square operators are circulant under the lexicographic order (65 offsets
for the P2 mass and stiffness, 15 for the P1 Laplacian) and the couplings
rim operators; the torus stencils and the strided convection are 2D only,
so 3D convection takes the gather form.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.segment import ell_from_sorted_coo

RB = 128  # rows per block in AffineBand


# ---------------------------------------------------------------------------
# host-side scalar element matrices and CSR assembly
# ---------------------------------------------------------------------------

def scalar_element_matrices(space):
    """Per-cell scalar P2/P1 element matrices (host f64).

    Returns dict with M2 (nc, 6, 6) P2 mass, K2 (nc, 6, 6) P2 stiffness,
    L1 (nc, 3, 3) P1 stiffness, M1 (nc, 3, 3) P1 mass and
    G (nc, 6, d, 3) pressure-gradient coupling
    G[c, i, d, j] = -int N1_j dN2_i/dx_d.
    """
    W = np.asarray(space.integration_weights(), dtype=np.float64)
    N2 = np.asarray(space.N2, dtype=np.float64)
    N1 = np.asarray(space.N1, dtype=np.float64)
    Jinv_q = np.asarray(space.Jinv_q, dtype=np.float64)
    g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2, np.float64), Jinv_q)
    g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1, np.float64), Jinv_q)
    return {
        "M2": np.einsum("cq,qi,qj->cij", W, N2, N2),
        "K2": np.einsum("cq,cqie,cqje->cij", W, g2, g2),
        "L1": np.einsum("cq,cqje,cqke->cjk", W, g1, g1),
        "M1": np.einsum("cq,qj,qk->cjk", W, N1, N1),
        "G": -np.einsum("cq,qj,cqid->cidj", W, N1, g2),
    }


def assemble_csr(vals, rows_nodes, cols_nodes, shape):
    """Scatter per-cell blocks (nc, a, b) into a CSR matrix."""
    nc, a, b = vals.shape
    r = np.repeat(rows_nodes, b, axis=1).ravel()
    c = np.tile(cols_nodes, (1, a)).ravel()
    m = sp.coo_matrix((vals.ravel(), (r, c)), shape=shape).tocsr()
    m.sum_duplicates()
    return m


def node_coordinates(space):
    """(n_unodes, d) and (n_pnodes, d) canonical node coordinates.

    Periodic slave occurrences map onto their owner; the canonical
    coordinate is the per-axis minimum over occurrences.
    """
    cu = np.asarray(space.cell_unodes)
    cp = np.asarray(space.cell_pnodes)
    X = np.asarray(space.cell_ucoords, dtype=np.float64)
    d = X.shape[-1]
    uc = np.full((space.n_unodes, d), np.inf)
    pc = np.full((space.n_pnodes, d), np.inf)
    for ax in range(d):
        np.minimum.at(uc[:, ax], cu.ravel(), X[..., ax].ravel())
        np.minimum.at(pc[:, ax], cp.ravel(),
                      X[:, :cp.shape[1], ax].ravel())
    return uc, pc


def lex_permutation(coords, tol=1e-9):
    """Row-major lexicographic node order (last axis fastest)."""
    keys = np.round(np.asarray(coords, np.float64) / tol).astype(np.int64)
    perm = np.lexsort(tuple(keys[:, ax] for ax in range(keys.shape[1])))
    return np.asarray(perm, dtype=np.int64)


def rcm_permutation(A):
    """Reverse Cuthill-McKee order of a sparse matrix's graph (SciPy on
    the CSR as ``assemble_csr`` builds it, so the order is the JAX
    package's)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(A.tocsr(),
                                            symmetric_mode=False),
                      dtype=np.int64)


def _inverse(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def _to_numpy(a):
    """Host copy of a torch tensor or any array-like (JAX arrays too)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _wrap_pad(a, e):
    """Pad the last two axes circularly by ``e`` (``jnp.pad(mode="wrap")``)."""
    if e == 0:
        return a
    a = torch.cat([a[..., -e:, :], a, a[..., :e, :]], dim=-2)
    return torch.cat([a[..., -e:], a, a[..., :e]], dim=-1)


# ---------------------------------------------------------------------------
# device formats
# ---------------------------------------------------------------------------

class CirculantBand:
    """y[i] = sum_d band[d, i] * x[(i + off_d) mod N].

    ``apply`` goes through ``cuda_band.circulant_apply``: the CUDA kernel
    for CUDA tensors, the plain torch version for CPU tensors.
    """

    def __init__(self, offsets, band: torch.Tensor):
        self.offsets = tuple(int(o) for o in offsets)
        self.band = band
        self.n = band.shape[1]

    @classmethod
    def from_numpy(cls, offsets, band, dtype, device):
        return cls(offsets, torch.tensor(np.asarray(band), dtype=dtype,
                                         device=device))

    def apply(self, x):
        """x: (..., N) -> (..., N)."""
        return cuda_band.circulant_apply(self.band, self.offsets,
                                         x.contiguous())

    def diagonal(self):
        if 0 in self.offsets:
            return self.band[self.offsets.index(0)]
        return torch.zeros(self.n, dtype=self.band.dtype,
                           device=self.band.device)

    @property
    def nbytes(self):
        return self.band.numel() * self.band.element_size()


class AffineBand:
    """Block-window band: rows in blocks of RB, window start affine in b.

    ``bandmat`` is (nblk, RB, W) with
        A[b*RB + i, start_b + w] = bandmat[b, i, w],
        start_b = b * stride - b_lo.
    Window construction is static slicing of the padded x reshaped to
    stride-wide tiles; the apply is one batched dense mat-vec.
    """

    def __init__(self, n_rows, n_cols, stride, b_lo, bandmat, dtype,
                 device):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.stride = int(stride)
        self.b_lo = int(b_lo)
        bandmat = np.asarray(bandmat)
        nblk, rb, W = bandmat.shape
        if rb != RB:
            raise ValueError(f"bandmat has {rb} rows per block, not {RB}")
        self.nblk = nblk
        s = self.stride
        self.T = -(-W // s)
        Wp = self.T * s
        if Wp != W:
            bandmat = np.concatenate(
                [bandmat, np.zeros((nblk, RB, Wp - W), bandmat.dtype)],
                axis=2)
        self.W = Wp
        self._diag_host = self._extract_diag(bandmat)
        self.bandmat = torch.tensor(bandmat, dtype=dtype, device=device)
        # padded-x length: window max = (nblk-1)*s + Wp, plus front pad b_lo
        need = self.b_lo + (self.nblk - 1) * s + Wp
        self.pad_back = max(need - self.n_cols, 0)
        total = self.b_lo + self.n_cols + self.pad_back
        self.pad_back += (-total) % s
        self.n_tiles = (self.b_lo + self.n_cols + self.pad_back) // s

    def _windows(self, x):
        """x: (..., n_cols) -> (..., nblk, W) window matrix.

        The padding is *circular* (xp[i] = x[(i - b_lo) mod N]): periodic
        wrap columns live near the window under the centered-mod offsets
        of ``build_operator``; for non-periodic operators the wrapped
        reads multiply zero band entries, so they are inert.  The windows
        are written once (the ``stack``); everything before it is a view
        of the padded copy of x.
        """
        total = self.b_lo + self.n_cols + self.pad_back
        s0 = (-self.b_lo) % self.n_cols
        reps = -(-(s0 + total) // self.n_cols)
        xp = torch.cat([x] * reps, dim=-1)[..., s0:s0 + total]
        tiles = xp.reshape(x.shape[:-1] + (self.n_tiles, self.stride))
        parts = [tiles[..., t:t + self.nblk, :] for t in range(self.T)]
        wins = torch.stack(parts, dim=-2)         # (..., nblk, T, s)
        return wins.reshape(x.shape[:-1] + (self.nblk, self.W))

    def apply(self, x):
        """x: (..., n_cols) -> (..., n_rows)."""
        lead = tuple(x.shape[:-1])
        wins = self._windows(x).reshape(-1, self.nblk, self.W)
        # (nblk, RB, W) @ (nblk, W, B) -> (nblk, RB, B)
        out = torch.bmm(self.bandmat, wins.permute(1, 2, 0))
        out = out.permute(2, 0, 1).reshape(lead + (self.nblk * RB,))
        return out[..., :self.n_rows]

    def _extract_diag(self, bandmat):
        if self.n_rows != self.n_cols:
            return None
        rows = np.arange(self.n_rows)
        b, i = rows // RB, rows % RB
        rel = (np.mod(rows - b * self.stride + self.n_cols // 2,
                      self.n_cols) - self.n_cols // 2)
        w = rel + self.b_lo
        ok = (w >= 0) & (w < self.W)
        diag = np.zeros(self.n_rows, bandmat.dtype)
        diag[ok] = bandmat[b[ok], i[ok], w[ok]]
        return diag

    def diagonal(self):
        if self._diag_host is None:
            raise ValueError("a rectangular AffineBand has no diagonal")
        return torch.tensor(self._diag_host, dtype=self.bandmat.dtype,
                            device=self.bandmat.device)

    @property
    def nbytes(self):
        return self.bandmat.numel() * self.bandmat.element_size()


class StructureError(ValueError):
    """No gather-free format fits this operator."""


def build_operator(A, dtype, device, name="", *,
                   circulant_cap=cuda_band.MAX_OFFSETS, window_cap=6144,
                   max_bytes=None):
    """Pick the device format for a (permuted) CSR matrix.

    Tries CirculantBand (offset count <= ``circulant_cap``, itself at most
    ``cuda_band.MAX_OFFSETS``, the band kernels' limit), then AffineBand
    (window width <= ``window_cap`` and band storage <= ``max_bytes``,
    default ``NS_FASTOP_MAX_BYTES`` or 1e9).  Raises ``StructureError`` if
    neither fits.
    """
    if circulant_cap > cuda_band.MAX_OFFSETS:
        raise ValueError(f"circulant_cap {circulant_cap} exceeds the band "
                         f"kernels' {cuda_band.MAX_OFFSETS} offsets")
    if max_bytes is None:
        max_bytes = float(os.environ.get("NS_FASTOP_MAX_BYTES", 1e9))
    np_dt = config.numpy_dtype(dtype)
    A = A.tocoo()
    n_rows, n_cols = A.shape
    if n_rows == n_cols:
        off = np.mod(A.col - A.row, n_cols)
        uniq = np.unique(off)
        if len(uniq) <= circulant_cap:
            idx = np.searchsorted(uniq, off)
            band = np.zeros((len(uniq), n_cols), dtype=np_dt)
            band[idx, A.row] = A.data
            return CirculantBand.from_numpy(uniq, band, dtype, device)
    # affine block-window band (centered-mod offsets: periodic wrap
    # columns fold back near the window)
    stride = max(int(round(RB * n_cols / n_rows)), 1)
    b = A.row // RB
    rel = np.mod(A.col - b * stride + n_cols // 2, n_cols) - n_cols // 2
    b_lo = int(max(-rel.min(), 0))
    W = int(rel.max() + b_lo + 1)
    if W > window_cap:
        raise StructureError(
            f"{name or 'operator'}: window {W} exceeds cap {window_cap}")
    nblk = -(-n_rows // RB)
    W_pad = -(-W // stride) * stride    # pre-pad to the stride multiple
    est = nblk * RB * W_pad * np.dtype(np_dt).itemsize
    if est > max_bytes:
        raise StructureError(
            f"{name or 'operator'}: band storage {est/1e9:.2f} GB exceeds "
            f"NS_FASTOP_MAX_BYTES={max_bytes/1e9:.2f} GB")
    bandmat = np.zeros((nblk, RB, W_pad), dtype=np_dt)
    bandmat[b, A.row % RB, rel + b_lo] = A.data
    return AffineBand(n_rows, n_cols, stride, b_lo, bandmat, dtype, device)


class GatherOp:
    """Sorted-COO rim operator.

    The rectangular couplings (gradient/divergence) apply only ~3x per
    projection step, while their *band* storage grows with the grid line
    length (O(N^1.5) in total).  Above ``NS_FASTOP_RIM_BYTES`` the engine
    stores them as plain sorted COO (``rows``, ``cols``, ``vals``)
    instead.  The apply gathers x through the row-wise padded table of
    :func:`ell_from_sorted_coo` and sums each row's products in column
    order: a scatter-add without atomics, the same bits on every run.
    """

    def __init__(self, rows, cols, vals, shape, dtype, device):
        self.n_rows, self.n_cols = (int(v) for v in shape)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals).astype(config.numpy_dtype(dtype))
        if np.any(np.diff(rows) < 0):
            raise ValueError("GatherOp rows must be sorted")
        self.rows = torch.as_tensor(rows.astype(np.int32), device=device)
        self.cols = torch.as_tensor(cols.astype(np.int32), device=device)
        self.vals = torch.as_tensor(vals, device=device)
        table, slots = ell_from_sorted_coo(rows, cols, self.n_rows,
                                           pad=self.n_cols)
        ell = np.zeros(table.size, dtype=vals.dtype)
        ell[slots] = vals
        self._cols_ell = torch.as_tensor(table, device=device)
        self._vals_ell = torch.as_tensor(ell.reshape(table.shape),
                                         device=device)

    @classmethod
    def from_scipy(cls, A, dtype, device):
        coo = A.tocoo()
        coo.sum_duplicates()
        order = np.lexsort((coo.col, coo.row))
        return cls(coo.row[order], coo.col[order], coo.data[order], A.shape,
                   dtype, device)

    def apply(self, x):
        """x: (..., n_cols) -> (..., n_rows)."""
        xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        return (self._vals_ell * xp[..., self._cols_ell]).sum(dim=-1)

    @property
    def nbytes(self):
        return (self.vals.numel() * self.vals.element_size()
                + self.rows.numel() * 8)


def build_rim_operator(A, dtype, device, name="", *,
                       circulant_cap=cuda_band.MAX_OFFSETS, window_cap=6144,
                       max_bytes=None):
    """Band format if it fits the rim budget (``NS_FASTOP_RIM_BYTES``,
    default 2.5e8), else sorted-COO gather."""
    rim_cap = float(os.environ.get("NS_FASTOP_RIM_BYTES", 2.5e8))
    if max_bytes is not None:
        rim_cap = min(rim_cap, max_bytes)
    try:
        return build_operator(A, dtype, device, name=name,
                              circulant_cap=circulant_cap,
                              window_cap=window_cap, max_bytes=rim_cap)
    except StructureError:
        return GatherOp.from_scipy(A, dtype, device)


class StencilCoupling:
    """Class-constant P2<->P1 coupling stencil on translation-class grids.

    On uniform periodic boxes the permuted P2 nodes fill a fine (Ny, Nx)
    torus grid and the P1 nodes its stride-2 coarse grid; every nonzero of
    the gradient G (Nu, Np) / divergence D (Np, Nu) coupling depends only
    on (parity phase of the fine node, coarse offset).  The apply is a few
    static slices of a wrap-padded plane plus multiply-adds.
    """

    #: (a, b) parity enumeration order for taps
    PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))

    def __init__(self, kind, fine_grid, coarse_grid, offs, weights, dtype,
                 device):
        if kind not in ("G", "D"):
            raise ValueError(f"kind must be 'G' or 'D', got {kind!r}")
        self.kind = kind
        self.fine = tuple(int(v) for v in fine_grid)
        self.coarse = tuple(int(v) for v in coarse_grid)
        # offs: 4-tuple (per phase) of ((dy, dx), ...) coarse offsets
        self.offs = tuple(tuple((int(dy), int(dx)) for dy, dx in ph)
                          for ph in offs)
        self.extent = max((max(abs(dy), abs(dx)) for ph in self.offs
                           for dy, dx in ph), default=0)
        w = np.asarray(weights).astype(config.numpy_dtype(dtype))
        self.weights = torch.as_tensor(w, device=device)
        # the taps as Python floats (exact in the storage dtype): scalar
        # multiplies need no device reads
        self._w = [float(v) for v in w]
        if kind == "G":
            self.n_rows = self.fine[0] * self.fine[1]
            self.n_cols = self.coarse[0] * self.coarse[1]
        else:
            self.n_rows = self.coarse[0] * self.coarse[1]
            self.n_cols = self.fine[0] * self.fine[1]

    def _taps(self, pad, ph, w, acc=None):
        """``acc`` plus the phase's taps, summed in tap order."""
        e = self.extent
        nyc, nxc = self.coarse
        for dy, dx in ph:
            term = self._w[w] * pad[..., e + dy:e + dy + nyc,
                                    e + dx:e + dx + nxc]
            w += 1
            acc = term if acc is None else acc + term
        return acc, w

    def apply(self, x):
        nyc, nxc = self.coarse
        lead = tuple(x.shape[:-1])
        nl = len(lead)
        e = self.extent
        if self.kind == "G":
            # coarse plane -> 4 fine parity phases
            pad = _wrap_pad(x.reshape(lead + (nyc, nxc)), e)
            phases, w = [], 0
            for ph in self.offs:
                acc, w = self._taps(pad, ph, w)
                phases.append(acc)
            ph = torch.stack(phases, dim=nl).reshape(lead + (2, 2, nyc, nxc))
            # out[..., I, a, J, b] = ph[..., a, b, I, J]
            axes = tuple(range(nl)) + (nl + 2, nl, nl + 3, nl + 1)
            return ph.permute(axes).reshape(lead + (self.n_rows,))
        # D: 4 fine parity phases -> coarse plane
        ug = x.reshape(lead + (nyc, 2, nxc, 2))
        acc, w = None, 0
        for (a, b), ph in zip(self.PHASES, self.offs):
            acc, w = self._taps(_wrap_pad(ug[..., :, a, :, b], e), ph, w,
                                acc)
        return acc.reshape(lead + (self.n_rows,))


def detect_stencil_coupling(A, kind, fine_grid, coarse_grid, dtype, device,
                            max_extent=2, tol=1e-11):
    """Exact class-constant detection of a P2<->P1 coupling matrix.

    Returns a :class:`StencilCoupling` when EVERY nonzero of ``A`` (rows
    fine for "G", rows coarse for "D") is reproduced by a per-parity-phase
    constant stencil on the torus grids -- each (phase, offset) group must
    cover every coarse anchor exactly once with value spread <= tol.
    Returns None otherwise.
    """
    Ny, Nx = fine_grid
    nyc, nxc = coarse_grid
    if nyc < 2 * max_extent + 2 or nxc < 2 * max_extent + 2:
        return None
    A = A.tocoo()
    fine_idx = A.row if kind == "G" else A.col
    coarse_idx = A.col if kind == "G" else A.row
    fy, fx = fine_idx // Nx, fine_idx % Nx
    a, b = fy % 2, fx % 2
    Jy, Jx = coarse_idx // nxc, coarse_idx % nxc
    if kind == "G":
        dy = (Jy - fy // 2) % nyc
        dx = (Jx - fx // 2) % nxc
    else:
        dy = (fy // 2 - Jy) % nyc
        dx = (fx // 2 - Jx) % nxc
    dy = np.where(dy > nyc // 2, dy - nyc, dy)
    dx = np.where(dx > nxc // 2, dx - nxc, dx)
    if abs(dy).max() > max_extent or abs(dx).max() > max_extent:
        return None
    span = 2 * max_extent + 1
    key = ((a * 2 + b) * span + (dy + max_extent)) * span \
        + (dx + max_extent)
    order = np.argsort(key, kind="stable")
    ks, vs = key[order], A.data[order]
    uk, starts = np.unique(ks, return_index=True)
    bounds = np.append(starts, len(ks))
    m = nyc * nxc
    scale = np.abs(A.data).max()
    per_phase = [[] for _ in range(4)]
    for i, k in enumerate(uk):
        grp = vs[bounds[i]:bounds[i + 1]]
        if len(grp) != m or np.ptp(grp) > tol * scale:
            return None
        ph, rem = divmod(int(k), span * span)
        dyy, dxx = divmod(rem, span)
        per_phase[ph].append(((dyy - max_extent, dxx - max_extent),
                              grp[0]))
    offs = tuple(tuple(o for o, _ in per_phase[ph]) for ph in range(4))
    weights = np.asarray([v for ph in range(4) for _, v in per_phase[ph]])
    return StencilCoupling(kind, fine_grid, coarse_grid, offs, weights,
                           dtype, device)


def combine_circulant(terms):
    """``sum_i c_i A_i`` as ONE CirculantBand.

    Coefficients may be Python floats or 0-d tensors.  Fusing the
    Helmholtz combination (a0/k) M + nu K into one band halves the band
    traffic of every velocity-CG iteration; the combine is one elementwise
    pass per step.
    """
    ops = [op for _, op in terms]
    union = sorted({o for op in ops for o in op.offsets})
    if all(op.offsets == tuple(union) for op in ops):
        band = None
        for c, op in terms:
            term = c * op.band
            band = term if band is None else band + term
    else:
        pos = {o: i for i, o in enumerate(union)}
        band = torch.zeros((len(union), ops[0].n), dtype=ops[0].band.dtype,
                           device=ops[0].band.device)
        for c, op in terms:
            idx = torch.as_tensor([pos[o] for o in op.offsets],
                                  device=band.device)
            band.index_add_(0, idx, c * op.band)
    return CirculantBand(union, band)


# ---------------------------------------------------------------------------
# Taylor-Hood operator suite (planar layout)
# ---------------------------------------------------------------------------

class StridedConv(NamedTuple):
    """Static descriptor of the gather-free (strided) convection layout.

    On uniform periodic boxes the P2 nodes form a regular half-spacing
    torus grid of shape ``grid`` and every cell is one of a few
    translation classes: its 6 nodes sit at fixed 2D offsets ``offs[c]``
    from a stride-2 anchor lattice.
    """

    grid: tuple               # (Ny, Nx) fine-grid shape, Ny*Nx = Nu
    offs: tuple               # ncls x nn x 2 nested int tuples


class PlanarOps(NamedTuple):
    """Device-side operator bundle of the planar projection step."""

    M: object                 # velocity scalar mass (band op)
    K: object                 # velocity scalar stiffness
    L: object                 # pressure stiffness
    G: tuple                  # per-dim pressure-gradient couplings
    D: tuple                  # per-dim divergence couplings
    diag_m: torch.Tensor
    diag_k: torch.Tensor
    diag_l: torch.Tensor
    conv_cu: torch.Tensor     # (nc, 6) permuted cell u-node ids
    conv_W: torch.Tensor      # (nc, nq) quadrature weights
    conv_N2: torch.Tensor     # (nq, 6)
    conv_g2: torch.Tensor     # (nc, nq, 6, d) physical shape gradients
    conv_table: torch.Tensor  # transpose-scatter table
    Mp: object = None         # pressure (P1) mass -- rotational scheme
    diag_mp: torch.Tensor = None
    conv_Wc: torch.Tensor = None   # (ncls, nq) per-class quad weights
    conv_g2c: torch.Tensor = None  # (ncls, nq, nn, d) per-class gradients
    conv_strided: StridedConv = None
    permU: torch.Tensor = None     # lex order of the velocity nodes
    permP: torch.Tensor = None     # lex order of the pressure nodes


def conv_apply(ops: PlanarOps, u, cc, strided=None):
    """Assembled convection rhs b = int(cc (u.grad)u . N), planar."""
    if strided is not None and ops.conv_Wc is not None:
        return _conv_apply_strided(ops, u, cc, strided)
    dim = u.shape[0]
    u_c = u[:, ops.conv_cu]                                  # (d, nc, 6)
    u_q = torch.einsum("qi,dci->dcq", ops.conv_N2, u_c)
    grad_u = torch.einsum("dci,cqie->dcqe", u_c, ops.conv_g2)
    adv = cc * torch.einsum("ecq,dcqe->dcq", u_q, grad_u)
    r_c = torch.einsum("cq,dcq,qi->dci", ops.conv_W, adv, ops.conv_N2)
    flat = r_c.reshape(dim, -1)
    pad = torch.zeros((dim, 1), dtype=flat.dtype, device=flat.device)
    padded = torch.cat([flat, pad], dim=1)
    return padded[:, ops.conv_table].sum(dim=2)


def _conv_apply_strided(ops: PlanarOps, u, cc, strided: StridedConv):
    """Gather-free convection on translation-class grids (StridedConv).

    The fine grid is split into its 4 half-spacing parity phases and
    cyclically padded by one coarse cell; every per-(class, node) extract
    and scatter is then a static slice of a contiguous (ny, nx) plane.
    """
    d = u.shape[0]
    Ny, Nx = strided.grid
    ny, nx = Ny // 2, Nx // 2
    ph = u.reshape(d, ny, 2, nx, 2).permute(0, 2, 4, 1, 3)
    pad = _wrap_pad(ph, 1)
    outp = torch.zeros((d, 2, 2, ny + 2, nx + 2), dtype=u.dtype,
                       device=u.device)

    def loc(dy, dx):
        py, px = dy % 2, dx % 2
        return py, px, (dy - py) // 2 + 1, (dx - px) // 2 + 1

    for c, off_c in enumerate(strided.offs):
        cols = []
        for dy, dx in off_c:
            py, px, sy, sx = loc(dy, dx)
            cols.append(pad[:, py, px, sy:sy + ny, sx:sx + nx]
                        .reshape(d, -1))
        u_c = torch.stack(cols, dim=-1)                      # (d, m, nn)
        u_q = torch.einsum("qi,dmi->dmq", ops.conv_N2, u_c)
        grad_u = torch.einsum("dmi,qie->dmqe", u_c, ops.conv_g2c[c])
        adv = cc * torch.einsum("emq,dmqe->dmq", u_q, grad_u)
        r_c = torch.einsum("q,dmq,qi->dmi", ops.conv_Wc[c], adv,
                           ops.conv_N2)
        m2 = r_c.reshape(d, ny, nx, r_c.shape[-1])
        for i, (dy, dx) in enumerate(off_c):
            py, px, sy, sx = loc(dy, dx)
            outp[:, py, px, sy:sy + ny, sx:sx + nx] += m2[..., i]
    # fold the cyclic pad ring back into the interior (rows first with
    # full columns, so corner contributions ride along)
    outp[:, :, :, ny, :] += outp[:, :, :, 0, :]
    outp[:, :, :, 1, :] += outp[:, :, :, ny + 1, :]
    outp[:, :, :, :, nx] += outp[:, :, :, :, 0]
    outp[:, :, :, :, 1] += outp[:, :, :, :, nx + 1]
    out = outp[:, :, :, 1:ny + 1, 1:nx + 1]
    return out.permute(0, 3, 1, 4, 2).reshape(d, -1)


def _torus_grids(ucoords, pcoords):
    """((Ny, Nx), (nyc, nxc)) when both node sets fill uniform row-major
    grids with the fine one exactly double; else None."""
    def dims(coords):
        key = np.round(coords / 1e-9).astype(np.int64)
        xs, ys = np.unique(key[:, 0]), np.unique(key[:, 1])
        if len(xs) * len(ys) != len(coords):
            return None
        for v in (xs, ys):
            if len(v) > 1 and np.ptp(np.diff(v)) > 1:
                return None
        return len(ys), len(xs)
    fine, coarse = dims(ucoords), dims(pcoords)
    if fine is None or coarse is None:
        return None
    if fine[0] != 2 * coarse[0] or fine[1] != 2 * coarse[1]:
        return None
    return fine, coarse


def _is_circulant(A, perm, cap):
    A = A.tocoo()
    inv = _inverse(perm)
    off = np.mod(inv[A.col] - inv[A.row], A.shape[0])
    return len(np.unique(off)) <= cap


def _early_band_guard(space, cu, Nu, dtype, circulant_cap, window_cap,
                      max_bytes):
    """Fail FAST (seconds, before any CSR assembly) when no band format
    can plausibly fit.  Samples cells under the lex permutation: if the
    sampled mod-offset count rules out the circulant format AND the
    sampled block-window lower bound overshoots the affine-band caps by
    >= 4x, raise StructureError now.
    """
    if max_bytes is None:
        max_bytes = float(os.environ.get("NS_FASTOP_MAX_BYTES", 1e9))
    ucoords, _ = node_coordinates(space)
    perm = _inverse(lex_permutation(ucoords))
    rng = np.random.default_rng(0)
    pick = rng.choice(len(cu), size=min(len(cu), 2048), replace=False)
    # interior-only samples of a non-periodic box LOOK circulant
    # (translation-invariant stencil); the boundary rows are what break
    # the format, so sample them explicitly too
    bnd = np.unique(np.asarray(
        space.mesh.facet_cell[space.mesh.exterior_facet_mask]))
    if len(bnd) > 1024:
        bnd = bnd[rng.choice(len(bnd), size=1024, replace=False)]
    sample = cu[np.unique(np.concatenate([pick, bnd]))]
    pc = perm[sample]                          # (ns, nn) permuted ids
    # the rectangular G/D couplings always have the sorted-COO rim
    # fallback, so feasibility hinges on the SQUARE velocity operators
    nn = pc.shape[1]
    offs = np.mod(pc[:, :, None] - pc[:, None, :], Nu).ravel()
    if len(np.unique(offs)) <= circulant_cap:
        return
    item = np.dtype(config.numpy_dtype(dtype)).itemsize
    nblk = -(-Nu // RB)
    rows = np.repeat(pc, nn, axis=1).ravel()
    cols = np.tile(pc, (1, nn)).ravel()
    rel = np.mod(cols - (rows // RB) * RB + Nu // 2, Nu) - Nu // 2
    W_lb = int(rel.max() - rel.min() + 1)
    est = nblk * RB * W_lb * item
    if W_lb > 4 * window_cap or est > 3 * max_bytes:
        raise StructureError(
            f"velocity-stiffness band storage lower bound "
            f"{est/1e9:.2f} GB / window {W_lb} from sampled cells "
            f"rules out the banded formats (caps "
            f"{max_bytes/1e9:.2f} GB / {window_cap}) "
            f"-- refusing before assembly")


def _detect_strided_convection(cu_p, ucoords, W, g2):
    """Classify cells into translation classes on the lex torus grid.

    Returns ``(StridedConv, Wc, g2c)`` (host f64) exactly when the
    permuted P2 nodes fill a uniform (Ny, Nx) grid, every cell's nodes sit
    at class-constant offsets from an even-parity anchor, each class's
    anchors tile the stride-2 lattice once, and the quadrature weights and
    physical gradients are class-constant; else None (gather path).
    """
    key = np.round(ucoords / 1e-9).astype(np.int64)
    xs, ys = np.unique(key[:, 0]), np.unique(key[:, 1])
    Nx, Ny = len(xs), len(ys)
    if Nx * Ny != len(ucoords) or Nx % 2 or Ny % 2:
        return None
    if (len(xs) > 1 and np.ptp(np.diff(xs)) > 1) or \
            (len(ys) > 1 and np.ptp(np.diff(ys)) > 1):
        return None
    iy, ix = cu_p // Nx, cu_p % Nx
    dy = (iy - iy[:, :1]) % Ny
    dx = (ix - ix[:, :1]) % Nx
    dy = np.where(dy > Ny // 2, dy - Ny, dy)
    dx = np.where(dx > Nx // 2, dx - Nx, dx)
    if abs(dy).max() > 2 or abs(dx).max() > 2:
        return None
    sig = np.concatenate([dy, dx, iy[:, :1] % 2, ix[:, :1] % 2], axis=1)
    classes, cls_inv = np.unique(sig, axis=0, return_inverse=True)
    cls_inv = cls_inv.reshape(-1)
    if len(classes) > 8:
        return None
    m = (Ny // 2) * (Nx // 2)
    offs, Wc, g2c = [], [], []
    for c in range(len(classes)):
        cells = np.where(cls_inv == c)[0]
        if len(cells) != m:
            return None
        if np.ptp(W[cells], axis=0).max() > 1e-12 * abs(W).max() or \
                np.ptp(g2[cells], axis=0).max() > 1e-9 * abs(g2).max():
            return None
        py, px = int(classes[c][-2]), int(classes[c][-1])
        ay, ax = iy[cells, 0] - py, ix[cells, 0] - px
        ids = (ay // 2) * (Nx // 2) + ax // 2
        if not np.array_equal(np.sort(ids), np.arange(m)):
            return None
        offs.append(tuple((int(dy[cells[0], i] + py),
                           int(dx[cells[0], i] + px))
                          for i in range(cu_p.shape[1])))
        Wc.append(W[cells[0]])
        g2c.append(g2[cells[0]])
    return (StridedConv(grid=(Ny, Nx), offs=tuple(offs)), np.asarray(Wc),
            np.asarray(g2c))


class FastTaylorHood:
    """Gather-free scalar-operator suite for a Taylor-Hood space.

    Works in permuted node numberings chosen per field (``permU``,
    ``permP``: lexicographic where that makes the square operators
    circulant, else reverse Cuthill-McKee on the velocity stiffness with
    the pressure order induced from it) and the planar velocity layout
    ``(dim, n_unodes)``.  Use ``permute_*`` /
    ``unpermute_*`` (or ``interleaved_to_planar`` /
    ``planar_to_interleaved``) at solver boundaries; keep state permuted
    across steps.  Device tensors are made on ``device`` (default: the
    card; the CPU only with ``device="cpu"``) in ``dtype`` (default:
    ``config.default_dtype(device)``).

    On structured boxes the square operators are
    circulant under the lexicographic order (``structured``), the
    couplings torus stencils on periodic boxes and rim operators
    (``AffineBand`` / ``GatherOp``) otherwise; on unstructured meshes
    every operator is an ``AffineBand`` (or a ``GatherOp`` coupling) under
    the RCM order.  3D spaces take the same path: circulant squares on
    boxes, rim couplings, and the gather convection (the torus stencils
    and ``StridedConv`` are 2D only).
    """

    @monitor.spanned("setup.engine")
    def __init__(self, space, dtype=None, device=None, *,
                 circulant_cap=cuda_band.MAX_OFFSETS, window_cap=6144,
                 max_bytes=None):
        self.space = space
        self.dim = space.dim
        self.device = device = config.require_device(device)
        self.dtype = dt = config.resolve_dtype(dtype, device)

        cu = np.asarray(space.cell_unodes)
        cp = np.asarray(space.cell_pnodes)
        Nu, Np = space.n_unodes, space.n_pnodes
        _early_band_guard(space, cu, Nu, dt, circulant_cap, window_cap,
                          max_bytes)
        em = scalar_element_matrices(space)
        M = assemble_csr(em["M2"], cu, cu, (Nu, Nu))
        K = assemble_csr(em["K2"], cu, cu, (Nu, Nu))
        L = assemble_csr(em["L1"], cp, cp, (Np, Np))
        Mp = assemble_csr(em["M1"], cp, cp, (Np, Np))
        Gs = [assemble_csr(em["G"][:, :, d, :], cu, cp, (Nu, Np))
              for d in range(self.dim)]

        ucoords, pcoords = node_coordinates(space)
        permU = lex_permutation(ucoords)
        # probe circulant structure on the stiffness pattern
        if not _is_circulant(K, permU, circulant_cap):
            permU = rcm_permutation(K)
        self.permU, self.invU = permU, _inverse(permU)
        permP = lex_permutation(pcoords)
        if not _is_circulant(L, permP, circulant_cap):
            # induce the pressure order from the velocity order (P1 nodes
            # sit on P2 vertex nodes): independent orders would make the
            # rectangular G/D windows span the whole matrix
            nn1 = cp.shape[1]
            p2u = np.full(Np, -1, dtype=np.int64)
            p2u[cp.ravel()] = cu[:, :nn1].ravel()
            if not (p2u >= 0).all():
                raise ValueError("a pressure node lies on no cell vertex")
            permP = np.argsort(self.invU[p2u], kind="stable")
        self.permP, self.invP = permP, _inverse(permP)

        def pu(A):
            return A.tocsr()[permU][:, permU]

        def pp(A):
            return A.tocsr()[permP][:, permP]

        kw = dict(dtype=dt, device=device, circulant_cap=circulant_cap,
                  window_cap=window_cap, max_bytes=max_bytes)
        self.M = build_operator(pu(M), name="mass", **kw)
        self.K = build_operator(pu(K), name="stiffness", **kw)
        self.L = build_operator(pp(L), name="pressure-stiffness", **kw)
        self.Mp = build_operator(pp(Mp), name="pressure-mass", **kw)
        self.structured = all(
            isinstance(op, CirculantBand) for op in (self.M, self.K, self.L))

        # rectangular couplings: exact class-constant stencil on
        # translation-class torus grids; else banded while cheap,
        # sorted-COO gather beyond NS_FASTOP_RIM_BYTES
        grids = _torus_grids(ucoords, pcoords) \
            if self.structured and self.dim == 2 else None
        self.G, self.D = [], []
        for d, Gd in enumerate(Gs):
            Gp = Gd.tocsr()[permU][:, permP]
            Dp = Gd.tocsr().T.tocsr()[permP][:, permU]
            g = detect_stencil_coupling(Gp, "G", *grids, dt, device) \
                if grids else None
            dd = detect_stencil_coupling(Dp, "D", *grids, dt, device) \
                if grids else None
            self.G.append(g if g is not None else build_rim_operator(
                Gp, name=f"gradient[{d}]", **kw))
            self.D.append(dd if dd is not None else build_rim_operator(
                Dp, name=f"divergence[{d}]", **kw))

        conv = self._setup_convection()
        self.ops = PlanarOps(
            M=self.M, K=self.K, L=self.L, G=tuple(self.G), D=tuple(self.D),
            diag_m=self.M.diagonal(), diag_k=self.K.diagonal(),
            diag_l=self.L.diagonal(), Mp=self.Mp,
            diag_mp=self.Mp.diagonal(), conv_strided=self.conv_strided,
            permU=torch.as_tensor(permU, device=device),
            permP=torch.as_tensor(permP, device=device), **conv)
        self._index_cache = {}

    def _setup_convection(self):
        space = self.space
        dev, np_dt = self.device, config.numpy_dtype(self.dtype)
        cu_p = self.invU[np.asarray(space.cell_unodes)]
        W = np.asarray(space.integration_weights(), dtype=np.float64)
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2, np.float64),
                       np.asarray(space.Jinv_q, np.float64))
        from navierstokes_tpu_torch.parallel.sharded import \
            build_scatter_transpose

        tab, _ = build_scatter_transpose(cu_p.astype(np.int32),
                                         space.n_unodes)

        def dev_f(a):
            return torch.as_tensor(np.asarray(a, dtype=np_dt), device=dev)

        conv = dict(conv_cu=torch.as_tensor(cu_p, device=dev),
                    conv_W=dev_f(W), conv_N2=dev_f(space.N2),
                    conv_g2=dev_f(g2),
                    conv_table=torch.as_tensor(tab.astype(np.int64),
                                               device=dev))
        # detect on the storage-dtype values, as the JAX engine does; the
        # translation classes are 2D (3D keeps the gather form)
        got = None
        if self.structured and self.dim == 2:
            got = _detect_strided_convection(
                cu_p, node_coordinates(space)[0],
                np.asarray(W.astype(np_dt), np.float64),
                np.asarray(g2.astype(np_dt), np.float64))
        self.conv_strided = None
        if got is not None:
            self.conv_strided, Wc, g2c = got
            conv.update(conv_Wc=dev_f(Wc), conv_g2c=dev_f(g2c))
        return conv

    # -- layout helpers ------------------------------------------------------
    def interleaved_to_planar(self, u_flat):
        """(n_unodes*dim,) node-major interleaved -> permuted (dim, Nu),
        on the engine's device in its dtype."""
        u2 = torch.as_tensor(u_flat, device=self.device).to(self.dtype) \
            .reshape(-1, self.dim).T
        return self.permute_velocity(u2)

    def planar_to_interleaved(self, u_planar):
        """permuted (dim, Nu) -> (n_unodes*dim,) node-major interleaved."""
        return self.unpermute_velocity(u_planar).T.reshape(-1)

    def diagonals(self):
        """(diag_M (Nu,), diag_K (Nu,), diag_L (Np,)) -- scalar per node."""
        return self.M.diagonal(), self.K.diagonal(), self.L.diagonal()

    # -- permutation helpers (node axis last) --------------------------------
    def _take(self, a, name):
        """``a[..., idx]`` for the index array ``name``, kept on each
        device it was asked for (no upload per call)."""
        key = (name, a.device)
        idx = self._index_cache.get(key)
        if idx is None:
            idx = self._index_cache[key] = torch.as_tensor(
                getattr(self, name), device=a.device)
        return a[..., idx]

    def permute_velocity(self, u_planar):
        return self._take(u_planar, "permU")

    def unpermute_velocity(self, u_planar):
        return self._take(u_planar, "invU")

    def permute_pressure(self, p):
        return self._take(p, "permP")

    def unpermute_pressure(self, p):
        return self._take(p, "invP")


# ---------------------------------------------------------------------------
# operator bundles as NumPy dicts (state carried across from either engine)
# ---------------------------------------------------------------------------

_DIAGS = ("diag_m", "diag_k", "diag_l", "diag_mp")
_CONV = ("conv_cu", "conv_W", "conv_N2", "conv_g2", "conv_table",
         "conv_Wc", "conv_g2c")


def _op_to_numpy(op) -> dict:
    """One operator of either package as a dict of NumPy arrays; the
    ``format`` key names its class."""
    name = type(op).__name__
    if name == "CirculantBand":
        return {"format": name, "offsets": np.asarray(op.offsets, np.int64),
                "band": _to_numpy(op.band)}
    if name == "StencilCoupling":
        return {"format": name, "kind": op.kind, "fine": tuple(op.fine),
                "coarse": tuple(op.coarse), "offs": op.offs,
                "weights": _to_numpy(op.weights)}
    if name == "AffineBand":
        return {"format": name, "n_rows": op.n_rows, "n_cols": op.n_cols,
                "stride": op.stride, "b_lo": op.b_lo,
                "bandmat": _to_numpy(op.bandmat)}
    if name == "GatherOp":
        return {"format": name, "shape": (op.n_rows, op.n_cols),
                "rows": _to_numpy(op.rows), "cols": _to_numpy(op.cols),
                "vals": _to_numpy(op.vals)}
    raise TypeError(f"unknown operator format {name}")


def _op_from_numpy(e: dict, dtype, device):
    fmt = e.get("format", "StencilCoupling" if "kind" in e
                else "CirculantBand")
    if fmt == "CirculantBand":
        return CirculantBand.from_numpy(e["offsets"], e["band"], dtype,
                                        device)
    if fmt == "StencilCoupling":
        return StencilCoupling(e["kind"], e["fine"], e["coarse"], e["offs"],
                               e["weights"], dtype, device)
    if fmt == "AffineBand":
        return AffineBand(e["n_rows"], e["n_cols"], e["stride"], e["b_lo"],
                          e["bandmat"], dtype, device)
    if fmt == "GatherOp":
        return GatherOp(e["rows"], e["cols"], e["vals"], e["shape"], dtype,
                        device)
    raise TypeError(f"unknown operator format {fmt}")


def planar_ops_to_numpy(fast) -> dict:
    """The operator bundle of an engine as a dict of NumPy arrays.

    ``fast`` is a FastTaylorHood of either package: only the attributes
    both share are read (``ops``, ``conv_strided``, ``permU``, ``permP``),
    and every array goes through ``numpy.asarray``.  All four formats are
    carried (circulant and affine bands, stencil and gather couplings).
    """
    ops = fast.ops
    d = {name: _op_to_numpy(getattr(ops, name))
         for name in ("M", "K", "L", "Mp")}
    d["G"] = [_op_to_numpy(op) for op in ops.G]
    d["D"] = [_op_to_numpy(op) for op in ops.D]
    for name in _DIAGS + _CONV:
        val = getattr(ops, name)
        d[name] = None if val is None else _to_numpy(val)
    cs = fast.conv_strided
    d["conv_strided"] = None if cs is None else {"grid": tuple(cs.grid),
                                                 "offs": cs.offs}
    d["permU"] = np.asarray(fast.permU, np.int64)
    d["permP"] = np.asarray(fast.permP, np.int64)
    return d


def planar_ops_from_numpy(d: dict, device=None, dtype=None) -> PlanarOps:
    """The port's PlanarOps from :func:`planar_ops_to_numpy`'s dict, on
    ``device`` (default: the card; the CPU only with ``device="cpu"``)."""
    device = config.require_device(device)
    dtype = config.resolve_dtype(dtype, device)

    def op(e):
        return _op_from_numpy(e, dtype, device)

    # torch.tensor copies: arrays read from JAX are read-only views
    def floats(a):
        return None if a is None else torch.tensor(
            np.asarray(a), dtype=dtype, device=device)

    def ints(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    cs = d["conv_strided"]
    return PlanarOps(
        M=op(d["M"]), K=op(d["K"]), L=op(d["L"]), Mp=op(d["Mp"]),
        G=tuple(op(e) for e in d["G"]), D=tuple(op(e) for e in d["D"]),
        **{name: floats(d[name]) for name in _DIAGS},
        conv_cu=ints(d["conv_cu"]), conv_table=ints(d["conv_table"]),
        conv_W=floats(d["conv_W"]), conv_N2=floats(d["conv_N2"]),
        conv_g2=floats(d["conv_g2"]), conv_Wc=floats(d["conv_Wc"]),
        conv_g2c=floats(d["conv_g2c"]),
        conv_strided=None if cs is None else StridedConv(
            grid=tuple(cs["grid"]),
            offs=tuple(tuple(tuple(o) for o in c) for c in cs["offs"])),
        permU=ints(d["permU"]), permP=ints(d["permP"]))
