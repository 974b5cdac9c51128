"""Class-grid view of a Taylor-Hood space on a structured rectangle/box mesh.

Counterpart of ``navierstokes_tpu/structured/grid.py``: host-side NumPy,
the same operations in the same order, so every table equals the JAX
package's.  On the uniform right-diagonal triangulation produced by
``mesh.generators.hyper_rectangle`` the P2/P1 nodes fall into translation-invariant *classes* on the cell
lattice:

  * velocity (P2), 2D: 4 classes -- vertices, x-edge midpoints, y-edge
    midpoints, diagonal midpoints -- each an (nx, ny) grid (periodic case);
  * velocity (P2), 3D (Kuhn 6-tet subdivision): 8 classes -- vertices,
    3 axis-edge midpoints, 3 face-diagonal midpoints, body-diagonal
    midpoints -- each an (nx, ny, nz) grid;
  * pressure (P1): 1 class (the vertices).

Every FEM operator with constant coefficients is then block-circulant over
the cell lattice: operator application is a fixed *stencil* (a handful of
``torch.roll`` shifts and multiply-adds, no gathers), and, for fully periodic meshes, the operator is exactly block-diagonalized
by the n-D DFT (2^dim x 2^dim complex blocks per Fourier mode), so the
linear solves of the projection scheme become exact direct solves at FFT
cost.

The flat <-> grid transforms take NumPy arrays or torch tensors; the
torch branches index with ``int64`` copies of the rank tables, made once
per device.
"""

from __future__ import annotations

import numpy as np
import torch

_DEC = 9  # coordinate comparison decimals


class NotStructured(ValueError):
    """The space is not a structured class-grid candidate."""


def class_parity(dim):
    """(2^dim, dim) parity table; class c has parity bit a = (c >> a) & 1."""
    c = np.arange(2 ** dim)
    return np.stack([(c >> a) & 1 for a in range(dim)], axis=1)


class PeriodicStructuredTH:
    """Fully-periodic structured Taylor-Hood space as class grids.

    Builds (host-side, once):
      * ``u_rank[c, *g]`` / ``p_rank[*g]``: node rank of class ``c`` at
        cell position ``g`` -- the bijection between flat dof vectors and
        class-grid tensors;
      * per-simplex-type local-node tables
        ``u_shift[tau, l] -> (class, *shift)`` and ``p_shift[tau, l]``
        (cell-lattice shifts);
      * per-type element matrices M/K/G/L (uniform geometry).

    ``self.shape`` is the cell lattice (nx, ny[, nz]); ``self.nx/ny`` are
    kept for 2D callers.
    """

    def __init__(self, space):
        self.space = space
        mesh = space.mesh
        dim = mesh.dim
        if dim not in (2, 3):
            raise NotStructured("only 2D/3D structured grids supported")
        if len(space.periodic) < dim:
            raise NotStructured("space is not periodic in every axis")
        self.dim = dim
        self.n_uclass = 2 ** dim
        self.n_local_u = (dim + 1) + (dim * (dim + 1)) // 2  # 6 / 10
        self.n_local_p = dim + 1
        self.n_tau = 2 if dim == 2 else 6
        self.parity = class_parity(dim)

        uc = space.u_coords
        # fine lattice spacing from the distinct master coordinates per axis
        axes = [np.unique(np.round(uc[:, a], _DEC)) for a in range(dim)]
        h2 = []
        for vals in axes:
            dv = np.diff(vals)
            if len(vals) < 2 or not np.allclose(dv, dv[0], rtol=1e-6):
                raise NotStructured("points are not on a uniform lattice")
            h2.append(dv[0])
        self.h = 2.0 * np.asarray(h2)
        shape = tuple(len(vals) // 2 for vals in axes)
        if any(len(axes[a]) != 2 * shape[a] for a in range(dim)) \
                or space.n_unodes != self.n_uclass * int(np.prod(shape)) \
                or space.n_pnodes != int(np.prod(shape)):
            raise NotStructured("node counts do not match a fully periodic "
                                "structured mesh")
        self.shape = shape
        if dim == 2:
            self.nx, self.ny = shape
            self.hx, self.hy = self.h
        self.origin = np.array([vals[0] for vals in axes])

        fine_u = self._fine_indices(uc)                   # (n_unodes, dim)
        cls = np.zeros(len(fine_u), dtype=np.int64)
        for a in range(dim):
            cls |= (fine_u[:, a] % 2) << a
        g = fine_u // 2
        self.u_rank = np.full((self.n_uclass,) + shape, -1, dtype=np.int32)
        self.u_rank[(cls,) + tuple(g.T)] = np.arange(space.n_unodes,
                                                     dtype=np.int32)
        if (self.u_rank < 0).any():
            raise NotStructured("velocity nodes do not tile the class grids")

        fine_p = self._fine_indices(space.p_coords)
        if (fine_p % 2).any():
            raise NotStructured("pressure nodes off the vertex lattice")
        self.p_rank = np.full(shape, -1, dtype=np.int32)
        self.p_rank[tuple((fine_p // 2).T)] = np.arange(space.n_pnodes,
                                                        dtype=np.int32)
        if (self.p_rank < 0).any():
            raise NotStructured("pressure nodes do not tile the grid")

        self._build_cell_tables(fine_u, fine_p)
        self._build_element_matrices()
        self._rank_tensors = {}

    # -- host-side construction ----------------------------------------------
    def _fine_indices(self, coords):
        f = (coords - self.origin) / (self.h / 2)
        fi = np.round(f).astype(np.int64)
        if not np.allclose(f, fi, atol=1e-6):
            raise NotStructured("node off the fine lattice")
        return fi % (2 * np.asarray(self.shape))

    def _build_cell_tables(self, fine_u, fine_p):
        """Group cells into congruent simplex types and extract the
        translation-invariant local-node shift tables."""
        space, shape = self.space, np.asarray(self.shape)
        dim = self.dim
        n2 = 2 * shape
        fu = fine_u[space.cell_unodes]                   # (nc, nlu, dim)
        fp = fine_p[space.cell_pnodes]                   # (nc, nlp, dim)

        # cell anchor: the main-diagonal midpoint node (all-odd parity)
        # sits at fine (2g + 1) of cell g for EVERY simplex type (the 2D
        # diagonal / the 3D Kuhn body diagonal is shared by all cells of
        # a lattice site)
        is_diag = (fu % 2 == 1).all(axis=2)
        if not (is_diag.sum(axis=1) == 1).all():
            raise NotStructured("cells lack a unique diagonal midpoint")
        diag = fu[is_diag]                                # (nc, dim)
        base = (diag - 1) % n2                            # fine coords of v00

        offu = (fu - base[:, None, :]) % n2               # in {0, 1, 2}
        offp = (fp - base[:, None, :]) % n2
        if offu.max() > 2 or offp.max() > 2:
            raise NotStructured("cell touches non-adjacent lattice sites")

        # signature -> simplex type
        sig = np.concatenate([offu.reshape(len(offu), -1),
                              offp.reshape(len(offp), -1)], axis=1)
        tau, n_classes = _rank_rows(sig)
        if n_classes != self.n_tau:
            raise NotStructured(f"{n_classes} cell congruence classes "
                                f"(expected {self.n_tau})")
        self.cell_tau = tau.astype(np.int32)
        self.cell_base = (base // 2).astype(np.int32)     # cell lattice pos

        # local-node tables per tau: class + cell-lattice shift
        def u_table(off):                                 # (nlu, dim) fine
            cls = np.zeros(len(off), dtype=np.int64)
            for a in range(dim):
                cls |= (off[:, a] % 2) << a
            par = self.parity[cls]
            shift = (off - par) // 2
            return cls.astype(np.int32), shift.astype(np.int32)

        rep = [np.nonzero(tau == t)[0][0] for t in range(self.n_tau)]
        self.u_class = np.stack([u_table(offu[r])[0] for r in rep])
        self.u_shift = np.stack([u_table(offu[r])[1] for r in rep])
        self.p_shift = np.stack([(offp[r] // 2).astype(np.int32)
                                 for r in rep])

    def _build_element_matrices(self):
        """Per-simplex-type element matrices (uniform geometry)."""
        space = self.space
        rep = [np.nonzero(self.cell_tau == t)[0][0]
               for t in range(self.n_tau)]
        W = space.integration_weights()
        for t, r in enumerate(rep):
            same = np.nonzero(self.cell_tau == t)[0]
            if not np.allclose(space.Jinv[same], space.Jinv[r], atol=1e-9):
                raise NotStructured("non-uniform cell geometry")

        Wt = W[rep]                                       # (ntau, nq)
        Jinv = space.Jinv[rep]                            # (ntau, dim, dim)
        g2 = np.einsum("qia,tae->tqie", space.G2, Jinv)
        g1 = np.einsum("qja,tae->tqje", space.G1, Jinv)
        self.W_tau = Wt
        self.Jinv_tau = Jinv
        self.M_tau = np.einsum("tq,qi,qj->tij", Wt, space.N2, space.N2)
        self.K_tau = np.einsum("tq,tqie,tqje->tij", Wt, g2, g2)
        # G[t, i, d, j] = -int N1_j dN2_i/dx_d
        self.G_tau = -np.einsum("tq,qj,tqid->tidj", Wt, space.N1, g2)
        self.L_tau = np.einsum("tq,tqje,tqke->tjk", Wt, g1, g1)

    # -- stencil (tap) extraction -------------------------------------------
    def taps_uu(self, A_tau):
        """Assembled stencil of a P2->P2 operator given (ntau, nlu, nlu)
        element matrices: dict (c_out, c_in) -> list of (shift, weight)."""
        taps = {}
        for t in range(self.n_tau):
            for lo in range(self.n_local_u):
                co = self.u_class[t, lo]
                for li in range(self.n_local_u):
                    ci = self.u_class[t, li]
                    s = tuple(self.u_shift[t, li] - self.u_shift[t, lo])
                    key = (int(co), int(ci))
                    taps.setdefault(key, {})
                    taps[key][s] = taps[key].get(s, 0.0) + A_tau[t, lo, li]
        return _prune(taps)

    def taps_up(self, A_tau):
        """P1 -> P2 coupling taps from (ntau, nlu, ..., nlp) element
        tensors (the trailing axes between local indices are carried
        through -- e.g. the gradient's direction axis)."""
        taps = {}
        for t in range(self.n_tau):
            for lo in range(self.n_local_u):
                co = self.u_class[t, lo]
                for li in range(self.n_local_p):
                    s = tuple(self.p_shift[t, li] - self.u_shift[t, lo])
                    key = (int(co), 0)
                    taps.setdefault(key, {})
                    w = A_tau[t, lo, ..., li]
                    taps[key][s] = taps[key].get(s, 0.0) + w
        return _prune(taps)

    def taps_pu(self, A_tau):
        """P2 -> P1 taps from (ntau, nlu, ..., nlp) tensors read
        transposed."""
        taps = {}
        for t in range(self.n_tau):
            for lo in range(self.n_local_p):
                for li in range(self.n_local_u):
                    ci = self.u_class[t, li]
                    s = tuple(self.u_shift[t, li] - self.p_shift[t, lo])
                    key = (0, int(ci))
                    taps.setdefault(key, {})
                    w = A_tau[t, li, ..., lo]
                    taps[key][s] = taps[key].get(s, 0.0) + w
        return _prune(taps)

    def taps_pp(self, A_tau):
        """P1 -> P1 taps from (ntau, nlp, nlp) element matrices."""
        taps = {}
        for t in range(self.n_tau):
            for lo in range(self.n_local_p):
                for li in range(self.n_local_p):
                    s = tuple(self.p_shift[t, li] - self.p_shift[t, lo])
                    key = (0, 0)
                    taps.setdefault(key, {})
                    taps[key][s] = taps[key].get(s, 0.0) + A_tau[t, lo, li]
        return _prune(taps)

    # -- flat <-> grid transforms -------------------------------------------
    def _ranks(self, device):
        """(u_rank, p_rank) as int64 tensors on ``device``, made once."""
        key = str(device)
        if key not in self._rank_tensors:
            self._rank_tensors[key] = (
                torch.as_tensor(self.u_rank, dtype=torch.int64,
                                device=device),
                torch.as_tensor(self.p_rank, dtype=torch.int64,
                                device=device))
        return self._rank_tensors[key]

    def u_to_grids(self, u_flat):
        """(n_unodes*d,) -> (2^dim, *shape, d) class grids."""
        d = self.space.dim
        u = u_flat.reshape(self.space.n_unodes, d)
        if isinstance(u, np.ndarray):
            return u[self.u_rank]
        return u[self._ranks(u.device)[0]]

    def grids_to_u(self, U):
        d = self.space.dim
        if isinstance(U, np.ndarray):
            out = np.empty((self.space.n_unodes, d), dtype=U.dtype)
            out[self.u_rank] = U
            return out.reshape(-1)
        out = torch.empty((self.space.n_unodes, d), dtype=U.dtype,
                          device=U.device)
        out[self._ranks(U.device)[0]] = U
        return out.reshape(-1)

    def p_to_grid(self, p_flat):
        if isinstance(p_flat, np.ndarray):
            return p_flat[self.p_rank]
        return p_flat[self._ranks(p_flat.device)[1]]

    def grid_to_p(self, P):
        if isinstance(P, np.ndarray):
            out = np.empty(self.space.n_pnodes, dtype=P.dtype)
            out[self.p_rank] = P
            return out
        out = torch.empty(self.space.n_pnodes, dtype=P.dtype,
                          device=P.device)
        out[self._ranks(P.device)[1]] = P
        return out


def _rank_rows(sig, base=3, digits=30):
    """``(inverse, n_unique)`` of ``np.unique(sig, axis=0,
    return_inverse=True)`` for rows of ints in [0, base).

    ``digits`` columns at a time are packed into one int64 key on top of
    the rank of the columns before them, so every sort is over plain
    integers; the final rank orders the rows lexicographically, as
    ``np.unique`` over rows does, at a fraction of its cost."""
    rank = np.zeros(len(sig), dtype=np.int64)
    for j0 in range(0, sig.shape[1], digits):
        if int(rank.max(initial=0)) >= 2 ** 62 // base ** digits:
            raise NotStructured("too many cell congruence classes")
        key = rank
        for col in sig[:, j0:j0 + digits].T:
            key = key * base + col
        _, rank = np.unique(key, return_inverse=True)
    return rank.reshape(-1), int(rank.max(initial=-1)) + 1


def _prune(taps, tol=1e-14):
    """Drop numerically-zero taps; convert to {key: [(shift, w), ...]}."""
    out = {}
    for key, entries in taps.items():
        kept = [(s, w) for s, w in entries.items()
                if np.max(np.abs(w)) > tol]
        if kept:
            out[key] = kept
    return out
