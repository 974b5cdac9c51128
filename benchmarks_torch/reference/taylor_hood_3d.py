"""Plain PyTorch reference of the benchmark's flow step on the periodic
unit cube.

Taylor-Hood P2/P1 finite elements on the unit cube cut into n x n x n
cubes, each split into six tetrahedra around its (0, 0, 0)-(1, 1, 1)
diagonal (Kuhn's split: corner (di, dj, dk) is corner number 4 di + 2 dj +
dk, and the tetrahedra are (0, 4, 6, 7), (0, 4, 5, 7), (0, 2, 6, 7),
(0, 2, 3, 7), (0, 1, 5, 7), (0, 1, 3, 7)), periodic on all three axes;
the semi-implicit SBDF-2 incremental pressure-correction step of
``reference/taylor_hood.py``: explicit extrapolated convection, a velocity
Helmholtz solve, a mean-free pressure Poisson solve for the increment phi,
a velocity-mass correction, and p <- p + phi with the nodal mean removed.

Written from the method alone: it imports nothing of the program under
test and takes no table, operator or weight that the program built.  Its
nodes are numbered on the half-spacing lattice, ``index = (a * N + b) * N
+ c`` for the P2 node at (a, b, c) * h / 2 (N = 2n per axis) and ``(i *
n + j) * n + k`` for the vertex at (i, j, k) * h.  Every cube is split
alike, so the mesh has six shapes of tetrahedron and nothing is tabulated
per cell: a P2 node's row of an operator depends only on its class (the
parities of a, b and c), and is read off the six element matrices; the
convection gathers and scatters each local node of a shape as one strided
view of the lattice.  Integrals are exact (a degree-5 rule on affine
tetrahedra: mass, stiffness, couplings and the convection form are
polynomials of degree at most 5).  Operators are padded row tables (ELL,
``reference/taylor_hood.Ell``), so every product runs in any floating
dtype, bfloat16 included.

A sub-solve is ``("exact",)``: Jacobi-preconditioned CG to a relative
residual of 1e-13, for the velocity systems from the warm start and for
the pressure with the mean removed from the residual after each update,
which gives the mean-free solution (a dense inverse of the Laplacian, as
the square's reference takes, would need 98 GB at 48^3).
"""

from __future__ import annotations

import torch

from reference.taylor_hood import BDF2, Ell, _inv, pcg

# A fully symmetric 14-point rule on the tetrahedron, exact for every
# polynomial of degree 5 (the rule of Walkington, "Quadrature on simplices
# of arbitrary dimension", 2000): the orbits (a, a, a, 1 - 3a) of two
# points a and (b, b, 1/2 - b, 1/2 - b) of one, weights summing to one.
# The parameters were solved anew from the six degree-5 moment equations
# to double precision; tests/test_torch_tgv3d.py integrates every monomial
# of degree 5 or less with them.
_A1, _W1 = 0.09273525031089107, 0.0734930431163616
_A2, _W2 = 0.3108859192633004, 0.11268792571801468
_B3, _W3 = 0.4544962958743493, 0.04254602077708251


def _orbits():
    points, weights = [], []
    for a, w in ((_A1, _W1), (_A2, _W2)):
        for i in range(4):
            lam = [a] * 4
            lam[i] = 1.0 - 3.0 * a
            points.append(lam)
            weights.append(w)
    for i in range(4):
        for j in range(i + 1, 4):
            lam = [0.5 - _B3] * 4
            lam[i] = lam[j] = _B3
            points.append(lam)
            weights.append(_W3)
    return points, weights


QUAD_BARY, QUAD_W = _orbits()

# the cube's corners, numbered 4 di + 2 dj + dk, and its six tetrahedra
CORNERS = tuple((c >> 2 & 1, c >> 1 & 1, c & 1) for c in range(8))
TETS = ((0, 4, 6, 7), (0, 4, 5, 7), (0, 2, 6, 7), (0, 2, 3, 7),
        (0, 1, 5, 7), (0, 1, 3, 7))
# P2 local nodes: the four vertices, then the midpoints of the six edges
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _element(verts, h):
    """Exact element matrices and quadrature tables of one tetrahedron
    with vertex offsets ``verts`` (in cells) on a grid of spacing ``h``."""
    f64 = torch.float64
    X = torch.tensor(verts, dtype=f64) * h                       # (4, 3)
    B = (X[1:] - X[0]).T                                         # (3, 3)
    Binv = torch.linalg.inv(B)
    g = torch.cat([-Binv.sum(dim=0)[None], Binv], dim=0)        # (4, 3)
    vol = abs(float(torch.linalg.det(B))) / 6.0
    lam = torch.tensor(QUAD_BARY, dtype=f64)                    # (14, 4)
    w = torch.tensor(QUAD_W, dtype=f64) * vol                   # (14,)
    phi = torch.cat([lam * (2 * lam - 1)] +
                    [4 * lam[:, a:a + 1] * lam[:, b:b + 1] for a, b in EDGES],
                    dim=1)                                       # (14, 10)
    dphi = torch.cat(
        [((4 * lam - 1)[:, :, None] * g[None])] +
        [4 * (lam[:, a, None, None] * g[None, None, b]
              + lam[:, b, None, None] * g[None, None, a]) for a, b in EDGES],
        dim=1)                                                   # (14, 10, 3)
    return {
        "M2": torch.einsum("q,qi,qj->ij", w, phi, phi),
        "K2": torch.einsum("q,qie,qje->ij", w, dphi, dphi),
        "L1": vol * g @ g.T,
        # G[i, d, j] = -int psi_j d(phi_i)/dx_d
        "G": -torch.einsum("q,qj,qid->idj", w, lam, dphi),
        "phi": phi, "dphi": dphi, "w": w,
    }


def _local_offsets(tet):
    """Half-spacing lattice offsets of a tetrahedron's ten P2 nodes from
    its cube's (0, 0, 0) corner: twice the corners, then the sums of the
    edges' two corners."""
    corners = [CORNERS[c] for c in tet]
    out = [tuple(2 * x for x in c) for c in corners]
    out += [tuple(x + y for x, y in zip(corners[a], corners[b]))
            for a, b in EDGES]
    return out


class Lattice:
    """The node numbering of the periodic n x n x n unit cube."""

    def __init__(self, n):
        if n < 3:
            raise ValueError("the periodic cube needs n >= 3, so that no "
                             "row of an operator wraps onto itself")
        self.n = n
        self.N = 2 * n                  # P2 nodes per axis
        self.n1 = n                     # P1 nodes per axis
        self.nu, self.np = self.N ** 3, self.n1 ** 3

    def _fine(self, a, b, c):
        N = self.N
        return ((a % N) * N + b % N) * N + c % N

    def _coarse(self, i, j, k):
        n = self.n1
        return ((i % n) * n + j % n) * n + k % n

    def u_index(self, coords):
        """Indices of the P2 nodes at ``coords`` ((m, 3), numpy or
        torch)."""
        c = torch.round(torch.as_tensor(coords, dtype=torch.float64)
                        * self.N).long()
        return self._fine(c[:, 0], c[:, 1], c[:, 2])

    def p_index(self, coords):
        """Indices of the P1 nodes at ``coords``."""
        c = torch.round(torch.as_tensor(coords, dtype=torch.float64)
                        * self.n1).long()
        return self._coarse(c[:, 0], c[:, 1], c[:, 2])

    def u_coords(self):
        """(nu, 3) coordinates of the P2 nodes in index order."""
        a = torch.arange(self.N, dtype=torch.float64) / self.N
        return torch.stack(torch.meshgrid(a, a, a, indexing="ij"),
                           dim=-1).reshape(-1, 3)


def _stencil_ell(stencils, row_step, n_rows_axis, col_step, n_cols_axis):
    """An ELL operator on the periodic lattice from its rows' stencils.

    ``stencils`` maps a row class (a parity triple, or (0, 0, 0) alone) to
    ``{offset: weight}``: the row at ``row_step * base + class`` has the
    weight at column ``col_step * base + offset`` (per axis, periodic).
    The rows and columns are numbered lexicographically on lattices of
    ``n_rows_axis`` and ``n_cols_axis`` nodes per axis."""
    nb = n_rows_axis // row_step         # bases per axis
    width = max(len(s) for s in stencils.values())
    rows = n_rows_axis ** 3
    cols = torch.zeros((rows, width), dtype=torch.long)
    vals = torch.zeros((rows, width), dtype=torch.float64)
    base = torch.arange(nb)
    I, J, K = (t.reshape(-1) for t in torch.meshgrid(base, base, base,
                                                     indexing="ij"))
    for cls, stencil in stencils.items():
        r = [row_step * B + c for B, c in zip((I, J, K), cls)]
        row = (r[0] * n_rows_axis + r[1]) * n_rows_axis + r[2]
        for slot, (off, weight) in enumerate(sorted(stencil.items())):
            c = [(col_step * B + o) % n_cols_axis
                 for B, o in zip((I, J, K), off)]
            cols[row, slot] = (c[0] * n_cols_axis + c[1]) * n_cols_axis + c[2]
            vals[row, slot] = weight
    out = Ell.__new__(Ell)
    out.cols, out.vals = cols, vals
    out.shape = (rows, n_cols_axis ** 3)
    return out


def _add(stencil, offset, weight):
    stencil[offset] = stencil.get(offset, 0.0) + float(weight)


class Grid(Lattice):
    """P2/P1 Taylor-Hood operators on the periodic n^3 unit cube (f64,
    host)."""

    def __init__(self, n):
        super().__init__(n)
        h = 1.0 / n
        self.elements = [_element([CORNERS[c] for c in tet], h)
                         for tet in TETS]
        self.offsets = [_local_offsets(tet) for tet in TETS]
        uu = {"M2": {}, "K2": {}}
        up = [{} for _ in range(3)]      # gradient rows, per axis
        pu = [{} for _ in range(3)]      # divergence rows, per axis
        pp = {}
        for el, offs, tet in zip(self.elements, self.offsets, TETS):
            corners = [CORNERS[c] for c in tet]
            for i, oi in enumerate(offs):
                cls = tuple(x % 2 for x in oi)
                # the row node at 2 base + cls is node i of the
                # tetrahedron in the cube at base + (cls - oi) / 2
                for name in uu:
                    s = uu[name].setdefault(cls, {})
                    for j, oj in enumerate(offs):
                        _add(s, tuple(c + b - a
                                      for c, a, b in zip(cls, oi, oj)),
                             el[name][i, j])
                for d in range(3):
                    s = up[d].setdefault(cls, {})
                    for j, cj in enumerate(corners):
                        _add(s, tuple((c - o) // 2 + x
                                      for c, o, x in zip(cls, oi, cj)),
                             el["G"][i, d, j])
            for j, cj in enumerate(corners):
                for k, ck in enumerate(corners):
                    _add(pp, tuple(b - a for a, b in zip(cj, ck)),
                         el["L1"][j, k])
                for d in range(3):
                    for i, oi in enumerate(offs):
                        _add(pu[d], tuple(o - 2 * x for o, x in zip(oi, cj)),
                             el["G"][i, d, j])
        N, n1 = self.N, self.n1
        self.M = _stencil_ell(uu["M2"], 2, N, 2, N)
        self.K = _stencil_ell(uu["K2"], 2, N, 2, N)
        self.L = _stencil_ell({(0, 0, 0): pp}, 1, n1, 1, n1)
        self.G = [_stencil_ell(up[d], 2, N, 1, n1) for d in range(3)]
        self.D = [_stencil_ell({(0, 0, 0): pu[d]}, 1, n1, 2, N)
                  for d in range(3)]


class ReferenceStep:
    """``(u, p, phi) = step(u, u_old, p, phi)``: one SBDF-2 step.

    ``u`` is (3, nu), ``p`` and ``phi`` (np,), in the grid's numbering and
    in ``dtype``.  ``solves`` maps helmholtz / poisson / mass to
    ``("exact",)``, the only kind this reference takes."""

    EXACT_TOL = 1e-13
    EXACT_MAX_ITERS = 400
    POISSON_MAX_ITERS = 4000

    def __init__(self, grid, *, visc, dt, solves, dtype=torch.float64,
                 device="cpu"):
        kinds = {tuple(v) for v in dict(solves).values()}
        if kinds != {("exact",)}:
            raise ValueError(f"the 3D reference solves exactly only, got "
                             f"{solves}")
        self.grid, self.visc, self.dt = grid, float(visc), float(dt)
        self.dtype = dtype

        def dev(op):
            return op.to(dtype, device)

        self.M, self.K, self.L = dev(grid.M), dev(grid.K), dev(grid.L)
        self.G = [dev(op) for op in grid.G]
        self.D = [dev(op) for op in grid.D]
        self.diag_m, self.diag_k = self.M.diagonal(), self.K.diagonal()
        self.inv_diag_l = _inv(self.L.diagonal())
        self._helm = {}
        self.conv = [{k: el[k].to(device=device, dtype=dtype)
                      for k in ("phi", "dphi", "w")} for el in grid.elements]

    def _lattice(self, v):
        """(3, nu) -> (3, n, 2, n, 2, n, 2): the node at a = 2 i + p on
        each axis as [i, p]."""
        n = self.grid.n
        return v.reshape(3, n, 2, n, 2, n, 2)

    def convection(self, u):
        """int ((u . grad) u) . phi_i for every P2 node, (3, nu)."""
        lat = self._lattice(u)
        out = torch.zeros_like(u)
        acc = self._lattice(out)
        for tab, offs in zip(self.conv, self.grid.offsets):
            # local node j of the cube at i is lattice node 2 i + o_j
            uc = torch.stack([
                torch.roll(lat[:, :, o[0] % 2, :, o[1] % 2, :, o[2] % 2],
                           shifts=tuple(-(x // 2) for x in o),
                           dims=(1, 2, 3)).reshape(3, -1)
                for o in offs], dim=-1)                         # (3, c, 10)
            uq = torch.einsum("dci,qi->dcq", uc, tab["phi"])
            grad = torch.einsum("dci,qie->dcqe", uc, tab["dphi"])
            adv = torch.einsum("ecq,dcqe->dcq", uq, grad)
            r = torch.einsum("dcq,q,qi->dci", adv, tab["w"], tab["phi"])
            n = self.grid.n
            for j, o in enumerate(offs):
                acc[:, :, o[0] % 2, :, o[1] % 2, :, o[2] % 2] += torch.roll(
                    r[..., j].reshape(3, n, n, n),
                    shifts=tuple(x // 2 for x in o), dims=(1, 2, 3))
        return out

    def grad(self, q):
        return torch.stack([G(q) for G in self.G], dim=0)

    def div(self, v):
        return self.D[0](v[0]) + self.D[1](v[1]) + self.D[2](v[2])

    def _velocity_solve(self, A, diag, b, x0):
        # an iteration applies a 65-wide table to three components, so the
        # residual is read after each one
        return pcg(A, b, x0, self.EXACT_MAX_ITERS, _inv(diag),
                   tol=self.EXACT_TOL, check_every=1)

    def __call__(self, u, u_old, p, phi, alpha=BDF2[0], eta=BDF2[1]):
        a0, a1, a2 = alpha
        k, visc = self.dt, self.visc
        M = self.M

        if a0 / k not in self._helm:
            # M and K are built on the same stencils (Grid), so one
            # column table holds both
            H = Ell.__new__(Ell)
            H.cols, H.shape = M.cols, M.shape
            H.vals = (a0 / k) * M.vals + visc * self.K.vals
            self._helm[a0 / k] = H
        helm = self._helm[a0 / k]

        def mean_free(r):
            return r - r.mean()

        u_ext = eta[0] * u + eta[1] * u_old
        b = (-(a1 / k) * M(u) - (a2 / k) * M(u_old)
             - self.convection(u_ext) - self.grad(p))
        u_star = self._velocity_solve(
            helm, (a0 / k) * self.diag_m + visc * self.diag_k, b, u)

        rhs = mean_free((a0 / k) * self.div(u_star))
        phi_new = pcg(self.L, rhs, mean_free(phi), self.POISSON_MAX_ITERS,
                      self.inv_diag_l, project=mean_free, tol=self.EXACT_TOL)

        b_corr = M(u_star) - (k / a0) * self.grad(phi_new)
        u_new = self._velocity_solve(M, self.diag_m, b_corr, u_star)
        p_new = p + phi_new
        return u_new, p_new - p_new.mean(), phi_new

    def run(self, state, n_steps):
        """``n_steps`` BDF-2 steps from ``state = (u, u_old, p, phi)``
        (cast to the step's dtype); returns the final state."""
        u, u_old, p, phi = (t.to(self.dtype) for t in state)
        for _ in range(int(n_steps)):
            u_new, p, phi = self(u, u_old, p, phi)
            u_old, u = u, u_new
        return u, u_old, p, phi
