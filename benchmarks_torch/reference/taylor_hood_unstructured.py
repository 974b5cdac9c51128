"""Plain PyTorch reference of the benchmark's flow step on an unstructured
triangle mesh with curved boundary cells.

Taylor-Hood P2/P1 finite elements on a triangulation given as data: the
vertices, the triangles, the position of every P2 node of every cell and
the boundary's edges with their markers.  A mid-edge node of a boundary
edge on a curve sits on the curve, so the cell's geometry is its
quadratic (isoparametric) map x(xi) = sum_i X_i phi_i(xi) from the
reference triangle, with a Jacobian that varies over the cell.  The step
is the semi-implicit SBDF-2 incremental pressure correction of
``reference/taylor_hood.py`` with Dirichlet data on both fields:
explicit extrapolated convection, a velocity Helmholtz solve with the
velocity Dirichlet rows held, a pressure Poisson solve for the increment
phi with phi = 0 on the pressure Dirichlet nodes, a velocity-mass
correction, and p <- p + phi.

Written from the method alone: it imports nothing of the program under
test and takes no table, operator or weight that the program built; the
mesh is its input.  Its P1 nodes are the vertices in the given order; its
P2 nodes the vertices and then one node per edge, the edges numbered by
their sorted vertex pairs.  Operators are padded row tables (ELL,
``reference/taylor_hood.Ell``), so every product runs in any floating
dtype, bfloat16 included.

Quadrature: the conical product of Gauss-Jacobi (weight 1 - t) and
Gauss-Legendre rules of four points each, 16 points exact to degree 7,
their points and weights computed here from the three-term recurrences
(Golub-Welsch).  On a straight cell the mass (degree 4), the stiffness
(2), the couplings (3) and the convection (5) are then exact, and on a
curved cell the mass (6) and the couplings (3: the gradient times det J is
a polynomial) too; there the stiffness and the convection hold 1 / det J
and no rule is exact.  Departure from the method alone: the rule is of
the program's family and order (its points agree with the program's to
2.2e-16), so that the comparison reads roundoff and not the difference
of two rules on those cells (a 100-point rule moves their stiffness by
2.3e-11 of its largest entry at resolution 1, 4.4e-14 at resolution 3).

A sub-solve is ``("jacobi", iters)`` -- Jacobi-preconditioned CG with a
fixed iteration count from the warm start, the masked rows zeroed after
each update --, or ``("exact",)``: Jacobi-PCG to a relative residual of
1e-13 for the velocity systems, and for the pressure the inverse of the
masked Laplacian P L P + (I - P) (P the free nodes), from its Cholesky
factor, made once in float64.  Departure from the program: its Poisson
solve is 40 AMG-preconditioned CG iterations (run in float64, the
program's pressure then departs from this one's by 2.5e-11 of its change
over a 50-step block at resolution 3); the reference's is exact.

The nodal reaction (:func:`reaction_force`) is the momentum residual of
the monolithic system, summed over a boundary's velocity nodes and
negated, with the acceleration of the two velocity levels a state holds
(backward Euler).  Departure from the program, whose force takes the
SBDF-2 acceleration of three levels: the third is not in the state.
"""

from __future__ import annotations

import torch

from reference.taylor_hood import BDF2, Ell, _inv, pcg

F64 = torch.float64
# P2 local nodes: the vertices, then the mid-edge nodes of edges 01, 12, 02
EDGES = ((0, 1), (1, 2), (0, 2))
QUAD_POINTS_PER_AXIS = 4


def _golub_welsch(diag, off, mu0):
    """Nodes and weights of the Gauss rule of the recurrence with
    diagonal ``diag`` and off-diagonal ``off`` (on [-1, 1]), whose weight
    function has the integral ``mu0``."""
    T = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
    x, V = torch.linalg.eigh(T)
    return x, mu0 * V[0] ** 2


def triangle_rule(n=QUAD_POINTS_PER_AXIS):
    """``(points (n^2, 2), weights (n^2,))`` on the triangle (0, 0),
    (1, 0), (0, 1): the integral over the triangle of f is that of
    f(a, (1 - a) b) (1 - a) over the unit square, a Gauss-Jacobi rule for
    the weight 1 - a times a Gauss-Legendre rule in b; exact to degree
    2 n - 1.  Weights sum to 1/2."""
    k = torch.arange(n, dtype=F64)
    j = torch.arange(1, n, dtype=F64)
    # Jacobi (alpha, beta) = (1, 0): weight 1 - x on [-1, 1], integral 2
    xa, wa = _golub_welsch(-1.0 / ((2 * k + 1) * (2 * k + 3)),
                           torch.sqrt(j * (j + 1)) / (2 * j + 1), 2.0)
    # Legendre: weight 1 on [-1, 1], integral 2
    xb, wb = _golub_welsch(torch.zeros(n, dtype=F64),
                           j / torch.sqrt(4 * j * j - 1), 2.0)
    # to [0, 1]: the Jacobi weight (1 - x) dx is 4 (1 - a) da
    a, wa = 0.5 * (xa + 1.0), wa / 4.0
    b, wb = 0.5 * (xb + 1.0), wb / 2.0
    A, B = torch.meshgrid(a, b, indexing="ij")
    points = torch.stack([A.reshape(-1), ((1.0 - A) * B).reshape(-1)], 1)
    return points, (wa[:, None] * wb[None, :]).reshape(-1)


def shape_functions(points):
    """P1 values ``lam`` (nq, 3) with gradients (3, 2), and P2 values
    (nq, 6) with gradients (nq, 6, 2), on the reference triangle."""
    x, y = points[:, 0], points[:, 1]
    lam = torch.stack([1.0 - x - y, x, y], dim=1)
    dlam = torch.tensor([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]], dtype=F64)
    phi = torch.cat([lam * (2.0 * lam - 1.0)]
                    + [4.0 * lam[:, a:a + 1] * lam[:, b:b + 1]
                       for a, b in EDGES], dim=1)
    dphi = torch.cat(
        [(4.0 * lam - 1.0)[:, :, None] * dlam[None]]
        + [4.0 * (lam[:, a, None, None] * dlam[None, None, b]
                  + lam[:, b, None, None] * dlam[None, None, a])
           for a, b in EDGES], dim=1)
    return lam, dlam, phi, dphi


class Mesh:
    """The node numbering of a triangulation, and its boundary.

    ``vertices`` (nv, 2), ``triangles`` (nc, 3), ``cell_nodes`` (nc, 6,
    2): each cell's P2 node positions in the local order of
    :data:`EDGES`; ``boundary`` maps a marker to its edges (m, 2) as
    vertex pairs."""

    def __init__(self, vertices, triangles, cell_nodes, boundary):
        vertices = torch.as_tensor(vertices, dtype=F64)
        triangles = torch.as_tensor(triangles, dtype=torch.long)
        cell_nodes = torch.as_tensor(cell_nodes, dtype=F64)
        nv = len(vertices)
        pairs = triangles[:, list(EDGES)]                          # (nc, 3, 2)
        key = pairs.min(-1).values * nv + pairs.max(-1).values
        self._edge_keys, edge = torch.unique(key, return_inverse=True)
        self.nv, self.np = nv, nv
        self.nu = nv + len(self._edge_keys)
        self.unodes = torch.cat([triangles, nv + edge], dim=1)    # (nc, 6)
        self.pnodes = triangles
        self.cell_nodes = cell_nodes
        xy = torch.zeros((self.nu, 2), dtype=F64)
        xy[self.unodes.reshape(-1)] = cell_nodes.reshape(-1, 2)
        if not torch.equal(xy[self.unodes], cell_nodes):
            raise ValueError("two cells place one P2 node apart")
        self.u_xy, self.p_xy = xy, vertices
        self.boundary = {int(m): torch.as_tensor(e, dtype=torch.long)
                         for m, e in boundary.items()}
        self._u_at = {p: i for i, p in enumerate(map(tuple, xy.tolist()))}
        self._p_at = {p: i for i, p in
                      enumerate(map(tuple, vertices.tolist()))}

    def u_index(self, coords):
        """Indices of the P2 nodes at ``coords`` ((m, 2), numpy or torch):
        the same positions, to the bit."""
        xy = torch.as_tensor(coords, dtype=F64).tolist()
        return torch.tensor([self._u_at[tuple(p)] for p in xy])

    def p_index(self, coords):
        """Indices of the P1 nodes at ``coords``."""
        xy = torch.as_tensor(coords, dtype=F64).tolist()
        return torch.tensor([self._p_at[tuple(p)] for p in xy])

    def boundary_unodes(self, markers):
        """The P2 nodes of the edges carrying any of ``markers``: their
        vertices and their mid-edge nodes."""
        edges = torch.cat([self.boundary[int(m)] for m in markers])
        key = edges.min(1).values * self.nv + edges.max(1).values
        mids = self.nv + torch.searchsorted(self._edge_keys, key)
        return torch.unique(torch.cat([edges.reshape(-1), mids]))

    def boundary_pnodes(self, markers):
        edges = torch.cat([self.boundary[int(m)] for m in markers])
        return torch.unique(edges.reshape(-1))


class Grid(Mesh):
    """P2/P1 operators of the isoparametric cells (float64, host)."""

    def __init__(self, vertices, triangles, cell_nodes, boundary):
        super().__init__(vertices, triangles, cell_nodes, boundary)
        points, weights = triangle_rule()
        lam, dlam, phi, dphi_ref = shape_functions(points)
        X = self.cell_nodes
        J = torch.einsum("cid,qie->cqde", X, dphi_ref)   # dx_d / dxi_e
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        if not (det > 0).all():
            raise ValueError("a cell's map folds (det J <= 0)")
        # Jinv[e, d] = dxi_e / dx_d
        Jinv = torch.stack([torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                            torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1)],
                           -2) / det[..., None, None]
        dphi = torch.einsum("qie,cqed->cqid", dphi_ref, Jinv)
        dpsi = torch.einsum("ie,cqed->cqid", dlam, Jinv)
        W = weights * det                                         # (nc, nq)
        self.cells = {"phi": phi, "dphi": dphi, "w": W}
        u, p = self.unodes, self.pnodes
        self.M = self._assemble(torch.einsum("cq,qi,qj->cij", W, phi, phi),
                                u, u, self.nu, self.nu)
        self.K = self._assemble(
            torch.einsum("cq,cqid,cqjd->cij", W, dphi, dphi), u, u, self.nu,
            self.nu)
        self.L = self._assemble(
            torch.einsum("cq,cqid,cqjd->cij", W, dpsi, dpsi), p, p, self.np,
            self.np)
        # G[i, d, j] = -int psi_j d(phi_i)/dx_d
        G = -torch.einsum("cq,qj,cqid->cidj", W, lam, dphi)
        self.G = [self._assemble(G[:, :, d, :], u, p, self.nu, self.np)
                  for d in range(2)]
        self.D = [self._assemble(G[:, :, d, :].transpose(1, 2), p, u,
                                 self.np, self.nu) for d in range(2)]
        # the convection's scatter as a gather: for each node, the slots of
        # the per-cell results that land on it (padded with a zero slot)
        flat = u.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=self.nu)
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(len(flat)) - start[flat[order]]
        self.conv_table = torch.full((self.nu, int(counts.max())), len(flat),
                                     dtype=torch.long)
        self.conv_table[flat[order], pos] = order

    @staticmethod
    def _assemble(E, rows, cols, n_rows, n_cols):
        a, b = E.shape[1:]
        return Ell(rows[:, :, None].expand(-1, a, b).reshape(-1),
                   cols[:, None, :].expand(-1, a, b).reshape(-1),
                   E.reshape(-1), n_rows, n_cols)


class Convection:
    """int ((u . grad) u) . phi_i for every P2 node, (2, nu), cell by
    cell in ``dtype`` on ``device``."""

    def __init__(self, grid, dtype, device):
        self.tab = {k: v.to(device=device, dtype=dtype)
                    for k, v in grid.cells.items()}
        self.unodes = grid.unodes.to(device)
        self.table = grid.conv_table.to(device)

    def __call__(self, u):
        tab = self.tab
        uc = u[:, self.unodes]                                  # (2, c, 6)
        uq = torch.einsum("dci,qi->dcq", uc, tab["phi"])
        grad = torch.einsum("dci,cqie->dcqe", uc, tab["dphi"])
        adv = torch.einsum("ecq,dcqe->dcq", uq, grad)
        r = torch.einsum("dcq,cq,qi->dci", adv, tab["w"], tab["phi"])
        pad = torch.zeros((2, 1), dtype=u.dtype, device=u.device)
        flat = torch.cat([r.reshape(2, -1), pad], dim=1)
        return flat[:, self.table].sum(dim=-1)


def reaction_force(grid, u, u_old, p, markers, *, visc, dt):
    """The nodal reaction on the boundary of ``markers``, (2,) float64: the
    negated sum over its velocity nodes of the momentum residual
    (u - u_old) / dt M + convection + visc K u + G p of the state's
    levels ``u``, ``u_old`` (2, nu) and ``p`` (np,), in float64 on their
    device."""
    dev = u.device
    u, u_old, p = (t.to(F64) for t in (u, u_old, p))
    M, K = grid.M.to(F64, dev), grid.K.to(F64, dev)
    r = (M(u) - M(u_old)) / dt + Convection(grid, F64, dev)(u) \
        + visc * K(u) + torch.stack([G.to(F64, dev)(p) for G in grid.G])
    return -r[:, grid.boundary_unodes(markers).to(dev)].sum(dim=1)


class ReferenceStep:
    """``(u, p, phi) = step(u, u_old, p, phi)``: one SBDF-2 step.

    ``u`` is (2, nu), ``p`` and ``phi`` (np,), in the grid's numbering and
    in ``dtype``.  ``solves`` maps helmholtz / poisson / mass to a kind of
    sub-solve (the module's docstring).  ``dirichlet``: ``(mask, values)``
    of the velocity nodes held fixed ((nu,) and (2, nu)); ``pressure_fixed``
    the (np,) mask of the pressure nodes held fixed (phi = 0 there)."""

    EXACT_TOL = 1e-13
    EXACT_MAX_ITERS = 400

    def __init__(self, grid, *, visc, dt, solves, dirichlet, pressure_fixed,
                 dtype=F64, device="cpu"):
        self.grid, self.visc, self.dt = grid, float(visc), float(dt)
        self.solves, self.dtype = dict(solves), dtype

        def dev(op):
            return op.to(dtype, device)

        self.M, self.K, self.L = dev(grid.M), dev(grid.K), dev(grid.L)
        self.G = [dev(op) for op in grid.G]
        self.D = [dev(op) for op in grid.D]
        self.diag_m, self.diag_k = self.M.diagonal(), self.K.diagonal()
        self.inv_diag_l = _inv(self.L.diagonal())
        self.convection = Convection(grid, dtype, device)
        mask, vals = dirichlet
        self.free = (~mask.to(device)).to(dtype)
        self.fixed_vals = (vals.to(device=device, dtype=dtype)
                           * (1.0 - self.free))
        self.p_free = (~pressure_fixed.to(device)).to(dtype)
        if self.solves["poisson"][0] == "exact":
            P = (~pressure_fixed.to(device)).to(F64)
            A = P[:, None] * grid.L.to(F64, device).dense() * P[None, :] \
                + torch.diag(1.0 - P)
            self.poisson_inv = torch.cholesky_inverse(
                torch.linalg.cholesky(A)).to(dtype)

    def grad(self, q):
        return torch.stack([G(q) for G in self.G], dim=0)

    def div(self, v):
        return self.D[0](v[0]) + self.D[1](v[1])

    def _velocity_solve(self, kind, A_free, diag, b, x0):
        m, g = self.free, self.fixed_vals

        def A(v):
            return m * A_free(m * v) + (1.0 - m) * v

        b = m * (b - A_free(g)) + g
        x0 = m * x0 + g
        inv_diag = _inv(diag)
        if kind[0] == "jacobi":
            return pcg(A, b, x0, kind[1], inv_diag)
        return pcg(A, b, x0, self.EXACT_MAX_ITERS, inv_diag,
                   tol=self.EXACT_TOL)

    def __call__(self, u, u_old, p, phi, alpha=BDF2[0], eta=BDF2[1]):
        a0, a1, a2 = alpha
        k, visc = self.dt, self.visc
        M, pf = self.M, self.p_free

        def helm(v):
            return (a0 / k) * M(v) + visc * self.K(v)

        u_ext = eta[0] * u + eta[1] * u_old
        b = (-(a1 / k) * M(u) - (a2 / k) * M(u_old)
             - self.convection(u_ext) - self.grad(p))
        u_star = self._velocity_solve(
            self.solves["helmholtz"], helm,
            (a0 / k) * self.diag_m + visc * self.diag_k, b, u)

        rhs = pf * ((a0 / k) * self.div(u_star))
        kind = self.solves["poisson"]
        if kind[0] == "jacobi":
            def stiff(v):
                return pf * self.L(pf * v) + (1.0 - pf) * v

            def project(r):
                return pf * r

            phi_new = pcg(stiff, rhs, pf * phi, kind[1], self.inv_diag_l,
                          project=project)
        else:
            phi_new = self.poisson_inv @ rhs

        b_corr = M(u_star) - (k / a0) * self.grad(phi_new)
        u_new = self._velocity_solve(self.solves["mass"], M, self.diag_m,
                                     b_corr, u_star)
        return u_new, p + phi_new, phi_new

    def run(self, state, n_steps):
        """``n_steps`` BDF-2 steps from ``state = (u, u_old, p, phi)``
        (cast to the step's dtype; further entries are not read); returns
        the final state."""
        u, u_old, p, phi = (t.to(self.dtype) for t in state[:4])
        for _ in range(int(n_steps)):
            u_new, p, phi = self(u, u_old, p, phi)
            u_old, u = u, u_new
        return u, u_old, p, phi
