"""Plain PyTorch reference of the benchmark's flow step.

Taylor-Hood P2/P1 finite elements on the unit square cut into n x n
squares, each split along its (0, 0)-(1, 1) diagonal into two triangles;
the semi-implicit SBDF-2 incremental pressure-correction step: explicit
extrapolated convection, a velocity Helmholtz solve, a mean-free pressure
Poisson solve for the increment phi, a velocity-mass correction, and
p <- p + phi with the nodal mean removed.

Written from the method alone: it imports nothing of the program under
test and takes no table, operator or weight that the program built.  Its
nodes are numbered on the half-spacing grid, ``index = a * N + b`` for the
node at (a, b) * h / 2 (P2, N nodes per axis) and ``a * n1 + b`` for the
vertex at (a, b) * h (P1); a periodic square keeps one node per class
(N = 2n, n1 = n).  Integrals are exact (a degree-5 rule on affine
triangles: mass, stiffness, couplings and the convection form are
polynomials of degree at most 5).  Operators are padded row tables
(ELL), so every product runs in any floating dtype, bfloat16 included.

A sub-solve is ``("jacobi", iters)`` -- Jacobi-preconditioned CG with a
fixed iteration count from the warm start, the residual projected (the
mean removed, or masked rows zeroed) after each update --, for a velocity
system ``("jacobi_rtol", rtol, max_iters)`` -- the same, stopped before
the first iteration at which ||r|| <= rtol ||b|| --, or ``("exact",)``:
Jacobi-PCG to a relative residual of 1e-13 for the velocity systems, and
the inverse of the mean-fixed Laplacian L + 1 1^T / n_p for
the pressure, which gives the mean-free solution.
"""

from __future__ import annotations

import math

import torch

# Radon's seven-point rule on a triangle: barycentric points, weights
# summing to one; exact for polynomials of degree 5
_S15 = math.sqrt(15.0)
_A, _B = (6.0 - _S15) / 21.0, (6.0 + _S15) / 21.0
_WA, _WB = (155.0 - _S15) / 1200.0, (155.0 + _S15) / 1200.0
QUAD_BARY = [(1 / 3, 1 / 3, 1 / 3),
             (_A, _A, 1 - 2 * _A), (_A, 1 - 2 * _A, _A), (1 - 2 * _A, _A, _A),
             (_B, _B, 1 - 2 * _B), (_B, 1 - 2 * _B, _B), (1 - 2 * _B, _B, _B)]
QUAD_W = [9.0 / 40.0] + [_WA] * 3 + [_WB] * 3

# the two triangles of the square at (i, j), as vertex offsets in cells
TRIANGLES = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))
# P2 local nodes: the vertices, then the midpoints of edges 01, 12, 02
EDGES = ((0, 1), (1, 2), (0, 2))

BDF2 = ((1.5, -2.0, 0.5), (2.0, -1.0))


def _element(verts, h):
    """Exact element matrices and quadrature tables of one triangle with
    vertex offsets ``verts`` (in cells) on a grid of spacing ``h``."""
    f64 = torch.float64
    X = torch.tensor(verts, dtype=f64) * h                       # (3, 2)
    B = torch.stack([X[1] - X[0], X[2] - X[0]], dim=1)          # (2, 2)
    Binv = torch.linalg.inv(B)
    g = torch.cat([-(Binv[0] + Binv[1])[None], Binv], dim=0)    # (3, 2)
    area = abs(float(torch.linalg.det(B))) / 2.0
    lam = torch.tensor(QUAD_BARY, dtype=f64)                    # (7, 3)
    w = torch.tensor(QUAD_W, dtype=f64) * area                  # (7,)
    phi = torch.cat([lam * (2 * lam - 1)] +
                    [4 * lam[:, a:a + 1] * lam[:, b:b + 1] for a, b in EDGES],
                    dim=1)                                       # (7, 6)
    dphi = torch.cat(
        [((4 * lam - 1)[:, :, None] * g[None])] +
        [4 * (lam[:, a, None, None] * g[None, None, b]
              + lam[:, b, None, None] * g[None, None, a]) for a, b in EDGES],
        dim=1)                                                   # (7, 6, 2)
    return {
        "M2": torch.einsum("q,qi,qj->ij", w, phi, phi),
        "K2": torch.einsum("q,qie,qje->ij", w, dphi, dphi),
        "L1": area * g @ g.T,
        # G[i, d, j] = -int psi_j d(phi_i)/dx_d
        "G": -torch.einsum("q,qj,qid->idj", w, lam, dphi),
        "phi": phi, "dphi": dphi, "w": w,
    }


class Ell:
    """A sparse matrix as padded rows: ``y = sum_k vals[i, k] x[cols[i, k]]``
    over the last axis of ``x``."""

    def __init__(self, rows, cols, vals, n_rows, n_cols):
        key = rows * n_cols + cols
        key, order = torch.sort(key)
        vals = vals[order]
        uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
        summed = torch.zeros(len(uniq), dtype=vals.dtype).index_add_(
            0, inverse, vals)
        r, c = uniq // n_cols, uniq % n_cols
        counts = torch.bincount(r, minlength=n_rows)
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(len(r)) - start[r]
        width = int(counts.max())
        self.cols = torch.zeros((n_rows, width), dtype=torch.long)
        self.vals = torch.zeros((n_rows, width), dtype=vals.dtype)
        self.cols[r, pos] = c
        self.vals[r, pos] = summed
        self.shape = (n_rows, n_cols)

    def to(self, dtype, device):
        out = Ell.__new__(Ell)
        out.cols = self.cols.to(device)
        out.vals = self.vals.to(device=device, dtype=dtype)
        out.shape = self.shape
        return out

    def __call__(self, x):
        return (x[..., self.cols] * self.vals).sum(dim=-1)

    def diagonal(self):
        rows = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        return (self.vals * (self.cols == rows)).sum(dim=1)

    def dense(self):
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        rows = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        out.index_put_((rows.expand_as(self.cols), self.cols), self.vals,
                       accumulate=True)
        return out


class Lattice:
    """The node numbering of the n x n unit square (periodic or not)."""

    def __init__(self, n, periodic):
        self.n, self.periodic = n, bool(periodic)
        self.N = 2 * n if periodic else 2 * n + 1     # P2 nodes per axis
        self.n1 = n if periodic else n + 1            # P1 nodes per axis
        self.nu, self.np = self.N ** 2, self.n1 ** 2

    def _fine(self, a, b):
        if self.periodic:
            a, b = a % self.N, b % self.N
        return a * self.N + b

    def _coarse(self, a, b):
        if self.periodic:
            a, b = a % self.n1, b % self.n1
        return a * self.n1 + b

    def u_index(self, coords):
        """Indices of the P2 nodes at ``coords`` ((m, 2), numpy or
        torch)."""
        c = torch.round(torch.as_tensor(coords, dtype=torch.float64)
                        * (2 * self.n)).long()
        return self._fine(c[:, 0], c[:, 1])

    def p_index(self, coords):
        """Indices of the P1 nodes at ``coords``."""
        c = torch.round(torch.as_tensor(coords, dtype=torch.float64)
                        * self.n).long()
        return self._coarse(c[:, 0], c[:, 1])

    def boundary_values(self, lid_corners):
        """Dirichlet mask and values (2, nu) of the lid-driven cavity: no
        slip on the walls, (1, 0) on the lid y = 1; the two lid corners
        take the lid's value when ``lid_corners`` is true."""
        a = torch.arange(self.N)
        A, B = torch.meshgrid(a, a, indexing="ij")
        last = self.N - 1
        wall = (A == 0) | (A == last) | (B == 0)
        lid = B == last
        if not lid_corners:
            lid = lid & ~wall
        mask = (wall | lid).reshape(-1)
        vals = torch.zeros((2, self.nu), dtype=torch.float64)
        vals[0] = lid.reshape(-1).to(torch.float64)
        return mask, vals


class Grid(Lattice):
    """P2/P1 Taylor-Hood operators on the n x n unit square (f64, host)."""

    def __init__(self, n, periodic):
        super().__init__(n, periodic)
        i, j = torch.meshgrid(torch.arange(n), torch.arange(n),
                              indexing="ij")
        i, j = i.reshape(-1), j.reshape(-1)
        self.elements, self.unodes, pnodes = [], [], []
        for verts in TRIANGLES:
            self.elements.append(_element(verts, 1.0 / n))
            fine = [(2 * (i + dx), 2 * (j + dy)) for dx, dy in verts]
            fine += [((fine[a][0] + fine[b][0]) // 2,
                      (fine[a][1] + fine[b][1]) // 2) for a, b in EDGES]
            self.unodes.append(torch.stack(
                [self._fine(a, b) for a, b in fine], dim=1))       # (nc, 6)
            pnodes.append(torch.stack(
                [self._coarse(i + dx, j + dy) for dx, dy in verts], dim=1))
        self.M = self._assemble("M2", self.unodes, self.unodes, self.nu,
                                self.nu)
        self.K = self._assemble("K2", self.unodes, self.unodes, self.nu,
                                self.nu)
        self.L = self._assemble("L1", pnodes, pnodes, self.np, self.np)
        self.G = [self._assemble("G", self.unodes, pnodes, self.nu, self.np,
                                 axis=d) for d in range(2)]
        self.D = [self._assemble("G", self.unodes, pnodes, self.nu, self.np,
                                 axis=d, transpose=True) for d in range(2)]
        # the convection's scatter as a gather: for each node, the slots of
        # the per-cell results that land on it (padded with a zero slot)
        flat = torch.cat([u.reshape(-1) for u in self.unodes])
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=self.nu)
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(len(flat)) - start[flat[order]]
        self.conv_table = torch.full((self.nu, int(counts.max())), len(flat),
                                     dtype=torch.long)
        self.conv_table[flat[order], pos] = order

    def _assemble(self, name, row_nodes, col_nodes, n_rows, n_cols,
                  axis=None, transpose=False):
        rows, cols, vals = [], [], []
        for el, rn, cn in zip(self.elements, row_nodes, col_nodes):
            E = el[name] if axis is None else el[name][:, axis, :]
            if transpose:
                rn, cn, E = cn, rn, E.T
            a, b = E.shape
            rows.append(rn[:, :, None].expand(-1, a, b).reshape(-1))
            cols.append(cn[:, None, :].expand(-1, a, b).reshape(-1))
            vals.append(E[None].expand(len(rn), a, b).reshape(-1))
        if transpose:
            n_rows, n_cols = n_cols, n_rows
        return Ell(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                   n_rows, n_cols)


def _inv(d):
    return 1.0 / torch.where(d.abs() > 1e-30, d, torch.ones_like(d))


def pcg(matvec, b, x0, iters, inv_diag, project=None, tol=None,
        check_every=20):
    """Jacobi-preconditioned CG: ``iters`` iterations, or with ``tol``
    until ||r|| <= tol ||b|| (tested before every ``check_every``-th
    iteration, ``iters`` at most).  The residual is re-projected after
    each update."""
    r = b - matvec(x0)
    if project is not None:
        r = project(r)
    z = inv_diag * r
    x, p, rz = x0, z, torch.sum(r * z)
    norm_b = None if tol is None else float(torch.linalg.vector_norm(
        b.double()))
    for it in range(int(iters)):
        if tol is not None and it % check_every == 0 and \
                float(torch.linalg.vector_norm(r.double())) <= tol * norm_b:
            break
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom.abs() > 0, rz / denom, torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        if project is not None:
            r = project(r)
        z = inv_diag * r
        rz_new = torch.sum(r * z)
        beta = torch.where(rz.abs() > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x


class ReferenceStep:
    """``(u, p, phi) = step(u, u_old, p, phi)``: one SBDF-2 step.

    ``u`` is (2, nu), ``p`` and ``phi`` (np,), in the grid's numbering and
    in ``dtype``.  ``solves`` maps helmholtz / poisson / mass to a kind
    of sub-solve (the module's docstring).  ``dirichlet``: ``(mask,
    values)`` of the velocity nodes held fixed, or None (periodic)."""

    EXACT_TOL = 1e-13
    EXACT_MAX_ITERS = 400

    def __init__(self, grid, *, visc, dt, solves, dirichlet=None,
                 dtype=torch.float64, device="cpu"):
        self.grid, self.visc, self.dt = grid, float(visc), float(dt)
        self.solves, self.dtype = dict(solves), dtype

        def dev(op):
            return op.to(dtype, device)

        self.M, self.K, self.L = dev(grid.M), dev(grid.K), dev(grid.L)
        self.G = [dev(op) for op in grid.G]
        self.D = [dev(op) for op in grid.D]
        self.diag_m, self.diag_k = self.M.diagonal(), self.K.diagonal()
        self.inv_diag_l = _inv(self.L.diagonal())
        self.conv = [{k: el[k].to(device=device, dtype=dtype)
                      for k in ("phi", "dphi", "w")} for el in grid.elements]
        self.unodes = [u.to(device) for u in grid.unodes]
        self.conv_table = grid.conv_table.to(device)
        if self.solves["poisson"][0] == "exact":
            A = grid.L.to(torch.float64, device).dense() + 1.0 / grid.np
            self.poisson_inv = torch.cholesky_inverse(
                torch.linalg.cholesky(A)).to(dtype)
        if dirichlet is None:
            self.free = self.fixed_vals = None
        else:
            mask, vals = dirichlet
            self.free = (~mask.to(device)).to(dtype)
            self.fixed_vals = (vals.to(device=device, dtype=dtype)
                               * (1.0 - self.free))

    def convection(self, u):
        """int ((u . grad) u) . phi_i for every P2 node, (2, nu)."""
        parts = []
        for tab, nodes in zip(self.conv, self.unodes):
            uc = u[:, nodes]                                    # (2, c, 6)
            uq = torch.einsum("dci,qi->dcq", uc, tab["phi"])
            grad = torch.einsum("dci,qie->dcqe", uc, tab["dphi"])
            adv = torch.einsum("ecq,dcqe->dcq", uq, grad)
            parts.append(torch.einsum("dcq,q,qi->dci", adv, tab["w"],
                                      tab["phi"]).reshape(2, -1))
        pad = torch.zeros((2, 1), dtype=u.dtype, device=u.device)
        flat = torch.cat(parts + [pad], dim=1)
        return flat[:, self.conv_table].sum(dim=-1)

    def grad(self, q):
        return torch.stack([G(q) for G in self.G], dim=0)

    def div(self, v):
        return self.D[0](v[0]) + self.D[1](v[1])

    def _velocity_solve(self, kind, A, diag, b, x0):
        if self.free is not None:
            m, g = self.free, self.fixed_vals
            A_free = A

            def A(v):
                return m * A_free(m * v) + (1.0 - m) * v

            b = m * (b - A_free(g)) + g
            x0 = m * x0 + g
        inv_diag = _inv(diag)
        if kind[0] == "jacobi":
            return pcg(A, b, x0, kind[1], inv_diag)
        if kind[0] == "jacobi_rtol":
            return pcg(A, b, x0, kind[2], inv_diag, tol=kind[1],
                       check_every=1)
        return pcg(A, b, x0, self.EXACT_MAX_ITERS, inv_diag,
                   tol=self.EXACT_TOL)

    def __call__(self, u, u_old, p, phi, alpha=BDF2[0], eta=BDF2[1]):
        a0, a1, a2 = alpha
        k, visc = self.dt, self.visc
        M = self.M

        def helm(v):
            return (a0 / k) * M(v) + visc * self.K(v)

        def mean_free(r):
            return r - r.mean()

        u_ext = eta[0] * u + eta[1] * u_old
        b = (-(a1 / k) * M(u) - (a2 / k) * M(u_old)
             - self.convection(u_ext) - self.grad(p))
        u_star = self._velocity_solve(
            self.solves["helmholtz"], helm,
            (a0 / k) * self.diag_m + visc * self.diag_k, b, u)

        rhs = mean_free((a0 / k) * self.div(u_star))
        kind = self.solves["poisson"]
        if kind[0] == "jacobi":
            phi_new = pcg(self.L, rhs, mean_free(phi), kind[1],
                          self.inv_diag_l, project=mean_free)
        else:
            phi_new = self.poisson_inv @ rhs

        b_corr = M(u_star) - (k / a0) * self.grad(phi_new)
        u_new = self._velocity_solve(self.solves["mass"], M, self.diag_m,
                                     b_corr, u_star)
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
