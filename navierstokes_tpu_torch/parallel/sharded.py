"""Cell-loop matrix-free operators (``navierstokes_tpu/parallel/sharded.py``).

The linear operators (mass, stiffness, pressure-gradient coupling) are
per-cell element matrices precomputed once on the host; each matvec is a
gather of the cell's nodes, a batched small product (``torch.bmm``) and an
accumulation through a precomputed transpose-gather table (node -> the
(cell, local-node) slots that contribute to it, ELL-padded): a gather and a
fixed-order sum, with no atomics, so a rerun on the card repeats itself
bit for bit.  Only the nonlinear convection keeps the quadrature loop.

One device only.  The JAX class shards the cells over a device mesh and
adds the shards' partial results with one ``psum`` per apply; on one
device that sum has a single term, so here each apply is the plain sum
over all cells.  ``device_mesh`` with more than one device, the sharded
form, is ROADMAP item 15 and raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.utils.segment import padded_row_sum, take_rows


def device_mesh(n_devices=None, axis="shard", device=None):
    """The devices the cell-loop operators run on: one.

    ``n_devices`` of None or 1 gives ``[device]`` (default: the card; the
    CPU only when asked for).  More than one device is the multi-device
    layer, which is not ported yet.
    """
    if n_devices is not None and int(n_devices) > 1:
        raise NotImplementedError(
            "parallel.sharded.device_mesh over more than one device is not "
            "ported yet (ROADMAP item 15: the multi-device layer on "
            "torch.distributed)")
    return [config.require_device(device)]


def _numpy_scatter_transpose(flat_nodes: np.ndarray, n_nodes: int,
                             k_pad=None):
    """ELL-padded transpose table of a flat node list (NumPy)."""
    n_flat = len(flat_nodes)
    order = np.argsort(flat_nodes, kind="stable")
    counts = np.bincount(flat_nodes, minlength=n_nodes)
    K = int(counts.max()) if len(counts) else 1
    if k_pad is not None:
        K = max(K, int(k_pad))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n_nodes, K), n_flat, dtype=np.int32)
    within = np.arange(n_flat) - np.repeat(starts, counts)
    table[flat_nodes[order], within] = order.astype(np.int32)
    return table, K


def build_scatter_transpose(cell_nodes: np.ndarray, n_nodes: int,
                            k_pad: int = None):
    """Transpose-gather table: node -> flat (cell, local) slots.

    Returns (table (n_nodes, K) int32, K).  Pad entries point one past the
    last flat slot; callers append a zero row to the flattened per-cell
    values before gathering.
    """
    flat_nodes = np.asarray(cell_nodes, dtype=np.int32).ravel()
    return _numpy_scatter_transpose(flat_nodes, n_nodes, k_pad)


def build_scatter_transpose_range(cell_nodes: np.ndarray, lo: int,
                                  hi: int, k_pad: int = None):
    """Transpose table restricted to nodes in [lo, hi).

    Rows index local node ids (node - lo); stored slot indices stay global
    into the flattened per-cell values.  Used to split the velocity
    scatter by node class (vertex vs edge-midpoint ranks), whose valences
    differ: one ELL width for both would gather many padded slots.
    """
    flat = np.asarray(cell_nodes, dtype=np.int64).ravel()
    n_flat = len(flat)
    sel = np.nonzero((flat >= lo) & (flat < hi))[0]
    local = flat[sel] - lo
    counts = np.bincount(local, minlength=hi - lo)
    K = max(int(counts.max()) if len(counts) else 1, 1)
    if k_pad is not None:
        K = max(K, int(k_pad))
    order = np.argsort(local, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((hi - lo, K), n_flat, dtype=np.int32)
    within = np.arange(len(sel)) - np.repeat(starts, counts)
    table[local[order], within] = sel[order].astype(np.int32)
    return table, K


class ShardedCellOperator:
    """Matrix-free cell-loop operators of a Taylor-Hood space, on one
    device.

    Vectors are the space's flat layouts: velocity ``(n_unodes * dim,)``
    node-major interleaved, pressure ``(n_pnodes,)``.  ``mesh`` is None or
    a one-device list from :func:`device_mesh` (``axis`` names the JAX
    class's mesh axis and is unused on one device); ``device`` / ``dtype``
    default to the card and ``config.default_dtype``.
    """

    def __init__(self, space, mesh=None, axis="shard", *, dtype=None,
                 device=None):
        if mesh is not None:
            if len(mesh) != 1:
                raise NotImplementedError(
                    "ShardedCellOperator over more than one device is not "
                    "ported yet (ROADMAP item 15)")
            if device is None:
                device = mesh[0]
        self.device = device = config.require_device(device)
        self.dtype = dt = config.resolve_dtype(dtype, device)
        np_dt = config.numpy_dtype(dt)
        self.space = space
        self.dim = dim = space.dim

        # cells along a Morton curve of their centroids: consecutive cells
        # gather and scatter nearby node rows (the sums do not depend on
        # the cell order)
        from navierstokes_tpu_torch.fem.spaces import _morton_order

        centroids = space.mesh.points[space.mesh.cells].mean(axis=1)
        cell_order = _morton_order(centroids)
        self.cell_order = cell_order
        W = np.asarray(space.integration_weights(), dtype=np_dt)[cell_order]
        Jinv = np.asarray(space.Jinv_q, dtype=np_dt)[cell_order]
        cu = np.asarray(space.cell_unodes)[cell_order]
        cp_ = np.asarray(space.cell_pnodes)[cell_order]
        self._cu_host, self._cp_host = cu, cp_

        def dev_f(a):
            return torch.as_tensor(np.asarray(a, dtype=np_dt), device=device)

        def dev_i(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        self.W = dev_f(W)
        self.cell_unodes = dev_i(cu)
        self.cell_pnodes = dev_i(cp_)
        self.N2 = dev_f(space.N2)

        # element matrices, host-side once (cell-ordered)
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2), Jinv)
        g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1), Jinv)
        N2h = np.asarray(space.N2)
        N1h = np.asarray(space.N1)
        M_c = np.einsum("cq,qi,qj->cij", W, N2h, N2h)
        K_c = np.einsum("cq,cqie,cqje->cij", W, g2, g2)
        # G_c[i, d, j] = -int N1_j dN2_i/dx_d (pressure-gradient coupling)
        G_c = -np.einsum("cq,qj,cqid->cidj", W, N1h, g2)
        KP_c = np.einsum("cq,cqje,cqke->cjk", W, g1, g1)
        self._elem_diags_host = (np.einsum("cii->ci", M_c),
                                 np.einsum("cii->ci", K_c),
                                 np.einsum("cjj->cj", KP_c))
        nc, n2, n1 = G_c.shape[0], G_c.shape[1], G_c.shape[3]
        self.M_c = dev_f(M_c)
        self.K_c = dev_f(K_c)
        self.G_c = dev_f(G_c)
        self.KP_c = dev_f(KP_c)
        # the coupling as (cells, n2*dim, n1) for G p and its transpose
        # for D u, both one bmm
        self._G_flat = self.G_c.reshape(nc, n2 * dim, n1)
        self._D_flat = self._G_flat.transpose(1, 2).contiguous()
        # physical shape gradients at the quadrature points, for the
        # convection (the JAX class forms them inside every apply)
        self.g2 = dev_f(g2)
        self._helm_cache = None

        # the velocity scatter split by node class (vertex nodes in ranks
        # [0, n_vtx), edge midpoints in [n_vtx, n_unodes)): their valences
        # differ, so each class gets its own ELL width
        n_vtx = getattr(space, "n_vertex_unodes", space.n_unodes)
        self.n_vertex_unodes = n_vtx
        self.u_table_v = dev_i(build_scatter_transpose_range(
            cu, 0, n_vtx)[0])
        self.u_table_e = dev_i(build_scatter_transpose_range(
            cu, n_vtx, space.n_unodes)[0])
        self.p_table = dev_i(build_scatter_transpose(cp_,
                                                     space.n_pnodes)[0])

    # -- gather / scatter ---------------------------------------------------
    def _cells_u(self, uflat):
        """(n_unodes * dim,) -> (cells, n2, dim) cell values."""
        return take_rows(uflat.reshape(-1, self.dim), self.cell_unodes)

    def _scatter_u(self, r_c):
        """(cells, n2, dim) cell contributions -> (n_unodes * dim,)."""
        flat = r_c.reshape(-1, self.dim)
        out_v = padded_row_sum(self.u_table_v, flat)
        out_e = padded_row_sum(self.u_table_e, flat)
        return torch.cat([out_v, out_e], dim=0).reshape(-1)

    def _scatter_p(self, r_c):
        return padded_row_sum(self.p_table, r_c.reshape(-1))

    # -- operator factories ---------------------------------------------------
    def make_velocity_mass(self):
        """u -> M u (P2 vector mass), flat in and out."""
        def mass(uflat):
            return self._scatter_u(torch.bmm(self.M_c,
                                             self._cells_u(uflat)))

        return mass

    def _helmholtz_cells(self, visc, accel0):
        """accel0 M_c + visc K_c, kept for the last accel0 (a step's
        velocity solve applies it once per CG iteration)."""
        key = (float(visc), float(accel0))
        if self._helm_cache is None or self._helm_cache[0] != key:
            self._helm_cache = (key, accel0 * self.M_c + visc * self.K_c)
        return self._helm_cache[1]

    def make_velocity_helmholtz(self, visc):
        """(u, accel0) -> (accel0 M + visc K) u."""
        def helm(uflat, accel0):
            A_c = self._helmholtz_cells(visc, accel0)
            return self._scatter_u(torch.bmm(A_c, self._cells_u(uflat)))

        return helm

    def make_gradient(self):
        """p -> G p: velocity-space image of -int(p div w)."""
        def grad(p):
            p_c = p[self.cell_pnodes].unsqueeze(-1)
            r_c = torch.bmm(self._G_flat, p_c)
            return self._scatter_u(r_c.reshape(-1, self.G_c.shape[1],
                                               self.dim))

        return grad

    def make_divergence(self):
        """u -> D u with D u = -int(div u) q tested against P1 (D = G^T)."""
        def div(uflat):
            u_c = self._cells_u(uflat).reshape(self._D_flat.shape[0], -1, 1)
            return self._scatter_p(torch.bmm(self._D_flat, u_c))

        return div

    def make_pressure_stiffness(self):
        """p -> L p (P1 Laplacian)."""
        def stiff(p):
            p_c = p[self.cell_pnodes].unsqueeze(-1)
            return self._scatter_p(torch.bmm(self.KP_c, p_c))

        return stiff

    def make_convection_rhs(self, cc):
        """u -> b with b_i = int(cc (u.grad)u . N_i): the nonlinear
        assembly, by quadrature."""
        cc = float(cc)

        def conv(uflat):
            u_c = self._cells_u(uflat)
            u_q = torch.einsum("qi,cid->cqd", self.N2, u_c)
            grad_u = torch.einsum("cid,cqie->cqde", u_c, self.g2)
            adv = cc * torch.einsum("cqde,cqe->cqd", grad_u, u_q)
            r_c = torch.einsum("cq,cqd,qi->cid", self.W, adv, self.N2)
            return self._scatter_u(r_c)

        return conv

    def make_stokes_matvec(self, visc, cp=1.0, accel0=0.0):
        """x = [u, p] -> monolithic Stokes/Helmholtz apply."""
        n_u = self.space.n_velocity_dofs
        helm = self.make_velocity_helmholtz(visc)
        grad = self.make_gradient()
        div = self.make_divergence()

        def matvec(x):
            u, p = x[:n_u], x[n_u:]
            return torch.cat([helm(u, accel0) + cp * grad(p),
                              cp * div(u)])

        return matvec

    # -- operator diagonals (Jacobi preconditioning) ------------------------
    def diagonals(self):
        """(diag_M_u, diag_K_u, diag_L_p) assembled from the element
        matrices on the host: velocity diagonals per interleaved
        component."""
        def accumulate(elem_diag, cell_nodes, n_nodes):
            out = np.zeros(n_nodes)
            np.add.at(out, cell_nodes.ravel(),
                      np.asarray(elem_diag, np.float64).ravel())
            return out

        dM, dK, dL = self._elem_diags_host
        n_u = self.space.n_unodes
        diag_m = accumulate(dM, self._cu_host, n_u)
        diag_k = accumulate(dK, self._cu_host, n_u)
        diag_l = accumulate(dL, self._cp_host, self.space.n_pnodes)

        def dev(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype)

        return (dev(np.repeat(diag_m, self.dim)),
                dev(np.repeat(diag_k, self.dim)), dev(diag_l))
