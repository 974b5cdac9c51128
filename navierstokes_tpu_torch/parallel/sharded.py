"""Cell-sharded matrix-free operators (``navierstokes_tpu/parallel/sharded.py``).

The linear operators (mass, stiffness, pressure-gradient coupling) are
per-cell element matrices precomputed once on the host; each matvec is a
gather of the cell's nodes, a batched small product (``torch.bmm``) and an
accumulation through a precomputed transpose-gather table (node -> the
(cell, local-node) slots that contribute to it, ELL-padded): a gather and a
fixed-order sum, with no atomics, so a rerun on the card repeats itself
bit for bit.  Only the nonlinear convection keeps the quadrature loop.

Cell sharding with replicated vectors, as in the JAX class: the cells,
in Morton order and padded with zero-weight cells to a multiple of the
shard count, are split into equal chunks, one per shard of a
:class:`~navierstokes_tpu_torch.parallel.comm.DeviceMesh`; each shard
holds its chunk's element matrices and its own ELL tables (one padded
width K for all shards).  An apply sends the replicated input to every
shard, each shard assembles its cells' contributions into a full-length
partial result, and one :func:`~navierstokes_tpu_torch.parallel.comm.psum`
adds the partials in shard order on shard 0's device, where the result
lives.  On one shard the sum has one term and the apply is the plain sum
over all cells.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config, native
from navierstokes_tpu_torch.parallel.comm import (  # noqa: F401
    DeviceMesh, as_mesh, device_mesh, psum)
from navierstokes_tpu_torch.utils.segment import padded_row_sum, take_rows


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
    values before gathering.  Built by the g++ helper's counting sort
    (``navierstokes_tpu_torch.native``); :func:`_numpy_scatter_transpose`
    is its plain version (``NS_TPU_NO_NATIVE=1``).
    """
    flat_nodes = np.asarray(cell_nodes, dtype=np.int32).ravel()
    return native.build_transpose(flat_nodes, n_nodes, k_pad)


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


class _CellShard:
    """One shard's cells: element matrices, geometry and ELL tables on the
    shard's device."""

    def __init__(self, device, dim, arrays, tables):
        self.device = device
        self.dim = dim
        for name, value in arrays.items():
            setattr(self, name, value)
        self.u_table_v, self.u_table_e, self.p_table = tables
        nc, n2, n1 = self.G_c.shape[0], self.G_c.shape[1], self.G_c.shape[3]
        # the coupling as (cells, n2*dim, n1) for G p and its transpose
        # for D u, both one bmm
        self._G_flat = self.G_c.reshape(nc, n2 * dim, n1)
        self._D_flat = self._G_flat.transpose(1, 2).contiguous()
        self._helm_cache = None

    def cells_u(self, uflat):
        """(n_unodes * dim,) -> (cells, n2, dim) cell values."""
        return take_rows(uflat.to(self.device, non_blocking=True)
                         .reshape(-1, self.dim), self.cell_unodes)

    def cells_p(self, p):
        return p.to(self.device, non_blocking=True)[self.cell_pnodes]

    def scatter_u(self, r_c):
        """(cells, n2, dim) cell contributions -> (n_unodes * dim,)."""
        flat = r_c.reshape(-1, self.dim)
        out_v = padded_row_sum(self.u_table_v, flat)
        out_e = padded_row_sum(self.u_table_e, flat)
        return torch.cat([out_v, out_e], dim=0).reshape(-1)

    def scatter_p(self, r_c):
        return padded_row_sum(self.p_table, r_c.reshape(-1))

    def helmholtz_cells(self, visc, accel0):
        """accel0 M_c + visc K_c, kept for the last accel0 (a step's
        velocity solve applies it once per CG iteration)."""
        key = (float(visc), float(accel0))
        if self._helm_cache is None or self._helm_cache[0] != key:
            self._helm_cache = (key, accel0 * self.M_c + visc * self.K_c)
        return self._helm_cache[1]


class ShardedCellOperator:
    """Matrix-free cell-loop operators of a Taylor-Hood space over the
    shards of a device mesh.

    Vectors are the space's flat layouts, replicated: velocity
    ``(n_unodes * dim,)`` node-major interleaved, pressure ``(n_pnodes,)``,
    on shard 0's device (``self.device``); every apply returns there.
    ``mesh`` is None (one shard on ``device``), a
    :class:`~navierstokes_tpu_torch.parallel.comm.DeviceMesh` or a plain
    sequence of devices; ``axis`` names the mesh axis of a plain
    sequence.  ``dtype`` defaults to ``config.default_dtype``.
    """

    def __init__(self, space, mesh=None, axis="shard", *, dtype=None,
                 device=None):
        mesh = as_mesh(mesh, axis)
        if mesh is None:
            mesh = DeviceMesh([config.require_device(device)], axis)
        elif device is not None and \
                config.resolve_device(device) != mesh.devices[0]:
            raise ValueError(f"device {device} is not the mesh's shard 0 "
                             f"({mesh.devices[0]})")
        self.mesh = mesh
        self.n_dev = n_dev = len(mesh)
        self.device = device = mesh.devices[0]
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
        # padding to a multiple of the shard count: zero-weight copies of
        # the first cell, whose element matrices vanish
        n_pad = (-len(cu)) % n_dev
        if n_pad:
            W = np.concatenate([W, np.zeros((n_pad, W.shape[1]), W.dtype)])
            Jinv = np.concatenate([Jinv, np.repeat(Jinv[:1], n_pad, 0)])
            cu = np.concatenate([cu, np.repeat(cu[:1], n_pad, 0)])
            cp_ = np.concatenate([cp_, np.repeat(cp_[:1], n_pad, 0)])
        self.n_cells_padded = len(cu)
        self.chunk = chunk = len(cu) // n_dev
        self._cu_host, self._cp_host = cu, cp_

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

        # per-shard ELL tables over the shard's own cells, the velocity
        # scatter split by node class (vertex nodes in ranks [0, n_vtx),
        # edge midpoints in [n_vtx, n_unodes)): their valences differ, so
        # each class gets its own width, common to all shards
        n_vtx = getattr(space, "n_vertex_unodes", space.n_unodes)
        self.n_vertex_unodes = n_vtx
        chunks_u = [cu[d * chunk:(d + 1) * chunk] for d in range(n_dev)]
        chunks_p = [cp_[d * chunk:(d + 1) * chunk] for d in range(n_dev)]

        def shard_tables(builder, chunks, *args):
            K = max(builder(c, *args)[1] for c in chunks)
            return [builder(c, *args, K)[0] for c in chunks]

        tables = zip(
            shard_tables(build_scatter_transpose_range, chunks_u, 0, n_vtx),
            shard_tables(build_scatter_transpose_range, chunks_u, n_vtx,
                         space.n_unodes),
            shard_tables(build_scatter_transpose, chunks_p, space.n_pnodes))

        self.N2 = torch.as_tensor(np.asarray(space.N2, dtype=np_dt),
                                  device=device)
        self._shards = []
        for d, tabs in enumerate(tables):
            dev = mesh.devices[d]
            cells = slice(d * chunk, (d + 1) * chunk)

            def dev_f(a):
                return torch.as_tensor(np.asarray(a[cells], dtype=np_dt),
                                       device=dev)

            arrays = dict(W=dev_f(W), M_c=dev_f(M_c), K_c=dev_f(K_c),
                          G_c=dev_f(G_c), KP_c=dev_f(KP_c),
                          # physical shape gradients at the quadrature
                          # points, for the convection (the JAX class
                          # forms them inside every apply)
                          g2=dev_f(g2),
                          N2=self.N2.to(dev),
                          cell_unodes=torch.as_tensor(
                              np.asarray(cu[cells], np.int64), device=dev),
                          cell_pnodes=torch.as_tensor(
                              np.asarray(cp_[cells], np.int64), device=dev))
            self._shards.append(_CellShard(
                dev, dim, arrays,
                [torch.as_tensor(t.astype(np.int64), device=dev)
                 for t in tabs]))

    def _sum(self, local):
        """``local(shard)`` on every shard, added in shard order on shard
        0's device (one psum)."""
        parts = [local(sh) for sh in self._shards]
        if len(parts) == 1:
            return parts[0]
        return psum(parts, self.mesh)[0]

    # -- operator factories ---------------------------------------------------
    def make_velocity_mass(self):
        """u -> M u (P2 vector mass), flat in and out."""
        def mass(uflat):
            return self._sum(lambda sh: sh.scatter_u(
                torch.bmm(sh.M_c, sh.cells_u(uflat))))

        return mass

    def make_velocity_helmholtz(self, visc):
        """(u, accel0) -> (accel0 M + visc K) u."""
        def helm(uflat, accel0):
            return self._sum(lambda sh: sh.scatter_u(torch.bmm(
                sh.helmholtz_cells(visc, accel0), sh.cells_u(uflat))))

        return helm

    def make_gradient(self):
        """p -> G p: velocity-space image of -int(p div w)."""
        def local(sh, p):
            r_c = torch.bmm(sh._G_flat, sh.cells_p(p).unsqueeze(-1))
            return sh.scatter_u(r_c.reshape(-1, sh.G_c.shape[1], sh.dim))

        def grad(p):
            return self._sum(lambda sh: local(sh, p))

        return grad

    def make_divergence(self):
        """u -> D u with D u = -int(div u) q tested against P1 (D = G^T)."""
        def local(sh, uflat):
            u_c = sh.cells_u(uflat).reshape(sh._D_flat.shape[0], -1, 1)
            return sh.scatter_p(torch.bmm(sh._D_flat, u_c))

        def div(uflat):
            return self._sum(lambda sh: local(sh, uflat))

        return div

    def make_pressure_stiffness(self):
        """p -> L p (P1 Laplacian)."""
        def stiff(p):
            return self._sum(lambda sh: sh.scatter_p(torch.bmm(
                sh.KP_c, sh.cells_p(p).unsqueeze(-1))))

        return stiff

    def make_convection_rhs(self, cc):
        """u -> b with b_i = int(cc (u.grad)u . N_i): the nonlinear
        assembly, by quadrature."""
        cc = float(cc)

        def local(sh, uflat):
            u_c = sh.cells_u(uflat)
            u_q = torch.einsum("qi,cid->cqd", sh.N2, u_c)
            grad_u = torch.einsum("cid,cqie->cqde", u_c, sh.g2)
            adv = cc * torch.einsum("cqde,cqe->cqd", grad_u, u_q)
            r_c = torch.einsum("cq,cqd,qi->cid", sh.W, adv, sh.N2)
            return sh.scatter_u(r_c)

        def conv(uflat):
            return self._sum(lambda sh: local(sh, uflat))

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
