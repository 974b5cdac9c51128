"""Dof-partitioned matrix-free operators with halo exchange
(``navierstokes_tpu/parallel/halo.py``).

The cell-sharded layer (``parallel/sharded.py``) replicates solution
vectors: every matvec sums a full-length vector over the shards.  This
layer partitions the *dofs*:

* cells are split into contiguous Morton blocks, one per shard; a node is
  owned by the first shard (in Morton cell order) whose cells touch it,
  and nodes are renumbered owner-major, each shard's count padded to the
  largest;
* each shard stores ONLY its own dof chunk plus a halo -- the nodes of
  other shards that its cells touch;
* a matvec is: the halo values come in (one exchange per active partner
  offset) -> the shard's element kernel and transpose-gather sum -> the
  halo contributions go back to their owners and are added.

Per-shard storage is O(dofs/n + halo), and each matvec moves only the
halo.  The host plan (:func:`_partition_nodes`, :class:`_HaloPlan`) is
the JAX module's NumPy code, array for array.  Where the JAX module calls
``lax.ppermute`` inside ``shard_map``, the port calls
:func:`~navierstokes_tpu_torch.parallel.comm.ppermute` on a list of
per-shard tensors; the owners add the returned contributions with
``index_add``, whose indices are distinct within one offset but for the
padding row, which receives only zeros, so every real entry gets exactly
one addition and a rerun on the card is bitwise equal.

Vectors are :class:`~navierstokes_tpu_torch.parallel.comm.Sharded`: one
tensor per shard holding its own chunk in the partitioned numbering
(velocity ``(chunk_u * dim,)`` node-major, pressure ``(chunk_p,)``);
padding slots hold zeros.  ``pad_velocity`` / ``unpad_velocity`` (and the
pressure versions) convert from and to the space's flat layout.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.parallel.comm import Sharded, as_mesh, ppermute
from navierstokes_tpu_torch.parallel.sharded import build_scatter_transpose
from navierstokes_tpu_torch.utils.segment import padded_row_sum, take_rows


def _ceil_div(a, b):
    return -(-a // b)


def _partition_nodes(cell_nodes_pad, chunk_c, n_nodes, n_dev):
    """Cell-partition-aligned node ownership + permuted numbering.

    The space's numbering is class-major (vertices, then edge midpoints),
    so contiguous ranges straddle both classes and a cell-aligned
    partition would see most touched nodes as halo.  Instead a node is
    owned by the FIRST shard (in Morton cell order) whose cells touch it;
    nodes are renumbered owner-major (old order within a shard) and each
    shard's count padded to the largest.

    Returns (new_id (n_nodes,), chunk_n, old_of_new (n_dev*chunk_n,) with
    -1 at padding slots).
    """
    owner = np.full(n_nodes, -1, dtype=np.int64)
    for d in reversed(range(n_dev)):
        cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
        owner[np.unique(cn)] = d
    owner[owner < 0] = 0
    counts = np.bincount(owner, minlength=n_dev)
    chunk_n = max(int(counts.max()), 1)
    new_id = np.empty(n_nodes, dtype=np.int64)
    old_of_new = np.full(n_dev * chunk_n, -1, dtype=np.int64)
    for d in range(n_dev):
        idx = np.nonzero(owner == d)[0]
        new_id[idx] = d * chunk_n + np.arange(len(idx))
        old_of_new[d * chunk_n:d * chunk_n + len(idx)] = idx
    return new_id, chunk_n, old_of_new


class _HaloPlan:
    """Exchange plan for one node set (velocity or pressure).

    Host attributes (NumPy, per shard d stacked on axis 0, as the JAX
    plan's arrays):
      cell_nodes_local: (n_dev, chunk_c, nloc) int32 into [own | halo | pad]
      tables:           (n_dev, n_local, K) transpose-gather tables
      offsets:          list of active partner offsets k (owner - needer)
      send_idx[k]:      (n_dev, H_k) int32 own-chunk indices to ship to d-k
                        (padded entries point at the zero row ``chunk_n``)
      halo_sizes[k]:    H_k
    and the same index arrays on each shard's device.  ``bytes_moved``
    counts the bytes of the halo buffers exchanged between shards.
    """

    def __init__(self, cell_nodes_pad, cells_per_dev, chunk_n, mesh):
        chunk_c = cells_per_dev
        n_dev = len(mesh)
        self.mesh = mesh
        self.chunk_n = chunk_n
        self.n_dev = n_dev
        nloc = cell_nodes_pad.shape[1]

        def owner(nodes):
            return np.minimum(nodes // chunk_n, n_dev - 1)

        # halo requirements per shard
        needs = []
        for d in range(n_dev):
            cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
            need = np.unique(cn)
            needs.append(need[owner(need) != d])

        # active offsets k = owner - needer (global union)
        offs = set()
        halo_by_offset = []       # per shard: {k: sorted node array}
        for d in range(n_dev):
            by_k = {}
            if len(needs[d]):
                own = owner(needs[d])
                for e in np.unique(own):
                    k = int(e) - d
                    by_k[k] = np.sort(needs[d][own == e])
                    offs.add(k)
            halo_by_offset.append(by_k)
        self.offsets = sorted(offs)

        # per-offset send tables (stored at the OWNER, ordered like the
        # needer's receive buffer) + halo sizes
        self.halo_sizes = {}
        self.send_idx = {}
        for k in self.offsets:
            H = max((len(halo_by_offset[d].get(k, ()))
                     for d in range(n_dev)), default=0)
            H = max(H, 1)
            self.halo_sizes[k] = H
            sidx = np.full((n_dev, H), chunk_n, dtype=np.int32)  # zero row
            for e in range(n_dev):       # e = owner, needer d = e - k
                d = e - k
                if 0 <= d < n_dev:
                    nodes = halo_by_offset[d].get(k, np.zeros(0, np.int64))
                    sidx[e, :len(nodes)] = (nodes - e * chunk_n).astype(
                        np.int32)
            self.send_idx[k] = sidx

        # local index map per shard: own range, then halo blocks in
        # offset order, each in the needer's sorted receive order
        n_halo_total = sum(self.halo_sizes.values())
        self.n_local = chunk_n + n_halo_total
        cn_local = np.zeros((n_dev, chunk_c, nloc), dtype=np.int32)
        for d in range(n_dev):
            lmap = {}
            base = chunk_n
            for k in self.offsets:
                nodes = halo_by_offset[d].get(k, np.zeros(0, np.int64))
                for j, g in enumerate(nodes):
                    lmap[int(g)] = base + j
                base += self.halo_sizes[k]
            cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
            lo = d * chunk_n
            local = np.where((cn >= lo) & (cn < lo + chunk_n), cn - lo, -1)
            miss = local < 0
            if miss.any():
                local[miss] = [lmap[int(g)] for g in cn[miss]]
            cn_local[d] = local
        self.cell_nodes_local = cn_local

        # per-shard transpose-gather tables over the local slot space
        tabs, K = [], 0
        for d in range(n_dev):
            _, k_ = build_scatter_transpose(cn_local[d], self.n_local)
            K = max(K, k_)
        for d in range(n_dev):
            t, _ = build_scatter_transpose(cn_local[d], self.n_local, K)
            tabs.append(t)
        self.tables = np.stack(tabs)

        def on(d, a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=mesh.devices[d])

        self.cell_nodes_dev = [on(d, cn_local[d]) for d in range(n_dev)]
        self.tables_dev = [on(d, self.tables[d]) for d in range(n_dev)]
        self.send_dev = {k: [on(d, self.send_idx[k][d])
                             for d in range(n_dev)] for k in self.offsets}
        self.bytes_moved = 0

    # -- the exchanges ------------------------------------------------------
    def _count(self, buf, n_pairs):
        self.bytes_moved += n_pairs * buf.numel() * buf.element_size()

    def gather(self, own):
        """own: per shard (chunk_n, w) -> per shard (n_local, w): the own
        values followed by the received halo blocks."""
        n, mesh = self.n_dev, self.mesh
        ext = [torch.cat([o, o.new_zeros((1,) + o.shape[1:])]) for o in own]
        parts = [[o] for o in own]
        for k in self.offsets:
            perm = [(e, e - k) for e in range(n) if 0 <= e - k < n]
            bufs = [None] * n
            for e, _ in perm:
                bufs[e] = take_rows(ext[e], self.send_dev[k][e])
            recv = ppermute(bufs, perm, mesh)
            self._count(recv[perm[0][1]], len(perm))
            for d in range(n):
                parts[d].append(recv[d])
        return [torch.cat(p) for p in parts]

    def scatter_back(self, acc):
        """acc: per shard (n_local, w) -> per shard (chunk_n, w): the halo
        contributions returned to their owners and added."""
        n, mesh = self.n_dev, self.mesh
        own = [torch.cat([a[:self.chunk_n],
                          a.new_zeros((1,) + a.shape[1:])]) for a in acc]
        base = self.chunk_n
        for k in self.offsets:
            H = self.halo_sizes[k]
            perm = [(d, d + k) for d in range(n) if 0 <= d + k < n]
            bufs = [None] * n
            for d, _ in perm:
                bufs[d] = acc[d][base:base + H]
            back = ppermute(bufs, perm, mesh)
            self._count(bufs[perm[0][0]], len(perm))
            for _, e in perm:
                own[e] = own[e].index_add(0, self.send_dev[k][e], back[e])
            base += H
        return [o[:self.chunk_n] for o in own]


class HaloCellOperator:
    """Dof-partitioned Taylor-Hood operators.

    The factory API of :class:`~navierstokes_tpu_torch.parallel.sharded.
    ShardedCellOperator`, on :class:`~navierstokes_tpu_torch.parallel.comm.
    Sharded` vectors in the partitioned numbering: no replication, no
    full-length sum.  ``mesh`` is a :class:`~navierstokes_tpu_torch.
    parallel.comm.DeviceMesh` or a plain sequence of devices; ``dtype``
    defaults to ``config.default_dtype`` of shard 0's device.
    """

    def __init__(self, space, mesh, axis="shard", *, dtype=None):
        mesh = as_mesh(mesh, axis)
        self.space = space
        self.mesh = mesh
        self.axis = mesh.axis
        n_dev = len(mesh)
        self.n_dev = n_dev
        self.device = mesh.devices[0]
        self.dtype = dt = config.resolve_dtype(dtype, self.device)
        np_dt = config.numpy_dtype(dt)
        dim = space.dim
        self.dim = dim

        nc = space.mesh.n_cells
        chunk_c = _ceil_div(nc, n_dev)
        n_pad_c = chunk_c * n_dev - nc
        self.chunk_c = chunk_c

        from navierstokes_tpu_torch.fem.spaces import _morton_order

        centroids = space.mesh.points[space.mesh.cells].mean(axis=1)
        cell_order = _morton_order(centroids)
        self.cell_order = cell_order

        W = np.asarray(space.integration_weights(), dtype=np_dt)[cell_order]
        Jinv = np.asarray(space.Jinv_q, dtype=np_dt)[cell_order]
        cu = np.asarray(space.cell_unodes, dtype=np.int64)[cell_order]
        cp_ = np.asarray(space.cell_pnodes, dtype=np.int64)[cell_order]

        if n_pad_c:
            W = np.concatenate([W, np.zeros((n_pad_c,) + W.shape[1:],
                                            W.dtype)])
            Jinv = np.concatenate(
                [Jinv, np.repeat(Jinv[:1], n_pad_c, 0)])
            cu = np.concatenate([cu, np.repeat(cu[:1], n_pad_c, 0)])
            cp_ = np.concatenate([cp_, np.repeat(cp_[:1], n_pad_c, 0)])

        # partition-aligned ownership + owner-major renumbering (the
        # permuted, padded layout the vectors live in)
        self._u_new_id, self.chunk_u, self._u_old_of_new = _partition_nodes(
            cu, chunk_c, space.n_unodes, n_dev)
        self._p_new_id, self.chunk_p, self._p_old_of_new = _partition_nodes(
            cp_, chunk_c, space.n_pnodes, n_dev)
        self.nu_pad = self.chunk_u * n_dev
        self.np_pad = self.chunk_p * n_dev
        cu = self._u_new_id[cu]
        cp_ = self._p_new_id[cp_]
        if n_pad_c:
            # padded cells: zero weight, nodes pinned inside the range of
            # the shard that owns them (no spurious halo traffic)
            pad_dev = (np.arange(nc, nc + n_pad_c) // chunk_c)
            cu[nc:] = (pad_dev * self.chunk_u)[:, None]
            cp_[nc:] = (pad_dev * self.chunk_p)[:, None]

        # element matrices (cell-ordered, padded)
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2), Jinv)
        g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1), Jinv)
        N2h, N1h = np.asarray(space.N2), np.asarray(space.N1)
        M_ch = np.einsum("cq,qi,qj->cij", W, N2h, N2h)
        K_ch = np.einsum("cq,cqie,cqje->cij", W, g2, g2)
        KP_ch = np.einsum("cq,cqje,cqke->cjk", W, g1, g1)
        G_ch = -np.einsum("cq,qj,cqid->cidj", W, N1h, g2)

        # assembled Jacobi diagonals in the partitioned (padded)
        # numbering; padded cells carry zero weight, so their slots stay 0
        diag_m = np.zeros(self.nu_pad)
        diag_k = np.zeros(self.nu_pad)
        diag_l = np.zeros(self.np_pad)
        np.add.at(diag_m, cu.ravel(), np.einsum("cii->ci", M_ch).ravel())
        np.add.at(diag_k, cu.ravel(), np.einsum("cii->ci", K_ch).ravel())
        np.add.at(diag_l, cp_.ravel(), np.einsum("cjj->cj", KP_ch).ravel())
        self._diag_host = (diag_m, diag_k, diag_l)

        self.u_plan = _HaloPlan(cu, chunk_c, self.chunk_u, mesh)
        self.p_plan = _HaloPlan(cp_, chunk_c, self.chunk_p, mesh)

        # per-shard element data on the shard's device
        n2, n1 = G_ch.shape[1], G_ch.shape[3]
        self._elem = []
        for d in range(n_dev):
            dev = mesh.devices[d]
            cells = slice(d * chunk_c, (d + 1) * chunk_c)

            def f(a):
                return torch.as_tensor(np.asarray(a[cells], dtype=np_dt),
                                       device=dev)

            G = f(G_ch)
            G_flat = G.reshape(chunk_c, n2 * dim, n1)
            self._elem.append(dict(
                M=f(M_ch), K=f(K_ch), KP=f(KP_ch), G_flat=G_flat,
                D_flat=G_flat.transpose(1, 2).contiguous(), W=f(W),
                g2=f(g2), N2=torch.as_tensor(np.asarray(N2h, np_dt),
                                             device=dev)))
        self._helm_cache = None

        dev0 = self.device
        self._u_gather = torch.as_tensor(
            np.where(self._u_old_of_new < 0, space.n_unodes,
                     self._u_old_of_new), device=dev0)
        self._p_gather = torch.as_tensor(
            np.where(self._p_old_of_new < 0, space.n_pnodes,
                     self._p_old_of_new), device=dev0)
        self._u_new_id_dev = torch.as_tensor(self._u_new_id, device=dev0)
        self._p_new_id_dev = torch.as_tensor(self._p_new_id, device=dev0)

    # -- vector layout conversion -------------------------------------------
    def _split(self, full, chunk):
        """(n_dev * chunk, ...) on shard 0's device -> Sharded blocks."""
        return Sharded(full[d * chunk:(d + 1) * chunk].reshape(-1).to(
            self.mesh.devices[d], non_blocking=True)
            for d in range(self.n_dev))

    def _join(self, x: Sharded):
        return torch.cat([p.to(self.device, non_blocking=True) for p in x])

    def pad_velocity(self, u_flat):
        """(n_unodes*dim,) space layout -> Sharded partitioned blocks."""
        u = u_flat.to(self.device).reshape(self.space.n_unodes, self.dim)
        ext = torch.cat([u, u.new_zeros((1, self.dim))])
        return self._split(take_rows(ext, self._u_gather), self.chunk_u)

    def unpad_velocity(self, u: Sharded):
        full = self._join(u).reshape(self.nu_pad, self.dim)
        return take_rows(full, self._u_new_id_dev).reshape(-1)

    def pad_pressure(self, p):
        p = p.to(self.device)
        ext = torch.cat([p, p.new_zeros(1)])
        return self._split(ext[self._p_gather], self.chunk_p)

    def unpad_pressure(self, p: Sharded):
        return self._join(p)[self._p_new_id_dev]

    # -- the shard-local sweep ----------------------------------------------
    def _apply(self, x: Sharded, in_plan, out_plan, width, kernel):
        """Gather ``x``'s own values and halo, apply ``kernel(d, cells)``
        per shard ((chunk_c, nloc_in, w_in) -> (chunk_c, nloc_out, w)),
        sum into the local slots and return the halo contributions."""
        w_in = self.dim if in_plan is self.u_plan else 1
        full = in_plan.gather([v.reshape(in_plan.chunk_n, w_in) for v in x])
        acc = []
        for d in range(self.n_dev):
            r_c = kernel(d, take_rows(full[d], in_plan.cell_nodes_dev[d]))
            acc.append(padded_row_sum(out_plan.tables_dev[d],
                                      r_c.reshape(-1, width)))
        return Sharded(o.reshape(-1) for o in out_plan.scatter_back(acc))

    # -- operators -----------------------------------------------------------
    def make_velocity_mass(self):
        def mass(u):
            return self._apply(u, self.u_plan, self.u_plan, self.dim,
                               lambda d, u_c: torch.bmm(self._elem[d]["M"],
                                                        u_c))

        return mass

    def _helmholtz_cells(self, visc, accel0):
        """accel0 M_c + visc K_c per shard, kept for the last accel0."""
        key = (float(visc), float(accel0))
        if self._helm_cache is None or self._helm_cache[0] != key:
            self._helm_cache = (key, [accel0 * e["M"] + visc * e["K"]
                                      for e in self._elem])
        return self._helm_cache[1]

    def make_velocity_helmholtz(self, visc):
        def helm(u, accel0):
            A = self._helmholtz_cells(visc, accel0)
            return self._apply(u, self.u_plan, self.u_plan, self.dim,
                               lambda d, u_c: torch.bmm(A[d], u_c))

        return helm

    def make_gradient(self):
        """p (partitioned) -> velocity image (partitioned)."""
        n2 = self._elem[0]["G_flat"].shape[1] // self.dim

        def kernel(d, p_c):
            r_c = torch.bmm(self._elem[d]["G_flat"], p_c)
            return r_c.reshape(-1, n2, self.dim)

        def grad(p):
            return self._apply(p, self.p_plan, self.u_plan, self.dim,
                               kernel)

        return grad

    def make_divergence(self):
        def kernel(d, u_c):
            D = self._elem[d]["D_flat"]
            return torch.bmm(D, u_c.reshape(D.shape[0], -1, 1))

        def div(u):
            return self._apply(u, self.u_plan, self.p_plan, 1, kernel)

        return div

    def make_pressure_stiffness(self):
        def stiff(p):
            return self._apply(p, self.p_plan, self.p_plan, 1,
                               lambda d, p_c: torch.bmm(self._elem[d]["KP"],
                                                        p_c))

        return stiff

    def make_convection_rhs(self, cc):
        """u -> b_i = int(cc (u.grad)u . N_i), by quadrature."""
        cc = float(cc)

        def kernel(d, u_c):
            e = self._elem[d]
            u_q = torch.einsum("qi,cid->cqd", e["N2"], u_c)
            grad_u = torch.einsum("cid,cqie->cqde", u_c, e["g2"])
            adv = cc * torch.einsum("cqde,cqe->cqd", grad_u, u_q)
            return torch.einsum("cq,cqd,qi->cid", e["W"], adv, e["N2"])

        def conv(u):
            return self._apply(u, self.u_plan, self.u_plan, self.dim,
                               kernel)

        return conv

    def diagonals(self):
        """Assembled Jacobi diagonals in the partitioned layout (velocity
        per interleaved component); padding slots hold 0."""
        dm, dk, dl = self._diag_host

        def sharded(a, chunk):
            return self._split(torch.as_tensor(a, device=self.device)
                               .to(self.dtype), chunk)

        cu = self.chunk_u * self.dim
        return (sharded(np.repeat(dm, self.dim), cu),
                sharded(np.repeat(dk, self.dim), cu),
                sharded(dl, self.chunk_p))

    # -- diagnostics ---------------------------------------------------------
    @property
    def halo_bytes(self):
        """Bytes of halo buffers exchanged between shards so far (both
        plans, both directions)."""
        return self.u_plan.bytes_moved + self.p_plan.bytes_moved

    def halo_report(self) -> dict:
        """Per-shard memory / halo statistics (the weak-scaling table)."""
        return {
            "n_devices": self.n_dev,
            "u_nodes_per_device": self.u_plan.chunk_n,
            "u_halo_per_device": self.u_plan.n_local - self.u_plan.chunk_n,
            "p_nodes_per_device": self.p_plan.chunk_n,
            "p_halo_per_device": self.p_plan.n_local - self.p_plan.chunk_n,
            "active_offsets_u": list(self.u_plan.offsets),
            "active_offsets_p": list(self.p_plan.offsets),
        }
