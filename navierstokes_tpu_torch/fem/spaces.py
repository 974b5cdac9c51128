"""Taylor-Hood mixed function space as flat index arrays.

Counterpart of ``navierstokes_tpu/fem/spaces.py``: host-side NumPy, built
once.  P2 velocity nodes are mesh vertices + edge midpoints, P1 pressure
nodes the vertices; periodic BCs merge slave nodes into master nodes
before numbering.  Mixed dof layout ``[u_0x, u_0y, u_1x, ..., p_0, ...]``.

Boundary mid-edge nodes may be snapped onto a curved boundary
(``snap``, or the mesh's ``mesh.snap``): the cells then carry the
isoparametric P2 coordinate map, with per-quadrature-point Jacobians
computed exactly as the JAX package computes them.  Point evaluation
(``eval_pressure``, ``eval_velocity``) locates points by the straight-cell
hull, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from navierstokes_tpu_torch.fem import elements
from navierstokes_tpu_torch.mesh.core import SimplexMesh

_MATCH_DECIMALS = 8


@dataclass
class PeriodicPair:
    """One periodic identification: ``is_slave(x)`` selects constrained
    points, ``mapping(x)`` sends them onto their master images (both
    vectorized over an (n, dim) coordinate array)."""

    is_slave: callable
    mapping: callable


def axis_periodic(axis: int, xmin: float = 0.0, xmax: float = 1.0,
                  tol: float = 1e-9) -> PeriodicPair:
    """Periodicity along a coordinate axis: x[axis]=xmax -> x[axis]=xmin."""

    def is_slave(x):
        return np.abs(x[:, axis] - xmax) < tol

    def mapping(x):
        y = x.copy()
        y[:, axis] -= (xmax - xmin)
        return y

    return PeriodicPair(is_slave, mapping)


def _match_coordinates(coords: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of the row of ``coords`` nearest (within 1e-7) each query row."""
    from scipy.spatial import cKDTree

    dist, found = cKDTree(coords).query(queries)
    bad = dist > 10.0 ** (-_MATCH_DECIMALS + 1)
    if np.any(bad):
        raise ValueError(f"periodic image not found for points "
                         f"{queries[bad][:3]}")
    return found


def merge_periodic_nodes(coords: np.ndarray, periodic) -> np.ndarray:
    """owner[i] = index of the master node of i (i itself if unconstrained)."""
    n = len(coords)
    owner = np.arange(n)
    if not periodic:
        return owner
    target = coords.copy()
    dim = coords.shape[1]
    for _ in range(dim + 1):  # chain mappings through corners/edges
        moved = False
        for pair in periodic:
            mask = pair.is_slave(target)
            if not np.any(mask):
                continue
            mapped = pair.mapping(target[mask])
            if np.allclose(mapped, target[mask]):
                continue
            target[mask] = mapped
            moved = True
        if not moved:
            break
    slave = ~np.all(np.abs(target - coords) < 10.0 ** (-_MATCH_DECIMALS),
                    axis=1)
    if np.any(slave):
        owner[slave] = _match_coordinates(coords, target[slave])
    return owner


def _rank_owners(owner: np.ndarray):
    """(node_map, n_unique, owners): consecutive ranks, slaves share
    their master's rank."""
    unique_owners, ranks = np.unique(owner, return_inverse=True)
    return ranks.astype(np.int32), len(unique_owners), unique_owners


def _morton_order(coords: np.ndarray) -> np.ndarray:
    """Permutation sorting points along a Morton (Z-order) curve."""
    x = coords - coords.min(axis=0)
    scale = x.max(axis=0)
    scale[scale == 0.0] = 1.0
    q = np.minimum((x / scale * 1023.0).astype(np.uint64), 1023)

    def spread(v, dim):
        out = np.zeros_like(v)
        for b in range(10):
            out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(dim * b)
        return out

    dim = coords.shape[1]
    code = np.zeros(len(coords), dtype=np.uint64)
    for a in range(dim):
        code |= spread(q[:, a], dim) << np.uint64(a)
    return np.argsort(code, kind="stable")


def _renumber(order: np.ndarray, coords: np.ndarray, node_map: np.ndarray):
    """Apply a rank order: (reordered coords, remapped node_map)."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return coords[order], inv[node_map].astype(np.int32)


class TaylorHoodSpace:
    """P2/P1 (velocity/pressure) mixed space on a simplex mesh."""

    def __init__(self, mesh: SimplexMesh, periodic=None,
                 quadrature_degree: int = 6, renumber="morton", snap=None):
        self.mesh = mesh
        self.dim = dim = mesh.dim
        self.periodic = list(periodic) if periodic else []
        self.quadrature_degree = quadrature_degree
        nv = mesh.n_vertices

        # raw node sets; boundary mid-edge nodes optionally snapped onto a
        # curved boundary -> isoparametric P2 cells
        edge_mid = mesh.points[mesh.edges].mean(axis=1)
        if snap is None:
            snap = getattr(mesh, "snap", None)
        self.snap = snap
        if snap is not None:
            on_curve, project = snap
            von = np.asarray(on_curve(mesh.points), dtype=bool)
            if dim == 2:
                ext_edge = mesh.exterior_facet_mask
            else:
                # an edge is on the exterior surface iff it belongs to an
                # exterior (boundary) triangle
                ext_f = mesh.facets[mesh.exterior_facet_mask]
                pairs = np.sort(
                    ext_f[:, [[0, 1], [0, 2], [1, 2]]].reshape(-1, 2),
                    axis=1)
                enc = pairs[:, 0].astype(np.int64) * nv + pairs[:, 1]
                eenc = (mesh.edges[:, 0].astype(np.int64) * nv
                        + mesh.edges[:, 1])
                ext_edge = np.isin(eenc, enc)
            emask = von[mesh.edges[:, 0]] & von[mesh.edges[:, 1]] \
                & ext_edge
            if emask.any():
                edge_mid[emask] = project(edge_mid[emask])
        u_coords_raw = np.concatenate([mesh.points, edge_mid], axis=0)
        p_coords_raw = mesh.points
        cell_unodes_raw = np.concatenate(
            [mesh.cells, nv + mesh.cell_edges], axis=1)
        cell_pnodes_raw = mesh.cells

        # periodic merging before numbering
        u_owner = merge_periodic_nodes(u_coords_raw, self.periodic)
        p_owner = merge_periodic_nodes(p_coords_raw, self.periodic)
        self._u_node_map, self.n_unodes, u_keep = _rank_owners(u_owner)
        self._p_node_map, self.n_pnodes, p_keep = _rank_owners(p_owner)
        self.u_coords = u_coords_raw[u_keep]
        self.p_coords = p_coords_raw[p_keep]

        # class-major ranks (vertex nodes, then edge midpoints), Morton
        # order within each class
        self.n_vertex_unodes = self.n_unodes
        if renumber == "morton":
            is_vertex = u_keep < mesh.n_vertices
            self.n_vertex_unodes = int(is_vertex.sum())
            order_v = np.nonzero(is_vertex)[0][
                _morton_order(self.u_coords[is_vertex])]
            order_e = np.nonzero(~is_vertex)[0][
                _morton_order(self.u_coords[~is_vertex])]
            self.u_coords, self._u_node_map = _renumber(
                np.concatenate([order_v, order_e]), self.u_coords,
                self._u_node_map)
            self.p_coords, self._p_node_map = _renumber(
                _morton_order(self.p_coords), self.p_coords,
                self._p_node_map)

        self.cell_unodes = self._u_node_map[cell_unodes_raw]
        self.cell_pnodes = self._p_node_map[cell_pnodes_raw]

        self.n_velocity_dofs = self.n_unodes * dim
        self.n_pressure_dofs = self.n_pnodes
        self.n_dofs = self.n_velocity_dofs + self.n_pressure_dofs

        # affine cell geometry: J[c,d,e] = dx_d/dxi_e
        v = mesh.points[mesh.cells]
        J = np.transpose(v[:, 1:, :] - v[:, :1, :], (0, 2, 1))
        self.detJ = np.linalg.det(J)
        self.Jinv = np.linalg.inv(J)
        self.cell_origin = v[:, 0, :]
        self.J = J

        # tabulated shape functions at the volume quadrature rule
        q, w = elements.simplex_quadrature(dim, quadrature_degree)
        self.quad_points, self.quad_weights = q, w
        self.N2, self.G2 = elements.tabulate(2, q, dim)
        self.N1, self.G1 = elements.tabulate(1, q, dim)

        # isoparametric P2 geometry: x(xi) = sum_i N2_i X_i with the
        # (possibly snapped) raw node coordinates -- exact for straight
        # cells, quadratic on curved-boundary cells.  Raw (pre-merge)
        # coordinates keep wrapped periodic cells geometrically local.
        X_raw = u_coords_raw[cell_unodes_raw]
        self.cell_ucoords = X_raw
        Jq = np.einsum("qie,cid->cqde", self.G2, X_raw)
        det = np.linalg.det(Jq)
        # a cell whose det J changes sign across quadrature points is
        # tangled (a snapped mid-edge node pulled across the opposite
        # edge): integrating |det| there would corrupt the geometry
        sign = np.sign(det[:, :1])
        if np.any(det * sign <= 0.0):
            bad = np.unique(np.nonzero(det * sign <= 0.0)[0])[:10]
            raise ValueError(f"tangled isoparametric cells (det J changes "
                             f"sign): cells {bad.tolist()}")
        self.detJ_q = np.abs(det)
        self.Jinv_q = np.linalg.inv(Jq)

        self._facet_edge_lookup = None

    def velocity_dof(self, node_ranks: np.ndarray,
                     component: int) -> np.ndarray:
        return node_ranks * self.dim + component

    @property
    def pressure_offset(self) -> int:
        return self.n_velocity_dofs

    def split(self, x):
        """(u (n_unodes, dim), p (n_pnodes,)) views of a mixed vector."""
        u = x[:self.n_velocity_dofs].reshape(self.n_unodes, self.dim)
        return u, x[self.n_velocity_dofs:]

    def join(self, u, p):
        """The mixed vector of ``u`` (n_unodes, dim) and ``p``: NumPy for
        NumPy arrays, torch for tensors."""
        if isinstance(u, np.ndarray):
            return np.concatenate([u.reshape(-1), p])
        import torch

        return torch.cat([u.reshape(-1), p])

    def quad_coords(self) -> np.ndarray:
        """Physical coordinates of the volume quadrature points (nc, nq, d)."""
        return np.einsum("qi,cid->cqd", self.N2, self.cell_ucoords)

    def integration_weights(self) -> np.ndarray:
        """w_q * |det J_c(xi_q)| as an (nc, nq) array."""
        return self.detJ_q * self.quad_weights[None, :]

    # -- point evaluation -----------------------------------------------------
    def _locate_cells(self, points):
        """(cell index, barycentric coords) of each query point (host).

        Affine barycentric location; points on curved boundary cells are
        located by the straight-cell hull (adequate for interior and
        on-vertex queries).
        """
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        v0 = self.cell_origin                          # (nc, d)
        # xi = Jinv_affine @ (x - v0); inside iff xi >= 0 and sum(xi) <= 1
        d = pts[:, None, :] - v0[None, :, :]           # (np, nc, d)
        xi = np.einsum("ced,pcd->pce", self.Jinv, d)
        tol = 1e-10
        inside = np.all(xi >= -tol, axis=2) & \
            (xi.sum(axis=2) <= 1.0 + tol)
        cells = np.argmax(inside, axis=1)
        ok = inside[np.arange(len(pts)), cells]
        if not ok.all():
            # fall back to the nearest cell by barycentric violation
            viol = np.maximum(np.maximum(-xi, 0.0).sum(axis=2),
                              np.maximum(xi.sum(axis=2) - 1.0, 0.0))
            cells = np.where(ok, cells, np.argmin(viol, axis=1))
        return cells, xi[np.arange(len(pts)), cells]

    def eval_pressure(self, p, points):
        """Exact P1 interpolation of a pressure vector at physical points
        (a float for one point, an array otherwise)."""
        cells, xi = self._locate_cells(points)
        N1, _ = elements.tabulate(1, xi, self.dim)
        p = _host(p)
        vals = np.einsum("pj,pj->p", N1, p[self.cell_pnodes[cells]])
        return vals if len(vals) > 1 else float(vals[0])

    def eval_velocity(self, u, points):
        """P2 interpolation of a velocity field (n_unodes, dim) at points."""
        cells, xi = self._locate_cells(points)
        N2, _ = elements.tabulate(2, xi, self.dim)
        u = _host(u)
        return np.einsum("pi,pid->pd", N2, u[self.cell_unodes[cells]])

    # -- facet (boundary) machinery ----------------------------------------
    def facet_unodes(self, facet_ids: np.ndarray) -> np.ndarray:
        """Unique velocity node ranks on the given facets (P2 trace)."""
        mesh = self.mesh
        ids = np.asarray(facet_ids)
        verts = mesh.facets[ids].ravel()
        if self.dim == 2:
            mids = mesh.n_vertices + ids           # edge index == facet index
        else:
            mids = mesh.n_vertices + self._facet_edges(ids).ravel()
        nodes = np.concatenate([verts, np.atleast_1d(mids).ravel()])
        return np.unique(self._u_node_map[nodes])

    def facet_pnodes(self, facet_ids: np.ndarray) -> np.ndarray:
        verts = self.mesh.facets[np.asarray(facet_ids)].ravel()
        return np.unique(self._p_node_map[verts])

    def _facet_edges(self, facet_ids: np.ndarray) -> np.ndarray:
        """(nf, 3) edge indices of triangle facets (3D only)."""
        mesh = self.mesh
        if self._facet_edge_lookup is None:
            key = mesh.edges[:, 0].astype(np.int64) * mesh.n_vertices \
                + mesh.edges[:, 1]
            order = np.argsort(key)
            self._facet_edge_lookup = (key[order], order)
        skey, order = self._facet_edge_lookup
        fv = np.sort(mesh.facets[np.asarray(facet_ids)], axis=1)  # (nf, 3)
        pairs = np.stack([fv[:, [0, 1]], fv[:, [0, 2]], fv[:, [1, 2]]],
                         axis=1)
        qkey = pairs[..., 0].astype(np.int64) * mesh.n_vertices \
            + pairs[..., 1]
        pos = np.searchsorted(skey, qkey)
        return order[pos].astype(np.int32)

    def facet_batch(self, facet_ids: np.ndarray, quadrature_degree=None):
        """Precomputed integration data for a set of facets.

        Returns a dict of arrays for boundary assembly: cell (nf,), tables
        selected per facet (N2/G2/N1 at embedded facet quadrature points),
        physical quad coords, scaled weights, outward unit normals.
        """
        deg = quadrature_degree or self.quadrature_degree
        mesh, dim = self.mesh, self.dim
        ids = np.asarray(facet_ids, dtype=np.int64)
        cells = mesh.facet_cell[ids]
        local = mesh.facet_local_index[ids]

        if dim == 2:
            qf, wf = elements.interval_quadrature(deg)
            qf = qf.reshape(-1, 1)
        else:
            qf, wf = elements.triangle_quadrature(deg)
        nqf = len(wf)

        n_local = dim + 1
        N2_tab = np.empty((n_local, nqf, self.N2.shape[1]))
        G2_tab = np.empty((n_local, nqf, self.N2.shape[1], dim))
        N1_tab = np.empty((n_local, nqf, dim + 1))
        for lf in range(n_local):
            emb = elements.facet_embedding(dim, lf, qf)
            N2_tab[lf], G2_tab[lf] = elements.tabulate(2, emb, dim)
            N1_tab[lf], _ = elements.tabulate(1, emb, dim)

        N2_f = N2_tab[local]                               # (nf, nqf, nn2)
        G2_f = G2_tab[local]                               # (nf, nqf, nn2, d)
        X = self.cell_ucoords[cells]                       # (nf, nn2, d)

        # physical quad coords + cell Jacobians at the facet quadrature
        # points through the isoparametric map (exact for straight cells)
        xq = np.einsum("fqi,fid->fqd", N2_f, X)
        Jf = np.einsum("fqie,fid->fqde", G2_f, X)          # (nf, nqf, d, d)
        Jinv_f = np.linalg.inv(Jf)

        straight_normals = mesh.facet_outward_normals(ids)
        if dim == 2:
            # curved-aware facet measure/normals: tangent tau(q) = J_f t_ref
            # with t_ref the reference-edge direction of d(emb)/dq
            t_ref = np.empty((n_local, 1, dim))
            for lf in range(n_local):
                e0 = elements.facet_embedding(dim, lf, np.array([[0.0]]))
                e1 = elements.facet_embedding(dim, lf, np.array([[1.0]]))
                t_ref[lf, 0] = (e1 - e0)[0]
            tau = np.einsum("fqde,fqe->fqd", Jf, t_ref[local])
            ds = np.linalg.norm(tau, axis=-1)              # (nf, nqf)
            weights = (wf[None, :] / wf.sum()) * ds
            normals = np.stack([tau[..., 1], -tau[..., 0]], axis=-1) / \
                ds[..., None]
            # orient outward (match the straight-facet normal)
            sign = np.sign(np.einsum("fqd,fd->fq", normals,
                                     straight_normals))[..., None]
            normals = normals * np.where(sign == 0.0, 1.0, sign)
        else:
            areas = mesh.facet_areas(ids)
            weights = areas[:, None] * (wf[None, :] / wf.sum())
            normals = np.broadcast_to(
                straight_normals[:, None, :], xq.shape).copy()

        return {
            "facet_ids": ids.astype(np.int32),
            "cells": cells.astype(np.int32),
            "local": local.astype(np.int32),
            "N2": N2_f,                 # (nf, nqf, 6|10)
            "G2": G2_f,                 # (nf, nqf, 6|10, dim)
            "N1": N1_tab[local],        # (nf, nqf, 3|4)
            "x": xq,                    # (nf, nqf, dim)
            "weights": weights,         # (nf, nqf)
            "normals": normals,         # (nf, nqf, dim) per-quad unit normals
            "Jinv": Jinv_f,             # (nf, nqf, dim, dim)
        }

    # -- interpolation ------------------------------------------------------
    def interpolate_velocity(self, fn, t=None) -> np.ndarray:
        """Nodal interpolation of a velocity field onto (n_unodes, dim)."""
        vals = _eval_field(fn, self.u_coords, t, self.dim)
        return np.asarray(vals, dtype=np.float64).reshape(self.n_unodes,
                                                          self.dim)

    def interpolate_pressure(self, fn, t=None) -> np.ndarray:
        """Nodal interpolation of a pressure field onto (n_pnodes,)."""
        vals = _eval_field(fn, self.p_coords, t, None)
        return np.asarray(vals, dtype=np.float64).reshape(self.n_pnodes)

    # -- vertex extraction (for visualization output) -----------------------
    def vertex_velocity(self, u) -> np.ndarray:
        """Velocity at mesh vertices (n_vertices, dim), on the host."""
        return _host(u)[self._u_node_map[:self.mesh.n_vertices]]

    def vertex_pressure(self, p) -> np.ndarray:
        """Pressure at mesh vertices (n_vertices,), on the host."""
        return _host(p)[self._p_node_map[:self.mesh.n_vertices]]


def _host(a) -> np.ndarray:
    """A NumPy copy of a tensor (any device) or a view of an array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _eval_field(fn, coords, t, vector_dim):
    """Evaluate a constant / tuple / callable field at coordinates."""
    n = len(coords)
    if callable(fn):
        vals = fn(coords, t) if _accepts_time(fn) else fn(coords)
        vals = np.asarray(vals, dtype=np.float64)
        if vector_dim is not None and vals.shape != (n, vector_dim):
            vals = np.broadcast_to(vals, (n, vector_dim))
        elif vector_dim is None:
            vals = np.broadcast_to(vals.reshape(-1), (n,)) \
                if vals.size in (1, n) else vals
        return vals
    if vector_dim is not None:
        arr = np.asarray(fn, dtype=np.float64).reshape(1, vector_dim)
        return np.broadcast_to(arr, (n, vector_dim))
    return np.full(n, float(fn))


def _accepts_time(fn) -> bool:
    import inspect

    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    required = [p for p in params.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(required) >= 2 or any(p.name in ("t", "time")
                                     for p in params.values())
