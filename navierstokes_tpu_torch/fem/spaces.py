"""Taylor-Hood mixed function space as flat index arrays.

Counterpart of ``navierstokes_tpu/fem/spaces.py``: host-side NumPy, built
once.  P2 velocity nodes are mesh vertices + edge midpoints, P1 pressure
nodes the vertices; periodic BCs merge slave nodes into master nodes
before numbering.  Mixed dof layout ``[u_0x, u_0y, u_1x, ..., p_0, ...]``.

Ported so far: the constructor (straight cells, optional periodicity),
``split``, quadrature geometry and interpolation.  Boundary snapping,
point evaluation and the facet machinery come with later slices.
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
                 quadrature_degree: int = 6, renumber="morton"):
        self.mesh = mesh
        self.dim = dim = mesh.dim
        self.periodic = list(periodic) if periodic else []
        self.quadrature_degree = quadrature_degree
        nv = mesh.n_vertices

        u_coords_raw = np.concatenate(
            [mesh.points, mesh.points[mesh.edges].mean(axis=1)], axis=0)
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

        # per-quadrature-point P2 geometry from the raw (pre-merge) node
        # coordinates, so wrapped periodic cells stay geometrically local
        X_raw = u_coords_raw[cell_unodes_raw]
        self.cell_ucoords = X_raw
        Jq = np.einsum("qie,cid->cqde", self.G2, X_raw)
        det = np.linalg.det(Jq)
        sign = np.sign(det[:, :1])
        if np.any(det * sign <= 0.0):
            bad = np.unique(np.nonzero(det * sign <= 0.0)[0])[:10]
            raise ValueError(f"tangled isoparametric cells (det J changes "
                             f"sign): cells {bad.tolist()}")
        self.detJ_q = np.abs(det)
        self.Jinv_q = np.linalg.inv(Jq)

    @property
    def pressure_offset(self) -> int:
        return self.n_velocity_dofs

    def split(self, x):
        """(u (n_unodes, dim), p (n_pnodes,)) views of a mixed vector."""
        u = x[:self.n_velocity_dofs].reshape(self.n_unodes, self.dim)
        return u, x[self.n_velocity_dofs:]

    def quad_coords(self) -> np.ndarray:
        """Physical coordinates of the volume quadrature points (nc, nq, d)."""
        return np.einsum("qi,cid->cqd", self.N2, self.cell_ucoords)

    def integration_weights(self) -> np.ndarray:
        """w_q * |det J_c(xi_q)| as an (nc, nq) array."""
        return self.detJ_q * self.quad_weights[None, :]

    def interpolate_velocity(self, fn, t=None) -> np.ndarray:
        """Nodal interpolation of a velocity field onto (n_unodes, dim)."""
        vals = _eval_field(fn, self.u_coords, t, self.dim)
        return np.asarray(vals, dtype=np.float64).reshape(self.n_unodes,
                                                          self.dim)

    def interpolate_pressure(self, fn, t=None) -> np.ndarray:
        """Nodal interpolation of a pressure field onto (n_pnodes,)."""
        vals = _eval_field(fn, self.p_coords, t, None)
        return np.asarray(vals, dtype=np.float64).reshape(self.n_pnodes)


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
