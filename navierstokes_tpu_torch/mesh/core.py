"""Simplex mesh as flat index arrays (``navierstokes_tpu/mesh/core.py``).

Host-side NumPy, built once.  Conventions as in the JAX package: cells are
positively oriented, local facet ``i`` is opposite local vertex ``i``, and
facet markers live in a :class:`FacetMarkers` companion object.

Facet and edge rows are deduplicated by the g++ helper
(``navierstokes_tpu_torch.native.unique_rows``), as in the JAX package;
:func:`unique_rows` here is its plain NumPy version (packed row keys),
which ``NS_TPU_NO_NATIVE=1`` selects.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from navierstokes_tpu_torch import native


def _facet_local_indices(n_cell_vertices: int) -> np.ndarray:
    """Local vertex index tuples of each facet (facet i opposite vertex i)."""
    n = n_cell_vertices
    return np.array([[j for j in range(n) if j != i] for i in range(n)],
                    dtype=np.int32)


def _edge_local_indices(n_cell_vertices: int) -> np.ndarray:
    """Local vertex index pairs of each cell edge.

    Triangle: edge i is opposite vertex i (matches the facet numbering, so
    P2 edge nodes align with facets).  Tet: the 6 pairs in lexicographic
    order.
    """
    if n_cell_vertices == 3:
        return np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)
    return np.array(list(itertools.combinations(range(n_cell_vertices), 2)),
                    dtype=np.int32)


def unique_rows(rows: np.ndarray):
    """``(unique, inverse, counts)`` of the rows of an (n, w) int array,
    the unique rows in lexicographic order.

    Rows of non-negative entries whose width fits are packed into one
    int64 key each (the order of the keys is the lexicographic order of
    the rows), which sorts several times faster than ``np.unique`` over
    rows and gives the same three arrays."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, w = rows.shape
    base = int(rows.max()) + 1 if n else 1
    if n == 0 or int(rows.min()) < 0 or base ** w >= 2 ** 62:
        uniq, inverse, counts = np.unique(rows, axis=0, return_inverse=True,
                                          return_counts=True)
        return (uniq, inverse.reshape(-1).astype(np.int64),
                counts.astype(np.int64))
    key = rows[:, 0].astype(np.int64)
    for j in range(1, w):
        key = key * base + rows[:, j]
    ukey, inverse, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
    uniq = np.empty((len(ukey), w), dtype=np.int32)
    for j in range(w - 1, -1, -1):
        uniq[:, j] = ukey % base
        ukey = ukey // base
    return uniq, inverse.reshape(-1).astype(np.int64), counts.astype(np.int64)


@dataclass
class FacetMarkers:
    """Marker values on a subset of mesh facets (unmarked facets carry 0)."""

    facet_ids: np.ndarray  # (n_marked,) int32 into the global facet list
    values: np.ndarray     # (n_marked,) int32

    def ids_with_value(self, value: int) -> np.ndarray:
        return self.facet_ids[self.values == int(value)]

    def value_of(self, facet_id: int) -> int:
        hits = np.nonzero(self.facet_ids == facet_id)[0]
        return int(self.values[hits[0]]) if hits.size else 0


class SimplexMesh:
    """Triangular (2D) / tetrahedral (3D) mesh with precomputed topology."""

    def __init__(self, points: np.ndarray, cells: np.ndarray):
        points = np.ascontiguousarray(points, dtype=np.float64)
        cells = np.ascontiguousarray(cells, dtype=np.int32)
        if points.ndim != 2 or points.shape[1] not in (2, 3):
            raise ValueError(f"points must be (n, 2|3), got {points.shape}")
        dim = points.shape[1]
        if cells.ndim != 2 or cells.shape[1] != dim + 1:
            raise ValueError(f"cells must be (n, {dim + 1}), "
                             f"got {cells.shape}")
        self.points = points
        self.cells = cells
        self.dim = dim
        self._orient_cells()
        self._build_topology()

    def _orient_cells(self) -> None:
        """Flip cells with negative Jacobian determinant."""
        v = self.points[self.cells]
        flip = np.linalg.det(v[:, 1:, :] - v[:, :1, :]) < 0.0
        if np.any(flip):
            self.cells[flip, -2], self.cells[flip, -1] = \
                self.cells[flip, -1].copy(), self.cells[flip, -2].copy()

    def _build_topology(self) -> None:
        nc, nv = self.cells.shape
        dim = self.dim

        # facets: unique codim-1 entities
        loc = _facet_local_indices(nv)
        all_facets = self.cells[:, loc].reshape(nc * nv, dim)
        self.facets, inverse, counts = native.unique_rows(
            np.sort(all_facets, axis=1))
        inverse = inverse.reshape(nc, nv)
        self.cell_facets = inverse.astype(np.int32)
        self.facet_counts = counts.astype(np.int32)
        # one adjacent (cell, local facet) per facet: the first occurrence
        first_occurrence = np.full(len(self.facets), -1, dtype=np.int64)
        order = np.arange(nc * nv - 1, -1, -1)
        first_occurrence[inverse.ravel()[order]] = order
        self.facet_cell = (first_occurrence // nv).astype(np.int32)
        self.facet_local_index = (first_occurrence % nv).astype(np.int32)
        self.exterior_facet_mask = counts == 1

        # edges (P2 node numbering)
        if dim == 2:
            self.edges = self.facets
            self.cell_edges = self.cell_facets
        else:
            eloc = _edge_local_indices(nv)
            all_edges = np.sort(
                self.cells[:, eloc].reshape(nc * len(eloc), 2), axis=1)
            self.edges, einv, _ = native.unique_rows(all_edges)
            self.cell_edges = einv.reshape(nc, len(eloc)).astype(np.int32)

        # geometry
        v = self.points[self.cells]
        det = np.linalg.det(v[:, 1:, :] - v[:, :1, :])
        self.cell_volumes = det / (2.0 if dim == 2 else 6.0)
        if not np.all(self.cell_volumes > 0.0):
            raise ValueError("degenerate or inverted cells")
        eloc = _edge_local_indices(nv)
        edge_vec = v[:, eloc[:, 1], :] - v[:, eloc[:, 0], :]
        self.cell_diameters = np.linalg.norm(edge_vec, axis=2).max(axis=1)

        self.n_cells = nc
        self.n_vertices = len(self.points)
        self.n_facets = len(self.facets)
        self.n_edges = len(self.edges)

    def hmin(self) -> float:
        return float(self.cell_diameters.min())

    def hmax(self) -> float:
        return float(self.cell_diameters.max())

    @property
    def exterior_facet_ids(self) -> np.ndarray:
        return np.nonzero(self.exterior_facet_mask)[0].astype(np.int32)

    def facet_midpoints(self, facet_ids=None) -> np.ndarray:
        ids = (np.arange(self.n_facets) if facet_ids is None
               else np.asarray(facet_ids))
        return self.points[self.facets[ids]].mean(axis=1)

    def facet_areas(self, facet_ids=None) -> np.ndarray:
        ids = (np.arange(self.n_facets) if facet_ids is None
               else np.asarray(facet_ids))
        fv = self.points[self.facets[ids]]
        if self.dim == 2:
            return np.linalg.norm(fv[:, 1] - fv[:, 0], axis=1)
        cr = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        return 0.5 * np.linalg.norm(cr, axis=1)

    def facet_outward_normals(self, facet_ids) -> np.ndarray:
        """Unit normals pointing out of the adjacent cell.

        For exterior facets this is the outward boundary normal; for
        interior facets it is the normal seen from ``facet_cell``.
        """
        ids = np.asarray(facet_ids)
        fv = self.points[self.facets[ids]]                 # (nf, dim, dim)
        if self.dim == 2:
            t = fv[:, 1] - fv[:, 0]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        else:
            n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        # orient: away from the opposite vertex of the adjacent cell
        cell = self.facet_cell[ids]
        opp_local = self.facet_local_index[ids]
        opp_vertex = self.points[self.cells[cell, opp_local]]
        centroid = fv.mean(axis=1)
        sign = np.sign(np.einsum("fd,fd->f", n, centroid - opp_vertex))
        return n * sign[:, None]

    def mark_exterior_facets(self, predicate) -> np.ndarray:
        """Exterior facet ids whose vertices ALL satisfy ``predicate(x)``."""
        ext = self.exterior_facet_ids
        fv = self.points[self.facets[ext]]
        ok = predicate(fv.reshape(-1, self.dim)).reshape(fv.shape[:2])
        return ext[np.all(ok, axis=1)]


def merge_markers(pieces) -> FacetMarkers:
    """Combine (facet_ids, value) pairs; later pieces override earlier ones."""
    facet_ids = np.concatenate([np.asarray(ids, dtype=np.int32)
                                for ids, _ in pieces])
    values = np.concatenate([np.full(len(ids), int(val), dtype=np.int32)
                             for ids, val in pieces])
    _, last = np.unique(facet_ids[::-1], return_index=True)
    keep = len(facet_ids) - 1 - last
    keep.sort()
    return FacetMarkers(facet_ids[keep], values[keep])


def extract_all_boundary_markers(mesh: SimplexMesh,
                                 markers: FacetMarkers) -> set:
    """Set of marker values present on *exterior* facets, including the
    implicit 0 of unmarked exterior facets."""
    ext = mesh.exterior_facet_ids
    marked = dict(zip(markers.facet_ids.tolist(), markers.values.tolist()))
    return {marked.get(int(f), 0) for f in ext}


def boundary_normal(mesh: SimplexMesh, markers: FacetMarkers,
                    bndry_id: int) -> tuple:
    """Common outward unit normal of a flat marked boundary.

    Checks (a) all facet normals are parallel and (b) midpoint connection
    vectors are tangential; raises ValueError otherwise.
    """
    ids = markers.ids_with_value(bndry_id)
    ids = ids[mesh.exterior_facet_mask[ids]]
    if len(ids) == 0:
        raise AssertionError("Boundary id is not marked in the mesh")
    normals = mesh.facet_outward_normals(ids)
    midpoints = mesh.facet_midpoints(ids)

    tol = 1.0e3 * np.finfo(np.float64).eps
    n0 = normals[0]
    dots = normals @ n0
    if np.any(dots <= 0.0) or np.any(np.abs(dots - 1.0) > tol):
        raise ValueError("Boundary facets do not share common normal.")
    connections = midpoints - midpoints[0]
    if np.any(np.abs(connections @ n0)
              > tol * (1.0 + np.abs(connections).max())):
        raise ValueError(
            "Midpoint connection vector is not tangential to boundary "
            "facets.")
    return tuple(float(c) for c in n0)
