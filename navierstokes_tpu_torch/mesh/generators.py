"""Structured mesh generators (``navierstokes_tpu/mesh/generators.py``).

The axis-aligned rectangle (right-diagonal triangles) and box (Kuhn
6-tet subdivision) are ported, with the unit square and cube built on
them; the unstructured generators come with a later slice.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.mesh.core import SimplexMesh, merge_markers
from navierstokes_tpu_torch.mesh.markers import HyperCubeBoundaryMarkers

_TOL = 1.0e-10


def _structured_rectangle(first_point, second_point, n_points):
    """Grid points + right-diagonal triangulation of a rectangle."""
    (x0, y0), (x1, y1) = first_point, second_point
    nx, ny = n_points
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    lower = np.stack([v00, v10, v11], axis=1)
    upper = np.stack([v00, v11, v01], axis=1)
    return points, np.concatenate([lower, upper], axis=0)


def _structured_box(first_point, second_point, n_points):
    """Kuhn (6-tet) subdivision of a structured hexahedral grid."""
    (x0, y0, z0), (x1, y1, z1) = first_point, second_point
    nx, ny, nz = n_points
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    # corner index bit order: (di, dj, dk) -> di*4 + dj*2 + dk
    c = [vid(I + di, J + dj, K + dk)
         for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
    # six tets sharing the main diagonal c[0]-c[7]
    tet_corners = [(0, 4, 6, 7), (0, 4, 5, 7), (0, 2, 6, 7),
                   (0, 2, 3, 7), (0, 1, 5, 7), (0, 1, 3, 7)]
    cells = np.concatenate(
        [np.stack([c[a], c[b], c[d], c[e]], axis=1)
         for a, b, d, e in tet_corners], axis=0)
    return points, cells


def _mark_axis_faces(mesh: SimplexMesh, first_point, second_point):
    """Marker pieces for the axis-aligned faces of a rectangle/box."""
    M = HyperCubeBoundaryMarkers
    face_defs = [(0, first_point[0], M.left.value),
                 (0, second_point[0], M.right.value),
                 (1, first_point[1], M.bottom.value),
                 (1, second_point[1], M.top.value)]
    if mesh.dim == 3:
        face_defs += [(2, first_point[2], M.back.value),
                      (2, second_point[2], M.front.value)]
    scale = max(abs(v) for p in (first_point, second_point) for v in p) + 1.0
    pieces = []
    for axis, value, marker in face_defs:
        ids = mesh.mark_exterior_facets(
            lambda x, a=axis, v=value: np.abs(x[:, a] - v) < _TOL * scale)
        pieces.append((ids, marker))
    return pieces


def hyper_rectangle(first_point, second_point, n_points=10):
    """Axis-aligned rectangle/box spanned by two diagonal corner points.

    Returns ``(mesh, facet_markers)`` with HyperCubeBoundaryMarkers face ids.
    """
    first_point = tuple(float(x) for x in first_point)
    second_point = tuple(float(x) for x in second_point)
    dim = len(first_point)
    if dim not in (2, 3) or len(second_point) != dim:
        raise ValueError("hyper_rectangle takes two 2D or two 3D corner "
                         "points")
    if not all(b > a for a, b in zip(first_point, second_point)):
        raise ValueError("second_point must exceed first_point on each axis")
    if isinstance(n_points, int):
        n_points = (n_points,) * dim
    n_points = tuple(int(n) for n in n_points)
    if len(n_points) != dim or not all(n > 0 for n in n_points):
        raise ValueError(f"bad n_points {n_points}")
    build = _structured_rectangle if dim == 2 else _structured_box
    points, cells = build(first_point, second_point, n_points)
    mesh = SimplexMesh(points, cells)
    markers = merge_markers(_mark_axis_faces(mesh, first_point, second_point))
    return mesh, markers


def hyper_cube(dim, n_points=10):
    """Unit square/cube with equidistant resolution."""
    return hyper_rectangle((0.0,) * dim, (1.0,) * dim, n_points)
