"""Reference simplex elements and quadrature.

Counterpart of ``navierstokes_tpu/fem/elements.py``.  Shape functions and
gradients for Lagrange P1/P2 on triangles and tetrahedra, tabulated once
at quadrature points as dense NumPy tables -- identical to the JAX
package's (pure NumPy on both sides).

Quadrature: conical-product (Duffy) Gauss rules built from Gauss-Legendre x
Gauss-Jacobi nodes, exact to any requested polynomial degree on the
reference simplex.
"""

from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi

# ---------------------------------------------------------------------------
# quadrature
# ---------------------------------------------------------------------------


def _gauss_legendre01(n):
    """n-point Gauss-Legendre on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _gauss_jacobi01(n, alpha):
    """n-point Gauss-Jacobi with weight (1-x)^alpha, mapped to [0, 1]."""
    x, w = roots_jacobi(n, alpha, 0.0)
    return 0.5 * (x + 1.0), w / 2.0 ** (alpha + 1)


def triangle_quadrature(degree: int):
    """Points/weights on the reference triangle {x,y>=0, x+y<=1}.

    Conical product rule with n = ceil((degree+1)/2) points per direction;
    exact for polynomials of total degree ``degree``.  Weights sum to 1/2.
    """
    n = max(1, (int(degree) + 2) // 2)
    xa, wa = _gauss_jacobi01(n, 1.0)   # radial, absorbs the (1-x) Jacobian
    xb, wb = _gauss_legendre01(n)
    pts, wts = [], []
    for a, w1 in zip(xa, wa):
        for b, w2 in zip(xb, wb):
            pts.append((a, (1.0 - a) * b))
            wts.append(w1 * w2)
    return np.array(pts), np.array(wts)


def tetrahedron_quadrature(degree: int):
    """Points/weights on the reference tetrahedron; weights sum to 1/6."""
    n = max(1, (int(degree) + 2) // 2)
    xa, wa = _gauss_jacobi01(n, 2.0)
    xb, wb = _gauss_jacobi01(n, 1.0)
    xc, wc = _gauss_legendre01(n)
    pts, wts = [], []
    for a, w1 in zip(xa, wa):
        for b, w2 in zip(xb, wb):
            for c, w3 in zip(xc, wc):
                x = a
                y = (1.0 - a) * b
                z = (1.0 - a) * (1.0 - b) * c
                pts.append((x, y, z))
                wts.append(w1 * w2 * w3)
    return np.array(pts), np.array(wts)


def interval_quadrature(degree: int):
    """Gauss-Legendre on [0, 1] for facet (edge) integrals in 2D."""
    n = max(1, (int(degree) + 2) // 2)
    return _gauss_legendre01(n)


def simplex_quadrature(dim: int, degree: int):
    if dim == 2:
        return triangle_quadrature(degree)
    if dim == 3:
        return tetrahedron_quadrature(degree)
    raise ValueError(f"unsupported dimension {dim}")


# ---------------------------------------------------------------------------
# Lagrange shape functions (barycentric formulation)
# ---------------------------------------------------------------------------
#
# Node ordering conventions (must match fem.spaces dof numbering):
#   P1 triangle: nodes 0..2 at vertices.
#   P2 triangle: nodes 0..2 at vertices, node 3+i at the midpoint of the
#                edge OPPOSITE vertex i (edge i = mesh.core facet i).
#   P1 tet: nodes 0..3 at vertices.
#   P2 tet: nodes 0..3 at vertices, node 4+e at the midpoint of edge e in
#           the lexicographic pair order of mesh.core._edge_local_indices.


def _barycentric(points: np.ndarray, dim: int):
    """lambda_0..lambda_dim and their constant gradients w.r.t. ref coords."""
    lam = np.concatenate(
        [1.0 - points.sum(axis=1, keepdims=True), points], axis=1)
    grad = np.zeros((dim + 1, dim))
    grad[0, :] = -1.0
    grad[1:, :] = np.eye(dim)
    return lam, grad


def _triangle_edge_pairs():
    # edge i opposite vertex i (mesh.core._edge_local_indices for triangles)
    return [(1, 2), (0, 2), (0, 1)]


def _tet_edge_pairs():
    import itertools
    return list(itertools.combinations(range(4), 2))


def tabulate_p1(points: np.ndarray, dim: int):
    """(N (nq, dim+1), dN (nq, dim+1, dim)) for linear Lagrange."""
    lam, grad = _barycentric(points, dim)
    N = lam
    dN = np.broadcast_to(grad, (len(points), dim + 1, dim)).copy()
    return N, dN


def tabulate_p2(points: np.ndarray, dim: int):
    """(N (nq, nn), dN (nq, nn, dim)) for quadratic Lagrange."""
    lam, grad = _barycentric(points, dim)
    pairs = _triangle_edge_pairs() if dim == 2 else _tet_edge_pairs()
    nn = (dim + 1) + len(pairs)
    nq = len(points)
    N = np.empty((nq, nn))
    dN = np.empty((nq, nn, dim))
    for i in range(dim + 1):
        N[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dN[:, i, :] = (4.0 * lam[:, i, None] - 1.0) * grad[None, i, :]
    for k, (a, b) in enumerate(pairs):
        j = dim + 1 + k
        N[:, j] = 4.0 * lam[:, a] * lam[:, b]
        dN[:, j, :] = 4.0 * (lam[:, a, None] * grad[None, b, :]
                             + lam[:, b, None] * grad[None, a, :])
    return N, dN


def tabulate(degree: int, points: np.ndarray, dim: int):
    if degree == 1:
        return tabulate_p1(points, dim)
    if degree == 2:
        return tabulate_p2(points, dim)
    raise ValueError(f"unsupported degree {degree}")


def facet_embedding(dim: int, local_facet: int, facet_points: np.ndarray):
    """Map facet reference coordinates into cell reference coordinates.

    2D: facet_points (nq, 1) on [0,1] -> (nq, 2) on the triangle, running
    along facet ``local_facet`` (opposite vertex ``local_facet``) from its
    first to its second vertex in the cell's local ordering.
    3D: facet_points (nq, 2) on the reference triangle -> (nq, 3) on the tet.
    """
    verts = np.concatenate([np.zeros((1, dim)), np.eye(dim)], axis=0)
    if dim == 2:
        locs = _triangle_edge_pairs()[local_facet]
        a, b = verts[locs[0]], verts[locs[1]]
        t = facet_points.reshape(-1, 1)
        return a[None, :] * (1.0 - t) + b[None, :] * t
    face = [j for j in range(4) if j != local_facet]
    a, b, c = verts[face[0]], verts[face[1]], verts[face[2]]
    uv = facet_points
    return (a[None, :] * (1.0 - uv[:, :1] - uv[:, 1:2])
            + b[None, :] * uv[:, :1] + c[None, :] * uv[:, 1:2])
