"""Mesh generators (``navierstokes_tpu/mesh/generators.py``).

All of the JAX package's generators, returning host NumPy data:

* structured: the axis-aligned rectangle (right-diagonal triangles) and
  box (Kuhn 6-tet subdivision), the unit square and cube built on them,
  the unit cube with opening windows;
* ``spherical_shell``: a structured polar annulus in 2D, and in 3D a
  cube-sphere surface times radial layers, each hexahedron cut into 12
  tetrahedra through its centroid; both carry ``sphere_snap`` on the two
  boundary spheres;
* ``channel_with_cylinder`` (DFG 2D-2, point cloud + Delaunay, with
  ``circle_snap``), ``backward_facing_step`` (two structured blocks) and
  ``blasius_plate`` (a rectangle whose interior facets along the plate are
  marked for an internal no-slip constraint), each returning
  ``(mesh, markers, marker_map)``.

Every array equals the JAX package's: the same construction, the same
seeded cloud and the same ``scipy.spatial.Delaunay``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from navierstokes_tpu_torch.mesh.core import SimplexMesh, merge_markers
from navierstokes_tpu_torch.mesh.markers import (
    HyperCubeBoundaryMarkers,
    SphericalAnnulusBoundaryMarkers,
)

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


def open_hyper_cube(dim, n_points=10, openings=None):
    """Unit hyper cube with re-marked opening windows on its faces.

    ``openings = ((position, center, width), ...)`` with position one of
    left/right/bottom/top/back/front; facets whose vertices all lie within
    the window get ``HyperCubeBoundaryMarkers.opening`` (the tangential
    window test applies on every tangential axis).
    """
    if openings is None:
        return hyper_cube(dim, n_points)

    face_axis_value = {
        "left": (0, 0.0), "right": (0, 1.0),
        "bottom": (1, 0.0), "top": (1, 1.0),
        "back": (2, 0.0), "front": (2, 1.0),
    }
    for position, center, width in openings:
        if position not in face_axis_value:
            raise ValueError(f"unknown face {position!r}")
        if len(center) != dim:
            raise ValueError(f"opening center {center} is not {dim}D")
        if isinstance(width, float) and dim != 2:
            raise ValueError("a scalar opening width needs dim == 2")
        if not isinstance(width, float) and len(width) != dim - 1:
            raise ValueError(f"opening width {width} needs {dim - 1} "
                             "entries")

    mesh, markers = hyper_cube(dim, n_points)
    pieces = [(markers.ids_with_value(v.value), v.value)
              for v in HyperCubeBoundaryMarkers]

    tol = 1.0e-10
    for position, center, width in openings:
        axis, value = face_axis_value[position]
        if axis == 2 and dim != 3:
            raise ValueError(f"face {position!r} needs a 3D cube")
        if isinstance(width, float):
            width = (width,)
        tangential = [a for a in range(dim) if a != axis]
        if not abs(center[axis] - value) < tol:
            raise ValueError("opening center must lie on the named face")

        def in_window(x, axis=axis, value=value, tangential=tangential,
                      center=center, width=width):
            ok = np.abs(x[:, axis] - value) < tol
            for w, a in zip(width, tangential):
                ok &= np.abs(x[:, a] - center[a]) <= w / 2.0 + tol
            return ok

        ids = mesh.mark_exterior_facets(in_window)
        if len(ids) == 0:
            raise ValueError("opening does not cover any boundary facet")
        pieces.append((ids, HyperCubeBoundaryMarkers.opening.value))

    return mesh, merge_markers(pieces)


# ---------------------------------------------------------------------------
# spherical shell
# ---------------------------------------------------------------------------

def spherical_shell(dim, radii, n_points=10):
    """Annular shell mesh; 2D is a structured polar grid.

    Replaces the reference's mshr/CGAL CSG meshing (grid_generator.py:67-108).
    ``n_points`` plays the role of the mshr resolution: the target edge
    length is ``2 * r_outer / n_points``.
    """
    if dim not in (2, 3):
        raise ValueError(f"spherical_shell takes dim 2 or 3, got {dim}")
    ri, ro = (float(r) for r in radii)
    if not 0.0 < ri < ro:
        raise ValueError(f"radii must satisfy 0 < inner < outer, got "
                         f"{radii}")
    if dim == 3:
        return _spherical_shell_3d(ri, ro, n_points)

    h = 2.0 * ro / max(int(n_points), 3)
    n_r = max(2, int(math.ceil((ro - ri) / h)))
    n_t = max(8, int(math.ceil(2.0 * math.pi * (0.5 * (ri + ro)) / h)))

    r = np.linspace(ri, ro, n_r + 1)
    theta = np.linspace(0.0, 2.0 * math.pi, n_t, endpoint=False)
    R, T = np.meshgrid(r, theta, indexing="ij")
    points = np.stack([(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel()],
                      axis=1)

    def vid(i, j):
        return i * n_t + (j % n_t)

    I, J = np.meshgrid(np.arange(n_r), np.arange(n_t), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    cells = np.concatenate([np.stack([v00, v10, v11], axis=1),
                            np.stack([v00, v11, v01], axis=1)], axis=0)
    mesh = SimplexMesh(points, cells)

    inner_ids = mesh.mark_exterior_facets(
        lambda x: np.abs(np.hypot(x[:, 0], x[:, 1]) - ri) < 1e-9 * ro)
    outer_ids = mesh.mark_exterior_facets(
        lambda x: np.abs(np.hypot(x[:, 0], x[:, 1]) - ro) < 1e-9 * ro)
    markers = merge_markers([
        (inner_ids, SphericalAnnulusBoundaryMarkers.interior_boundary.value),
        (outer_ids, SphericalAnnulusBoundaryMarkers.exterior_boundary.value),
    ])
    mesh.snap = sphere_snap(np.zeros(2), (ri, ro), tol=1e-6 * ro)
    return mesh, markers


# ---------------------------------------------------------------------------
# unstructured generators
# ---------------------------------------------------------------------------

def _delaunay_mesh(points, inside_hole=None, min_quality=1e-6):
    """Delaunay-triangulate a planar point cloud, dropping hole/sliver cells."""
    from scipy.spatial import Delaunay

    tri = Delaunay(points)
    cells = tri.simplices.astype(np.int32)
    v = points[cells]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    keep = area > min_quality * np.median(area)
    if inside_hole is not None:
        centroid = v.mean(axis=1)
        keep &= ~inside_hole(centroid)
    cells = cells[keep]
    used = np.unique(cells)
    remap = np.full(len(points), -1, dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return SimplexMesh(points[used], remap[cells])


def sphere_snap(center, radii, tol=None):
    """(on_curve, project) pair for concentric circles/spheres (any dim).

    Points within ``tol`` of ANY of the ``radii`` are snapped radially to
    the nearest one, so the P2 mid-edge nodes of every boundary sphere
    become isoparametric.
    """
    c = np.asarray(center, dtype=float)
    radii = np.sort(np.asarray(radii, dtype=float))
    t = tol if tol is not None else 1e-6 * radii.max()

    def on_curve(x):
        r = np.linalg.norm(x - c[None, :], axis=1)
        return np.min(np.abs(r[:, None] - radii[None, :]), axis=1) < t

    def project(x):
        d = x - c[None, :]
        r = np.linalg.norm(d, axis=1, keepdims=True)
        near = radii[np.argmin(np.abs(r - radii[None, :]), axis=1)]
        return c[None, :] + d / r * near[:, None]

    return on_curve, project


def circle_snap(cx, cy, rad, tol=None):
    """(on_curve, project) pair for isoparametric boundary snapping.

    Passed to ``TaylorHoodSpace`` (directly or via ``mesh.snap``): P2
    mid-edge nodes whose edge endpoints both lie on the circle are
    projected radially onto it, recovering the true curved boundary.
    """
    t = tol if tol is not None else 1e-6 * rad

    def on_curve(x):
        r = np.hypot(x[:, 0] - cx, x[:, 1] - cy)
        return np.abs(r - rad) < t

    def project(x):
        d = np.stack([x[:, 0] - cx, x[:, 1] - cy], axis=1)
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        return np.array([cx, cy])[None, :] + rad * d

    return on_curve, project


def _legacy_stagger() -> bool:
    """``NS_RING_STAGGER=legacy`` rebuilds the old (asymmetric) mesh that
    the legacy states under ``benchmarks/states/`` were computed on;
    the default ``half`` builds the mirror-symmetric one."""
    return os.environ.get("NS_RING_STAGGER", "half") == "legacy"


def channel_with_cylinder(resolution=1.0, curved=True, wake=1.0,
                          length=22.0):
    """DFG 2D-2 cylinder-in-channel benchmark mesh.

    Geometry nondimensionalized by the cylinder diameter: channel
    [0, length] x [0, 4.1], cylinder center (2, 2), diameter 1.  Boundary-
    layer rings around the cylinder + a graded, seeded background cloud,
    Delaunay-triangulated.

    Returns ``(mesh, markers, marker_map)`` with marker names
    inlet / outlet / upper wall / lower wall / cylinder; with ``curved``
    the mesh carries ``mesh.snap = circle_snap(...)`` so the space snaps
    the cylinder's P2 mid-edge nodes onto the circle (isoparametric cells).

    ``wake`` > 1 refines the near wake by that factor; ``length`` is the
    channel length in diameters (22 = the DFG geometry).
    """
    L, H = float(length), 4.1
    cx, cy, rad = 2.0, 2.0, 0.5
    res = float(resolution)
    h_cyl = 0.08 / res      # edge length on the cylinder
    h_far = 0.45 / res      # far-field edge length
    pts = []

    # cylinder boundary + geometric boundary-layer rings.  An even count
    # on the boundary ring puts the front/back stagnation points (angles
    # pi and 0) on mesh vertices.  curved=True: boundary vertices on the
    # true circle (the space snaps the mid-edge nodes onto it);
    # curved=False: a chord-compensated polygon whose chord midpoints lie
    # on the circle.
    n_c = 2 * int(round(math.pi * rad / h_cyl))
    rad_poly = rad if curved else rad / math.cos(math.pi / n_c)
    growth, r_k, h_k = 1.25, rad_poly, h_cyl
    ring_i = 0
    legacy = _legacy_stagger()
    while r_k < 2.6 * rad:
        n_k = n_c if r_k == rad_poly \
            else max(16, int(round(2.0 * math.pi * r_k / h_k)))
        ang = np.linspace(0.0, 2.0 * math.pi, n_k, endpoint=False)
        # alternate rings staggered by half a step (both phases keep each
        # ring mirror-symmetric about the horizontal axis through the
        # cylinder center); legacy: the old rotation by 0.5 (r_k - rad)
        if legacy:
            ang += 0.5 * (r_k - rad)
        elif ring_i % 2 == 1:
            ang += math.pi / n_k
        pts.append(np.stack([cx + r_k * np.cos(ang),
                             cy + r_k * np.sin(ang)], axis=1))
        h_k *= growth
        r_k += h_k
        ring_i += 1

    # background cloud: spacing grows with distance from the cylinder,
    # refined wake corridor behind it; ``wake`` > 1 refines the near wake
    def local_h(xy):
        d = np.hypot(xy[:, 0] - cx, xy[:, 1] - cy) - rad
        h = np.minimum(h_far, 0.12 / res + 0.12 * np.maximum(d, 0.0))
        corridor = (xy[:, 0] > cx) & (np.abs(xy[:, 1] - cy) < 1.2)
        h = np.where(corridor & (xy[:, 0] < cx + 12.0),
                     np.minimum(h, 0.22 / res), h)
        if wake > 1.0:
            ramp = np.clip((cx + 8.0 - xy[:, 0]) / 4.0, 0.0, 1.0)
            eff = 1.0 + (wake - 1.0) * ramp
            near = corridor & (np.abs(xy[:, 1] - cy) < 1.1)
            h = np.where(near, np.minimum(h, 0.22 / (res * eff)), h)
        return h

    # rejection-sampled jittered grid honoring local_h (the JAX package's
    # seed, so the cloud is the same point for point)
    rng = np.random.default_rng(20260816)
    base_h = 0.12 / res
    xs = np.arange(0.0, L + base_h, base_h)
    ys = np.arange(0.0, H + base_h, base_h)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    cand = np.stack([X.ravel(), Y.ravel()], axis=1)
    cand += rng.uniform(-0.25, 0.25, cand.shape) * base_h
    cand[:, 0] = np.clip(cand[:, 0], 0.0, L)
    cand[:, 1] = np.clip(cand[:, 1], 0.0, H)
    hloc = local_h(cand)
    accept = rng.random(len(cand)) < (base_h / hloc) ** 2
    cand = cand[accept]
    if wake > 1.0:
        # secondary candidate grid in the near-wake box: add the density
        # 1/h^2 - 1/base_h^2 the primary grid cannot reach
        bh2 = 0.12 / (res * wake)
        xs2 = np.arange(cx, cx + 8.0 + bh2, bh2)
        ys2 = np.arange(cy - 1.15, cy + 1.15 + bh2, bh2)
        X2, Y2 = np.meshgrid(xs2, ys2, indexing="ij")
        cand2 = np.stack([X2.ravel(), Y2.ravel()], axis=1)
        cand2 += rng.uniform(-0.25, 0.25, cand2.shape) * bh2
        cand2[:, 1] = np.clip(cand2[:, 1], 0.0, H)
        h2 = local_h(cand2)
        p2 = (bh2 / h2) ** 2 - (bh2 / base_h) ** 2
        cand2 = cand2[rng.random(len(cand2)) < p2]
        cand = np.concatenate([cand, cand2])
    # keep clear of the cylinder + rings and the walls
    d_c = np.hypot(cand[:, 0] - cx, cand[:, 1] - cy)
    cand = cand[d_c > r_k - 0.4 * h_k]
    # mirror-symmetrize the near-cylinder cloud about the horizontal axis
    # through the cylinder center: a reflection-symmetric point set makes
    # the Delaunay triangulation symmetric (up to ties), so mesh-induced
    # spurious lift cancels.  The reflection band stays clear of the
    # walls.
    if not legacy:
        R_sym, Y_bnd = 6.0, 1.55
        d_c = np.hypot(cand[:, 0] - cx, cand[:, 1] - cy)
        near = (d_c < R_sym) & (np.abs(cand[:, 1] - cy) < Y_bnd)
        keep = cand[~near]
        upper_half = cand[near & (cand[:, 1] >= cy)].copy()
        # points hugging the symmetry plane go onto it (a point at cy + eps
        # and its mirror would form a sliver pair).  Carried over as the
        # JAX package has it: the snapped points are not deduplicated.
        snap = upper_half[:, 1] - cy < 0.35 * local_h(upper_half)
        upper_half[snap, 1] = cy
        mirrored = upper_half * np.array([1.0, -1.0]) \
            + np.array([0.0, 2.0 * cy])
        strict = upper_half[:, 1] > cy + 1e-12
        cand = np.concatenate([keep, upper_half, mirrored[strict]])
    interior = ((cand[:, 0] > 0.4 * h_far) & (cand[:, 0] < L - 0.4 * h_far)
                & (cand[:, 1] > 0.4 * base_h) & (cand[:, 1] < H - 0.4 * base_h))
    pts.append(cand[interior])

    # channel boundary points (graded along the walls near the cylinder)
    def wall_points(y):
        t = [0.0]
        x = 0.0
        while x < L:
            h = float(local_h(np.array([[x, y]]))[0])
            x = min(L, x + h)
            t.append(x)
        return np.stack([np.array(t), np.full(len(t), y)], axis=1)

    lower, upper = wall_points(0.0), wall_points(H)
    n_io = int(round(H / (0.28 / res)))
    ysb = np.linspace(0.0, H, n_io + 1)[1:-1]
    inlet = np.stack([np.zeros(len(ysb)), ysb], axis=1)
    outlet = np.stack([np.full(len(ysb), L), ysb], axis=1)
    pts += [lower, upper, inlet, outlet]

    points = np.concatenate(pts, axis=0)
    mesh = _delaunay_mesh(
        points,
        inside_hole=lambda c: np.hypot(c[:, 0] - cx, c[:, 1] - cy) < rad)

    tol = 1e-9 * L
    marker_map = {"inlet": 1, "outlet": 2, "upper wall": 3, "lower wall": 4,
                  "cylinder": 5}
    on_cyl = mesh.mark_exterior_facets(
        lambda x: np.hypot(x[:, 0] - cx, x[:, 1] - cy) < rad + 0.25 * h_cyl)
    markers = merge_markers([
        (mesh.mark_exterior_facets(lambda x: x[:, 0] < tol),
         marker_map["inlet"]),
        (mesh.mark_exterior_facets(lambda x: x[:, 0] > L - tol),
         marker_map["outlet"]),
        (mesh.mark_exterior_facets(lambda x: x[:, 1] > H - tol),
         marker_map["upper wall"]),
        (mesh.mark_exterior_facets(lambda x: x[:, 1] < tol),
         marker_map["lower wall"]),
        (on_cyl, marker_map["cylinder"]),
    ])
    if curved:
        mesh.snap = circle_snap(cx, cy, rad, tol=1e-6 * rad)
    return mesh, markers, marker_map


def backward_facing_step(resolution=1.0):
    """Channel with a backward-facing step.

    Inlet channel y in [0.5, 1] (matching the reference demo's inlet profile
    h=0.5, y0=0.5, demo/backward_facing_step.py:23-24), step at x=2,
    expanded channel [2, 12] x [0, 1].  Structured triangulation.

    Returns ``(mesh, markers, marker_map)`` with names inlet/outlet/walls.
    """
    n = max(4, int(round(8 * resolution)))  # cells across the half-height
    h = 0.5 / n
    # union of two structured blocks sharing the interface x=2, y in [0.5,1]
    p1, c1 = _structured_rectangle((0.0, 0.5), (2.0, 1.0),
                                   (int(round(2.0 / h)), n))
    p2, c2 = _structured_rectangle((2.0, 0.0), (12.0, 1.0),
                                   (int(round(10.0 / h)), 2 * n))
    points = np.concatenate([p1, p2], axis=0)
    cells = np.concatenate([c1, c2 + len(p1)], axis=0)
    # merge duplicate points on the shared interface
    rounded = np.round(points, 9)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    cells = inv[cells]
    mesh = SimplexMesh(uniq, cells.astype(np.int32))

    tol = 1e-9
    marker_map = {"inlet": 1, "outlet": 2, "walls": 3}
    inlet = mesh.mark_exterior_facets(lambda x: x[:, 0] < tol)
    outlet = mesh.mark_exterior_facets(lambda x: x[:, 0] > 12.0 - tol)
    everything = mesh.exterior_facet_ids
    walls = np.setdiff1d(everything, np.concatenate([inlet, outlet]))
    markers = merge_markers([(walls, marker_map["walls"]),
                             (inlet, marker_map["inlet"]),
                             (outlet, marker_map["outlet"])])
    return mesh, markers, marker_map


def blasius_plate(resolution=1.0):
    """Zero-thickness flat plate embedded in a free stream.

    Rectangle [-1, 2] x [0, 1] with the plate on the segment
    y = 0.5, x in [0, 1]; interior facets along the plate are marked so a
    no-slip *internal constraint* can pin the velocity there (the reference
    demo applies VelocityBCType.no_slip via set_internal_constraints,
    demo/blasius_flow.py:33-34).

    Returns ``(mesh, markers, marker_map)`` with names
    inlet/outlet/bottom/top/plate.
    """
    n = max(8, int(round(16 * resolution)))  # cells per unit length
    mesh, _ = hyper_rectangle((-1.0, 0.0), (2.0, 1.0), (3 * n, n))

    tol = 1e-9
    marker_map = {"inlet": 1, "outlet": 2, "bottom": 3, "top": 4, "plate": 5}
    inlet = mesh.mark_exterior_facets(lambda x: x[:, 0] < -1.0 + tol)
    outlet = mesh.mark_exterior_facets(lambda x: x[:, 0] > 2.0 - tol)
    bottom = mesh.mark_exterior_facets(lambda x: x[:, 1] < tol)
    top = mesh.mark_exterior_facets(lambda x: x[:, 1] > 1.0 - tol)

    # interior plate facets: both vertices on y=0.5, 0<=x<=1
    fv = mesh.points[mesh.facets]
    on_plate = (np.all(np.abs(fv[:, :, 1] - 0.5) < tol, axis=1)
                & np.all(fv[:, :, 0] > -tol, axis=1)
                & np.all(fv[:, :, 0] < 1.0 + tol, axis=1)
                & ~mesh.exterior_facet_mask)
    plate = np.nonzero(on_plate)[0].astype(np.int32)
    if len(plate) == 0:
        raise ValueError("blasius_plate: no interior facet lies on the "
                         "plate at this resolution")

    markers = merge_markers([(inlet, marker_map["inlet"]),
                             (outlet, marker_map["outlet"]),
                             (bottom, marker_map["bottom"]),
                             (top, marker_map["top"]),
                             (plate, marker_map["plate"])])
    return mesh, markers, marker_map


def _spherical_shell_3d(ri, ro, n_points):
    """3D spherical shell: cube-sphere surface x radial layers.

    Hexahedral cells are tetrahedralized through their centroid (12 tets
    per hex), with every quad face split along the diagonal through its
    lowest-global-index vertex -- a consistent rule, so the mesh is
    conforming.  Replaces the reference's mshr Sphere CSG meshing
    (grid_generator.py:92-95).
    """
    h = 2.0 * ro / max(int(n_points), 3)
    n_face = max(2, int(math.ceil(0.5 * math.pi * ro / h)))
    n_r = max(1, int(math.ceil((ro - ri) / h)))

    # cube-sphere surface directions: 6 faces, deduplicated by direction
    t = np.linspace(-1.0, 1.0, n_face + 1)
    A, B = np.meshgrid(t, t, indexing="ij")
    ones = np.ones_like(A)
    face_grids = [
        np.stack([ones, A, B], axis=-1), np.stack([-ones, A, B], axis=-1),
        np.stack([A, ones, B], axis=-1), np.stack([A, -ones, B], axis=-1),
        np.stack([A, B, ones], axis=-1), np.stack([A, B, -ones], axis=-1),
    ]
    dirs, quads = [], []
    key_to_id = {}
    for grid in face_grids:
        pts = grid.reshape(-1, 3)
        d = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        ids = np.empty(len(d), dtype=np.int64)
        for i, v in enumerate(np.round(d, 9)):
            key = tuple(v)
            if key not in key_to_id:
                key_to_id[key] = len(dirs)
                dirs.append(d[i])
            ids[i] = key_to_id[key]
        ids = ids.reshape(n_face + 1, n_face + 1)
        for i in range(n_face):
            for j in range(n_face):
                quads.append((ids[i, j], ids[i + 1, j],
                              ids[i + 1, j + 1], ids[i, j + 1]))
    dirs = np.asarray(dirs)
    quads = np.asarray(quads, dtype=np.int64)
    n_surf = len(dirs)

    # radial layers of surface points
    radii_levels = np.linspace(ri, ro, n_r + 1)
    points = (radii_levels[:, None, None] * dirs[None, :, :]).reshape(-1, 3)

    def nid(layer, surf):
        return layer * n_surf + surf

    cells = []
    pts_list = [points]
    next_new = len(points)
    for layer in range(n_r):
        for quad in quads:
            bottom = [nid(layer, s) for s in quad]
            top = [nid(layer + 1, s) for s in quad]
            hex_pts = np.concatenate([pts_list[0][bottom],
                                      pts_list[0][top]], axis=0)
            centroid = hex_pts.mean(axis=0)
            c_id = next_new
            pts_list.append(centroid[None, :])
            next_new += 1
            # 6 quad faces of the hex (outward orientation irrelevant)
            b0, b1, b2, b3 = bottom
            t0, t1, t2, t3 = top
            faces = [(b0, b1, b2, b3), (t0, t1, t2, t3),
                     (b0, b1, t1, t0), (b1, b2, t2, t1),
                     (b2, b3, t3, t2), (b3, b0, t0, t3)]
            for f in faces:
                # split along the diagonal through the min-index vertex
                k = int(np.argmin(f))
                a, b, c, d = f[k], f[(k + 1) % 4], f[(k + 2) % 4], \
                    f[(k + 3) % 4]
                cells.append((a, b, c, c_id))
                cells.append((a, c, d, c_id))
    points = np.concatenate(pts_list, axis=0)
    mesh = SimplexMesh(points, np.asarray(cells, dtype=np.int32))

    r_of = np.linalg.norm
    inner_ids = mesh.mark_exterior_facets(
        lambda x: np.abs(r_of(x, axis=1) - ri) < 1e-9 * ro)
    outer_ids = mesh.mark_exterior_facets(
        lambda x: np.abs(r_of(x, axis=1) - ro) < 1e-9 * ro)
    markers = merge_markers([
        (inner_ids, SphericalAnnulusBoundaryMarkers.interior_boundary.value),
        (outer_ids, SphericalAnnulusBoundaryMarkers.exterior_boundary.value),
    ])
    mesh.snap = sphere_snap(np.zeros(3), (ri, ro), tol=1e-6 * ro)
    return mesh, markers
