"""Port parity: the isoparametric P2 space (fem/spaces.py with a boundary
snap) and point evaluation, on the DFG cylinder mesh.

Host NumPy on both sides, so node coordinates, the per-quadrature-point
Jacobian tables (the same ``np.linalg.det`` / ``inv`` on the same arrays)
and the element matrices built from them are EQUAL; point evaluation is
an einsum over located cells, held to 1e-13.
"""

import numpy as np
import pytest

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem import elements as jel
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cwc
from navierstokes_tpu.mesh.core import SimplexMesh as JaxMesh
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem import elements as tel
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import channel_with_cylinder
from navierstokes_tpu_torch.mesh.core import SimplexMesh

TABLES = ("u_coords", "p_coords", "cell_unodes", "cell_pnodes",
          "cell_ucoords", "detJ_q", "Jinv_q", "detJ", "Jinv", "N2", "G2",
          "N1", "G1", "quad_weights")
_SPACES = {}


def _spaces():
    if not _SPACES:
        _SPACES["jax"] = JaxSpace(jax_cwc(1.0)[0])
        _SPACES["torch"] = TaylorHoodSpace(channel_with_cylinder(1.0)[0])
    return _SPACES["jax"], _SPACES["torch"]


@pytest.mark.parametrize("key", TABLES)
def test_snapped_space_tables_equal(key):
    js, ts = _spaces()
    assert np.array_equal(np.asarray(getattr(js, key)),
                          np.asarray(getattr(ts, key))), key


def test_snap_moves_the_cylinder_midpoints():
    """The snapped mid-edge nodes lie on the circle and the curved cells'
    Jacobians vary over the cell; a space without the snap differs."""
    _, ts = _spaces()
    mesh = ts.mesh
    on_curve, _ = mesh.snap
    r = np.hypot(ts.u_coords[:, 0] - 2.0, ts.u_coords[:, 1] - 2.0)
    on_circle = np.abs(r - 0.5) < 1e-12
    assert on_circle.sum() > mesh.points[on_curve(mesh.points)].shape[0]
    curved = np.ptp(ts.detJ_q, axis=1) > 1e-12 * ts.detJ_q.max()
    assert curved.any()
    straight = TaylorHoodSpace(mesh, snap=(lambda x: np.zeros(len(x), bool),
                                           mesh.snap[1]))
    assert not np.array_equal(straight.detJ_q, ts.detJ_q)
    assert np.ptp(straight.detJ_q, axis=1).max() \
        <= 1e-12 * straight.detJ_q.max()


@pytest.mark.parametrize("key", ["M2", "K2", "L1", "M1", "G"])
def test_curved_element_matrices_equal(key):
    """FastTaylorHood's element matrices take the curved tables."""
    js, ts = _spaces()
    assert np.array_equal(jfo.scalar_element_matrices(js)[key],
                          tfo.scalar_element_matrices(ts)[key])


def test_tangled_cell_refused_on_both_sides():
    """A snap that pulls a boundary mid-edge node across the opposite edge
    makes det J change sign: both packages raise ValueError."""
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    cells = np.array([[0, 1, 2]])

    def on_curve(x):
        return np.ones(len(x), bool)

    def project(x):
        return x + np.array([[1.5, 1.5]])

    for mesh_cls, space_cls in ((JaxMesh, JaxSpace),
                                (SimplexMesh, TaylorHoodSpace)):
        with pytest.raises(ValueError, match="tangled"):
            space_cls(mesh_cls(pts, cells), snap=(on_curve, project))


def _points(n=50):
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0.05, 21.95, n), rng.uniform(0.05, 4.05, n)],
                   axis=1)
    # keep them out of the cylinder, and put a few on mesh vertices
    inside = np.hypot(pts[:, 0] - 2.0, pts[:, 1] - 2.0) < 0.55
    pts[inside, 0] += 1.5
    _, ts = _spaces()
    pts[:5] = ts.mesh.points[[0, 10, 20, 30, 40]]
    return pts


def test_eval_velocity_and_pressure_match():
    js, ts = _spaces()
    rng = np.random.default_rng(6)
    u = rng.standard_normal((ts.n_unodes, 2))
    p = rng.standard_normal(ts.n_pnodes)
    pts = _points()
    assert np.abs(ts.eval_velocity(u, pts)
                  - js.eval_velocity(u, pts)).max() <= 1e-13
    assert np.abs(ts.eval_pressure(p, pts)
                  - js.eval_pressure(p, pts)).max() <= 1e-13
    assert ts.eval_pressure(p, pts[:1]) == pytest.approx(
        js.eval_pressure(p, pts[:1]), abs=1e-13)
    # a linear field is reproduced exactly, the vertex value at a vertex
    lin = 0.3 * ts.p_coords[:, 0] - 1.2 * ts.p_coords[:, 1]
    want = 0.3 * pts[:, 0] - 1.2 * pts[:, 1]
    assert np.abs(ts.eval_pressure(lin, pts) - want).max() <= 1e-12


def test_eval_takes_tensors():
    import torch

    _, ts = _spaces()
    u = np.random.default_rng(7).standard_normal((ts.n_unodes, 2))
    pts = _points(8)
    assert np.array_equal(ts.eval_velocity(torch.tensor(u), pts),
                          ts.eval_velocity(u, pts))


@pytest.mark.parametrize("degree, dim", [(1, 2), (2, 2), (1, 3), (2, 3)])
def test_reference_nodes_equal(degree, dim):
    got = tel.reference_nodes(degree, dim)
    assert np.array_equal(got, jel.reference_nodes(degree, dim))
    # the nodal basis is the identity at its own nodes
    N, _ = tel.tabulate(degree, got, dim)
    assert np.allclose(N, np.eye(len(got)), atol=1e-14)
