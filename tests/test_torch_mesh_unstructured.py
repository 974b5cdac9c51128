"""Port parity: the unstructured and opening generators
(mesh/generators.py).

Host NumPy/SciPy on both sides (the same seeded cloud, the same
``scipy.spatial.Delaunay``), so every array must be EQUAL: points, cells,
facets, edges, markers and the marker map, under both ring staggers of
``channel_with_cylinder`` (``NS_RING_STAGGER``: ``half``, the default
symmetric mesh, and ``legacy``).
"""

import numpy as np
import pytest

from navierstokes_tpu.mesh import generators as jgen
from navierstokes_tpu_torch.mesh import generators as tgen

TOPOLOGY = ("points", "cells", "facets", "edges", "cell_facets",
            "cell_edges", "facet_cell", "exterior_facet_mask")


def _assert_mesh_equal(a, b):
    for key in TOPOLOGY:
        assert np.array_equal(getattr(a, key), getattr(b, key)), key


def _assert_markers_equal(a, b):
    assert np.array_equal(a.facet_ids, b.facet_ids)
    assert np.array_equal(a.values, b.values)


@pytest.mark.parametrize("stagger", ["half", "legacy"])
@pytest.mark.parametrize("res", [0.5, 1.0])
def test_channel_with_cylinder_equal(res, stagger, monkeypatch):
    monkeypatch.setenv("NS_RING_STAGGER", stagger)
    jm, jmk, jmap = jgen.channel_with_cylinder(res)
    tm, tmk, tmap = tgen.channel_with_cylinder(res)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jmk, tmk)
    assert jmap == tmap
    assert set(np.unique(tmk.values)) == set(tmap.values())
    # the mesh carries the snap pair the space picks up
    x = np.random.default_rng(0).standard_normal((40, 2)) + 2.0
    for fj, ft in zip(jm.snap, tm.snap):
        assert np.array_equal(fj(x), ft(x))


def test_symmetric_mesh_is_not_the_legacy_one(monkeypatch):
    a, _, _ = tgen.channel_with_cylinder(1.0)
    monkeypatch.setenv("NS_RING_STAGGER", "legacy")
    b, _, _ = tgen.channel_with_cylinder(1.0)
    assert a.points.shape != b.points.shape \
        or not np.array_equal(a.points, b.points)


@pytest.mark.parametrize("kw", [dict(curved=False), dict(wake=2.0),
                                dict(length=12.0)])
def test_channel_with_cylinder_options_equal(kw):
    jm, jmk, _ = jgen.channel_with_cylinder(0.5, **kw)
    tm, tmk, _ = tgen.channel_with_cylinder(0.5, **kw)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jmk, tmk)
    assert hasattr(tm, "snap") == hasattr(jm, "snap")


@pytest.mark.parametrize("dim, openings", [
    (2, None),
    (2, (("top", (0.5, 1.0), 0.5), ("left", (0.0, 0.25), 0.5))),
    (3, (("front", (0.5, 0.5, 1.0), (0.5, 0.5)),)),
])
def test_open_hyper_cube_equal(dim, openings):
    jm, jmk = jgen.open_hyper_cube(dim, 4, openings)
    tm, tmk = tgen.open_hyper_cube(dim, 4, openings)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jmk, tmk)


def test_open_hyper_cube_refuses_a_window_off_its_face():
    with pytest.raises(ValueError, match="named face"):
        tgen.open_hyper_cube(2, 4, (("top", (0.5, 0.5), 0.5),))


def test_snaps_equal():
    rng = np.random.default_rng(3)
    x2 = rng.standard_normal((64, 2))
    x2[:16] = x2[:16] / np.linalg.norm(x2[:16], axis=1, keepdims=True) * 0.5
    pairs = [(jgen.circle_snap(0.0, 0.0, 0.5),
              tgen.circle_snap(0.0, 0.0, 0.5)),
             (jgen.circle_snap(2.0, 2.0, 0.5, tol=1e-3),
              tgen.circle_snap(2.0, 2.0, 0.5, tol=1e-3)),
             (jgen.sphere_snap(np.zeros(2), (0.5, 1.0)),
              tgen.sphere_snap(np.zeros(2), (0.5, 1.0)))]
    for (jon, jproj), (ton, tproj) in pairs:
        assert np.array_equal(jon(x2), ton(x2))
        assert np.array_equal(jproj(x2), tproj(x2))
    x3 = rng.standard_normal((32, 3))
    jon, jproj = jgen.sphere_snap(np.zeros(3), (0.5, 1.0))
    ton, tproj = tgen.sphere_snap(np.zeros(3), (0.5, 1.0))
    assert np.array_equal(jon(x3), ton(x3))
    assert np.array_equal(jproj(x3), tproj(x3))
    # snapped points lie on the circle
    on, proj = tgen.circle_snap(0.0, 0.0, 0.5)
    assert on(proj(x2)).all()


def test_delaunay_mesh_equal():
    rng = np.random.default_rng(20)
    pts = rng.random((300, 2))

    def hole(c):
        return np.hypot(c[:, 0] - 0.5, c[:, 1] - 0.5) < 0.15

    for kw in ({}, {"inside_hole": hole}):
        _assert_mesh_equal(jgen._delaunay_mesh(pts, **kw),
                           tgen._delaunay_mesh(pts, **kw))
