"""Port parity: mesh and Taylor-Hood space setup, and the package boundary.

The host setup is NumPy on both sides with the same operations in the same
order, so the port must reproduce the JAX package's arrays exactly
(``np.array_equal``), not merely to a tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube, hyper_rectangle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_ATTRS = ("points", "cells", "facets", "cell_facets", "facet_counts",
              "facet_cell", "facet_local_index", "exterior_facet_mask",
              "edges", "cell_edges", "cell_volumes", "cell_diameters",
              "n_cells", "n_vertices", "n_facets", "n_edges")
SPACE_ATTRS = ("n_unodes", "n_pnodes", "n_velocity_dofs", "n_dofs",
               "n_vertex_unodes", "u_coords", "p_coords", "cell_unodes",
               "cell_pnodes", "_u_node_map", "_p_node_map", "detJ", "Jinv",
               "J", "cell_origin", "quad_points", "quad_weights", "N2", "G2",
               "N1", "G1", "cell_ucoords", "detJ_q", "Jinv_q")


def _build(kind, mesh_fn, rect_fn, periodic_fn, space_cls):
    """The fixtures of tests/test_fastop.py, built with one package."""
    if kind == "periodic":
        mesh, markers = mesh_fn(2, 8)
        return mesh, markers, space_cls(
            mesh, periodic=[periodic_fn(0), periodic_fn(1)])
    if kind == "periodic3d":        # the triply periodic Kuhn-tet cube
        mesh, markers = mesh_fn(3, 4)
        return mesh, markers, space_cls(
            mesh, periodic=[periodic_fn(a) for a in range(3)])
    if kind == "box":               # unequal extents and cell counts
        mesh, markers = rect_fn((0.0, -1.0, 0.5), (2.0, 1.0, 1.0), (3, 4, 2))
        return mesh, markers, space_cls(mesh)
    mesh, markers = rect_fn((0.0, 0.0), (2.0, 1.0), (12, 6))
    return mesh, markers, space_cls(mesh)


@pytest.mark.parametrize("kind", ["periodic", "channel", "periodic3d",
                                  "box"])
def test_mesh_and_space_arrays_equal(kind):
    jm, jmk, js = _build(kind, jax_hyper_cube, jax_hyper_rectangle,
                         jax_axis_periodic, JaxSpace)
    tm, tmk, ts = _build(kind, hyper_cube, hyper_rectangle, axis_periodic,
                         TaylorHoodSpace)
    for name in MESH_ATTRS:
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    assert np.array_equal(tmk.facet_ids, jmk.facet_ids)
    assert np.array_equal(tmk.values, jmk.values)
    for name in SPACE_ATTRS:
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    assert np.array_equal(ts.integration_weights(), js.integration_weights())
    assert ts.n_dofs == js.n_dofs


def test_box_markers_cover_all_six_faces():
    from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers as M

    mesh, markers = hyper_cube(3, 3)
    assert mesh.dim == 3 and mesh.n_cells == 6 * 27
    faces = (M.left, M.right, M.bottom, M.top, M.back, M.front)
    counts = [len(markers.ids_with_value(f.value)) for f in faces]
    assert counts == [2 * 9] * 6            # two triangles per cell face
    assert sum(counts) == int(mesh.exterior_facet_mask.sum())
    with pytest.raises(ValueError):
        hyper_rectangle((0.0, 0.0, 0.0), (1.0, 1.0), 2)
    with pytest.raises(ValueError):
        hyper_rectangle((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2))


@pytest.mark.parametrize("n,dim", [(16, 2), (4, 3)])
def test_taylor_green_setup_matches_graft_entry(n, dim):
    from __graft_entry__ import _taylor_green_setup

    from navierstokes_tpu_torch.setups import taylor_green_setup

    js, ju0, jp0 = _taylor_green_setup(n, dim=dim)
    ts, tu0, tp0 = taylor_green_setup(n, dim=dim)
    assert ts.n_dofs == js.n_dofs
    assert tu0.shape == (ts.n_unodes, dim)
    assert np.array_equal(tu0, ju0)
    assert np.array_equal(tp0, jp0)
    for name in SPACE_ATTRS:
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    with pytest.raises(ValueError):
        taylor_green_setup(4, dim=1)


def test_fast_host_paths_equal_the_plain_ones():
    """The packed-key row dedup and the ranked cell signatures give
    exactly what ``np.unique`` over rows gives."""
    from navierstokes_tpu_torch.mesh.core import unique_rows
    from navierstokes_tpu_torch.structured.grid import _rank_rows

    rng = np.random.default_rng(3)
    for w, hi in ((2, 50), (3, 40), (3, 2 ** 30)):   # the last: no packing
        rows = np.sort(rng.integers(0, hi, size=(500, w)), axis=1)
        rows[::7] = rows[0]
        want = np.unique(rows.astype(np.int32), axis=0, return_inverse=True,
                         return_counts=True)
        got = unique_rows(rows)
        for a, b in zip(got, want):
            assert np.array_equal(a, b.reshape(a.shape))
        assert got[0].dtype == np.int32 and got[1].dtype == np.int64

    sig = rng.integers(0, 3, size=(400, 42))
    sig[::5] = sig[1]
    uniq, inverse = np.unique(sig, axis=0, return_inverse=True)
    rank, n_unique = _rank_rows(sig)
    assert n_unique == len(uniq)
    assert np.array_equal(rank, inverse.reshape(-1))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import navierstokes_tpu_torch\n"
            "import navierstokes_tpu_torch.setups\n"
            "import navierstokes_tpu_torch.solvers.planar_step\n"
            "import navierstokes_tpu_torch.assembly.cuda_band\n"
            "import navierstokes_tpu_torch.structured\n"
            "import navierstokes_tpu_torch.structured.spectral\n"
            "import navierstokes_tpu_torch.timestepping\n"
            "import navierstokes_tpu_torch.fem.bcs\n"
            "import navierstokes_tpu_torch.fem.dirichlet\n"
            "import navierstokes_tpu_torch.problems\n"
            "import navierstokes_tpu_torch.utils\n"
            "import navierstokes_tpu_torch.utils.segment\n"
            "import navierstokes_tpu_torch.linalg.krylov\n"
            "import navierstokes_tpu_torch.linalg.amg\n"
            "import navierstokes_tpu_torch.assembly.kernels\n"
            "import navierstokes_tpu_torch.assembly.operators\n"
            "import navierstokes_tpu_torch.solvers\n"
            "import navierstokes_tpu_torch.solvers.projection\n"
            "import navierstokes_tpu_torch.io\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'navierstokes_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
