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
    mesh, markers = rect_fn((0.0, 0.0), (2.0, 1.0), (12, 6))
    return mesh, markers, space_cls(mesh)


@pytest.mark.parametrize("kind", ["periodic", "channel"])
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


def test_taylor_green_setup_matches_graft_entry():
    from __graft_entry__ import _taylor_green_setup

    from navierstokes_tpu_torch.setups import taylor_green_setup

    js, ju0, jp0 = _taylor_green_setup(16)
    ts, tu0, tp0 = taylor_green_setup(16)
    assert ts.n_dofs == js.n_dofs
    assert np.array_equal(tu0, ju0)
    assert np.array_equal(tp0, jp0)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import navierstokes_tpu_torch\n"
            "import navierstokes_tpu_torch.setups\n"
            "import navierstokes_tpu_torch.solvers.planar_step\n"
            "import navierstokes_tpu_torch.assembly.cuda_band\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'navierstokes_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
