"""Port parity: the rest of the mesh layer -- the spherical shell, the
backward-facing step and the Blasius plate (mesh/generators.py), gmsh
import and export (mesh/gmsh_io.py) and XDMF (mesh/xdmf_io.py).

Host NumPy on both sides with the same construction, so every array must
be EQUAL (``np.array_equal``): points, cells, facets, edges, markers and
the marker maps, the meshes read from ``.msh`` files and strings, and the
XDMF round trips with and without ``h5py`` (the card's machine has no
``h5py``, so there the inline-XML data items are the ones written).
"""

import os

import numpy as np
import pytest

from navierstokes_tpu.mesh import generators as jgen
from navierstokes_tpu.mesh import gmsh_io as jgmsh
from navierstokes_tpu.mesh import xdmf_io as jxdmf
from navierstokes_tpu_torch import mesh as tmesh
from navierstokes_tpu_torch.mesh import generators as tgen
from navierstokes_tpu_torch.mesh import gmsh_io as tgmsh
from navierstokes_tpu_torch.mesh import xdmf_io as txdmf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = os.path.join(REPO, "meshes")
TOPOLOGY = ("points", "cells", "facets", "edges", "cell_facets",
            "cell_edges", "facet_cell", "exterior_facet_mask")

# the gmsh strings of tests/test_gmsh_io.py: a unit square in MSH 2.2 and
# in MSH 4.1 (entity blocks, physical tags on the $Entities records)
GEO = """\
// sample geometry
Point(1) = {0, 0, 0, 1.0};
Physical Curve("inlet", 102) = {1};
Physical Line("outlet", 103) = {2};
Physical Curve("wall", 100) = {3, 4};
Physical Surface("fluid", 200) = {1};
"""

MSH22 = """\
$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
6
1 1 2 102 1 1 2
2 1 2 103 2 2 3
3 1 2 100 3 3 4
4 1 2 100 3 4 1
5 2 2 200 1 1 2 3
6 2 2 200 1 1 3 4
$EndElements
"""

MSH41 = """\
$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
4 4 1 0
1 0 0 0 0
2 1 0 0 0
3 1 1 0 0
4 0 1 0 0
1 0 0 0 1 0 0 1 102 2 1 -2
2 1 0 0 1 1 0 1 103 2 2 -3
3 0 1 0 1 1 0 1 100 2 3 -4
4 0 0 0 0 1 0 1 100 2 4 -1
1 0 0 0 1 1 0 1 200 4 1 2 3 4
$EndEntities
$Nodes
5 4 1 4
0 1 0 1
1
0 0 0
0 2 0 1
2
1 0 0
0 3 0 1
3
1 1 0
0 4 0 1
4
0 1 0
2 1 0 0
$EndNodes
$Elements
5 6 1 6
1 1 1 1
1 1 2
1 2 1 1
2 2 3
1 3 1 1
3 3 4
1 4 1 1
4 4 1
2 1 2 2
5 1 2 3
6 1 3 4
$EndElements
"""


def _assert_mesh_equal(a, b):
    for key in TOPOLOGY:
        assert np.array_equal(getattr(a, key), getattr(b, key)), key


def _assert_markers_equal(a, b):
    assert np.array_equal(a.facet_ids, b.facet_ids)
    assert np.array_equal(a.values, b.values)


# ---------------------------------------------------------------------------
# generators, at the sizes of tests/test_mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim, radii, n", [(2, (0.25, 1.0), 20),
                                           (2, (0.5, 1.0), 40),
                                           (3, (0.5, 1.0), 8)])
def test_spherical_shell_equal(dim, radii, n):
    jm, jmk = jgen.spherical_shell(dim, radii, n)
    tm, tmk = tgen.spherical_shell(dim, radii, n)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jmk, tmk)
    # both boundary spheres snap, as in the JAX package
    x = np.random.default_rng(1).standard_normal((50, dim))
    x[:10] *= radii[0] / np.linalg.norm(x[:10], axis=1, keepdims=True)
    for fj, ft in zip(jm.snap, tm.snap):
        assert np.array_equal(fj(x), ft(x))
    with pytest.raises(ValueError):
        tgen.spherical_shell(dim, radii[::-1], n)


@pytest.mark.parametrize("name", ["backward_facing_step", "blasius_plate"])
@pytest.mark.parametrize("res", [0.5, 1.0])
def test_step_and_plate_equal(name, res):
    jm, jmk, jmap = getattr(jgen, name)(res)
    tm, tmk, tmap = getattr(tgen, name)(res)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jmk, tmk)
    assert jmap == tmap
    assert set(np.unique(tmk.values)) == set(tmap.values())


def test_mesh_package_exports_what_the_jax_one_does():
    from navierstokes_tpu import mesh as jmesh

    names = {n for n in dir(jmesh) if not n.startswith("_")
             and callable(getattr(jmesh, n))}
    missing = {n for n in names if not hasattr(tmesh, n)}
    assert not missing, missing


# ---------------------------------------------------------------------------
# gmsh
# ---------------------------------------------------------------------------

def test_extract_facet_markers_equal(tmp_path):
    geo = tmp_path / "sample.geo"
    geo.write_text(GEO)
    assert tgmsh.extract_facet_markers(str(geo)) \
        == jgmsh.extract_facet_markers(str(geo)) \
        == {"inlet": 102, "outlet": 103, "wall": 100}
    assert tgmsh.extract_facet_markers(
        os.path.join(MESHES, "backward_facing_step.geo")) \
        == jgmsh.extract_facet_markers(
            os.path.join(MESHES, "backward_facing_step.geo"))


@pytest.mark.parametrize("text", [MSH22, MSH41], ids=["msh22", "msh41"])
def test_read_msh_strings_equal(tmp_path, text):
    path = tmp_path / "sample.msh"
    path.write_text(text)
    jm, jk = jgmsh.read_msh(str(path))
    tm, tk = tgmsh.read_msh(str(path))
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jk, tk)
    assert tm.n_cells == 2 and set(tk.values.tolist()) == {100, 102, 103}


def test_read_shipped_geo_msh_equal():
    geo = os.path.join(MESHES, "backward_facing_step.geo")
    jm, jk, jmap = jgmsh.read_geo_msh(geo)
    tm, tk, tmap = tgmsh.read_geo_msh(geo)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jk, tk)
    assert jmap == tmap == {"inlet": 1, "outlet": 2, "walls": 3}
    assert tm.n_cells > 500


@pytest.mark.parametrize("shape", ["cube", "shell"])
def test_write_msh_round_trip_equal(tmp_path, shape):
    """A 3D mesh written by either package reads back in both to the same
    arrays.  The port writes 17 significant digits, so its file reads back
    to the written points exactly; the JAX package writes 16, which
    loses the last bit of points that are no short binary fractions (the
    shell's)."""
    if shape == "cube":
        mesh, markers = tmesh.hyper_cube(3, 2)
    else:
        mesh, markers = tgen.spherical_shell(3, (0.5, 1.0), 4)
    a, b = str(tmp_path / "t.msh"), str(tmp_path / "j.msh")
    tgmsh.write_msh(a, mesh, markers)
    jgmsh.write_msh(b, mesh, markers)
    for path in (a, b):
        tm, tk = tgmsh.read_msh(path)
        jm, jk = jgmsh.read_msh(path)
        _assert_mesh_equal(jm, tm)
        _assert_markers_equal(jk, tk)
    tm, _ = tgmsh.read_msh(a)
    jm, _ = jgmsh.read_msh(b)
    assert tm.dim == 3 and np.array_equal(tm.points, mesh.points)
    assert np.array_equal(jm.points, mesh.points) == (shape == "cube")
    assert np.abs(jm.points - mesh.points).max() < 1e-15


def test_generate_msh_without_gmsh_raises(tmp_path, monkeypatch):
    geo = tmp_path / "lonely.geo"
    geo.write_text(GEO)
    monkeypatch.setattr(tgmsh.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="no gmsh binary"):
        tgmsh.generate_msh(str(geo))


# ---------------------------------------------------------------------------
# XDMF
# ---------------------------------------------------------------------------

def _xdmf_round_trip(tmp_path, mesh, markers, inline, monkeypatch):
    if inline:
        monkeypatch.setattr(txdmf, "_h5py", lambda: None)
        monkeypatch.setattr(jxdmf, "_h5py", lambda: None)
    tpath = str(tmp_path / "t.xdmf")
    jpath = str(tmp_path / "j.xdmf")
    tf = txdmf.write_xdmf_mesh(tpath, mesh, facet_markers=markers)
    jxdmf.write_xdmf_mesh(jpath, mesh, facet_markers=markers)
    assert os.path.exists(tf)
    assert os.path.exists(tpath[:-5] + ".h5") is not inline
    # each package reads the other's files to the same arrays
    for path in (jpath, tpath):
        tm, tk = txdmf.read_xdmf_mesh(path)
        jm, jk = jxdmf.read_xdmf_mesh(path)
        _assert_mesh_equal(jm, tm)
        _assert_markers_equal(jk, tk)
    # the port's file (read last) gives back the written arrays exactly
    assert np.array_equal(tm.points, mesh.points)
    assert np.array_equal(tm.cells, mesh.cells)
    return tm, tk


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "hdf5"])
def test_xdmf_round_trip_2d(tmp_path, monkeypatch, inline):
    if not inline:
        pytest.importorskip("h5py")
    mesh, markers, _ = tgen.backward_facing_step(resolution=0.25)
    _, k2 = _xdmf_round_trip(tmp_path, mesh, markers, inline, monkeypatch)
    a = {(tuple(sorted(mesh.facets[f])), int(v))
         for f, v in zip(markers.facet_ids, markers.values)}
    b = {(tuple(sorted(mesh.facets[f])), int(v))
         for f, v in zip(k2.facet_ids, k2.values)}
    assert a == b


def test_xdmf_round_trip_3d(tmp_path, monkeypatch):
    mesh, markers = tgen.spherical_shell(3, (0.5, 1.0), 4)
    _xdmf_round_trip(tmp_path, mesh, markers, True, monkeypatch)


def test_xdmf_reading_hdf5_without_h5py_raises(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    mesh, markers = tgen.hyper_cube(2, 3)
    path = str(tmp_path / "m.xdmf")
    txdmf.write_xdmf_mesh(path, mesh, facet_markers=markers)
    monkeypatch.setattr(txdmf, "_h5py", lambda: None)
    with pytest.raises(RuntimeError, match="h5py is required"):
        txdmf.read_xdmf_mesh(path)
    with pytest.raises(ValueError, match="codim-1"):
        monkeypatch.undo()
        txdmf.read_xdmf_mesh(path[:-5] + "_facet_markers.xdmf")


def test_generate_xdmf_mesh_from_shipped_msh_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(txdmf, "_h5py", lambda: None)
    msh = os.path.join(MESHES, "backward_facing_step.msh")
    out = txdmf.generate_xdmf_mesh(msh, out=str(tmp_path / "bfs.xdmf"))
    tm, tk = txdmf.read_xdmf_mesh(out)
    jm, jk = jgmsh.read_msh(msh)
    _assert_mesh_equal(jm, tm)
    _assert_markers_equal(jk, tk)
