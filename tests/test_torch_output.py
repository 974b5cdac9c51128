"""Port parity: field output (io/output.py), both formats.

The same vertex fields written by both packages' writers give the same
files: the XDMF/PVD/VTU texts byte for byte (the same ASCII formatting of
the same numbers) and the HDF5 datasets array for array.  The port's
writer also takes tensors.
"""

import os

import numpy as np
import pytest
import torch

from navierstokes_tpu.io import output as jout
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cwc
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu_torch.io import output as tout
from navierstokes_tpu_torch.mesh import channel_with_cylinder, hyper_cube

h5py = pytest.importorskip("h5py")


def _fields(mesh, seed=0):
    rng = np.random.default_rng(seed)
    vel = rng.random((mesh.n_vertices, mesh.dim))
    return {"velocity": vel, "pressure": vel[:, 0] - 0.5,
            "vorticity": rng.standard_normal(mesh.n_vertices)}


def _write_both(tmp_path, fmt, mesh_j, mesh_t, steps=3):
    jw = jout.FieldWriter(str(tmp_path / "jax" / "out.xdmf"), mesh_j,
                          fmt=fmt)
    tw = tout.FieldWriter(str(tmp_path / "torch" / "out.xdmf"), mesh_t,
                          fmt=fmt)
    for i in range(steps):
        f = _fields(mesh_t, seed=i)
        jw.write(0.5 * i, f)
        tw.write(0.5 * i, {k: torch.tensor(v) for k, v in f.items()})
    return tmp_path / "jax", tmp_path / "torch"


def _same_text(a, b):
    assert open(a).read() == open(b).read(), os.path.basename(a)


@pytest.mark.parametrize("mesh", ["cube", "dfg"])
def test_xdmf_equal(tmp_path, mesh):
    if mesh == "cube":
        mj, mt = jax_hyper_cube(2, 4)[0], hyper_cube(2, 4)[0]
    else:
        mj, mt = jax_cwc(0.5)[0], channel_with_cylinder(0.5)[0]
    dj, dt = _write_both(tmp_path, "xdmf", mj, mt)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt)) \
        == ["out.h5", "out.xdmf"]
    _same_text(dj / "out.xdmf", dt / "out.xdmf")
    with h5py.File(dj / "out.h5") as a, h5py.File(dt / "out.h5") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        for name in names:
            if isinstance(a[name], h5py.Dataset):
                assert np.array_equal(a[name][()], b[name][()]), name
        assert b["step2/velocity"].shape == (mt.n_vertices, 2)


@pytest.mark.parametrize("mesh", ["cube", "dfg"])
def test_pvd_equal(tmp_path, mesh):
    if mesh == "cube":
        mj, mt = jax_hyper_cube(2, 3)[0], hyper_cube(2, 3)[0]
    else:
        mj, mt = jax_cwc(0.5)[0], channel_with_cylinder(0.5)[0]
    dj, dt = _write_both(tmp_path, "pvd", mj, mt)
    files = sorted(os.listdir(dt))
    assert files == sorted(os.listdir(dj)) == [
        "out.pvd", "out_000000.vtu", "out_000001.vtu", "out_000002.vtu"]
    for name in files:
        _same_text(dj / name, dt / name)


def test_default_format_follows_h5py(tmp_path):
    mesh, _ = hyper_cube(2, 2)
    assert tout.FieldWriter(str(tmp_path / "a.xdmf"), mesh).fmt == "xdmf"
    with pytest.raises(ValueError, match="fmt"):
        tout.FieldWriter(str(tmp_path / "b.xdmf"), mesh, fmt="vtk")
    w = tout.FieldWriter(str(tmp_path / "c.pvd"), mesh, fmt="pvd")
    with pytest.raises(ValueError, match="rows"):
        w.write(0.0, {"pressure": np.zeros(mesh.n_vertices + 1)})


def test_write_vtu_with_cell_fields_equal(tmp_path):
    mj, mt = jax_hyper_cube(3, 2)[0], hyper_cube(3, 2)[0]
    rng = np.random.default_rng(2)
    point = {"velocity": rng.random((mt.n_vertices, 3))}
    cell = {"rank": rng.random(mt.n_cells),
            "grad": rng.random((mt.n_cells, 3))}
    jout.write_vtu(str(tmp_path / "j.vtu"), mj, point_fields=point,
                   cell_fields=cell)
    tout.write_vtu(str(tmp_path / "t.vtu"), mt, point_fields=point,
                   cell_fields=cell)
    _same_text(tmp_path / "j.vtu", tmp_path / "t.vtu")


@pytest.mark.parametrize("mesh", ["cube", "dfg"])
def test_write_boundary_markers_equal(tmp_path, mesh):
    if mesh == "cube":
        (mj, kj), (mt, kt) = jax_hyper_cube(2, 3), hyper_cube(2, 3)
    else:
        mj, kj, _ = jax_cwc(0.5)
        mt, kt, _ = channel_with_cylinder(0.5)
    jout.write_boundary_markers(str(tmp_path / "j" / "m.vtu"), mj, kj)
    tout.write_boundary_markers(str(tmp_path / "t" / "m.vtu"), mt, kt)
    _same_text(tmp_path / "j" / "m.vtu", tmp_path / "t" / "m.vtu")
    assert "marker" in open(tmp_path / "t" / "m.vtu").read()
