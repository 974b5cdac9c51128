"""Field output: XDMF/HDF5 time series with a VTU/PVD fallback
(counterpart of ``navierstokes_tpu/io/output.py``).

Velocity/pressure plus registered extra fields are written per output
step as vertex data.  ``FieldWriter`` writes XDMF + HDF5 when ``h5py``
imports and a PVD collection of ASCII VTU files otherwise; ``fmt`` picks
one explicitly.  The files have the JAX package's layout byte for byte.
"""

from __future__ import annotations

import os
import xml.sax.saxutils as sx

import numpy as np

from navierstokes_tpu_torch.io.checkpoint import _to_numpy

try:
    import h5py
    _HAVE_H5PY = True
except ImportError:
    _HAVE_H5PY = False

_XDMF_CELL = {2: ("Triangle", 3), 3: ("Tetrahedron", 4)}
_VTK_CELL = {2: 5, 3: 10}  # triangle / tetra


class FieldWriter:
    """Time-series writer for vertex fields on a simplex mesh.

    ``fmt``: ``"xdmf"`` (needs ``h5py``), ``"pvd"``, or None for XDMF when
    ``h5py`` imports and PVD otherwise.
    """

    def __init__(self, filename: str, mesh, fmt: str = None):
        if fmt is None:
            fmt = "xdmf" if _HAVE_H5PY else "pvd"
        if fmt not in ("xdmf", "pvd"):
            raise ValueError(f"fmt must be 'xdmf' or 'pvd', got {fmt!r}")
        if fmt == "xdmf" and not _HAVE_H5PY:
            raise RuntimeError("XDMF output needs h5py; pass fmt='pvd'")
        self.fmt = fmt
        self.mesh = mesh
        base, _ = os.path.splitext(filename)
        self.base = base
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        self._timesteps = []
        if fmt == "xdmf":
            self.h5_path = base + ".h5"
            with h5py.File(self.h5_path, "w") as h5:
                h5.create_dataset("mesh/points", data=mesh.points)
                h5.create_dataset("mesh/cells", data=mesh.cells)

    def write(self, time: float, fields: dict) -> None:
        """``fields``: name -> (n_vertices,) or (n_vertices, dim) array."""
        fields = {name: _to_numpy(arr) for name, arr in fields.items()}
        for name, arr in fields.items():
            if len(arr) != self.mesh.n_vertices:
                raise ValueError(f"field {name!r} has {len(arr)} rows, the "
                                 f"mesh {self.mesh.n_vertices} vertices")
        if self.fmt == "xdmf":
            self._write_xdmf_step(time, fields)
        else:
            self._write_vtu_step(time, fields)

    # -- XDMF ---------------------------------------------------------------
    def _write_xdmf_step(self, time, fields):
        idx = len(self._timesteps)
        with h5py.File(self.h5_path, "a") as h5:
            for name, arr in fields.items():
                h5.create_dataset(f"step{idx}/{name}", data=arr)
        self._timesteps.append((time, list(fields)))
        self._flush_xdmf(fields)

    def _flush_xdmf(self, fields):
        mesh = self.mesh
        cell_name, nvc = _XDMF_CELL[mesh.dim]
        h5_rel = os.path.basename(self.h5_path)
        lines = ['<?xml version="1.0"?>',
                 '<Xdmf Version="3.0">', "<Domain>",
                 '<Grid Name="series" GridType="Collection" '
                 'CollectionType="Temporal">']
        for idx, (time, names) in enumerate(self._timesteps):
            lines += [
                f'<Grid Name="step{idx}">',
                f'<Time Value="{time}"/>',
                f'<Topology TopologyType="{cell_name}" '
                f'NumberOfElements="{mesh.n_cells}">',
                f'<DataItem Dimensions="{mesh.n_cells} {nvc}" '
                f'Format="HDF" NumberType="Int">{h5_rel}:/mesh/cells'
                '</DataItem>', '</Topology>',
                f'<Geometry GeometryType="{"XY" if mesh.dim == 2 else "XYZ"}">',
                f'<DataItem Dimensions="{mesh.n_vertices} {mesh.dim}" '
                f'Format="HDF">{h5_rel}:/mesh/points</DataItem>',
                '</Geometry>']
            for name in names:
                with h5py.File(self.h5_path, "r") as h5:
                    shape = h5[f"step{idx}/{name}"].shape
                attr_type = "Vector" if len(shape) == 2 else "Scalar"
                dims = " ".join(str(s) for s in shape)
                lines += [
                    f'<Attribute Name={sx.quoteattr(name)} '
                    f'AttributeType="{attr_type}" Center="Node">',
                    f'<DataItem Dimensions="{dims}" Format="HDF">'
                    f'{h5_rel}:/step{idx}/{name}</DataItem>',
                    '</Attribute>']
            lines.append("</Grid>")
        lines += ["</Grid>", "</Domain>", "</Xdmf>"]
        with open(self.base + ".xdmf", "w") as fh:
            fh.write("\n".join(lines))

    # -- VTU/PVD ------------------------------------------------------------
    def _write_vtu_step(self, time, fields):
        idx = len(self._timesteps)
        vtu = f"{self.base}_{idx:06d}.vtu"
        write_vtu(vtu, self.mesh, point_fields=fields)
        self._timesteps.append((time, vtu))
        lines = ['<?xml version="1.0"?>',
                 '<VTKFile type="Collection" version="0.1">', "<Collection>"]
        for t, path in self._timesteps:
            lines.append(f'<DataSet timestep="{t}" part="0" '
                         f'file="{os.path.basename(path)}"/>')
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.base + ".pvd", "w") as fh:
            fh.write("\n".join(lines))


def _ascii(arr):
    return "\n".join(" ".join(repr(float(v)) for v in row)
                     for row in np.atleast_2d(arr))


def write_vtu(path, mesh, point_fields=None, cell_fields=None):
    """Minimal ASCII VTU writer (volume cells + point/cell data)."""
    points3 = np.zeros((mesh.n_vertices, 3))
    points3[:, :mesh.dim] = mesh.points
    nvc = mesh.dim + 1
    vtk_type = _VTK_CELL[mesh.dim]
    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="UnstructuredGrid" version="0.1">',
             "<UnstructuredGrid>",
             f'<Piece NumberOfPoints="{mesh.n_vertices}" '
             f'NumberOfCells="{mesh.n_cells}">',
             "<Points>",
             '<DataArray type="Float64" NumberOfComponents="3" '
             'format="ascii">', _ascii(points3), "</DataArray>", "</Points>",
             "<Cells>",
             '<DataArray type="Int32" Name="connectivity" format="ascii">',
             " ".join(str(v) for v in mesh.cells.ravel()), "</DataArray>",
             '<DataArray type="Int32" Name="offsets" format="ascii">',
             " ".join(str((i + 1) * nvc) for i in range(mesh.n_cells)),
             "</DataArray>",
             '<DataArray type="UInt8" Name="types" format="ascii">',
             " ".join(str(vtk_type) for _ in range(mesh.n_cells)),
             "</DataArray>", "</Cells>"]
    if point_fields:
        lines.append("<PointData>")
        for name, arr in point_fields.items():
            arr = np.asarray(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            if ncomp == 2:  # pad 2D vectors for VTK
                arr = np.concatenate([arr, np.zeros((len(arr), 1))], axis=1)
                ncomp = 3
            lines += [f'<DataArray type="Float64" Name={sx.quoteattr(name)} '
                      f'NumberOfComponents="{ncomp}" format="ascii">',
                      _ascii(arr.reshape(len(arr), -1)), "</DataArray>"]
        lines.append("</PointData>")
    if cell_fields:
        lines.append("<CellData>")
        for name, arr in cell_fields.items():
            arr = np.asarray(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            lines += [f'<DataArray type="Float64" Name={sx.quoteattr(name)} '
                      f'NumberOfComponents="{ncomp}" format="ascii">',
                      _ascii(arr.reshape(len(arr), -1)), "</DataArray>"]
        lines.append("</CellData>")
    lines += ["</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def write_boundary_markers(path, mesh, markers):
    """Facet markers as a VTU of line (2D) / triangle (3D) cells.

    """
    ids = markers.facet_ids
    facets = mesh.facets[ids]
    nvf = facets.shape[1]
    vtk_type = 3 if mesh.dim == 2 else 5  # line / triangle
    points3 = np.zeros((mesh.n_vertices, 3))
    points3[:, :mesh.dim] = mesh.points
    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="UnstructuredGrid" version="0.1">',
             "<UnstructuredGrid>",
             f'<Piece NumberOfPoints="{mesh.n_vertices}" '
             f'NumberOfCells="{len(facets)}">',
             "<Points>",
             '<DataArray type="Float64" NumberOfComponents="3" '
             'format="ascii">', _ascii(points3), "</DataArray>", "</Points>",
             "<Cells>",
             '<DataArray type="Int32" Name="connectivity" format="ascii">',
             " ".join(str(v) for v in facets.ravel()), "</DataArray>",
             '<DataArray type="Int32" Name="offsets" format="ascii">',
             " ".join(str((i + 1) * nvf) for i in range(len(facets))),
             "</DataArray>",
             '<DataArray type="UInt8" Name="types" format="ascii">',
             " ".join(str(vtk_type) for _ in range(len(facets))),
             "</DataArray>", "</Cells>", "<CellData>",
             '<DataArray type="Int32" Name="marker" format="ascii">',
             " ".join(str(int(v)) for v in markers.values), "</DataArray>",
             "</CellData>", "</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
