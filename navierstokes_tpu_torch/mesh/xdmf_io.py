"""XDMF mesh input/output (``navierstokes_tpu/mesh/xdmf_io.py``).

The two-file dialect of the meshio/FEniCS pipelines: the cell mesh, and a
codim-1 facet mesh carrying ``facet_markers`` cell data.  Written and read
natively (no meshio):

* :func:`write_xdmf_mesh` -- mesh + facet markers to ``name.xdmf`` /
  ``name_facet_markers.xdmf`` (+ companion ``.h5`` files when h5py is
  available; inline-XML data items otherwise, which dolfin/meshio also
  accept).
* :func:`read_xdmf_mesh` -- reads either file pair back (HDF5 or inline
  data items, XY or XYZ geometry), returning ``(SimplexMesh,
  FacetMarkers)``.  Facet connectivity from the facet file is matched to
  the volume mesh's own facet numbering by sorted-vertex lookup, the
  array-native equivalent of dolfin's MeshValueCollection association.
* :func:`generate_xdmf_mesh` -- .geo/.msh -> XDMF pair, the
  grid_tools.py:70 entry point.

Where ``h5py`` does not import, the data items are written inline as
XML (the JAX package's own behaviour, which dolfin and meshio read too);
reading HDF5 data items then raises.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from navierstokes_tpu_torch.mesh.core import FacetMarkers, SimplexMesh

_TOPO = {2: {"triangle": "Triangle", "line": "PolyLine"},
         3: {"tetra": "Tetrahedron", "triangle": "Triangle"}}
_NODES = {"Triangle": 3, "Tetrahedron": 4, "PolyLine": 2, "Polyline": 2,
          "Line": 2, "Edge_3": 3}


def _h5py():
    try:
        import h5py
        return h5py
    except ImportError:
        return None


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _data_item(parent, arr, h5file, h5name, number_type):
    dims = " ".join(str(s) for s in arr.shape)
    if h5file is not None:
        item = ET.SubElement(parent, "DataItem", Dimensions=dims,
                             NumberType=number_type,
                             Precision="8" if number_type == "Float" else "4",
                             Format="HDF")
        item.text = f"{os.path.basename(h5file.filename)}:{h5name}"
        h5file.create_dataset(h5name, data=arr)
    else:
        item = ET.SubElement(parent, "DataItem", Dimensions=dims,
                             NumberType=number_type,
                             Precision="8" if number_type == "Float" else "4",
                             Format="XML")
        flat = arr.reshape(-1, arr.shape[-1]) if arr.ndim > 1 else arr[:, None]
        # 17 significant digits: every float64 reads back exactly
        item.text = "\n" + "\n".join(
            " ".join(format(v, ".17g") if number_type == "Float" else str(v)
                     for v in row) for row in flat) + "\n"


def _write_grid(path, points, cells, topo_type, attr_name=None,
                attr_values=None):
    root = ET.Element("Xdmf", Version="3.0")
    domain = ET.SubElement(root, "Domain")
    grid = ET.SubElement(domain, "Grid", Name="Grid")
    h5 = _h5py()
    h5file = h5.File(path[:-5] + ".h5", "w") if h5 else None
    try:
        geom = ET.SubElement(grid, "Geometry",
                             GeometryType="XY" if points.shape[1] == 2
                             else "XYZ")
        _data_item(geom, np.asarray(points, np.float64), h5file,
                   "/data0", "Float")
        topo = ET.SubElement(grid, "Topology", TopologyType=topo_type,
                             NumberOfElements=str(len(cells)),
                             NodesPerElement=str(cells.shape[1]))
        _data_item(topo, np.asarray(cells, np.int64), h5file, "/data1",
                   "Int")
        if attr_name is not None:
            attr = ET.SubElement(grid, "Attribute", Name=attr_name,
                                 AttributeType="Scalar", Center="Cell")
            _data_item(attr, np.asarray(attr_values, np.int32), h5file,
                       "/data2", "Int")
    finally:
        if h5file is not None:
            h5file.close()
    ET.indent(root)
    ET.ElementTree(root).write(path, xml_declaration=True)


def write_xdmf_mesh(path, mesh, facet_markers=None, cell_markers=None):
    """Write ``path`` (``.xdmf``) + ``path[:-5]_facet_markers.xdmf``.

    Same two-file layout as the reference's grid_tools.py:106-121; returns
    the facet-marker filename (or None when ``facet_markers`` is None).
    """
    if not path.endswith(".xdmf"):
        raise ValueError(f"{path}: expected a .xdmf path")
    dim = mesh.dim
    cell_name = {2: "Triangle", 3: "Tetrahedron"}[dim]
    _write_grid(path, mesh.points, mesh.cells, cell_name,
                attr_name=None if cell_markers is None else "cell_markers",
                attr_values=cell_markers)
    if facet_markers is None:
        return None
    facet_path = path[:-5] + "_facet_markers.xdmf"
    facets = mesh.facets[facet_markers.facet_ids]
    facet_name = {2: "PolyLine", 3: "Triangle"}[dim]
    _write_grid(facet_path, mesh.points, facets, facet_name,
                attr_name="facet_markers", attr_values=facet_markers.values)
    return facet_path


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_data_item(item, base_dir):
    fmt = item.get("Format", "XML")
    number_type = item.get("NumberType", item.get("DataType", "Float"))
    dims = tuple(int(d) for d in item.get("Dimensions", "").split())
    if fmt == "HDF":
        h5 = _h5py()
        if h5 is None:
            raise RuntimeError("h5py is required to read HDF5 XDMF data")
        fname, dset = item.text.strip().split(":", 1)
        with h5.File(os.path.join(base_dir, fname), "r") as fh:
            arr = np.asarray(fh[dset])
    elif fmt == "XML":
        arr = np.fromiter((float(t) for t in item.text.split()),
                          dtype=np.float64)
        if number_type != "Float":
            arr = arr.astype(np.int64)
    else:
        raise ValueError(f"unsupported XDMF DataItem format {fmt!r}")
    if dims:
        arr = arr.reshape(dims)
    return arr


def _read_grid(path):
    tree = ET.parse(path)
    grid = tree.getroot().find("Domain").find("Grid")
    base = os.path.dirname(os.path.abspath(path))
    geom = grid.find("Geometry")
    points = _read_data_item(geom.find("DataItem"), base)
    gt = geom.get("GeometryType", "XYZ")
    points = np.asarray(points, np.float64).reshape(
        -1, 2 if gt.upper() == "XY" else 3)
    topo = grid.find("Topology")
    tt = topo.get("TopologyType")
    npe = int(topo.get("NodesPerElement", _NODES.get(tt, 0)) or
              _NODES[tt])
    cells = np.asarray(_read_data_item(topo.find("DataItem"), base),
                       np.int64).reshape(-1, npe)
    attrs = {}
    for attr in grid.findall("Attribute"):
        attrs[attr.get("Name")] = np.asarray(
            _read_data_item(attr.find("DataItem"), base)).reshape(-1)
    return points, cells, tt, attrs


def read_xdmf_mesh(path, facet_marker_path=None):
    """Read an XDMF mesh (+ optional facet-marker file) -> (mesh, markers).

    ``facet_marker_path`` defaults to ``path[:-5]_facet_markers.xdmf`` when
    that file exists (the layout both this module and the reference's
    grid_tools write).  Returns ``(SimplexMesh, FacetMarkers)``; the
    markers are empty when no facet file is found.

    Parity: grid_generator.py:406-437 (XDMFFile.read + MeshValueCollection).
    """
    points, cells, tt, attrs = _read_grid(path)
    if tt not in ("Triangle", "Tetrahedron"):
        raise ValueError(f"volume grid has codim-1 topology {tt!r}; pass "
                         "the mesh file, not the facet-marker file")
    dim = 3 if tt == "Tetrahedron" else 2
    if points.shape[1] != dim:
        if dim == 2 and points.shape[1] == 3:
            if not np.allclose(points[:, 2], points[0, 2]):
                raise ValueError(f"{path}: a triangle mesh whose points "
                                 "do not lie in one z plane")
            points = points[:, :2]
    mesh = SimplexMesh(points, cells.astype(np.int32))

    if facet_marker_path is None:
        cand = path[:-5] + "_facet_markers.xdmf"
        facet_marker_path = cand if os.path.exists(cand) else None
    if facet_marker_path is None:
        return mesh, FacetMarkers(np.zeros(0, np.int32),
                                  np.zeros(0, np.int32))

    fpoints, fcells, ftt, fattrs = _read_grid(facet_marker_path)
    if "facet_markers" not in fattrs:
        raise ValueError(f"{facet_marker_path}: no 'facet_markers' "
                         "attribute")
    values = fattrs["facet_markers"].astype(np.int32)
    # the facet file may carry its own (identical) point cloud; match
    # facet connectivity to the volume mesh by sorted vertex tuples
    if len(fpoints) != len(points) or not np.allclose(fpoints[:, :dim],
                                                      points):
        # re-map facet vertex ids onto volume vertex ids by coordinates
        from scipy.spatial import cKDTree

        tree = cKDTree(points)
        dist, idx = tree.query(fpoints[:, :dim])
        if dist.max() >= 1e-10:
            raise ValueError(f"{facet_marker_path}: facet file points do "
                             "not match the mesh")
        fcells = idx[fcells]
    key = np.ascontiguousarray(np.sort(fcells, axis=1).astype(np.int32))
    mesh_key = np.ascontiguousarray(np.sort(mesh.facets, axis=1)
                                    .astype(np.int32))
    lookup = {row.tobytes(): i for i, row in enumerate(mesh_key)}
    facet_ids = np.fromiter(
        (lookup.get(row.tobytes(), -1) for row in key), dtype=np.int64,
        count=len(key))
    if np.any(facet_ids < 0):
        raise ValueError(
            f"{int((facet_ids < 0).sum())} facet(s) in {facet_marker_path} "
            "do not exist in the mesh")
    return mesh, FacetMarkers(facet_ids.astype(np.int32), values)


def generate_xdmf_mesh(geo_or_msh, dim=2, out=None):
    """.geo/.msh -> XDMF mesh + facet-marker files; returns the mesh path.

    Runs the gmsh binary when given a ``.geo`` without a pre-generated
    ``.msh`` (grid_tools.py:84-91); the conversion itself is native.
    """
    from navierstokes_tpu_torch.mesh.gmsh_io import generate_msh, read_msh

    if geo_or_msh.endswith(".geo"):
        msh = generate_msh(geo_or_msh, dim=dim)
    else:
        msh = geo_or_msh
    mesh, markers = read_msh(msh)
    out = out or (os.path.splitext(msh)[0] + ".xdmf")
    write_xdmf_mesh(out, mesh, facet_markers=markers)
    return out
