"""gmsh interoperability (``navierstokes_tpu/mesh/gmsh_io.py``).

A parser for the ``Physical Curve/Line`` declarations of ``.geo`` files, a
reader for gmsh MSH ASCII files in the legacy 2.2 and the modern 4.1
format (nodes, lines, triangles, tetrahedra with physical tags) and a 2.2
writer.  ``generate_msh`` runs a ``gmsh`` binary when one is on the PATH
and a ``.msh`` beside the ``.geo`` is missing; otherwise it raises, and
users supply a pre-generated ``.msh`` (the repository ships
``meshes/backward_facing_step.{geo,msh}``).  Host-side NumPy only; the
arrays equal the JAX package's.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from navierstokes_tpu_torch.mesh.core import FacetMarkers, SimplexMesh


def extract_facet_markers(geo_filename: str) -> dict:
    """{physical name: facet id} from Physical Curve/Line lines of a .geo.

    Parity with the reference's ``_extract_facet_markers``
    (grid_generator.py:357-386).
    """
    if not geo_filename.endswith(".geo"):
        raise ValueError(f"{geo_filename}: expected a .geo file")
    if not os.path.exists(geo_filename):
        raise FileNotFoundError(geo_filename)
    markers = {}
    with open(geo_filename, "r") as fh:
        for line in fh:
            if "Physical Curve" not in line and "Physical Line" not in line:
                continue
            inner = line[line.index("(") + 1:line.index(")")]
            description, number = inner.split(",")
            number = number.strip()
            if not number.isnumeric():
                raise ValueError(f"{geo_filename}: physical tag {number!r} "
                                 "is not a number")
            description = description.strip().strip("'").strip('"')
            if description in markers:
                raise ValueError(f"{geo_filename}: physical name "
                                 f"{description!r} declared twice")
            markers[description] = int(number)
    return markers


def generate_msh(geo_filename: str, dim: int = 2) -> str:
    """Run the gmsh binary on a .geo file (if available) and return the .msh
    path."""
    msh = geo_filename[:-4] + ".msh"
    if os.path.exists(msh):
        return msh
    gmsh = shutil.which("gmsh")
    if gmsh is None:
        raise FileNotFoundError(
            f"{msh} does not exist and no gmsh binary found to generate it")
    subprocess.run([gmsh, geo_filename, f"-{dim}", "-format", "msh2",
                    "-o", msh], check=True)
    return msh


_MSH_CELL_TYPES = {1: ("line", 2), 2: ("triangle", 3), 4: ("tetra", 4),
                   15: ("point", 1)}


def read_msh(filename: str):
    """Read a gmsh MSH ASCII file (legacy 2.2 or modern 4.1).

    Returns ``(mesh, markers)`` where interior/exterior codim-1 elements with
    physical tags become facet markers.  The spatial dimension is inferred
    from the present cell types (tetra -> 3D, else 2D), mirroring the
    reference's meshio path (source/grid_tools.py:92-121), which accepts
    whatever gmsh emits -- hence both major ASCII formats here.
    """
    with open(filename, "r") as fh:
        lines = fh.read().splitlines()

    def section(name):
        start = lines.index(f"${name}") + 1
        end = lines.index(f"$End{name}")
        return lines[start:end]

    fmt = section("MeshFormat")[0].split()
    version = float(fmt[0])
    if int(fmt[1]) != 0:
        raise ValueError(f"{filename}: binary MSH files are not supported; "
                         "re-export with 'gmsh -format msh2' or ASCII msh4")
    if version >= 4.0:
        nodes, blocks = _parse_msh41(section)
    else:
        nodes, blocks = _parse_msh22(section)

    return _build_mesh(nodes, blocks)


def _parse_msh22(section):
    node_lines = section("Nodes")
    n_nodes = int(node_lines[0])
    nodes = np.array([[float(v) for v in ln.split()[1:4]]
                      for ln in node_lines[1:1 + n_nodes]])

    elem_lines = section("Elements")
    n_elems = int(elem_lines[0])
    blocks = {}
    for ln in elem_lines[1:1 + n_elems]:
        parts = [int(v) for v in ln.split()]
        etype = parts[1]
        if etype not in _MSH_CELL_TYPES:
            continue
        name, nv = _MSH_CELL_TYPES[etype]
        n_tags = parts[2]
        phys = parts[3] if n_tags > 0 else 0
        conn = [v - 1 for v in parts[3 + n_tags:3 + n_tags + nv]]
        blocks.setdefault(name, []).append((phys, conn))
    return nodes, blocks


def _parse_msh41(section):
    """MSH 4.1: entity-block nodes/elements; physical tags live on the
    $Entities records and are looked up per (dim, entity tag)."""
    # (dim, entity_tag) -> first physical tag (0 if none)
    entity_phys = {}
    try:
        ent = section("Entities")
    except ValueError:
        ent = None
    if ent is not None:
        counts = [int(v) for v in ent[0].split()]
        row = 1
        for dim, n_ent in enumerate(counts):
            for _ in range(n_ent):
                parts = ent[row].split()
                row += 1
                tag = int(parts[0])
                # points: tag x y z numPhys phys...; curves/surfaces/volumes:
                # tag 6 bbox floats, then numPhys phys...
                off = 4 if dim == 0 else 7
                n_phys = int(parts[off])
                phys = int(parts[off + 1]) if n_phys > 0 else 0
                entity_phys[(dim, tag)] = phys

    node_lines = section("Nodes")
    header = [int(v) for v in node_lines[0].split()]
    n_blocks, _, _, max_tag = header
    coords = np.zeros((max_tag + 1, 3))
    row = 1
    for _ in range(n_blocks):
        _, _, _, n_in_block = [int(v) for v in node_lines[row].split()]
        row += 1
        tags = [int(node_lines[row + i]) for i in range(n_in_block)]
        row += n_in_block
        for i, tag in enumerate(tags):
            coords[tag] = [float(v)
                           for v in node_lines[row + i].split()[:3]]
        row += n_in_block
    # node tags are 1-based and may be sparse; keep a dense array indexed by
    # tag-1 (unused rows are dropped later by the shared build step)
    nodes = coords[1:]

    elem_lines = section("Elements")
    n_blocks = int(elem_lines[0].split()[0])
    row = 1
    blocks = {}
    for _ in range(n_blocks):
        edim, etag, etype, n_in_block = [int(v)
                                         for v in elem_lines[row].split()]
        row += 1
        phys = entity_phys.get((edim, etag), 0)
        if etype in _MSH_CELL_TYPES:
            name, nv = _MSH_CELL_TYPES[etype]
            for i in range(n_in_block):
                parts = [int(v) for v in elem_lines[row + i].split()]
                conn = [v - 1 for v in parts[1:1 + nv]]
                blocks.setdefault(name, []).append((phys, conn))
        row += n_in_block
    return nodes, blocks


def _build_mesh(nodes, blocks):
    if "tetra" in blocks:
        dim, cell_name, facet_name = 3, "tetra", "triangle"
    else:
        dim, cell_name, facet_name = 2, "triangle", "line"
    if cell_name not in blocks:
        raise ValueError("mesh contains no volume cells")

    cells = np.array([c for _, c in blocks[cell_name]], dtype=np.int32)
    points = nodes[:, :dim]
    # drop unused points (gmsh may emit construction nodes)
    used = np.unique(cells)
    remap = np.full(len(points), -1, dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    mesh = SimplexMesh(points[used], remap[cells])

    facet_ids, values = [], []
    if facet_name in blocks:
        lookup = {tuple(sorted(f)): i for i, f in enumerate(
            mesh.facets.tolist())}
        for phys, conn in blocks[facet_name]:
            key = tuple(sorted(remap[np.array(conn)].tolist()))
            if -1 in key or key not in lookup:
                continue
            facet_ids.append(lookup[key])
            values.append(phys)
    markers = FacetMarkers(np.array(facet_ids, dtype=np.int32),
                           np.array(values, dtype=np.int32))
    return mesh, markers


def read_geo_msh(geo_filename: str):
    """Full pipeline: parse marker names from the .geo, read/generate the
    matching .msh, return ``(mesh, markers, marker_map)``.

    Equivalent of the reference's ``_read_external_mesh``
    (grid_generator.py:406-437).
    """
    marker_map = extract_facet_markers(geo_filename)
    msh = generate_msh(geo_filename)
    mesh, markers = read_msh(msh)
    return mesh, markers, marker_map


def write_msh(filename: str, mesh, markers=None, cell_physical=1):
    """Write a legacy MSH 2.2 ASCII file (nodes, marked facets, cells).

    The inverse of :func:`read_msh`: volume cells carry physical tag
    ``cell_physical``; marked facets are emitted as codim-1 elements with
    their marker value as the physical tag.  Useful for exporting
    built-in meshes to gmsh-toolchain users and for shipping pre-meshed
    assets next to their ``.geo`` sources (the reference distributes
    exactly such pairs via its gmsh-collection submodule,
    .gitmodules:1-3).
    """
    dim = mesh.dim
    etype_cell = 4 if dim == 3 else 2        # tetra / triangle
    etype_facet = 2 if dim == 3 else 1       # triangle / line
    with open(filename, "w") as fh:
        fh.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n{len(mesh.points)}\n")
        for i, pt in enumerate(mesh.points):
            xyz = list(pt) + [0.0] * (3 - dim)
            # 17 significant digits: every float64 reads back exactly
            fh.write(f"{i + 1} {xyz[0]:.17g} {xyz[1]:.17g} {xyz[2]:.17g}\n")
        fh.write("$EndNodes\n")
        n_f = 0 if markers is None else len(markers.facet_ids)
        fh.write(f"$Elements\n{n_f + len(mesh.cells)}\n")
        eid = 1
        if markers is not None:
            for fid, val in zip(markers.facet_ids, markers.values):
                conn = " ".join(str(v + 1) for v in mesh.facets[fid])
                fh.write(f"{eid} {etype_facet} 2 {val} {val} {conn}\n")
                eid += 1
        for cell in mesh.cells:
            conn = " ".join(str(v + 1) for v in cell)
            fh.write(f"{eid} {etype_cell} 2 {cell_physical} "
                     f"{cell_physical} {conn}\n")
            eid += 1
        fh.write("$EndElements\n")
    return filename
