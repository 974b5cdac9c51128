"""Mesh layer: simplex meshes, generators, boundary markers."""

from navierstokes_tpu_torch.mesh.core import (  # noqa: F401
    FacetMarkers,
    SimplexMesh,
    boundary_normal,
    extract_all_boundary_markers,
    merge_markers,
)
from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    backward_facing_step,
    blasius_plate,
    channel_with_cylinder,
    circle_snap,
    hyper_cube,
    hyper_rectangle,
    open_hyper_cube,
    sphere_snap,
    spherical_shell,
)
from navierstokes_tpu_torch.mesh.gmsh_io import (  # noqa: F401
    extract_facet_markers,
    read_geo_msh,
    read_msh,
    write_msh,
)
from navierstokes_tpu_torch.mesh.xdmf_io import (  # noqa: F401
    generate_xdmf_mesh,
    read_xdmf_mesh,
    write_xdmf_mesh,
)
from navierstokes_tpu_torch.mesh.markers import (  # noqa: F401
    GeometryType,
    HyperCubeBoundaryMarkers,
    HyperRectangleBoundaryMarkers,
    SphericalAnnulusBoundaryMarkers,
    SymmetricPipeBoundaryMarkers,
)
