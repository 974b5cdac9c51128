"""Mesh layer: simplex meshes, generators, boundary markers."""

from navierstokes_tpu_torch.mesh.core import (  # noqa: F401
    FacetMarkers,
    SimplexMesh,
    boundary_normal,
    extract_all_boundary_markers,
    merge_markers,
)
from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    channel_with_cylinder,
    circle_snap,
    hyper_cube,
    hyper_rectangle,
    open_hyper_cube,
    sphere_snap,
)
from navierstokes_tpu_torch.mesh.markers import (  # noqa: F401
    GeometryType,
    HyperCubeBoundaryMarkers,
    HyperRectangleBoundaryMarkers,
    SphericalAnnulusBoundaryMarkers,
    SymmetricPipeBoundaryMarkers,
)
