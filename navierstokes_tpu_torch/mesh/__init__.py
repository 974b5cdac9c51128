"""Mesh layer: simplex meshes, structured generators, boundary markers."""

from navierstokes_tpu_torch.mesh.core import (  # noqa: F401
    FacetMarkers,
    SimplexMesh,
    merge_markers,
)
from navierstokes_tpu_torch.mesh.generators import (  # noqa: F401
    hyper_cube,
    hyper_rectangle,
)
from navierstokes_tpu_torch.mesh.markers import (  # noqa: F401
    GeometryType,
    HyperCubeBoundaryMarkers,
    HyperRectangleBoundaryMarkers,
    SphericalAnnulusBoundaryMarkers,
    SymmetricPipeBoundaryMarkers,
)
