"""Boundary-marker enumerations (``navierstokes_tpu/mesh/markers.py``).

The same enums and integer values as the JAX package, so marker ids carry
over between the two packages unchanged.
"""

from __future__ import annotations

from enum import Enum, auto


class GeometryType(Enum):
    spherical_annulus = auto()
    rectangle = auto()
    square = auto()
    other = auto()


class SphericalAnnulusBoundaryMarkers(Enum):
    interior_boundary = auto()
    exterior_boundary = auto()


class SymmetricPipeBoundaryMarkers(Enum):
    wall = 100
    symmetry = 101
    inlet = 102
    outlet = 103


class HyperCubeBoundaryMarkers(Enum):
    left = auto()
    right = auto()
    bottom = auto()
    top = auto()
    back = auto()
    front = auto()
    opening = auto()


HyperRectangleBoundaryMarkers = HyperCubeBoundaryMarkers
