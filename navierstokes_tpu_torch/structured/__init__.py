"""Structured-mesh fast path: class grids, stencil ops, spectral solves."""

from navierstokes_tpu_torch.structured.grid import (NotStructured,
                                                    PeriodicStructuredTH)
from navierstokes_tpu_torch.structured.ops import (StructuredConvection,
                                                   apply_pp, apply_pu,
                                                   apply_up, apply_uu)
from navierstokes_tpu_torch.structured.spectral import (
    SpectralOperators, build_spectral_projection_step)

__all__ = [
    "NotStructured", "PeriodicStructuredTH", "StructuredConvection",
    "apply_pp", "apply_pu", "apply_up", "apply_uu", "SpectralOperators",
    "build_spectral_projection_step",
]
