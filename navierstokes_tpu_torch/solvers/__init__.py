"""Time-step solvers.  Ported so far: the planar projection step and, on
top of it and the spectral step, the ``ProjectionSolver`` of the product
solver API with its bases."""

from navierstokes_tpu_torch.solvers.base import SolverBase  # noqa: F401
from navierstokes_tpu_torch.solvers.transient import (  # noqa: F401
    InstationarySolverBase,
)
from navierstokes_tpu_torch.solvers.projection import (  # noqa: F401
    ProjectionSolver,
)
