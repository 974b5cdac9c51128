"""Navier-Stokes solvers: the projection step, stationary Picard->Newton,
monolithic BDF, theta and IMEX, and IPCS."""

from navierstokes_tpu_torch.solvers.base import SolverBase  # noqa: F401
from navierstokes_tpu_torch.solvers.stationary import (  # noqa: F401
    StationarySolver,
    StationarySolverBase,
)
from navierstokes_tpu_torch.solvers.transient import (  # noqa: F401
    InstationarySolverBase,
)
from navierstokes_tpu_torch.solvers.bdf import ImplicitBDFSolver  # noqa: F401
from navierstokes_tpu_torch.solvers.ipcs import IPCSSolver  # noqa: F401
from navierstokes_tpu_torch.solvers.projection import (  # noqa: F401
    ProjectionSolver,
)
from navierstokes_tpu_torch.solvers.theta import ThetaSolver  # noqa: F401
from navierstokes_tpu_torch.solvers.imex import IMEXSolver  # noqa: F401
