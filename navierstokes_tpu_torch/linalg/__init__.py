"""Linear algebra: Krylov solvers, direct solves, the Newton loop, the
smoothed-aggregation AMG and the PCD block preconditioners."""

from navierstokes_tpu_torch.linalg.krylov import (  # noqa: F401
    bicgstab,
    cg,
    gmres,
    jacobi_preconditioner,
    masked_spd_solve,
)
from navierstokes_tpu_torch.linalg.direct import dense_solve  # noqa: F401
from navierstokes_tpu_torch.linalg.newton import (  # noqa: F401
    NewtonResult,
    newton_solve,
)
