"""Linear algebra: conjugate gradients and the smoothed-aggregation AMG."""

from navierstokes_tpu_torch.linalg.krylov import (  # noqa: F401
    bicgstab,
    cg,
    gmres,
    jacobi_preconditioner,
    masked_spd_solve,
)
