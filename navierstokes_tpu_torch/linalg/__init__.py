"""Linear algebra: conjugate gradients and the smoothed-aggregation AMG."""

from navierstokes_tpu_torch.linalg.krylov import cg  # noqa: F401
