"""Problem-level helpers: dimensionless coefficients and rotating frames
(own copies of ``navierstokes_tpu/problems/{coefficients,rotation}.py``;
the Problem classes come with the application layer)."""

from navierstokes_tpu_torch.problems.coefficients import (  # noqa: F401
    EquationCoefficientHandler,
)
from navierstokes_tpu_torch.problems.rotation import (  # noqa: F401
    AngularVelocityVector,
    FunctionTime,
)
