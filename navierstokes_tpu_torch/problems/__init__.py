"""Application-facing problem orchestration: the Problem classes (hooks
API, time loop, output), dimensionless coefficients, rotating frames and
the postprocessing of derived fields."""

from navierstokes_tpu_torch.problems.coefficients import (  # noqa: F401
    EquationCoefficientHandler,
)
from navierstokes_tpu_torch.problems.rotation import (  # noqa: F401
    AngularVelocityVector,
    FunctionTime,
)
from navierstokes_tpu_torch.problems.base import (  # noqa: F401,E402
    InstationaryProblem,
    ProblemBase,
    StationaryProblem,
)
