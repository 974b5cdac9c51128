"""Time-axis bookkeeping and time-integration coefficient generators.

Counterpart of ``navierstokes_tpu/timestepping/``: pure Python (host side,
``math`` and ``enum`` only), the port's own copy.  These produce scalar
coefficients that the solver steps take as Python floats, so changing dt or
the scheme coefficients builds no device tensor.
"""

from navierstokes_tpu_torch.timestepping.discrete_time import (  # noqa: F401
    DiscreteTime,
    calculate_next_time,
)
from navierstokes_tpu_torch.timestepping.bdf import BDFTimeStepping  # noqa: F401
from navierstokes_tpu_torch.timestepping.theta import (  # noqa: F401
    GeneralThetaTimeStepping,
    ThetaTimeSteppingType,
)
from navierstokes_tpu_torch.timestepping.imex import (  # noqa: F401
    IMEXTimeStepping,
    IMEXType,
)
