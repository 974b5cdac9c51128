"""Variable-step IMEX (implicit-explicit) two-step schemes.

Family parameterized by the pair ``(a, b)`` covering CNAB, modified CNAB,
CNLF and SBDF2 (cf. Ascher/Ruuth/Wetton).  Produces four coefficient sets:

* ``alpha`` -- weights of the discrete time derivative,
* ``beta``  -- extrapolation weights of the explicitly treated operator,
* ``gamma`` -- implicit/explicit splitting weights of the stiff operator,
* ``eta``   -- Taylor extrapolation weights (e.g. for convection velocity).

Behavioral parity with the reference's ``source/imex_time_stepping.py``
(declared there but never wired into a solver; here drives
``solvers.imex.IMEXSolver``).
"""

from __future__ import annotations

import math
from enum import Enum, auto

from navierstokes_tpu_torch.timestepping.discrete_time import DiscreteTime


class IMEXType(Enum):
    CNAB = auto()
    mCNAB = auto()
    CNLF = auto()
    SBDF2 = auto()


_IMEX_PARAMETERS = {
    IMEXType.SBDF2: (1.0, 0.0),
    IMEXType.CNAB: (0.5, 0.0),
    IMEXType.mCNAB: (0.5, 1.0 / 8.0),
    IMEXType.CNLF: (0.0, 1.0),
}


def imex_weights(a: float, b: float, omega: float):
    """(alpha, beta, gamma, eta) for step ratio ``omega = k_next/k_prev``."""
    alpha = [(1.0 + 2.0 * a * omega) / (1.0 + omega),
             (1.0 - 2.0 * a) * omega - 1.0,
             (2.0 * a - 1.0) * omega * omega / (1.0 + omega)]
    beta = [1.0 + a * omega, -a * omega]
    gamma = [a + b / (2.0 * omega),
             1.0 - a - (1.0 + 1.0 / omega) * b / 2.0,
             b / 2.0]
    eta = [1.0 + omega, -omega]
    return alpha, beta, gamma, eta


_FIRST_ORDER_STARTUP = ([1.0, -1.0, 0.0], [1.0, 0.0], [1.0, 0.0, 0.0],
                        [1.0, 0.0])


class IMEXTimeStepping(DiscreteTime):
    """Adaptive-step IMEX coefficients; first step is first order."""

    def __init__(self, start_time: float, end_time: float, imex_type,
                 desired_start_time_step: float = 0.0):
        super().__init__(start_time, end_time, desired_start_time_step)
        assert isinstance(imex_type, IMEXType)
        self._type = imex_type
        self._imex_parameters = _IMEX_PARAMETERS[imex_type]
        self._reset_coefficient_state()

    def _reset_coefficient_state(self) -> None:
        self._coefficients_changed = True
        self._omega = -1.0
        a, bt, g, e = _FIRST_ORDER_STARTUP
        self._alpha = list(a)
        self._beta = list(bt)
        self._gamma = list(g)
        self._eta = list(e)

    def restart(self) -> None:
        super().restart()
        self._reset_coefficient_state()

    def update_coefficients(self) -> None:
        if self.step_number == 0:
            return
        omega = self.get_next_step_size() / self.get_previous_step_size()
        if not (math.isfinite(omega) and omega > 0.0):
            raise RuntimeError(f"invalid step ratio {omega}")
        if self._omega == omega and self.step_number > 1:
            self._coefficients_changed = False
            return
        self._omega = omega
        a, b = self._imex_parameters
        self._alpha, self._beta, self._gamma, self._eta = \
            imex_weights(a, b, omega)
        self._coefficients_changed = True

    def coefficient_table(self) -> str:
        sep = "+-" + "-+-".join(4 * (12 * "-",)) + "-+"
        lines = [sep,
                 "| {:12} | {:12} | {:12} | {:12} |".format(
                     "coefficient", "n + 1", "n", "n - 1"),
                 "| {:12} | {:12.2e} | {:12.2e} | {:12.2e} |".format(
                     "alpha", *self._alpha),
                 "| {:12} | {} | {:12.2g} | {:12.2e} |".format(
                     "beta", 12 * " ", *self._beta),
                 "| {:12} | {:12.2e} | {:12.2e} | {:12.2g} |".format(
                     "gamma", *self._gamma),
                 "| {:12} | {} | {:12.2g} | {:12.2e} |".format(
                     "eta", 12 * " ", *self._eta),
                 sep]
        return "\n".join(lines)

    def print_coefficients(self) -> None:
        print(self.coefficient_table())

    @property
    def alpha(self):
        return self._alpha

    @property
    def beta(self):
        return self._beta

    @property
    def gamma(self):
        return self._gamma

    @property
    def eta(self):
        return self._eta

    @property
    def coefficients_changed(self) -> bool:
        return self._coefficients_changed

    @property
    def n_levels(self) -> int:
        return len(self._alpha) - 1

    @property
    def n_substeps(self) -> int:
        return 1
