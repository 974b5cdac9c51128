"""Variable-step BDF coefficient generation (orders 1 and 2).

Generates the backward-differentiation weights for first and second time
derivatives on a non-uniform time grid, parameterized by the step ratios

    omega = k_{n+1} / k_n          (current over previous step)
    Omega = k_n / k_{n-1}          (previous ratio, lagged one step)

The d-th derivative at t_{n+1} is approximated as

    d^d u/dt^d  ~=  sum_i alpha_i u_{n+1-i} / k_{n+1}^d

Closed forms below are the standard variable-step BDF weights (derivable by
differentiating the interpolating Newton polynomial; cf. the reference's
Mathematica derivation ``mathematica/BDFCoefficients.nb`` and the golden
tables in ``tests/test_bdf_time_stepping.py``).  The first step always uses
the first-order weights since no history exists yet
(reference: source/bdf_time_stepping.py:29-36).
"""

from __future__ import annotations

import math

from navierstokes_tpu_torch.timestepping.discrete_time import DiscreteTime


def bdf1_weights_d1() -> tuple:
    """First derivative, two levels (backward Euler)."""
    return (1.0, -1.0)


def bdf2_weights_d1(omega: float) -> tuple:
    """First derivative, three levels, variable step."""
    return ((1.0 + 2.0 * omega) / (1.0 + omega),
            -(1.0 + omega),
            omega * omega / (1.0 + omega))


def weights_d2_three_level(omega: float) -> tuple:
    """Second derivative from three levels (first order)."""
    return (2.0 * omega / (1.0 + omega),
            -2.0 * omega,
            2.0 * omega * omega / (1.0 + omega))


def weights_d2_four_level(omega: float, Omega: float) -> tuple:
    """Second derivative from four levels (second order), variable step."""
    a0 = (2.0 * omega * (1.0 + (2.0 + 3.0 * omega) * Omega)
          / ((1.0 + omega) * (1.0 + Omega + omega * Omega)))
    a1 = (-2.0 * omega * (1.0 + 2.0 * (1.0 + omega) * Omega)
          / (1.0 + Omega))
    a2 = (2.0 * omega ** 2 * (1.0 + Omega + 2.0 * omega * Omega)
          / (1.0 + omega))
    a3 = (-2.0 * omega ** 2 * (1.0 + 2.0 * omega) * Omega ** 3
          / ((1.0 + Omega) * (1.0 + Omega + omega * Omega)))
    return (a0, a1, a2, a3)


class BDFTimeStepping(DiscreteTime):
    """Adaptive-step BDF coefficients for 1st and 2nd time derivatives.

    API parity with the reference's ``BDFTimeStepping``
    (source/bdf_time_stepping.py): ``coefficients(derivative)`` returns the
    alpha tuple, ``coefficients_changed(derivative)`` reports whether the last
    ``update_coefficients()`` altered it (used by solvers to skip pushing new
    scalars into the jitted step).
    """

    def __init__(self, start_time: float, end_time: float, order: int = 2,
                 desired_start_time_step: float = 0.0):
        super().__init__(start_time, end_time, desired_start_time_step)
        if not isinstance(order, int) or order < 1:
            raise ValueError("order must be a positive integer")
        if order > 2:
            raise NotImplementedError("BDF order > 2 not implemented")
        self._order = order
        self._reset_coefficient_state()

    def _reset_coefficient_state(self) -> None:
        self._changed = {1: True, 2: True}
        self._ratios = [1.0, 1.0]  # [omega, Omega]
        # first step: first-order weights regardless of nominal order
        n1 = self._order + 1
        self._alpha = {
            1: [*bdf1_weights_d1()] + [0.0] * (n1 - 2),
            2: [1.0, -2.0, 1.0] + [0.0] * (self._order - 1),
        }

    def restart(self) -> None:
        super().restart()
        self._reset_coefficient_state()

    # -- coefficient updates ------------------------------------------------
    def update_coefficients(self) -> None:
        if self.step_number == 0:
            # first step keeps the startup (first-order) weights
            return
        omega = self.get_next_step_size() / self.get_previous_step_size()
        if not (math.isfinite(omega) and omega > 0.0):
            raise RuntimeError(f"invalid step ratio {omega}")
        Omega = self._ratios[0]

        same_omega = (self._ratios[0] == omega)
        same_Omega = (self._ratios[1] == Omega)
        past_startup = self.step_number > 1

        if self._order == 1:
            if same_omega and past_startup:
                self._changed = {1: False, 2: False}
                return
            self._ratios = [omega, Omega]
            self._alpha[1][:2] = bdf1_weights_d1()
            self._alpha[2][:3] = weights_d2_three_level(omega)
            # the d/dt weights of BDF-1 are step-size independent
            self._changed = {1: False, 2: True}
            return

        # order == 2
        if same_omega and same_Omega and past_startup:
            self._changed = {1: False, 2: False}
            return
        if same_omega and past_startup:
            # only the lagged ratio moved: d/dt weights are unaffected
            self._ratios[1] = Omega
            self._alpha[2][:4] = weights_d2_four_level(omega, Omega)
            self._changed = {1: False, 2: True}
            return
        self._ratios = [omega, Omega]
        self._alpha[1][:3] = bdf2_weights_d1(omega)
        self._alpha[2][:4] = weights_d2_four_level(omega, Omega)
        self._changed = {1: True, 2: True}

    # -- accessors ------------------------------------------------------------
    def coefficients(self, derivative: int) -> tuple:
        assert derivative in (1, 2)
        return tuple(self._alpha[derivative])

    def coefficients_changed(self, derivative: int) -> bool:
        assert derivative in (1, 2)
        return self._changed[derivative]

    def n_levels(self, derivative: int = 1) -> int:
        """Number of previous-step solutions the scheme requires."""
        assert derivative in (1, 2)
        return len(self._alpha[derivative]) - 1

    @property
    def n_substeps(self) -> int:
        return 1

    def coefficient_table(self) -> str:
        """ASCII table of the current weights (one row per derivative)."""
        levels = ("n + 1", "n", "n - 1", "n - 2")
        n_levels = 2 + self._order
        sep = "+-" + "-+-".join((n_levels + 1) * (12 * "-",)) + "-+"
        lines = [sep]
        header = "| {:12} | ".format("derivative")
        header += " | ".join("{:12}".format(x) for x in levels[:n_levels])
        lines.append(header + " |")
        for d in (1, 2):
            coeffs = self._alpha[d]
            name = "1st" if d == 1 else "2nd"
            row = "| {:12} | ".format(name)
            row += " | ".join("{:12.2e}".format(c) for c in coeffs)
            pad = n_levels - len(coeffs)
            if pad > 0:
                row += " | " + " | ".join(pad * (12 * " ",))
            lines.append(row + " |")
        lines.append(sep)
        return "\n".join(lines)

    def print_coefficients(self) -> None:
        print(self.coefficient_table())
