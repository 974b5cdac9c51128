"""Generalized theta / fractional-step-theta schemes.

Substep parameterization after V. John, *Finite Element Methods for
Incompressible Flow Problems* (2016), Tables 7.1/7.2: each substep carries a
4-tuple ``(theta_1, theta_2, theta_3, theta_4)`` weighting the implicit/
explicit operator and right-hand-side contributions.  Behavioral parity with
the reference's ``source/theta_time_stepping.py`` (which declares these
schemes but never wires them into a solver; here they drive
``solvers.theta.ThetaSolver``).
"""

from __future__ import annotations

import math
from enum import Enum, auto

from navierstokes_tpu_torch.timestepping.discrete_time import DiscreteTime


class ThetaTimeSteppingType(Enum):
    ForwardEuler = auto()
    BackwardEuler = auto()
    CrankNicolson = auto()
    FractionalStep01 = auto()
    FractionalStep02 = auto()


# the classical fractional-step constants
_THETA = 1.0 - math.sqrt(2.0) / 2.0
_ZETA = 1.0 - 2.0 * _THETA
_TAU = _ZETA / (1.0 - _THETA)
_ETA = 1.0 - _TAU


def _substep_tableau(scheme: ThetaTimeSteppingType):
    """Per-substep (theta1..theta4) tuples for each scheme."""
    t, z, tau, eta = _THETA, _ZETA, _TAU, _ETA
    if scheme is ThetaTimeSteppingType.ForwardEuler:
        return [(0.0, 1.0, 1.0, 0.0)]
    if scheme is ThetaTimeSteppingType.BackwardEuler:
        return [(1.0, 0.0, 0.0, 1.0)]
    if scheme is ThetaTimeSteppingType.CrankNicolson:
        return [(0.5, 0.5, 0.5, 0.5)]
    if scheme is ThetaTimeSteppingType.FractionalStep01:
        sub_outer = (tau * t, eta * t, eta * t, tau * t)
        sub_inner = (eta * z, tau * z, tau * z, eta * z)
        return [sub_outer, sub_inner, sub_outer]
    if scheme is ThetaTimeSteppingType.FractionalStep02:
        sub_outer = (tau * t, eta * t, t, 0.0)
        sub_inner = (eta * z, tau * z, 0.0, z)
        return [sub_outer, sub_inner, sub_outer]
    raise ValueError(f"unknown theta scheme {scheme}")  # pragma: no cover


class GeneralThetaTimeStepping(DiscreteTime):
    """Theta-family schemes incl. 3-substep fractional-step variants."""

    _theta = _THETA
    _zeta = _ZETA
    _tau = _TAU
    _eta = _ETA

    def __init__(self, start_time: float, end_time: float, theta_type,
                 desired_start_time_step: float = 0.0):
        super().__init__(start_time, end_time, desired_start_time_step)
        assert isinstance(theta_type, ThetaTimeSteppingType)
        self._type = theta_type
        self._Theta = _substep_tableau(theta_type)
        self._n_steps = len(self._Theta)
        self._clear_intermediate_state()

    def _clear_intermediate_state(self) -> None:
        self._intermediate_timesteps = [0.0] * self._n_steps
        self._intermediate_times = [[0.0] * self._n_steps for _ in range(2)]

    def restart(self) -> None:
        super().restart()
        self._clear_intermediate_state()

    def update_coefficients(self) -> None:
        """Recompute the substep sizes and substep start/end times."""
        k = self.get_next_step_size()
        assert math.isfinite(k)
        t0, t1 = self.current_time, self.next_time
        if self._n_steps == 3:
            th = self._theta
            self._intermediate_timesteps = [th * k, self._zeta * k, th * k]
            starts = [t0, t0 + th * k, t1 - th * k]
            ends = [t0 + th * k, t1 - th * k, t1]
            self._intermediate_times = [starts, ends]
        else:
            self._intermediate_timesteps[0] = k
            self._intermediate_times = [[t0], [t1]]

    @property
    def theta(self):
        return self._Theta

    @property
    def intermediate_timesteps(self):
        return self._intermediate_timesteps

    @property
    def intermediate_times(self):
        return self._intermediate_times

    @property
    def n_levels(self) -> int:
        return 1

    @property
    def n_steps(self) -> int:
        return self._n_steps

    @property
    def n_substeps(self) -> int:
        return self._n_steps
