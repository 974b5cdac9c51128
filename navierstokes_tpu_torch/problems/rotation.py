"""Time-dependent rotating-frame angular velocity.

``FunctionTime`` is the user-facing virtual base (value()/derivative()) and
``AngularVelocityVector`` wraps it, caching the current angular velocity and
-- if the subclass implements it -- the angular acceleration used by the
Euler force term.  Parity with the reference
(source/auxiliary_classes.py:12-117), minus dolfin Constants: values are
plain floats/tuples fed into the step as plain scalars.
"""

from __future__ import annotations


class FunctionTime:
    """Virtual scalar/vector function of time: override value()/derivative()."""

    def __init__(self, value_size: int, current_time: float = 0.0):
        assert isinstance(value_size, int) and value_size > 0
        self._value_size = value_size
        self._current_time = float(current_time)

    def set_time(self, current_time: float) -> None:
        current_time = float(current_time)
        assert current_time >= self._current_time
        self._current_time = current_time

    @property
    def current_time(self) -> float:
        return self._current_time

    @property
    def value_size(self) -> int:
        return self._value_size

    def value(self):  # pragma: no cover
        raise NotImplementedError("override value() in the subclass")

    def derivative(self):  # pragma: no cover
        raise NotImplementedError("override derivative() in the subclass")


class AngularVelocityVector:
    """Angular velocity omega(t) (scalar in 2D, 3-vector in 3D) + optional
    angular acceleration alpha(t) = d omega/dt."""

    def __init__(self, space_dim: int = 2, function: FunctionTime = None):
        assert space_dim in (2, 3)
        self._space_dim = space_dim
        self._value_size = 1 if space_dim == 2 else 3
        self._current_time = 0.0
        self._omega = None
        self._alpha = None
        self._has_derivative = False
        if function is not None:
            self.set_angular_velocity_function(function)

    def set_angular_velocity_function(self, function: FunctionTime) -> None:
        assert isinstance(function, FunctionTime)
        assert function.value_size == self._value_size
        self._function = function
        self._omega = function.value()
        try:
            self._alpha = function.derivative()
            self._has_derivative = True
        except (NotImplementedError, RuntimeError):
            self._alpha = None
            self._has_derivative = False

    def set_time(self, current_time: float) -> None:
        current_time = float(current_time)
        assert current_time >= self._current_time
        self._current_time = current_time
        self._function.set_time(current_time)
        self._refresh()

    def _refresh(self) -> None:
        self._omega = self._function.value()
        if self._has_derivative:
            self._alpha = self._function.derivative()

    @property
    def space_dim(self) -> int:
        return self._space_dim

    @property
    def value(self):
        """Current angular velocity (float in 2D, tuple of 3 in 3D)."""
        assert self._omega is not None
        return self._omega

    @property
    def derivative(self):
        """Current angular acceleration, or None if not provided."""
        return self._alpha
