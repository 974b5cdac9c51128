"""Discrete time axis with end-time snapping.

Behavioral parity with the reference's ``source/discrete_time.py`` (the time
axis is a host-side scalar state machine; nothing here touches the device):

* ``calculate_next_time`` snaps the next time level onto the end time whenever
  the step would land within 5% of a step size of it, avoiding a tiny final
  step (reference: discrete_time.py:5-26).
* ``advance_time`` keeps the previous step size as the proposal for the next
  step (reference: discrete_time.py:138-153).
"""

from __future__ import annotations

_RELATIVE_SNAP_TOLERANCE = 0.05


def calculate_next_time(current_time: float, step_size: float,
                        end_time: float) -> float:
    """Next time level; snapped to ``end_time`` if within 5% of the step."""
    if not (step_size >= 0.0):
        raise ValueError(f"step size must be non-negative, got {step_size}")
    if not (end_time >= current_time):
        raise ValueError("end time lies before the current time")
    next_time = current_time + step_size
    if next_time > end_time - _RELATIVE_SNAP_TOLERANCE * step_size:
        next_time = end_time
    return next_time


class DiscreteTime:
    """Tracks previous/current/next time levels and the step counter."""

    def __init__(self, start_time: float, end_time: float,
                 desired_start_time_step: float = 0.0):
        start_time = float(start_time)
        end_time = float(end_time)
        desired_start_time_step = float(desired_start_time_step)
        if not start_time < end_time:
            raise ValueError("start time must precede end time")
        if desired_start_time_step < 0.0:
            raise ValueError("start step must be non-negative")

        self._start_time = start_time
        self._end_time = end_time
        self._previous_time = start_time
        self._current_time = start_time
        self._next_time = calculate_next_time(start_time,
                                              desired_start_time_step,
                                              end_time)
        self._start_step_size = self._next_time - start_time
        self._step_number = 0

    # -- inspection -------------------------------------------------------
    @property
    def start_time(self) -> float:
        return self._start_time

    @property
    def end_time(self) -> float:
        return self._end_time

    @property
    def previous_time(self) -> float:
        return self._previous_time

    @property
    def current_time(self) -> float:
        return self._current_time

    @property
    def next_time(self) -> float:
        return self._next_time

    @property
    def step_number(self) -> int:
        return self._step_number

    def is_at_start(self) -> bool:
        return self._step_number == 0

    def is_at_end(self) -> bool:
        return self._current_time == self._end_time

    def get_next_step_size(self) -> float:
        return self._next_time - self._current_time

    def get_previous_step_size(self) -> float:
        return self._current_time - self._previous_time

    def __str__(self) -> str:
        return ("step number {0:8d}, current time {1:10.2e}, "
                "next step size {2:10.2e}".format(self._step_number,
                                                  self._current_time,
                                                  self.get_next_step_size()))

    # -- mutation ---------------------------------------------------------
    def set_desired_next_step_size(self, next_step_size: float) -> None:
        next_step_size = float(next_step_size)
        if not next_step_size > 0.0:
            raise ValueError("step size must be positive")
        self._next_time = calculate_next_time(self._current_time,
                                              next_step_size, self._end_time)

    def advance_time(self) -> None:
        if not self._next_time > self._current_time:
            raise RuntimeError("next time level does not advance")
        step_size = self.get_next_step_size()
        self._previous_time = self._current_time
        self._current_time = self._next_time
        self._step_number += 1
        self._next_time = calculate_next_time(self._current_time, step_size,
                                              self._end_time)

    def restart(self) -> None:
        self._previous_time = self._start_time
        self._current_time = self._start_time
        self._next_time = calculate_next_time(self._start_time,
                                              self._start_step_size,
                                              self._end_time)
        self._step_number = 0

    def set_end_time(self, new_end_time: float) -> None:
        new_end_time = float(new_end_time)
        if not (new_end_time > self._start_time
                and new_end_time > self._current_time):
            raise ValueError("new end time must lie in the future")
        self._end_time = new_end_time
        if self._step_number == 0:
            step_size = self._start_step_size
        else:
            step_size = self.get_previous_step_size()
        self._next_time = calculate_next_time(self._current_time, step_size,
                                              self._end_time)
