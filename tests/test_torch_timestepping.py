"""Port parity: the time-stepping bookkeeping (timestepping/).

Pure Python on both sides, so every class of the port is driven through
the same scripted sequences as its JAX-package counterpart -- fixed steps,
the canonical variable-step schedule of the golden-value tests, a restart,
a change of end time and a seeded random walk -- and everything a solver
reads (coefficient tuples, change flags, times, step sizes, step numbers,
the printed tables) must be equal with ``==``, not to a tolerance.
"""

import math

import numpy as np
import pytest

from navierstokes_tpu import timestepping as jts
from navierstokes_tpu_torch import timestepping as tts

# the canonical schedule of tests/test_{bdf,theta,imex}_time_stepping.py
STEP_SIZES = [1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 1.0]
FIXED = [0.5] * 18
CHANGE = [0.25] * 4 + [0.75] * 10 + [0.1] * 5


def _time_state(ts):
    return (ts.step_number, ts.start_time, ts.end_time, ts.previous_time,
            ts.current_time, ts.next_time, ts.get_next_step_size(),
            ts.get_previous_step_size(), ts.is_at_start(), ts.is_at_end(),
            str(ts))


def _bdf_state(ts):
    return tuple((ts.coefficients(d), ts.coefficients_changed(d),
                  ts.n_levels(d)) for d in (1, 2)) \
        + (ts.n_substeps, ts.coefficient_table())


def _theta_state(ts):
    return (ts.theta, ts.intermediate_times, ts.intermediate_timesteps,
            ts.n_levels, ts.n_steps, ts.n_substeps)


def _imex_state(ts):
    return (ts.alpha, ts.beta, ts.gamma, ts.eta, ts.coefficients_changed,
            ts.n_levels, ts.n_substeps, ts.coefficient_table())


def _none_state(ts):
    return ()


def _make(mod, kind, end_time, **kw):
    """(instance, coefficient reader) of one class of package ``mod``."""
    if kind == "time":
        return mod.DiscreteTime(0.0, end_time, **kw), _none_state
    if kind.startswith("bdf"):
        return mod.BDFTimeStepping(0.0, end_time, order=int(kind[3:]),
                                   **kw), _bdf_state
    family, name = kind.split(":")
    if family == "theta":
        return mod.GeneralThetaTimeStepping(
            0.0, end_time, getattr(mod.ThetaTimeSteppingType, name),
            **kw), _theta_state
    return mod.IMEXTimeStepping(0.0, end_time, getattr(mod.IMEXType, name),
                                **kw), _imex_state


def _walk(ts, read, sizes, trace):
    """Step to the end, asking for ``sizes[n]`` at step n (the last size
    again once they run out)."""
    while not ts.is_at_end():
        n = min(ts.step_number, len(sizes) - 1)
        ts.set_desired_next_step_size(sizes[n])
        if hasattr(ts, "update_coefficients"):
            ts.update_coefficients()
        trace.append((_time_state(ts), read(ts)))
        ts.advance_time()
        trace.append(_time_state(ts))


def _drive(mod, kind, script):
    """The trace of one scripted sequence on package ``mod``."""
    trace = []
    if script == "fixed":
        ts, read = _make(mod, kind, 9.0, desired_start_time_step=0.5)
        trace.append(_time_state(ts))
        _walk(ts, read, FIXED, trace)
    elif script == "change":
        ts, read = _make(mod, kind, 9.0)
        _walk(ts, read, CHANGE, trace)
    elif script == "restart":
        ts, read = _make(mod, kind, 9.0)
        for _sweep in range(2):
            _walk(ts, read, STEP_SIZES, trace)
            ts.restart()
            trace.append(_time_state(ts))
    elif script == "end_time":
        ts, read = _make(mod, kind, 5.0)
        _walk(ts, read, STEP_SIZES, trace)
        ts.set_end_time(9.0)
        trace.append(_time_state(ts))
        _walk(ts, read, STEP_SIZES, trace)
    else:
        rng = np.random.default_rng(42)
        ts, read = _make(mod, kind, 5.0)
        sizes = [float(rng.random()) + 1e-6 for _ in range(200)]
        _walk(ts, read, sizes, trace)
    assert ts.is_at_end() or script == "restart"
    return trace


KINDS = ["time", "bdf1", "bdf2",
         "theta:ForwardEuler", "theta:BackwardEuler", "theta:CrankNicolson",
         "theta:FractionalStep01", "theta:FractionalStep02",
         "imex:SBDF2", "imex:CNAB", "imex:mCNAB", "imex:CNLF"]


@pytest.mark.parametrize("script", ["fixed", "change", "restart", "end_time",
                                    "random"])
@pytest.mark.parametrize("kind", KINDS)
def test_sequences_equal_jax_package(kind, script):
    got, want = _drive(tts, kind, script), _drive(jts, kind, script)
    assert len(got) == len(want) > 10
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"entry {i}"


def test_snapping_rule():
    """The 5 % end-time snapping of ``calculate_next_time``."""
    cases = [(0.0, 0.5, 5.0), (4.0, 0.97, 5.0), (4.9, 0.2, 5.0),
             (4.5, 0.5, 5.0)]
    want = [0.5, 5.0, 5.0, 5.0]
    assert [tts.calculate_next_time(*c) for c in cases] == want
    assert [jts.calculate_next_time(*c) for c in cases] == want


def test_port_golden_values():
    """Spot checks of the port alone against the hand-derived tables: the
    variable-step BDF-2 / SBDF-2 weights at the 1 -> 2 step-size change
    and the fractional-step theta."""
    bdf = tts.BDFTimeStepping(0.0, 9.0, order=2)
    imex = tts.IMEXTimeStepping(0.0, 9.0, tts.IMEXType.SBDF2)
    for ts in (bdf, imex):
        for n in range(3):
            ts.set_desired_next_step_size(STEP_SIZES[n])
            ts.update_coefficients()
            if n < 2:
                ts.advance_time()
    assert bdf.coefficients(1) == (5.0 / 3.0, -3.0, 4.0 / 3.0)
    assert bdf.coefficients(2) == (3.0, -14.0, 16.0, -5.0)
    assert imex.alpha == [5.0 / 3.0, -3.0, 4.0 / 3.0]
    assert imex.eta == [3.0, -2.0]
    theta = 1.0 - math.sqrt(2.0) / 2.0
    fs = tts.GeneralThetaTimeStepping(
        0.0, 9.0, tts.ThetaTimeSteppingType.FractionalStep02)
    fs.set_desired_next_step_size(1.0)
    fs.update_coefficients()
    assert fs.intermediate_timesteps == [theta, 1.0 - 2.0 * theta, theta]
    assert fs.n_substeps == 3


def test_port_classes_are_its_own():
    """The port keeps its own copy: none of its classes is the JAX
    package's."""
    for name in ("DiscreteTime", "BDFTimeStepping",
                 "GeneralThetaTimeStepping", "ThetaTimeSteppingType",
                 "IMEXTimeStepping", "IMEXType", "calculate_next_time"):
        obj = getattr(tts, name)
        assert obj is not getattr(jts, name)
        assert obj.__module__.startswith("navierstokes_tpu_torch.")
