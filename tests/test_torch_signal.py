"""Port parity: the harmonic-fit max estimator (utils/signal.py).

Pure NumPy on both sides: the same series gives the same fit, array for
array; and the port's estimator passes the JAX package's own checks
(tests/test_signal.py) on the same series.
"""

import numpy as np
import pytest

from navierstokes_tpu.utils import signal as jax_signal
from navierstokes_tpu_torch.utils.signal import periodic_eval, periodic_fit


def _series(noise, n=4000, dt=0.005, f=0.30):
    rng = np.random.default_rng(7)
    t = 100.0 + dt * np.arange(n)
    w = 2 * np.pi * f
    y = (3.2 + 0.05 * np.cos(w * t + 0.3) + 0.02 * np.cos(2 * w * t - 1.0)
         + 0.004 * np.sin(3 * w * t))
    return t, y, y + noise * rng.standard_normal(n)


@pytest.mark.parametrize("noise", [0.0, 0.01, 0.02])
def test_fit_equals_the_jax_package(noise):
    t, _, y = _series(noise)
    got = periodic_fit(t, y, K=6)
    want = jax_signal.periodic_fit(t, y, K=6)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), \
            key
    assert np.array_equal(periodic_eval(got, t[:50]),
                          jax_signal.periodic_eval(want, t[:50]))


def test_recovers_true_max_under_noise():
    t, y_clean, y_noisy = _series(noise=0.02)
    true_max = y_clean.max()
    assert y_noisy.max() - true_max > 0.04
    fit = periodic_fit(t, y_noisy, K=6)
    assert abs(fit["max"] - true_max) < 0.003
    assert abs(fit["freq"] - 0.30) < 1e-3
    assert 0.015 < fit["sigma"] < 0.025


def test_noise_free_is_exact():
    t, y_clean, _ = _series(noise=0.0)
    fit = periodic_fit(t, y_clean, K=6)
    assert abs(fit["max"] - y_clean.max()) < 1e-6
    assert fit["sigma"] < 1e-8
    assert np.allclose(periodic_eval(fit, t[:50]), y_clean[:50], atol=1e-8)


def test_argmax_phase():
    t, y_clean, y_noisy = _series(noise=0.01)
    fit = periodic_fit(t, y_noisy, K=6)
    T = 1.0 / fit["freq"]
    assert t[0] <= fit["argmax"] < t[0] + T
    i = np.argmax(y_clean[: int(T / 0.005) + 1])
    assert abs(fit["argmax"] - t[i]) < 0.05 * T
