"""Periodic-signal estimators for limit-cycle force series (counterpart
of ``navierstokes_tpu/utils/signal.py``, pure NumPy).

The DFG drag/lift histories are smooth periodic signals (a shedding
fundamental plus a handful of harmonics).  f32 runs superimpose per-step
solver-truncation noise on them, and the raw maximum of a noisy series is
biased upward by ~sigma*sqrt(2 ln N) (extreme-value statistics).

``periodic_fit`` recovers the noise-free envelope: least-squares fit of K
harmonics of the shedding fundamental (the frequency refined by a
golden-section search on the LS residual), evaluated on a fine grid over
one period.  Its error on the max is O(sigma * sqrt(2K/N)).
"""

from __future__ import annotations

import numpy as np


def _design(t, f, K):
    """LS design matrix [1, cos(2*pi*k*f*t), sin(...)] for k=1..K."""
    w = 2.0 * np.pi * f * t[:, None] * np.arange(1, K + 1)[None, :]
    return np.hstack([np.ones((len(t), 1)), np.cos(w), np.sin(w)])


def _lstsq_sse(t, y, f, K):
    A = _design(t, f, K)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    r = y - A @ coef
    return float(r @ r), coef


def periodic_fit(t, y, K=10, f0=None, refine=0.05):
    """Fit ``y(t)`` with K harmonics of a refined fundamental frequency.

    Returns dict with ``freq``, ``coef``, ``sigma`` (residual std),
    ``max``/``min`` (extrema of the fitted signal over one period on a
    4096-point grid), and ``argmax`` (time of the fitted maximum within
    [t[0], t[0]+1/freq)).

    ``f0``: initial fundamental guess; default = FFT peak of the
    mean-removed series.  ``refine``: half-width of the relative
    frequency search interval around ``f0``.
    """
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    assert len(t) == len(y) and len(t) > 4 * (2 * K + 1)
    dt = np.median(np.diff(t))
    if f0 is None:
        yc = y - y.mean()
        amp = np.abs(np.fft.rfft(yc))
        freqs = np.fft.rfftfreq(len(yc), d=dt)
        f0 = float(freqs[np.argmax(amp[1:]) + 1])
        if f0 <= 0.0:
            raise ValueError("no dominant frequency found")

    # golden-section search of the LS residual over f in f0*(1 +- refine):
    # SSE(f) is smooth and unimodal near the true fundamental
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = f0 * (1.0 - refine), f0 * (1.0 + refine)
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, _ = _lstsq_sse(t, y, c, K)
    fd, _ = _lstsq_sse(t, y, d, K)
    for _ in range(60):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc, _ = _lstsq_sse(t, y, c, K)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd, _ = _lstsq_sse(t, y, d, K)
    f = 0.5 * (a + b)
    sse, coef = _lstsq_sse(t, y, f, K)
    dof = max(len(t) - (2 * K + 1), 1)
    sigma = np.sqrt(sse / dof)

    tt = t[0] + np.linspace(0.0, 1.0 / f, 4096, endpoint=False)
    yy = _design(tt, f, K) @ coef
    imax = int(np.argmax(yy))
    return {
        "freq": float(f),
        "coef": coef,
        "sigma": float(sigma),
        "max": float(yy[imax]),
        "min": float(yy.min()),
        "argmax": float(tt[imax]),
    }


def periodic_eval(fit, t):
    """Evaluate a ``periodic_fit`` result at times ``t``."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    K = (len(fit["coef"]) - 1) // 2
    return _design(t, fit["freq"], K) @ fit["coef"]
