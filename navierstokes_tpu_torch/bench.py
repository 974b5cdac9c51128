"""Benchmark: Taylor-Green vortex, semi-implicit projection steps on the
card (counterpart of ``bench.py``).

    python -m navierstokes_tpu_torch.bench

Measures sustained DoF-steps/s (assembly + solve) of the port's two hot
paths on the periodic Taylor-Green vortex (Re = 100, dt = 1e-3, Taylor-Hood
P2/P1) at 128^2 (2D) or the triply periodic shear wave at 48^3 (3D):

* ``structured`` -- the class-grid spectral step
  (``structured.build_spectral_projection_step``);
* ``generic``    -- the banded engine (``assembly.fastop.FastTaylorHood``)
  with fixed-iteration Jacobi-PCG solves
  (``solvers.planar_step.build_planar_projection_step``): with
  ``cg_rtol`` None every square solve is one launch of the hand-written
  ``circulant_pcg`` kernel and every band matvec outside it one
  ``circulant_apply``.

Knobs (environment, read at import): ``NS_BENCH_DIM`` (2), ``NS_BENCH_N``
(128 in 2D, 48 in 3D), ``NS_BENCH_STEPS`` (200), ``NS_BENCH_PATH`` (the
primary metric: ``structured`` or ``generic``), ``NS_BENCH_LOOP``:

* ``scan``     (default) -- chunks of ``NS_BENCH_CHUNK`` (50) steps, each
  one CUDA graph replay (``utils.graph.ChunkLoop``): the counterpart of
  ``bench.py``'s ``lax.scan`` chunk, one device dispatch per chunk;
* ``dispatch`` -- one eager step per host iteration.

and, for the generic path, ``NS_BENCH_POISSON`` (``jacobi``, or ``amg``
for AMG-preconditioned CG on the pressure Poisson solve with
``NS_BENCH_PITERS`` (10) iterations) and ``NS_BENCH_PSWEEPS`` (the Jacobi
sweeps of the Poisson solve, default max(60, 60 N / 128)).

The CLI runs in float32 (``bench.py`` as the TPU runs it, x64 off); the
path functions take a ``dtype``.  It runs on the card and raises without
one.  ``BASELINE_DOF_STEPS_PER_SEC`` is ``bench.py``'s proxy for the
reference (FEniCS assembly + sparse-direct solves on a workstation CPU).

Prints ONE JSON line: ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``paths``, ``quality``) plus ``loop`` and
``device`` (the card's name and power limit as nvidia-smi reports them).
A path whose state is not finite or whose amplitude is 5 % or more off the
analytic decay reads 0; a path that raises reads 0, with its error under
``"<path>_error"``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.utils.graph import ChunkLoop

BASELINE_DOF_STEPS_PER_SEC = 3.0e5
DIM = int(os.environ.get("NS_BENCH_DIM", "2"))
N_POINTS = int(os.environ.get("NS_BENCH_N", "128" if DIM == 2 else "48"))
N_STEPS = int(os.environ.get("NS_BENCH_STEPS", "200"))
PATH = os.environ.get("NS_BENCH_PATH", "structured")
LOOP = os.environ.get("NS_BENCH_LOOP", "scan")
CHUNK = int(os.environ.get("NS_BENCH_CHUNK", "50"))
POISSON = os.environ.get("NS_BENCH_POISSON", "jacobi")
P_ITERS = int(os.environ.get("NS_BENCH_PITERS", "10"))
P_SWEEPS = int(os.environ.get("NS_BENCH_PSWEEPS",
                              str(max(60, 60 * N_POINTS // 128))))
RE = 100.0
DT = 1.0e-3
# SBDF coefficients (bench.py:81-86): BDF-1 for the first step, then BDF-2
ALPHA1, ETA1 = (1.0, -1.0, 0.0), (1.0, 0.0)
ALPHA2, ETA2 = (1.5, -2.0, 0.5), (2.0, -1.0)
N_WARMUP = 4


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _tg_amp_err(amp_max, n_steps_total, dim):
    """Relative error of max|u| against the analytic decay e^{-rate t}
    after ``n_steps_total`` steps of DT (rate 2 nu g^2 for the 2D vortex,
    nu g^2 for the 3D shear wave), rounded to 5 digits as in bench.py."""
    g = 2.0 * math.pi
    rate = (2.0 if dim == 2 else 1.0) * (1.0 / RE) * g * g
    expected = math.exp(-rate * n_steps_total * DT)
    return round(abs(float(amp_max) - expected) / expected, 5)


def _n_total(loop, chunk, n_steps, n_timed):
    """Steps taken in all: the warm-up, then (scan) the untimed chunk and
    the timed chunks, or (dispatch) the timed steps."""
    return N_WARMUP + (chunk + n_timed if loop == "scan" else n_steps)


def _march(step_fn, state, *, loop, chunk, n_steps, device, report):
    """The timed part of a path: ``(state, elapsed, n_timed)``.

    ``scan``: a ChunkLoop of ``chunk`` steps (on the card: captured after a
    warm-up step), one untimed chunk (the counterpart of bench.py's
    compiling call), then max(1, (n_steps - chunk) // chunk) timed chunks.
    ``dispatch``: ``n_steps`` eager steps."""
    if loop == "scan":
        chunks = ChunkLoop(step_fn, state, chunk, device)
        chunks.run()
        _sync(device)
        n_chunks = max(1, (n_steps - chunk) // chunk)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            chunks.run()
        _sync(device)
        elapsed = time.perf_counter() - t0
        if report is not None:
            report.update(capture_seconds=chunks.capture_seconds,
                          captured_launches=chunks.captured_launches,
                          replays=chunks.replays)
        return chunks.state, elapsed, n_chunks * chunk
    if loop != "dispatch":
        raise ValueError(f"loop {loop!r}: expected 'scan' or 'dispatch'")
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step_fn(state)
    _sync(device)
    return state, time.perf_counter() - t0, n_steps


def bench_structured(space, u0, p0, *, loop=LOOP, chunk=CHUNK,
                     n_steps=N_STEPS, dtype=torch.float32, device=None,
                     report=None):
    """bench.py's structured path (``bench.py:89-139``).

    Returns ``(elapsed, n_timed, finite, quality, state)``; ``state`` is
    the spectral step's ``(U, U_old, Uh, Uh_old, Ph)``.  ``report``, a
    dict, receives the scan loop's capture seconds, captured launches and
    replays."""
    from navierstokes_tpu_torch.structured import (
        PeriodicStructuredTH, build_spectral_projection_step)

    device = config.require_device(device)
    sgrid = PeriodicStructuredTH(space)
    step, init_state, _ = build_spectral_projection_step(
        sgrid, visc=1.0 / RE, dt=DT, dtype=dtype, device=device)
    flat = u0.reshape(-1)
    state = step(init_state(flat, flat, p0), ALPHA1, ETA1)
    for _ in range(N_WARMUP - 1):
        state = step(state, ALPHA2, ETA2)
    _sync(device)

    state, elapsed, n_timed = _march(
        lambda s: step(s, ALPHA2, ETA2), state, loop=loop, chunk=chunk,
        n_steps=n_steps, device=device, report=report)
    U = state[0]
    finite = bool(torch.isfinite(U).all())
    quality = {"amp_rel_err": _tg_amp_err(
        U.abs().max(), _n_total(loop, chunk, n_steps, n_timed), space.dim)}
    return elapsed, n_timed, finite, quality, state


def bench_generic(space, u0, p0, *, loop=LOOP, chunk=CHUNK, n_steps=N_STEPS,
                  dtype=torch.float32, device=None, report=None):
    """bench.py's generic path (``bench.py:142-229``).

    Returns ``(elapsed, n_timed, finite, quality, state)``; ``state`` is
    ``(u, u_old, p, phi)`` in the engine's planar permuted layout;
    ``quality`` also holds the three sub-solves' residual norms of one
    extra step (``cg_residuals``).  ``report`` as in
    :func:`bench_structured`."""
    from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
    from navierstokes_tpu_torch.solvers.planar_step import (
        _step_core, build_planar_projection_step)

    device = config.require_device(device)
    fast = FastTaylorHood(space, dtype=dtype, device=device)
    # NS_BENCH_POISSON=amg: AMG-preconditioned CG on the pressure Poisson
    # solve (P_ITERS iterations) in place of P_SWEEPS Jacobi-CG sweeps; no
    # tolerance either way, so no solve reads the device (bench.py:149-165)
    if POISSON == "amg":
        step = build_planar_projection_step(
            fast, visc=1.0 / RE, dt=DT, cg_iters=(10, P_ITERS, 6),
            poisson_precond="amg")
    else:
        step = build_planar_projection_step(fast, visc=1.0 / RE, dt=DT,
                                            cg_iters=(10, P_SWEEPS, 6))
    u = fast.permute_velocity(torch.tensor(u0.T, dtype=dtype, device=device))
    p = fast.permute_pressure(torch.tensor(p0, dtype=dtype, device=device))

    def advance(state, alpha=ALPHA2, eta=ETA2):
        u, u_old, p, phi = state
        u_new, p_new, phi_new = step(u, u_old, p, phi, alpha, eta)
        return (u_new, u, p_new, phi_new)

    state = advance((u, u, p, torch.zeros_like(p)), ALPHA1, ETA1)
    for _ in range(N_WARMUP - 1):
        state = advance(state)
    _sync(device)

    state, elapsed, n_timed = _march(advance, state, loop=loop, chunk=chunk,
                                     n_steps=n_steps, device=device,
                                     report=report)
    u = state[0]
    finite = bool(torch.isfinite(u).all())
    # the sub-solves' residual norms of one extra step in the bench's
    # configuration (bench.py:221-225)
    static = dict(step.static, with_residuals=True)
    *_, res = _step_core(step.ops, step.masks, *state, ALPHA2, ETA2, None,
                         DT, None, **static)
    quality = {"amp_rel_err": _tg_amp_err(
        u.abs().max(), _n_total(loop, chunk, n_steps, n_timed), space.dim),
        "cg_residuals": [float(r) for r in res.cpu()]}
    return elapsed, n_timed, finite, quality, state


def card_info():
    """``{"name", "power_limit"}`` as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reports them (first card)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def main():
    """Run both paths on the card and print the JSON line; returns it as
    a dict."""
    from navierstokes_tpu_torch.setups import taylor_green_setup

    device = config.require_device(None)
    if PATH not in ("structured", "generic"):
        raise SystemExit(f"NS_BENCH_PATH={PATH!r}: expected 'structured' "
                         "or 'generic'")
    card = card_info()
    space, u0, p0 = taylor_green_setup(N_POINTS, dim=DIM)

    results, quality = {}, {}
    for name, bench in (("structured", bench_structured),
                        ("generic", bench_generic)):
        try:
            elapsed, n_timed, finite, qual, _ = bench(space, u0, p0,
                                                      device=device)
            # a path that lost physical accuracy reads 0 as well
            ok = finite and qual["amp_rel_err"] < 0.05
            rate = (n_timed / elapsed) * space.n_dofs if ok else 0.0
            quality[name] = qual
        except Exception as exc:  # a broken path reads 0, not a crash
            traceback.print_exc(file=sys.stderr)
            rate = 0.0
            results[name + "_error"] = f"{type(exc).__name__}: {exc}"[:200]
        results[name] = round(rate, 1)

    value = results[PATH]
    record = {
        "metric": "DoF-steps/sec (assembly+solve, Taylor-Green "
                  f"{N_POINTS}^{DIM} SBDF2 projection, {PATH}, "
                  f"{LOOP} loop)",
        "value": value,
        "unit": "dof*steps/s",
        "vs_baseline": round(value / BASELINE_DOF_STEPS_PER_SEC, 3),
        "paths": results,
        "quality": quality,
        "loop": LOOP,
        "device": card,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
