"""Problem ``taylor_green``: the periodic Taylor-Green vortex on the unit
square.

* Program side: the Taylor-Hood space periodic in x and y, a zero-mean
  pressure, no velocity Dirichlet data.
* Initial state, drawn from the seed: u = (cos gx' sin gy',
  -sin gx' cos gy'), p = -(cos 2gx' + cos 2gy') / 4, g = 2 pi, shifted by
  a phase (x', y') = (x + a, y + b) with (a, b) uniform in [0, 1)^2.  The
  shift changes where the flow starts and never how much work a step is.
* Reference: ``reference/taylor_hood.py`` on the periodic square.
* Guard: ``amp_rel_err``, the peak velocity against the analytic decay
  e^{-2 nu g^2 t}, which does not depend on the shift."""

from __future__ import annotations

import math

import numpy as np

from reference.taylor_hood import Grid, Lattice, ReferenceStep

TWO_PI = 2.0 * math.pi


def lattice(cfg):
    """The reference's node numbering, which the drivers scatter into."""
    return Lattice(int(cfg["n_cells"]), periodic=True)


def setup(cfg):
    """``(space, vel_bc)``: the program's Taylor-Hood space; no velocity
    Dirichlet data on the torus."""
    from navierstokes_tpu_torch.fem.spaces import (TaylorHoodSpace,
                                                   axis_periodic)
    from navierstokes_tpu_torch.mesh import hyper_cube

    mesh, _ = hyper_cube(2, int(cfg["n_cells"]))
    return TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                           axis_periodic(1)]), None


def initial_fields(cfg, seed):
    """``(velocity, pressure)``: callables of node coordinates x (m, 2)
    returning (m, 2) and (m,) host float64 arrays."""
    a, b = np.random.default_rng(int(seed)).random(2)

    def velocity(x):
        gx, gy = TWO_PI * (x[:, 0] + a), TWO_PI * (x[:, 1] + b)
        return np.stack([np.cos(gx) * np.sin(gy),
                         -np.sin(gx) * np.cos(gy)], axis=1)

    def pressure(x):
        gx, gy = TWO_PI * (x[:, 0] + a), TWO_PI * (x[:, 1] + b)
        return -0.25 * (np.cos(2.0 * gx) + np.cos(2.0 * gy))

    return velocity, pressure


def reference_grid(cfg):
    return Grid(int(cfg["n_cells"]), periodic=True)


def reference_step(cfg, grid, solves, dtype, device):
    return ReferenceStep(grid, visc=1.0 / cfg["re"], dt=cfg["dt"],
                         solves=solves, dtype=dtype, device=device)


def guards(cfg, lat, state, steps):
    """``amp_rel_err`` of the velocity ``state[0]`` (reference layout),
    ``steps`` steps from the initial state."""
    t = steps * cfg["dt"]
    expected = math.exp(-2.0 * TWO_PI ** 2 * t / cfg["re"])
    return {"amp_rel_err":
            abs(float(state[0].abs().max()) - expected) / expected}
