"""Problem ``taylor_green_3d``: the Taylor-Green vortex of Brachet et al.
(1983) on the periodic unit cube.

* Program side: the Taylor-Hood space periodic in x, y and z, a zero-mean
  pressure, no velocity Dirichlet data.
* Initial state, drawn from the seed: the source's box [-pi L, pi L]^3
  mapped onto one period, L = 1 / g, g = 2 pi, V0 = 1:
  u = (sin x' cos y' cos z', -cos x' sin y' cos z', 0),
  p = (cos 2x' + cos 2y') (cos 2z' + 2) / 16, with x' = g (x + a),
  y' = g (y + b), z' = g (z + c) and (a, b, c) uniform in [0, 1)^3.  The
  shift moves the flow and never changes the work of a step.
* Reference: ``reference/taylor_hood_3d.py`` on the periodic cube.
* Guard: ``ke_growth`` = E(t) / E_h(0) - 1, the kinetic energy 1/2 u^T M u
  (the reference's mass matrix) of the state over that of the nodal
  interpolant of the initial velocity.  Without forcing the energy cannot
  grow; a step that feeds energy in (a viscosity of the wrong sign) reads
  above zero."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from reference.taylor_hood_3d import Grid, Lattice, ReferenceStep

TWO_PI = 2.0 * math.pi


def lattice(cfg):
    """The reference's node numbering, which the drivers scatter into."""
    return Lattice(int(cfg["n_cells"]))


def setup(cfg):
    """``(space, vel_bc)``: the program's Taylor-Hood space; no velocity
    Dirichlet data on the periodic cube."""
    from navierstokes_tpu_torch.fem.spaces import (TaylorHoodSpace,
                                                   axis_periodic)
    from navierstokes_tpu_torch.mesh import hyper_cube

    mesh, _ = hyper_cube(3, int(cfg["n_cells"]))
    return TaylorHoodSpace(mesh, periodic=[axis_periodic(a)
                                           for a in range(3)]), None


def initial_fields(cfg, seed):
    """``(velocity, pressure)``: callables of node coordinates x (m, 3)
    returning (m, 3) and (m,) host float64 arrays."""
    shift = np.random.default_rng(int(seed)).random(3)

    def angles(x):
        return [TWO_PI * (np.asarray(x)[:, d] + shift[d]) for d in range(3)]

    def velocity(x):
        gx, gy, gz = angles(x)
        return np.stack([np.sin(gx) * np.cos(gy) * np.cos(gz),
                         -np.cos(gx) * np.sin(gy) * np.cos(gz),
                         np.zeros_like(gx)], axis=1)

    def pressure(x):
        gx, gy, gz = angles(x)
        return (np.cos(2.0 * gx) + np.cos(2.0 * gy)) \
            * (np.cos(2.0 * gz) + 2.0) / 16.0

    return velocity, pressure


@functools.lru_cache(maxsize=1)
def _grid(n):
    return Grid(n)


def reference_grid(cfg):
    return _grid(int(cfg["n_cells"]))


def reference_step(cfg, grid, solves, dtype, device):
    return ReferenceStep(grid, visc=1.0 / cfg["re"], dt=cfg["dt"],
                         solves=solves, dtype=dtype, device=device)


def energy(grid, u):
    """1/2 u^T M u of a (3, nu) velocity in the reference's numbering, in
    float64 on ``u``'s device."""
    M = grid.M.to(torch.float64, u.device)
    u = u.to(torch.float64)
    return 0.5 * float(torch.sum(u * M(u)))


def guards(cfg, lat, state, steps):
    """``ke_growth`` of the velocity ``state[0]`` (reference layout).  The
    driver keeps the seeded initial fields on the lattice
    (``lat.initial``)."""
    grid = reference_grid(cfg)
    u = state[0]
    u0 = torch.as_tensor(lat.initial[0](grid.u_coords().numpy()).T,
                         dtype=torch.float64, device=u.device)
    return {"ke_growth": energy(grid, u) / energy(grid, u0) - 1.0}
