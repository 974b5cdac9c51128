"""Problem ``lid_driven_cavity``: the lid-driven unit square.

* Program side: ``setups.lid_driven_cavity_setup`` -- no slip on the
  walls, the lid y = 1 at (1, 0), a zero-mean pressure -- with its
  velocity Dirichlet data as ``(mask, values)`` over the space's
  interleaved velocity dofs.
* Initial state, drawn from the seed: fluid at rest plus a smooth
  perturbation that vanishes on the walls, amplitude
  ``initial.perturbation.amplitude`` times the lid speed: sin(pi x)
  sin(pi y) times a sum of ``initial.perturbation.modes`` Fourier modes
  with integer wave numbers 1..3 and random phases.
* Reference: ``reference/taylor_hood.py`` on the bounded square with the
  same walls and lid (``lid_corners``: whether the two lid corners take
  the lid's value).
* Guards: ``lid_err`` and ``wall_err``, the largest departure of the lid
  and wall velocities from their Dirichlet values."""

from __future__ import annotations

import numpy as np
import torch

from reference.taylor_hood import Grid, Lattice, ReferenceStep

TWO_PI = 2.0 * np.pi


def lattice(cfg):
    """The reference's node numbering, which the drivers scatter into."""
    return Lattice(int(cfg["n_cells"]), periodic=False)


def setup(cfg):
    """``(space, vel_bc)``: the program's Taylor-Hood space and the
    velocity Dirichlet ``(mask, values)``."""
    from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
    from navierstokes_tpu_torch.setups import lid_driven_cavity_setup

    mesh, markers, bcs = lid_driven_cavity_setup(int(cfg["n_cells"]))
    space = TaylorHoodSpace(mesh)
    velocity_bcs = [bc for bc in bcs if bc[1] is not None]
    vbc, _ = compile_dirichlet_bcs(space, markers, velocity_bcs, [])
    mask = np.zeros(space.n_velocity_dofs, bool)
    mask[np.asarray(vbc.dofs)] = True
    vals = np.zeros(space.n_velocity_dofs)
    vals[np.asarray(vbc.dofs)] = vbc.values()
    return space, (mask, vals)


def initial_fields(cfg, seed):
    """``(velocity, pressure)``: callables of node coordinates x (m, 2)
    returning (m, 2) and (m,) host float64 arrays."""
    rng = np.random.default_rng(int(seed))
    spec = cfg["initial"]["perturbation"]
    m = int(spec["modes"])
    k = rng.integers(1, 4, size=(m, 2))
    phase = TWO_PI * rng.random((m, 2))
    weight = rng.standard_normal((m, 2))
    weight *= float(spec["amplitude"]) / np.abs(weight).sum(axis=0)

    def velocity(x):
        bump = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
        out = np.zeros((len(x), 2))
        for j in range(m):
            arg = TWO_PI * (k[j, 0] * x[:, 0] + k[j, 1] * x[:, 1])
            for d in range(2):
                out[:, d] += weight[j, d] * np.cos(arg + phase[j, d])
        return bump[:, None] * out

    def pressure(x):
        return np.zeros(len(x))

    return velocity, pressure


def reference_grid(cfg):
    return Grid(int(cfg["n_cells"]), periodic=False)


def reference_step(cfg, grid, solves, dtype, device):
    return ReferenceStep(
        grid, visc=1.0 / cfg["re"], dt=cfg["dt"], solves=solves,
        dirichlet=grid.boundary_values(cfg["lid_corners"] == "lid"),
        dtype=dtype, device=device)


def guards(cfg, lat, state, steps):
    """``lid_err`` and ``wall_err`` of the velocity ``state[0]``
    (reference layout)."""
    u = state[0]
    mask, vals = lat.boundary_values(cfg["lid_corners"] == "lid")
    mask, vals = mask.to(u.device), vals.to(u.device)
    a = torch.arange(lat.N, device=u.device)
    A, B = torch.meshgrid(a, a, indexing="ij")
    last = lat.N - 1
    lid = ((B == last) & (A > 0) & (A < last)).reshape(-1)
    err = (u - vals).abs().amax(dim=0)
    return {"lid_err": float(err[lid].max()),
            "wall_err": float(err[mask & ~lid].max())}
