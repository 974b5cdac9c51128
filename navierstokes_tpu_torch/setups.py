"""Benchmark initial states (counterpart of
``__graft_entry__.py::_taylor_green_setup``)."""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube


def taylor_green_setup(n_points, dim=2):
    """``(space, u0, p0)`` of the periodic exact-solution benchmark on the
    unit square/cube with ``n_points`` cells per side.

    2D: the Taylor-Green vortex (decay e^{-2 nu g^2 t}, g = 2 pi).  3D: the
    unidirectional shear wave u = (cos(g y), 0, 0), p = 0 -- divergence-free
    with (u.grad)u == 0, so an exact Navier-Stokes solution (decay
    e^{-nu g^2 t}) that still runs the full convection.  ``u0`` is
    (n_unodes, dim) and ``p0`` (n_pnodes,), host f64 in the space's node
    numbering.
    """
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    mesh, _ = hyper_cube(dim, n_points)
    space = TaylorHoodSpace(mesh, periodic=[axis_periodic(a)
                                            for a in range(dim)])
    g = 2.0 * np.pi
    if dim == 2:
        u0 = space.interpolate_velocity(
            lambda x: np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                                -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                               axis=1))
        p0 = space.interpolate_pressure(
            lambda x: -0.25 * (np.cos(2 * g * x[:, 0])
                               + np.cos(2 * g * x[:, 1])))
    else:
        u0 = space.interpolate_velocity(
            lambda x: np.stack([np.cos(g * x[:, 1]),
                                np.zeros(len(x)), np.zeros(len(x))],
                               axis=1))
        p0 = space.interpolate_pressure(lambda x: np.zeros(len(x)))
    return space, u0, p0
