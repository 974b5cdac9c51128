"""Benchmark initial states (counterpart of
``__graft_entry__.py::_taylor_green_setup``)."""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube


def taylor_green_setup(n_points, dim=2):
    """``(space, u0, p0)`` of the periodic Taylor-Green vortex on the unit
    square with ``n_points`` cells per side.

    ``u0`` is (n_unodes, 2) and ``p0`` (n_pnodes,), host f64 in the
    space's node numbering.  The exact solution decays as
    e^{-2 nu g^2 t} with g = 2 pi.  Only 2D is ported.
    """
    if dim != 2:
        raise NotImplementedError("the 3D shear-wave setup is not ported yet")
    mesh, _ = hyper_cube(2, n_points)
    space = TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                            axis_periodic(1)])
    g = 2.0 * np.pi
    u0 = space.interpolate_velocity(
        lambda x: np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                            -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                           axis=1))
    p0 = space.interpolate_pressure(
        lambda x: -0.25 * (np.cos(2 * g * x[:, 0]) + np.cos(2 * g * x[:, 1])))
    return space, u0, p0
