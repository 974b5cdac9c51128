"""Benchmark setups: the periodic initial states (counterpart of
``__graft_entry__.py::_taylor_green_setup``) and the wall-bounded boxes
driven through the solver API (lid-driven cavity, channel)."""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers, hyper_cube,
                                         hyper_rectangle)


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


def _lid(x):
    return np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)


def lid_driven_cavity_setup(n):
    """``(mesh, markers, bcs)`` of the lid-driven cavity on the unit square
    with ``n`` cells per side: no slip on three walls, unit tangential
    speed on the top lid, zero mean pressure (the boundary conditions of
    ``benchmarks/cavity_re1000.py``)."""
    M = HyperCubeBoundaryMarkers
    mesh, markers = hyper_cube(2, n)
    bcs = ((VelocityBCType.no_slip, M.left.value, None),
           (VelocityBCType.no_slip, M.right.value, None),
           (VelocityBCType.no_slip, M.bottom.value, None),
           (VelocityBCType.function, M.top.value, _lid),
           (PressureBCType.mean_value, None, 0.0))
    return mesh, markers, bcs


def parabolic_inlet(x, t=None):
    """The steady Poiseuille profile u = (y (1 - y), 0)."""
    return np.stack([x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1)


def channel_setup(nx, ny, inlet=parabolic_inlet):
    """``(mesh, markers, bcs)`` of the plane channel [0, 5] x [0, 1] with
    ``nx`` x ``ny`` cells: the velocity ``inlet(x[, t])`` on the left, no
    slip on bottom and top, zero pressure on the right outlet."""
    M = HyperCubeBoundaryMarkers
    mesh, markers = hyper_rectangle((0.0, 0.0), (5.0, 1.0), (nx, ny))
    bcs = ((VelocityBCType.function, M.left.value, inlet),
           (VelocityBCType.no_slip, M.bottom.value, None),
           (VelocityBCType.no_slip, M.top.value, None),
           (PressureBCType.constant, M.right.value, 0.0))
    return mesh, markers, bcs
