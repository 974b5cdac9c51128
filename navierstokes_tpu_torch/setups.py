"""Benchmark setups: the periodic initial states (counterpart of
``__graft_entry__.py::_taylor_green_setup``) and the wall-bounded domains
driven through the solver API (lid-driven cavity in 2D and 3D, channel,
the 3D duct, spherical Couette flow)."""

from __future__ import annotations

import numpy as np

from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers,
                                         SphericalAnnulusBoundaryMarkers,
                                         hyper_cube, hyper_rectangle,
                                         spherical_shell)


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
    lid = np.zeros_like(x)
    lid[:, 0] = 1.0
    return lid


def lid_driven_cavity_setup(n, dim=2):
    """``(mesh, markers, bcs)`` of the lid-driven cavity on the unit square
    (cube, ``dim=3``) with ``n`` cells per side: no slip on the walls,
    the unit velocity (1, 0[, 0]) on the top lid, zero mean pressure (the
    boundary conditions of ``benchmarks/cavity_re1000.py``; in 3D those of
    ``tests/test_3d_solver.py``'s cavity)."""
    M = HyperCubeBoundaryMarkers
    mesh, markers = hyper_cube(dim, n)
    walls = (M.left, M.right, M.bottom) + ((M.back, M.front)
                                           if dim == 3 else ())
    bcs = tuple((VelocityBCType.no_slip, w.value, None) for w in walls) + (
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


def duct_setup(n_points=(9, 3, 3)):
    """``(mesh, markers, bcs)`` of the 3D duct [0, 3] x [0, 1] x [0, 1] of
    ``tests/test_3d_solver.py``: the plane Poiseuille profile
    u = (y (1 - y), 0, 0) at the inlet, no slip on the plates y = 0, 1,
    no normal flux on the side walls z = 0, 1, zero pressure at the
    outlet.  The profile lies in the P2 space and is constant in z, so it
    is the exact steady state."""
    M = HyperCubeBoundaryMarkers
    mesh, markers = hyper_rectangle((0.0, 0.0, 0.0), (3.0, 1.0, 1.0),
                                    tuple(n_points))
    bcs = ((VelocityBCType.function, M.left.value, duct_profile),
           (VelocityBCType.no_slip, M.bottom.value, None),
           (VelocityBCType.no_slip, M.top.value, None),
           (VelocityBCType.no_normal_flux, M.back.value, None),
           (VelocityBCType.no_normal_flux, M.front.value, None),
           (PressureBCType.constant, M.right.value, 0.0))
    return mesh, markers, bcs


def duct_profile(x, t=None):
    """The duct's exact velocity u = (y (1 - y), 0, 0)."""
    u = np.zeros((len(x), 3))
    u[:, 0] = x[:, 1] * (1 - x[:, 1])
    return u


def spherical_couette_setup(n_points, radii=(0.5, 1.0), omega=1.0):
    """``(mesh, markers, bcs)`` of spherical Couette flow: the inner
    sphere of ``spherical_shell(3, radii, n_points)`` rotates about z at
    rate ``omega`` (u = omega e_z x x), the outer sphere is at rest, zero
    mean pressure."""
    S = SphericalAnnulusBoundaryMarkers
    mesh, markers = spherical_shell(3, radii, n_points)

    def rotating(x):
        u = np.zeros_like(x)
        u[:, 0] = -omega * x[:, 1]
        u[:, 1] = omega * x[:, 0]
        return u

    bcs = ((VelocityBCType.function, S.interior_boundary.value, rotating),
           (VelocityBCType.no_slip, S.exterior_boundary.value, None),
           (PressureBCType.mean_value, None, 0.0))
    return mesh, markers, bcs


def spherical_couette_stokes(x, radii=(0.5, 1.0), omega=1.0):
    """The Stokes solution of spherical Couette flow, u = u_phi e_phi with
    u_phi = omega sin(theta) ri^3 ro^3 / (ro^3 - ri^3) (1/r^2 - r/ro^3),
    as (n, 3) Cartesian vectors."""
    ri, ro = radii
    r = np.linalg.norm(x, axis=1)
    amp = omega * ri ** 3 * ro ** 3 / (ro ** 3 - ri ** 3) \
        * (1.0 / r ** 2 - r / ro ** 3) / r      # u_phi / (r sin(theta))
    u = np.zeros_like(x)
    u[:, 0] = -amp * x[:, 1]
    u[:, 1] = amp * x[:, 0]
    return u
