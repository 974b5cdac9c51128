"""Problem ``dfg_2d2``: the Schaefer-Turek DFG 2D-2 cylinder benchmark
(Schaefer & Turek 1996, test case 2D-2) in diameters: the channel [0, 22]
x [0, 4.1] with a cylinder of diameter 1 at (2, 2), the parabolic inflow
of mean 1 on x = 0, no slip on the walls and the cylinder, p = 0 on the
outlet x = 22, Re = 100.

* Program side: ``mesh.channel_with_cylinder(resolution)`` (the symmetric
  mesh; the space snaps the cylinder's mid-edge nodes onto the circle, so
  its cells there are isoparametric), the boundary conditions as solver
  tuples, the inflow declared as a function of the position alone (it
  does not change in time), and the reaction's boundary, the cylinder,
  with the scale 2 / (rho U^2 D) = 2 that makes the force (c_D, c_L).
* Initial state: the committed saturated state ``initial.state`` (u,
  u_old, p in the space's dof order), loaded as data; the seed adds to u
  and u_old alike a perturbation of amplitude
  ``initial.perturbation.amplitude``, a sum of
  ``initial.perturbation.modes`` cosine modes over the channel with
  random wave numbers, phases and weights, set to zero at the velocity
  Dirichlet nodes.  Every seed does the same work per step.
* Reference: ``reference/taylor_hood_unstructured.py`` on the program's
  mesh, given to it as data (vertices, triangles, each cell's P2 node
  positions with the snapped ones, the marked boundary edges); its own
  Dirichlet data.
* Guards: ``cd_envelope`` and ``cl_envelope``, how far the reference's
  own nodal reaction (c_D, c_L) of the state lies outside the saturated
  cycle's envelope (``envelope``: [low, high] per coefficient, the reason
  beside each), negative inside it; ``force_gap``, the larger distance
  between the program's (c_D, c_L) of the state (the fifth entry of the
  driver's ``reference_state``) and the reference's (``force_check`` says
  why its limit lies where it does)."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from reference.taylor_hood_unstructured import Grid, Mesh, ReferenceStep

ROOT = Path(__file__).resolve().parents[2]
TWO_PI = 2.0 * np.pi
# program's local P2 order (vertices, then the mid-edge node opposite each
# vertex) -> the reference's (vertices, then edges 01, 12, 02)
TO_REFERENCE_ORDER = [0, 1, 2, 5, 3, 4]
WALLS = ("upper wall", "lower wall", "cylinder")


@functools.lru_cache(maxsize=2)
def _program_mesh(resolution):
    """``(mesh, markers, marker_map, space)`` of the program at
    ``resolution``."""
    from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
    from navierstokes_tpu_torch.mesh import channel_with_cylinder

    mesh, markers, marker_map = channel_with_cylinder(resolution)
    return mesh, markers, marker_map, TaylorHoodSpace(mesh)


def _mesh_data(cfg):
    """The reference's input: vertices, triangles, each cell's P2 node
    positions in the reference's local order, and the boundary's edges
    by marker."""
    mesh, markers, marker_map, space = _program_mesh(float(cfg["resolution"]))
    boundary = {v: mesh.facets[markers.ids_with_value(v)]
                for v in marker_map.values()}
    return (mesh.points, mesh.cells,
            np.asarray(space.cell_ucoords)[:, TO_REFERENCE_ORDER], boundary)


def _marker_map(cfg):
    return _program_mesh(float(cfg["resolution"]))[2]


@functools.lru_cache(maxsize=2)
def _lattice(resolution):
    return Mesh(*_mesh_data({"resolution": resolution}))


@functools.lru_cache(maxsize=2)
def _grid(resolution):
    return Grid(*_mesh_data({"resolution": resolution}))


def lattice(cfg):
    """The reference's node numbering, which the drivers scatter into."""
    return _lattice(float(cfg["resolution"]))


def reference_grid(cfg):
    return _grid(float(cfg["resolution"]))


def inflow(cfg):
    """The parabolic inflow of mean ``inflow.mean`` across the channel's
    height, a function of the position alone ((m, 2) -> (m, 2))."""
    height, mean = cfg["inflow"]["height"], cfg["inflow"]["mean"]

    def profile(x):
        s = x[:, 1] / height
        return np.stack([6.0 * mean * s * (1.0 - s), np.zeros(len(x))],
                        axis=1)

    return profile


def _velocity_bcs(cfg, marker_map):
    from navierstokes_tpu_torch.fem.bcs import VelocityBCType

    return ((VelocityBCType.function, marker_map["inlet"], inflow(cfg)),) \
        + tuple((VelocityBCType.no_slip, marker_map[w], None)
                for w in WALLS)


def setup(cfg):
    """``(mesh, markers, bcs, (reaction boundary, scale))``: the program's
    mesh and its solver's boundary conditions, the cylinder's marker and
    the scale of its force to (c_D, c_L)."""
    from navierstokes_tpu_torch.fem.bcs import PressureBCType

    mesh, markers, marker_map, _ = _program_mesh(float(cfg["resolution"]))
    bcs = _velocity_bcs(cfg, marker_map) \
        + ((PressureBCType.constant, marker_map["outlet"], 0.0),)
    return mesh, markers, bcs, \
        (marker_map["cylinder"], 2.0 / cfg["inflow"]["mean"] ** 2)


def initial_fields(cfg, seed):
    """``state(space)``: the seeded initial state ``(u, u_old, p)`` on
    the program's ``space`` (built on :func:`setup`'s mesh), host float64
    arrays in its dof order (interleaved velocity)."""
    from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs

    rng = np.random.default_rng(int(seed))
    spec = cfg["initial"]["perturbation"]
    m = int(spec["modes"])
    k = rng.integers(1, 5, size=(m, 2))
    phase = TWO_PI * rng.random((m, 2))
    weight = rng.standard_normal((m, 2))
    weight *= float(spec["amplitude"]) / np.abs(weight).sum(axis=0)
    extent = np.array([cfg["length"], cfg["inflow"]["height"]])

    def state(space):
        with np.load(ROOT / cfg["initial"]["state"]) as data:
            u, u_old, p = data["u"], data["u_old"], data["p"]
        if (len(u), len(p)) != (space.n_velocity_dofs, space.n_pnodes):
            raise ValueError(f"{cfg['initial']['state']}: state ({len(u)}, "
                             f"{len(p)}), space ({space.n_velocity_dofs}, "
                             f"{space.n_pnodes})")
        x = space.u_coords / extent
        du = np.zeros((space.n_unodes, 2))
        for j in range(m):
            arg = TWO_PI * (k[j, 0] * x[:, 0] + k[j, 1] * x[:, 1])
            for d in range(2):
                du[:, d] += weight[j, d] * np.cos(arg + phase[j, d])
        du = du.reshape(-1)
        _, markers, marker_map, _ = _program_mesh(float(cfg["resolution"]))
        vbc, _ = compile_dirichlet_bcs(space, markers,
                                       _velocity_bcs(cfg, marker_map), ())
        du[np.asarray(vbc.dofs)] = 0.0
        return u + du, u_old + du, p

    return state


def _dirichlet(cfg, grid):
    """The reference's velocity Dirichlet ``(mask (nu,), values (2, nu))``
    and pressure Dirichlet mask (np,)."""
    names = _marker_map(cfg)
    inlet = grid.boundary_unodes([names["inlet"]])
    walls = grid.boundary_unodes([names[w] for w in WALLS])
    mask = torch.zeros(grid.nu, dtype=torch.bool)
    mask[inlet] = mask[walls] = True
    vals = torch.zeros((2, grid.nu), dtype=torch.float64)
    vals[:, inlet] = torch.as_tensor(
        inflow(cfg)(grid.u_xy[inlet].numpy()).T)
    vals[:, walls] = 0.0
    fixed = torch.zeros(grid.np, dtype=torch.bool)
    fixed[grid.boundary_pnodes([names["outlet"]])] = True
    return (mask, vals), fixed


def reference_step(cfg, grid, solves, dtype, device):
    dirichlet, fixed = _dirichlet(cfg, grid)
    return ReferenceStep(grid, visc=1.0 / cfg["re"], dt=cfg["dt"],
                         solves=solves, dirichlet=dirichlet,
                         pressure_fixed=fixed, dtype=dtype, device=device)


def guards(cfg, lat, state, steps):
    """``cd_envelope`` and ``cl_envelope`` of the state (reference
    layout): max(c - high, low - c) of the reference's nodal reaction
    c_D, c_L on the cylinder, with the acceleration of the state's two
    velocity levels (``reference/taylor_hood_unstructured.
    reaction_force``); ``force_gap``: max |c_prog - c| over (c_D, c_L),
    ``c_prog`` the program's force that the state carries."""
    from reference.taylor_hood_unstructured import reaction_force

    grid = reference_grid(cfg)
    u, u_old, p, _, c_prog = state
    scale = 2.0 / cfg["inflow"]["mean"] ** 2
    c = scale * reaction_force(grid, u, u_old, p,
                               [_marker_map(cfg)["cylinder"]],
                               visc=1.0 / cfg["re"], dt=cfg["dt"])
    out = {}
    for name, value in zip(("cd", "cl"), c.tolist()):
        low, high = cfg["envelope"][name][:2]
        out[f"{name}_envelope"] = max(value - high, low - value)
    out["force_gap"] = float((c_prog.to(c) - c).abs().max())
    return out
