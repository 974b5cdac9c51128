"""Entry points: one step of the flagship configuration and a dry run of
the multi-device layer (counterpart of ``__graft_entry__.py``).

``entry()`` returns the structured spectral step of the Taylor-Green
vortex at 32^2 (Taylor-Hood P2/P1, semi-implicit projection, BDF-2
weights) and its example state, on the card.

``dryrun_multidevice(n)`` runs the four checks of
``__graft_entry__.dryrun_multichip(n)`` on ``parallel.comm.device_mesh(n)``
(one process, n shards; on one card every shard is on it): one full time
step with the cell-sharded operators; the halo-exchange
``ProjectionSolver`` on a Dirichlet channel against one device; the
slab-sharded spectral step at 64^2 against one device; the sharded
Picard->Newton ``StationarySolver`` (PCD-FGMRES) on the cavity against
one device -- with the JAX function's tolerances for the dtype.

    python -m navierstokes_tpu_torch.entry [n]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.utils import _pytree as pytree

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.setups import taylor_green_setup

# the BDF-1 start and the BDF-2 weights (SBDF coefficients)
ALPHA1, ETA1 = (1.0, -1.0, 0.0), (1.0, 0.0)
ALPHA2, ETA2 = (1.5, -2.0, 0.5), (2.0, -1.0)
# the sharded spectral check's grid (dryrun_multichip's)
SPECTRAL_N = 64


def entry(device=None):
    """``(fn, example_args)``: ``fn(*state)`` is one spectral step of the
    32^2 Taylor-Green vortex (visc 0.01, dt 2e-3, BDF-2 weights) and
    returns the next state ``(U, U_old, Uh, Uh_old, Ph)``; the example
    state starts from the vortex.  On the card (float32) unless
    ``device`` says otherwise (the CPU: float64)."""
    from navierstokes_tpu_torch.structured import (
        PeriodicStructuredTH, build_spectral_projection_step)

    device = config.require_device(device)
    space, u0, p0 = taylor_green_setup(32)
    sgrid = PeriodicStructuredTH(space)
    step, init_state, _ = build_spectral_projection_step(
        sgrid, visc=0.01, dt=2e-3, device=device)
    state = init_state(u0.reshape(-1), u0.reshape(-1), p0)

    def fn(*state):
        return step(tuple(state), ALPHA2, ETA2)

    return fn, tuple(state)


def _cell_step(space, mesh, dtype, dt=2e-3, visc=0.01, cg_iters=(8, 12, 5)):
    """The fused projection step over the cell-sharded operators."""
    from navierstokes_tpu_torch.parallel.sharded import ShardedCellOperator
    from navierstokes_tpu_torch.solvers.fused_step import \
        build_projection_step

    ops = ShardedCellOperator(space, mesh, dtype=dtype)
    return build_projection_step(space, ops, visc=visc, dt=dt,
                                 cg_iters=cg_iters)


def _numpy(t):
    return t.detach().cpu().numpy()


def _channel(dmesh, device, dtype):
    """The halo check's Dirichlet channel (12 x 3 cells on [0, 4] x [0, 1],
    parabolic inlet, no-slip walls, zero outlet pressure), 2 steps."""
    from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu_torch.mesh import hyper_rectangle
    from navierstokes_tpu_torch.setups import parabolic_inlet
    from navierstokes_tpu_torch.solvers import ProjectionSolver
    from navierstokes_tpu_torch.timestepping import BDFTimeStepping

    cmesh, markers = hyper_rectangle((0.0, 0.0), (4.0, 1.0), (12, 3))
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.02)
    solver = ProjectionSolver(cmesh, markers, "standard", ts,
                              cg_iters=(40, 200, 20), cg_rtol=1e-10,
                              device_mesh=dmesh, device=device, dtype=dtype)
    solver.set_boundary_conditions(
        ((VelocityBCType.function, M.left.value, parabolic_inlet),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.no_slip, M.top.value, None),
         (PressureBCType.constant, M.right.value, 0.0)))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 0.1, "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    for _ in range(2):
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    return solver, _numpy(solver.solution)


def _cavity(dmesh, device, dtype, n, tol):
    """The stationary check's lid-driven cavity (Re 50) through
    Picard->Newton with PCD-FGMRES."""
    from navierstokes_tpu_torch.fem.bcs import VelocityBCType
    from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu_torch.mesh import hyper_cube
    from navierstokes_tpu_torch.solvers import StationarySolver

    cmesh, markers = hyper_cube(2, n)
    s = StationarySolver(cmesh, markers, "standard", tol=tol,
                         linear_solver="pcd", device_mesh=dmesh,
                         device=device, dtype=dtype)
    s.set_boundary_conditions(
        ((VelocityBCType.no_slip, M.left.value, None),
         (VelocityBCType.no_slip, M.right.value, None),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.constant, M.top.value, (1.0, 0.0))))
    s.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / 50.0,
         "pressure_term": 1.0, "coriolis_term": None, "euler_term": None,
         "body_force_term": None})
    s.solve()
    return _numpy(s.solution)


def dryrun_multidevice(n_devices: int, device=None, *, cavity_n=12) -> dict:
    """The four checks of ``dryrun_multichip`` over ``n_devices`` shards
    (on the card, float32, unless ``device`` says otherwise: the CPU,
    float64); raises ``AssertionError`` on a failed check, prints one
    summary line and returns the errors.  ``cavity_n`` is the stationary
    check's cavity size (12, as ``dryrun_multichip`` has it)."""
    from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, \
        axis_periodic
    from navierstokes_tpu_torch.mesh import hyper_cube
    from navierstokes_tpu_torch.parallel.comm import device_mesh
    from navierstokes_tpu_torch.structured import (
        PeriodicStructuredTH, build_spectral_projection_step)
    from navierstokes_tpu_torch.structured.spectral import \
        shard_spectral_step

    mesh = device_mesh(n_devices, device=device)
    if len(mesh) != n_devices:
        raise AssertionError(f"mesh of {len(mesh)} shards, asked for "
                             f"{n_devices}")
    dev0 = mesh.devices[0]
    dtype = config.default_dtype(dev0)
    f64 = dtype == torch.float64

    # (1) one full time step with the cell-sharded operators
    space, u0, p0 = taylor_green_setup(8)
    step = _cell_step(space, mesh, dtype)
    u = torch.tensor(u0.reshape(-1), dtype=dtype, device=dev0)
    p = torch.tensor(p0, dtype=dtype, device=dev0)
    u_new, p_new, _ = step(u, u, p, torch.zeros_like(p), ALPHA1, ETA1)
    if not (bool(torch.isfinite(u_new).all())
            and bool(torch.isfinite(p_new).all())):
        raise AssertionError("cell-sharded step: non-finite state")

    # (2) the halo-exchange ProjectionSolver against one device
    _, x1 = _channel(None, dev0, dtype)
    sh, xh = _channel(mesh, dev0, dtype)
    if sh._step_kind != "halo":
        raise AssertionError(f"step kind {sh._step_kind}, expected halo")
    err = float(np.abs(xh - x1).max() / max(np.abs(x1).max(), 1e-30))
    if not err < (1e-9 if f64 else 1e-4):
        raise AssertionError(f"halo-vs-single-device mismatch: {err}")
    rep = sh._hops.halo_report()

    # (3) the slab-sharded spectral step against one device, 3 steps
    smesh, _ = hyper_cube(2, SPECTRAL_N)
    sspace = TaylorHoodSpace(smesh, periodic=[axis_periodic(0),
                                              axis_periodic(1)])
    sgrid = PeriodicStructuredTH(sspace)
    sstep, init_state, read_state = build_spectral_projection_step(
        sgrid, visc=0.01, dt=1e-3, dtype=dtype, device=dev0)
    su0, sp0 = taylor_green_setup(SPECTRAL_N)[1:]
    st1 = init_state(su0.reshape(-1), su0.reshape(-1), sp0)
    for _ in range(3):
        st1 = sstep(st1, ALPHA2, ETA2)
    su1, _ = read_state(st1)
    sharded, shard_state = shard_spectral_step(sstep, sgrid, mesh)
    st8 = shard_state(init_state(su0.reshape(-1), su0.reshape(-1), sp0))
    for _ in range(3):
        st8 = sharded(st8, ALPHA2, ETA2)
    width = sgrid.shape[1] // n_devices
    if n_devices > 1 and not all(st[0].shape[2] == width for st in st8):
        raise AssertionError("spectral state not sharded")
    su8, _ = read_state(sharded.gather_state(st8))
    serr = float(np.linalg.norm(su8 - su1) / np.linalg.norm(su1))
    if not serr < (1e-12 if f64 else 1e-5):
        raise AssertionError(f"sharded spectral mismatch: {serr}")

    # (4) the sharded Picard->Newton stationary solve against one device
    nl_tol = 1e-9 if f64 else 2e-5
    xc1 = _cavity(None, dev0, dtype, cavity_n, nl_tol)
    xc8 = _cavity(mesh, dev0, dtype, cavity_n, nl_tol)
    cerr = float(np.abs(xc8 - xc1).max() / np.abs(xc1).max())
    if not cerr < (1e-6 if f64 else 5e-3):
        raise AssertionError(f"sharded stationary mismatch: {cerr}")

    print(f"dryrun_multidevice: {n_devices} shards on "
          f"{sorted({str(d) for d in mesh.devices})}, {space.n_dofs} dofs, "
          f"step OK (|u|_max={float(u_new.abs().max()):.4f}); "
          f"halo ProjectionSolver OK (rel err {err:.2e}, "
          f"{rep['u_nodes_per_device']} owned + "
          f"{rep['u_halo_per_device']} halo u-nodes/device); "
          f"sharded spectral {SPECTRAL_N}^2 OK ({sspace.n_dofs} dofs, "
          f"rel err {serr:.2e}); "
          f"sharded stationary Picard->Newton OK (rel err {cerr:.2e})",
          flush=True)
    return {"halo": err, "spectral": serr, "stationary": cerr}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else None
    fn, args = entry()
    out = fn(*args)
    print("entry step OK:",
          [tuple(t.shape) for t in pytree.tree_leaves(out)])
    if n is not None:
        dryrun_multidevice(n)
