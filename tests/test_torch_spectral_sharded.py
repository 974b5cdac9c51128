"""Port parity: the slab-sharded spectral projection step
(``structured/spectral.shard_spectral_step``) and ``ProjectionSolver``'s
sharded spectral route; mirrors tests/test_spectral_sharded.py.

CPU, float64.  The JAX package leaves the collectives to GSPMD on the
conftest's 8 virtual devices; the port writes them out over
``device_mesh(n, device="cpu")``: the convection's halo exchange with the
neighbouring slabs and the all-gather of the DFT along the split axis.
4 steps over 1, 2, 4 and 8 shards agree with the unsharded step to 1e-12
relative (2D 16x16, 3D 8^3) and with the JAX package's sharded step to
1e-10 (2D, 8 devices); every state leaf stays split into slabs; a grid
whose axis 1 does not divide into the shards raises ``NotStructured``;
the solver through its ``device_mesh`` matches the one-device solver and
the JAX package's sharded solver to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.parallel.sharded import device_mesh as jax_device_mesh
from navierstokes_tpu.structured import PeriodicStructuredTH as JaxGrid
from navierstokes_tpu.structured import \
    build_spectral_projection_step as jax_build_step
from navierstokes_tpu.structured.spectral import \
    shard_spectral_step as jax_shard_step
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.parallel.sharded import device_mesh
from navierstokes_tpu_torch.structured import (NotStructured,
                                               PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.structured.spectral import (SplitC,
                                                        shard_spectral_step)

GAMMA = 2.0 * np.pi
ALPHA, ETA = (1.5, -2.0, 0.5), (2.0, -1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tg_velocity(x, t=0.0):
    return np.stack([np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
                     -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])],
                    axis=1)


def _tg_pressure(x, t=0.0):
    return -0.25 * (np.cos(2 * GAMMA * x[:, 0]) + np.cos(2 * GAMMA * x[:, 1]))


_CASES = {}


def _case(dim):
    """(space, sgrid, step, init, read, u0, p0, reference (u, p) after 4
    unsharded steps); 2D 16x16 Taylor-Green, 3D 8^3 random; built once."""
    if dim not in _CASES:
        n = 16 if dim == 2 else 8
        space = TaylorHoodSpace(hyper_cube(dim, n)[0], periodic=[
            axis_periodic(a) for a in range(dim)])
        sg = PeriodicStructuredTH(space)
        step, init, read = build_spectral_projection_step(
            sg, visc=0.01, dt=1e-3, device="cpu")
        if dim == 2:
            u0 = space.interpolate_velocity(_tg_velocity).reshape(-1)
            p0 = space.interpolate_pressure(_tg_pressure)
        else:
            rng = np.random.default_rng(4)
            u0 = rng.standard_normal(space.n_velocity_dofs)
            p0 = rng.standard_normal(space.n_pnodes)
        st = init(u0, u0, p0)
        for _ in range(4):
            st = step(st, ALPHA, ETA)
        _CASES[dim] = (space, sg, step, init, read, u0, p0, read(st))
    return _CASES[dim]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_step_matches_unsharded(dim, n_shards):
    space, sg, step, init, read, u0, p0, (u1, p1) = _case(dim)
    sharded, shard_state = shard_spectral_step(
        step, sg, device_mesh(n_shards, device="cpu"))
    states = shard_state(init(u0, u0, p0))
    w = sg.shape[1] // n_shards

    def slab_widths(states):
        assert len(states) == n_shards
        for st in states:
            U, U_old, Uh, Uh_old, Ph = st
            assert U.shape[2] == U_old.shape[2] == w
            for z in (Uh, Uh_old, Ph):
                assert isinstance(z, SplitC) and z.re.shape[1] == w

    slab_widths(states)
    for _ in range(4):
        states = sharded(states, ALPHA, ETA)
    slab_widths(states)
    u, p = read(sharded.gather_state(states))
    assert _rel(u, u1) <= 1e-12 and _rel(p, p1) <= 1e-12


def test_sharded_step_matches_the_jax_package():
    space, sg, step, init, read, u0, p0, _ = _case(2)
    sharded, shard_state = shard_spectral_step(
        step, sg, device_mesh(8, device="cpu"))
    states = shard_state(init(u0, u0, p0))
    for _ in range(4):
        states = sharded(states, ALPHA, ETA)
    u, p = read(sharded.gather_state(states))
    jspace = JaxSpace(jax_hyper_cube(2, 16)[0],
                      periodic=[jax_periodic(0), jax_periodic(1)])
    jsg = JaxGrid(jspace)
    jstep, jinit, jread = jax_build_step(jsg, visc=0.01, dt=1e-3)
    jsharded, jshard_state = jax_shard_step(jstep, jsg, jax_device_mesh(8))
    jst = jshard_state(jinit(u0, u0, p0))
    al = tuple(jnp.asarray(v) for v in ALPHA)
    et = tuple(jnp.asarray(v) for v in ETA)
    for _ in range(4):
        jst = jsharded(jst, al, et)
    ju, jp = jread(jst)
    assert _rel(u, np.asarray(ju)) <= 1e-10
    assert _rel(p, np.asarray(jp)) <= 1e-10


def test_indivisible_grid_raises_not_structured():
    space = TaylorHoodSpace(hyper_cube(2, 12)[0], periodic=[
        axis_periodic(0), axis_periodic(1)])
    sg = PeriodicStructuredTH(space)
    step, *_ = build_spectral_projection_step(sg, visc=0.01, dt=1e-3,
                                              device="cpu")
    with pytest.raises(NotStructured, match="not divisible"):
        shard_spectral_step(step, sg, device_mesh(8, device="cpu"))
    # 12 over 6 shards divides, but no slab is narrower than the
    # convection's reach of one column
    shard_spectral_step(step, sg, device_mesh(6, device="cpu"))


def _solver(package, mesh_arg):
    if package == "jax":
        from navierstokes_tpu.fem.bcs import PressureBCType as JP
        from navierstokes_tpu.solvers import ProjectionSolver as Solver
        from navierstokes_tpu.timestepping import BDFTimeStepping as BDF
        mesh, markers = jax_hyper_cube(2, 16)
        pair, mean = [jax_periodic(0), jax_periodic(1)], JP.mean_value
        kw = {}
    else:
        from navierstokes_tpu_torch.solvers import ProjectionSolver as Solver
        from navierstokes_tpu_torch.timestepping import BDFTimeStepping as BDF
        mesh, markers = hyper_cube(2, 16)
        pair, mean = [axis_periodic(0), axis_periodic(1)], \
            PressureBCType.mean_value
        kw = {"device": "cpu"}
    ts = BDF(0.0, 1.0, desired_start_time_step=1e-2)
    s = Solver(mesh, markers, "standard", ts, device_mesh=mesh_arg, **kw)
    s.set_periodic_boundary_conditions(
        pair, (M.left.value, M.right.value, M.top.value, M.bottom.value))
    s.set_boundary_conditions(((mean, None, 0.0),))
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 0.01, "pressure_term": 1.0})
    s.set_initial_conditions({"velocity": _tg_velocity,
                              "pressure": _tg_pressure})
    return s, ts


def _run(solver, ts, n):
    for _ in range(n):
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    return np.asarray(solver.solution)


def test_projection_solver_spectral_sharded_route():
    s4, ts4 = _solver("torch", device_mesh(4, device="cpu"))
    x4 = _run(s4, ts4, 5)
    assert s4._step_kind == "spectral"
    assert len(s4._spectral_state) == 4
    s1, ts1 = _solver("torch", None)
    x1 = _run(s1, ts1, 5)
    assert s1._step_kind == "spectral"
    assert np.abs(x4 - x1).max() <= 1e-11
    j8, jts8 = _solver("jax", jax_device_mesh(8))
    assert np.abs(x4 - _run(j8, jts8, 5)).max() <= 1e-10
    # a grid that does not divide into the shards takes the halo step
    s3, ts3 = _solver("torch", ["cpu"] * 3)
    with pytest.warns(RuntimeWarning, match="not divisible"):
        _run(s3, ts3, 1)
    assert s3._step_kind == "halo"
