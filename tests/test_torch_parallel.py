"""Port parity: the shard mesh, its collectives and the cell-sharded
operators (parallel/comm.py, parallel/sharded.py), and the cell-loop step
over them (solvers/fused_step.py); mirrors tests/test_parallel.py.

CPU, float64.  The JAX package runs on the conftest's 8 virtual CPU
devices, the port on ``device_mesh(n, device="cpu")``: n CPU shards in one
process.  Every apply at 1, 2 and 8 shards agrees with the JAX package's
to 1e-12 absolute on unit-normal inputs (the sums differ in order only:
the port adds the shards' partials in shard order, XLA in its own), and a
few steps of the fused step over 4 shards to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.parallel.sharded import \
    ShardedCellOperator as JaxCellOperator
from navierstokes_tpu.parallel.sharded import device_mesh as jax_device_mesh
from navierstokes_tpu.solvers.fused_step import \
    build_projection_step as jax_build_step
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.parallel import comm
from navierstokes_tpu_torch.parallel.sharded import (ShardedCellOperator,
                                                     device_mesh)
from navierstokes_tpu_torch.solvers.fused_step import build_projection_step

ATOL_APPLY = 1e-12
ATOL_STEP = 1e-10
A1, E1 = (1.0, -1.0, 0.0), (1.0, 0.0)
A2, E2 = (1.5, -2.0, 0.5), (2.0, -1.0)
GAMMA = 2.0 * np.pi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SPACES = {}


def _spaces(n=8):
    """(JAX space, port space) of the periodic unit square, n x n."""
    if n not in _SPACES:
        periodic = [(jax_periodic(0), jax_periodic(1)),
                    (axis_periodic(0), axis_periodic(1))]
        jm, _ = jax_hyper_cube(2, n)
        tm, _ = hyper_cube(2, n)
        _SPACES[n] = (JaxSpace(jm, periodic=list(periodic[0])),
                      TaylorHoodSpace(tm, periodic=list(periodic[1])))
    return _SPACES[n]


def _random_state(space, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(space.n_velocity_dofs),
            rng.standard_normal(space.n_pnodes))


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_device_mesh_on_the_cpu():
    mesh = device_mesh(4, device="cpu")
    assert isinstance(mesh, comm.DeviceMesh) and len(mesh) == 4
    assert mesh == ["cpu"] * 4 and mesh.axis == "shard"
    assert mesh.physical_devices == [torch.device("cpu")]
    assert device_mesh(device="cpu") == [torch.device("cpu")]
    assert comm.as_mesh(["cpu", "cpu"]) == device_mesh(2, device="cpu")
    assert comm.as_mesh(None) is None


def test_device_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        device_mesh(4)
    with pytest.raises(RuntimeError):
        comm.DeviceMesh(["cuda:0", "cuda:1"])


def test_collectives_sum_in_shard_order():
    mesh = device_mesh(3, device="cpu")
    parts = [torch.tensor([1e16, 1.0]), torch.tensor([1.0, 2.0]),
             torch.tensor([-1e16, 3.0])]
    total = comm.psum(parts, mesh)
    # ((1e16 + 1) + -1e16) in shard order, not 1e16 - 1e16 + 1
    want = (parts[0] + parts[1]) + parts[2]
    assert all(torch.equal(t, want) for t in total) and len(total) == 3
    bufs = [torch.full((2,), float(i)) for i in range(3)]
    got = comm.ppermute(bufs, [(0, 1), (1, 2)], mesh)
    assert [g.tolist() for g in got] == [[0.0, 0.0], [0.0, 0.0],
                                         [1.0, 1.0]]
    full = comm.allgather([torch.ones(2, 1) * i for i in range(3)], mesh, 1)
    assert all(torch.equal(f, torch.tensor([[0.0, 1, 2], [0, 1, 2]]))
               for f in full)
    x = comm.Sharded([torch.ones(2), 2 * torch.ones(3)])
    y = 1.0 - 2.0 * x / comm.Sharded([torch.ones(2), torch.ones(3)])
    assert [p.tolist() for p in y] == [[-1.0, -1.0], [-3.0, -3.0, -3.0]]
    mesh2 = device_mesh(2, device="cpu")
    assert float(comm.sharded_dot(x, x, mesh2)[1]) == 14.0
    assert float(comm.sharded_sum(x, mesh2)[0]) == 8.0


# ---------------------------------------------------------------------------
# the cell-sharded operators
# ---------------------------------------------------------------------------

_OPS = {}


def _ops(n_shards):
    if n_shards not in _OPS:
        js, ts = _spaces()
        _OPS[n_shards] = (
            JaxCellOperator(js, jax_device_mesh(n_shards)),
            ShardedCellOperator(ts, device_mesh(n_shards, device="cpu")))
    return _OPS[n_shards]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_matvecs_match(n_shards):
    jo, to = _ops(n_shards)
    space = to.space
    assert to.n_dev == n_shards and to.chunk * n_shards == \
        to.n_cells_padded == jo.n_cells_padded
    u, p = _random_state(space, 0)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    pt, pj = torch.tensor(p), jnp.asarray(p)
    pairs = [
        (to.make_velocity_mass()(ut), jo.make_velocity_mass()(uj)),
        (to.make_velocity_helmholtz(0.3)(ut, 2.0),
         jo.make_velocity_helmholtz(0.3)(uj, jnp.asarray(2.0))),
        (to.make_gradient()(pt), jo.make_gradient()(pj)),
        (to.make_divergence()(ut), jo.make_divergence()(uj)),
        (to.make_pressure_stiffness()(pt), jo.make_pressure_stiffness()(pj)),
        (to.make_convection_rhs(0.7)(ut), jo.make_convection_rhs(0.7)(uj)),
        (to.make_stokes_matvec(0.1, accel0=3.0)(torch.cat([ut, pt])),
         jo.make_stokes_matvec(0.1, accel0=3.0)(jnp.concatenate([uj, pj]))),
    ]
    for got, want in pairs:
        assert got.device == torch.device("cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_APPLY)
    for got, want in zip(to.diagonals(), jo.diagonals()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_APPLY)


def test_sharding_invariance():
    u, _ = _random_state(_spaces()[1], 3)
    r = [_ops(n)[1].make_velocity_mass()(torch.tensor(u)) for n in (1, 2, 8)]
    assert np.abs((r[1] - r[0]).numpy()).max() <= ATOL_APPLY
    assert np.abs((r[2] - r[0]).numpy()).max() <= ATOL_APPLY
    # padding: 128 cells over 3 shards leave two zero-weight cells
    three = ShardedCellOperator(_spaces()[1], ["cpu"] * 3)
    assert three.n_cells_padded == 129 and three.chunk == 43
    r3 = three.make_velocity_mass()(torch.tensor(u))
    assert np.abs((r3 - r[0]).numpy()).max() <= ATOL_APPLY


def test_gradient_divergence_adjoint():
    """<G p, u> == <p, D u> over 2 shards."""
    _, to = _ops(2)
    u, p = (torch.tensor(a) for a in _random_state(to.space, 5))
    lhs = float(torch.dot(to.make_gradient()(p), u))
    rhs = float(torch.dot(p, to.make_divergence()(u)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_operator_refuses_a_device_off_the_mesh():
    with pytest.raises(ValueError, match="shard 0"):
        ShardedCellOperator(_spaces()[1], ["cpu"] * 2, device="meta")


# ---------------------------------------------------------------------------
# the fused step over the sharded operator
# ---------------------------------------------------------------------------

def _tg(space):
    u = space.interpolate_velocity(
        lambda x: np.stack([np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
                            -np.sin(GAMMA * x[:, 0])
                            * np.cos(GAMMA * x[:, 1])], axis=1)).reshape(-1)
    p = space.interpolate_pressure(
        lambda x: -0.25 * (np.cos(2 * GAMMA * x[:, 0])
                           + np.cos(2 * GAMMA * x[:, 1])))
    return u, p


def _run_steps(step, u, p, n, tensor):
    u, p = tensor(u), tensor(p)
    phi, u_old = 0.0 * p, u
    for i in range(n):
        a, e = (A1, E1) if i == 0 else (A2, E2)
        u_new, p, phi = step(u, u_old, p, phi, a, e)
        u_old, u = u, u_new
    return np.asarray(u), np.asarray(p), np.asarray(phi)


def test_fused_step_over_shards_matches_taylor_green():
    """The step needs nothing of the operator but its replicated vectors:
    5 steps over 4 shards match the JAX step over 4 devices and the
    port's one-shard step."""
    js, ts = _spaces()
    kw = dict(visc=0.01, dt=5e-3, cg_iters=(30, 60, 15))
    u0, p0 = _tg(ts)
    got = _run_steps(build_projection_step(
        ts, ShardedCellOperator(ts, device_mesh(4, device="cpu")), **kw),
        u0, p0, 5, torch.tensor)
    one = _run_steps(build_projection_step(ts, _ops(1)[1], **kw),
                     u0, p0, 5, torch.tensor)
    want = _run_steps(jax_build_step(
        js, JaxCellOperator(js, jax_device_mesh(4)), **kw), u0, p0, 5,
        jnp.asarray)
    for g, o, w in zip(got, one, want):
        assert np.abs(g - w).max() <= ATOL_STEP
        assert np.abs(g - o).max() <= ATOL_STEP


def test_masked_fused_step_over_shards_matches_the_channel():
    """Dirichlet-masked step (inflow, walls, a pressure outlet) over 2
    shards: 5 steps match the JAX step over 2 devices."""
    from navierstokes_tpu.mesh import hyper_rectangle as jax_rectangle
    from navierstokes_tpu_torch import setups
    from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu_torch.fem.bcs import PressureBCType

    mesh, markers, bcs = setups.channel_setup(20, 4)
    space = TaylorHoodSpace(mesh)
    jspace = JaxSpace(jax_rectangle((0.0, 0.0), (5.0, 1.0), (20, 4))[0])
    vbc, _ = compile_dirichlet_bcs(space, markers, [
        b for b in bcs if not isinstance(b[0], PressureBCType)], [])
    pbc, _ = compile_dirichlet_bcs(space, markers, [], [
        b for b in bcs if isinstance(b[0], PressureBCType)])
    v_mask = np.zeros(space.n_velocity_dofs, bool)
    v_mask[np.asarray(vbc.dofs)] = True
    v_vals = np.zeros(space.n_velocity_dofs)
    v_vals[np.asarray(vbc.dofs)] = np.asarray(vbc.values())
    p_mask = np.zeros(space.n_pnodes, bool)
    p_mask[np.asarray(pbc.dofs) - space.pressure_offset] = True
    kw = dict(visc=0.1, dt=0.02, cg_iters=(15, 60, 10),
              vel_bc=(v_mask, v_vals), pres_bc_mask=p_mask)
    zero_u, zero_p = np.zeros(space.n_velocity_dofs), np.zeros(space.n_pnodes)
    got = _run_steps(build_projection_step(
        space, ShardedCellOperator(space, device_mesh(2, device="cpu")),
        **kw), zero_u, zero_p, 5, torch.tensor)
    want = _run_steps(jax_build_step(
        jspace, JaxCellOperator(jspace, jax_device_mesh(2)), **kw),
        zero_u, zero_p, 5, jnp.asarray)
    assert np.abs(got[0]).max() > 0.1
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= ATOL_STEP
