"""Port parity: the dof-partitioned halo layer (parallel/halo.py), the
halo projection step (solvers/halo_step.py) and ``ProjectionSolver``'s
halo route; mirrors tests/test_halo.py.

CPU, float64, the JAX package on the conftest's 8 virtual devices, the
port on ``device_mesh(n, device="cpu")``.  The host plan is the same NumPy
code and its arrays are equal; every apply at 1, 2 and 8 shards agrees to
1e-12 absolute on unit-normal inputs; a few halo steps agree with the JAX
halo step and the one-shard cell-loop step to 1e-10; the solver through
its ``device_mesh`` matches the JAX package's halo solver to 1e-10 and the
one-device solver to 1e-9 (both converge every solve to 1e-13).  A
checkpoint written by the JAX package's sharded solver resumes in the
port's to 1e-10, and within the port a checkpoint crosses between 4
shards and 1 bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_periodic
from navierstokes_tpu.io.checkpoint import save_checkpoint as jax_save
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_rectangle
from navierstokes_tpu.parallel.halo import HaloCellOperator as JaxHalo
from navierstokes_tpu.parallel.sharded import device_mesh as jax_device_mesh
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu.solvers.halo_step import \
    build_halo_projection_step as jax_build_halo_step
from navierstokes_tpu.timestepping import BDFTimeStepping as JaxBDF
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.io import load_checkpoint, save_checkpoint
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.parallel.comm import Sharded
from navierstokes_tpu_torch.parallel.halo import HaloCellOperator
from navierstokes_tpu_torch.parallel.sharded import (ShardedCellOperator,
                                                     device_mesh)
from navierstokes_tpu_torch.solvers import ProjectionSolver
from navierstokes_tpu_torch.solvers.fused_step import build_projection_step
from navierstokes_tpu_torch.solvers.halo_step import \
    build_halo_projection_step
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

ATOL_APPLY = 1e-12
ATOL_STEP = 1e-10
A2, E2 = (1.5, -2.0, 0.5), (2.0, -1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BOX = {}


def _box(n=12):
    if n not in _BOX:
        _BOX[n] = (JaxSpace(jax_hyper_cube(2, n)[0]),
                   TaylorHoodSpace(hyper_cube(2, n)[0]))
    return _BOX[n]


_OPS = {}


def _ops(n_shards):
    if n_shards not in _OPS:
        js, ts = _box()
        _OPS[n_shards] = (JaxHalo(js, jax_device_mesh(n_shards)),
                          HaloCellOperator(ts, device_mesh(n_shards,
                                                           device="cpu")))
    return _OPS[n_shards]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_halo_plan_arrays_equal(n_shards):
    jo, to = _ops(n_shards)
    assert (to.chunk_c, to.chunk_u, to.chunk_p) == \
        (jo.chunk_c, jo.chunk_u, jo.chunk_p)
    assert np.array_equal(to._u_new_id, jo._u_new_id)
    assert np.array_equal(to._p_old_of_new, jo._p_old_of_new)
    for tp, jp in ((to.u_plan, jo.u_plan), (to.p_plan, jo.p_plan)):
        assert tp.offsets == jp.offsets
        assert tp.halo_sizes == jp.halo_sizes
        assert tp.n_local == jp.n_local
        for k in tp.offsets:
            assert np.array_equal(tp.send_idx[k], np.asarray(jp.send_idx[k]))
        assert np.array_equal(tp.cell_nodes_local,
                              np.asarray(jp.cell_nodes_local))
        assert np.array_equal(tp.tables, np.asarray(jp.tables))
    assert to.halo_report() == jo.halo_report()


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_halo_operators_match(n_shards):
    jo, to = _ops(n_shards)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(to.space.n_velocity_dofs)
    p = rng.standard_normal(to.space.n_pnodes)
    uj, pj = jo.pad_velocity(jnp.asarray(u)), jo.pad_pressure(jnp.asarray(p))
    ut, pt = to.pad_velocity(torch.tensor(u)), to.pad_pressure(torch.tensor(p))
    assert isinstance(ut, Sharded) and len(ut) == n_shards
    assert all(b.numel() == to.chunk_u * 2 for b in ut)
    vel = (jo.unpad_velocity, to.unpad_velocity)
    prs = (jo.unpad_pressure, to.unpad_pressure)
    cases = {
        "mass": (jo.make_velocity_mass()(uj), to.make_velocity_mass()(ut),
                 vel),
        "helm": (jo.make_velocity_helmholtz(0.1)(uj, 2.0),
                 to.make_velocity_helmholtz(0.1)(ut, 2.0), vel),
        "grad": (jo.make_gradient()(pj), to.make_gradient()(pt), vel),
        "div": (jo.make_divergence()(uj), to.make_divergence()(ut), prs),
        "lap": (jo.make_pressure_stiffness()(pj),
                to.make_pressure_stiffness()(pt), prs),
        "conv": (jo.make_convection_rhs(1.0)(uj),
                 to.make_convection_rhs(1.0)(ut), vel),
    }
    for name, (want, got, (junpad, tunpad)) in cases.items():
        err = np.abs(tunpad(got).numpy() - np.asarray(junpad(want))).max()
        assert err <= ATOL_APPLY, (name, err)
    for got, want in zip(to.diagonals(), jo.diagonals()):
        assert np.array_equal(torch.cat(list(got)).numpy(),
                              np.asarray(want))
    if n_shards > 1:
        assert to.halo_bytes > 0


def test_halo_memory_is_partitioned():
    """Per-shard storage O(dofs/n + halo), the halo a small fraction."""
    js, ts = _box(24)
    op = HaloCellOperator(ts, device_mesh(8, device="cpu"))
    rep = op.halo_report()
    assert rep == JaxHalo(js, jax_device_mesh(8)).halo_report()
    assert rep["u_nodes_per_device"] < ts.n_unodes / 4
    assert rep["u_halo_per_device"] < rep["u_nodes_per_device"]
    assert rep["p_halo_per_device"] < rep["p_nodes_per_device"]


def test_halo_pad_roundtrip():
    _, op = _ops(8)
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.standard_normal(op.space.n_velocity_dofs))
    p = torch.tensor(rng.standard_normal(op.space.n_pnodes))
    assert torch.equal(op.unpad_velocity(op.pad_velocity(u)), u)
    assert torch.equal(op.unpad_pressure(op.pad_pressure(p)), p)


def test_halo_cg_solves_pressure_poisson():
    """A CG solve entirely in the partitioned layout: dots and axpys on
    the shards' blocks, exchanges inside the matvec."""
    from navierstokes_tpu_torch.parallel.comm import sharded_dot, sharded_sum

    _, op = _ops(8)
    lap = op.make_pressure_stiffness()
    rng = np.random.default_rng(2)
    x_exact = rng.standard_normal(op.space.n_pnodes)
    x_exact -= x_exact.mean()
    b = lap(op.pad_pressure(torch.tensor(x_exact)))
    mask = op.pad_pressure(torch.ones(op.space.n_pnodes, dtype=torch.float64))
    n_real = float(op.space.n_pnodes)

    def project(v):
        return (v - sharded_sum(v * mask, op.mesh) / n_real) * mask

    x = 0.0 * b
    r = project(b)
    pvec, rz = r, sharded_dot(r, r, op.mesh)
    for _ in range(400):
        Ap = project(lap(pvec))
        alpha = rz / sharded_dot(pvec, Ap, op.mesh)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rz_new = sharded_dot(r, r, op.mesh)
        if float(rz_new[0]) ** 0.5 < 1e-10:
            break
        pvec = r + (rz_new / rz) * pvec
        rz = rz_new
    sol = op.unpad_pressure(x).numpy()
    assert np.abs(sol - sol.mean() - x_exact).max() < 1e-7


# ---------------------------------------------------------------------------
# the halo projection step
# ---------------------------------------------------------------------------

def _steps(step, u, p, n, pad=None, unpad=None):
    """n BDF-2 steps from (u, u, p, 0); returns (u, p) in space layout."""
    pad = pad or (lambda a, kind: a)
    unpad = unpad or (lambda a, kind: a)
    u, p = pad(u, "u"), pad(p, "p")
    phi, u_old = 0.0 * p, u
    for _ in range(n):
        u_new, p, phi = step(u, u_old, p, phi, A2, E2)
        u_old, u = u, u_new
    return np.asarray(unpad(u, "u")), np.asarray(unpad(p, "p"))


def _layout(op, to_array):
    def pad(a, kind):
        a = to_array(a)
        return op.pad_velocity(a) if kind == "u" else op.pad_pressure(a)

    def unpad(a, kind):
        return op.unpad_velocity(a) if kind == "u" else op.unpad_pressure(a)

    return pad, unpad


def test_halo_step_periodic_mean_free():
    """Enclosed periodic flow: the mean-free gauge acts on real nodes only
    (padding slots stay zero); 3 steps over 8 shards."""
    jm, tm = jax_hyper_cube(2, 8)[0], hyper_cube(2, 8)[0]
    js = JaxSpace(jm, periodic=[jax_periodic(0), jax_periodic(1)])
    ts = TaylorHoodSpace(tm, periodic=[axis_periodic(0), axis_periodic(1)])
    g = 2 * np.pi
    u0 = ts.interpolate_velocity(
        lambda x: np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                            -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                           axis=1)).reshape(-1)
    p0 = ts.interpolate_pressure(
        lambda x: -0.25 * (np.cos(2 * g * x[:, 0])
                           + np.cos(2 * g * x[:, 1])))
    kw = dict(visc=0.01, dt=1e-3, cg_iters=(12, 60, 8))
    top = HaloCellOperator(ts, device_mesh(8, device="cpu"))
    got = _steps(build_halo_projection_step(top, **kw), u0, p0, 3,
                 *_layout(top, torch.tensor))
    for blk in top.pad_pressure(torch.tensor(p0)):
        assert blk.numel() == top.chunk_p
    jop = JaxHalo(js, jax_device_mesh(8))
    want = _steps(jax_build_halo_step(jop, **kw), u0, p0, 3,
                  *_layout(jop, jnp.asarray))
    one = _steps(build_projection_step(
        ts, ShardedCellOperator(ts, device_mesh(1, device="cpu")), **kw),
        torch.tensor(u0), torch.tensor(p0), 3)
    for g_, w, o in zip(got, want, one):
        assert np.abs(g_ - w).max() <= ATOL_STEP
        assert np.abs(g_ - o).max() <= ATOL_STEP


def _channel_masks(space, markers, bcs):
    from navierstokes_tpu_torch.fem.bcs import PressureBCType
    from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs

    vbc, _ = compile_dirichlet_bcs(space, markers, [
        b for b in bcs if not isinstance(b[0], PressureBCType)], [])
    pbc, _ = compile_dirichlet_bcs(space, markers, [], [
        b for b in bcs if isinstance(b[0], PressureBCType)])
    vmask = np.zeros(space.n_velocity_dofs, bool)
    vmask[np.asarray(vbc.dofs, np.int64)] = True
    vvals = np.zeros(space.n_velocity_dofs)
    vvals[np.asarray(vbc.dofs, np.int64)] = np.asarray(vbc.values(0.0))
    pmask = np.zeros(space.n_pnodes, bool)
    pmask[np.asarray(pbc.dofs, np.int64) - space.pressure_offset] = True
    return (vmask, vvals), pmask


@pytest.mark.parametrize("n_shards", [2, 8])
def test_halo_step_channel_matches_one_device(n_shards):
    """Dirichlet inflow, walls and a pressure outlet: 5 steps on
    partitioned state match the one-shard cell-loop step of both
    packages."""
    from navierstokes_tpu.parallel.sharded import \
        ShardedCellOperator as JaxCellOperator
    from navierstokes_tpu.solvers.fused_step import \
        build_projection_step as jax_build_step

    mesh, markers, bcs = setups.channel_setup(16, 4)
    space = TaylorHoodSpace(mesh)
    vel_bc, pmask = _channel_masks(space, markers, bcs)
    kw = dict(visc=0.1, dt=0.02, cg_iters=(40, 200, 20), vel_bc=vel_bc,
              pres_bc_mask=pmask, cg_rtol=1e-13)
    zu, zp = np.zeros(space.n_velocity_dofs), np.zeros(space.n_pnodes)
    op = HaloCellOperator(space, device_mesh(n_shards, device="cpu"))
    got = _steps(build_halo_projection_step(op, **kw), zu, zp, 5,
                 *_layout(op, torch.tensor))
    if "channel" not in _BOX:
        jspace = JaxSpace(jax_rectangle((0.0, 0.0), (5.0, 1.0), (16, 4))[0])
        _BOX["channel"] = _steps(jax_build_step(
            jspace, JaxCellOperator(jspace, jax_device_mesh(1)), **kw),
            jnp.asarray(zu), jnp.asarray(zp), 5)
    want = _BOX["channel"]
    assert np.abs(got[0]).max() > 0.1
    for g_, w in zip(got, want):
        assert np.abs(g_ - w).max() <= ATOL_STEP


# ---------------------------------------------------------------------------
# ProjectionSolver(device_mesh=...)
# ---------------------------------------------------------------------------

def _jax_bcs(bcs):
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


def _inlet(x):
    return np.stack([np.sin(np.pi * x[:, 1]), np.zeros(len(x))], axis=1)


def _solver(package, mesh_arg):
    mesh, markers, bcs = setups.channel_setup(16, 4, inlet=_inlet)
    kw = dict(cg_iters=(60, 400, 30), cg_rtol=1e-13, device_mesh=mesh_arg)
    if package == "jax":
        jmesh, jmarkers = jax_rectangle((0.0, 0.0), (5.0, 1.0), (16, 4))
        ts = JaxBDF(0.0, 1.0, desired_start_time_step=0.02)
        s = JaxSolver(jmesh, jmarkers, "standard", ts, **kw)
        s.set_boundary_conditions(_jax_bcs(bcs))
    else:
        ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.02)
        s = ProjectionSolver(mesh, markers, "standard", ts, device="cpu",
                             **kw)
        s.set_boundary_conditions(bcs)
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 0.1, "pressure_term": 1.0})
    s.set_initial_conditions({"velocity": (0.0, 0.0)})
    return s, ts


def _run(solver, ts, n):
    for _ in range(n):
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    return np.asarray(solver.solution)


_RUNS = {}


def _jax_halo_run(tmp_path_factory):
    """The JAX package's 8-device halo solver: 2 steps, a checkpoint,
    2 more steps; computed once."""
    if "jax" not in _RUNS:
        s, ts = _solver("jax", jax_device_mesh(8))
        _run(s, ts, 2)
        path = str(tmp_path_factory.mktemp("jax") / "halo.npz")
        jax_save(path, s, ts)
        _RUNS["jax"] = (path, _run(s, ts, 2), s._step_kind)
    return _RUNS["jax"]


def test_projection_solver_halo_route_matches(tmp_path_factory):
    path, want, jax_kind = _jax_halo_run(tmp_path_factory)
    s, ts = _solver("torch", device_mesh(4, device="cpu"))
    got = _run(s, ts, 4)
    assert s._step_kind == jax_kind == "halo"
    assert s._hops.n_dev == 4 and s.solution.device == torch.device("cpu")
    assert np.abs(got - want).max() <= ATOL_STEP
    one, one_ts = _solver("torch", None)
    x1 = _run(one, one_ts, 4)
    assert one._step_kind == "fast"
    assert np.abs(got - x1).max() <= 1e-9
    # a plain list of devices is a mesh
    listed, _ = _solver("torch", ["cpu", "cpu"])
    listed._setup_problem()
    assert listed._step_kind == "halo" and listed._hops.n_dev == 2


def test_jax_sharded_checkpoint_resumes_in_the_port(tmp_path_factory):
    path, want, _ = _jax_halo_run(tmp_path_factory)
    s, ts = _solver("torch", device_mesh(8, device="cpu"))
    s._setup_problem()
    load_checkpoint(path, s, ts)
    assert ts.step_number == 2 and s._step_kind == "halo"
    assert np.abs(_run(s, ts, 2) - want).max() <= ATOL_STEP


def test_checkpoint_crosses_shard_counts_bitwise(tmp_path):
    """4 shards -> a checkpoint -> 1 shard -> a checkpoint -> 4 shards:
    each reader starts from the writer's state bit for bit, and a resumed
    sharded run equals the unbroken one bit for bit."""
    def state(s):
        return [v.clone() for v in (s._u, s._u_old, s._p, s._phi)]

    a, ats = _solver("torch", device_mesh(4, device="cpu"))
    _run(a, ats, 3)
    p1 = str(tmp_path / "four.npz")
    save_checkpoint(p1, a, ats)
    one, one_ts = _solver("torch", ["cpu"])
    one._setup_problem()
    load_checkpoint(p1, one, one_ts)
    assert one._step_kind == "fast"
    assert all(torch.equal(x, y) for x, y in zip(state(one), state(a)))
    _run(one, one_ts, 2)
    p2 = str(tmp_path / "one.npz")
    save_checkpoint(p2, one, one_ts)
    b, bts = _solver("torch", device_mesh(4, device="cpu"))
    b._setup_problem()
    load_checkpoint(p2, b, bts)
    assert all(torch.equal(x, y) for x, y in zip(state(b), state(one)))
    c, cts = _solver("torch", device_mesh(4, device="cpu"))
    c._setup_problem()
    load_checkpoint(p1, c, cts)
    assert np.array_equal(_run(c, cts, 2), _run(a, ats, 2))
