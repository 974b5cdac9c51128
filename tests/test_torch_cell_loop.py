"""Port parity: the cell-loop step (parallel/sharded.py's
``ShardedCellOperator`` and solvers/fused_step.py), the step a mesh takes
when no banded format holds it, and the backward-facing step's
stationary solve on the shipped gmsh mesh.

CPU, float64, against the JAX package on the same inputs.  The element
matrices are the same NumPy code; the applies differ in summation order
only (a fixed-order padded gather sum against XLA's), so matvecs on
unit-normal inputs agree to 1e-12 absolute.  After 5 steps u, p and phi
agree to 1e-10 absolute (fields O(1)), the residual norms to 1e-6
relative with a 1e-13 floor (a residual at roundoff has no digits to
compare).  The stationary solution on the shipped mesh agrees to 1e-9.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import read_geo_msh as jax_read_geo_msh
from navierstokes_tpu.mesh import spherical_shell as jax_spherical_shell
from navierstokes_tpu.parallel.sharded import \
    ShardedCellOperator as JaxCellOperator
from navierstokes_tpu.parallel.sharded import device_mesh as jax_device_mesh
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu.solvers import StationarySolver as JaxStationary
from navierstokes_tpu.solvers.fused_step import \
    build_projection_step as jax_build_step
from navierstokes_tpu.timestepping import BDFTimeStepping as JaxBDF
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.fem.bcs import VelocityBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import (hyper_cube, read_geo_msh,
                                         spherical_shell)
from navierstokes_tpu_torch.parallel.sharded import (ShardedCellOperator,
                                                     device_mesh)
from navierstokes_tpu_torch.solvers import ProjectionSolver, StationarySolver
from navierstokes_tpu_torch.solvers.fused_step import build_projection_step
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_APPLY = 1e-12
ATOL_STEP = 1e-10
ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bcs(bcs):
    """The port's BC tuples with the JAX package's enums."""
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


_OPS = {}


def _ops(mesh_name):
    """(JAX operator, port operator) on the same mesh, built once."""
    if mesh_name not in _OPS:
        if mesh_name == "box8":
            jm, _ = jax_hyper_cube(2, 8)
            tm, _ = hyper_cube(2, 8)
        else:
            jm, _ = jax_spherical_shell(3, (0.5, 1.0), 4)
            tm, _ = spherical_shell(3, (0.5, 1.0), 4)
        _OPS[mesh_name] = (
            JaxCellOperator(JaxSpace(jm), jax_device_mesh(1)),
            ShardedCellOperator(TaylorHoodSpace(tm), device_mesh(
                1, device="cpu")))
    return _OPS[mesh_name]


@pytest.mark.parametrize("mesh_name", ["box8", "shell4"])
def test_cell_operator_matvecs_match(mesh_name):
    jo, to = _ops(mesh_name)
    space = to.space
    assert to.dtype == torch.float64 and to.device == torch.device("cpu")
    assert np.array_equal(to.cell_order, np.asarray(jo.cell_order))
    rng = np.random.default_rng(2)
    u = rng.standard_normal(space.n_velocity_dofs)
    p = rng.standard_normal(space.n_pnodes)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    pt, pj = torch.tensor(p), jnp.asarray(p)
    a0 = 3.0
    pairs = [
        (to.make_velocity_mass()(ut), jo.make_velocity_mass()(uj)),
        (to.make_velocity_helmholtz(0.1)(ut, a0),
         jo.make_velocity_helmholtz(0.1)(uj, jnp.asarray(a0))),
        (to.make_gradient()(pt), jo.make_gradient()(pj)),
        (to.make_divergence()(ut), jo.make_divergence()(uj)),
        (to.make_pressure_stiffness()(pt), jo.make_pressure_stiffness()(pj)),
        (to.make_convection_rhs(0.7)(ut), jo.make_convection_rhs(0.7)(uj)),
        (to.make_stokes_matvec(0.1, accel0=a0)(torch.cat([ut, pt])),
         jo.make_stokes_matvec(0.1, accel0=a0)(jnp.concatenate([uj, pj]))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_APPLY)
    for got, want in zip(to.diagonals(), jo.diagonals()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_APPLY)


def test_device_mesh_is_one_device():
    """``device_mesh()`` is one shard; more shards are a mesh (CPU shards
    here; without a card the default, the cards, raises), and the cell
    operator over a plain list of two devices equals the one-shard one."""
    assert device_mesh(device="cpu") == [torch.device("cpu")]
    assert device_mesh(4, device="cpu") == ["cpu"] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device_mesh(4)
    _, to = _ops("box8")
    two = ShardedCellOperator(to.space, ["cpu", "cpu"])
    assert two.n_dev == 2 and two.device == torch.device("cpu")
    u = torch.tensor(np.random.default_rng(7).standard_normal(
        to.space.n_velocity_dofs))
    np.testing.assert_allclose(two.make_velocity_mass()(u).numpy(),
                               to.make_velocity_mass()(u).numpy(), rtol=0,
                               atol=ATOL_APPLY)


def _masks(space, case):
    """Full-length velocity mask/values and the pressure mask of a case.

    ``cavity``: every boundary node of the unit square fixed, the lid at
    (1, 0), mean-free pressure.  ``channel``: the inflow (y (1 - y), 0) on
    x = 0, no slip on y = 0, 1, the pressure pinned on x = 1.  ``shell``:
    the inner sphere rotating about z, the outer at rest, mean-free."""
    x = space.u_coords
    dim = space.dim
    vals = np.zeros((space.n_unodes, dim))
    if case == "shell":
        r = np.linalg.norm(x, axis=1)
        inner, outer = np.abs(r - 0.5) < 1e-6, np.abs(r - 1.0) < 1e-6
        fixed = inner | outer
        vals[inner, 0], vals[inner, 1] = -x[inner, 1], x[inner, 0]
        return np.repeat(fixed, dim), vals.reshape(-1), None
    on = lambda v: np.abs(x[:, v[0]] - v[1]) < 1e-12
    if case == "cavity":
        fixed = on((0, 0.0)) | on((0, 1.0)) | on((1, 0.0)) | on((1, 1.0))
        vals[on((1, 1.0)), 0] = 1.0
        pres = None
    else:
        fixed = on((0, 0.0)) | on((1, 0.0)) | on((1, 1.0))
        left = on((0, 0.0))
        vals[left, 0] = x[left, 1] * (1 - x[left, 1])
        xp = space.p_coords
        pres = np.abs(xp[:, 0] - 1.0) < 1e-12
    return np.repeat(fixed, dim), vals.reshape(-1), pres


@pytest.mark.parametrize("rtol", [None, 1e-10], ids=["fixed", "rtol"])
@pytest.mark.parametrize("case", ["cavity", "channel", "shell"])
def test_cell_loop_steps_match(case, rtol):
    """5 cell-loop steps of both packages from rest; ``channel`` also
    passes per-step ``bc_values``, a step size ``k`` and a ``body_rhs``."""
    jo, to = _ops("shell4" if case == "shell" else "box8")
    space = to.space
    vmask, vvals, pmask = _masks(space, case)
    kw = dict(visc=0.05, dt=0.02, cg_iters=(30, 120, 15), cg_rtol=rtol,
              with_residuals=True, conv_coeff=1.0)
    step_j = jax_build_step(
        jo.space, jo, vel_bc=(jnp.asarray(vmask), jnp.asarray(vvals)),
        pres_bc_mask=None if pmask is None else jnp.asarray(pmask), **kw)
    step_t = build_projection_step(space, to, vel_bc=(vmask, vvals),
                                   pres_bc_mask=pmask, **kw)
    extra_j, extra_t = {}, {}
    if case == "channel":
        rng = np.random.default_rng(6)
        body = 1e-2 * rng.standard_normal(space.n_velocity_dofs)
        bc = 1.1 * vvals
        extra_j = dict(bc_values=jnp.asarray(bc), k=jnp.asarray(0.025),
                       body_rhs=jnp.asarray(body))
        extra_t = dict(bc_values=torch.tensor(bc), k=0.025,
                       body_rhs=torch.tensor(body))
    nu, np_ = space.n_velocity_dofs, space.n_pnodes
    sj = [jnp.asarray(vvals), jnp.asarray(vvals), jnp.zeros(np_),
          jnp.zeros(np_)]
    st = [torch.tensor(vvals), torch.tensor(vvals),
          torch.zeros(np_, dtype=torch.float64),
          torch.zeros(np_, dtype=torch.float64)]
    assert len(vvals) == nu
    for i in range(5):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        un, p, phi, rj = step_j(*sj, tuple(jnp.asarray(v) for v in a),
                                tuple(jnp.asarray(v) for v in e), **extra_j)
        sj = [un, sj[0], p, phi]
        un, p, phi, rt = step_t(*st, a, e, **extra_t)
        st = [un, st[0], p, phi]
    for got, want in zip(st, sj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_STEP)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-13)
    assert np.isfinite(st[0].numpy()).all()


def test_shell_solver_falls_back_to_the_cell_loop(monkeypatch):
    """Spherical Couette flow on ``spherical_shell(3, (0.5, 1.0), 4)``
    through both packages' ProjectionSolver with a band budget no format
    meets (``NS_FASTOP_MAX_BYTES``): one ``fastop_fallback`` record, the
    ``generic`` step, the same 5 steps (1e-10)."""
    monkeypatch.setenv("NS_FASTOP_MAX_BYTES", "1e4")
    out = []
    for port in (False, True):
        mesh, markers, bcs = setups.spherical_couette_setup(4)
        if not port:
            mesh, markers = jax_spherical_shell(3, (0.5, 1.0), 4)
        ts = (BDFTimeStepping if port else JaxBDF)(
            0.0, 1.0, desired_start_time_step=0.05)
        kw = dict(device="cpu") if port else {}
        s = (ProjectionSolver if port else JaxSolver)(
            mesh, markers, "standard", ts, cg_rtol=1e-10, **kw)
        s.set_boundary_conditions(bcs if port else _jax_bcs(bcs))
        s.set_equation_coefficients({"convective_term": 1.0,
                                     "viscous_term": 0.25,
                                     "pressure_term": 1.0})
        s.set_initial_conditions({"velocity": (0.0, 0.0, 0.0)})
        for _ in range(5):
            ts.update_coefficients()
            s.solve()
            ts.advance_time()
            s.advance_time()
        out.append(s)
    js, s = out
    assert s._step_kind == js._step_kind == "generic"
    assert [r["kind"] for r in s.monitor.records].count(
        "fastop_fallback") == 1
    for name in ("_u", "_u_old", "_p", "_phi"):
        got = getattr(s, name).numpy()
        assert np.abs(np.asarray(getattr(js, name)) - got).max() \
            <= ATOL_STEP, name
    # the rotating inner sphere is held
    u, _ = s.space.split(s.solution.numpy())
    x = s.space.u_coords
    inner = np.abs(np.linalg.norm(x, axis=1) - 0.5) < 1e-6
    np.testing.assert_allclose(u[inner, 0], -x[inner, 1], atol=1e-12)


def _bfs_solve(port):
    geo = os.path.join(REPO, "meshes", "backward_facing_step.geo")
    mesh, markers, mm = (read_geo_msh if port else jax_read_geo_msh)(geo)

    def inlet_profile(x):
        s = (x[:, 1] - 0.5) / 0.5
        return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    kw = dict(device="cpu") if port else {}
    solver = (StationarySolver if port else JaxStationary)(
        mesh, markers, tol=1e-10, **kw)
    bcs = ((VelocityBCType.function, mm["inlet"], inlet_profile),
           (VelocityBCType.no_slip, mm["walls"], None))
    solver.set_boundary_conditions(bcs if port else _jax_bcs(bcs))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / 50.0,
         "pressure_term": 1.0, "coriolis_term": None, "euler_term": None,
         "body_force_term": None})
    solver.solve()
    return solver


def test_backward_facing_step_on_the_shipped_msh_matches_jax():
    js, s = _bfs_solve(False), _bfs_solve(True)
    got = s.solution.numpy()
    want = np.asarray(js.solution)
    assert np.abs(got - want).max() <= 1e-9
    u, _ = s.space.split(got)
    assert np.isfinite(u).all() and np.abs(u).max() > 1.0


def test_cell_loop_with_body_force_matches_the_banded_step(monkeypatch):
    """The same cavity with a body force through the banded step and
    through the cell loop (forced by an engine that refuses): both
    discretize the same finite-element operators, so with the solves
    converged to 1e-12 the states after 3 steps agree to 1e-9.  (The JAX
    ``ProjectionSolver`` takes no body force: its ``MixedOperator`` lacks
    ``mass_rhs``.)"""
    from navierstokes_tpu_torch.assembly.fastop import StructureError
    from navierstokes_tpu_torch.solvers import projection

    engine = projection.FastTaylorHood

    def refuse(*args, **kwargs):
        raise StructureError("forced")

    def run(force):
        monkeypatch.setattr(projection, "FastTaylorHood",
                            refuse if force else engine)
        mesh, markers, bcs = setups.lid_driven_cavity_setup(6)
        ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.02)
        s = ProjectionSolver(mesh, markers, "standard", ts, device="cpu",
                             cg_rtol=1e-12, poisson_precond=None,
                             cg_iters=(200, 2000, 200))
        s.set_boundary_conditions(bcs)
        s.set_equation_coefficients({"convective_term": 1.0,
                                     "viscous_term": 0.05,
                                     "pressure_term": 1.0,
                                     "body_force_term": 1.0})
        s.set_body_force(lambda x: np.stack(
            [np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 0])], axis=1))
        s.set_initial_conditions({"velocity": (0.0, 0.0)})
        for _ in range(3):
            ts.update_coefficients()
            s.solve()
            ts.advance_time()
            s.advance_time()
        return s

    fast, cell = run(False), run(True)
    assert fast._step_kind == "fast" and cell._step_kind == "generic"
    assert cell._body_rhs is not None and cell._body_rhs.dim() == 1
    assert np.abs(fast.solution.numpy() - cell.solution.numpy()).max() \
        <= 1e-9
