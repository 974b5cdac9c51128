"""Port parity: the 3D banded engine (assembly/fastop.py on 3D spaces), the
planar step and ``ProjectionSolver`` on it, and 3D through the rest of
the stack (``StationarySolver``, the spectral path of ``ProjectionSolver``).

CPU, float64, against the JAX package.  Host assembly is the same NumPy
code, so permutations and band arrays are EQUAL; the applies differ only
in summation order and are held to 1e-12 absolute on unit-normal inputs.
After 4 raw banded steps u, p and phi agree to 1e-10 absolute; through
``ProjectionSolver`` after 5 steps to 1e-9 (fields O(1), as in
``tests/test_torch_projection_solver.py``); the Couette solution, which
lies in the P2 space, to 1e-10 between the packages and 1e-10 of the
exact field.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu.solvers import StationarySolver as JaxStationary
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_build_step
from navierstokes_tpu.timestepping import BDFTimeStepping as JaxBDF
from navierstokes_tpu_torch import cudalib, setups
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu_torch.mesh import hyper_cube, hyper_rectangle
from navierstokes_tpu_torch.solvers import ProjectionSolver, StationarySolver
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

ATOL_APPLY = 1e-12
ATOL_STEP = 1e-10
ATOL_SOLVER = 1e-9
GAMMA = 2.0 * np.pi
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


_ENGINES = {}
BOXES = {"cube3": ((0.0,) * 3, (1.0,) * 3, (3, 3, 3)),
         "duct": ((0.0,) * 3, (3.0, 1.0, 1.0), (6, 2, 2))}


def _engines(box):
    """(JAX engine, port engine) on the same 3D box, built once."""
    if box not in _ENGINES:
        lo, hi, n = BOXES[box]
        jmesh, _ = jax_hyper_rectangle(lo, hi, n)
        tmesh, _ = hyper_rectangle(lo, hi, n)
        _ENGINES[box] = (jfo.FastTaylorHood(JaxSpace(jmesh)),
                         tfo.FastTaylorHood(TaylorHoodSpace(tmesh),
                                            device="cpu"))
    return _ENGINES[box]


@pytest.mark.parametrize("box", list(BOXES))
def test_3d_engine_arrays_equal(box):
    jf, tf = _engines(box)
    assert np.array_equal(tf.permU, np.asarray(jf.permU))
    assert np.array_equal(tf.permP, np.asarray(jf.permP))
    for name, K in (("M", 65), ("K", 65), ("L", 15), ("Mp", 15)):
        t, j = getattr(tf, name), getattr(jf, name)
        assert isinstance(t, tfo.CirculantBand) and len(t.offsets) == K
        assert tuple(t.offsets) == tuple(int(o) for o in j.offsets)
        assert np.array_equal(t.band.numpy(), np.asarray(j.band))
    assert tf.structured and tf.conv_strided is None
    assert jf.conv_strided is None
    # no torus stencils in 3D: the couplings are rim operators
    for t, j in zip(tf.G + tf.D, list(jf.G) + list(jf.D)):
        assert type(t).__name__ == type(j).__name__ == "AffineBand"
        assert np.array_equal(t.bandmat.numpy(), np.asarray(j.bandmat))
    for t, j in zip(tf.diagonals(), jf.diagonals()):
        assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("box", list(BOXES))
def test_3d_engine_applies_match(box):
    jf, tf = _engines(box)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((3, tf.space.n_unodes))
    p = rng.standard_normal(tf.space.n_pnodes)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    pt, pj = torch.tensor(p), jnp.asarray(p)
    pairs = [(tf.M.apply(ut), jf.M.apply(uj)), (tf.K.apply(ut), jf.K.apply(uj)),
             (tf.L.apply(pt), jf.L.apply(pj)),
             (tfo.conv_apply(tf.ops, ut, 0.7), jf.make_convection_rhs(0.7)(uj))]
    pairs += [(tf.G[d].apply(pt), jf.G[d].apply(pj)) for d in range(3)]
    pairs += [(tf.D[d].apply(ut[d]), jf.D[d].apply(uj[d])) for d in range(3)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_APPLY)


@pytest.mark.parametrize("case", ["kernels", "rtol"])
def test_3d_raw_steps_match(case):
    """4 banded steps of the 3D lid-driven cavity on its engine: every
    boundary node masked (the lid at (1, 0, 0)), a mean-free Poisson;
    fixed iterations (every solve in the whole-solve PCG's plain version)
    and with a tolerance."""
    cudalib.reset_launch_counts()
    jf, tf = _engines("cube3")
    nu = tf.space.n_unodes
    x = tfo.node_coordinates(tf.space)[0][tf.permU]
    wall = ((x < 1e-12) | (x > 1 - 1e-12)).any(axis=1)
    v_mask = np.repeat(wall[None], 3, axis=0)
    v_vals = np.zeros((3, nu))
    v_vals[0, x[:, 1] > 1 - 1e-12] = 1.0
    kw = dict(visc=0.05, dt=2e-2, cg_iters=(12, 40, 8), with_residuals=True)
    if case == "rtol":
        kw["cg_rtol"] = 1e-10
    step_j = jax_build_step(jf, vel_bc=(jnp.asarray(v_mask),
                                        jnp.asarray(v_vals)), **kw)
    step_t = build_planar_projection_step(tf, vel_bc=(v_mask, v_vals), **kw)
    u0 = v_vals
    p0 = np.zeros(tf.space.n_pnodes)
    sj = [jnp.asarray(u0), jnp.asarray(u0), jnp.asarray(p0),
          jnp.zeros(len(p0))]
    st = [torch.tensor(u0), torch.tensor(u0), torch.tensor(p0),
          torch.zeros(len(p0), dtype=torch.float64)]
    for i in range(4):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        un, p, phi, rj = step_j(*sj, tuple(jnp.asarray(v) for v in a),
                                tuple(jnp.asarray(v) for v in e))
        sj = [un, sj[0], p, phi]
        un, p, phi, rt = step_t(*st, a, e)
        st = [un, st[0], p, phi]
    for got, want in zip(st, sj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_STEP)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-13)
    assert cudalib.launched() == {}


_SOLVERS = {}


def _duct_pair():
    """Both packages' ProjectionSolver on the duct (6, 2, 2), 5 steps."""
    if "duct" not in _SOLVERS:
        out = []
        mesh_t, markers_t, bcs = setups.duct_setup((6, 2, 2))
        for port in (False, True):
            ts = (BDFTimeStepping if port else JaxBDF)(
                0.0, 10.0, desired_start_time_step=0.05)
            if port:
                s = ProjectionSolver(mesh_t, markers_t, "standard", ts,
                                     cg_iters=(60, 600, 30), cg_rtol=1e-12,
                                     device="cpu")
            else:
                mesh, markers = jax_hyper_rectangle(
                    (0.0,) * 3, (3.0, 1.0, 1.0), (6, 2, 2))
                s = JaxSolver(mesh, markers, "standard", ts,
                              cg_iters=(60, 600, 30), cg_rtol=1e-12)
            s.set_boundary_conditions(bcs if port else _jax_bcs(bcs))
            s.set_equation_coefficients({"convective_term": 1.0,
                                         "viscous_term": 0.1,
                                         "pressure_term": 1.0})
            s.set_initial_conditions({"velocity": (0.0, 0.0, 0.0)})
            for _ in range(5):
                ts.update_coefficients()
                s.solve()
                ts.advance_time()
                s.advance_time()
            out.append(s)
        _SOLVERS["duct"] = out
    return _SOLVERS["duct"]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def test_3d_duct_projection_solver_matches_jax():
    js, s = _duct_pair()
    assert s._step_kind == js._step_kind == "fast"
    for name in ("_u", "_u_old", "_p", "_phi"):
        assert np.abs(_np(getattr(js, name))
                      - _np(getattr(s, name))).max() <= ATOL_SOLVER, name
    rj = np.array([_np(r["residuals"]) for r in js.monitor.records
                   if r["kind"] == "linear_solve"])
    rt = np.array([_np(r["residuals"]) for r in s.monitor.records
                   if r["kind"] == "linear_solve"])
    assert rj.shape == rt.shape == (5, 3)
    assert np.abs(rj - rt).max() <= ATOL_SOLVER


def test_3d_duct_holds_its_boundary_data():
    """The inflow profile on the inlet, no slip on the plates and no
    normal flux (u_z = 0) on the side walls, after 5 steps."""
    _, s = _duct_pair()
    space = s.space
    u, _ = space.split(s.solution.numpy())
    x = space.u_coords
    inlet = x[:, 0] < 1e-12
    np.testing.assert_allclose(u[inlet], setups.duct_profile(x[inlet]),
                               atol=1e-12)
    plates = (x[:, 1] < 1e-12) | (x[:, 1] > 1 - 1e-12)
    assert np.abs(u[plates]).max() < 1e-12
    sides = (x[:, 2] < 1e-12) | (x[:, 2] > 1 - 1e-12)
    assert np.abs(u[sides, 2]).max() < 1e-12


def _couette(x):
    return np.stack([x[:, 1], np.zeros(len(x)), np.zeros(len(x))], axis=1)


def test_3d_couette_stationary_exact_and_matches_jax():
    """``tests/test_3d_solver.py``'s Couette flow in a cube: u = (y, 0, 0)
    lies in the P2 space and solves Navier-Stokes exactly."""
    faces = (M.left, M.right, M.bottom, M.top, M.back, M.front)
    bcs = tuple((VelocityBCType.function, f.value, _couette) for f in faces)
    coeffs = {"convective_term": 1.0, "viscous_term": 0.5,
              "pressure_term": 1.0, "coriolis_term": None,
              "euler_term": None, "body_force_term": None}
    jmesh, jmarkers = jax_hyper_cube(3, 3)
    js = JaxStationary(jmesh, jmarkers)
    js.set_boundary_conditions(_jax_bcs(bcs))
    js.set_equation_coefficients(coeffs)
    js.solve()
    mesh, markers = hyper_cube(3, 3)
    s = StationarySolver(mesh, markers, device="cpu")
    s.set_boundary_conditions(bcs)
    s.set_equation_coefficients(coeffs)
    s.solve()
    u, p = s.space.split(s.solution.numpy())
    uj, _ = js.space.split(np.asarray(js.solution))
    assert np.abs(u - _couette(s.space.u_coords)).max() < 1e-10
    assert np.abs(p).max() < 1e-9
    assert np.abs(u - uj).max() < 1e-10


def _box_velocity(x):
    """Divergence-free, with non-zero convection."""
    return np.stack([np.cos(GAMMA * x[:, 1]), np.zeros(len(x)),
                     np.sin(GAMMA * x[:, 0])], axis=1)


def test_3d_periodic_box_spectral_matches_jax():
    """``demo/periodic_box_3d.py``'s problem at 4^3 through both
    packages' ProjectionSolver: the spectral path, 5 steps."""
    out = []
    for port in (False, True):
        mesh, markers = (hyper_cube if port else jax_hyper_cube)(3, 4)
        ts = (BDFTimeStepping if port else JaxBDF)(
            0.0, 1.0, desired_start_time_step=0.01)
        kw = dict(device="cpu") if port else {}
        s = (ProjectionSolver if port else JaxSolver)(
            mesh, markers, "standard", ts, **kw)
        ap = axis_periodic if port else jax_axis_periodic
        s.set_periodic_boundary_conditions(
            [ap(a) for a in range(3)], constrained_boundary_ids=tuple(
                f.value for f in (M.left, M.right, M.top, M.bottom,
                                  M.back, M.front)))
        PBC = PressureBCType if port else jax_bcs.PressureBCType
        s.set_boundary_conditions(((PBC.mean_value, None, 0.0),))
        s.set_equation_coefficients({"convective_term": 1.0,
                                     "viscous_term": 0.01,
                                     "pressure_term": 1.0})
        s.set_initial_conditions({"velocity": _box_velocity})
        for _ in range(5):
            ts.update_coefficients()
            s.solve()
            ts.advance_time()
            s.advance_time()
        out.append(s)
    js, s = out
    assert s._step_kind == js._step_kind == "spectral"
    assert np.abs(np.asarray(js.solution)
                  - s.solution.numpy()).max() <= ATOL_SOLVER
