"""Port parity: the product solver API as a whole (solvers/projection.py
with base.py, transient.py, the rim engine, the AMG and io/checkpoint.py).

Both packages' ``ProjectionSolver`` take the same problem through the
documented hooks and the manual loop; CPU, float64.  After 5 steps u, p
and phi agree to 1e-9 absolute (fields are O(1)) and the recorded residual
triples to 1e-9 absolute: only the summation order differs (torch against
XLA, the fixed-order segment sums against indexed adds), and both CG loops
stop at the same iteration.  A checkpoint written by either package
resumes in the other on the same trajectory (1e-9).
"""

import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.io.checkpoint import load_checkpoint as jax_load
from navierstokes_tpu.io.checkpoint import save_checkpoint as jax_save
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu.timestepping import BDFTimeStepping as JaxBDF
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.assembly.fastop import AffineBand, CirculantBand
from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.fem.spaces import axis_periodic
from navierstokes_tpu_torch.io import load_checkpoint, save_checkpoint
from navierstokes_tpu_torch.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu_torch.solvers import ProjectionSolver
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

TOL = 1e-9
GAMMA = 2.0 * np.pi


def _jax_bcs(bcs):
    """The port's BC tuples with the JAX package's enums."""
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


def _pulsed_inlet(x, t=0.0):
    t = 0.0 if t is None else t
    return np.sin(np.pi * t) * setups.parabolic_inlet(x)


def _tg_velocity(x):
    return np.stack([np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
                     -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])],
                    axis=1)


def _tg_pressure(x):
    return -0.25 * (np.cos(2 * GAMMA * x[:, 0])
                    + np.cos(2 * GAMMA * x[:, 1]))


CASES = {
    # channel 20x4, time-dependent inflow, variable steps, AMG on a
    # Dirichlet-pinned Poisson
    "channel": dict(dts=[0.02, 0.02, 0.03, 0.025, 0.02], visc=0.1,
                    kw=dict(cg_iters=(60, 600, 30), cg_rtol=1e-10),
                    kind="fast"),
    # cavity 8x8, enclosed (mean-free Poisson) with the AMG defaults
    "cavity": dict(dts=[0.01] * 5, visc=0.01, kw=dict(cg_rtol=1e-10),
                   kind="fast"),
    # the same cavity with fixed iteration counts and no preconditioner:
    # every solve of the port is one whole-solve PCG call (its plain
    # version here), with the velocity mask and the mean-free Poisson
    "cavity_kernels": dict(dts=[0.01] * 5, visc=0.01,
                           kw=dict(cg_rtol=None, poisson_precond=None,
                                   cg_iters=(18, 60, 10)), kind="fast"),
    "tg_spectral": dict(dts=[5e-3] * 5, visc=0.01, kw={}, kind="spectral"),
    "tg_fast": dict(dts=[5e-3] * 5, visc=0.01,
                    kw=dict(prefer_spectral=False, cg_rtol=1e-10),
                    kind="fast"),
}


def _build(case, package):
    """A solver of ``package`` ("jax" or "torch") on the case's problem,
    with its time stepping."""
    c = CASES[case]
    port = package == "torch"
    if case == "channel":
        mesh, markers, bcs = setups.channel_setup(20, 4, inlet=_pulsed_inlet)
        if not port:
            mesh, markers = jax_hyper_rectangle((0.0, 0.0), (5.0, 1.0),
                                                (20, 4))
    elif case.startswith("cavity"):
        mesh, markers, bcs = setups.lid_driven_cavity_setup(8)
        if not port:
            mesh, markers = jax_hyper_cube(2, 8)
    else:
        mesh, markers = (hyper_cube if port else jax_hyper_cube)(2, 16)
        bcs = None
    ts = (BDFTimeStepping if port else JaxBDF)(
        0.0, 10.0, desired_start_time_step=c["dts"][0])
    kw = dict(c["kw"], device="cpu") if port else c["kw"]
    solver = (ProjectionSolver if port else JaxSolver)(
        mesh, markers, "standard", ts, **kw)
    if bcs is None:
        ap = axis_periodic if port else jax_axis_periodic
        solver.set_periodic_boundary_conditions(
            [ap(0), ap(1)], constrained_boundary_ids=(1, 2, 3, 4))
        PBC = PressureBCType if port else jax_bcs.PressureBCType
        solver.set_boundary_conditions(((PBC.mean_value, None, 0.0),))
        ic = {"velocity": _tg_velocity, "pressure": _tg_pressure}
    else:
        solver.set_boundary_conditions(bcs if port else _jax_bcs(bcs))
        ic = {"velocity": (0.0, 0.0)}
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": c["visc"],
         "pressure_term": 1.0})
    solver.set_initial_conditions(ic)
    return solver, ts


def _run(solver, ts, dts):
    for dt in dts:
        ts.set_desired_next_step_size(dt)
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _state(solver):
    return {name: _np(getattr(solver, name))
            for name in ("_u", "_u_old", "_u_old2", "_p", "_phi")}


def _residuals(solver):
    return np.array([_np(r["residuals"]) for r in solver.monitor.records
                     if r["kind"] == "linear_solve"])


_RUNS = {}


def _pair(case):
    """Both packages' solvers after the case's steps (built once)."""
    if case not in _RUNS:
        out = []
        for package in ("jax", "torch"):
            solver, ts = _build(case, package)
            _run(solver, ts, CASES[case]["dts"])
            out.append((solver, ts))
        _RUNS[case] = out
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_solver_matches_jax_solver(case):
    (js, jts), (s, ts) = _pair(case)
    assert s._step_kind == js._step_kind == CASES[case]["kind"]
    assert ts.current_time == jts.current_time
    a, b = _state(js), _state(s)
    for name in a:
        assert np.abs(a[name] - b[name]).max() <= TOL, name
    assert np.abs(np.asarray(js.solution)
                  - s.solution.numpy()).max() <= TOL
    if CASES[case]["kind"] == "fast":
        rj, rt = _residuals(js), _residuals(s)
        assert rj.shape == rt.shape == (5, 3)
        assert np.abs(rj - rt).max() <= TOL
        rec = s.monitor.last("linear_solve")
        assert isinstance(rec["residual"], float)        # read lazily
        assert rec["label"] == "projection-cg"


def test_engine_formats_on_walls_and_torus():
    """Wall-bounded boxes keep circulant square operators and take rim
    couplings; the torus with ``prefer_spectral=False`` takes stencil
    couplings and the strided convection."""
    for case in ("channel", "cavity"):
        fast = _pair(case)[1][0]._fast
        assert fast.structured and fast.conv_strided is None
        assert all(isinstance(op, CirculantBand)
                   for op in (fast.M, fast.K, fast.L))
        assert all(isinstance(op, AffineBand) for op in fast.G + fast.D)
    fast = _pair("tg_fast")[1][0]._fast
    assert fast.conv_strided is not None
    assert all(type(op).__name__ == "StencilCoupling"
               for op in fast.G + fast.D)


def test_channel_inflow_follows_the_boundary_data():
    s, ts = _pair("channel")[1]
    space = s.space
    u, _ = space.split(s.solution.numpy())
    inlet = np.nonzero(space.u_coords[:, 0] < 1e-12)[0]
    y = space.u_coords[inlet, 1]
    expected = np.sin(np.pi * ts.current_time) * y * (1 - y)
    assert np.abs(u[inlet, 0] - expected).max() < 1e-12


def test_boundary_reaction_force_matches_jax():
    (js, _), (s, _) = _pair("channel")
    for bndry_id in (HyperCubeBoundaryMarkers.bottom.value,
                     HyperCubeBoundaryMarkers.top.value):
        fj = np.asarray(js.boundary_reaction_force(bndry_id))
        ft = s.boundary_reaction_force(bndry_id)
        assert isinstance(ft, torch.Tensor) and ft.shape == (2,)
        assert np.abs(fj - ft.numpy()).max() <= TOL


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """3 variable steps, save in one package, load in the other's fresh
    solver, 2 more steps: the reader ends where the unbroken runs end."""
    dts = CASES["channel"]["dts"]
    reader = "torch" if writer == "jax" else "jax"
    save = {"jax": jax_save, "torch": save_checkpoint}[writer]
    load = {"jax": jax_load, "torch": load_checkpoint}[reader]
    w, wts = _build("channel", writer)
    _run(w, wts, dts[:3])
    path = str(tmp_path / "state.npz")
    save(path, w, wts)
    r, rts = _build("channel", reader)
    r._setup_problem()
    load(path, r, rts)
    assert rts.step_number == 3
    _run(r, rts, dts[3:])
    want = _state(_pair("channel")[0][0])
    got = _state(r)
    for name in want:
        assert np.abs(want[name] - got[name]).max() <= TOL, name


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Within the port a resumed run equals the unbroken one bit for bit."""
    dts = CASES["cavity"]["dts"]
    a, ats = _build("cavity", "torch")
    _run(a, ats, dts[:3])
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, a, ats)
    b, bts = _build("cavity", "torch")
    b._setup_problem()
    load_checkpoint(path, b, bts)
    _run(a, ats, dts[3:])
    _run(b, bts, dts[3:])
    for name, val in _state(a).items():
        assert np.array_equal(val, _state(b)[name]), name
    assert torch.equal(a.solution, b.solution)


def test_body_force_takes_the_banded_path():
    """A body force loads the banded step through ``mass_rhs`` (which the
    JAX ``MixedOperator`` lacks): a uniform force along a closed channel
    of no-slip walls drives a flow along it."""
    mesh, markers, bcs = setups.lid_driven_cavity_setup(8)
    no_slip = tuple((VelocityBCType.no_slip, bc[1], None)
                    for bc in bcs[:4]) + (bcs[4],)
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.01)
    s = ProjectionSolver(mesh, markers, "standard", ts, cg_rtol=1e-10,
                         device="cpu")
    s.set_boundary_conditions(no_slip)
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 0.1, "pressure_term": 1.0,
                                 "body_force_term": 1.0})
    s.set_body_force(lambda x: np.stack([np.sin(np.pi * x[:, 1]),
                                         np.zeros(len(x))], axis=1))
    s.set_initial_conditions({"velocity": (0.0, 0.0)})
    _run(s, ts, [0.01] * 3)
    assert s._step_kind == "fast" and s._body_rhs is not None
    u, _ = s.space.split(s.solution.numpy())
    assert np.isfinite(u).all() and u[:, 0].max() > 1e-3


def _tg_solver(conv=1.0, **kw):
    mesh, markers = hyper_cube(2, 8)
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=5e-3)
    s = ProjectionSolver(mesh, markers, "standard", ts, device="cpu", **kw)
    s.set_periodic_boundary_conditions(
        [axis_periodic(0), axis_periodic(1)],
        constrained_boundary_ids=(1, 2, 3, 4))
    s.set_boundary_conditions(((PressureBCType.mean_value, None, 0.0),))
    s.set_equation_coefficients({"convective_term": conv,
                                 "viscous_term": 0.01,
                                 "pressure_term": 1.0})
    s.set_initial_conditions({"velocity": _tg_velocity})
    return s, ts


def test_spectral_downgrade_is_narrow_and_visible(monkeypatch):
    """Only the structured detector's refusals downgrade to the banded
    step, with a warning and a monitor record; anything else propagates."""
    from navierstokes_tpu_torch.solvers import projection
    from navierstokes_tpu_torch.structured import NotStructured

    s, ts = _tg_solver(conv=0.5, cg_rtol=1e-10)
    with pytest.warns(RuntimeWarning, match="convective_term == 1"):
        _run(s, ts, [5e-3])
    assert s._step_kind == "fast"
    rec = s.monitor.last("spectral_fallback")
    assert rec["exc_type"] == "ValueError"

    def refuse(space):
        raise NotStructured("points are not on a uniform lattice")

    monkeypatch.setattr(projection, "PeriodicStructuredTH", refuse)
    s, ts = _tg_solver(cg_rtol=1e-10)
    with pytest.warns(RuntimeWarning, match="uniform lattice"):
        _run(s, ts, [5e-3])
    assert s._step_kind == "fast"
    assert s.monitor.last("spectral_fallback")["exc_type"] == "NotStructured"

    def broken(space):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(projection, "PeriodicStructuredTH", broken)
    s, ts = _tg_solver()
    with pytest.raises(RuntimeError, match="out of memory"):
        _run(s, ts, [5e-3])


def test_parts_left_out_raise_with_their_roadmap_item(monkeypatch):
    from navierstokes_tpu_torch.assembly.fastop import StructureError
    from navierstokes_tpu_torch.solvers import projection

    mesh, markers, bcs = setups.lid_driven_cavity_setup(4)
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.01)
    with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
        ProjectionSolver(mesh, markers, "standard", ts, device="cpu",
                         device_mesh=["cuda:0", "cuda:1"])
    # one device is no mesh to decompose over
    ProjectionSolver(mesh, markers, "standard", ts, device="cpu",
                     device_mesh=["cpu"])

    def no_format(*args, **kwargs):
        raise StructureError("window 9000 exceeds cap 6144")

    monkeypatch.setattr(projection, "FastTaylorHood", no_format)
    s = ProjectionSolver(mesh, markers, "standard", ts, device="cpu")
    s.set_boundary_conditions(bcs)
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 0.01,
                                 "pressure_term": 1.0})
    s.set_initial_conditions({"velocity": (0.0, 0.0)})
    with pytest.raises(NotImplementedError, match="ROADMAP item 14") as exc:
        _run(s, ts, [0.01])
    assert isinstance(exc.value.__cause__, StructureError)
    assert s.monitor.last("fastop_fallback")["reason"].startswith("window")


def test_solver_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    mesh, markers, _ = setups.lid_driven_cavity_setup(4)
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.01)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProjectionSolver(mesh, markers, "standard", ts)
    s = ProjectionSolver(mesh, markers, "standard", ts, device="cpu")
    assert s._device.type == "cpu" and s._dtype == torch.float64
    s._setup_function_spaces()
    assert s._resolved_linear_mode() == "dense"       # 187 DoFs
    # past the dense limit: what the JAX package picks on the CPU, and the
    # accelerator's choice on the card
    from navierstokes_tpu_torch.solvers.base import _auto_linear_mode

    assert _auto_linear_mode(10_000, torch.device("cpu")) == "host_lu"
    assert _auto_linear_mode(10_000, torch.device("cuda")) == "pcd"
