"""The port's tracing (``navierstokes_tpu_torch/utils/monitor.py``): spans
and counters in the registry, the set-up spans of the engines and the AMG
hierarchy, the step phases (null when nothing traces, profiler ranges
under a profiler, marks under ``device_marks``), and
``utils/graph.ChunkLoop.phase_ms`` on the CPU for the periodic planar,
masked AMG planar and spectral steps.  CPU, float64, 8^2 and 16^2."""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.linalg.amg import AMG, pressure_laplacian_scipy
from navierstokes_tpu_torch.setups import (lid_driven_cavity_setup,
                                           taylor_green_setup)
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.graph import ChunkLoop

ALPHA, ETA = (1.5, -2.0, 0.5), (2.0, -1.0)
PHASES = ("convection", "helmholtz", "poisson", "correction")
KINDS = ("periodic", "masked_amg", "spectral")

_steps = {}


@pytest.fixture(autouse=True)
def _fresh_registry():
    monitor.reset()
    yield
    monitor.reset()


def planar_periodic():
    space, u0, p0 = taylor_green_setup(8)
    fast = FastTaylorHood(space, dtype=torch.float64, device="cpu")
    step = build_planar_projection_step(fast, visc=0.01, dt=1e-3,
                                        cg_iters=(10, 60, 6))
    u = fast.permute_velocity(torch.tensor(u0.T))
    p = fast.permute_pressure(torch.tensor(p0 - p0.mean()))
    return step, (u, 0.99 * u, p, torch.zeros_like(p))


def planar_masked_amg():
    """The march cell's step kind: walls and a lid, the Poisson solve
    preconditioned by an AMG V-cycle (one level at 16^2)."""
    mesh, markers, bcs = lid_driven_cavity_setup(16)
    space = TaylorHoodSpace(mesh)
    vbc, _ = compile_dirichlet_bcs(
        space, markers, [bc for bc in bcs if bc[1] is not None], [])
    mask = np.zeros(space.n_velocity_dofs, bool)
    mask[np.asarray(vbc.dofs)] = True
    vals = np.zeros(space.n_velocity_dofs)
    vals[np.asarray(vbc.dofs)] = vbc.values()
    fast = FastTaylorHood(space, dtype=torch.float64, device="cpu")

    def planar(flat):
        return np.asarray(flat).reshape(space.n_unodes, 2).T[:, fast.permU]

    step = build_planar_projection_step(
        fast, visc=1e-3, dt=0.25 / 32, cg_iters=(18, 30, 10),
        vel_bc=(planar(mask), planar(vals)), poisson_precond="amg")
    rng = np.random.default_rng(3)
    u = torch.tensor(planar(np.where(mask, vals, 1e-3 * rng.standard_normal(
        space.n_velocity_dofs))))
    p = torch.zeros(space.n_pnodes, dtype=torch.float64)
    return step, (u, u, p, p)


def spectral():
    space, u0, p0 = taylor_green_setup(8)
    step, init_state, _ = build_spectral_projection_step(
        PeriodicStructuredTH(space), visc=0.01, dt=1e-3,
        dtype=torch.float64, device="cpu")
    flat = u0.reshape(-1)
    return step, init_state(flat, flat, p0)


def case(kind):
    """``(advance, state)``: one BDF-2 step as ``state -> state``."""
    if kind not in _steps:
        if kind == "spectral":
            step, state = spectral()

            def advance(s):
                return step(s, ALPHA, ETA)
        else:
            step, state = (planar_periodic if kind == "periodic"
                           else planar_masked_amg)()

            def advance(s):
                u, u_old, p, phi = s
                u_new, p_new, phi_new = step(u, u_old, p, phi, ALPHA, ETA)
                return (u_new, u, p_new, phi_new)
        _steps[kind] = (advance, state)
    return _steps[kind]


class _Owner:
    """What a build is for (held by a weak reference)."""


def test_spans_nest_and_add_up_by_owner():
    """A span counts once when nested in one of its own name; ``last``
    adds the records made in a row for one owner and starts anew for any
    other (or none); counters are dicts incremented in place."""
    a, b = _Owner(), _Owner()
    with monitor.span("x", owner=a) as outer:
        with monitor.span("x") as inner:
            with monitor.span("y"):
                pass
    assert inner.seconds <= outer.seconds
    stats = monitor.SPANS["x"]
    assert (stats.count, stats.total, stats.last) == \
        (1, outer.seconds, outer.seconds)
    assert monitor.SPANS["y"].count == 1
    with monitor.span("x", owner=a) as again:
        pass
    assert monitor.latest("x") == outer.seconds + again.seconds
    for owner in (b, None, None):
        with monitor.span("x", owner=owner) as other:
            pass
        assert monitor.latest("x") == other.seconds
    assert stats.count == 5 and monitor.latest("nothing") is None

    group = monitor.counters("test.group", ("a", "b"))
    group["a"] += 2
    assert monitor.counters("test.group", ("a", "b")) is group
    assert monitor.COUNTERS["test.group"] == {"a": 2, "b": 0}
    monitor.reset()
    assert group == {"a": 0, "b": 0} and not monitor.SPANS


def test_timed_region_is_a_span_with_a_timing_record():
    solver_monitor = monitor.SolverMonitor()
    with monitor.timed_region(solver_monitor, "setup_engine", n=3):
        pass
    record = solver_monitor.last("timing")
    assert record["label"] == "setup_engine" and record["n"] == 3
    assert record["seconds"] == monitor.latest("setup_engine")


def test_setup_spans_of_the_engines_and_the_hierarchy():
    """``setup.engine`` is the planar engine, or the spectral grid and its
    two operator sets, which add up into one build; ``setup.amg`` the
    hierarchy."""
    space, _, _ = taylor_green_setup(8)
    FastTaylorHood(space, dtype=torch.float64, device="cpu")
    planar = monitor.latest("setup.engine")
    assert monitor.SPANS["setup.engine"].count == 1 and planar > 0.0
    build_spectral_projection_step(PeriodicStructuredTH(space), visc=0.01,
                                   dt=1e-3, dtype=torch.float64,
                                   device="cpu")
    stats = monitor.SPANS["setup.engine"]
    assert stats.count == 4
    assert 0.0 < stats.last < stats.total
    assert stats.last == pytest.approx(stats.total - planar, rel=1e-12)
    assert "setup.amg" not in monitor.SPANS
    AMG(pressure_laplacian_scipy(space), device="cpu")
    assert monitor.SPANS["setup.amg"].count == 1


def test_phase_records_nothing_when_nothing_traces():
    null = monitor.phase("convection")
    assert monitor.phase("amg.vcycle") is null
    assert monitor.annotate("chunk.replay") is null
    advance, state = case("masked_amg")
    monitor.reset()
    advance(state)
    assert not monitor.SPANS


@pytest.mark.parametrize("kind", KINDS)
def test_marks_leave_the_step_bitwise_equal(kind):
    advance, state = case(kind)
    plain = advance(state)
    with monitor.device_marks("cpu") as marks:
        marked = advance(state)
    names = {name for name, *_ in marks.marks}
    assert names == set(PHASES) | ({"amg.vcycle"} if kind == "masked_amg"
                                   else set())
    for a, b in zip(pytree.tree_leaves(plain), pytree.tree_leaves(marked)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="already on"):
        with monitor.device_marks("cpu"), monitor.device_marks("cpu"):
            pass


def test_profiler_sees_spans_and_phases_as_annotations():
    from torch.profiler import ProfilerActivity, profile

    advance, state = case("masked_amg")
    space, _, _ = taylor_green_setup(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PeriodicStructuredTH(space)
        ChunkLoop(advance, state, 1, device="cpu").run()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"setup.engine", "chunk.replay", "amg.vcycle"} | set(PHASES) \
        <= names


@pytest.mark.parametrize("kind", KINDS)
def test_phase_ms_on_the_cpu(kind):
    """``phase_ms`` returns the four phases (and ``amg.vcycle`` with the
    AMG), which add up to the marked steps' time; the loop's state, its
    counts and the launch counters are left as they were."""
    advance, state = case(kind)
    loop = ChunkLoop(advance, state, 2, device="cpu")
    loop.run()
    before = pytree.tree_map(torch.clone, loop.state)
    cuda_band.LAUNCHES["circulant_apply"] += 7
    launches = dict(cuda_band.LAUNCHES)
    got = loop.phase_ms(replays=2, steps=2)
    want = set(PHASES) | ({"amg.vcycle"} if kind == "masked_amg" else set())
    assert set(got.phases) == want
    four = sum(got.phases[p] for p in PHASES)
    assert abs(four - got.step_ms) <= 0.1 * got.step_ms
    if kind == "masked_amg":
        assert 0.0 < got.phases["amg.vcycle"] < got.phases["poisson"]
    assert cuda_band.LAUNCHES == launches
    assert (loop.replays, loop.captured_launches, loop.nodes) == (1, None,
                                                                  None)
    for a, b in zip(pytree.tree_leaves(loop.state),
                    pytree.tree_leaves(before)):
        assert torch.equal(a, b)


def test_launch_counts_are_a_registry_group():
    """``cuda_band.LAUNCHES`` is the registry's ``cuda_band.launches``,
    zeroed in place by ``reset_launch_counts``; CPU tensors launch no
    kernel, and a CPU loop captures nothing."""
    assert monitor.COUNTERS["cuda_band.launches"] is cuda_band.LAUNCHES
    cuda_band.LAUNCHES["circulant_pcg"] += 1
    cuda_band.reset_launch_counts()
    assert cuda_band.LAUNCHES == {"circulant_apply": 0, "circulant_pcg": 0}
    advance, state = case("periodic")
    loop = ChunkLoop(advance, state, 2, device="cpu")
    loop.run()
    assert cuda_band.LAUNCHES == {"circulant_apply": 0, "circulant_pcg": 0}
    assert loop.captured_launches is None and loop.capture_seconds is None
