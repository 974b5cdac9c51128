"""Port parity: the shipped applications (``demo/*.py`` against
``navierstokes_tpu_torch/demo/``).

Each demo class runs in the JAX package (its script under ``demo/``,
imported from its file, unedited) and in the port on the CPU in float64,
at the same small size, both writing into ``tmp_path``.  Where a demo's
size is fixed by the class, both packages' classes get the same
attribute overrides (fewer steps) before ``solve_problem``.  Tolerances,
those of the existing parity tests of the same solver, relative to the
largest entry of the JAX result:

* stationary (``StationaryProblem``, Picard->Newton, dense/host LU):
  the solution to 1e-9 as ``test_torch_stationary.py``, ||F|| <= 1e-10
  in both; the mass flux of the open cube to 1e-12 absolute (it is a
  sum of opening fluxes that cancel to roundoff);
* monolithic BDF-2 (``ImplicitBDFSolver``): 1e-9 as
  ``test_torch_monolithic.py``, the force series alike;
* projection (``ProjectionSolver``): 1e-9 as
  ``test_torch_projection_solver.py``; on the DFG mesh the pressure and
  the force series to 1e-11 of max|p| as ``test_torch_dfg_parity.py``;
  ``summarize`` equal to 1e-9 (its Strouhal number is a frequency bin,
  so exactly equal);
* the convergence study: every L2 error to 1e-9 relative.

``tests/test_torch_demos_transient.py`` holds the projection demos and
the study's projection mode, ``tests/test_torch_demos_bdf.py`` the BDF
demos and the study's BDF mode; this file the stationary demos and the
command lines.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: under several pytest workers on a shared CPU,
    torch's intra-op threads oversubscribe the cores.  One thread per
    worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jax_script(relpath):
    """The JAX package's application script ``relpath`` as a module."""
    name = "jax_" + relpath.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def solution(problem):
    """(u, p) of a problem's solver as host f64 arrays (either package)."""
    solver = problem._get_solver()
    x = solver.solution
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    u, p = solver.space.split(x)
    return np.asarray(u, np.float64), np.asarray(p, np.float64)


def run_pair(jcls, tcls, tmp_path, *args, setup=None, **kw):
    """Both packages' problems built alike, solved quietly in their own
    directories under ``tmp_path``."""
    pair = []
    for name, cls, extra in (("jax", jcls, {}),
                             ("torch", tcls, {"device": "cpu"})):
        main_dir = tmp_path / name
        main_dir.mkdir()
        problem = cls(*args, main_dir=str(main_dir), **kw, **extra)
        if setup is not None:
            setup(problem)
        problem.solve_problem()
        pair.append(problem)
    return pair


def nonlinear_residual(problem):
    records = [r for r in problem._get_solver().monitor.records
               if r["kind"] == "nonlinear_solve"]
    assert len(records) == 1, "the Reynolds continuation ran"
    return float(records[0]["residual"])


def assert_stationary_pair(jp, tp, tol=1e-9):
    ju, jpr = solution(jp)
    tu, tpr = solution(tp)
    assert rel(tu, ju) <= tol
    assert rel(tpr, jpr) <= tol
    assert nonlinear_residual(tp) <= 1e-10
    assert nonlinear_residual(jp) <= 1e-10


def test_cavity_flow(tmp_path):
    from navierstokes_tpu_torch.demo import cavity_flow

    jp, tp = run_pair(jax_script("demo/cavity_flow.py").CavityProblem,
                      cavity_flow.CavityProblem, tmp_path, 10)
    assert_stationary_pair(jp, tp)
    assert sorted(os.listdir(tmp_path / "torch" / "results"))


def test_backward_facing_step(tmp_path):
    from navierstokes_tpu_torch.demo import backward_facing_step

    jp, tp = run_pair(
        jax_script("demo/backward_facing_step.py").BackwardFacingStepProblem,
        backward_facing_step.BackwardFacingStepProblem, tmp_path)
    assert tp._mesh.n_cells == jp._mesh.n_cells
    assert_stationary_pair(jp, tp)


def test_blasius_flow(tmp_path):
    from navierstokes_tpu_torch.demo import blasius_flow

    jp, tp = run_pair(jax_script("demo/blasius_flow.py").BlasiusFlowProblem,
                      blasius_flow.BlasiusFlowProblem, tmp_path)
    assert_stationary_pair(jp, tp)


def jax_mass_flux(problem):
    """The JAX demo's printed total mass flux, recomputed unrounded."""
    from navierstokes_tpu.mesh.core import extract_all_boundary_markers

    solver = problem._get_solver()
    u = problem._get_velocity()
    flux = 0.0
    for bid in extract_all_boundary_markers(problem._mesh,
                                            problem._boundary_markers):
        fids = problem._boundary_markers.ids_with_value(bid)
        if len(fids):
            batch = solver.operator.facet_batch_device(
                solver.space.facet_batch(fids))
            flux += float(solver.operator.boundary_velocity_flux(batch, u))
    return flux


def test_gravity_driven_flow(tmp_path, capsys):
    from navierstokes_tpu_torch.demo import gravity_driven_flow

    jp, tp = run_pair(
        jax_script("demo/gravity_driven_flow.py").GravityDrivenFlowProblem,
        gravity_driven_flow.GravityDrivenFlowProblem, tmp_path, 40)
    assert_stationary_pair(jp, tp)
    assert abs(tp.mass_flux - jax_mass_flux(jp)) <= 1e-12
    assert abs(tp.mass_flux) <= 1e-10
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Value of the total mass flux")]
    assert len(lines) == 2
    assert os.path.exists(tmp_path / "torch" / "results"
                          / "OpenCube_BoundaryMarkers.vtu")


DEMO_MAINS = ("cavity_flow", "backward_facing_step", "blasius_flow",
              "gravity_driven_flow", "taylor_green_vortex", "dfg_benchmark",
              "dfg_benchmark_projection", "periodic_box_3d")


@pytest.mark.parametrize("name", DEMO_MAINS)
def test_main_raises_without_a_card(name, monkeypatch, tmp_path):
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"navierstokes_tpu_torch.demo.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
    assert not os.listdir(tmp_path)


def test_study_raises_without_a_card(monkeypatch, tmp_path):
    from navierstokes_tpu_torch.convergence_test import taylor_green_vortex

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taylor_green_vortex.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taylor_green_vortex.cli(["8", "2", "projection"])


def test_main_on_the_cpu_runs_in_float64(monkeypatch, tmp_path):
    from navierstokes_tpu_torch.demo import argument_parser, cavity_flow, \
        placement

    ap = argument_parser("x")
    for argv, projection, want in (
            (["--device", "cpu"], True, torch.float64),
            (["--device", "cpu"], False, torch.float64),
            (["--device", "cpu", "--dtype", "float32"], True,
             torch.float32)):
        got = placement(ap.parse_args(argv), projection)
        assert got["device"] == torch.device("cpu")
        assert got["dtype"] == want
        assert got["solver_options"] == (
            {"cg_rtol": 1e-6} if want == torch.float32 else {})
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cavity_flow, "CavityProblem",
                        _small(cavity_flow.CavityProblem, 6))
    problem = cavity_flow.main(["--device", "cpu"])
    solver = problem._get_solver()
    assert solver.solution.dtype == torch.float64
    assert solver.solution.device.type == "cpu"
    assert os.listdir(tmp_path / "results")


def _small(cls, n):
    class Small(cls):
        def __init__(self, n_points, main_dir=None, **kw):
            super().__init__(n, main_dir, **kw)

    return Small
