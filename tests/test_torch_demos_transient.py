"""Port parity: the transient shipped applications on the projection
path and the convergence study in projection mode (``demo/*.py``,
``convergence_test/taylor_green_vortex.py`` against
``navierstokes_tpu_torch/demo/`` and ``navierstokes_tpu_torch/
convergence_test/``), on the CPU in float64, both packages at the same
small size.  The tolerances and the helpers are those of
``tests/test_torch_demos.py`` (its docstring states them); the BDF demos
and the study's BDF mode are in ``tests/test_torch_demos_bdf.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_demos import jax_script, rel, run_pair, solution

PROJECTION_TOL = 1e-9   # tests/test_torch_projection_solver.py
DFG_TOL = 1e-11         # tests/test_torch_dfg_parity.py, of max|p|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: under several pytest workers on a shared CPU,
    torch's intra-op threads oversubscribe the cores.  One thread per
    worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def steps(n):
    def setup(problem):
        problem._n_max_steps = n
    return setup


@pytest.mark.parametrize("which", ["2D2", "2D3"])
def test_dfg_benchmark_projection(tmp_path, which):
    from navierstokes_tpu_torch.demo import dfg_benchmark_projection as tmod

    jmod = jax_script("demo/dfg_benchmark_projection.py")
    name = f"DFGBenchmark{which}Projection"
    n_steps, dt = 10, 0.005
    jp, tp = run_pair(getattr(jmod, name), getattr(tmod, name), tmp_path,
                      end_time=n_steps * dt, n_max_steps=n_steps,
                      resolution=1.0, dt=dt)
    (tu, tpr), (ju, jpr) = solution(tp), solution(jp)
    assert tp._get_solver()._step_kind == "fast"
    assert rel(tu, ju) <= PROJECTION_TOL
    assert rel(tpr, jpr) <= DFG_TOL
    got = np.asarray(tp.materialize_coefficients())
    want = np.asarray(jp.materialize_coefficients())
    assert got.shape == want.shape == (n_steps, 3)
    assert np.array_equal(got[:, 0], want[:, 0])
    assert rel(got[:, 1:], want[:, 1:]) <= DFG_TOL
    assert tp.materialize_coefficients() is tp.coefficients
    t_sum, j_sum = tmod.summarize(got, dt), jmod.summarize(want, dt)
    assert sorted(t_sum) == sorted(j_sum)
    assert t_sum["strouhal"] == j_sum["strouhal"]
    for key in ("cd_max", "cl_max"):
        assert abs(t_sum[key] - j_sum[key]) <= PROJECTION_TOL * abs(
            j_sum[key])


def test_periodic_box_3d(tmp_path):
    from navierstokes_tpu_torch.demo import periodic_box_3d

    jmod = jax_script("demo/periodic_box_3d.py")
    jp, tp = run_pair(jmod.PeriodicBox3D, periodic_box_3d.PeriodicBox3D,
                      tmp_path, n_points=4, setup=steps(5))
    assert tp._get_solver()._step_kind == "spectral"
    (tu, tpr), (ju, jpr) = solution(tp), solution(jp)
    assert rel(tu, ju) <= PROJECTION_TOL
    # the shear wave's pressure is zero: both are roundoff, held against u
    assert np.abs(tpr - jpr).max() <= PROJECTION_TOL * np.abs(ju).max()
    amp, expected = periodic_box_3d.amplitude(tp)
    assert amp == pytest.approx(np.abs(solution(jp)[0]).max(), rel=1e-12)
    assert expected == pytest.approx(np.exp(-(2 * np.pi) ** 2 * 0.05 / 100))


def test_convergence_study(tmp_path, monkeypatch, capsys):
    run_study(tmp_path, monkeypatch, capsys, "projection", 8, 3)


def run_study(tmp_path, monkeypatch, capsys, solver, n, levels):
    """Both packages' study at ``n``^2 over ``levels`` levels."""
    from navierstokes_tpu_torch.convergence_test import taylor_green_vortex

    jmod = jax_script("convergence_test/taylor_green_vortex.py")
    monkeypatch.chdir(tmp_path)
    want = jmod.main(n, levels, solver)
    got = taylor_green_vortex.main(n, levels, solver, device="cpu")
    assert got[0] == want[0] == [0.5 ** i for i in range(levels)]
    for g, w in zip(got[1:], want[1:]):
        assert rel(g, w) <= PROJECTION_TOL
    out = capsys.readouterr().out
    assert out.count("observed velocity orders:") == 2
    assert out.count("dt = ") == 2 * levels
