"""Port parity: the monolithic BDF-2 shipped applications
(``demo/taylor_green_vortex.py``, ``demo/dfg_benchmark.py``) and the
convergence study's BDF mode, against ``navierstokes_tpu_torch/demo/``
and ``navierstokes_tpu_torch/convergence_test/``, on the CPU in float64,
both packages at the same small size.  The tolerances and the helpers are
those of ``tests/test_torch_demos.py`` (its docstring states them).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_demos import jax_script, rel, run_pair, solution
from test_torch_demos_transient import run_study, steps

BDF_TOL = 1e-9          # tests/test_torch_monolithic.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: under several pytest workers on a shared CPU,
    torch's intra-op threads oversubscribe the cores.  One thread per
    worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_taylor_green_vortex(tmp_path):
    from navierstokes_tpu_torch.demo import taylor_green_vortex

    jmod = jax_script("demo/taylor_green_vortex.py")
    jp, tp = run_pair(jmod.TaylorGreenVortex,
                      taylor_green_vortex.TaylorGreenVortex, tmp_path,
                      n_points=8, setup=steps(4))
    assert tp._time_stepping.step_number == 4
    for got, want in zip(solution(tp), solution(jp)):
        assert rel(got, want) <= BDF_TOL
    assert sorted(os.listdir(tmp_path / "torch" / "results"))


def test_dfg_benchmark(tmp_path):
    from navierstokes_tpu_torch.demo import dfg_benchmark

    jmod = jax_script("demo/dfg_benchmark.py")
    jp, tp = run_pair(jmod.DFGBenchmark2D2, dfg_benchmark.DFGBenchmark2D2,
                      tmp_path, end_time=1.0e6, n_max_steps=2,
                      resolution=0.5)
    for got, want in zip(solution(tp), solution(jp)):
        assert rel(got, want) <= BDF_TOL
    got, want = np.asarray(tp.coefficients), np.asarray(jp.coefficients)
    assert got.shape == want.shape == (2, 3)
    assert np.array_equal(got[:, 0], want[:, 0])
    assert rel(got[:, 1:], want[:, 1:]) <= BDF_TOL


def test_convergence_study_bdf(tmp_path, monkeypatch, capsys):
    run_study(tmp_path, monkeypatch, capsys, "bdf", 8, 2)
