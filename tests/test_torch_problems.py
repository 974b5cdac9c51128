"""Port parity: the application layer (problems/base.py) as a user drives
it.

CPU, float64, both packages through their Problem classes:

* DFG 2D-2 on the projection path: the JAX package's demo class
  (``demo/dfg_benchmark_projection.py``) against the port's mirror of it
  (``chip_smoke.DFGBenchmark2D2Projection``) on a coarse mesh, 4 steps:
  the drag/lift series and the final solution agree to 1e-9.
* A lid-driven cavity ``InstationaryProblem`` at 16^2, 5 steps, CFL every
  step, vorticity in the output: the output files of both packages agree
  array by array (1e-9; the XDMF text byte for byte).
* A checkpoint written by the problem resumes on the same trajectory, bit
  for bit.
* ``StationaryProblem`` solves the cavity to the JAX package's solution.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.io import output as jax_output
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.problems import EquationCoefficientHandler as JaxCoeffs
from navierstokes_tpu.problems import InstationaryProblem as JaxProblem
from navierstokes_tpu.problems import \
    StationaryProblem as JaxStationaryProblem
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.io import load_checkpoint
from navierstokes_tpu_torch.problems import (EquationCoefficientHandler,
                                             InstationaryProblem,
                                             StationaryProblem)
from navierstokes_tpu_torch.solvers import ProjectionSolver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "demo"))

import chip_smoke  # noqa: E402
from dfg_benchmark_projection import \
    DFGBenchmark2D2Projection as JaxDFG  # noqa: E402

TOL = 1e-9


def _jax_bcs(bcs):
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


def test_dfg_problem_matches_the_demo(tmp_path):
    kw = dict(end_time=1.0e6, n_max_steps=4, resolution=0.5, dt=0.01)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "torch")
    jp = JaxDFG(str(tmp_path / "jax"), **kw)
    tp = chip_smoke.DFGBenchmark2D2Projection(str(tmp_path / "torch"),
                                              device="cpu", **kw)
    jp.solve_problem()
    tp.solve_problem()
    want = np.asarray(jp.materialize_coefficients())
    got = np.asarray(tp.materialize_coefficients())
    assert got.shape == want.shape == (4, 3)
    assert np.array_equal(got[:, 0], want[:, 0])
    assert np.abs(got[:, 1:] - want[:, 1:]).max() <= TOL
    assert np.abs(got[:, 1]).max() > 0.1        # the flow pushes
    js, ts = jp._get_solver(), tp._get_solver()
    assert ts._step_kind == "fast"
    assert np.abs(ts.solution.numpy() - np.asarray(js.solution)).max() \
        <= TOL
    # the start-time field output of both
    assert sorted(os.listdir(tmp_path / "jax" / "results")) \
        == sorted(os.listdir(tmp_path / "torch" / "results"))


class _JaxCavity(JaxProblem):
    def __init__(self, main_dir, n, n_steps, output_every):
        super().__init__(main_dir, start_time=0.0, end_time=1.0e6,
                         desired_start_time_step=0.25 / (2.0 * n),
                         n_max_steps=n_steps)
        self._problem_name = "cavity"
        self._n = n
        self._output_frequency = output_every
        self._postprocessing_frequency = output_every
        self.set_solver_class(JaxSolver)

    def setup_mesh(self):
        self._mesh, self._boundary_markers = jax_hyper_cube(2, self._n)

    def set_boundary_conditions(self):
        self._bcs = _jax_bcs(setups.lid_driven_cavity_setup(self._n)[2])

    def set_equation_coefficients(self):
        self._coefficient_handler = JaxCoeffs(Re=1000.0)

    def set_initial_conditions(self):
        self._initial_conditions = {"velocity": (0.0, 0.0)}

    def postprocess_solution(self):
        self._add_to_field_output(self._compute_vorticity())


def _vtu_arrays(path):
    """The DataArrays of an ASCII VTU file, by name, as float arrays."""
    text = open(path).read()
    out = {}
    for m in re.finditer(r"<DataArray([^>]*)>([^<]*)</DataArray>", text):
        name = re.search(r'Name="([^"]*)"', m.group(1))
        out[name.group(1) if name else "points"] = np.array(
            m.group(2).split(), float)
    return out


@pytest.mark.parametrize("fmt", ["xdmf", "pvd"])
def test_cavity_problem_output_matches(tmp_path, fmt, monkeypatch):
    if fmt == "pvd":
        monkeypatch.setattr(jax_output, "_HAVE_H5PY", False)
    n, steps, every = 16, 5, 2
    for who in ("jax", "torch"):
        os.makedirs(tmp_path / who)
    jp = _JaxCavity(str(tmp_path / "jax"), n, steps, every)
    tp = chip_smoke.CavityProblem(str(tmp_path / "torch"), n, steps, every,
                                  device="cpu")
    tp._output_format = fmt
    jp.solve_problem()
    tp.solve_problem()
    dj, dt = tmp_path / "jax" / "results", tmp_path / "torch" / "results"
    files = sorted(os.listdir(dt))
    assert files == sorted(os.listdir(dj))
    assert len(files) == (2 if fmt == "xdmf" else 1 + 1 + steps // every)
    if fmt == "xdmf":
        import h5py

        name = [f for f in files if f.endswith(".xdmf")][0]
        assert open(dj / name).read() == open(dt / name).read()
        h5 = name[:-5] + ".h5"
        with h5py.File(dj / h5) as a, h5py.File(dt / h5) as b:
            names = []
            a.visit(names.append)
            for key in names:
                if isinstance(a[key], h5py.Dataset):
                    assert np.abs(a[key][()] - b[key][()]).max() <= TOL, key
            assert "step2/vorticity" in b
    else:
        for name in files:
            if name.endswith(".pvd"):
                assert open(dj / name).read() == open(dt / name).read()
                continue
            a, b = _vtu_arrays(dj / name), _vtu_arrays(dt / name)
            assert a.keys() == b.keys()
            for key in a:
                assert np.abs(a[key] - b[key]).max() <= TOL, (name, key)
        assert "vorticity" in _vtu_arrays(dt / files[-1])
    js, ts = jp._get_solver(), tp._get_solver()
    assert np.abs(ts.solution.numpy() - np.asarray(js.solution)).max() <= TOL


def test_problem_checkpoint_resumes_bitwise(tmp_path):
    """The problem's checkpoint after 2 steps, loaded into a fresh problem
    through ``io.load_checkpoint``, continues as the unbroken run."""
    n = 8
    for who in ("a", "b", "c"):
        os.makedirs(tmp_path / who)
    a = chip_smoke.CavityProblem(str(tmp_path / "a"), n, 4, 0, device="cpu")
    a._write_output = False
    a.solve_problem()
    b = chip_smoke.CavityProblem(str(tmp_path / "b"), n, 2, 0, device="cpu")
    b._write_output = False
    b._checkpoint_frequency = 2
    b.solve_problem()
    path = tmp_path / "b" / "results" / "cavity_checkpoint.npz"
    assert int(np.load(path)["step_number"]) == 2

    class Resumed(ProjectionSolver):
        def set_initial_conditions(self, initial_conditions):
            super().set_initial_conditions(initial_conditions)
            load_checkpoint(str(path), self, self._time_stepping)

    c = chip_smoke.CavityProblem(str(tmp_path / "c"), n, 4, 0, device="cpu")
    c._write_output = False
    c.set_solver_class(Resumed)
    c.solve_problem()
    assert c._time_stepping.step_number == 4
    assert torch.equal(c._get_solver().solution, a._get_solver().solution)


class _Stationary(StationaryProblem):
    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._bcs = \
            setups.lid_driven_cavity_setup(4)

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=10.0)


def _mkdir(path):
    path.mkdir(parents=True, exist_ok=True)
    return path


class _JaxStationary(JaxStationaryProblem):
    def setup_mesh(self):
        self._mesh, self._boundary_markers = jax_hyper_cube(2, 4)
        self._bcs = _jax_bcs(setups.lid_driven_cavity_setup(4)[2])

    def set_equation_coefficients(self):
        self._coefficient_handler = JaxCoeffs(Re=10.0)


def test_stationary_problem_names_its_item(tmp_path):
    """(The name dates from when it raised naming ROADMAP item 14.)  The
    cavity 4x4 at Re 10 as a ``StationaryProblem`` solves to the JAX
    package's solution (dense LU on both sides)."""
    t = _Stationary(str(_mkdir(tmp_path / "t")), device="cpu")
    j = _JaxStationary(str(_mkdir(tmp_path / "j")))
    t._write_output = j._write_output = False
    t.solve_problem()
    j.solve_problem()
    got = t._get_solver().solution.numpy()
    want = np.asarray(j._get_solver().solution)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_problem_defaults_to_the_card(tmp_path):
    """Without ``device`` the solver is built on the card, so a machine
    without one refuses instead of running on the CPU."""
    p = chip_smoke.CavityProblem(str(tmp_path), 4, 1, 0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.solve_problem()


def test_solver_class_must_be_transient():
    p = InstationaryProblem()
    with pytest.raises(AssertionError):
        p.set_solver_class(dict)
