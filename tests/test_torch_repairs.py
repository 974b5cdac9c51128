"""Port checks that no parity file holds: float32 on the CPU, names the
port does not have yet, and the pinned route-A block size.

* float32.  Every other ``tests/test_torch_*.py`` parity case runs in
  float64.  Here each ported path runs the port's plain versions in
  float32 on the CPU against the JAX package in float64 (in this process;
  the conftest keeps x64 on), for a few steps at 16^2 (the DFG path on the
  resolution-0.5 mesh): u and p agree to 1e-4 of their largest entry
  (measured gaps: banded 1.4e-6 / 1.7e-5, structured 4.8e-7 / 1.8e-6,
  cavity solver 8.9e-8 / 4.9e-7 on u / p; the DFG pressure is held to
  1e-3, see its test).
* Missing names raise ``NotImplementedError`` that names the ROADMAP item.
* ``csrc/band.cu`` pins route A's CTA size with a ``static_assert``, and
  ``pcg_plan`` sends two-plane systems that fit a cluster to route A.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import FastTaylorHood as JaxFast
from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.fem.spaces import axis_periodic as jax_axis_periodic
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_build_step
from navierstokes_tpu.structured import grid as jgrid
from navierstokes_tpu.structured import spectral as jspec
from navierstokes_tpu.timestepping import BDFTimeStepping as JaxBDF
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.assembly import cuda_band
from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
from navierstokes_tpu_torch.assembly.operators import MixedOperator
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu_torch.linalg import krylov
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.parallel import sharded
from navierstokes_tpu_torch.solvers import ProjectionSolver
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.structured import (PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.timestepping import BDFTimeStepping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4
ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]
G = 2.0 * np.pi


def _close32(got, want):
    got = got.double().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def _tg(x):
    return np.stack([np.cos(G * x[:, 0]) * np.sin(G * x[:, 1]),
                     -np.sin(G * x[:, 0]) * np.cos(G * x[:, 1])], axis=1)


def test_f32_banded_raw_step():
    n = 16
    jm, _ = jax_hyper_cube(2, n)
    jf = JaxFast(JaxSpace(jm, periodic=[jax_axis_periodic(0),
                                        jax_axis_periodic(1)]))
    space, u0, p0 = setups.taylor_green_setup(n)
    tf = FastTaylorHood(space, dtype=torch.float32, device="cpu")
    kw = dict(visc=0.01, dt=1e-3, cg_iters=(10, 60, 6))
    step_j, step_t = jax_build_step(jf, **kw), build_planar_projection_step(
        tf, **kw)
    uj = jf.permute_velocity(jnp.asarray(u0.T))
    pj = jf.permute_pressure(jnp.asarray(p0))
    ut = torch.tensor(np.asarray(uj), dtype=torch.float32)
    pt = torch.tensor(np.asarray(pj), dtype=torch.float32)
    sj, st = [uj, uj, pj, jnp.zeros_like(pj)], [ut, ut, pt,
                                                 torch.zeros_like(pt)]
    for i in range(4):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        u, p, phi = step_j(*sj, jnp.asarray(a), jnp.asarray(e))
        sj = [u, sj[0], p, phi]
        u, p, phi = step_t(*st, a, e)
        assert u.dtype == torch.float32
        st = [u, st[0], p, phi]
    _close32(st[0], sj[0])
    _close32(st[2], sj[2])


def test_f32_structured_step():
    n = 16
    jm, _ = jax_hyper_cube(2, n)
    jsg = jgrid.PeriodicStructuredTH(JaxSpace(
        jm, periodic=[jax_axis_periodic(0), jax_axis_periodic(1)]))
    tm, _ = hyper_cube(2, n)
    space = TaylorHoodSpace(tm, periodic=[axis_periodic(0),
                                          axis_periodic(1)])
    sg = PeriodicStructuredTH(space)
    u0 = space.interpolate_velocity(_tg).reshape(-1)
    p0 = np.zeros(space.n_pnodes)
    js, ji, jr = jspec.build_spectral_projection_step(
        jsg, visc=0.01, dt=1e-2, dtype=jnp.float64)
    ts_, ti, tr = build_spectral_projection_step(
        sg, visc=0.01, dt=1e-2, dtype=torch.float32, device="cpu")
    sj, st = ji(u0, u0, p0), ti(u0, u0, p0)
    for i in range(4):
        a, e = ALPHAS[min(i, 1)], ETAS[min(i, 1)]
        sj = js(sj, tuple(jnp.asarray(v) for v in a),
                tuple(jnp.asarray(v) for v in e))
        st = ts_(st, a, e)
    (uj, pj), (ut, pt) = jr(sj), tr(st)
    _close32(np.asarray(ut), uj)
    _close32(np.asarray(pt), pj)


def _jax_bcs(bcs):
    return tuple((getattr(getattr(jax_bcs, type(bc[0]).__name__),
                          bc[0].name),) + tuple(bc[1:]) for bc in bcs)


def test_f32_projection_solver_cavity():
    n, dt, steps = 16, 0.01, 4
    mesh, markers, bcs = setups.lid_driven_cavity_setup(n)
    coeffs = {"convective_term": 1.0, "viscous_term": 0.01,
              "pressure_term": 1.0}
    solvers = []
    for cls, bdf, (m, mk), kw in (
            (JaxSolver, JaxBDF, jax_hyper_cube(2, n), {}),
            (ProjectionSolver, BDFTimeStepping, (mesh, markers),
             {"device": "cpu", "dtype": torch.float32})):
        ts = bdf(0.0, 1.0, desired_start_time_step=dt)
        s = cls(m, mk, "standard", ts, cg_rtol=1e-6, **kw)
        s.set_boundary_conditions(bcs if cls is ProjectionSolver
                                  else _jax_bcs(bcs))
        s.set_equation_coefficients(coeffs)
        s.set_initial_conditions({"velocity": (0.0, 0.0)})
        for _ in range(steps):
            ts.update_coefficients()
            s.solve()
            ts.advance_time()
            s.advance_time()
        solvers.append(s)
    js, ts_ = solvers
    assert ts_.solution.dtype == torch.float32, ts_.solution.dtype
    assert ts_._step_kind == "fast"
    uj, pj = js.space.split(np.asarray(js.solution))
    ut, pt = ts_.space.split(ts_.solution)
    _close32(ut, uj)
    _close32(pt, pj)


def test_f32_dfg_problem():
    """The DFG application (resolution 0.5, impulsive start, 4 steps), the
    port in f32 with cg_rtol 1e-6 (the card's configuration: 1e-8 is below
    f32 roundoff) against the JAX demo in f64.  u and the force series to
    1e-4; p to 1e-3: the first steps' pressure solves on this graded mesh
    are ill-conditioned enough that f32 roundoff alone moves p by 3.1e-4
    of its largest entry (measured; 1.6e-3 with the solves run to their
    caps)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "demo"))
    import chip_smoke
    from dfg_benchmark_projection import DFGBenchmark2D2Projection

    kw = dict(end_time=1.0e6, n_max_steps=4, resolution=0.5, dt=0.01)
    jp = DFGBenchmark2D2Projection(None, **kw)
    jp._write_output = False
    tp = chip_smoke.DFGBenchmark2D2Projection(
        None, device="cpu", dtype=torch.float32,
        solver_options={"cg_rtol": 1e-6}, **kw)
    tp._write_output = False
    jp.solve_problem()
    tp.solve_problem()
    want = np.asarray(jp.materialize_coefficients())[:, 1:]
    got = np.asarray(tp.materialize_coefficients())[:, 1:]
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
    js, ts_ = jp._get_solver(), tp._get_solver()
    uj, pj = js.space.split(np.asarray(js.solution))
    ut, pt = ts_.space.split(ts_.solution)
    assert ut.dtype == torch.float32
    _close32(ut, uj)
    pt, pj = pt.double().numpy(), np.asarray(pj)
    assert np.abs(pt - pj).max() <= 10 * F32_TOL * np.abs(pj).max()


# ---------------------------------------------------------------------------
# names the port does not have yet
# ---------------------------------------------------------------------------

def test_missing_names_raise_with_their_item():
    """Names still missing raise naming their item; the Newton stack's
    (item 9b, 13) are ported and exported where the JAX package exports
    them."""
    from navierstokes_tpu_torch import linalg

    assert linalg.gmres is krylov.gmres and linalg.bicgstab is krylov.bicgstab
    space, *_ = setups.taylor_green_setup(4)
    op = MixedOperator(space, device="cpu")
    img = op.velocity_operator_image(torch.zeros(space.n_unodes, 2,
                                                 dtype=torch.float64),
                                     {"cc": 1.0, "cv": 1.0})
    assert img.shape == (space.n_unodes, 2) and not img.any()
    # one device is the cell-loop step's mesh; more is a shard mesh
    # (item 15), on the cards by default
    assert sharded.device_mesh(1, device="cpu") == [torch.device("cpu")]
    assert len(sharded.device_mesh(2, device="cpu")) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharded.device_mesh(2)


# ---------------------------------------------------------------------------
# the pinned route-A block size
# ---------------------------------------------------------------------------

def test_route_a_block_size_is_pinned():
    src = open(cuda_band.SOURCE).read()
    threads = int(re.search(r"constexpr int kClusterThreads = (\d+);",
                            src).group(1))
    assert threads == cuda_band.CLUSTER_THREADS == 512
    assert re.search(r"static_assert\(kClusterThreads == 512,", src)
    # two-plane systems that fit one cluster go to route A: the
    # configuration chip_smoke.py's kernels phase holds against the plain
    # version (4,096 rows, both dtypes, masked and not)
    for dtype in (torch.float32, torch.float64):
        for masked in (False, True):
            plan = cuda_band.pcg_plan(4096, 9, 2, dtype, masked)
            assert plan.route == "cluster"
            assert plan.ctas == cuda_band.CLUSTER_SIZE


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|navierstokes_tpu)"
                     r"(?![\w])", re.M)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No import statement of the port's package or of chip_smoke.py names
    jax or navierstokes_tpu (strings that cite the reference may)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT,
                                               "navierstokes_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        hits = _IMPORT.findall(open(path).read())
        assert not hits, f"{os.path.relpath(path, ROOT)} imports {hits}"


def test_new_modules_and_chip_smoke_import_no_jax():
    import subprocess

    code = ("import sys\n"
            "import chip_smoke\n"
            "import navierstokes_tpu_torch.problems.base\n"
            "import navierstokes_tpu_torch.problems.postprocess\n"
            "import navierstokes_tpu_torch.io.output\n"
            "import navierstokes_tpu_torch.utils.signal\n"
            "import navierstokes_tpu_torch.mesh.generators\n"
            "import navierstokes_tpu_torch.parallel.sharded\n"
            "import navierstokes_tpu_torch.parallel.sharded_mixed\n"
            "import navierstokes_tpu_torch.solvers.halo_step\n"
            "import navierstokes_tpu_torch.native\n"
            "import navierstokes_tpu_torch.demo.cavity_flow\n"
            "import navierstokes_tpu_torch.demo.backward_facing_step\n"
            "import navierstokes_tpu_torch.demo.blasius_flow\n"
            "import navierstokes_tpu_torch.demo.gravity_driven_flow\n"
            "import navierstokes_tpu_torch.demo.taylor_green_vortex\n"
            "import navierstokes_tpu_torch.demo.dfg_benchmark\n"
            "import navierstokes_tpu_torch.demo.dfg_benchmark_projection\n"
            "import navierstokes_tpu_torch.demo.periodic_box_3d\n"
            "import navierstokes_tpu_torch.convergence_test."
            "taylor_green_vortex\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules), 'jax imported'\n"
            "assert 'navierstokes_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
