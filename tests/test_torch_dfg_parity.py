"""Port parity on the DFG 2D-2 mesh where the roundoff of two summation
orders is largest: the RCM order at the benchmark's resolution 3, and the
pressure of the projection application at resolution 1.

* The RCM order of the velocity stiffness graph at resolution 3 (33,504
  velocity nodes) and the window widths it gives the square operators are
  EQUAL in both packages (host NumPy/SciPy; no band is built).
* The DFG application (``chip_smoke.DFGBenchmark2D2Projection`` against
  ``demo/dfg_benchmark_projection.py``), f64, 10 steps.  From rest the
  impulsive start's pressure peak is orders of magnitude above the relaxed
  pressure of step 10, so the first steps' absolute roundoff gap is read
  against a small max|p|; from a checkpoint the port writes after 40 steps,
  both packages resume it.  Either way u, p and the forces agree to 1e-11
  of their largest entry (the card's ``dfg_parity`` phase holds the port's
  card run to its CPU run at 1e-12).  Run with ``-s`` to print the gaps.
"""

import contextlib
import io
import os
import sys

import numpy as np

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.io import load_checkpoint as jax_load_checkpoint
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cwc
from navierstokes_tpu.solvers import ProjectionSolver as JaxSolver
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import channel_with_cylinder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "demo"))

import chip_smoke  # noqa: E402
from dfg_benchmark_projection import \
    DFGBenchmark2D2Projection as JaxDFG  # noqa: E402

RES, DT, WARM, STEPS = 1.0, 0.005, 40, 10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rcm_windows(fo, space):
    """RCM order of the velocity stiffness graph and the padded window
    widths it gives K (velocity) and L (pressure, the induced order)."""
    cu, cp = np.asarray(space.cell_unodes), np.asarray(space.cell_pnodes)
    nu, np_ = space.n_unodes, space.n_pnodes
    em = fo.scalar_element_matrices(space)
    K = fo.assemble_csr(em["K2"], cu, cu, (nu, nu))
    L = fo.assemble_csr(em["L1"], cp, cp, (np_, np_))
    perm_u = np.asarray(fo.rcm_permutation(K))
    inv_u = np.empty_like(perm_u)
    inv_u[perm_u] = np.arange(nu)
    p2u = np.full(np_, -1)
    p2u[cp.ravel()] = cu[:, :cp.shape[1]].ravel()
    perm_p = np.argsort(inv_u[p2u], kind="stable")
    widths = []
    for A, perm in ((K, perm_u), (L, perm_p)):
        A = A.tocsr()[perm][:, perm].tocoo()
        n, rb = A.shape[0], jfo.RB
        rel = np.mod(A.col - (A.row // rb) * rb + n // 2, n) - n // 2
        W = int(rel.max() + max(-rel.min(), 0) + 1)
        widths.append(-(-W // rb) * rb)
    return perm_u, widths


def test_rcm_order_equal_at_resolution_3():
    jm, _, _ = jax_cwc(3.0)
    tm, _, _ = channel_with_cylinder(3.0)
    js, ts = JaxSpace(jm), TaylorHoodSpace(tm)
    assert ts.n_unodes == 33504
    pj, wj = _rcm_windows(jfo, js)
    pt, wt = _rcm_windows(tfo, ts)
    assert np.array_equal(pt, pj)
    assert wt == wj
    nblk = [-(-ts.n_unodes // jfo.RB), -(-ts.n_pnodes // jfo.RB)]
    print(f"\nresolution 3: W (K, L) = {wt}, f32 bytes of M/K and L/Mp "
          f"= {[b * jfo.RB * w * 4 for b, w in zip(nblk, wt)]}")


def _run_both(tmp_path, n_steps, resume=None):
    """Both packages' DFG application at RES for steps .. ``n_steps``,
    from rest or from the checkpoint ``resume``: (u, p, forces) pairs."""
    jp = JaxDFG(str(tmp_path), end_time=1.0e6, n_max_steps=n_steps,
                resolution=RES, dt=DT)
    jp._write_output = False
    if resume:
        class Resumed(JaxSolver):
            def set_initial_conditions(self, initial_conditions):
                super().set_initial_conditions(initial_conditions)
                jax_load_checkpoint(resume, self, self._time_stepping)

        jp.set_solver_class(Resumed)
    with contextlib.redirect_stdout(io.StringIO()):
        jp.solve_problem()
    js = jp._get_solver()
    uj, pj = js.space.split(np.asarray(js.solution))
    fj = np.asarray(jp.materialize_coefficients())
    ut, pt, ft, _ = chip_smoke.dfg_run("cpu", n_steps, resume=resume)
    return (ut.numpy(), np.asarray(uj)), (pt.numpy(), np.asarray(pj)), \
        (ft.numpy(), fj)


def test_dfg_from_rest_reads_the_pressure_peak(tmp_path):
    first = chip_smoke.dfg_run("cpu", 1)[1].numpy()
    u, p, f = _run_both(tmp_path, STEPS)
    peak, relaxed = np.abs(first).max(), np.abs(p[1]).max()
    gaps = [_rel(*u), _rel(*p), _rel(*f)]
    print(f"\nfrom rest: max|p| step 1 {peak:.6g}, step {STEPS} "
          f"{relaxed:.6g}; gaps u, p, forces {gaps}")
    assert peak > 100.0 * relaxed
    assert max(gaps) <= 1e-11


def test_dfg_from_a_warm_start_matches_the_demo(tmp_path):
    chip_smoke.dfg_run("cpu", WARM, checkpoint_dir=str(tmp_path))
    path = os.path.join(str(tmp_path), "results",
                        "DFGBenchmark2D2Projection_checkpoint.npz")
    u, p, f = _run_both(tmp_path, WARM + STEPS, resume=path)
    assert len(f[0]) == len(f[1]) == STEPS
    assert np.array_equal(f[0][:, 0], f[1][:, 0])
    gaps = [_rel(*u), _rel(*p), _rel(*f)]
    print(f"\nfrom step {WARM}: gaps u, p, forces {gaps}")
    assert max(gaps) <= 1e-11
