"""Port parity: the linear algebra of the Newton stack (linalg/krylov.py,
linalg/fgmres.py, linalg/direct.py, linalg/newton.py,
linalg/block_precond.py) and the mixed-precision refinement.

CPU, float64 against the JAX package with x64.  BiCGStab and GMRES give
the JAX package's iterate after every iteration count (so both stop at
the same iteration) to 1e-10; the flexible GMRES variants the same
solution to 1e-10 with the same matvec counts; the direct solves, the
Newton loop and the PCD preconditioners their counterparts' results
to 1e-10 (a PCD-FGMRES solve stopped short of convergence to 1e-9).
``solve_refined`` run by the port in float32 reaches the float64 1e-10
residual contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.fem import bcs as jax_bcs
from navierstokes_tpu.linalg import block_precond as jbp
from navierstokes_tpu.linalg import direct as jdirect
from navierstokes_tpu.linalg import fgmres as jfg
from navierstokes_tpu.linalg import krylov as jkr
from navierstokes_tpu.linalg import newton as jnewton
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.solvers import StationarySolver as JaxStationary
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.assembly.host_reference import residual_f64
from navierstokes_tpu_torch.linalg import block_precond as tbp
from navierstokes_tpu_torch.linalg import direct as tdirect
from navierstokes_tpu_torch.linalg import fgmres as tfg
from navierstokes_tpu_torch.linalg import krylov as tkr
from navierstokes_tpu_torch.linalg import newton as tnewton
from navierstokes_tpu_torch.solvers import StationarySolver

TOL = 1e-10

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: under several pytest workers on a
    shared CPU, torch's intra-op threads oversubscribe the cores and slow
    them tenfold.  One thread per worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _system(n=48, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)
    A[0, 1] += 3.0
    return A, rng.standard_normal(n)


def _counted(fn):
    def wrapped(x):
        wrapped.calls += 1
        return fn(x)
    wrapped.calls = 0
    return wrapped


@pytest.mark.parametrize("name", ["bicgstab", "gmres"])
@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
def test_krylov_iterates_match(name, precond):
    """The iterate after k iterations (restart cycles for GMRES) and the
    tolerance-stopped solution equal the JAX package's."""
    A, b = _system()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jb, tb = jnp.asarray(b), torch.tensor(b)
    jM = tM = None
    if precond:
        jM = jkr.jacobi_preconditioner(jnp.diagonal(jA))
        tM = tkr.jacobi_preconditioner(torch.diagonal(tA))
    kw = dict(restart=8) if name == "gmres" else {}
    jfn, tfn = getattr(jkr, name), getattr(tkr, name)
    for k in (1, 2, 3, 5):
        jx, _ = jfn(jA, jb, tol=0.0, maxiter=k, M=jM, **kw)
        tx, _ = tfn(tA, tb, tol=0.0, maxiter=k, M=tM, **kw)
        assert _rel(tx, jx) <= TOL, k
    jx, jres = jfn(jA, jb, tol=1e-9, M=jM, **kw)
    tx, tres = tfn(lambda v: tA @ v, tb, tol=1e-9, M=tM, **kw)
    assert _rel(tx, jx) <= TOL
    assert float(tres) <= 1e-8 * np.linalg.norm(b)
    assert abs(float(tres) - float(jres)) <= 1e-10 * np.linalg.norm(b)


def test_gmres_takes_a_csr_and_cg_runs_fixed_sweeps():
    from navierstokes_tpu_torch.assembly import sparse as tsp

    A, b = _system(12, seed=3)
    rows, cols = np.nonzero(np.ones_like(A))
    pat = tsp.SparsityPattern(12, rows.astype(np.int32),
                              cols.astype(np.int32),
                              np.zeros((0, 1, 1), np.int32),
                              (np.arange(12) * 13).astype(np.int32))
    csr = tsp.CSRMatrix(tsp.DevicePattern(pat, "cpu"),
                        torch.tensor(A.reshape(-1)))
    x, _ = tkr.gmres(csr, torch.tensor(b), tol=1e-12, restart=12)
    assert np.abs(A @ x.numpy() - b).max() <= 1e-10
    S = A @ A.T
    jx, _ = jkr.cg(jnp.asarray(S), jnp.asarray(b), tol=0.0, maxiter=4)
    tx, _ = tkr.cg(torch.tensor(S), torch.tensor(b), tol=0.0, maxiter=4)
    assert _rel(tx, jx) <= TOL


def test_fgmres_host_and_device_match():
    A, b = _system(60, seed=1)
    D = np.diag(A).copy()
    jmv, tmv = _counted(lambda v: jnp.asarray(A) @ v), \
        _counted(lambda v: torch.tensor(A) @ v)
    jx, jres, jits = jfg.fgmres(jmv, jnp.asarray(b),
                                M_apply=lambda v: v / jnp.asarray(D),
                                tol=1e-11, restart=10, maxiter=200)
    tx, tres, tits = tfg.fgmres(tmv, torch.tensor(b),
                                M_apply=lambda v: v / torch.tensor(D),
                                tol=1e-11, restart=10, maxiter=200)
    assert tits == jits and tmv.calls == jmv.calls
    assert _rel(tx, jx) <= TOL and abs(tres - float(jres)) <= 1e-12

    jx, jres, jn = jfg.fgmres_device(
        lambda v: jnp.asarray(A) @ v, lambda v: v / jnp.asarray(D),
        jnp.asarray(b), restart=10, tol=1e-11, max_cycles=20)
    tmv = _counted(lambda v: torch.tensor(A) @ v)
    tx, tres, tn = tfg.fgmres_device(
        tmv, lambda v: v / torch.tensor(D), torch.tensor(b), restart=10,
        tol=1e-11, max_cycles=20)
    assert tn == int(jn) and tn > 10
    # one residual per cycle plus the restart's inner matvecs
    assert tmv.calls == tn + tn // 10 + 1
    assert _rel(tx, jx) <= TOL
    assert abs(tres - float(jres)) <= 1e-12 * np.linalg.norm(b)


def test_direct_solves_match():
    A, b = _system(30, seed=2)
    assert _rel(tdirect.dense_solve(torch.tensor(A), torch.tensor(b)),
                jdirect.dense_solve(jnp.asarray(A), jnp.asarray(b))) <= TOL
    from navierstokes_tpu.assembly import sparse as jsp
    from navierstokes_tpu_torch.assembly import sparse as tsp

    cells = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5]])
    rng = np.random.default_rng(4)
    elem = rng.standard_normal((4, 3, 3)) + 4.0 * np.eye(3)
    jp, tp = jsp.build_pattern(cells, 6), tsp.build_pattern(cells, 6)
    jcsr = jsp.CSRMatrix(jp, jsp.assemble_csr(jp, jnp.asarray(elem)))
    dpat = tsp.DevicePattern(tp, "cpu")
    tcsr = tsp.CSRMatrix(dpat, tsp.assemble_csr(dpat, torch.tensor(elem)))
    rhs = rng.standard_normal(6)
    got = tdirect.HostSparseLU(tcsr).solve(torch.tensor(rhs))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _rel(got, jdirect.HostSparseLU(jcsr).solve(jnp.asarray(rhs))) \
        <= TOL
    got32 = tdirect.HostSparseLU(tcsr).solve(torch.tensor(rhs).float())
    assert got32.dtype == torch.float32


def test_newton_solve_matches():
    """x^3 + x - c = 0 componentwise: the same iterates and counts."""
    c = np.linspace(0.5, 3.0, 5)

    def step(lib):
        return lambda x: -(x ** 3 + x - lib(c)) / (3 * x ** 2 + 1)

    jr = jnewton.newton_solve(lambda x: x ** 3 + x - jnp.asarray(c),
                              step(jnp.asarray), jnp.zeros(5), atol=1e-13)
    tr = tnewton.newton_solve(lambda x: x ** 3 + x - torch.tensor(c),
                              step(torch.tensor),
                              torch.zeros(5, dtype=torch.float64),
                              atol=1e-13)
    assert tr.iterations == jr.iterations and tr.converged
    assert _rel(tr.x, jr.x) <= TOL
    with pytest.raises(RuntimeError, match="did not converge"):
        tnewton.newton_solve(lambda x: x ** 3 + x - torch.tensor(c),
                             step(torch.tensor),
                             torch.zeros(5, dtype=torch.float64),
                             atol=1e-13, maxiter=2)


def _cavities(n=8, Re=100.0, linear_solver="pcd"):
    mesh, markers, bcs = setups.lid_driven_cavity_setup(n)
    jmesh, jmarkers = jax_hyper_cube(2, n)
    coeffs = {"convective_term": 1.0, "viscous_term": 1.0 / Re,
              "pressure_term": 1.0}
    t = StationarySolver(mesh, markers, linear_solver=linear_solver,
                         device="cpu")
    j = JaxStationary(jmesh, jmarkers, linear_solver=linear_solver)
    t.set_boundary_conditions(bcs)
    j.set_boundary_conditions(tuple(
        (getattr(getattr(jax_bcs, type(bc[0]).__name__), bc[0].name),)
        + tuple(bc[1:]) for bc in bcs))
    for s in (t, j):
        s.set_equation_coefficients(dict(coeffs))
        s._setup_problem()
    return t, j


def _state(space, seed=0):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal(space.n_dofs)


@pytest.mark.parametrize("grad_div", [0.0, 0.3], ids=["pcd", "grad_div"])
def test_matrix_free_pcd_matches(grad_div):
    """The preconditioner application and a whole solve (two restart
    cycles of 20, the second one driven from the host for grad-div) of
    the Newton system at a random state."""
    t, j = _cavities()
    x = _state(t.space)
    sc = t._scalars()
    tctx = tbp.MatrixFreePCD(t.operator, restart=20, grad_div=grad_div)
    jctx = jbp.MatrixFreePCD(j.operator, restart=20, grad_div=grad_div)
    tctx.host_cycles = jctx.host_cycles = grad_div > 0.0
    rhs = np.random.default_rng(1).standard_normal(t.space.n_dofs)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    _, tjvp = t.operator.linearize_at(tx, sc)
    _, jjvp = j.operator.linearize_at(jx, sc)
    u_q = t.operator.u_at_quad(t.space.split(tx)[0])
    ju_q = j.operator.u_at_quad(j.space.split(jx)[0])
    assert _rel(tctx._apply(torch.tensor(rhs), tjvp, u_q, sc),
                jctx._apply(jnp.asarray(rhs), jjvp, ju_q, sc)) <= TOL
    tdx, tres, tn = tctx.solve(tx, torch.tensor(rhs), sc, tol=1e-8,
                               max_cycles=2)
    jdx, jres, jn = jctx.solve(jx, jnp.asarray(rhs), sc, tol=1e-8,
                               max_cycles=2)
    assert tn == int(jn)
    # two cycles short of convergence: roundoff of the inner sweeps is
    # amplified to about 1.5e-10 here
    assert _rel(tdx, jdx) <= 1e-9
    assert abs(float(tres) - float(jres)) <= 1e-8 * np.linalg.norm(rhs)


def test_round_one_pcd_preconditioner_matches():
    """The first-generation PCD application.  Its BiCGStab sweep on the
    Picard velocity block amplifies roundoff about 1000-fold per
    iteration at this random state (4e-16, 8e-16, 2e-13, 7e-11 after 1-4
    iterations), so the sweep is held to two iterations."""
    t, j = _cavities(linear_solver="dense")
    x = _state(t.space, 2)
    sc = t._scalars()
    tJ = t.operator.jacobian_csr(torch.tensor(x), sc, picard=True)
    jJ = j.operator.jacobian_csr(jnp.asarray(x), sc, picard=True)
    kw = dict(visc=sc["cv"], accel0=0.0, f_iters=2, lp_iters=10,
              mp_iters=3)
    tp = tbp.PCDPreconditioner(t.operator, tJ.matvec,
                               u_current=t.space.split(torch.tensor(x))[0],
                               **kw)
    jp = jbp.PCDPreconditioner(j.operator, jJ.matvec,
                               u_current=j.space.split(jnp.asarray(x))[0],
                               **kw)
    r = np.random.default_rng(3).standard_normal(t.space.n_dofs)
    assert _rel(tp.apply(torch.tensor(r)), jp.apply(jnp.asarray(r))) <= TOL


def test_solve_refined_in_float32_reaches_the_f64_contract(monkeypatch):
    """The port's float32 PCD solve on the CPU, refined against the host
    float64 residual, reaches ||F||_2 <= 1e-10 (the JAX package's
    ``tests/test_mixed_precision.py`` contract)."""
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "30")
    mesh, markers, bcs = setups.lid_driven_cavity_setup(6)
    s = StationarySolver(mesh, markers, linear_solver="pcd", device="cpu",
                         dtype=torch.float32)
    s.set_boundary_conditions(bcs)
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 1.0 / 50.0,
                                 "pressure_term": 1.0})
    x = s.solve_refined(tol=1e-10, maxiter=25)
    assert s.solution.dtype == torch.float32 and x.dtype == np.float64
    r = residual_f64(s.space, x, s._bc_dofs_all,
                     s._bc_values().double().numpy(), s._scalars())
    assert np.linalg.norm(r) <= 1e-10
    rec = s.monitor.last("mixed_precision_refinement")
    assert rec["residual"] <= 1e-10
