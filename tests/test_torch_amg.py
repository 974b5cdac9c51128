"""Port parity: the smoothed-aggregation AMG (linalg/amg.py), the CG of
linalg/krylov.py and ``planar_step.build_poisson_amg``.

CPU, float64.  The setup is the same host NumPy/SciPy code, so aggregates,
level sizes and the smoothing constants ``c`` are EQUAL.  One V-cycle and
``build_poisson_amg(...).apply`` agree to 1e-11 absolute on unit-normal
right-hand sides (summation order: gather tables against XLA segment
sums), an AMG-preconditioned solve to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import FastTaylorHood as JaxFast
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.linalg import amg as jamg
from navierstokes_tpu.linalg.krylov import cg as jax_cg
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.solvers.planar_step import \
    build_poisson_amg as jax_build_poisson_amg
from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.linalg import amg as tamg
from navierstokes_tpu_torch.linalg.krylov import cg
from navierstokes_tpu_torch.mesh import hyper_cube
from navierstokes_tpu_torch.solvers.planar_step import build_poisson_amg

ATOL = 1e-11
N = 20

_SPACES = {}


def _spaces():
    if not _SPACES:
        _SPACES["j"] = JaxSpace(jax_hyper_cube(2, N)[0])
        _SPACES["t"] = TaylorHoodSpace(hyper_cube(2, N)[0])
    return _SPACES["j"], _SPACES["t"]


def _matrices(kind):
    js, ts = _spaces()
    if kind == "dirichlet":
        dofs = np.where(np.abs(ts.p_coords[:, 0]) < 1e-12)[0]
        return (jamg.pressure_laplacian_scipy(js, dirichlet_dofs=dofs),
                tamg.pressure_laplacian_scipy(ts, dirichlet_dofs=dofs))
    if kind == "shifted":
        return (jamg.pressure_laplacian_scipy(js, mass_shift=0.3),
                tamg.pressure_laplacian_scipy(ts, mass_shift=0.3))
    return (jamg.pressure_laplacian_scipy(js),
            tamg.pressure_laplacian_scipy(ts))


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("kind", ["enclosed", "dirichlet", "shifted"])
def test_host_matrices_equal(kind):
    ja, ta = _matrices(kind)
    assert _same_csr(ja, ta)


def test_other_host_assemblies_equal():
    js, ts = _spaces()
    assert _same_csr(jamg.pressure_mass_scipy(js),
                     tamg.pressure_mass_scipy(ts))
    dofs = np.array([0, 5, 7])
    assert _same_csr(
        jamg.velocity_stiffness_scipy(js, mass_shift=0.1,
                                      dirichlet_dofs=dofs),
        tamg.velocity_stiffness_scipy(ts, mass_shift=0.1,
                                      dirichlet_dofs=dofs))
    A = tamg.pressure_laplacian_scipy(ts)
    assert _same_csr(jamg.symmetric_dirichlet(A, dofs),
                     tamg.symmetric_dirichlet(A, dofs))
    agg_j, n_j = jamg._aggregate(A)
    agg_t, n_t = tamg._aggregate(A)
    assert n_j == n_t and np.array_equal(agg_j, agg_t)
    assert jamg._lambda_max_dinv_a(A) == tamg._lambda_max_dinv_a(A)


@pytest.mark.parametrize("kind,kw", [
    ("dirichlet", {}), ("shifted", {}), ("enclosed", {}),
    ("dirichlet", {"dense_level_cap": 0}),           # every level sparse
    ("dirichlet", {"coarse_size": 40, "pre_smooth": 2, "post_smooth": 2}),
], ids=["dirichlet", "shifted", "enclosed", "all-sparse", "deep"])
def test_hierarchy_equal_and_vcycle_matches(kind, kw):
    ja, ta = _matrices(kind)
    j, t = jamg.AMG(ja, **kw), tamg.AMG(ta, device="cpu", **kw)
    assert len(t.levels) == len(j.levels) >= 1
    for lj, lt in zip(j.levels, t.levels):
        assert lt["n_agg"] == lj["n_agg"] and lt["c"] == lj["c"]
        assert np.array_equal(lt["agg"].numpy(), np.asarray(lj["agg"]))
        assert np.array_equal(lt["dinv"].numpy(), np.asarray(lj["dinv"]))
        assert type(lt["A"]).__name__ == type(lj["A"]).__name__
    np.testing.assert_allclose(t.coarse_inv.numpy(),
                               np.asarray(j.coarse_inv), rtol=0, atol=1e-9)
    r = np.random.default_rng(1).standard_normal(ta.shape[0])
    if kind == "enclosed":
        r -= r.mean()
    np.testing.assert_allclose(t.apply(torch.tensor(r)).numpy(),
                               np.asarray(j.apply(jnp.asarray(r))), rtol=0,
                               atol=ATOL)
    x = t.apply(torch.tensor(r))
    assert torch.equal(x, t.apply(torch.tensor(r)))   # no atomics


def test_amg_solve_matches():
    ja, ta = _matrices("dirichlet")
    b = np.random.default_rng(2).standard_normal(ta.shape[0])
    xj, rj = jamg.AMG(ja).solve(jnp.asarray(b), tol=1e-12)
    xt, rt = tamg.AMG(ta, device="cpu").solve(torch.tensor(b), tol=1e-12)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    assert float(rt) < 1e-10 and float(rj) < 1e-10


@pytest.mark.parametrize("precond", [False, True])
def test_cg_stops_where_jax_cg_stops(precond):
    """Same loop and stopping rule as ``jax.scipy.sparse.linalg.cg``:
    tolerance, atol floor and iteration cap give the same iterates."""
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((40, 40))
    A = Q @ Q.T + 40.0 * np.eye(40)
    b = rng.standard_normal(40)
    dinv = 1.0 / np.diag(A)
    for kw in (dict(tol=1e-10), dict(tol=1e-30, maxiter=7),
               dict(tol=0.0, atol=1e-3)):
        Mj = (lambda v: jnp.asarray(dinv) * v) if precond else None
        Mt = (lambda v: torch.tensor(dinv) * v) if precond else None
        xj, rj = jax_cg(jnp.asarray(A), jnp.asarray(b), M=Mj, **kw)
        xt, rt = cg(torch.tensor(A), torch.tensor(b), M=Mt, **kw)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=1e-12)
        assert abs(float(rt) - float(rj)) <= 1e-12
    x0 = torch.tensor(rng.standard_normal(40))
    xt, _ = cg(lambda v: torch.tensor(A) @ v, torch.tensor(b), x0=x0,
               tol=1e-12)
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(A, b), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("masked", [False, True])
def test_build_poisson_amg_matches(masked):
    """The step's preconditioner: level 0 through the banded ``L`` in the
    engine's permuted numbering (tests/test_fastop.py:184)."""
    js, ts = _spaces()
    jf, tf = JaxFast(js), FastTaylorHood(ts, device="cpu")
    mask = None
    if masked:
        mask = np.zeros(ts.n_pnodes, bool)
        mask[np.abs(ts.p_coords[:, 0] - 1.0) < 1e-12] = True
        mask = mask[tf.permP]
    j, t = jax_build_poisson_amg(jf, mask), build_poisson_amg(tf, mask)
    assert [lv["n_agg"] for lv in t.levels] == \
        [lv["n_agg"] for lv in j.levels]
    r = np.random.default_rng(4).standard_normal(ts.n_pnodes)
    r = np.where(mask, 0.0, r) if masked else r - r.mean()
    np.testing.assert_allclose(t.apply(torch.tensor(r)).numpy(),
                               np.asarray(j.apply(jnp.asarray(r))), rtol=0,
                               atol=ATOL)
    with pytest.raises(TypeError, match="engine"):
        from navierstokes_tpu_torch.solvers.planar_step import \
            build_planar_projection_step

        build_planar_projection_step(tf.ops, visc=0.01, dt=0.01,
                                     poisson_precond="amg")
