"""Port parity: the cell-sharded mixed residual and Jacobian
(parallel/sharded_mixed.py) and ``StationarySolver(device_mesh=...)``;
mirrors tests/test_sharded_mixed.py.

CPU, float64.  The JAX package shards its residual sweep over the
conftest's 8 virtual devices and ``jax.linearize``s it; the port shards
its residual and tangent sweeps over ``device_mesh(n, device="cpu")``.
The Jacobian action at 1, 2 and 8 shards agrees with the JAX package's to
1e-12 relative (Newton and Picard; the JAX Newton action over 8 devices
agrees with its unsharded one to 1e-12), the residual with the one-shard
operator's to 1e-12, a PCD-FGMRES Newton system solved through the sharded
operator with the JAX package's to 1e-10 in the same iteration count, and
a full Picard->Newton solve of a 6x6 cavity over 4 shards (restart cycles
of 30 in both packages, as in test_torch_stationary.py) with the one-shard
solve to 1e-10.  The JAX package's own full sharded solve is marked slow
and is not called here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.operators import MixedOperator as JaxMixed
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.linalg.block_precond import \
    MatrixFreePCD as JaxMatrixFreePCD
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.parallel.sharded import device_mesh as jax_device_mesh
from navierstokes_tpu.parallel.sharded_mixed import \
    ShardedMixedOperator as JaxShardedMixed
from navierstokes_tpu_torch import setups
from navierstokes_tpu_torch.assembly.operators import MixedOperator
from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.linalg.block_precond import MatrixFreePCD
from navierstokes_tpu_torch.parallel.sharded import device_mesh
from navierstokes_tpu_torch.parallel.sharded_mixed import ShardedMixedOperator
from navierstokes_tpu_torch.solvers import StationarySolver

SCALARS = {"cv": 1.0 / 100.0, "cc": 1.0, "cp": 1.0, "accel0": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(n):
    """(JAX operator, port operator, lid values) of the n x n cavity with
    its Dirichlet rows set; built once per n."""
    if n not in _SETUPS:
        mesh, markers, bcs = setups.lid_driven_cavity_setup(n)
        space = TaylorHoodSpace(mesh)
        vbc, _ = compile_dirichlet_bcs(space, markers, bcs[:4], [])
        op = MixedOperator(space, device="cpu")
        op.set_bc_dofs(np.asarray(vbc.dofs))
        jop = JaxMixed(JaxSpace(jax_hyper_cube(2, n)[0]))
        jop.set_bc_dofs(np.asarray(vbc.dofs))
        _SETUPS[n] = (jop, op, vbc)
    return _SETUPS[n]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


_JAX_JVP = {}


def _jax_jvps(x, v):
    """The JAX package's Jacobian actions on the 8x8 cavity: Newton and
    Picard unsharded, and Newton over 8 devices (each call of the sharded
    ``linearize`` traces anew: about 10 s); computed once."""
    if not _JAX_JVP:
        jop, _, _ = _setup(8)
        for picard in (False, True):
            _, f = jop.linearize_at(jnp.asarray(x), SCALARS, picard=picard)
            _JAX_JVP[picard] = np.asarray(f(jnp.asarray(v)))
        _, f8 = JaxShardedMixed(jop, jax_device_mesh(8)).linearize_at(
            jnp.asarray(x), SCALARS)
        _JAX_JVP["sharded"] = np.asarray(f8(jnp.asarray(v)))
    return _JAX_JVP


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_jvp_matches(n_shards):
    _, op, _ = _setup(8)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(op.space.n_dofs)
    v = rng.standard_normal(op.space.n_dofs)
    want = _jax_jvps(x, v)
    assert _rel(want["sharded"], want[False]) <= 1e-12
    sop = ShardedMixedOperator(op, device_mesh(n_shards, device="cpu"))
    assert sop.n_cells_padded % n_shards == 0
    for picard in (False, True):
        r, jvp = sop.linearize_at(torch.tensor(x), SCALARS, picard=picard)
        got = jvp(torch.tensor(v)).numpy()
        assert _rel(got, want[picard]) <= 1e-12
        r1, jvp1 = op.linearize_at(torch.tensor(x), SCALARS, picard=picard)
        assert _rel(r.numpy(), r1.numpy()) <= 1e-12
        assert _rel(got, jvp1(torch.tensor(v)).numpy()) <= 1e-12
        # identity rows at the Dirichlet dofs
        bc = op._bc_dofs_np
        assert np.array_equal(got[bc], v[bc])
    g = torch.tensor(rng.standard_normal(len(op._bc_dofs_np)))
    assert _rel(sop.residual(torch.tensor(x), g, SCALARS).numpy(),
                op.residual(torch.tensor(x), g, SCALARS).numpy()) <= 1e-12


def test_pcd_newton_system_through_sharded_operator(monkeypatch):
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "30")
    jop, op, vbc = _setup(6)
    vals = np.asarray(vbc.values())
    x0 = np.zeros(op.space.n_dofs)
    x0[np.asarray(vbc.dofs)] = vals
    rhs = -op.residual(torch.tensor(x0), torch.tensor(vals), SCALARS)
    sop = ShardedMixedOperator(op, device_mesh(8, device="cpu"))
    dx, res, its = MatrixFreePCD(sop, max_cycles=2).solve(
        torch.tensor(x0), rhs, SCALARS, tol=1e-10)
    # the JAX package's own test holds its sharded solve to its unsharded
    # one at 1e-10; the unsharded one is the reference here
    jdx, jres, jits = JaxMatrixFreePCD(jop, max_cycles=2).solve(
        jnp.asarray(x0), jnp.asarray(rhs.numpy()), SCALARS, tol=1e-10)
    assert its == jits and float(res) < 1e-9
    assert _rel(dx.numpy(), jdx) <= 1e-10


def _cavity(device_mesh_arg, **kw):
    mesh, markers, bcs = setups.lid_driven_cavity_setup(6)
    kw.setdefault("device", "cpu")
    s = StationarySolver(mesh, markers, "standard", tol=1e-10,
                         device_mesh=device_mesh_arg, **kw)
    s.set_boundary_conditions(bcs)
    s.set_equation_coefficients({"convective_term": 1.0,
                                 "viscous_term": 1.0 / 50.0,
                                 "pressure_term": 1.0})
    return s


def test_stationary_solver_device_mesh_full_solve(monkeypatch):
    """The product API: ``StationarySolver(device_mesh=...)`` wraps its
    operator, takes the PCD mode by default and converges the Picard ->
    Newton solve to the one-shard solution."""
    monkeypatch.setenv("NS_TPU_FGMRES_RESTART", "30")
    sharded = _cavity(device_mesh(4, device="cpu"))
    assert sharded._linear_solver == "pcd"
    sharded.solve()
    assert isinstance(sharded._operator, ShardedMixedOperator)
    assert len(sharded._operator.mesh) == 4
    one = _cavity(None, linear_solver="pcd")
    one.solve()
    rec = [[r for r in s.monitor.records if r["kind"] == "nonlinear_solve"]
           for s in (sharded, one)]
    assert rec[0][-1]["residual"] <= 1e-10
    assert rec[0][-1]["newton_iterations"] == rec[1][-1]["newton_iterations"]
    assert _rel(sharded.solution.numpy(), one.solution.numpy()) <= 1e-10
    # a plain list of devices is a mesh; the state lives on shard 0
    with pytest.raises(ValueError, match="shard 0"):
        _cavity(["cpu", "cpu"], device="meta")
