"""Port parity: the planar projection step (solvers/planar_step.py).

The port's step runs on ``planar_ops_from_numpy`` of the JAX engine, so
both steps see identical operators.  CPU, float64: u, p and phi agree to
1e-10 absolute after 4 steps and the residual norms to 1e-6 relative --
only the summation order differs (torch vs XLA, and the PCG's plain
version in place of ``_pcg``).  A residual that has converged to roundoff
has no digits to compare, so the residuals also get an absolute floor of
1e-13 (|b| is O(1e-2..1) here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import FastTaylorHood as JaxFast
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_build_step
from navierstokes_tpu_torch import cudalib
from navierstokes_tpu_torch.assembly.fastop import (planar_ops_from_numpy,
                                                    planar_ops_to_numpy)
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step

ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]


def _run(n, case):
    """4 steps of both packages on identical operators.

    ``periodic``: the bench configuration.  ``masked``: a strip of fixed
    velocity nodes (``vel_bc``), a strip of prescribed pressure nodes and
    the rotational update.  ``options``: ``masked`` plus a tolerance
    (``_pcg`` in place of the whole-solve kernel), a callable Poisson
    preconditioner, ``conv_coeff`` and the per-step ``bc_values``, ``k``
    and ``body_rhs``.
    """
    from __graft_entry__ import _taylor_green_setup

    space, u0, p0 = _taylor_green_setup(n)
    jf = JaxFast(space)
    ops = planar_ops_from_numpy(planar_ops_to_numpy(jf), device="cpu")
    kw = dict(visc=0.01, dt=1e-3, cg_iters=(8, 20, 6), with_residuals=True)
    kw_j, kw_t, call_j, call_t = {}, {}, {}, {}
    rng = np.random.default_rng(4)
    if case in ("masked", "options"):
        v_mask = np.zeros((2, space.n_unodes), bool)
        v_mask[:, :3 * n] = True             # a strip of nodes, both comps
        v_vals = np.where(v_mask, rng.standard_normal(v_mask.shape), 0.0)
        p_mask = np.zeros(space.n_pnodes, bool)
        p_mask[:n] = True
        kw.update(pres_bc_mask=p_mask, rotational=True)
        kw_j["vel_bc"] = (jnp.asarray(v_mask), jnp.asarray(v_vals))
        kw_t["vel_bc"] = (v_mask, v_vals)
    if case == "options":
        kw.update(cg_rtol=1e-9, conv_coeff=0.7)
        inv_l = 1.0 / np.asarray(jf.ops.diag_l)
        inv_lj, inv_lt = jnp.asarray(inv_l), torch.tensor(inv_l)
        kw_j["poisson_precond"] = lambda r: inv_lj * r
        kw_t["poisson_precond"] = lambda r: inv_lt * r
        bc = np.where(v_mask, rng.standard_normal(v_mask.shape), 0.0)
        body = 1e-3 * rng.standard_normal(v_mask.shape)
        call_j = dict(bc_values=jnp.asarray(bc), k=jnp.asarray(1.1e-3),
                      body_rhs=jnp.asarray(body))
        call_t = dict(bc_values=torch.tensor(bc), k=1.1e-3,
                      body_rhs=torch.tensor(body))
    step_j = jax_build_step(jf, **kw, **kw_j)
    step_t = build_planar_projection_step(ops, **kw, **kw_t)

    uj = jf.permute_velocity(jnp.asarray(u0.T))
    pj = jf.permute_pressure(jnp.asarray(p0))
    ut, pt = torch.tensor(np.asarray(uj)), torch.tensor(np.asarray(pj))
    states = {"jax": [uj, uj, pj, jnp.zeros_like(pj)],
              "torch": [ut, ut, pt, torch.zeros_like(pt)]}
    res = {}
    for i in range(4):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        for name, step in (("jax", step_j), ("torch", step_t)):
            u, uo, p, phi = states[name]
            if name == "jax":
                a_, e_ = (tuple(jnp.asarray(v) for v in a),
                          tuple(jnp.asarray(v) for v in e))
            else:
                a_, e_ = a, e
            extra = call_j if name == "jax" else call_t
            un, p, phi, r = step(u, uo, p, phi, a_, e_, **extra)
            states[name] = [un, u, p, phi]
            res[name] = np.asarray(r)
    return states, res


@pytest.mark.parametrize("n,case", [(8, "periodic"), (16, "periodic"),
                                    (16, "masked"), (16, "options")])
def test_step_matches_jax(n, case):
    cudalib.reset_launch_counts()
    states, res = _run(n, case)
    for got, want in zip(states["torch"], states["jax"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(res["torch"], res["jax"], rtol=1e-6,
                               atol=1e-13)
    assert np.isfinite(states["torch"][0].numpy()).all()
    # CPU tensors: every band matvec and solve took the plain versions
    assert cudalib.launched() == {}


def test_amg_poisson_is_not_ported():
    """(The name dates from when ``poisson_precond="amg"`` raised.)  It
    builds a V-cycle now: on an engine the step takes the preconditioned,
    tolerance-controlled ``_pcg`` and converges the Poisson solve in a few
    iterations; a bare ``PlanarOps`` bundle, which carries no space to
    build the hierarchy from, is refused."""
    from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
    from navierstokes_tpu_torch.setups import taylor_green_setup

    space, u0, p0 = taylor_green_setup(8)
    fast = FastTaylorHood(space, device="cpu")
    step = build_planar_projection_step(
        fast, visc=0.01, dt=1e-3, cg_iters=(20, 12, 10), cg_rtol=1e-10,
        with_residuals=True, poisson_precond="amg")
    assert callable(step.static["p_precond"])
    u = fast.permute_velocity(torch.tensor(u0.T))
    p = fast.permute_pressure(torch.tensor(p0))
    _, _, _, res = step(u, u, p, torch.zeros_like(p), ALPHAS[0], ETAS[0])
    # stopped by the tolerance (1e-10 |b|) inside the 12 iterations
    assert float(res[1]) < 1e-8
    assert cudalib.launched() == {}
    with pytest.raises(TypeError, match="engine"):
        build_planar_projection_step(fast.ops, visc=0.01, dt=1e-3,
                                     poisson_precond="amg")
