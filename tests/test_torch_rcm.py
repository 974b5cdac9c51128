"""Port parity: the RCM ordering on an unstructured mesh (assembly/
fastop.py, ROADMAP item 5a-RCM), on the DFG cylinder mesh at resolution 1.

Host assembly is the same NumPy/SciPy code on both sides (the same CSR,
the same ``reverse_cuthill_mckee``), so the permutations, each operator's
format and its band arrays are EQUAL.  The applies differ only in
summation order: 1e-12 against the largest entry of the result.  Five raw
steps of the planar projection step with the DFG boundary conditions
(parabolic inflow, no slip on the walls and the cylinder, zero pressure
at the outlet) agree to 1e-10 against the largest entry of each field
(the impulsive start makes p and phi O(100)).  The fixed-iteration case
runs few iterations: Jacobi-CG on this graded mesh's Poisson problem is so
ill-conditioned that 60 unconverged iterations amplify the roundoff of
either summation order to 1e-7 (measured), in either package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly import fastop as jfo
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cwc
from navierstokes_tpu.solvers.planar_step import \
    build_planar_projection_step as jax_build_step
from navierstokes_tpu_torch.assembly import fastop as tfo
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import channel_with_cylinder
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step

ALPHAS = [(1.0, -1.0, 0.0), (1.5, -2.0, 0.5)]
ETAS = [(1.0, 0.0), (2.0, -1.0)]
_ENGINES = {}


def _engines():
    if not _ENGINES:
        mesh, markers, mmap = jax_cwc(1.0)
        _ENGINES["jax"] = jfo.FastTaylorHood(JaxSpace(mesh))
        tmesh, tmarkers, _ = channel_with_cylinder(1.0)
        _ENGINES["torch"] = tfo.FastTaylorHood(TaylorHoodSpace(tmesh),
                                               device="cpu")
        _ENGINES["markers"] = (tmarkers, mmap)
    return _ENGINES["jax"], _ENGINES["torch"]


def _close(got, want, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale


def test_permutations_equal_and_rcm():
    jf, tf = _engines()
    assert np.array_equal(tf.permU, np.asarray(jf.permU))
    assert np.array_equal(tf.permP, np.asarray(jf.permP))
    lex = tfo.lex_permutation(tfo.node_coordinates(tf.space)[0])
    assert not np.array_equal(tf.permU, lex)
    # the pressure order is the one the velocity order induces on the
    # vertex nodes
    cu, cp = tf.space.cell_unodes, tf.space.cell_pnodes
    p2u = np.empty(tf.space.n_pnodes, np.int64)
    p2u[cp.ravel()] = cu[:, :3].ravel()
    assert np.all(np.diff(tf.invU[p2u][tf.permP]) > 0)


@pytest.mark.parametrize("name", ["M", "K", "L", "Mp", "G0", "G1", "D0",
                                  "D1"])
def test_operator_format_and_band_equal(name):
    jf, tf = _engines()
    d_j = tfo.planar_ops_to_numpy(jf)
    d_t = tfo.planar_ops_to_numpy(tf)
    if name[0] in "GD":
        a, b = d_j[name[0]][int(name[1])], d_t[name[0]][int(name[1])]
    else:
        a, b = d_j[name], d_t[name]
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    if name in ("M", "K"):
        assert a["format"] == "AffineBand"


@pytest.mark.parametrize("name", ["M", "K", "L", "Mp"])
def test_square_applies_and_diagonals(name):
    jf, tf = _engines()
    top, jop = getattr(tf, name), getattr(jf, name)
    n = top.n if hasattr(top, "n") else top.n_rows
    x = np.random.default_rng(1).standard_normal((2, n))
    _close(top.apply(torch.tensor(x)), jop.apply(jnp.asarray(x)))
    _close(top.diagonal(), jop.diagonal())


def test_coupling_applies_and_convection():
    jf, tf = _engines()
    rng = np.random.default_rng(2)
    nu, np_ = tf.space.n_unodes, tf.space.n_pnodes
    p = rng.standard_normal(np_)
    u = rng.standard_normal((2, nu))
    for d in range(2):
        _close(tf.G[d].apply(torch.tensor(p)), jf.G[d].apply(jnp.asarray(p)))
        _close(tf.D[d].apply(torch.tensor(u[d])),
               jf.D[d].apply(jnp.asarray(u[d])))
    assert tf.conv_strided is None
    _close(tfo.conv_apply(tf.ops, torch.tensor(u), 1.0),
           jfo.conv_apply(jf.ops, jnp.asarray(u), 1.0))


def _dfg_bcs(space, markers, mmap):
    """Planar (unpermuted) velocity mask and values, pressure mask."""
    vel = np.zeros((2, space.n_unodes), bool)
    vals = np.zeros((2, space.n_unodes))
    for name in ("inlet", "cylinder", "upper wall", "lower wall"):
        nodes = space.facet_unodes(markers.ids_with_value(mmap[name]))
        vel[:, nodes] = True
        if name == "inlet":
            s = space.u_coords[nodes, 1] / 4.1
            vals[0, nodes] = 6.0 * s * (1.0 - s)
    inlet = space.facet_unodes(markers.ids_with_value(mmap["inlet"]))
    vals[0, inlet] = 6.0 * (space.u_coords[inlet, 1] / 4.1) \
        * (1.0 - space.u_coords[inlet, 1] / 4.1)
    pres = np.zeros(space.n_pnodes, bool)
    pres[space.facet_pnodes(markers.ids_with_value(mmap["outlet"]))] = True
    return vel, vals, pres


@pytest.mark.parametrize("precond", [None, "amg"])
def test_raw_steps_with_dfg_bcs(precond):
    jf, tf = _engines()
    markers, mmap = _ENGINES["markers"]
    vel, vals, pres = _dfg_bcs(tf.space, markers, mmap)
    perm_u, perm_p = tf.permU, tf.permP
    v_mask, v_vals = vel[:, perm_u], vals[:, perm_u]
    p_mask = pres[perm_p]
    kw = dict(visc=0.01, dt=0.01, cg_iters=(10, 10, 5),
              pres_bc_mask=p_mask, with_residuals=True)
    if precond:
        kw.update(poisson_precond="amg", cg_rtol=1e-10,
                  cg_iters=(30, 60, 15))
    step_j = jax_build_step(jf, vel_bc=(jnp.asarray(v_mask),
                                        jnp.asarray(v_vals)), **kw)
    step_t = build_planar_projection_step(tf, vel_bc=(v_mask, v_vals), **kw)
    u0 = v_vals
    p0 = np.zeros(tf.space.n_pnodes)
    sj = [jnp.asarray(u0), jnp.asarray(u0), jnp.asarray(p0),
          jnp.asarray(p0)]
    st = [torch.tensor(u0), torch.tensor(u0), torch.tensor(p0),
          torch.tensor(p0)]
    for i in range(5):
        a, e = (ALPHAS[0], ETAS[0]) if i == 0 else (ALPHAS[1], ETAS[1])
        uj, pj, phij, _ = step_j(*sj, jnp.asarray(a), jnp.asarray(e))
        ut, pt, phit, _ = step_t(*st, a, e)
        sj = [uj, sj[0], pj, phij]
        st = [ut, st[0], pt, phit]
    for got, want in zip(st, sj):
        _close(got, want, tol=1e-10)
    # the flow has left the rest state and kept the wall values
    assert np.abs(st[0].numpy()).max() > 0.5
    assert np.abs(st[0].numpy()[v_mask] - v_vals[v_mask]).max() <= 1e-12
