"""Port parity: the derived fields of problems/postprocess.py.

CPU, float64, on the lid-driven cavity 16^2 and on the DFG cylinder mesh
at resolution 1 (isoparametric cells), with the same smooth velocity and
pressure fields on both sides.  Vorticity, its vertex average, the
cellwise pressure gradient and the CFL number differ only in summation
order: 1e-12 against the largest entry.  The stream potential is a CG
solve run to the same tolerance on both sides (``tol=1e-12`` relative to
the right-hand side); the two solutions then agree to 1e-9 of the
field's largest entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from navierstokes_tpu.assembly.operators import MixedOperator as JaxOp
from navierstokes_tpu.assembly.operators import \
    PressurePoissonOperator as JaxPoisson
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.linalg import krylov as jax_krylov
from navierstokes_tpu.mesh import channel_with_cylinder as jax_cwc
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.problems import postprocess as jpp
from navierstokes_tpu_torch.assembly.operators import (MixedOperator,
                                                       PressurePoissonOperator)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.linalg import krylov
from navierstokes_tpu_torch.mesh import channel_with_cylinder, hyper_cube
from navierstokes_tpu_torch.problems import postprocess as tpp

_CASES = {}


def _case(name):
    """(JAX operator, port operator, u, p, markers, dirichlet, neumann)."""
    if name not in _CASES:
        if name == "cavity":
            jm, _ = jax_hyper_cube(2, 16)
            tm, markers = hyper_cube(2, 16)
            dirichlet, neumann = [1, 2, 3], [4]
        else:
            jm, _, _ = jax_cwc(1.0)
            tm, markers, mmap = channel_with_cylinder(1.0)
            dirichlet = [mmap["cylinder"], mmap["upper wall"],
                         mmap["lower wall"]]
            neumann = [mmap["inlet"], mmap["outlet"]]
        jop = JaxOp(JaxSpace(jm))
        top = MixedOperator(TaylorHoodSpace(tm), device="cpu")
        x, y = top.space.u_coords.T
        u = np.stack([np.sin(1.3 * x) * np.cos(2.1 * y) + 0.5 * y,
                      np.cos(0.7 * x + y) - 0.2 * x], axis=1)
        xp, yp = top.space.p_coords.T
        p = np.sin(0.9 * xp) * yp + 0.1 * xp * xp
        _CASES[name] = (jop, top, u, p, markers, dirichlet, neumann)
    return _CASES[name]


def _close(got, want, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("name", ["cavity", "dfg"])
def test_vorticity(name):
    jop, top, u, *_ = _case(name)
    _close(tpp.vorticity(top, torch.tensor(u)),
           jpp.vorticity(jop, jnp.asarray(u)))
    got = tpp.vorticity_vertex_field(top, torch.tensor(u))
    assert isinstance(got, np.ndarray)
    _close(got, jpp.vorticity_vertex_field(jop, jnp.asarray(u)))


@pytest.mark.parametrize("name", ["cavity", "dfg"])
def test_pressure_gradient(name):
    jop, top, _, p, *_ = _case(name)
    _close(tpp.pressure_gradient(top, torch.tensor(p)),
           jpp.pressure_gradient(jop, jnp.asarray(p)))


@pytest.mark.parametrize("name", ["cavity", "dfg"])
def test_cfl_number(name):
    jop, top, u, *_ = _case(name)
    for degree, dt in ((2, 0.01), (3, 0.37)):
        got = tpp.cfl_number(top, torch.tensor(u), dt, degree=degree)
        want = jpp.cfl_number(jop, jnp.asarray(u), dt, degree=degree)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["cavity", "dfg"])
def test_stream_potential(name):
    jop, top, u, _, markers, dirichlet, neumann = _case(name)
    got = tpp.stream_potential(top, torch.tensor(u), markers, dirichlet,
                               neumann, tol=1e-12)
    want = jpp.stream_potential(jop, jnp.asarray(u), markers, dirichlet,
                                neumann, tol=1e-12)
    _close(got, want, tol=1e-9)
    # zero on the no-slip walls
    pinned = np.concatenate([top.space.facet_pnodes(
        markers.ids_with_value(b)) for b in dirichlet])
    assert np.abs(got.numpy()[pinned]).max() == 0.0


@pytest.mark.parametrize("name", ["cavity", "dfg"])
def test_pressure_poisson_operator(name):
    jop, top, u, p, *_ = _case(name)
    jpo = JaxPoisson(jop.space)
    tpo = PressurePoissonOperator(top.space, device="cpu")
    pj, pt = jnp.asarray(p), torch.tensor(p)
    _close(tpo.stiffness_matvec(pt), jpo.stiffness_matvec(pj))
    _close(tpo.mass_matvec(pt), jpo.mass_matvec(pj))
    g = top.grad_u_at_quad(torch.tensor(u))[:, :, 0, :]
    _close(tpo.rhs_grad_dot_gradq(g),
           jpo.rhs_grad_dot_gradq(jnp.asarray(g.numpy())))
    v = g[..., 1]
    _close(tpo.rhs_scalar(v), jpo.rhs_scalar(jnp.asarray(v.numpy())))
    _close(tpo.convection_matvec(pt, g),
           jpo.convection_matvec(pj, jnp.asarray(g.numpy())))


def test_masked_spd_solve_and_jacobi():
    """The Dirichlet-masked solve on the cavity's P1 Laplacian, with and
    without the Jacobi preconditioner, against the JAX package's."""
    jop, top, _, p, markers, dirichlet, _ = _case("cavity")
    jpo = JaxPoisson(jop.space)
    tpo = PressurePoissonOperator(top.space, device="cpu")
    mask = np.zeros(top.space.n_pnodes, bool)
    for b in dirichlet:
        mask[top.space.facet_pnodes(markers.ids_with_value(b))] = True
    vals = np.where(mask, 0.3, 0.0)
    b = np.asarray(jpo.mass_matvec(jnp.asarray(p)))
    diag = np.asarray(jpo.mass_matvec(jnp.ones(len(p))))   # lumped mass
    for kw_j, kw_t in (({}, {}),
                       ({"diag": jnp.asarray(diag)},
                        {"diag": torch.tensor(diag)})):
        want, _ = jax_krylov.masked_spd_solve(
            jpo.stiffness_matvec, jnp.asarray(b), jnp.asarray(mask),
            jnp.asarray(vals), tol=1e-12, **kw_j)
        got, res = krylov.masked_spd_solve(
            tpo.stiffness_matvec, torch.tensor(b), mask, torch.tensor(vals),
            tol=1e-12, **kw_t)
        _close(got, want, tol=1e-9)
        assert np.abs(got.numpy()[mask] - 0.3).max() == 0.0
    inv = krylov.jacobi_preconditioner(torch.tensor([2.0, 0.0, -4.0]))
    assert inv(torch.ones(3)).tolist() == [0.5, 1.0, -0.25]
