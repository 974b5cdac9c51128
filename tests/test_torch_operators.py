"""Port parity: element kernels and ``MixedOperator`` (assembly/kernels.py,
assembly/operators.py), the forward subset the solver layer calls.

CPU, float64, a 6x4 rectangle (2D) and a 2^3 cube (3D), inputs from NumPy
seeds.  Pointwise evaluations, residuals, boundary integrals and
functionals agree with the JAX package to 1e-12 absolute (summation order
only); the L2 projections, which end in a CG solve to 1e-14, to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.assembly import kernels as jk
from navierstokes_tpu.assembly.operators import MixedOperator as JaxMixed
from navierstokes_tpu.assembly.operators import \
    VelocityOperator as JaxVelocityOperator
from navierstokes_tpu.fem import bcs as jbcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu_torch.assembly import kernels as tk
from navierstokes_tpu_torch.assembly import operators as tops
from navierstokes_tpu_torch.assembly.operators import MixedOperator
from navierstokes_tpu_torch.fem import bcs as tbcs
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import (HyperCubeBoundaryMarkers as M,
                                         hyper_cube, hyper_rectangle)

ATOL = 1e-12
ATOL_PROJECTION = 1e-10

_SPACES = {}


def _spaces(dim):
    if dim not in _SPACES:
        if dim == 2:
            args = ((0.0, 0.0), (2.0, 1.0), (6, 4))
            jm, tm = jax_hyper_rectangle(*args), hyper_rectangle(*args)
        else:
            jm, tm = jax_hyper_cube(3, 2), hyper_cube(3, 2)
        _SPACES[dim] = (JaxSpace(jm[0]), TaylorHoodSpace(tm[0]), tm[1])
    return _SPACES[dim]


def _operators(dim, conv="standard", visc="reduced", coriolis=False):
    js, ts, markers = _spaces(dim)
    return (JaxMixed(js, conv, visc, with_coriolis=coriolis),
            MixedOperator(ts, conv, visc, with_coriolis=coriolis,
                          device="cpu"), ts, markers)


def _fields(space, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((space.n_unodes, space.dim)),
            rng.standard_normal(space.n_pnodes))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("dim", [2, 3])
def test_quadrature_point_values_match(dim):
    jo, to, space, _ = _operators(dim)
    u, p = _fields(space)
    ut, pt, uj, pj = torch.tensor(u), torch.tensor(p), jnp.asarray(u), \
        jnp.asarray(p)
    _close(to.u_at_quad(ut), jo.u_at_quad(uj))
    _close(to.grad_u_at_quad(ut), jo.grad_u_at_quad(uj))
    _close(to.p_at_quad(pt), jo.p_at_quad(pj))
    _close(to.grad_p_at_quad(pt), jo.grad_p_at_quad(pj))
    _close(to.quad_coords(), jo.quad_coords())
    x = space.join(u, p)
    a, b = to.split(torch.tensor(x))
    assert torch.equal(a, ut) and torch.equal(b, pt)


FORMS = [("standard", "reduced"), ("rotational", "reduced"),
         ("divergence", "traction"), ("skew_symmetric", "traction")]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("conv,visc", FORMS)
def test_residual_matches(dim, conv, visc):
    """Masked and raw residuals, with a quadrature source, a traction
    contribution and the Coriolis term."""
    jo, to, space, _ = _operators(dim, conv, visc, coriolis=True)
    rng = np.random.default_rng(1)
    u, p = _fields(space, 1)
    x = space.join(u, p)
    bc = np.sort(rng.choice(space.n_dofs, 25, replace=False)).astype(np.int32)
    jo.set_bc_dofs(bc)
    to.set_bc_dofs(bc)
    assert np.array_equal(to.bc_dofs.numpy(), bc)
    g = rng.standard_normal(len(bc))
    src = rng.standard_normal(space.quad_coords().shape)
    extra = rng.standard_normal((space.n_unodes, dim))
    cor = 0.6 if dim == 2 else np.array([0.1, -0.2, 0.6])
    js = {"cc": 0.9, "cv": 0.05, "cp": 1.0, "accel0": 12.0,
          "cor": cor if dim == 2 else jnp.asarray(cor)}
    tsc = dict(js, cor=cor if dim == 2 else torch.tensor(cor))
    for mask in (True, False):
        rj = jo.residual(jnp.asarray(x), jnp.asarray(g), js,
                         jnp.asarray(src), jnp.asarray(extra),
                         mask_bcs=mask)
        rt = to.residual(torch.tensor(x), torch.tensor(g), tsc,
                         torch.tensor(src), torch.tensor(extra),
                         mask_bcs=mask)
        _close(rt, rj)
    # scalar source, no convection, no traction
    js0 = {"cc": None, "cv": 0.05, "cp": 1.0, "accel0": 0.0, "cor": js["cor"]}
    ts0 = dict(js0, cor=tsc["cor"])
    _close(to.residual(torch.tensor(x), torch.tensor(g), ts0),
           jo.residual(jnp.asarray(x), jnp.asarray(g), js0))


@pytest.mark.parametrize("conv,visc", FORMS)
def test_cell_residual_picard_matches(conv, visc):
    """The batched kernel against ``jax.vmap`` of the per-cell kernel in
    the Picard (frozen advection) form."""
    js, ts, _ = _spaces(2)
    cf, vf = jbcs.parse_convective_form(conv), jbcs.parse_viscous_form(visc)
    jfn = jk.make_cell_residual(js.N2, js.G2, js.N1, 2, cf, vf, False)
    t = torch.tensor
    tfn = tk.make_cell_residual(
        t(ts.N2), t(ts.G2), t(ts.N1), 2, tbcs.parse_convective_form(conv),
        tbcs.parse_viscous_form(visc), False)
    rng = np.random.default_rng(2)
    nc = len(ts.cell_unodes)
    u_c = rng.standard_normal((nc, 6, 2))
    uf_c = rng.standard_normal((nc, 6, 2))
    p_c = rng.standard_normal((nc, 3))
    src = rng.standard_normal((nc, ts.N2.shape[0], 2))
    W = ts.integration_weights()
    sc = {"cc": 1.1, "cv": 0.02, "cp": 1.0, "accel0": 3.0}
    want = jax.vmap(lambda a, b, c, Ji, Wc, s: jfn(a, b, c, Ji, Wc, s, sc,
                                                   True))(
        jnp.asarray(u_c), jnp.asarray(p_c), jnp.asarray(uf_c),
        jnp.asarray(js.Jinv_q), jnp.asarray(W), jnp.asarray(src))
    got = tfn(t(u_c), t(p_c), t(uf_c), t(ts.Jinv_q), t(W), t(src), sc, True)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_element_matrices_match():
    js, ts, _ = _spaces(2)
    t = torch.tensor
    W, Ji = ts.integration_weights(), ts.Jinv_q
    _close(tk.p1_stiffness_elements(t(ts.G1), t(Ji), t(W)),
           jk.p1_stiffness_elements(js.G1, jnp.asarray(Ji), jnp.asarray(W)))
    _close(tk.p1_mass_elements(t(ts.N1), t(W)),
           jk.p1_mass_elements(js.N1, jnp.asarray(W)))
    _close(tk.p2_mass_elements(t(ts.N2), t(W)),
           jk.p2_mass_elements(js.N2, jnp.asarray(W)))


@pytest.mark.parametrize("dim", [2, 3])
def test_boundary_integrals_match(dim):
    jo, to, space, markers = _operators(dim)
    js = _spaces(dim)[0]
    ids = markers.ids_with_value(M.right.value)
    jb = jo.facet_batch_device(js.facet_batch(ids))
    tb = to.facet_batch_device(space.facet_batch(ids))
    u, p = _fields(space, 3)
    t_q = np.random.default_rng(3).standard_normal(tb["x"].shape)
    _close(to.traction_residual(tb, torch.tensor(t_q)),
           jo.traction_residual(jb, jnp.asarray(t_q)))
    _close(to.boundary_velocity_flux(tb, torch.tensor(u)),
           jo.boundary_velocity_flux(jb, jnp.asarray(u)))
    _close(to.boundary_traction_force(tb, torch.tensor(u), torch.tensor(p),
                                      0.03),
           jo.boundary_traction_force(jb, jnp.asarray(u), jnp.asarray(p),
                                      0.03))


@pytest.mark.parametrize("dim", [2, 3])
def test_projections_and_functionals_match(dim):
    jo, to, space, _ = _operators(dim)
    u, p = _fields(space, 4)
    _close(to.project_velocity(values_at_unodes=u),
           jo.project_velocity(values_at_unodes=u), ATOL_PROJECTION)
    _close(to.project_pressure(values_at_pnodes=p),
           jo.project_pressure(values_at_pnodes=p), ATOL_PROJECTION)
    vq = np.random.default_rng(5).standard_normal(space.quad_coords().shape)
    _close(to.project_velocity(values_at_quad=torch.tensor(vq)),
           jo.project_velocity(values_at_quad=jnp.asarray(vq)),
           ATOL_PROJECTION)
    _close(to.project_pressure(values_at_quad=torch.tensor(vq[..., 0])),
           jo.project_pressure(values_at_quad=jnp.asarray(vq[..., 0])),
           ATOL_PROJECTION)
    # a nodal field is its own projection
    _close(to.project_velocity(values_at_unodes=u), u, ATOL_PROJECTION)
    ut, pt = torch.tensor(u), torch.tensor(p)
    assert to.domain_volume() == pytest.approx(jo.domain_volume(), abs=ATOL)
    _close(to.mean_pressure(pt), jo.mean_pressure(jnp.asarray(p)))
    exact_u = lambda x: np.stack([x[:, 0] ** 2] * dim, axis=1)
    exact_p = lambda x, t=None: x[:, 1] * (1.0 if t is None else t)
    assert to.l2_error_velocity(ut, exact_u) == pytest.approx(
        jo.l2_error_velocity(jnp.asarray(u), exact_u), abs=ATOL)
    assert to.l2_error_pressure(pt, exact_p, t=2.0) == pytest.approx(
        jo.l2_error_pressure(jnp.asarray(p), exact_p, t=2.0), abs=ATOL)
    assert to.divergence_l2(ut) == pytest.approx(
        jo.divergence_l2(jnp.asarray(u)), abs=ATOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_mass_rhs_matches_the_velocity_operator(dim):
    """``MixedOperator.mass_rhs`` computes what the JAX package's
    ``VelocityOperator.mass_rhs`` computes (its ``MixedOperator`` has no
    such method, so a body force on the banded path fails there)."""
    js, ts, _ = _spaces(dim)
    assert not hasattr(JaxMixed, "mass_rhs")
    to = MixedOperator(ts, device="cpu")
    f_q = np.random.default_rng(6).standard_normal(ts.quad_coords().shape)
    want = JaxVelocityOperator(js).mass_rhs(jnp.asarray(f_q))
    _close(to.mass_rhs(f_q), want)
    _close(to.mass_rhs(torch.tensor(f_q)), want)


def _state(op, seed):
    u, p = _fields(op.space, seed)
    return np.concatenate([u.reshape(-1), p])


_SCALARS = {"cc": 1.0, "cv": 0.2, "cp": 1.0, "accel0": 3.0}


@pytest.mark.parametrize("call", [
    lambda j, t, x: (j.linearize_at(jnp.asarray(x), _SCALARS)[1](
        jnp.asarray(x[::-1].copy())),
        t.linearize_at(torch.tensor(x), _SCALARS)[1](
            torch.tensor(x[::-1].copy()))),
    lambda j, t, x: (j.jacobian_csr(jnp.asarray(x), _SCALARS).values,
                     t.jacobian_csr(torch.tensor(x), _SCALARS).values),
    lambda j, t, x: (j.jacobian_dense(jnp.asarray(x), _SCALARS,
                                      picard=True),
                     t.jacobian_dense(torch.tensor(x), _SCALARS,
                                      picard=True)),
    lambda j, t, x: (j.velocity_jacobi_diags()[1],
                     t.velocity_jacobi_diags()[1]),
    lambda j, t, x: (
        JaxVelocityOperator(j.space).residual(
            jnp.asarray(x[:j.space.n_velocity_dofs]), jnp.zeros(0),
            _SCALARS, jnp.asarray(x[j.space.n_velocity_dofs:])),
        tops.VelocityOperator(t.space, device="cpu").residual(
            torch.tensor(x[:t.space.n_velocity_dofs]), torch.zeros(0),
            _SCALARS, torch.tensor(x[t.space.n_velocity_dofs:]))),
    lambda j, t, x: (
        _jax_poisson(j.space).convection_matvec(
            jnp.asarray(x[j.space.n_velocity_dofs:]),
            j.u_at_quad(jnp.asarray(x[:j.space.n_velocity_dofs]).reshape(
                -1, 2))),
        tops.PressurePoissonOperator(t.space, device="cpu")
        .convection_matvec(torch.tensor(x[t.space.n_velocity_dofs:]),
                           t.u_at_quad(torch.tensor(
                               x[:t.space.n_velocity_dofs]).reshape(-1, 2)))),
], ids=["linearize_at", "jacobian_csr", "jacobian_dense",
        "velocity_jacobi_diags", "VelocityOperator",
        "PressurePoissonOperator"])
def test_jacobian_side_raises_until_ported(call):
    """(The name dates from when these raised.)  The Jacobian side now
    matches the JAX package at roundoff: the 2D rectangle with every
    boundary dof constrained."""
    jop, top, ts, markers = _operators(2)
    bc = np.arange(0, ts.n_dofs, 7, dtype=np.int32)
    jop.set_bc_dofs(bc)
    top.set_bc_dofs(bc)
    want, got = call(jop, top, _state(top, 3))
    _close(got, want)


def _jax_poisson(space):
    from navierstokes_tpu.assembly.operators import PressurePoissonOperator

    return PressurePoissonOperator(space)


def test_operator_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MixedOperator(_spaces(2)[1])
