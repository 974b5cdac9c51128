"""Port parity: the Jacobian side of the operators (assembly/kernels.py,
assembly/operators.py, assembly/host_reference.py).

Element matrices, assembled CSR values, the dense Jacobian and the
matrix-free action ``linearize_at`` (Newton and Picard, with and without
a quadrature source, every convective form, Coriolis in 2D and 3D), the
PCD building blocks and ``VelocityOperator`` agree with the JAX package
to 1e-12 of the largest entry; the host float64 reference (NumPy on both
sides) is equal array for array.  CPU, float64, a 5x4 rectangle and a
2^3 cube, inputs from NumPy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_tpu.assembly import host_reference as jhr
from navierstokes_tpu.assembly import kernels as jk
from navierstokes_tpu.assembly.operators import MixedOperator as JaxMixed
from navierstokes_tpu.assembly.operators import \
    VelocityOperator as JaxVelocity
from navierstokes_tpu.fem import bcs as jbcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace as JaxSpace
from navierstokes_tpu.mesh import hyper_cube as jax_hyper_cube
from navierstokes_tpu.mesh import hyper_rectangle as jax_hyper_rectangle
from navierstokes_tpu_torch.assembly import host_reference as thr
from navierstokes_tpu_torch.assembly import kernels as tk
from navierstokes_tpu_torch.assembly.operators import (MixedOperator,
                                                       VelocityOperator)
from navierstokes_tpu_torch.fem.bcs import (parse_convective_form,
                                            parse_viscous_form)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace
from navierstokes_tpu_torch.mesh import hyper_cube, hyper_rectangle

TOL = 1e-12
FORMS = ("standard", "rotational", "divergence", "skew_symmetric")
_SPACES = {}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: under several pytest workers on a
    shared CPU, torch's intra-op threads oversubscribe the cores and slow
    them tenfold.  One thread per worker, restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def _spaces(dim):
    if dim not in _SPACES:
        if dim == 2:
            args = ((0.0, 0.0), (1.5, 1.0), (5, 4))
            jm, tm = jax_hyper_rectangle(*args), hyper_rectangle(*args)
        else:
            jm, tm = jax_hyper_cube(3, 2), hyper_cube(3, 2)
        _SPACES[dim] = (JaxSpace(jm[0]), TaylorHoodSpace(tm[0]))
    return _SPACES[dim]


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _scalars(dim, coriolis):
    sc = {"cc": 1.3, "cv": 0.7, "cp": 1.1, "accel0": 2.0}
    if coriolis:
        sc["cor"] = 0.3 if dim == 2 else np.array([0.1, -0.2, 0.3])
    return sc


def _pair(dim, form, visc="traction", coriolis=True, seed=0):
    js, ts = _spaces(dim)
    jo = JaxMixed(js, form, visc, with_coriolis=coriolis)
    to = MixedOperator(ts, form, visc, with_coriolis=coriolis, device="cpu")
    rng = np.random.default_rng(seed)
    bc = np.unique(rng.integers(0, js.n_dofs, js.n_dofs // 6)).astype(
        np.int32)
    jo.set_bc_dofs(bc)
    to.set_bc_dofs(bc)
    return jo, to, rng


def _args(rng, space, sc, with_source):
    x = rng.standard_normal(space.n_dofs)
    src = (rng.standard_normal(np.shape(space.Jinv_q)[:2] + (space.dim,))
           if with_source else 0.0)
    jsc = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in sc.items()}
    tsc = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in sc.items()}
    jsrc = jnp.asarray(src) if with_source else 0.0
    tsrc = torch.tensor(src) if with_source else 0.0
    return x, (jsc, jsrc), (tsc, tsrc)


@pytest.mark.parametrize("form,picard,with_source", [
    (form, False, True) for form in FORMS] + [
    ("standard", False, False), ("standard", True, False),
    ("skew_symmetric", True, True)])
def test_jacobians_match_2d(form, picard, with_source):
    jo, to, rng = _pair(2, form)
    x, (jsc, jsrc), (tsc, tsrc) = _args(rng, jo.space, _scalars(2, True),
                                        with_source)
    v = rng.standard_normal(x.shape)
    jcsr = jo.jacobian_csr(jnp.asarray(x), jsc, jsrc, picard=picard)
    tcsr = to.jacobian_csr(torch.tensor(x), tsc, tsrc, picard=picard)
    assert _rel(tcsr.values, jcsr.values) <= TOL
    assert _rel(to.jacobian_dense(torch.tensor(x), tsc, tsrc, picard=picard),
                jo.jacobian_dense(jnp.asarray(x), jsc, jsrc,
                                  picard=picard)) <= TOL
    jr, jjvp = jo.linearize_at(jnp.asarray(x), jsc, jsrc, picard=picard)
    tr, tjvp = to.linearize_at(torch.tensor(x), tsc, tsrc, picard=picard)
    assert _rel(tr, jr) <= TOL
    assert _rel(tjvp(torch.tensor(v)), jjvp(jnp.asarray(v))) <= TOL
    # the matrix-free action is the assembled matrix's
    assert _rel(tjvp(torch.tensor(v)), tcsr.matvec(torch.tensor(v))) <= TOL


@pytest.mark.parametrize("picard", [False, True], ids=["newton", "picard"])
def test_jacobians_match_3d_coriolis(picard):
    jo, to, rng = _pair(3, "rotational", "reduced")
    x, (jsc, jsrc), (tsc, tsrc) = _args(rng, jo.space, _scalars(3, True),
                                        True)
    v = rng.standard_normal(x.shape)
    jcsr = jo.jacobian_csr(jnp.asarray(x), jsc, jsrc, picard=picard)
    tcsr = to.jacobian_csr(torch.tensor(x), tsc, tsrc, picard=picard)
    assert _rel(tcsr.values, jcsr.values) <= TOL
    _, jjvp = jo.linearize_at(jnp.asarray(x), jsc, jsrc, picard=picard)
    _, tjvp = to.linearize_at(torch.tensor(x), tsc, tsrc, picard=picard)
    assert _rel(tjvp(torch.tensor(v)), jjvp(jnp.asarray(v))) <= TOL


@pytest.mark.parametrize("dim", [2, 3])
def test_pcd_building_blocks_match(dim):
    jo, to, rng = _pair(dim, "standard", "reduced", coriolis=False)
    for got, want in zip(to.velocity_jacobi_diags(),
                         jo.velocity_jacobi_diags()):
        assert _rel(got, want) <= TOL
    u = rng.standard_normal((jo.space.n_unodes, dim))
    sc = {"cc": 0.8, "cv": 0.3}
    assert _rel(to.velocity_operator_image(torch.tensor(u), sc),
                jo.velocity_operator_image(jnp.asarray(u), sc)) <= TOL


@pytest.mark.parametrize("form", ["standard", "skew_symmetric"])
def test_velocity_operator_matches(form):
    js, ts = _spaces(2)
    jv = JaxVelocity(js, form, "traction")
    tv = VelocityOperator(ts, form, "traction", device="cpu")
    rng = np.random.default_rng(5)
    bc = np.unique(rng.integers(0, jv.n_dofs, 12)).astype(np.int32)
    jv.set_bc_dofs(bc)
    tv.set_bc_dofs(bc)
    u = rng.standard_normal(jv.n_dofs)
    p = rng.standard_normal(js.n_pnodes)
    g = rng.standard_normal(len(bc))
    src = rng.standard_normal(np.shape(js.Jinv_q)[:2] + (2,))
    sc = {"cc": 1.0, "cv": 0.1, "cp": 1.0, "accel0": 3.0}
    J = (jnp.asarray(u), jnp.asarray(g), sc, jnp.asarray(p),
         jnp.asarray(src))
    T = (torch.tensor(u), torch.tensor(g), sc, torch.tensor(p),
         torch.tensor(src))
    assert _rel(tv.residual(*T), jv.residual(*J)) <= TOL
    for picard in (False, True):
        assert _rel(tv.jacobian_csr(T[0], sc, T[3], T[4],
                                    picard=picard).values,
                    jv.jacobian_csr(J[0], sc, J[3], J[4],
                                    picard=picard).values) <= TOL
    # the masked residual's jvp (the IPCS diffusion step's operator)
    v = rng.standard_normal(u.shape)
    _, jjvp = jax.linearize(
        lambda uf: jv._residual_impl(uf, J[1], sc, J[3], J[4]), J[0])
    r, tjvp = tv.linearize_at(*T)
    assert _rel(r, jv.residual(*J)) <= TOL
    assert _rel(tjvp(torch.tensor(v)), jjvp(jnp.asarray(v))) <= TOL
    f_q = rng.standard_normal(src.shape)
    assert _rel(tv.mass_rhs(torch.tensor(f_q)),
                jv.mass_rhs(jnp.asarray(f_q))) <= TOL
    assert _rel(tv.mass_matvec(torch.tensor(u)),
                jv.mass_matvec(jnp.asarray(u))) <= TOL


def test_velocity_cell_residual_matches():
    js, ts = _spaces(2)
    rng = np.random.default_rng(6)
    jcr = jk.make_velocity_cell_residual(
        js.N2, js.G2, js.N1, 2, jbcs.parse_convective_form("divergence"),
        jbcs.parse_viscous_form("reduced"))
    tcr = tk.make_velocity_cell_residual(
        *(torch.tensor(np.asarray(a)) for a in (ts.N2, ts.G2, ts.N1)), 2,
        parse_convective_form("divergence"), parse_viscous_form("reduced"))
    nc, nn2 = np.shape(js.cell_unodes)
    u_c, uf_c = (rng.standard_normal((nc, nn2, 2)) for _ in range(2))
    p_c = rng.standard_normal((nc, 3))
    src = rng.standard_normal(np.shape(js.Jinv_q)[:2] + (2,))
    Jinv, W = np.asarray(js.Jinv_q), np.asarray(js.integration_weights())
    sc = {"cc": 1.0, "cv": 0.5, "cp": 2.0, "accel0": 1.5}
    for picard in (False, True):
        want = jax.vmap(lambda a, b, c, d, e, f: jcr(a, b, c, d, e, f, sc,
                                                     picard))(
            *(jnp.asarray(a) for a in (u_c, uf_c, Jinv, W, src, p_c)))
        got = tcr(*(torch.tensor(a) for a in (u_c, uf_c, Jinv, W, src)),
                  torch.tensor(p_c), sc, picard)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("form", FORMS)
def test_host_reference_equals_the_jax_package(form):
    """``host_reference.py`` is the JAX package's NumPy code, copied:
    equal array for array."""
    js, ts = _spaces(2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(js.n_dofs)
    bc = np.unique(rng.integers(0, js.n_dofs, 20))
    g = rng.standard_normal(len(bc))
    src = rng.standard_normal(np.shape(js.Jinv_q)[:2] + (2,))
    extra = rng.standard_normal((js.n_unodes, 2))
    sc = {"cc": 1.0, "cv": 0.2, "cp": 1.0, "accel0": 0.5, "cor": 0.4}
    kw = dict(form_convective_term=form, form_viscous_term="traction",
              source_q=src)
    u = x[:js.n_velocity_dofs].reshape(-1, 2)
    p = x[js.n_velocity_dofs:]
    cu, cp = np.asarray(js.cell_unodes), np.asarray(js.cell_pnodes)
    for a, b in zip(thr.element_residuals_f64(ts, u[cu], p[cp], sc, **kw),
                    jhr.element_residuals_f64(js, u[cu], p[cp], sc, **kw)):
        assert np.array_equal(a, b)
    assert np.array_equal(
        thr.residual_f64(ts, x, bc, g, sc, extra_ru=extra, **kw),
        jhr.residual_f64(js, x, bc, g, sc, extra_ru=extra, **kw))
    kw.pop("source_q")
    a = thr.jacobian_f64(ts, x, bc, sc, pin_dof=int(js.pressure_offset),
                         **kw)
    b = jhr.jacobian_f64(js, x, bc, sc, pin_dof=int(js.pressure_offset),
                         **kw)
    assert (a != b).nnz == 0
