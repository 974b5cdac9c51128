"""Element kernels for the incompressible Navier-Stokes weak forms, on
tensors batched over cells (counterpart of
``navierstokes_tpu/assembly/kernels.py``).  Element Jacobians are taken
by forward-mode AD of these batched residuals (``assembly/operators.py``).

Term catalogue and sign conventions of the residual F(x) = 0:

    mass:       - c_p * div(u) * q
    momentum:   accel0 * u . w  +  source . w  +  convective(u) . w
                + coriolis(u) . w  - c_p * p * div(w) + viscous(u) : grad(w)
    boundary:   + traction . w   on marked facets

``source`` bundles every u-independent momentum contribution (BDF history
sum, body force with its minus sign, Euler acceleration), precomputed at
quadrature points outside the kernel.

Convective forms follow John (2016, pp. 307-308).  The Picard form omits
the Coriolis term.

The JAX package's ``scatter_unodes`` / ``scatter_pnodes`` (indexed adds)
are ``utils.segment.SegmentSum`` objects here, built once per cell-node
table by the operators: a fixed summation order, no atomics.
"""

from __future__ import annotations

import torch

from navierstokes_tpu_torch.fem.bcs import (WeakFormConvectiveTerm,
                                            WeakFormViscousTerm)


def _trace(g):
    return torch.diagonal(g, dim1=-2, dim2=-1).sum(dim=-1)


def _convective_momentum(form, cc, u_q, grad_u, v_q, grad_v, dim):
    """Momentum-term (dot w) part of the convective form.

    ``u`` is the advecting (frozen) field, ``v`` the transported (trial)
    field; Newton mode passes v = u.  All (nc, nq, ...); returns
    (nc, nq, d).
    """
    if form is WeakFormConvectiveTerm.standard_form:
        return cc * torch.einsum("cqde,cqe->cqd", grad_v, u_q)
    if form is WeakFormConvectiveTerm.rotational_form:
        if dim == 2:
            curl = grad_u[..., 1, 0] - grad_u[..., 0, 1]
            return cc * torch.stack([-curl * v_q[..., 1],
                                     curl * v_q[..., 0]], dim=-1)
        curl = torch.stack([grad_u[..., 2, 1] - grad_u[..., 1, 2],
                            grad_u[..., 0, 2] - grad_u[..., 2, 0],
                            grad_u[..., 1, 0] - grad_u[..., 0, 1]], dim=-1)
        return cc * torch.linalg.cross(curl, v_q, dim=-1)
    if form is WeakFormConvectiveTerm.divergence_form:
        div_u = _trace(grad_u)
        return cc * (torch.einsum("cqde,cqe->cqd", grad_v, u_q)
                     + 0.5 * div_u[..., None] * v_q)
    if form is WeakFormConvectiveTerm.skew_symmetric_form:
        return 0.5 * cc * torch.einsum("cqde,cqe->cqd", grad_v, u_q)
    raise ValueError(form)  # pragma: no cover


def _convective_stress(form, cc, u_q, v_q):
    """grad(w)-tested part of the convective form (skew-symmetric only)."""
    if form is WeakFormConvectiveTerm.skew_symmetric_form:
        # -c/2 * (grad(w) . u) . v  ->  stress[d,e] -= c/2 * v[d] u[e]
        return -0.5 * cc * torch.einsum("cqd,cqe->cqde", v_q, u_q)
    return None


def _momentum_and_stress(conv_form, visc_form, dim, scalars, v_q, grad_v,
                         u_q, grad_u, p_q, source_q):
    """The w-tested momentum terms (without Coriolis) and the
    grad(w)-tested stress of the velocity equation at quadrature points
    (``p_q`` None: no pressure term)."""
    cc = scalars["cc"]
    mom = scalars["accel0"] * v_q + source_q
    if cc is not None:
        mom = mom + _convective_momentum(conv_form, cc, u_q, grad_u,
                                         v_q, grad_v, dim)
    cv = scalars["cv"]
    if visc_form is WeakFormViscousTerm.traction_form:
        stress = cv * (grad_v + grad_v.transpose(-1, -2))
    else:
        stress = cv * grad_v
    if p_q is not None:
        eye = torch.eye(dim, dtype=v_q.dtype, device=v_q.device)
        stress = stress - scalars["cp"] * p_q[..., None, None] * eye
    if cc is not None:
        extra = _convective_stress(conv_form, cc, u_q, v_q)
        if extra is not None:
            stress = stress + extra
    return mom, stress


def _coriolis(cor, v_q, dim):
    """The Coriolis term 2 Omega x v (``cor`` = 2 c omega; 3D: a vector)."""
    if dim == 2:
        return cor * torch.stack([-v_q[..., 1], v_q[..., 0]], dim=-1)
    cor = torch.as_tensor(cor, dtype=v_q.dtype, device=v_q.device)
    return torch.linalg.cross(cor.expand_as(v_q), v_q, dim=-1)


class _Geometry:
    """The physical P2 gradients and quadrature-weighted test functions of
    a batch of cells, laid out so that every interpolation and test is
    one batched matmul over the cells (``torch.einsum`` of these shapes
    takes a slow batched path on the CPU)."""

    def __init__(self, N2, G2, N1, Jinv, W):
        nc, nq = W.shape
        g2 = torch.einsum("qia,cqae->cqie", G2, Jinv)
        self.g2 = g2
        self.dim = dim = g2.shape[-1]
        # (c, q*e, i): grad_u[c, q, :, e] = g2t[c, (q, e)] @ u_c[c]
        self.g2t = g2.transpose(2, 3).reshape(nc, nq * dim, -1)
        # (c, i, q*e) and (c, i, q), (c, j, q): the weighted tests
        wg2 = W[:, :, None, None] * g2
        self.wg2t = wg2.permute(0, 2, 1, 3).reshape(nc, -1, nq * dim)
        self.wN2t = (W[:, :, None] * N2).transpose(1, 2).contiguous()
        self.wN1t = (W[:, :, None] * N1).transpose(1, 2).contiguous()
        self.N2 = N2

    def values(self, u_c):
        """(c, i, d) nodal coefficients -> (c, q, d) quadrature values."""
        return torch.matmul(self.N2, u_c)

    def grads(self, u_c):
        """(c, i, d) -> (c, q, d, e) physical gradients."""
        nc, nq = u_c.shape[0], self.N2.shape[0]
        return torch.bmm(self.g2t, u_c).reshape(
            nc, nq, self.dim, -1).transpose(2, 3)

    def test_values(self, f_q):
        """(c, q, d) -> (c, i, d): integral(f . N_i)."""
        return torch.bmm(self.wN2t, f_q)

    def test_grads(self, s_q):
        """(c, q, d, e) -> (c, i, d): integral(s : grad N_i)."""
        nc = s_q.shape[0]
        return torch.bmm(self.wg2t, s_q.transpose(2, 3).reshape(
            nc, -1, s_q.shape[2]))

    def test_pressure(self, f_q):
        """(c, q) -> (c, j): integral(f N1_j)."""
        return torch.bmm(self.wN1t, f_q[..., None])[..., 0]


def _geometry(N2, G2, N1):
    """``(Jinv, W) -> _Geometry``, remembered for the last (Jinv, W)
    pair: an operator passes the same tensors on every call."""
    last = [None, None, None]

    def geometry(Jinv, W):
        if last[0] is not Jinv or last[1] is not W:
            last[:] = [Jinv, W, _Geometry(N2, G2, N1, Jinv, W)]
        return last[2]

    return geometry


def make_cell_residual(N2, G2, N1, dim, conv_form, visc_form,
                       with_coriolis):
    """Factory for the mixed residual of a batch of cells.

    ``N2`` (nq, nn2), ``G2`` (nq, nn2, d), ``N1`` (nq, nn1): tensors on the
    device the batch lives on.  Returns ``cell_residual(u_c, p_c, uf_c,
    Jinv, W, source_q, scalars, picard)`` -> (r_u (nc, nn2, d),
    r_p (nc, nn1)), where

      u_c (nc, nn2, d): trial velocity coefficients
      p_c (nc, nn1):    trial pressure coefficients
      uf_c:             frozen advection velocity (Picard); ignored else
      Jinv (nc, nq, d, d), W (nc, nq): cell geometry at quadrature points
        (weights include |det J(xi_q)|)
      source_q (nc, nq, d) or a scalar: u-independent momentum source
      scalars: dict of coefficients (floats or 0-d tensors)
        cc, cv, cp, accel0, cor (2*coriolis_coeff*omega; 3D: a vector)
      picard (bool): Picard linearization vs. full nonlinear form
    """
    geometry = _geometry(N2, G2, N1)

    def cell_residual(u_c, p_c, uf_c, Jinv, W, source_q, scalars,
                      picard: bool):
        geo = geometry(Jinv, W)
        v_q = geo.values(u_c)                          # trial
        grad_v = geo.grads(u_c)
        p_q = torch.matmul(p_c, N1.T)

        if picard:
            u_q = geo.values(uf_c)
            grad_u = geo.grads(uf_c)
        else:
            u_q, grad_u = v_q, grad_v

        mom, stress = _momentum_and_stress(conv_form, visc_form, dim,
                                           scalars, v_q, grad_v, u_q,
                                           grad_u, p_q, source_q)
        if with_coriolis and not picard:
            mom = mom + _coriolis(scalars["cor"], v_q, dim)

        r_u = geo.test_values(mom) + geo.test_grads(stress)
        r_p = -scalars["cp"] * geo.test_pressure(_trace(grad_v))
        return r_u, r_p

    return cell_residual


def make_cell_tangent(N2, G2, N1, dim, conv_form, visc_form, with_coriolis):
    """Factory for the Jacobian of :func:`make_cell_residual`'s residual.

    The residual is at most quadratic and its convective terms are a
    bilinear form B(advecting, transported), so at a state x the Jacobian
    applied to a direction w is

        Picard:  R_x(w)                      (advecting field frozen at x)
        Newton:  R_x(w) + B(w, x) + Coriolis(w)

    with R_x(w) the residual's terms linear in (w, p_w) for the advecting
    field x and no source.  Returns ``linearize(x_c, Jinv, W, scalars,
    picard)`` -> ``tangent(w_c, wp_c=None)`` -> (r_u (nc, nn2, d), r_p or
    None): x's quadrature values are computed once per linearization, and
    a tangent is one interpolation of w and one test per cell batch.
    ``wp_c`` None drops the pressure (the velocity residual of the IPCS
    diffusion step, whose lagged pressure is data).
    """
    geometry = _geometry(N2, G2, N1)

    def linearize(x_c, Jinv, W, scalars, picard):
        geo = geometry(Jinv, W)
        x_q, grad_x = geo.values(x_c), geo.grads(x_c)
        cc = scalars["cc"]
        newton = not picard and cc is not None
        coriolis = with_coriolis and not picard

        def tangent(w_c, wp_c=None):
            w_q, grad_w = geo.values(w_c), geo.grads(w_c)
            p_q = None if wp_c is None else torch.matmul(wp_c, N1.T)
            mom, stress = _momentum_and_stress(
                conv_form, visc_form, dim, scalars, w_q, grad_w, x_q,
                grad_x, p_q, 0.0)
            if newton:
                mom = mom + _convective_momentum(conv_form, cc, w_q, grad_w,
                                                 x_q, grad_x, dim)
                extra = _convective_stress(conv_form, cc, w_q, x_q)
                if extra is not None:
                    stress = stress + extra
            if coriolis:
                mom = mom + _coriolis(scalars["cor"], w_q, dim)
            r_u = geo.test_values(mom) + geo.test_grads(stress)
            if wp_c is None:
                return r_u, None
            return r_u, -scalars["cp"] * geo.test_pressure(_trace(grad_w))

        return tangent

    return linearize


def make_velocity_cell_residual(N2, G2, N1, dim, conv_form, visc_form):
    """Residual of the IPCS diffusion step (velocity unknown) for a batch
    of cells.

    ``cell_residual(u_c, uf_c, Jinv, W, source_q, p_old_c, scalars,
    picard)`` -> r_u (nc, nn2, d).  The lagged pressure enters via
    ``- c_p * p_old * div(w)``.
    """
    geometry = _geometry(N2, G2, N1)

    def cell_residual(u_c, uf_c, Jinv, W, source_q, p_old_c, scalars,
                      picard: bool):
        geo = geometry(Jinv, W)
        v_q = geo.values(u_c)
        grad_v = geo.grads(u_c)
        if picard:
            u_q = geo.values(uf_c)
            grad_u = geo.grads(uf_c)
        else:
            u_q, grad_u = v_q, grad_v
        p_q = torch.matmul(p_old_c, N1.T)
        mom, stress = _momentum_and_stress(conv_form, visc_form, dim,
                                           scalars, v_q, grad_v, u_q,
                                           grad_u, p_q, source_q)
        return geo.test_values(mom) + geo.test_grads(stress)

    return cell_residual


# ---------------------------------------------------------------------------
# simple bilinear element matrices (assembled once; SPD systems)
# ---------------------------------------------------------------------------

def p1_stiffness_elements(G1, Jinv, W):
    """(nc, nn1, nn1) element matrices of  (grad p, grad q).

    ``Jinv``: per-quadrature-point inverse Jacobians (nc, nq, d, d)."""
    g1 = torch.einsum("qia,cqae->cqie", G1, Jinv)
    return torch.einsum("cq,cqie,cqje->cij", W, g1, g1)


def p1_mass_elements(N1, W):
    return torch.einsum("cq,qi,qj->cij", W, N1, N1)


def p2_mass_elements(N2, W):
    return torch.einsum("cq,qi,qj->cij", W, N2, N2)


def p2_vector_mass_apply(N2, W, cell_unodes, u, scatter):
    """y = M u for the P2 vector mass matrix, matrix-free; ``scatter`` is
    the ``SegmentSum`` of ``cell_unodes``."""
    u_q = torch.einsum("qi,cid->cqd", N2, u[cell_unodes])
    r_c = torch.einsum("cq,cqd,qi->cid", W, u_q, N2)
    return scatter(r_c)

