"""Element kernels for the incompressible Navier-Stokes weak forms, on
tensors batched over cells (counterpart of
``navierstokes_tpu/assembly/kernels.py``, forward evaluation only: element
Jacobians come with the Newton stack).

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

    def cell_residual(u_c, p_c, uf_c, Jinv, W, source_q, scalars,
                      picard: bool):
        cc = scalars["cc"]
        cv = scalars["cv"]
        cp = scalars["cp"]
        accel0 = scalars["accel0"]

        g2 = torch.einsum("qia,cqae->cqie", G2, Jinv)  # phys grads of P2
        v_q = torch.einsum("qi,cid->cqd", N2, u_c)     # trial
        grad_v = torch.einsum("cid,cqie->cqde", u_c, g2)
        p_q = torch.einsum("qj,cj->cq", N1, p_c)

        if picard:
            u_q = torch.einsum("qi,cid->cqd", N2, uf_c)
            grad_u = torch.einsum("cid,cqie->cqde", uf_c, g2)
        else:
            u_q, grad_u = v_q, grad_v

        # momentum terms tested with w
        mom = accel0 * v_q + source_q
        if cc is not None:
            mom = mom + _convective_momentum(conv_form, cc, u_q, grad_u,
                                             v_q, grad_v, dim)
        if with_coriolis and not picard:
            cor = scalars["cor"]
            if dim == 2:
                mom = mom + cor * torch.stack([-v_q[..., 1], v_q[..., 0]],
                                              dim=-1)
            else:
                cor = torch.as_tensor(cor, dtype=v_q.dtype,
                                      device=v_q.device)
                mom = mom + torch.linalg.cross(cor.expand_as(v_q), v_q,
                                               dim=-1)

        # stress terms tested with grad(w)
        if visc_form is WeakFormViscousTerm.traction_form:
            stress = cv * (grad_v + grad_v.transpose(-1, -2))
        else:
            stress = cv * grad_v
        eye = torch.eye(dim, dtype=v_q.dtype, device=v_q.device)
        stress = stress - cp * p_q[..., None, None] * eye
        if cc is not None:
            extra = _convective_stress(conv_form, cc, u_q, v_q)
            if extra is not None:
                stress = stress + extra

        r_u = (torch.einsum("cq,cqd,qi->cid", W, mom, N2)
               + torch.einsum("cq,cqde,cqie->cid", W, stress, g2))

        div_v = _trace(grad_v)
        r_p = -cp * torch.einsum("cq,cq,qj->cj", W, div_v, N1)
        return r_u, r_p

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

