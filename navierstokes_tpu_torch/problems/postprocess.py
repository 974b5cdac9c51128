"""Derived fields: vorticity, pressure gradient, stream potential, CFL
numbers (counterpart of ``navierstokes_tpu/problems/postprocess.py``).

* vorticity: cell-local L2 projection of curl(u) onto DG(1) -- small
  batched dense solves;
* pressure gradient: DG(0) cell averages of grad(p);
* stream potential: CG1 Poisson solve with homogeneous Dirichlet data on
  no-slip walls and -u.n Neumann data elsewhere;
* CFL: max over quadrature points of deg * |u| * dt / h.

Each takes the solver's ``MixedOperator`` and tensors on its device; the
vertex fields for output come back as host arrays.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from navierstokes_tpu_torch.assembly.operators import (MixedOperator,
                                                       PressurePoissonOperator)
from navierstokes_tpu_torch.io.checkpoint import _to_numpy
from navierstokes_tpu_torch.utils.segment import SegmentSum


def _dg1_project(op: MixedOperator, values_q):
    """Cell-local L2 projection of (nc, nq) data onto DG1 -> (nc, nn1)."""
    M = torch.einsum("cq,qi,qj->cij", op.W, op.N1, op.N1)
    b = torch.einsum("cq,cq,qj->cj", op.W, values_q, op.N1)
    return torch.linalg.solve(M, b[..., None])[..., 0]


def _vertex_average(mesh, cell_vertex_values):
    """Average duplicated DG vertex values onto mesh vertices (nc, d+1)."""
    nv = mesh.n_vertices
    accum = np.zeros(nv)
    count = np.zeros(nv)
    np.add.at(accum, mesh.cells.ravel(),
              _to_numpy(cell_vertex_values).ravel())
    np.add.at(count, mesh.cells.ravel(), 1.0)
    return accum / np.maximum(count, 1.0)


def vorticity(op: MixedOperator, u):
    """2D: scalar curl as DG1 coefficients (nc, 3); 3D: (nc, nn1, 3)."""
    g = op.grad_u_at_quad(u)
    if op.dim == 2:
        return _dg1_project(op, g[:, :, 1, 0] - g[:, :, 0, 1])
    comps = [g[:, :, 2, 1] - g[:, :, 1, 2],
             g[:, :, 0, 2] - g[:, :, 2, 0],
             g[:, :, 1, 0] - g[:, :, 0, 1]]
    return torch.stack([_dg1_project(op, c) for c in comps], dim=-1)


def vorticity_vertex_field(op: MixedOperator, u):
    """Vorticity averaged onto mesh vertices (host array)."""
    w = vorticity(op, u)
    if op.dim == 2:
        return _vertex_average(op.space.mesh, w)
    return np.stack([_vertex_average(op.space.mesh, w[..., k])
                     for k in range(3)], axis=-1)


def pressure_gradient(op: MixedOperator, p):
    """DG0 (cellwise-average) pressure gradient (nc, d)."""
    grad_q = op.grad_p_at_quad(p)
    vol = torch.sum(op.W, dim=1)
    return torch.einsum("cq,cqe->ce", op.W, grad_q) / vol[:, None]


# 1 / h^2 per cell on each operator's device, made once per operator
_INV_H2 = weakref.WeakKeyDictionary()


def cfl_number(op: MixedOperator, u, step_size: float, degree: int = 2):
    """max over quadrature points of deg * |u| * dt / h_cell.

    This runs every time step, so the device work ends in one reduction
    and the host reads one number: the maximum of |u_q|^2 / h^2 over the
    quadrature points (the square root and the scalar factors are taken on
    the host; both are monotone).
    """
    inv_h2 = _INV_H2.get(op)
    if inv_h2 is None:
        h = np.asarray(op.space.mesh.cell_diameters, dtype=np.float64)
        inv_h2 = _INV_H2[op] = torch.tensor(1.0 / h ** 2, dtype=op.dtype,
                                            device=op.device)
    u_q = op.u_at_quad(u)
    peak = torch.einsum("cqd,cqd,c->cq", u_q, u_q, inv_h2).max()
    return degree * math.sqrt(float(peak)) * step_size


def stream_potential(op: MixedOperator, u, markers, dirichlet_ids,
                     neumann_ids, tol=1e-12):
    """CG1 potential phi: lap(phi) = div(u), phi=0 on no-slip walls,
    d(phi)/dn = -u.n on the remaining boundaries.  Returns nodal values on
    pressure dofs (a tensor on the operator's device)."""
    from navierstokes_tpu_torch.linalg.krylov import masked_spd_solve

    space = op.space
    pop = PressurePoissonOperator(space, device=op.device, dtype=op.dtype)

    div_q = torch.diagonal(op.grad_u_at_quad(u), dim1=2, dim2=3).sum(-1)
    rhs = pop.rhs_scalar(div_q)

    for bid in neumann_ids:
        fids = markers.ids_with_value(bid)
        if len(fids) == 0:
            continue
        batch = space.facet_batch(fids)
        dev = op.facet_batch_device(batch)
        u_q = torch.einsum("fqi,fid->fqd", dev["N2"], u[dev["cell_unodes"]])
        un = torch.einsum("fqd,fqd->fq", u_q, dev["normals"])
        contrib_c = -torch.einsum("fq,fq,fqj->fj", dev["weights"], un,
                                  dev["N1"])
        scatter = SegmentSum(space.cell_pnodes[np.asarray(batch["cells"])],
                             space.n_pnodes, op.device)
        rhs = rhs + scatter(contrib_c)

    mask = np.zeros(space.n_pnodes, dtype=bool)
    got_dirichlet = False
    for bid in dirichlet_ids:
        fids = markers.ids_with_value(bid)
        if len(fids):
            mask[np.asarray(space.facet_pnodes(fids))] = True
            got_dirichlet = True
    if not got_dirichlet:
        mask[0] = True  # pure-Neumann: pin the constant
    zeros = torch.zeros(space.n_pnodes, dtype=rhs.dtype, device=rhs.device)
    phi, _ = masked_spd_solve(pop.stiffness_matvec, rhs, mask, zeros,
                              tol=tol)
    return phi
