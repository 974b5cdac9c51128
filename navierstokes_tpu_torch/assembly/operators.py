"""Global operators bound to a Taylor-Hood space (counterpart of
``navierstokes_tpu/assembly/operators.py``).

``MixedOperator`` holds the forward subset the solver layer calls: the
assembled residual (with or without Dirichlet masking), boundary
tractions and fluxes, L2 projections and functionals.
``PressurePoissonOperator`` is the matrix-free P1 Laplacian and mass (the
stream-potential solve of the postprocessing uses it).  The Jacobian
methods, ``velocity_operator_image``, ``VelocityOperator`` and the PCD
convection of ``PressurePoissonOperator`` come with the Newton and IPCS
stacks and raise ``NotImplementedError`` until then; the sparsity pattern
comes with them (``set_bc_dofs`` only stores the dofs).
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly import kernels
from navierstokes_tpu_torch.fem.bcs import (parse_convective_form,
                                            parse_viscous_form)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, _eval_field
from navierstokes_tpu_torch.utils.segment import SegmentSum


def _not_ported(what, item):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP item {item})")


class MixedOperator:
    """Residual of the mixed (monolithic) Navier-Stokes system.

    Tensors live on ``device`` (default: the card; the CPU only with
    ``device="cpu"``) in ``dtype`` (default
    ``config.default_dtype(device)``).
    """

    def __init__(self, space: TaylorHoodSpace, form_convective_term="standard",
                 form_viscous_term="reduced", with_coriolis=False, *,
                 device=None, dtype=None):
        self.space = space
        self.dim = space.dim
        self.conv_form = parse_convective_form(form_convective_term)
        self.visc_form = parse_viscous_form(form_viscous_term)
        self.with_coriolis = with_coriolis
        self.device = device = config.require_device(device)
        self.dtype = dt = config.resolve_dtype(dtype, device)

        self.Jinv = self._floats(space.Jinv_q)
        self.W = self._floats(space.integration_weights())
        self.N2 = self._floats(space.N2)
        self.G2 = self._floats(space.G2)
        self.N1 = self._floats(space.N1)
        self.G1 = self._floats(space.G1)
        self.cell_unodes = self._ints(space.cell_unodes)
        self.cell_pnodes = self._ints(space.cell_pnodes)
        self._scatter_u = SegmentSum(space.cell_unodes, space.n_unodes,
                                     device)
        self._scatter_p = SegmentSum(space.cell_pnodes, space.n_pnodes,
                                     device)

        d = space.dim
        self.nu_loc = space.cell_unodes.shape[1] * d
        self.n_loc = self.nu_loc + space.cell_pnodes.shape[1]

        self._cell_residual = kernels.make_cell_residual(
            self.N2, self.G2, self.N1, d, self.conv_form, self.visc_form,
            with_coriolis)
        self._bc_dofs_np = np.zeros((0,), dtype=np.int32)
        self._bc_dofs = self._ints(self._bc_dofs_np)

    def _floats(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _ints(self, a):
        return torch.tensor(np.asarray(a), dtype=torch.int64,
                            device=self.device)

    def _tensor(self, a):
        """``a`` on the operator's device in its dtype (a tensor or
        anything NumPy reads)."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return self._floats(a)

    # -- Dirichlet wiring ---------------------------------------------------
    def set_bc_dofs(self, bc_dofs: np.ndarray) -> None:
        self._bc_dofs_np = np.asarray(bc_dofs, dtype=np.int32)
        self._bc_dofs = self._ints(self._bc_dofs_np)

    @property
    def bc_dofs(self):
        return self._bc_dofs

    # -- helpers -------------------------------------------------------------
    def split(self, x):
        return self.space.split(x)

    def u_at_quad(self, u):
        """(nc, nq, d) velocity values at volume quadrature points."""
        return torch.einsum("qi,cid->cqd", self.N2, u[self.cell_unodes])

    def grad_u_at_quad(self, u):
        g2 = torch.einsum("qia,cqae->cqie", self.G2, self.Jinv)
        return torch.einsum("cid,cqie->cqde", u[self.cell_unodes], g2)

    def p_at_quad(self, p):
        return torch.einsum("qj,cj->cq", self.N1, p[self.cell_pnodes])

    def grad_p_at_quad(self, p):
        g1 = torch.einsum("qja,cqae->cqje", self.G1, self.Jinv)
        return torch.einsum("cj,cqje->cqe", p[self.cell_pnodes], g1)

    def quad_coords(self):
        return self._floats(self.space.quad_coords())

    # -- residual ------------------------------------------------------------
    def residual(self, x, bc_values, scalars, source_q=0.0, extra_ru=None,
                 mask_bcs=True):
        """Assembled residual with Dirichlet masking r[bc] = x[bc] - g.

        ``extra_ru``: optional (n_unodes, d) pre-scattered velocity residual
        contribution (boundary tractions).  ``mask_bcs=False`` returns the
        raw assembled residual -- its values at constrained velocity nodes
        are the nodal *reaction forces* (used for superconvergent drag/lift
        evaluation).
        """
        u, p = self.space.split(x)
        u_c = u[self.cell_unodes]
        r_u_c, r_p_c = self._cell_residual(
            u_c, p[self.cell_pnodes], u_c, self.Jinv, self.W, source_q,
            scalars, False)
        r_u = self._scatter_u(r_u_c)
        if extra_ru is not None:
            r_u = r_u + extra_ru
        r = torch.cat([r_u.reshape(-1), self._scatter_p(r_p_c)])
        if mask_bcs:
            r[self._bc_dofs] = x[self._bc_dofs] - bc_values
        return r

    def linearize_at(self, *args, **kwargs):
        _not_ported("MixedOperator.linearize_at (the matrix-free Jacobian "
                    "action)", 13)

    def velocity_jacobi_diags(self):
        _not_ported("MixedOperator.velocity_jacobi_diags (the PCD "
                    "preconditioner's diagonals)", 13)

    def jacobian_csr(self, *args, **kwargs):
        _not_ported("MixedOperator.jacobian_csr (with assembly/sparse.py)",
                    13)

    def jacobian_dense(self, *args, **kwargs):
        _not_ported("MixedOperator.jacobian_dense", 13)

    def velocity_operator_image(self, *args, **kwargs):
        _not_ported("MixedOperator.velocity_operator_image (the explicit "
                    "side of the theta/IMEX splittings)", "9b")

    # -- boundary tractions ---------------------------------------------------
    def facet_batch_device(self, batch: dict) -> dict:
        """The arrays of ``space.facet_batch`` as tensors, plus the node
        tables of the batch's cells and the scatter of its velocity
        nodes."""
        out = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            out[k] = self._floats(arr) if arr.dtype.kind == "f" \
                else self._ints(arr)
        out["cell_unodes"] = self.cell_unodes[out["cells"]]
        out["cell_pnodes"] = self.cell_pnodes[out["cells"]]
        out["scatter_u"] = SegmentSum(
            self.space.cell_unodes[np.asarray(batch["cells"])],
            self.space.n_unodes, self.device)
        return out

    def traction_residual(self, batch_dev: dict, t_q) -> torch.Tensor:
        """+ integral(traction . w) dA, scattered to (n_unodes, d): the
        traction term is *added* to the residual F."""
        r_c = torch.einsum("fq,fqd,fqi->fid", batch_dev["weights"], t_q,
                           batch_dev["N2"])
        return batch_dev["scatter_u"](r_c)

    def boundary_velocity_flux(self, batch_dev: dict, u) -> torch.Tensor:
        """integral(u . n) over the batch facets (mass flux)."""
        u_q = torch.einsum("fqi,fid->fqd", batch_dev["N2"],
                           u[batch_dev["cell_unodes"]])
        un = torch.einsum("fqd,fqd->fq", u_q, batch_dev["normals"])
        return torch.sum(batch_dev["weights"] * un)

    def boundary_traction_force(self, batch_dev: dict, u, p,
                                visc) -> torch.Tensor:
        """integral(-p n + visc * (grad u + grad u^T)/2 . n) dA  -> (d,):
        the drag/lift integrand of the DFG benchmark."""
        g2 = torch.einsum("fqia,fqae->fqie", batch_dev["G2"],
                          batch_dev["Jinv"])
        grad_u = torch.einsum("fid,fqie->fqde", u[batch_dev["cell_unodes"]],
                              g2)
        p_q = torch.einsum("fqj,fj->fq", batch_dev["N1"],
                           p[batch_dev["cell_pnodes"]])
        D = 0.5 * (grad_u + grad_u.transpose(2, 3))
        n = batch_dev["normals"]                          # (nf, nqf, d)
        tau = (-p_q[:, :, None] * n
               + visc * torch.einsum("fqde,fqe->fqd", D, n))
        return torch.einsum("fq,fqd->d", batch_dev["weights"], tau)

    # -- projections / functionals -------------------------------------------
    def mass_rhs(self, values_at_quad):
        """b_i = integral(values . N_i), flat (n_velocity_dofs,): the load
        vector of quadrature-point values (nc, nq, d)."""
        b_c = torch.einsum("cq,cqd,qi->cid", self.W,
                           self._tensor(values_at_quad), self.N2)
        return self._scatter_u(b_c).reshape(-1)

    def project_velocity(self, values_at_unodes=None, values_at_quad=None,
                         tol=1e-14):
        """L2-project onto the P2 velocity space (mass-matrix CG solve).

        Provide either nodal values (used as RHS data via interpolation at
        quadrature points) or direct quadrature-point values (nc, nq, d).
        """
        from navierstokes_tpu_torch.linalg.krylov import cg

        if values_at_quad is None:
            values_at_quad = self.u_at_quad(self._tensor(values_at_unodes))
        b = self.mass_rhs(values_at_quad)

        def mass(uflat):
            return kernels.p2_vector_mass_apply(
                self.N2, self.W, self.cell_unodes,
                uflat.reshape(-1, self.dim), self._scatter_u).reshape(-1)

        x, _ = cg(mass, b, tol=tol)
        return x.reshape(-1, self.dim)

    def project_pressure(self, values_at_pnodes=None, values_at_quad=None,
                         tol=1e-14):
        from navierstokes_tpu_torch.linalg.krylov import cg

        def load(vals_q):
            return self._scatter_p(torch.einsum("cq,cq,qj->cj", self.W,
                                                vals_q, self.N1))

        if values_at_quad is None:
            values_at_quad = self.p_at_quad(self._tensor(values_at_pnodes))
        x, _ = cg(lambda p: load(self.p_at_quad(p)),
                  load(self._tensor(values_at_quad)), tol=tol)
        return x

    def domain_volume(self) -> float:
        return float(torch.sum(self.W))

    def mean_pressure(self, p):
        return torch.sum(self.W * self.p_at_quad(p)) / torch.sum(self.W)

    def _exact_at_quad(self, exact_fn, t, vector_dim):
        xq = self.space.quad_coords()
        exact = _eval_field(exact_fn, xq.reshape(-1, self.dim), t, vector_dim)
        shape = xq.shape if vector_dim else xq.shape[:2]
        return self._floats(np.asarray(exact).reshape(shape))

    def l2_error_velocity(self, u, exact_fn, t=None) -> float:
        diff = self.u_at_quad(u) - self._exact_at_quad(exact_fn, t, self.dim)
        return float(torch.sqrt(torch.sum(
            self.W * torch.sum(diff ** 2, dim=-1))))

    def l2_error_pressure(self, p, exact_fn, t=None) -> float:
        diff = self.p_at_quad(p) - self._exact_at_quad(exact_fn, t, None)
        return float(torch.sqrt(torch.sum(self.W * diff ** 2)))

    def divergence_l2(self, u) -> float:
        g = self.grad_u_at_quad(u)
        div = torch.diagonal(g, dim1=2, dim2=3).sum(dim=-1)
        return float(torch.sqrt(torch.sum(self.W * div ** 2)))


class VelocityOperator:
    """The velocity-subspace operator of the IPCS diffusion step."""

    def __init__(self, *args, **kwargs):
        _not_ported("VelocityOperator (the IPCS diffusion step)", 14)


class PressurePoissonOperator:
    """P1 scalar Laplacian + mass on the pressure dofmap (SPD, matrix-free).

    Tensors live on ``device`` (default: the card; the CPU only with
    ``device="cpu"``) in ``dtype``.  The stream-potential postprocessing
    solve uses it.
    """

    def __init__(self, space: TaylorHoodSpace, *, device=None, dtype=None):
        self.space = space
        self.dim = space.dim
        self.device = device = config.require_device(device)
        self.dtype = dt = config.resolve_dtype(dtype, device)

        def floats(a):
            return torch.tensor(np.asarray(a), dtype=dt, device=device)

        self.Jinv = floats(space.Jinv_q)
        self.W = floats(space.integration_weights())
        self.cell_pnodes = torch.tensor(np.asarray(space.cell_pnodes),
                                        dtype=torch.int64, device=device)
        self.n_dofs = space.n_pnodes
        self.G1 = floats(space.G1)
        self.N1 = floats(space.N1)
        self._g1 = torch.einsum("qja,cqae->cqje", self.G1, self.Jinv)
        self._scatter = SegmentSum(space.cell_pnodes, space.n_pnodes, device)

    def stiffness_matvec(self, p):
        grad_p = torch.einsum("cj,cqje->cqe", p[self.cell_pnodes], self._g1)
        r_c = torch.einsum("cq,cqe,cqje->cj", self.W, grad_p, self._g1)
        return self._scatter(r_c)

    def mass_matvec(self, p):
        p_q = torch.einsum("qj,cj->cq", self.N1, p[self.cell_pnodes])
        r_c = torch.einsum("cq,cq,qj->cj", self.W, p_q, self.N1)
        return self._scatter(r_c)

    def rhs_grad_dot_gradq(self, grad_at_quad):
        """b_j = integral(grad_at_quad . grad(N_j))."""
        r_c = torch.einsum("cq,cqe,cqje->cj", self.W, grad_at_quad, self._g1)
        return self._scatter(r_c)

    def rhs_scalar(self, vals_at_quad):
        """b_j = integral(vals * N_j)."""
        r_c = torch.einsum("cq,cq,qj->cj", self.W, vals_at_quad, self.N1)
        return self._scatter(r_c)

    def convection_matvec(self, *args, **kwargs):
        _not_ported("PressurePoissonOperator.convection_matvec (the PCD "
                    "preconditioner's transport operator)", "9b")
