"""Global operators bound to a Taylor-Hood space (counterpart of
``navierstokes_tpu/assembly/operators.py``).

``MixedOperator`` is the residual/Jacobian bundle of the monolithic
system: the assembled residual (with or without Dirichlet masking), the
matrix-free Jacobian action (``linearize_at``), sparse and dense Jacobians,
boundary tractions and fluxes, L2 projections and functionals.
``VelocityOperator`` is its velocity-subspace analogue for the IPCS
diffusion step; ``PressurePoissonOperator`` the matrix-free P1 Laplacian,
mass and pressure-space convection.

Where the JAX package differentiates with ``jax.jacfwd`` under
``jax.vmap`` and ``jax.linearize``, the port writes the derivative out
(``kernels.make_cell_tangent``: the residual is at most quadratic, its
convective terms a bilinear form), which costs one batched sweep per
direction; forward-mode ``torch.func.jvp`` of the residual ran several
times slower.  An element matrix is the cell Jacobian applied to a
one-hot direction on every cell per local dof, a Jacobian action the
cell Jacobian on the gathered direction, scattered and Dirichlet-masked.
Both equal the JAX package's at roundoff.
"""

from __future__ import annotations

import numpy as np
import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly import kernels, sparse
from navierstokes_tpu_torch.fem.bcs import (parse_convective_form,
                                            parse_viscous_form)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, _eval_field
from navierstokes_tpu_torch.utils.segment import SegmentSum


def _cell_dofs(space, with_pressure):
    """(nc, n_loc) global dofs of each cell: velocity node-major (node i,
    component d at i * dim + d), then the pressure nodes."""
    d = space.dim
    udofs = (space.cell_unodes[:, :, None] * d
             + np.arange(d)[None, None, :]).reshape(len(space.cell_unodes),
                                                    -1)
    if with_pressure:
        udofs = np.concatenate(
            [udofs, space.cell_pnodes + space.pressure_offset], axis=1)
    return udofs.astype(np.int64)


def _element_jacobian(f, nc, m, like):
    """(nc, m, m) matrices of a cell-batched linear map ``f`` (nc, m) ->
    (nc, m): column j is ``f`` of the one-hot e_j on every cell."""
    eye = torch.eye(m, dtype=like.dtype, device=like.device)
    return torch.stack([f(eye[j].expand(nc, m)) for j in range(m)], dim=2)


class _BCRows:
    """Dirichlet row data of an operator with a sparsity pattern: the
    dofs and the (n,) mask; the pattern (host), its device half and the
    nnz masks of :func:`sparse.apply_bc_rows` are built when first asked
    for, so the matrix-free paths never pay for them."""

    def _init_bc_rows(self, cell_dofs_np, n):
        self.cell_dofs_np = cell_dofs_np
        self._n_rows = n
        self._pattern = None
        self._dpat = None
        self.set_bc_dofs(np.zeros((0,), dtype=np.int32))

    @property
    def pattern(self) -> sparse.SparsityPattern:
        if self._pattern is None:
            self._pattern = sparse.build_pattern(self.cell_dofs_np,
                                                 self._n_rows)
        return self._pattern

    def set_bc_dofs(self, bc_dofs: np.ndarray) -> None:
        self._bc_dofs_np = np.asarray(bc_dofs, dtype=np.int32)
        self._bc_dofs = self._ints(self._bc_dofs_np)
        mask = np.zeros(self._n_rows, dtype=bool)
        mask[self._bc_dofs_np] = True
        self._bc_mask = torch.as_tensor(mask, device=self.device)
        self._bc_nnz = None

    @property
    def bc_dofs(self):
        return self._bc_dofs

    def _csr(self, elem):
        """Assemble element matrices into a CSR with identity BC rows."""
        if self._dpat is None:
            self._dpat = sparse.DevicePattern(self.pattern, self.device)
        if self._bc_nnz is None:
            mask, diag = sparse.bc_row_masks(self.pattern, self._bc_dofs_np)
            self._bc_nnz = (torch.as_tensor(mask, device=self.device),
                            self._ints(diag))
        values = sparse.apply_bc_rows(
            sparse.assemble_csr(self._dpat, elem), *self._bc_nnz)
        return sparse.CSRMatrix(self._dpat, values)


class MixedOperator(_BCRows):
    """Residual/Jacobian of the mixed (monolithic) Navier-Stokes system.

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
        self._linearize_cells = kernels.make_cell_tangent(
            self.N2, self.G2, self.N1, d, self.conv_form, self.visc_form,
            with_coriolis)
        self._init_bc_rows(_cell_dofs(space, True), space.n_dofs)

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

    def _assembled(self, r_u_c, r_p_c):
        return torch.cat([self._scatter_u(r_u_c).reshape(-1),
                          self._scatter_p(r_p_c)])

    def _cell_tangent(self, x, scalars, picard):
        """The Jacobian at ``x`` as a map of gathered cell directions
        (w_u (nc, nn2, d), w_p (nc, nn1)) -> (r_u, r_p)."""
        return self._linearize_cells(
            self.space.split(x)[0][self.cell_unodes], self.Jinv, self.W,
            scalars, picard)

    def linearize_at(self, x, scalars, source_q=0.0, picard=False):
        """Matrix-free Jacobian action J(x) @ v.

        Returns ``(r, jvp)`` where ``jvp(v)`` applies the Newton (or
        Picard, with the advecting field frozen at ``x``) Jacobian of the
        *masked* residual -- identity rows at Dirichlet dofs, matching the
        assembled path (:meth:`jacobian_csr`); ``r`` is that masked
        residual at ``x`` with ``x[bc]`` in the constrained rows.  Each
        ``jvp`` is one residual-like sweep; no CSR is formed.
        """
        space = self.space
        tangent = self._cell_tangent(x, scalars, picard)

        def jvp(v):
            u, p = space.split(v)
            r = self._assembled(*tangent(u[self.cell_unodes],
                                         p[self.cell_pnodes]))
            # the bc offset (z[bc] - g) differentiates to identity rows
            return torch.where(self._bc_mask, v, r)

        u, p = space.split(x)
        u_c = u[self.cell_unodes]
        r = self._assembled(*self._cell_residual(
            u_c, p[self.cell_pnodes], u_c, self.Jinv, self.W, source_q,
            scalars, picard))
        return torch.where(self._bc_mask, x, r), jvp

    def velocity_jacobi_diags(self):
        """Per-scalar-node diagonals of the P2 vector mass and stiffness.

        Building blocks of the Jacobi diagonal of the velocity
        convection-diffusion-reaction block: diag(F) ~= accel0 * dm +
        visc * dk (convection contributes nothing to the diagonal in the
        standard form).  Used by the matrix-free PCD preconditioner.
        """
        g2 = torch.einsum("qia,cqae->cqie", self.G2, self.Jinv)
        dk_c = torch.einsum("cq,cqie,cqie->ci", self.W, g2, g2)
        dm_c = torch.einsum("cq,qi,qi->ci", self.W, self.N2, self.N2)
        return self._scatter_u(dm_c), self._scatter_u(dk_c)

    # -- Jacobians -----------------------------------------------------------
    def _element_matrices(self, x, scalars, source_q, picard: bool):
        tangent = self._cell_tangent(x, scalars, picard)
        nc = self.cell_unodes.shape[0]

        def f(z):
            r_u, r_p = tangent(z[:, :self.nu_loc].reshape(nc, -1, self.dim),
                               z[:, self.nu_loc:])
            return torch.cat([r_u.reshape(nc, -1), r_p], dim=1)

        return _element_jacobian(f, nc, self.n_loc, x)

    def jacobian_csr(self, x, scalars, source_q=0.0, picard=False):
        return self._csr(self._element_matrices(x, scalars, source_q,
                                                picard))

    def jacobian_dense(self, x, scalars, source_q=0.0, picard=False):
        return self.jacobian_csr(x, scalars, source_q, picard).todense()

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

    def velocity_operator_image(self, u, scalars, source_q=0.0):
        """Velocity-block image of the momentum operator at ``u``.

        Returns the un-masked assembled velocity residual (n_unodes, dim)
        of the convective+viscous(+Coriolis) terms with the given
        coefficients, zero pressure and zero acceleration -- the
        explicit-side building block of theta/IMEX splittings.
        """
        full = dict(scalars)
        full.setdefault("cp", 0.0)
        full.setdefault("accel0", 0.0)
        u_c = u[self.cell_unodes]
        p_c = u.new_zeros(self.cell_pnodes.shape)
        r_u_c, _ = self._cell_residual(u_c, p_c, u_c, self.Jinv, self.W,
                                       source_q, full, False)
        return self._scatter_u(r_u_c)


class VelocityOperator(_BCRows):
    """Residual/Jacobian on the collapsed P2 velocity subspace: the IPCS
    diffusion step's unknown is the intermediate velocity; the lagged
    pressure and BDF history enter as precomputed data.  Tensors live on
    ``device`` (default: the card) in ``dtype``."""

    def __init__(self, space: TaylorHoodSpace, form_convective_term="standard",
                 form_viscous_term="reduced", *, device=None, dtype=None):
        self.space = space
        self.dim = space.dim
        self.conv_form = parse_convective_form(form_convective_term)
        self.visc_form = parse_viscous_form(form_viscous_term)
        self.device = device = config.require_device(device)
        self.dtype = config.resolve_dtype(dtype, device)

        floats = self._floats
        self.Jinv = floats(space.Jinv_q)
        self.W = floats(space.integration_weights())
        self.N2 = floats(space.N2)
        self.N1 = floats(space.N1)
        self.cell_unodes = self._ints(space.cell_unodes)
        self.cell_pnodes = self._ints(space.cell_pnodes)
        self._scatter_u = SegmentSum(space.cell_unodes, space.n_unodes,
                                     device)
        self.n_dofs = space.n_unodes * space.dim
        self._wN2 = self.W[:, :, None] * self.N2
        G2 = floats(space.G2)
        self._cell_residual = kernels.make_velocity_cell_residual(
            self.N2, G2, self.N1, space.dim, self.conv_form, self.visc_form)
        self._linearize_cells = kernels.make_cell_tangent(
            self.N2, G2, self.N1, space.dim, self.conv_form, self.visc_form,
            False)
        self._init_bc_rows(_cell_dofs(space, False), self.n_dofs)

    _floats = MixedOperator._floats
    _ints = MixedOperator._ints

    def _residual_impl(self, uflat, bc_values, scalars, p_old, source_q):
        u_c = uflat.reshape(-1, self.dim)[self.cell_unodes]
        r = self._scatter_u(self._cell_residual(
            u_c, u_c, self.Jinv, self.W, source_q, p_old[self.cell_pnodes],
            scalars, False)).reshape(-1)
        bc = self._bc_dofs
        return r.index_copy(0, bc, uflat[bc] - bc_values)

    def residual(self, uflat, bc_values, scalars, p_old, source_q=0.0):
        return self._residual_impl(uflat, bc_values, scalars, p_old,
                                   source_q)

    def _cell_tangent(self, uflat, scalars, picard):
        """The velocity Jacobian at ``uflat`` as a map of gathered cell
        directions (nc, nn2, d) -> (nc, nn2, d) (the lagged pressure and
        the source are constants)."""
        tangent = self._linearize_cells(
            uflat.reshape(-1, self.dim)[self.cell_unodes], self.Jinv,
            self.W, scalars, picard)
        return lambda w_u: tangent(w_u)[0]

    def linearize_at(self, uflat, bc_values, scalars, p_old, source_q=0.0):
        """``(F(uflat), jvp)``: the Dirichlet-masked residual and its
        Newton Jacobian action (identity rows at constrained dofs)."""
        tangent = self._cell_tangent(uflat, scalars, False)

        def jvp(v):
            r = self._scatter_u(tangent(
                v.reshape(-1, self.dim)[self.cell_unodes])).reshape(-1)
            return torch.where(self._bc_mask, v, r)

        return self._residual_impl(uflat, bc_values, scalars, p_old,
                                   source_q), jvp

    def jacobian_csr(self, uflat, scalars, p_old, source_q=0.0,
                     picard=False):
        tangent = self._cell_tangent(uflat, scalars, picard)
        nc = self.cell_unodes.shape[0]
        m = self.cell_dofs_np.shape[1]

        def f(z):
            return tangent(z.reshape(nc, -1, self.dim)).reshape(nc, -1)

        return self._csr(_element_jacobian(f, nc, m, uflat))

    def mass_matvec(self, uflat):
        u_q = torch.einsum("qi,cid->cqd", self.N2,
                           uflat.reshape(-1, self.dim)[self.cell_unodes])
        return self.mass_rhs(u_q)

    def mass_rhs(self, values_at_quad):
        """b_i = integral(values . N_i): RHS of an L2 projection."""
        return self._scatter_u(torch.einsum(
            "cqd,cqi->cid", values_at_quad, self._wN2)).reshape(-1)


class PressurePoissonOperator:
    """P1 scalar Laplacian + mass on the pressure dofmap (SPD, matrix-free).

    Tensors live on ``device`` (default: the card; the CPU only with
    ``device="cpu"``) in ``dtype``.  The IPCS projection step, the PCD
    preconditioner and the stream-potential postprocessing use it.
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
        # quadrature-weighted test functions: every apply is a chain of
        # two-operand contractions
        self._wg1 = self.W[:, :, None, None] * self._g1
        self._wN1 = self.W[:, :, None] * self.N1
        self._scatter = SegmentSum(space.cell_pnodes, space.n_pnodes, device)

    def stiffness_matvec(self, p):
        grad_p = torch.einsum("cj,cqje->cqe", p[self.cell_pnodes], self._g1)
        return self._scatter(torch.einsum("cqe,cqje->cj", grad_p,
                                          self._wg1))

    def mass_matvec(self, p):
        p_q = torch.einsum("qj,cj->cq", self.N1, p[self.cell_pnodes])
        return self._scatter(torch.einsum("cq,cqj->cj", p_q, self._wN1))

    def rhs_grad_dot_gradq(self, grad_at_quad):
        """b_j = integral(grad_at_quad . grad(N_j))."""
        return self._scatter(torch.einsum("cqe,cqje->cj", grad_at_quad,
                                          self._wg1))

    def rhs_scalar(self, vals_at_quad):
        """b_j = integral(vals * N_j)."""
        return self._scatter(torch.einsum("cq,cqj->cj", vals_at_quad,
                                          self._wN1))

    def convection_matvec(self, p, u_q):
        """N_p(u) p = integral((u . grad p) q): pressure-space convection
        (the PCD preconditioner's transport operator)."""
        grad_p = torch.einsum("cj,cqje->cqe", p[self.cell_pnodes], self._g1)
        conv = torch.einsum("cqe,cqe->cq", u_q, grad_p)
        return self._scatter(torch.einsum("cq,cqj->cj", conv, self._wN1))
