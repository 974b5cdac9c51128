"""Shared solver machinery: spaces, BC bookkeeping, coefficients, sources
(counterpart of ``navierstokes_tpu/solvers/base.py``).

The setter API and validation rules of the JAX package's ``SolverBase``
(BC format checks, velocity/traction conflict rules, traction BCs forcing
the traction-form viscous term, internal constraints as Dirichlet data on
interior facets), compiled into torch tensors on the solver's device.
"""

from __future__ import annotations

import numpy as np

import torch

from navierstokes_tpu_torch import config
from navierstokes_tpu_torch.assembly.operators import MixedOperator
from navierstokes_tpu_torch.fem.bcs import (PressureBCType, TractionBCType,
                                      VelocityBCType)
from navierstokes_tpu_torch.fem.dirichlet import (compile_dirichlet_bcs,
                                            validate_bc_format)
from navierstokes_tpu_torch.fem.spaces import TaylorHoodSpace, _eval_field
from navierstokes_tpu_torch.mesh.core import FacetMarkers, SimplexMesh
from navierstokes_tpu_torch.problems.rotation import AngularVelocityVector
from navierstokes_tpu_torch.utils.monitor import (SolverMonitor,
                                                  timed_region)

# systems up to this size take the dense solve in every mode choice
_DENSE_LIMIT = 4500


def _auto_linear_mode(n, device) -> str:
    """Default linear-solve strategy by size and device (the JAX package's
    ``solvers/stationary.py::auto_linear_mode``): a dense LU for validation
    sizes, host SuperLU on the CPU, and PCD-preconditioned FGMRES on the
    card (no sparse factorization exists there)."""
    if n <= _DENSE_LIMIT:
        return "dense"
    if device.type == "cpu":
        return "host_lu"
    return "pcd"


class SolverBase:
    """Base class: mixed P2/P1 space + BC/coefficient/source machinery."""

    _sub_space_association = {0: "velocity", 1: "pressure"}
    _field_association = {"velocity": 0, "pressure": 1}

    def __init__(self, mesh: SimplexMesh, boundary_markers: FacetMarkers,
                 form_convective_term="standard", form_viscous_term="reduced",
                 *, device=None, dtype=None):
        """Tensors live on ``device`` (default: the card; the CPU only
        with ``device="cpu"``) in ``dtype`` (default
        ``config.default_dtype(device)``)."""
        assert isinstance(mesh, SimplexMesh)
        assert isinstance(boundary_markers, FacetMarkers)
        self._device = config.require_device(device)
        self._dtype = config.resolve_dtype(dtype, self._device)
        self._mesh = mesh
        self._boundary_markers = boundary_markers
        self._space_dim = mesh.dim
        self._n_cells = mesh.n_cells
        self._form_convective_term = form_convective_term
        self._form_viscous_term = form_viscous_term
        self._p_deg = 1

        self._periodic = None
        self._constrained_boundary_ids = ()
        self._velocity_bcs = []
        self._pressure_bcs = []
        self._traction_bcs = []
        self._body_force = None
        self._angular_velocity = None
        self._equation_coefficients = None
        self._space = None
        self._operator = None

        self.monitor = SolverMonitor()

    # ------------------------------------------------------------------ API
    def set_periodic_boundary_conditions(self, periodic_pairs,
                                         constrained_boundary_ids):
        """Periodic identification (list of fem.spaces.PeriodicPair)."""
        from navierstokes_tpu_torch.fem.spaces import PeriodicPair

        if isinstance(periodic_pairs, PeriodicPair):
            periodic_pairs = [periodic_pairs]
        assert all(isinstance(p, PeriodicPair) for p in periodic_pairs)
        self._periodic = list(periodic_pairs)
        self._constrained_boundary_ids = tuple(constrained_boundary_ids)

    def set_boundary_conditions(self, bcs, internal_constraints=None):
        """BC spec tuples, split and validated as in the reference."""
        assert isinstance(bcs, (list, tuple))
        for bc in bcs:
            validate_bc_format(bc, self._space_dim, self._boundary_markers,
                               self._mesh)

        velocity_bcs, traction_bcs, pressure_bcs = [], [], []
        velocity_ids, traction_ids, pressure_ids = set(), set(), set()
        for bc in bcs:
            if self._periodic is not None:
                assert bc[1] not in self._constrained_boundary_ids
            if isinstance(bc[0], VelocityBCType):
                velocity_bcs.append(bc)
                velocity_ids.add(bc[1])
            elif isinstance(bc[0], TractionBCType):
                traction_bcs.append(bc)
                traction_ids.add(bc[1])
            elif isinstance(bc[0], PressureBCType):
                pressure_bcs.append(bc)
                pressure_ids.add(bc[1])
        if self._periodic is None:
            assert len(velocity_bcs) > 0

        # velocity/traction conflicts allowed component-wise only
        if traction_bcs:
            allowed_v = (VelocityBCType.no_normal_flux,
                         VelocityBCType.no_tangential_flux,
                         VelocityBCType.constant_component,
                         VelocityBCType.function_component)
            allowed_t = (TractionBCType.constant_component,
                         TractionBCType.function_component)
            for bndry_id in velocity_ids & traction_ids:
                v_comp = t_comp = None
                for bc in velocity_bcs:
                    if bc[1] == bndry_id:
                        assert bc[0] in allowed_v
                        v_comp = bc[2]
                        break
                for bc in traction_bcs:
                    if bc[1] == bndry_id:
                        assert bc[0] in allowed_t
                        t_comp = bc[2]
                        break
                assert t_comp != v_comp

        if internal_constraints is not None:
            for bc in internal_constraints:
                validate_bc_format(bc, self._space_dim,
                                   self._boundary_markers, self._mesh,
                                   internal_constraint=True)
                assert bc[1] not in velocity_ids | traction_ids | pressure_ids
                if isinstance(bc[0], VelocityBCType):
                    velocity_bcs.append(bc)
                elif isinstance(bc[0], PressureBCType):
                    pressure_bcs.append(bc)
                else:  # pragma: no cover
                    raise NotImplementedError(
                        "traction internal constraints are not supported")

        self._velocity_bcs = velocity_bcs
        self._pressure_bcs = pressure_bcs
        self._traction_bcs = traction_bcs
        if traction_bcs:
            # natural traction data only pairs with the traction-form term
            self._form_viscous_term = "traction"

    def set_equation_coefficients(self, input_coefficients: dict):
        possible = ("convective_term", "coriolis_term", "euler_term",
                    "pressure_term", "viscous_term", "body_force_term")
        assert all(k in possible for k in input_coefficients)
        coeffs = dict.fromkeys(possible)
        coeffs.update(input_coefficients)
        for key, value in coeffs.items():
            if value is not None:
                assert isinstance(value, float) and value > 0.0
        self._equation_coefficients = coeffs

    def set_body_force(self, body_force):
        """Constant tuple or callable f(x[, t]) -> (n, dim)."""
        self._body_force = body_force

    def set_angular_velocity(self, angular_velocity):
        assert isinstance(angular_velocity, AngularVelocityVector)
        assert angular_velocity.space_dim == self._space_dim
        self._angular_velocity = angular_velocity

    @property
    def field_association(self):
        return self._field_association

    @property
    def sub_space_association(self):
        return self._sub_space_association

    @property
    def space(self) -> TaylorHoodSpace:
        return self._space

    @property
    def operator(self) -> MixedOperator:
        return self._operator

    @property
    def solution(self):
        """Mixed solution vector (velocity nodal field + pressure)."""
        return self._solution

    def solve(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    # ------------------------------------------------------------- internals
    def _tensor(self, a) -> torch.Tensor:
        """A host array on the solver's device in its dtype."""
        return torch.tensor(np.asarray(a), dtype=self._dtype,
                            device=self._device)

    def _setup_space(self):
        import os

        # NS_QUAD_DEGREE: volume quadrature sensitivity knob (degree 6 is
        # exact for every affine-cell form in the suite)
        deg = int(os.environ.get("NS_QUAD_DEGREE", "6"))
        with timed_region(self.monitor, "setup_space"):
            self._space = TaylorHoodSpace(self._mesh,
                                          periodic=self._periodic,
                                          quadrature_degree=deg)
        print("Number of cells {0}, number of DoFs: {1}".format(
            self._n_cells, self._space.n_dofs))

    def _setup_operator(self):
        self._operator = MixedOperator(
            self._space, self._form_convective_term, self._form_viscous_term,
            with_coriolis=self._angular_velocity is not None,
            device=self._device, dtype=self._dtype)

    def _compile_boundary_conditions(self):
        """Dirichlet data, pressure pinning policy, traction batches."""
        self._dirichlet, self._mean_pressure_value = compile_dirichlet_bcs(
            self._space, self._boundary_markers, self._velocity_bcs,
            self._pressure_bcs)

        bc_dofs = self._dirichlet.dofs
        # pressure nullspace: a constant pressure mode exists iff the test
        # space carries no normal velocity anywhere on the boundary (fully
        # enclosed/periodic flow) and no pressure Dirichlet BC is set.
        #
        # Direct (dense/LU) solves pin one pressure dof for a nonsingular
        # matrix (the reference leans on LU pivoting luck there).  The
        # matrix-free Krylov path must NOT pin: replacing one continuity
        # equation makes the pinned direction ill-conditioned as O(N) --
        # float32 round-off then parks residual exactly there and the
        # preconditioned Krylov cannot remove it (measured: refinement
        # stalls with lres = 0.9999).  Instead the singular-but-consistent
        # system is solved in the mean-free pressure subspace (the PCD
        # preconditioner projects; compatibility sum(r_p) = -flux(BC) = 0
        # keeps the null direction empty) and the pressure is gauged to
        # p[gauge] = 0 after the solve.
        self._pressure_pin_dof = None
        self._pressure_gauge_dof = None
        if not any(bc[0] in (PressureBCType.constant, PressureBCType.function)
                   for bc in self._pressure_bcs) \
                and self._boundary_fully_normal_constrained():
            gauge = int(self._space.pressure_offset)
            self._pressure_gauge_dof = gauge
            if self._resolved_linear_mode() != "pcd":
                self._pressure_pin_dof = gauge
                bc_dofs = np.unique(np.concatenate(
                    [bc_dofs, [gauge]])).astype(np.int32)
        self._bc_dofs_all = bc_dofs
        self._operator.set_bc_dofs(bc_dofs)

        # traction batches
        self._traction_batches = []
        for bc in self._traction_bcs:
            if bc[0] is TractionBCType.free:
                continue
            if len(bc) == 3:
                bc_type, bndry_id, value = bc
                component = None
            else:
                bc_type, bndry_id, component, value = bc
            facet_ids = self._boundary_markers.ids_with_value(bndry_id)
            assert len(facet_ids) > 0
            batch = self._space.facet_batch(facet_ids)
            dev = self._operator.facet_batch_device(batch)
            self._traction_batches.append(
                dict(batch=dev, x=batch["x"], value=value,
                     component=component,
                     time_dependent=callable(value),
                     host=dict(weights=np.asarray(batch["weights"],
                                                  dtype=np.float64),
                               N2=np.asarray(batch["N2"],
                                             dtype=np.float64),
                               cells=np.asarray(batch["cells"]))))

    def _resolved_linear_mode(self) -> str:
        """The linear-solver mode this solver will actually use."""
        mode = getattr(self, "_linear_solver", None)
        if mode is not None:
            return mode
        return _auto_linear_mode(self._space.n_dofs, self._device)

    def _gauge_pressure(self, x):
        """Shift the pressure so p[gauge] = 0 (enclosed, unpinned path)."""
        if self._pressure_gauge_dof is None or \
                self._pressure_pin_dof is not None:
            return x
        g = x[self._pressure_gauge_dof]
        n_u = self._space.n_velocity_dofs
        return torch.cat([x[:n_u], x[n_u:] - g])

    def _boundary_fully_normal_constrained(self) -> bool:
        """True if every exterior boundary id constrains the normal velocity
        (via a full-vector or no-normal-flux BC) or is periodic."""
        from navierstokes_tpu_torch.mesh.core import extract_all_boundary_markers

        normal_constraining = (VelocityBCType.no_slip,
                               VelocityBCType.no_normal_flux,
                               VelocityBCType.constant,
                               VelocityBCType.function)
        covered = {bc[1] for bc in self._velocity_bcs
                   if bc[0] in normal_constraining}
        covered |= set(self._constrained_boundary_ids)
        all_ids = extract_all_boundary_markers(self._mesh,
                                               self._boundary_markers)
        return all_ids <= covered

    def _bc_values(self, t=None) -> torch.Tensor:
        """Aligned values for operator.bc_dofs (pin rows carry 0)."""
        vals = self._dirichlet.values(t)
        full = np.zeros(len(self._bc_dofs_all))
        pos = np.searchsorted(self._bc_dofs_all, self._dirichlet.dofs)
        full[pos] = vals
        return self._tensor(full)

    def _traction_extra_ru(self, t=None):
        """Sum of traction contributions, or None."""
        if not self._traction_batches:
            return None
        total = None
        for tb in self._traction_batches:
            x = tb["x"]                           # (nf, nq, dim) host coords
            nf, nq, dim = x.shape
            if tb["component"] is None:
                vals = _eval_field(tb["value"], x.reshape(-1, dim), t, dim)
                t_q = vals.reshape(nf, nq, dim)
            else:
                vals = _eval_field(tb["value"], x.reshape(-1, dim), t, None)
                t_q = np.zeros((nf * nq, dim))
                t_q[:, tb["component"]] = np.asarray(vals).reshape(-1)
                t_q = t_q.reshape(nf, nq, dim)
            contrib = self._operator.traction_residual(
                tb["batch"], self._tensor(t_q))
            total = contrib if total is None else total + contrib
        return total

    def _traction_extra_ru_f64(self, t=None):
        """Float64 host evaluation of the traction boundary integral
        (same math as :meth:`_traction_extra_ru`, NumPy f64) -- the
        high-precision half of mixed-precision refinement must not
        inherit float32 rounding from the device vector."""
        if not self._traction_batches:
            return None
        space = self._space
        cu = np.asarray(space.cell_unodes)
        total = np.zeros((space.n_unodes, space.dim))
        for tb in self._traction_batches:
            x = tb["x"]
            nf, nq, dim = x.shape
            if tb["component"] is None:
                vals = _eval_field(tb["value"], x.reshape(-1, dim), t, dim)
                t_q = np.asarray(vals, dtype=np.float64).reshape(nf, nq,
                                                                 dim)
            else:
                vals = _eval_field(tb["value"], x.reshape(-1, dim), t,
                                   None)
                t_q = np.zeros((nf * nq, dim))
                t_q[:, tb["component"]] = np.asarray(
                    vals, dtype=np.float64).reshape(-1)
                t_q = t_q.reshape(nf, nq, dim)
            h = tb["host"]
            r_c = np.einsum("fq,fqd,fqi->fid", h["weights"], t_q, h["N2"])
            np.add.at(total, cu[h["cells"]].ravel(),
                      r_c.reshape(-1, dim))
        return total

    def _momentum_source(self, t=None, extra_quad=None):
        """u-independent momentum source at quadrature points, or 0.0.

        Combines -c_f * body_force and the Euler acceleration
        c_e * d(omega)/dt x r (reference: ns_solver_base.py:158-211);
        ``extra_quad`` lets transient solvers add the BDF history term.
        """
        coeffs = self._equation_coefficients
        source = None
        if self._body_force is not None:
            cf = coeffs["body_force_term"]
            assert cf is not None, "body force requires Fr"
            xq = self._space.quad_coords()
            nc, nq, dim = xq.shape
            f = _eval_field(self._body_force, xq.reshape(-1, dim), t, dim)
            source = -cf * f.reshape(nc, nq, dim)
        if self._angular_velocity is not None:
            alpha = self._angular_velocity.derivative
            if alpha is not None:
                ce = coeffs["euler_term"]
                xq = self._space.quad_coords()
                if self._space_dim == 2:
                    euler = ce * float(alpha) * np.stack(
                        [-xq[..., 1], xq[..., 0]], axis=-1)
                else:
                    a = np.asarray(alpha)
                    euler = ce * np.cross(np.broadcast_to(a, xq.shape), xq)
                source = euler if source is None else source + euler
        if source is not None and extra_quad is not None:
            source = self._tensor(source) + extra_quad
        elif source is not None:
            source = self._tensor(source)
        elif extra_quad is not None:
            source = extra_quad
        return 0.0 if source is None else source

    def _scalars(self):
        """Coefficient dict for the element kernels."""
        coeffs = self._equation_coefficients
        scalars = {
            "cc": coeffs["convective_term"],
            "cv": coeffs["viscous_term"],
            "cp": coeffs["pressure_term"],
            "accel0": 0.0,
        }
        if self._angular_velocity is not None:
            c_cor = coeffs["coriolis_term"]
            omega = self._angular_velocity.value
            if self._space_dim == 2:
                scalars["cor"] = 2.0 * c_cor * float(omega)
            else:
                scalars["cor"] = 2.0 * c_cor * self._tensor(omega)
        return scalars

    def _apply_bc_values_to_x(self, x, t=None):
        x = x.clone()
        x[self._operator.bc_dofs] = self._bc_values(t)
        return x

    def _store_residual_context(self, scalars, source_q, extra_ru):
        self._last_residual_context = (scalars, source_q, extra_ru)

    def boundary_reaction_force(self, bndry_id):
        """Force exerted on a Dirichlet boundary, via nodal reactions.

        The raw (un-masked) assembled momentum residual at constrained
        velocity nodes equals minus the discrete force the boundary
        exerts on the fluid; summing it over the boundary's nodes and
        negating yields a superconvergent drag/lift evaluation (the
        variational "reaction force" method -- markedly more accurate
        than the direct traction integral the reference demo assembles,
        demo/dfg_benchmark.py:54-61).
        """
        assert hasattr(self, "_last_residual_context"), \
            "solve() must run before evaluating reaction forces"
        scalars, source_q, extra_ru = self._last_residual_context
        zeros = torch.zeros(len(self._bc_dofs_all), dtype=self._dtype,
                            device=self._device)
        r = self._operator.residual(self.solution, zeros, scalars,
                                    source_q, extra_ru, mask_bcs=False)
        r_u = r[:self._space.n_velocity_dofs].cpu().numpy().reshape(
            -1, self._space_dim)
        facet_ids = self._boundary_markers.ids_with_value(bndry_id)
        nodes = np.asarray(self._space.facet_unodes(facet_ids))
        return -r_u[nodes].sum(axis=0)
