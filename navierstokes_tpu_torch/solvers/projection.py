"""ProjectionSolver: the fast projection steps behind the product solver
API (counterpart of ``navierstokes_tpu/solvers/projection.py``).

An application built on the documented solver hooks (boundary conditions,
equation coefficients, initial conditions, ``solve()`` per step) reaches
the same step functions as the benchmark scripts:

* on a fully periodic structured mesh with a mean-pressure constraint it
  lowers to the spectral class-grid step (``structured/spectral.py`` --
  exact DFT solves, no Krylov iteration);
* on any other mesh the banded engine can hold it lowers to the planar
  SBDF projection step (``solvers/planar_step.py``) with Dirichlet masks,
  per-step time-dependent BC values, a variable step size, and
  tolerance-controlled CG with per-step residual monitoring.

Scheme: semi-implicit incremental pressure correction with variable-step
BDF weights alpha from ``BDFTimeStepping`` and matching extrapolation
weights eta = (1 + omega, -omega).

Not ported yet: the domain-decomposed halo step (``device_mesh`` with more
than one device, ROADMAP item 15) and the per-cell fallback step for
meshes no banded format can hold (ROADMAP item 14); both raise
``NotImplementedError``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from navierstokes_tpu_torch.assembly.fastop import (FastTaylorHood,
                                                    StructureError)
from navierstokes_tpu_torch.fem.bcs import PressureBCType
from navierstokes_tpu_torch.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu_torch.fem.spaces import _eval_field
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.structured import (NotStructured,
                                               PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.timestepping import BDFTimeStepping
from navierstokes_tpu_torch.utils.monitor import timed_region


class ProjectionSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=None,
                 form_viscous_term="reduced", linear_solver=None,
                 cg_iters=None, cg_rtol=1e-8,
                 prefer_spectral=True, device_mesh=None,
                 poisson_precond="amg", rotational=False, *,
                 device=None, dtype=None):
        """``device_mesh``: a sequence of devices for the domain-decomposed
        multi-device step; more than one device is not ported yet.

        ``poisson_precond``: "amg" (default) preconditions the banded
        step's pressure Poisson with a smoothed-aggregation V-cycle --
        the cg_rtol stopping then triggers after O(10) iterations instead
        of O(100) Jacobi sweeps; ``None`` reverts.  (The spectral path
        ignores it: its solve is exact.)

        ``rotational``: Timmermans/Guermond rotational pressure update on
        the banded path (p += phi - nu div u*; see
        solvers/planar_step.py).

        ``device`` / ``dtype``: where and in which precision the state
        lives (default: the card, ``config.default_dtype``; the CPU only
        with ``device="cpu"``)."""
        assert isinstance(time_stepping, BDFTimeStepping)
        if device_mesh is not None and len(device_mesh) > 1:
            raise NotImplementedError(
                "the domain-decomposed step over several devices is not "
                "ported yet (ROADMAP item 15)")
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter or 50,
                         form_viscous_term, linear_solver,
                         device=device, dtype=dtype)
        self._cg_iters_user = None if cg_iters is None else tuple(cg_iters)
        self._cg_rtol = cg_rtol
        self._prefer_spectral = prefer_spectral
        self._poisson_precond = poisson_precond
        self._rotational = bool(rotational)
        self._reaction_nodes = {}

    # -- setup ----------------------------------------------------------------
    def _setup_function_spaces(self):
        super()._setup_function_spaces()
        space = self._space
        self._u = self._zeros(space.n_velocity_dofs)
        self._u_old = self._zeros(space.n_velocity_dofs)
        self._u_old2 = self._zeros(space.n_velocity_dofs)
        self._p = self._zeros(space.n_pnodes)
        self._phi = self._zeros(space.n_pnodes)

    def _setup_scheme(self):
        space = self._space
        coeffs = self._equation_coefficients
        assert coeffs.get("coriolis_term") is None \
            and coeffs.get("euler_term") is None \
            and getattr(self, "_angular_velocity", None) is None, \
            "ProjectionSolver does not support rotating frames"
        self._visc = float(coeffs["viscous_term"])
        self._conv_coeff = float(coeffs.get("convective_term") or 0.0)
        cp = coeffs.get("pressure_term", 1.0)
        assert cp in (None, 1.0), "pressure_term must be 1 (rescale p)"

        self._vel_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, self._velocity_bcs, ())
        pres_bcs = [bc for bc in self._pressure_bcs
                    if bc[0] is not PressureBCType.mean_value]
        self._pres_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, (), pres_bcs)
        mean_constrained = len(pres_bcs) < len(self._pressure_bcs) \
            or not self._pressure_bcs

        v_dofs = np.asarray(self._vel_dirichlet.dofs, dtype=np.int64)
        periodic_enclosed = (len(v_dofs) == 0 and mean_constrained
                             and len(self._pres_dirichlet.dofs) == 0)

        if self._prefer_spectral and periodic_enclosed \
                and not self._has_body_force():
            # only the structured detector's own refusals downgrade to the
            # banded step; a downgrade costs a large factor in throughput,
            # so it is warned about and left in the monitor.  Anything
            # else propagates.
            refusal = None
            if self._conv_coeff != 1.0:
                # the spectral convection uses coefficient 1
                refusal = ValueError(
                    "spectral path assumes convective_term == 1")
            else:
                try:
                    sgrid = PeriodicStructuredTH(self._space)
                except NotStructured as exc:
                    refusal = exc
                else:
                    self._setup_spectral_step(sgrid)
                    return
            msg = (f"spectral fast path unavailable "
                   f"({type(refusal).__name__}: {refusal}); falling back "
                   f"to the banded projection step")
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            self.monitor.record("spectral_fallback", reason=str(refusal),
                                exc_type=type(refusal).__name__)
        self._setup_generic_step(v_dofs, mean_constrained)

    def _has_body_force(self):
        return getattr(self, "_body_force", None) is not None

    def _setup_spectral_step(self, sgrid):
        k0 = self._time_stepping.get_next_step_size()
        self._sgrid = sgrid
        self._spectral = build_spectral_projection_step(
            sgrid, visc=self._visc, dt=k0, dtype=self._dtype,
            device=self._device)
        self._spectral_state = None
        self._step_kind = "spectral"

    def _setup_generic_step(self, v_dofs, mean_constrained):
        space = self._space
        n_u = space.n_velocity_dofs
        vel_bc = None
        if len(v_dofs):
            mask = np.zeros(n_u, bool)
            mask[v_dofs] = True
            vals = np.zeros(n_u)
            vals[v_dofs] = np.asarray(self._vel_dirichlet.values())
            vel_bc = (mask, vals)

        pres_mask = None
        if not mean_constrained or len(self._pres_dirichlet.dofs):
            ranks = (np.asarray(self._pres_dirichlet.dofs, dtype=np.int64)
                     - space.pressure_offset)
            if len(ranks) == 0:
                ranks = np.array([0], dtype=np.int64)   # pin for solvability
            pres_mask = np.zeros(space.n_pnodes, bool)
            pres_mask[ranks] = True

        k0 = self._time_stepping.get_next_step_size()
        self._v_dofs = v_dofs
        try:
            self._setup_fast_step(vel_bc, pres_mask, k0)
        except StructureError as exc:
            self.monitor.record("fastop_fallback", reason=str(exc))
            raise NotImplementedError(
                "no banded format holds this mesh, and the per-cell "
                "fallback step (solvers/fused_step.py) is not ported yet "
                "(ROADMAP item 14)") from exc
        self._body_rhs = None
        if self._has_body_force():
            self._body_rhs = self._fast.interleaved_to_planar(
                self._assemble_body_rhs())

    def _setup_fast_step(self, vel_bc, pres_mask, k0):
        """Gather-free banded engine (assembly/fastop.py)."""
        space = self._space
        with timed_region(self.monitor, "setup_engine"):
            fast = FastTaylorHood(space, dtype=self._dtype,
                                  device=self._device)
        self._fast = fast

        def to_planar_mask(flat):
            m = np.asarray(flat).reshape(space.n_unodes, space.dim).T
            return m[:, fast.permU]

        p_vel_bc = None
        if vel_bc is not None:
            p_vel_bc = (to_planar_mask(vel_bc[0]), to_planar_mask(vel_bc[1]))
        p_pres_mask = None
        if pres_mask is not None:
            p_pres_mask = np.asarray(pres_mask)[fast.permP]
        # the step's own setup is the Poisson preconditioner's hierarchy
        with timed_region(self.monitor, "setup_poisson_precond"):
            self._fast_step = build_planar_projection_step(
                fast, visc=self._visc, dt=k0,
                cg_iters=self._cg_iters_user or (
                    # the V-cycle makes 40 Poisson iterations (behind the
                    # cg_rtol early exit) worth ~400 Jacobi sweeps
                    (40, 40, 20) if self._poisson_precond
                    else (40, 400, 20)),
                vel_bc=p_vel_bc, pres_bc_mask=p_pres_mask,
                conv_coeff=self._conv_coeff, cg_rtol=self._cg_rtol,
                with_residuals=True, poisson_precond=self._poisson_precond,
                rotational=self._rotational)
        self._step_kind = "fast"
        self._sync_planar_from_canonical()

    def _sync_planar_from_canonical(self):
        fast = self._fast
        self._u2 = fast.interleaved_to_planar(self._u)
        self._u2_old = fast.interleaved_to_planar(self._u_old)
        self._p2 = fast.permute_pressure(self._p)
        self._phi2 = fast.permute_pressure(self._phi)

    def _sync_state_from_canonical(self):
        """Re-derive per-path device state from the canonical arrays
        (after initial conditions or a checkpoint restore)."""
        kind = getattr(self, "_step_kind", None)
        if kind == "spectral":
            self._spectral_state = None        # rebuilt lazily from _u
        elif kind == "fast":
            self._sync_planar_from_canonical()

    def _assemble_body_rhs(self, t=None):
        """Velocity-space load vector of the (steady or frozen-at-t) body
        force, int f . w, via the operator's quadrature tables."""
        space = self._space
        coeff = self._equation_coefficients.get("body_force_term") or 1.0
        xq = space.quad_coords()
        vals = _eval_field(self._body_force, xq.reshape(-1, space.dim), t,
                           space.dim)
        return self._operator.mass_rhs(coeff * vals.reshape(xq.shape))

    # -- initial conditions ----------------------------------------------------
    def set_initial_conditions(self, initial_conditions):
        super().set_initial_conditions(initial_conditions)
        u0, p0 = self._space.split(self._solutions[0])
        self._u = u0.reshape(-1)
        self._u_old = self._u
        self._u_old2 = self._u
        self._p = p0
        self._phi = torch.zeros_like(p0)
        self._sync_state_from_canonical()

    # -- stepping ---------------------------------------------------------------
    def _weights(self):
        """BDF weights (a0, a1, a2) and extrapolation weights, as floats."""
        ts = self._time_stepping
        alpha = [float(a) for a in self._alpha[:3]]
        alpha += [0.0] * (3 - len(alpha))
        if ts.step_number == 0:
            eta = (1.0, 0.0)
        else:
            omega = ts.get_next_step_size() / ts.get_previous_step_size()
            eta = (1.0 + omega, -omega)
        return tuple(alpha), eta

    def _solve_time_step(self, next_time):
        space = self._space
        alpha, eta = self._weights()
        k = float(self._next_step_size)

        if self._step_kind == "spectral":
            step, init_state, read_state = self._spectral
            if self._spectral_state is None:
                self._spectral_state = init_state(
                    self._u.cpu().numpy(), self._u_old.cpu().numpy(),
                    self._p.cpu().numpy())
            self._spectral_state = step(self._spectral_state, alpha, eta,
                                        k=k)
            u_flat, p = read_state(self._spectral_state)
            self._u_old2, self._u_old = self._u_old, self._u
            self._u = self._tensor(u_flat)
            self._p = self._tensor(p)
        else:
            fast = self._fast
            bc_values = None
            if len(self._v_dofs):
                vals_flat = np.zeros(space.n_velocity_dofs)
                vals_flat[self._v_dofs] = np.asarray(
                    self._vel_dirichlet.values(next_time))
                bc_values = self._tensor(
                    vals_flat.reshape(space.n_unodes, space.dim).T
                    [:, fast.permU])
            u2_new, p2_new, phi2, res = self._fast_step(
                self._u2, self._u2_old, self._p2, self._phi2, alpha, eta,
                bc_values=bc_values, k=k, body_rhs=self._body_rhs)
            # recorded as tensors: read (and waited for) only when a
            # record is asked for
            self.monitor.record("linear_solve", residual=torch.max(res),
                                residuals=res, label="projection-cg")
            self._u2_old, self._u2 = self._u2, u2_new
            self._p2, self._phi2 = p2_new, phi2
            # canonical (interleaved, space-numbering) mirrors
            self._u_old2, self._u_old = self._u_old, self._u
            self._u = fast.planar_to_interleaved(u2_new)
            self._p = fast.unpermute_pressure(p2_new)
            self._phi = fast.unpermute_pressure(phi2)

        self._solutions[0] = space.join(
            self._u.reshape(space.n_unodes, space.dim), self._p)

    @property
    def solution(self):
        self._solutions[0] = self._space.join(
            self._u.reshape(self._space.n_unodes, self._space.dim),
            self._p)
        return self._solutions[0]

    # -- postprocessing ----------------------------------------------------------
    def boundary_reaction_force(self, bndry_id):
        """Nodal-reaction drag/lift (see SolverBase.boundary_reaction_force):
        the monolithic momentum residual is evaluated un-masked at the
        current projection state (u_{n+1}, u_n, u_{n-1}, alpha).  Returns
        a (dim,) tensor on the solver's device without waiting for it.
        """
        assert self._step_kind == "fast", \
            "reaction forces need a Dirichlet boundary (the banded path)"
        assert not self._has_body_force(), \
            "reaction force with body forces: use SolverBase path"
        space = self._space
        op = self._operator
        dim = space.dim

        nodes = self._reaction_nodes.get(bndry_id)
        if nodes is None:
            facet_ids = self._boundary_markers.ids_with_value(bndry_id)
            nodes = self._reaction_nodes[bndry_id] = torch.as_tensor(
                np.asarray(space.facet_unodes(facet_ids), dtype=np.int64),
                device=self._device)

        a = [float(v) for v in self._alpha[:3]]
        a += [0.0] * (3 - len(a))
        k = float(self._next_step_size)
        scalars = dict(self._scalars())
        scalars["accel0"] = a[0] / k
        hist = (a[1] / k) * op.u_at_quad(self._u_old.reshape(-1, dim)) \
            + (a[2] / k) * op.u_at_quad(self._u_old2.reshape(-1, dim))
        r = op.residual(torch.cat([self._u, self._p]), None, scalars, hist,
                        mask_bcs=False)
        r_u = r[:space.n_velocity_dofs].reshape(-1, dim)
        return -r_u[nodes].sum(dim=0)
