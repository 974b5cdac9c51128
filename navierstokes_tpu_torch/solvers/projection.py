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
  tolerance-controlled CG with per-step residual monitoring;
* a mesh that no banded format holds (the engine raises
  ``StructureError``, recorded as ``fastop_fallback``) takes the cell-loop
  step (``solvers/fused_step.py`` over ``parallel/sharded.py``'s
  element-matrix operators), with the same boundary data and monitoring;
* with a ``device_mesh`` of more than one shard, the spectral step runs
  slab-sharded (``structured/spectral.shard_spectral_step``) and every
  other mesh takes the domain-decomposed halo step
  (``solvers/halo_step.py`` over ``parallel/halo.py``), its state
  partitioned over the shards.

``solve()`` is one eager step.  On the banded path with fixed iteration
counts and Dirichlet data that do not read the time,
:meth:`ProjectionSolver.captured_step` gives the step as a function of its
tensors alone, with the nodal reaction force on a boundary computed on
the device every step, for ``utils/graph.ChunkLoop`` to run in chunks (one
CUDA graph replay each).

Scheme: semi-implicit incremental pressure correction with variable-step
BDF weights alpha from ``BDFTimeStepping`` and matching extrapolation
weights eta = (1 + omega, -omega).
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
from navierstokes_tpu_torch.parallel.comm import as_mesh
from navierstokes_tpu_torch.parallel.halo import HaloCellOperator
from navierstokes_tpu_torch.parallel.sharded import (ShardedCellOperator,
                                                     device_mesh)
from navierstokes_tpu_torch.solvers.halo_step import \
    build_halo_projection_step
from navierstokes_tpu_torch.solvers.fused_step import build_projection_step
from navierstokes_tpu_torch.solvers.planar_step import \
    build_planar_projection_step
from navierstokes_tpu_torch.solvers.transient import InstationarySolverBase
from navierstokes_tpu_torch.structured import (NotStructured,
                                               PeriodicStructuredTH,
                                               build_spectral_projection_step)
from navierstokes_tpu_torch.structured.spectral import shard_spectral_step
from navierstokes_tpu_torch.timestepping import BDFTimeStepping
from navierstokes_tpu_torch.timestepping.bdf import (bdf1_weights_d1,
                                                     bdf2_weights_d1)
from navierstokes_tpu_torch.utils import monitor
from navierstokes_tpu_torch.utils.monitor import timed_region


class ProjectionSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=None,
                 form_viscous_term="reduced", linear_solver=None,
                 cg_iters=None, cg_rtol=1e-8,
                 prefer_spectral=True, device_mesh=None,
                 poisson_precond="amg", rotational=False, *,
                 device=None, dtype=None):
        """``device_mesh``: a ``parallel.comm.DeviceMesh`` (or a plain
        sequence of devices) with more than one shard routes the step
        through the multi-device layer: the slab-sharded spectral step on
        a periodic enclosed mesh, the domain-decomposed halo step
        (``parallel/halo.py`` + ``solvers/halo_step.py``) otherwise.  The
        canonical state then lives on shard 0's device, which ``device``
        must be if given.

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
        device_mesh = as_mesh(device_mesh)
        if device_mesh is not None and len(device_mesh) > 1:
            if device is None:
                device = device_mesh.devices[0]
            elif torch.device(device) != device_mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's shard "
                                 f"0 ({device_mesh.devices[0]})")
        else:
            device_mesh = None
        self._device_mesh = device_mesh
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
                    self._setup_spectral_step(
                        PeriodicStructuredTH(self._space))
                except NotStructured as exc:
                    refusal = exc
                else:
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
        step, init_state, read_state = build_spectral_projection_step(
            sgrid, visc=self._visc, dt=k0, dtype=self._dtype,
            device=self._device)
        if self._device_mesh is not None:
            # slab-sharded over the mesh (raises NotStructured when the
            # grid's axis 1 does not divide the shard count): the state
            # is built whole, then split into slabs, and read whole
            sharded, shard_state = shard_spectral_step(
                step, sgrid, self._device_mesh)
            whole_init, whole_read = init_state, read_state

            def init_state(*flat):
                return shard_state(whole_init(*flat))

            def read_state(states):
                return whole_read(sharded.gather_state(states))

            step = sharded
        self._sgrid = sgrid
        self._spectral = (step, init_state, read_state)
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
        if self._device_mesh is not None:
            self._setup_halo_step(vel_bc, pres_mask, k0)
        else:
            try:
                self._setup_fast_step(vel_bc, pres_mask, k0)
            except StructureError as exc:
                # only the engine's own refusal falls back, and visibly
                self.monitor.record("fastop_fallback", reason=str(exc))
                self._setup_cell_loop_step(vel_bc, pres_mask, k0)
        self._body_rhs = None
        if self._has_body_force():
            self._body_rhs = self._convert_body_rhs(
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

    def _setup_cell_loop_step(self, vel_bc, pres_mask, k0):
        """Per-cell gather/scatter step: the fallback for meshes the
        banded formats cannot hold."""
        with timed_region(self.monitor, "setup_engine"):
            ops = ShardedCellOperator(self._space, device_mesh(
                1, device=self._device), dtype=self._dtype)
        self._ops = ops
        self._fused = build_projection_step(
            self._space, ops, visc=self._visc, dt=k0,
            cg_iters=self._cg_iters_user or (40, 400, 20),
            vel_bc=vel_bc, pres_bc_mask=pres_mask,
            conv_coeff=self._conv_coeff, cg_rtol=self._cg_rtol,
            with_residuals=True)
        self._step_kind = "generic"

    def _setup_halo_step(self, vel_bc, pres_mask, k0):
        """Domain-decomposed step: state partitioned over the mesh's
        shards, halo exchange per matvec."""
        with timed_region(self.monitor, "setup_engine"):
            hops = HaloCellOperator(self._space, self._device_mesh,
                                    dtype=self._dtype)
        self._hops = hops
        self._halo_step = build_halo_projection_step(
            hops, visc=self._visc, dt=k0,
            cg_iters=self._cg_iters_user or (40, 400, 20),
            vel_bc=vel_bc, pres_bc_mask=pres_mask,
            conv_coeff=self._conv_coeff, cg_rtol=self._cg_rtol,
            with_residuals=True)
        self._step_kind = "halo"
        self._sync_halo_from_canonical()

    def _sync_halo_from_canonical(self):
        hops = self._hops
        self._uh = hops.pad_velocity(self._u)
        self._uh_old = hops.pad_velocity(self._u_old)
        self._ph = hops.pad_pressure(self._p)
        self._phih = hops.pad_pressure(self._phi)

    def _convert_body_rhs(self, body_rhs_flat):
        if self._step_kind == "fast":
            return self._fast.interleaved_to_planar(body_rhs_flat)
        if self._step_kind == "halo":
            return self._hops.pad_velocity(self._tensor(body_rhs_flat))
        return self._tensor(body_rhs_flat)

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
        elif kind == "halo":
            self._sync_halo_from_canonical()

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
        elif self._step_kind == "fast":
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
        elif self._step_kind == "halo":
            hops = self._hops
            bc_values = None
            if len(self._v_dofs):
                vals_flat = np.zeros(space.n_velocity_dofs)
                vals_flat[self._v_dofs] = np.asarray(
                    self._vel_dirichlet.values(next_time))
                bc_values = hops.pad_velocity(self._tensor(vals_flat))
            uh_new, ph_new, phih, res = self._halo_step(
                self._uh, self._uh_old, self._ph, self._phih, alpha, eta,
                bc_values=bc_values, k=k, body_rhs=self._body_rhs)
            self.monitor.record("linear_solve", residual=torch.max(res),
                                residuals=res, label="projection-cg-halo")
            self._uh_old, self._uh = self._uh, uh_new
            self._ph, self._phih = ph_new, phih
            # canonical (space-numbering) mirrors
            self._u_old2, self._u_old = self._u_old, self._u
            self._u = hops.unpad_velocity(uh_new)
            self._p = hops.unpad_pressure(ph_new)
            self._phi = hops.unpad_pressure(phih)
        else:
            bc_values = None
            if len(self._v_dofs):
                vals_flat = np.zeros(space.n_velocity_dofs)
                vals_flat[self._v_dofs] = np.asarray(
                    self._vel_dirichlet.values(next_time))
                bc_values = self._tensor(vals_flat)
            u_new, p_new, phi, res = self._fused(
                self._u, self._u_old, self._p, self._phi, alpha, eta,
                bc_values=bc_values, k=k, body_rhs=self._body_rhs)
            self.monitor.record("linear_solve", residual=torch.max(res),
                                residuals=res, label="projection-cg")
            self._u_old2, self._u_old = self._u_old, self._u
            self._u = u_new
            self._p, self._phi = p_new, phi

        self._solutions[0] = space.join(
            self._u.reshape(space.n_unodes, space.dim), self._p)

    @property
    def solution(self):
        self._solutions[0] = self._space.join(
            self._u.reshape(self._space.n_unodes, self._space.dim),
            self._p)
        return self._solutions[0]

    # -- captured stepping -------------------------------------------------
    def captured_step(self, reaction_boundary, reaction_scale=1.0):
        """``(step, state)``: the banded step as a function of its tensors
        alone, ``state = step(state)``, for ``utils/graph.ChunkLoop``.

        ``state`` is ``(u, u_old, p, phi, force)``: the first four in the
        engine's planar permuted layout (``FastTaylorHood``), taken from
        the solver's current state; ``force``, ``reaction_scale`` times the
        nodal reaction force on the boundary ``reaction_boundary``
        (:meth:`boundary_reaction_force`) after each step, (c_D, c_L) of
        a flow past a body with the scale 2 / (rho U^2 D).  It starts as
        the force of the current state at the step's weights.  The step
        equals ``solve()`` with constant-step weights: the BDF weights,
        the extrapolation and the step size are fixed here, the velocity
        Dirichlet values were uploaded at set-up, and nothing is read on
        the host.  The force's device work is the phase
        ``reaction_force``.  The solver's own state and its time stepping
        stay where the call found them.

        Refused (``ValueError``) on another path than the banded one,
        with ``cg_rtol`` (its stopping test reads a norm on the host every
        iteration), with velocity Dirichlet data declared as a function of
        the time (``f(x, t)``, whose values ``solve()`` evaluates anew
        every step), before the first step (SBDF-1) and when the next
        step size is not the last one."""
        if not self._setup_done:
            self._setup_problem()
        if self._step_kind != "fast":
            raise ValueError(f"captured_step runs the banded step; this "
                             f"solver runs the {self._step_kind!r} step")
        if self._cg_rtol is not None:
            raise ValueError(
                f"captured_step needs fixed iteration counts: cg_rtol "
                f"{self._cg_rtol!r} stops each solve on a residual norm "
                f"read on the host; pass cg_rtol=None")
        if self._vel_dirichlet.reads_time:
            raise ValueError(
                "captured_step uploads the velocity Dirichlet values once: "
                "a boundary condition declared as a function of the time "
                "(f(x, t)) needs solve()")
        ts = self._time_stepping
        k = ts.get_next_step_size()
        if ts.step_number < 1 or \
                abs(ts.get_previous_step_size() - k) > 1e-9 * k:
            raise ValueError(
                "captured_step takes constant steps: take the first step "
                "and any change of the step size with solve()")
        # the constant-step weights of the time stepping's order
        alpha = bdf2_weights_d1(1.0) if len(ts.coefficients(1)) > 2 \
            else bdf1_weights_d1() + (0.0,)
        eta = (2.0, -1.0)
        fast, fast_step, body_rhs = self._fast, self._fast_step, \
            self._body_rhs

        def advance(u, u_old, p, phi):
            return fast_step(u, u_old, p, phi, alpha, eta, bc_values=None,
                             k=k, body_rhs=body_rhs)[:3]

        reaction = self._reaction(reaction_boundary, alpha, k)
        scale = float(reaction_scale)

        def force(u, u_old, u_old2, p):
            with monitor.phase("reaction_force"):
                return scale * reaction(
                    *(fast.planar_to_interleaved(v) for v in (u, u_old,
                                                              u_old2)),
                    fast.unpermute_pressure(p))

        def step(state):
            u, u_old, p, phi, _ = state
            u_new, p_new, phi_new = advance(u, u_old, p, phi)
            return (u_new, u, p_new, phi_new, force(u_new, u, u_old, p_new))

        # the force of the current state at the step's weights, through
        # the step's own calls: their index tensors and the operator's
        # tables are made here, before any capture
        f0 = force(self._u2, self._u2_old,
                   fast.interleaved_to_planar(self._u_old2), self._p2)
        return step, (self._u2, self._u2_old, self._p2, self._phi2, f0)

    # -- postprocessing ----------------------------------------------------------
    def _reaction(self, bndry_id, alpha, k):
        """``force(u, u_old, u_old2, p)``: the nodal reaction on boundary
        ``bndry_id`` of the interleaved velocity levels and the pressure
        in the space's numbering, with BDF weights ``alpha`` and step
        ``k`` (Python numbers: constants of the function)."""
        assert self._step_kind in ("generic", "fast"), \
            "reaction forces need a Dirichlet boundary (generic/fast path)"
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
        a0, a1, a2 = alpha
        scalars = dict(self._scalars())
        scalars["accel0"] = a0 / k

        def force(u, u_old, u_old2, p):
            hist = (a1 / k) * op.u_at_quad(u_old.reshape(-1, dim)) \
                + (a2 / k) * op.u_at_quad(u_old2.reshape(-1, dim))
            r = op.residual(torch.cat([u, p]), None, scalars, hist,
                            mask_bcs=False)
            r_u = r[:space.n_velocity_dofs].reshape(-1, dim)
            return -r_u[nodes].sum(dim=0)

        return force

    def boundary_reaction_force(self, bndry_id):
        """Nodal-reaction drag/lift (see SolverBase.boundary_reaction_force):
        the monolithic momentum residual is evaluated un-masked at the
        current projection state (u_{n+1}, u_n, u_{n-1}, alpha).  Returns
        a (dim,) tensor on the solver's device without waiting for it.
        """
        a = [float(v) for v in self._alpha[:3]]
        force = self._reaction(bndry_id, tuple(a + [0.0] * (3 - len(a))),
                               float(self._next_step_size))
        return force(self._u, self._u_old, self._u_old2, self._p)
