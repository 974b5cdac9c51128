"""Application-facing problem classes: the hooks API, the time loop and
its IO (counterpart of ``navierstokes_tpu/problems/base.py``).

Applications subclass a Problem, override the ``setup_mesh`` / ``set_*``
/ ``postprocess_solution`` hooks and call ``solve_problem()``; the hook
order, the CFL monitoring (``_cfl_frequency``), field output and
checkpoints are the JAX package's.

The port adds keyword-only arguments the JAX classes do not need:
``device`` and ``dtype`` (where the solver's state lives: the card by
default, the CPU only when asked for) and ``solver_options`` (further
keywords of the solver class, e.g. ``cg_rtol`` or ``linear_solver``).
``_output_format`` picks the field-output format (None: XDMF when
``h5py`` imports, else PVD).
"""

from __future__ import annotations

import math
import os

import numpy as np

from navierstokes_tpu_torch.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu_torch.io.checkpoint import _to_numpy
from navierstokes_tpu_torch.io.output import (FieldWriter,
                                              write_boundary_markers)
from navierstokes_tpu_torch.problems import postprocess
from navierstokes_tpu_torch.problems.coefficients import \
    EquationCoefficientHandler
from navierstokes_tpu_torch.timestepping import BDFTimeStepping


class ProblemBase:
    _suffix = ".xdmf"
    # FieldWriter format: None = XDMF when h5py imports, else PVD
    _output_format = None

    def __init__(self, main_dir=None, *, device=None, dtype=None):
        if main_dir is None:
            self._main_dir = os.getcwd()
        else:
            assert os.path.exists(main_dir)
            self._main_dir = main_dir
        self._results_dir = os.path.join(self._main_dir, "results")
        self._additional_field_output = []
        self._writer = None
        self._write_output = True
        self._device = device
        self._dtype = dtype

    # -- hooks (overridden by applications) ---------------------------------
    def setup_mesh(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    def set_boundary_conditions(self):
        pass

    def set_equation_coefficients(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    def set_angular_velocity(self):
        pass

    def set_body_force(self):
        pass

    def set_internal_constraints(self):
        pass

    def set_periodic_boundary_conditions(self):
        pass

    def postprocess_solution(self):
        pass

    def solve_problem(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    # -- solution access ----------------------------------------------------
    def _get_solver(self):
        assert hasattr(self, "_navier_stokes_solver")
        return self._navier_stokes_solver

    def _get_velocity(self):
        solver = self._get_solver()
        u, _ = solver.space.split(solver.solution)
        return u

    def _get_pressure(self):
        solver = self._get_solver()
        _, p = solver.space.split(solver.solution)
        return p

    @property
    def space_dim(self):
        return self._space_dim

    # -- derived fields -----------------------------------------------------
    def _compute_vorticity(self):
        solver = self._get_solver()
        field = postprocess.vorticity_vertex_field(solver.operator,
                                                   self._get_velocity())
        return ("vorticity", field)

    def _compute_pressure_gradient(self):
        solver = self._get_solver()
        cellwise = _to_numpy(postprocess.pressure_gradient(
            solver.operator, self._get_pressure()))
        accum = np.zeros((self._mesh.n_vertices, self._space_dim))
        count = np.zeros(self._mesh.n_vertices)
        np.add.at(accum, self._mesh.cells.ravel(),
                  np.repeat(cellwise, self._space_dim + 1, axis=0))
        np.add.at(count, self._mesh.cells.ravel(), 1.0)
        return ("pressure gradient", accum / np.maximum(count, 1.0)[:, None])

    def _compute_stream_potential(self):
        solver = self._get_solver()
        bc_map = self._get_boundary_conditions_map()
        assert VelocityBCType.no_slip in bc_map
        from navierstokes_tpu_torch.mesh.core import \
            extract_all_boundary_markers

        other = extract_all_boundary_markers(self._mesh,
                                             self._boundary_markers)
        dirichlet_ids = set(bc_map[VelocityBCType.no_slip])
        other -= dirichlet_ids
        if VelocityBCType.no_normal_flux in bc_map:
            other -= set(bc_map[VelocityBCType.no_normal_flux])
        phi = postprocess.stream_potential(
            solver.operator, self._get_velocity(), self._boundary_markers,
            sorted(dirichlet_ids), sorted(other))
        return ("velocity potential", solver.space.vertex_pressure(phi))

    def _get_boundary_conditions_map(self, field="velocity"):
        assert hasattr(self, "_bcs")
        BCType = (VelocityBCType if field == "velocity" else PressureBCType)
        bc_map = {}
        for bc in self._bcs:
            bc_type, bndry_id = bc[0], bc[1]
            if not isinstance(bc_type, BCType):
                continue
            existing = set(bc_map.get(bc_type, ()))
            existing.add(bndry_id)
            bc_map[bc_type] = tuple(existing)
        return bc_map

    def _add_to_field_output(self, field):
        """``field``: (name, vertex-array) tuple."""
        assert isinstance(field, tuple) and len(field) == 2
        self._additional_field_output.append(field)

    # -- output -------------------------------------------------------------
    def _get_filename(self):
        assert hasattr(self, "_problem_name")
        assert hasattr(self, "_coefficient_handler")
        fname = (self._problem_name
                 + self._coefficient_handler.get_file_suffix() + self._suffix)
        return os.path.join(self._results_dir, fname)

    def _write_xdmf_file(self, current_time=0.0):
        if not self._write_output:
            return
        solver = self._get_solver()
        if self._writer is None:
            self._writer = FieldWriter(self._get_filename(), self._mesh,
                                       fmt=self._output_format)
        space = solver.space
        fields = {
            "velocity": space.vertex_velocity(self._get_velocity()),
            "pressure": space.vertex_pressure(self._get_pressure()),
        }
        for name, arr in self._additional_field_output:
            fields[name] = arr
        self._additional_field_output = []
        self._writer.write(float(current_time), fields)

    def write_boundary_markers(self):
        if not self._write_output:
            return
        assert hasattr(self, "_problem_name")
        os.makedirs(self._results_dir, exist_ok=True)
        path = os.path.join(self._results_dir,
                            self._problem_name + "_BoundaryMarkers.vtu")
        write_boundary_markers(path, self._mesh, self._boundary_markers)


class StationaryProblem(ProblemBase):
    """Stationary problem with a Reynolds continuation fallback:
    the hook sequence, the ``StationarySolver`` and -- on solver failure
    -- the mixed log/linear Reynolds ramp re-solve."""

    def __init__(self, main_dir=None, form_convective_term="standard",
                 tol=None, maxiter=50, tol_picard=1e-2, maxiter_picard=10,
                 *, device=None, dtype=None, solver_options=None):
        super().__init__(main_dir, device=device, dtype=dtype)
        self._form_convective_term = form_convective_term
        self._tol = tol
        self._maxiter = maxiter
        self._tol_picard = tol_picard
        self._maxiter_picard = maxiter_picard
        self._solver_options = dict(solver_options or {})
        self._p_deg = 1

    def solve_problem(self):
        self.setup_mesh()
        assert self._mesh is not None
        self._space_dim = self._mesh.dim
        self._n_cells = self._mesh.n_cells

        self.set_periodic_boundary_conditions()
        self.set_internal_constraints()
        self.set_angular_velocity()
        self.set_boundary_conditions()
        self.set_body_force()
        self.set_equation_coefficients()
        assert isinstance(self._coefficient_handler,
                          EquationCoefficientHandler)
        self._coefficient_handler.close()

        if not hasattr(self, "_bcs"):
            assert hasattr(self, "_periodic_bcs")
        if hasattr(self, "_internal_constraints"):
            assert hasattr(self, "_bcs")

        if not hasattr(self, "_navier_stokes_solver"):
            # imported here: the solvers import problems.rotation, and
            # this package's __init__ imports this module
            from navierstokes_tpu_torch.solvers.stationary import \
                StationarySolver

            self._navier_stokes_solver = StationarySolver(
                self._mesh, self._boundary_markers,
                self._form_convective_term, self._tol, self._maxiter,
                self._tol_picard, self._maxiter_picard, device=self._device,
                dtype=self._dtype, **self._solver_options)
        solver = self._navier_stokes_solver

        if hasattr(self, "_periodic_bcs"):
            solver.set_periodic_boundary_conditions(
                self._periodic_bcs, self._periodic_boundary_ids)
        if hasattr(self, "_angular_velocity"):
            solver.set_angular_velocity(self._angular_velocity)
        if hasattr(self, "_internal_constraints"):
            solver.set_boundary_conditions(self._bcs,
                                           self._internal_constraints)
        elif hasattr(self, "_bcs"):
            solver.set_boundary_conditions(self._bcs)
        solver.set_equation_coefficients(
            self._coefficient_handler.equation_coefficients)
        if hasattr(self, "_body_force"):
            solver.set_body_force(self._body_force)

        try:
            print("Solving problem")
            solver.solve()
            self.postprocess_solution()
            self._write_xdmf_file()
            return
        except (RuntimeError, AssertionError):
            pass

        # Reynolds parameter continuation
        print("Solving problem with parameter continuation...")
        final_re = self._coefficient_handler.Re
        assert final_re is not None
        log_range = np.logspace(np.log10(10.0), np.log10(final_re), num=8,
                                endpoint=True)
        lin_range = np.linspace(log_range[-2], final_re, num=8,
                                endpoint=True)
        for Re in np.concatenate((log_range[:-2], lin_range)):
            self._coefficient_handler.modify_dimensionless_number(
                "Re", float(Re))
            solver.set_equation_coefficients(
                self._coefficient_handler.equation_coefficients)
            print(f"Solving problem with Re = {Re:.2f}")
            solver.solve()

        self.postprocess_solution()
        self._write_xdmf_file()


class InstationaryProblem(ProblemBase):
    """A transient problem: BDF-2 time loop with CFL monitoring."""

    def __init__(self, main_dir=None, start_time=0.0, end_time=1.0,
                 form_convective_term="standard",
                 desired_start_time_step=0.1, n_max_steps=1000,
                 tol=None, maxiter=50, *, device=None, dtype=None,
                 solver_options=None):
        super().__init__(main_dir, device=device, dtype=dtype)
        self._form_convective_term = form_convective_term
        self._start_time = start_time
        self._end_time = end_time
        self._desired_start_time_step = desired_start_time_step
        self._n_max_steps = n_max_steps
        self._tol = tol
        self._maxiter = maxiter
        self._solver_options = dict(solver_options or {})
        self._adaptive_time_stepping = False
        self._postprocessing_frequency = 0
        self._output_frequency = 0
        self._checkpoint_frequency = 0
        self._p_deg = 1

    def set_initial_conditions(self):  # pragma: no cover
        raise NotImplementedError("You are calling a purely virtual method.")

    def set_solver_class(self, InstationarySolverClass):
        # imported here: the solvers import problems.rotation, and this
        # package's __init__ imports this module
        from navierstokes_tpu_torch.solvers.transient import \
            InstationarySolverBase

        assert issubclass(InstationarySolverClass, InstationarySolverBase)
        self._InstationarySolverClass = InstationarySolverClass

    def set_time_stepping(self, factory):
        """Override the default BDF-2 scheme: ``factory(start, end,
        desired_start_time_step)`` returning a DiscreteTime subclass."""
        self._time_stepping_factory = factory

    def _compute_cfl_number(self, step_size):
        solver = self._get_solver()
        cfl = postprocess.cfl_number(solver.operator, self._get_velocity(),
                                     step_size, degree=self._p_deg + 1)
        assert math.isfinite(cfl) and cfl >= 0.0
        print(f"Current CFL number = {cfl:6.2e}")
        return cfl

    def _set_next_step_size(self):
        ts = self._time_stepping
        next_step_size = ts.get_next_step_size()
        assert next_step_size > 0.0
        # the CFL evaluation costs a host read per step; when the run is
        # non-adaptive it is monitoring only, so honor _cfl_frequency
        # (default 1, every step)
        freq = getattr(self, "_cfl_frequency", 1)
        if not self._adaptive_time_stepping and freq > 1 \
                and ts.step_number % freq:
            return
        cfl = self._compute_cfl_number(next_step_size)
        if cfl > 1.0 and self._adaptive_time_stepping:
            ts.set_desired_next_step_size(next_step_size / cfl)

    def solve_problem(self):
        assert hasattr(self, "_InstationarySolverClass")

        self.setup_mesh()
        assert self._mesh is not None
        self._space_dim = self._mesh.dim
        self._n_cells = self._mesh.n_cells

        self.set_periodic_boundary_conditions()
        self.set_internal_constraints()
        self.set_angular_velocity()
        self.set_boundary_conditions()
        self.set_body_force()
        self.set_equation_coefficients()
        assert isinstance(self._coefficient_handler,
                          EquationCoefficientHandler)
        self._coefficient_handler.close()
        self.set_initial_conditions()

        if not hasattr(self, "_bcs"):
            assert hasattr(self, "_periodic_bcs")
        assert hasattr(self, "_initial_conditions")

        factory = getattr(self, "_time_stepping_factory", None)
        if factory is not None:
            self._time_stepping = factory(
                self._start_time, self._end_time,
                self._desired_start_time_step)
        else:
            self._time_stepping = BDFTimeStepping(
                self._start_time, self._end_time,
                desired_start_time_step=self._desired_start_time_step)

        if not hasattr(self, "_navier_stokes_solver"):
            self._navier_stokes_solver = self._InstationarySolverClass(
                self._mesh, self._boundary_markers,
                self._form_convective_term, self._time_stepping,
                self._tol, self._maxiter, device=self._device,
                dtype=self._dtype, **self._solver_options)
        solver = self._navier_stokes_solver

        solver.set_equation_coefficients(
            self._coefficient_handler.equation_coefficients)
        if hasattr(self, "_body_force"):
            solver.set_body_force(self._body_force)
        if hasattr(self, "_periodic_bcs"):
            solver.set_periodic_boundary_conditions(
                self._periodic_bcs, self._periodic_boundary_ids)
        if hasattr(self, "_angular_velocity"):
            solver.set_angular_velocity(self._angular_velocity)
        if hasattr(self, "_bcs"):
            if hasattr(self, "_internal_constraints"):
                solver.set_boundary_conditions(self._bcs,
                                               self._internal_constraints)
            else:
                solver.set_boundary_conditions(self._bcs)

        solver.set_initial_conditions(self._initial_conditions)
        self._write_xdmf_file(current_time=self._start_time)

        ts = self._time_stepping
        print(f"Solving problem until time = {ts.end_time:0.2f}")

        while not ts.is_at_end() and ts.step_number < self._n_max_steps:
            self._set_next_step_size()
            ts.update_coefficients()
            print(ts)
            solver.solve()
            if self._postprocessing_frequency > 0 and \
                    ts.step_number % self._postprocessing_frequency == 0:
                self.postprocess_solution()
            ts.advance_time()
            solver.advance_time()
            if hasattr(self, "_angular_velocity"):
                self._angular_velocity.set_time(ts.current_time)
            if self._output_frequency > 0 and \
                    ts.step_number % self._output_frequency == 0:
                self._write_xdmf_file(current_time=ts.current_time)
            if self._checkpoint_frequency > 0 and \
                    ts.step_number % self._checkpoint_frequency == 0:
                self.write_checkpoint()
        print(ts)

    def write_checkpoint(self):
        from navierstokes_tpu_torch.io.checkpoint import save_checkpoint

        os.makedirs(self._results_dir, exist_ok=True)
        path = os.path.join(self._results_dir,
                            f"{self._problem_name}_checkpoint.npz")
        save_checkpoint(path, self._get_solver(), self._time_stepping)
