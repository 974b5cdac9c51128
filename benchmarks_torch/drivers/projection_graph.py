"""Driver ``projection_graph``: the product solver API's step
(``solvers/projection.ProjectionSolver`` on its banded path, the object
that ``demo/dfg_benchmark_projection.py`` and users build) advanced in
``utils/graph.ChunkLoop`` chunks of ``ProjectionSolver.captured_step``,
with the nodal reaction force on the problem's body computed on the
device every step, one CUDA graph replay per chunk.

The problem's ``setup(cfg)`` gives the mesh, its markers, the solver's
boundary conditions and the reaction's boundary with its scale;
``initial_fields`` the seeded state ``(u, u_old, p)`` on the solver's
space, which is loaded through ``io/checkpoint`` into a solver whose
initial-condition hook took zero data.  The warm-up steps are the
solver's own ``solve()`` (the first one SBDF-1, the rest SBDF-2); then
the captured step (constant-step SBDF-2 weights, the Dirichlet values
uploaded once, no host reads) is captured through
``harness.common.GraphStepper``.  The state of a block is ``(u, u_old, p,
phi, force)``, the velocity planar in the engine's permuted order;
``reference_state`` gives the first four in the reference's numbering and
the program's ``force`` (c_D, c_L) as a fifth entry, which the problem's
guard ``force_gap`` holds against the reference's own nodal reaction of
the same state.  ``run_eager`` runs a block of the captured step eagerly
(the TF32 control).

Workload keys: ``chunk``, ``warmup_steps`` and ``segment_steps`` as for
``planar_graph``; ``cg_iters`` (Helmholtz, Poisson, mass) and
``poisson_precond`` (null or ``"amg"``), the solver's own; its
``cg_rtol`` is None."""

from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from harness.common import GraphStepper, lex_maps


class ProjectionGraph(GraphStepper):

    def __init__(self, ctx):
        from navierstokes_tpu_torch.io import (load_checkpoint,
                                               save_checkpoint)
        from navierstokes_tpu_torch.solvers import ProjectionSolver
        from navierstokes_tpu_torch.timestepping import BDFTimeStepping

        if not hasattr(ProjectionSolver, "captured_step"):
            raise SystemExit("projection_graph: this program's "
                             "ProjectionSolver has no captured_step")
        cfg, wl, dev = ctx.config, ctx.workload, ctx.device
        with ctx.span("build"):
            mesh, markers, bcs, (body, scale) = ctx.problem.setup(cfg)
            ts = BDFTimeStepping(0.0, 1.0e6,
                                 desired_start_time_step=cfg["dt"])
            solver = ProjectionSolver(
                mesh, markers, "standard", ts,
                cg_iters=tuple(wl["cg_iters"]), cg_rtol=None,
                poisson_precond=wl["poisson_precond"], device=dev,
                dtype=getattr(torch, cfg["dtype"]))
            solver.set_boundary_conditions(bcs)
            solver.set_equation_coefficients(
                {"convective_term": 1.0, "viscous_term": 1.0 / cfg["re"],
                 "pressure_term": 1.0})
            solver.set_initial_conditions({"velocity": (0.0, 0.0)})
            u, u_old, p = ctx.initial(solver.space)
            x, x_old = np.concatenate([u, p]), np.concatenate([u_old, p])
            seeded = SimpleNamespace(
                _solutions=[x] + [x_old] * (len(solver._solutions) - 1),
                _u=u, _u_old=u_old, _u_old2=u_old, _p=p,
                _phi=np.zeros_like(p))
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "seed.npz")
                save_checkpoint(path, seeded, ts)
                load_checkpoint(path, solver, ts)
            self.lattice = ctx.lattice
        self.n_dofs = solver.space.n_dofs

        with ctx.span("warmup"):
            for _ in range(int(wl["warmup_steps"])):
                ts.update_coefficients()
                solver.solve()
                ts.advance_time()
                solver.advance_time()
            step, state = solver.captured_step(body, scale)
            ctx.sync()
        fast = solver._fast
        iu, ip = lex_maps(ctx.lattice, solver.space)
        self._iu = iu[torch.as_tensor(fast.permU)].to(dev)
        self._ip = ip[torch.as_tensor(fast.permP)].to(dev)
        self._capture(ctx, step, state, int(wl["warmup_steps"]))

    def run_eager(self, snap):
        """One block of eager steps from ``snap`` (the loop's state is left
        as it is)."""
        state = snap
        for _ in range(self.block_steps):
            state = self._step(state)
        return state

    def reference_state(self, snap):
        u, u_old, p, phi, force = snap
        return (self._to_u(u), self._to_u(u_old), self._to_p(p),
                self._to_p(phi), force.to(torch.float64))


def build(ctx):
    return ProjectionGraph(ctx)
