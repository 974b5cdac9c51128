"""Driver ``spectral_graph``: the structured spectral projection step
(``structured/spectral.build_spectral_projection_step`` on the class grids
of ``structured/grid.PeriodicStructuredTH``: exact per-mode solves, DFTs as
matrix products) advanced in ``utils/graph.ChunkLoop`` chunks.

Workload keys: ``chunk``, ``warmup_steps`` and ``segment_steps`` as for
``planar_graph``.
Periodic configurations only."""

from __future__ import annotations

import torch

from harness.common import BDF1, BDF2, GraphStepper, lex_maps


class SpectralGraph(GraphStepper):

    def __init__(self, ctx):
        from navierstokes_tpu_torch.structured import (
            PeriodicStructuredTH, build_spectral_projection_step)

        cfg, wl, dev = ctx.config, ctx.workload, ctx.device
        dtype = getattr(torch, cfg["dtype"])
        with ctx.span("build"):
            space, vel_bc = ctx.problem.setup(cfg)
            if vel_bc is not None:
                raise ValueError("spectral_graph runs periodic "
                                 "configurations only")
            sgrid = PeriodicStructuredTH(space)
            step, init_state, _ = build_spectral_projection_step(
                sgrid, visc=1.0 / cfg["re"], dt=cfg["dt"], dtype=dtype,
                device=dev)
            velocity, pressure = ctx.initial
            u0 = space.interpolate_velocity(velocity).reshape(-1)
            p0 = space.interpolate_pressure(pressure)
            state = init_state(u0, u0, p0)
            self.lattice = ctx.lattice
            iu, ip = lex_maps(ctx.lattice, space)
            self._iu, self._ip = iu.to(dev), ip.to(dev)
        self._sgrid, self._ops = sgrid, step.ops
        self.n_dofs = space.n_dofs

        def advance(state):
            return step(state, *BDF2)

        with ctx.span("warmup"):
            state = step(state, *BDF1)
            for _ in range(int(wl["warmup_steps"]) - 1):
                state = advance(state)
            ctx.sync()
        self._capture(ctx, advance, state, int(wl["warmup_steps"]))

    def run_eager(self, snap):
        """One block of eager steps from ``snap`` (the loop's state is left
        as it is)."""
        state = snap
        for _ in range(self.block_steps):
            state = self._step(state)
        return state

    def reference_state(self, snap):
        U, U_old, _, _, Ph = snap
        sg = self._sgrid

        def velocity(U):
            flat = sg.grids_to_u(U)
            return self._to_u(flat.reshape(-1, 2).T)

        p = self._to_p(sg.grid_to_p(self._ops.inv_p(Ph)))
        return velocity(U), velocity(U_old), p, torch.zeros_like(p)


def build(ctx):
    return SpectralGraph(ctx)
