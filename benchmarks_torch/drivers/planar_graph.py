"""Driver ``planar_graph``: the banded SBDF-2 projection step
(``solvers/planar_step.build_planar_projection_step`` over
``assembly/fastop.FastTaylorHood``) advanced in ``utils/graph.ChunkLoop``
chunks, one CUDA graph replay per chunk.

Workload keys: ``chunk`` (steps per replay), ``warmup_steps`` (eager steps
before the capture, the first one BDF-1), ``segment_steps`` (null, or the
length of the flow before it starts again, ``harness.common.
GraphStepper``), ``cg_iters`` (Helmholtz, Poisson, mass) and
``poisson_precond`` (null or ``"amg"``).  A problem without velocity
Dirichlet data runs the unmasked step (the torus); one with it the masked
step, as ``benchmarks/cavity_re1000.py``'s ``march_to_steady`` builds it
for the cavity's walls and lid."""

from __future__ import annotations

import numpy as np
import torch

from harness.common import BDF1, BDF2, GraphStepper, lex_maps


class PlanarGraph(GraphStepper):

    def __init__(self, ctx):
        from navierstokes_tpu_torch.assembly.fastop import FastTaylorHood
        from navierstokes_tpu_torch.solvers.planar_step import \
            build_planar_projection_step

        cfg, wl, dev = ctx.config, ctx.workload, ctx.device
        dtype = getattr(torch, cfg["dtype"])
        with ctx.span("build"):
            space, vel_bc = ctx.problem.setup(cfg)
            fast = FastTaylorHood(space, dtype=dtype, device=dev)

            def planar(flat):
                return np.asarray(flat).reshape(space.n_unodes, 2).T[
                    :, fast.permU]

            step = build_planar_projection_step(
                fast, visc=1.0 / cfg["re"], dt=cfg["dt"],
                cg_iters=tuple(wl["cg_iters"]),
                vel_bc=None if vel_bc is None else tuple(
                    planar(a) for a in vel_bc),
                poisson_precond=wl["poisson_precond"])
            velocity, pressure = ctx.initial
            u0 = space.interpolate_velocity(velocity)
            p0 = space.interpolate_pressure(pressure)
            u = fast.permute_velocity(torch.tensor(u0.T, dtype=dtype,
                                                   device=dev))
            p = fast.permute_pressure(torch.tensor(p0 - p0.mean(),
                                                   dtype=dtype, device=dev))
            self.lattice = ctx.lattice
            iu, ip = lex_maps(ctx.lattice, space)
            self._iu = iu[torch.as_tensor(fast.permU)].to(dev)
            self._ip = ip[torch.as_tensor(fast.permP)].to(dev)
        self.n_dofs = space.n_dofs

        def advance(state, coeffs=BDF2):
            u, u_old, p, phi = state
            u_new, p_new, phi_new = step(u, u_old, p, phi, *coeffs)
            return (u_new, u, p_new, phi_new)

        with ctx.span("warmup"):
            state = advance((u, u, p, torch.zeros_like(p)), BDF1)
            for _ in range(int(wl["warmup_steps"]) - 2):
                state = advance(state)
            with ctx.recording():
                state = advance(state)
            ctx.sync()
        self._capture(ctx, advance, state, int(wl["warmup_steps"]))

    def reference_state(self, snap):
        u, u_old, p, phi = snap
        return (self._to_u(u), self._to_u(u_old), self._to_p(p),
                self._to_p(phi))


def build(ctx):
    return PlanarGraph(ctx)
