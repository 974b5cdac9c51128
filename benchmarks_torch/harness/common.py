"""What the drivers share: the BDF coefficients, the maps from the
program's node numbering to the reference's, and the ``Stepper`` that the
harness drives."""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

# (alpha, eta) of SBDF-1 (the first step) and of constant-step SBDF-2
BDF1 = ((1.0, -1.0, 0.0), (1.0, 0.0))
BDF2 = ((1.5, -2.0, 0.5), (2.0, -1.0))


def lex_maps(lattice, space):
    """Reference indices of the space's velocity and pressure nodes (in
    the space's numbering), from the node coordinates."""
    return (lattice.u_index(space.u_coords),
            lattice.p_index(space.p_coords))


class Stepper:
    """A program path the harness times.

    ``begin_block()`` starts the flow again from its origin when the
    workload's ``segment_steps`` are done; ``advance()`` enqueues one block
    of ``block_steps`` steps; ``steps`` counts every step taken,
    ``trajectory`` the steps of the flow the state belongs to (from its
    initial state); ``snapshot()`` copies the state;
    ``reference_state(snapshot)`` gives ``(u, u_old, p, phi)`` in the
    reference's numbering in float64.  ``graph``: whether a block is a
    CUDA graph replay (its launches were recorded once, at a warm-up
    step)."""

    graph = False
    capture_seconds = None
    captured_launches = None

    def begin_block(self):
        pass

    def _scatter(self, values, index, size):
        out = torch.zeros(values.shape[:-1] + (size,), dtype=torch.float64,
                          device=values.device)
        out[..., index] = values.to(torch.float64)
        return out

    def _to_u(self, planar):
        return self._scatter(planar, self._iu, self.lattice.nu)

    def _to_p(self, p):
        return self._scatter(p, self._ip, self.lattice.np)


class GraphStepper(Stepper):
    """Blocks of ``chunk`` steps as replays of one ``utils/graph.ChunkLoop``.

    With the workload's ``segment_steps``, a block that would carry the
    flow past that many steps first copies the state kept after the
    warm-up back into the loop's buffers: every segment is the same flow
    from the same state, so the work per step and the state's size stay
    as they are however fast the program runs (a decaying vortex would
    otherwise fall towards float32's noise)."""

    graph = True

    def _capture(self, ctx, advance, state, warmup_steps):
        from navierstokes_tpu_torch.utils.graph import ChunkLoop

        self._step = advance
        self.block_steps = int(ctx.workload["chunk"])
        segment = ctx.workload.get("segment_steps")
        self.segment_steps = None if segment is None else int(segment)
        self._origin = pytree.tree_map(torch.clone, state)
        self._origin_steps = self.steps = self.trajectory = warmup_steps
        with ctx.span("capture"):
            self.loop = ChunkLoop(advance, state, self.block_steps,
                                  ctx.device)
            self.loop.run()
            ctx.sync()
        self.steps += self.block_steps
        self.trajectory += self.block_steps
        self.capture_seconds = self.loop.capture_seconds
        self.captured_launches = self.loop.captured_launches

    def begin_block(self):
        if self.segment_steps is not None and \
                self.trajectory + self.block_steps > self.segment_steps:
            for dst, src in zip(pytree.tree_leaves(self.loop.state),
                                pytree.tree_leaves(self._origin)):
                dst.copy_(src)
            self.trajectory = self._origin_steps

    def advance(self):
        self.loop.run()
        self.steps += self.block_steps
        self.trajectory += self.block_steps

    def snapshot(self):
        return pytree.tree_map(torch.clone, self.loop.state)
