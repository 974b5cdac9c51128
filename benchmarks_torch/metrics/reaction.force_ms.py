"""``reaction.force_ms``: ms per step of the phase ``reaction_force``, the
nodal reaction force (drag and lift) that
``ProjectionSolver.captured_step`` computes on the device after each step
(``ChunkLoop.phase_ms()``).  None where the program has no such phase."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(
        run, "reaction_force")
