"""``convection.gather_ms``: ms per step of the structured convection's
phase ``convection.gather``, nested in ``convection``
(``ChunkLoop.phase_ms()``)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(
        run, "convection.gather")
