"""``step.poisson_ms``: ms per step of the step's ``poisson`` phase
(``ChunkLoop.phase_ms()``)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(run, "poisson")
