"""``step.correction_ms``: ms per step of the step's ``correction`` phase
(``ChunkLoop.phase_ms()``)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(run, "correction")
