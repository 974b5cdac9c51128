"""``amg.vcycle_ms``: ms per step of the AMG V-cycles (``AMG.apply``, the
phase ``amg.vcycle``, nested in ``poisson``; ``ChunkLoop.phase_ms()``)."""

from harness.spec import load_module


def read(run):
    return load_module("metrics", "program_trace").phase_ms(run, "amg.vcycle")
