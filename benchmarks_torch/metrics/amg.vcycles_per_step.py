"""``amg.vcycles_per_step``: ``AMG.apply`` calls, the torch V-cycles (the
program's counter group ``amg``, ``vcycles``), per captured step of a
graph chunk (``ChunkLoop.captured_counts``).  0 where the fused AMG-PCG
kernel runs the V-cycles inside one launch; None where the program has no
such counter or the run captured no graph."""

from harness.spec import load_module


def read(run):
    counts = load_module("metrics", "program_trace").loop_value(
        run, "captured_counts")
    if counts is None or "amg" not in counts:
        return None
    return counts["amg"]["vcycles"] / run.stepper.block_steps
