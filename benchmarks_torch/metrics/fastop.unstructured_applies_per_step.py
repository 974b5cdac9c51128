"""``fastop.unstructured_applies_per_step``: applies of the unstructured
operator formats, ``AffineBand`` (one batched mat-vec) and ``GatherOp``
(a padded row gather) together (the program's counter group
``fastop.applies``), per captured step of a graph chunk
(``ChunkLoop.captured_counts``).  None where the program has no such
counter or the run captured no graph."""

from harness.spec import load_module


def read(run):
    counts = load_module("metrics", "program_trace").loop_value(
        run, "captured_counts")
    if counts is None or "fastop.applies" not in counts:
        return None
    return sum(counts["fastop.applies"].values()) / run.stepper.block_steps
