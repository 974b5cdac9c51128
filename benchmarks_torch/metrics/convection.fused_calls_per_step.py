"""``convection.fused_calls_per_step``: launches of the structured
convection's gather-and-quadrature kernel, one per convection
(``cuda_band.LAUNCHES["structured_convection"]``), per captured step of a
graph chunk (``ChunkLoop.captured_launches``).  None where the program has
no such counter or the run captured no graph."""


def read(run):
    stepper = run.stepper
    launches = stepper.captured_launches
    if launches is None or "structured_convection" not in launches:
        return None
    return launches["structured_convection"] / stepper.block_steps
