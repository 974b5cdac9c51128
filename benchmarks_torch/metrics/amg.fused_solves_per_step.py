"""``amg.fused_solves_per_step``: launches of the AMG-preconditioned
Poisson solve as one kernel (``cuda_band.LAUNCHES["amg_pcg"]``) per
captured step of a graph chunk (``ChunkLoop.captured_launches``).  None
where the program has no such counter or the run captured no graph."""


def read(run):
    stepper = run.stepper
    launches = stepper.captured_launches
    if launches is None or "amg_pcg" not in launches:
        return None
    return launches["amg_pcg"] / stepper.block_steps
