"""``spectral.modal_calls_per_step``: launches of the spectral step's
per-mode kernels, one per modal update at its Helmholtz launch
(``cudalib.LAUNCHES["spectral_modal"]``), per captured step of a graph
chunk (``ChunkLoop.captured_launches``).  None where the program has no
such counter or the run captured no graph."""


def read(run):
    stepper = run.stepper
    launches = stepper.captured_launches
    if launches is None or "spectral_modal" not in launches:
        return None
    return launches["spectral_modal"] / stepper.block_steps
