"""``amg.band_applies_per_step``: calls of ``cuda_band.circulant_apply``
per step -- per captured step of a graph chunk
(``ChunkLoop.captured_launches``), else per traced eager step."""


def read(run):
    stepper = run.stepper
    if stepper.captured_launches is not None:
        return stepper.captured_launches["circulant_apply"] / \
            stepper.block_steps
    if run.trace["steps"] <= 0:
        return None
    calls = sum(1 for name, *_ in run.launches if name == "circulant_apply")
    return calls / run.trace["steps"]
