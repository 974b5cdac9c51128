"""``spectral.device_ms_per_step``: device time of every kernel and copy
in the trace, in ms per traced step."""


def read(run):
    seconds = sum(run.trace["kernel_s"].values())
    if run.trace["steps"] <= 0 or seconds <= 0.0:
        return None
    return 1e3 * seconds / run.trace["steps"]
