"""``circulant_apply_roofline``: percent of the least time of the traced
steps' band applies (``work.apply_work`` at the peaks of ``work.py``)
over the device time of ``circulant_apply_kernel``."""

from harness.spec import load_module

KERNELS = ("circulant_apply_kernel",)


def read(run):
    work = load_module("metrics", "work")
    records = [r[1:] for r in run.launches if r[0] == "circulant_apply"]
    return work.roofline_share(records, run.trace["kernel_s"], KERNELS)
